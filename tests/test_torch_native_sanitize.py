"""The port's C library under the sanitizers (tools/native_sanitize.py).

- ``-m native_io`` over tests/test_torch_*.py selects the pure host-I/O
  cases: the codec, formatter and BGZF cases of
  test_torch_native_codecs.py, every case of test_torch_native_io.py
  and the BAM cases of the host tools, and none that runs cohortdepth;
- the loader's override loads the named library and only that one,
  raises when it does not load, and leaves the JAX package's loader on
  its own library;
- a library built under ASan in a temp dir runs a handful of codec cases
  clean in a subprocess, and the same harness sees the report of a
  planted heap overflow.
"""

import os
import subprocess
import sys

import pytest

from tools import native_sanitize as ns

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = sorted(os.path.join("tests", f) for f in os.listdir(
    os.path.join(ROOT, "tests")) if f.startswith("test_torch_")
    and f.endswith(".py"))


def _collect(*args) -> list[str]:
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q",
         "-p", "no:cacheprovider", "-p", "no:xdist", "-p", "no:randomly",
         *args], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return [ln for ln in r.stdout.splitlines() if "::" in ln]


def test_native_io_selects_the_marked_host_io_cases():
    ids = _collect("-m", "native_io", *TESTS)
    codecs = [i for i in ids if "test_torch_native_codecs.py" in i]
    assert len(codecs) == 45, codecs
    assert not any("cohortdepth" in i for i in ids), ids
    for case in ("test_rans_nx16_flag_matrix[False-False-False-0]",
                 "test_rans4x8[1]", "test_format_matrix_rows_matches_the"
                 "_reference[near_2_62]", "test_bgzf_stream_inflate_only",
                 "test_tok3_corrupt_streams_fall_back_to_the_references"
                 "_error"):
        assert any(i.endswith("::" + case) for i in codecs), case
    files = {i.split("::")[0] for i in ids}
    assert files == {"tests/test_torch_native_codecs.py",
                     "tests/test_torch_native_io.py",
                     "tests/test_torch_goleft_tools.py",
                     "tests/test_torch_remote.py"}, files
    assert len(ids) >= 170


def test_override_loads_the_named_library_only(monkeypatch, tmp_path):
    from goleft_tpu.io import native as jnative
    from goleft_tpu_torch.io import native

    assert native.OVERRIDE_ENV == ns.OVERRIDE_ENV \
        == "GOLEFT_TPU_TORCH_NATIVE_LIB"
    # the reference reads its own variable, never the port's
    assert "GOLEFT_TPU_TORCH_NATIVE_LIB" not in open(jnative.__file__).read()
    real = native.get_lib()
    assert real is not None
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_build", None)  # never built
    monkeypatch.setenv(ns.OVERRIDE_ENV, real._name)
    assert native.get_lib()._name == real._name
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    missing = str(tmp_path / "libmissing.so")
    monkeypatch.setenv(ns.OVERRIDE_ENV, missing)
    with pytest.raises(OSError):
        native.get_lib()
    assert native._tried is False


@pytest.fixture(scope="module")
def asan_lib(tmp_path_factory):
    return ns.build("asan", str(tmp_path_factory.mktemp("asan")))


def test_asan_build_runs_codec_cases_clean(asan_lib):
    """A few ``native_io`` codec cases, one of each C function family,
    in a subprocess with ASan preloaded: they pass, the port's loader
    took the ASan library, and no report is printed."""
    rc, out = ns.run("asan", asan_lib, [
        "-k", "rans4x8 or nosz or stripe or arith_truncated or fqzcomp or "
        "tok3 or format_matrix_rows_matches or bgzf_stream_inflate_only"],
        timeout=240, files=[os.path.join(ROOT, "tests",
                                         "test_torch_native_codecs.py")])
    assert rc == 0, out[-6000:]
    assert " passed" in out and "deselected" in out, out[-2000:]
    assert ns.reports(out) == []


#: a heap overflow for ASan (``bug(8)`` writes past 8 bytes) and a race
#: for TSan (two threads in ``bug`` at once: a read, a sleep, a write)
_PLANTED = {
    "asan": (r"""
#include <stdlib.h>
extern "C" long bug(long n) {
    volatile char *p = (volatile char *)malloc(8);
    p[n] = 1;
    long v = p[n];
    free((void *)p);
    return v;
}
""", "3", "8", "heap-buffer-overflow"),
    "tsan": (r"""
#include <unistd.h>
static long counter;
extern "C" long bug(long n) {
    long v = counter;
    usleep(100000);
    counter = v + n;
    return counter;
}
""", "1", "2", "data race"),
}

#: calls ``bug`` from argv[2] threads at once (ctypes drops the GIL)
_CALLER = """\
import ctypes, sys, threading
lib = ctypes.CDLL(sys.argv[1])
arg = int(sys.argv[2])
ts = [threading.Thread(target=lib.bug, args=(arg,))
      for _ in range(1 if sys.argv[3] == "asan" else arg)]
[t.start() for t in ts]
[t.join() for t in ts]
"""


@pytest.mark.parametrize("kind", sorted(_PLANTED))
def test_the_harness_sees_a_planted_report(tmp_path, kind):
    """The sanitizer runtimes the script preloads report what they are
    for, and its report scan finds them: a planted bug, built with the
    script's flags, runs clean on a safe argument and is reported on a
    bad one."""
    src, good, bad, what = _PLANTED[kind]
    (tmp_path / "bug.cpp").write_text(src)
    lib = str(tmp_path / "libbug.so")
    subprocess.run(["g++", "-O1", "-g", f"-fsanitize={ns.SANITIZERS[kind][0]}",
                    "-shared", "-fPIC", str(tmp_path / "bug.cpp"), "-o", lib],
                   check=True, timeout=120)
    env = ns.sanitized_env(kind, lib)
    runs = {arg: subprocess.run(
        [sys.executable, "-c", _CALLER, lib, arg, kind], env=env,
        capture_output=True, text=True, timeout=120) for arg in (good, bad)}
    assert runs[good].returncode == 0, runs[good].stderr[-3000:]
    assert ns.reports(runs[good].stderr) == []
    assert runs[bad].returncode != 0
    assert any(what in ln for ln in ns.reports(runs[bad].stderr)), \
        runs[bad].stderr[-3000:]
