"""Run the port's host C library (goleft_tpu_torch/csrc/fastio.cpp) under
AddressSanitizer and ThreadSanitizer.

For each sanitizer: build ``build/torch/libgoleftio_{asan,tsan}.so``
with the JAX package's sanitizer flags (``-O1 -g -fsanitize=...``, the
link order of ``io/native.py::_build``), then run the ``native_io``
cases of ``tests/test_torch_*.py`` (pure host I/O: they execute neither
XLA nor torch) with the sanitizer's runtime preloaded and the port's
loader pointed at the build through ``GOLEFT_TPU_TORCH_NATIVE_LIB``.
The JAX package's side of each parity case keeps its own library.

    python tools/native_sanitize.py                  # both, ~1 min
    python tools/native_sanitize.py --only asan -k rans

Needs g++ with its ``libasan.so`` / ``libtsan.so``; no card. Exits
non-zero when a build fails, a case fails, or a sanitizer reports.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "goleft_tpu_torch", "csrc", "fastio.cpp")
OVERRIDE_ENV = "GOLEFT_TPU_TORCH_NATIVE_LIB"

#: sanitizer -> (g++ flag, runtime to preload, its options variable)
SANITIZERS = {
    "asan": ("address", "libasan.so", {"ASAN_OPTIONS": "detect_leaks=0"}),
    "tsan": ("thread", "libtsan.so",
             {"TSAN_OPTIONS": "report_bugs=1:halt_on_error=1"}),
}

#: the first line of every sanitizer report
REPORT_MARKS = ("ERROR: AddressSanitizer", "WARNING: ThreadSanitizer",
                "ERROR: ThreadSanitizer")


def build(kind: str, out_dir: str, cxx: str = "g++") -> str:
    """Build the ``kind`` library into ``out_dir`` → its path. Raises
    RuntimeError with the compiler's tail when neither link works."""
    flag = SANITIZERS[kind][0]
    out = os.path.join(out_dir, f"libgoleftio_{kind}.so")
    os.makedirs(out_dir, exist_ok=True)
    base = [cxx, "-O1", "-g", f"-fsanitize={flag}", "-shared", "-fPIC", SRC]
    err = ""
    # as io/native.py builds it: libdeflate where it links, else zlib
    for extra in (["-lz", "-ldeflate"], ["-DNO_LIBDEFLATE", "-lz"]):
        r = subprocess.run(base + extra + ["-o", out], capture_output=True,
                           text=True, timeout=300)
        if r.returncode == 0:
            return out
        err = r.stderr[-2000:]
    raise RuntimeError(f"{kind} build failed:\n{err}")


def runtime(kind: str, cxx: str = "g++") -> str:
    """The sanitizer runtime g++ links against, to preload."""
    name = SANITIZERS[kind][1]
    path = subprocess.run([cxx, f"-print-file-name={name}"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()
    if not os.path.isabs(path) or not os.path.exists(path):
        raise RuntimeError(f"{cxx} has no {name}")
    return path


def sanitized_env(kind: str, lib: str, cxx: str = "g++") -> dict:
    """The environment of a process that runs the port's loader on
    ``lib`` with the sanitizer's runtime preloaded."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", LD_PRELOAD=runtime(kind, cxx),
               **SANITIZERS[kind][2])
    env[OVERRIDE_ENV] = lib
    return env


def reports(text: str) -> list[str]:
    """The lines of ``text`` that open a sanitizer report."""
    return [ln for ln in text.splitlines()
            if any(m in ln for m in REPORT_MARKS)]


def run(kind: str, lib: str, pytest_args: list[str], cxx: str = "g++",
        timeout: float = 1800, files=None) -> tuple[int, str]:
    """Run the ``native_io`` cases of ``files`` (default
    tests/test_torch_*.py) under ``kind`` → (exit code, combined output).
    The code is non-zero when pytest fails, the library was not the one
    loaded, or a report was printed."""
    import glob

    env = sanitized_env(kind, lib, cxx)
    check = subprocess.run(
        [sys.executable, "-c",
         "from goleft_tpu_torch.io import native; "
         "print(native.get_lib()._name)"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    if check.returncode != 0 or check.stdout.strip() != lib:
        return 1, (f"the port's loader did not load {lib}: "
                   f"{check.stdout}{check.stderr[-2000:]}")
    tests = files or sorted(glob.glob(os.path.join(ROOT, "tests",
                                                   "test_torch_*.py")))
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
           "-p", "no:xdist", "-p", "no:randomly", "-m", "native_io",
           *tests, *pytest_args]
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=timeout)
    out = r.stdout + r.stderr
    rc = r.returncode
    if rc == 0 and reports(out):
        rc = 1
    return rc, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=sorted(SANITIZERS),
                    help="one sanitizer (default: both)")
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "build", "torch"),
                    help="where the libraries are built (build/torch)")
    ap.add_argument("--cxx", default=os.environ.get("CXX", "g++"))
    a, pytest_args = ap.parse_known_args(argv)
    failed = []
    for kind in ([a.only] if a.only else sorted(SANITIZERS)):
        try:
            lib = build(kind, a.out_dir, a.cxx)
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            print(f"native_sanitize {kind}: {e}", file=sys.stderr)
            failed.append(kind)
            continue
        rc, out = run(kind, lib, pytest_args, a.cxx)
        found = reports(out)
        tail = [ln for ln in out.splitlines() if ln.strip()][-1:]
        print(f"native_sanitize {kind}: rc={rc} reports={len(found)} "
              f"lib={lib} :: {tail[0] if tail else ''}", flush=True)
        if rc != 0:
            print(out[-20000:], file=sys.stderr)
            failed.append(kind)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
