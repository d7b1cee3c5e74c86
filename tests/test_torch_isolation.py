"""The port stands alone: goleft_tpu_torch, chip_smoke.py and its fixture
writer import neither JAX nor the JAX package, and a default run needs a
CUDA card rather than dropping to the CPU."""

import json
import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

import goleft_tpu_torch
from goleft_tpu_torch import cli, device
from goleft_tpu_torch.commands.depth import DepthEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(goleft_tpu_torch.__file__)

_FORBIDDEN = re.compile(
    r"^\s*(?:import\s+(?:jax|goleft_tpu)\b(?!_torch)"
    r"|from\s+(?:jax|goleft_tpu)\b(?!_torch))", re.M)


def _sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    for tool in ("bulk_bam.py", "bulk_cram.py", "rans_bench.py",
                 "pairhmm_bench.py", "sass_loops.py",
                 "cohort_bench.py", "flags_bench.py", "em_bench.py",
                 "norm_bench.py", "swalign_bench.py", "serve_bench.py",
                 "bench_entries.py", "native_sanitize.py"):
        yield os.path.join(ROOT, "tools", tool)


def test_sources_import_neither_jax_nor_reference():
    seen = []
    for path in _sources():
        with open(path) as fh:
            hits = _FORBIDDEN.findall(fh.read())
        assert not hits, f"{path}: {hits}"
        seen.append(os.path.relpath(path, PKG))
    assert len(seen) > 10
    for sub in ("obs", "plan", "resilience", "models", "ops", "commands",
                "io", "parallel", "utils", "cohort", "mapping", "serve",
                "fleet"):
        assert any(p.startswith(sub + os.sep) for p in seen), sub
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from goleft_tpu.io import bam")
    assert not _FORBIDDEN.search("from goleft_tpu_torch.io import bam")


def test_cpu_depth_run_loads_no_jax(tmp_path):
    """Fixture, index and a whole depth run through the port alone in a
    fresh interpreter; then neither jax nor goleft_tpu is loaded."""
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        from goleft_tpu_torch.commands.depth import run_depth
        from goleft_tpu_torch.io.bai import build_bai, write_bai
        from goleft_tpu_torch.io.bam import BamWriter, parse_cigar
        d = {str(tmp_path)!r}
        with open(d + "/r.fa", "w") as fh:
            fh.write(">chr1\\n" + "ACGT" * 250 + "\\n")
        hdr = "@HD\\tVN:1.6\\tSO:coordinate\\n@SQ\\tSN:chr1\\tLN:1000\\n"
        with open(d + "/t.bam", "wb") as fh:
            with BamWriter(fh, hdr, ["chr1"], [1000]) as w:
                for i in range(50):
                    w.write_record(0, 10 * i, parse_cigar("100M"),
                                   name=f"r{{i}}")
        write_bai(build_bai(d + "/t.bam"), d + "/t.bam.bai")
        run_depth(d + "/t.bam", d + "/o", reference=d + "/r.fa",
                  window=100, device="cpu")
        from goleft_tpu_torch.obs.manifest import write_manifest
        write_manifest(d + "/m.json", argv=["depth"], device="cpu")
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "goleft_tpu"))
        print("LOADED", bad)
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=120, cwd=str(tmp_path), env=env)
    assert r.returncode == 0, r.stderr
    assert "LOADED []" in r.stdout, r.stdout
    rows = open(tmp_path / "o.depth.bed").read().splitlines()
    assert len(rows) == 10 and rows[0] == "chr1\t0\t100\t5.5"
    # the run asked for the CPU: its manifest is never device evidence
    from goleft_tpu.obs.manifest import load_manifest

    man = load_manifest(str(tmp_path / "m.json"))
    assert man["backend"]["platform"] == "cpu"
    assert man["spans"]["host-decode"]["calls"] >= 1


def test_cpu_pairhmm_run_loads_no_jax(tmp_path):
    """A windows document through the port's pairhmm command in a fresh
    interpreter, on the CPU; then neither jax nor goleft_tpu is
    loaded."""
    script = textwrap.dedent(f"""
        import io, json, sys
        sys.path.insert(0, {ROOT!r})
        from goleft_tpu_torch.commands.pairhmm_cmd import run_pairhmm
        hap = "ACGTTGCAAC" * 6
        doc = {{"schema": "goleft-tpu.pairhmm-windows/1",
               "windows": [{{"chrom": "chr1", "start": 0, "end": 60,
                            "haplotypes": [hap, hap[:30] + "T" + hap[31:]],
                            "reads": [{{"seq": hap[5:45], "quals": 30}}] * 3}}]}}
        path = {str(tmp_path / "w.json")!r}
        json.dump(doc, open(path, "w"))
        buf = io.StringIO()
        rc = run_pairhmm(path, out=buf, device="cpu")
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "goleft_tpu"))
        print("RC", rc, "ROWS", len(buf.getvalue().splitlines()))
        print("LOADED", bad)
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=120, cwd=str(tmp_path), env=env)
    assert r.returncode == 0, r.stderr
    assert "RC 0 ROWS 2" in r.stdout, r.stdout
    assert "LOADED []" in r.stdout, r.stdout


def test_cpu_cohortdepth_run_loads_no_jax(tmp_path):
    """A two-sample rANS-Nx16 CRAM cohort written with the port's
    CramWriter, through the port's cohortdepth with the device decode on
    the CPU, in a fresh interpreter; then neither jax nor goleft_tpu is
    loaded."""
    script = textwrap.dedent(f"""
        import io, sys
        sys.path.insert(0, {ROOT!r})
        from goleft_tpu_torch.commands.cohortdepth import run_cohortdepth
        from goleft_tpu_torch.io.bam import parse_cigar
        from goleft_tpu_torch.io.cram import CramWriter, M_RANSNX16
        d = {str(tmp_path)!r}
        paths = []
        for k in range(2):
            p = f"{{d}}/s{{k}}.cram"
            with open(p, "wb") as fh:
                with CramWriter(fh, f"@RG\\tID:r\\tSM:s{{k}}\\n", ["chr1"],
                                [1000], records_per_container=20,
                                block_method=M_RANSNX16, minor=1,
                                rans_order=k) as w:
                    for i in range(50):
                        w.write_record(0, 10 * i + k, parse_cigar("100M"),
                                       name=f"r{{i}}")
                w.write_crai(p + ".crai")
            paths.append(p)
        with open(d + "/r.fa.fai", "w") as fh:
            fh.write("chr1\\t1000\\t6\\t60\\t61\\n")
        buf = io.StringIO()
        rc = run_cohortdepth(paths, fai=d + "/r.fa.fai", window=100, out=buf,
                             decode_device=True, device="cpu")
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "goleft_tpu"))
        print("RC", rc, "ROWS", buf.getvalue().splitlines()[:2])
        print("LOADED", bad)
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=120, cwd=str(tmp_path), env=env)
    assert r.returncode == 0, r.stderr
    assert "RC 0 ROWS ['#chrom\\tstart\\tend\\ts0\\ts1', " \
        "'chr1\\t0\\t100\\t6\\t5']" in r.stdout, r.stdout
    assert "LOADED []" in r.stdout, r.stdout


def test_cpu_emdepth_run_loads_no_jax(tmp_path):
    """A depth matrix through the port's emdepth with every output, on
    the CPU, in a fresh interpreter; then neither jax nor goleft_tpu is
    loaded."""
    script = textwrap.dedent(f"""
        import io, sys
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        from goleft_tpu_torch.commands.emdepth_cmd import run_emdepth
        d = {str(tmp_path)!r}
        rng = np.random.default_rng(0)
        m = rng.gamma(40, 1.0, size=(60, 8)).round(1)
        m[20:30, 3] *= 0.25
        with open(d + "/m.tsv", "w") as fh:
            fh.write("#chrom\\tstart\\tend\\t"
                     + "\\t".join(f"s{{i}}" for i in range(8)) + "\\n")
            for w in range(60):
                fh.write(f"chr1\\t{{w * 1000}}\\t{{w * 1000 + 1000}}\\t"
                         + "\\t".join(str(v) for v in m[w]) + "\\n")
        buf = io.StringIO()
        calls = run_emdepth(d + "/m.tsv", out=buf, matrix_out=d + "/cn.tsv",
                            vcf_out=d + "/c.vcf.gz", mops_out=d + "/mops.tsv",
                            gain_out=d + "/gain.tsv",
                            candidates_out=d + "/c.json", device="cpu")
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "goleft_tpu"))
        print("S3", [c[1:5] for c in calls if c[3] == "s3"])
        print("LOADED", bad)
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=120, cwd=str(tmp_path), env=env)
    assert r.returncode == 0, r.stderr
    assert "S3 [(0, 30000, 's3', 1)]" in r.stdout, r.stdout
    assert "LOADED []" in r.stdout, r.stdout
    for f in ("cn.tsv", "c.vcf.gz", "mops.tsv", "gain.tsv", "c.json"):
        assert (tmp_path / f).stat().st_size > 0, f


def test_cpu_cnv_run_loads_no_jax(tmp_path):
    """Four BAMs written with the port's BamWriter, one with a deletion,
    through the port's cnv on the device engine on the CPU, in a fresh
    interpreter; then neither jax nor goleft_tpu is loaded."""
    script = textwrap.dedent(f"""
        import io, sys
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        from goleft_tpu_torch.commands.cnv import run_cnv
        from goleft_tpu_torch.io.bai import build_bai, write_bai
        from goleft_tpu_torch.io.bam import BamWriter, parse_cigar
        d = {str(tmp_path)!r}
        with open(d + "/r.fa", "w") as fh:
            fh.write(">chr1\\n" + "ACGT" * 10000 + "\\n")
        rng = np.random.default_rng(1)
        paths = []
        for k in range(4):
            hdr = ("@HD\\tVN:1.6\\tSO:coordinate\\n@SQ\\tSN:chr1\\tLN:40000\\n"
                   f"@RG\\tID:r\\tSM:s{{k}}\\n")
            pos = np.sort(rng.integers(0, 39900, 3000))
            if k == 2:
                pos = pos[(pos < 10000) | (pos >= 20000)]
            p = f"{{d}}/s{{k}}.bam"
            with open(p, "wb") as fh:
                with BamWriter(fh, hdr, ["chr1"], [40000]) as w:
                    for i, s in enumerate(pos):
                        w.write_record(0, int(s), parse_cigar("100M"),
                                       name=f"r{{i}}")
            write_bai(build_bai(p), p + ".bai")
            paths.append(p)
        buf = io.StringIO()
        calls = run_cnv(paths, reference=d + "/r.fa", window=1000, out=buf,
                        engine="device", vcf_out=d + "/c.vcf", device="cpu")
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "goleft_tpu"))
        print("S2", [c[3] for c in calls if c[1] < 20000 and c[2] > 10000])
        print("LOADED", bad)
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=120, cwd=str(tmp_path), env=env)
    assert r.returncode == 0, r.stderr
    assert "S2 ['s2']" in r.stdout, r.stdout
    assert "LOADED []" in r.stdout, r.stdout
    assert "<DEL>" in (tmp_path / "c.vcf").read_text()


def test_cpu_indexcov_run_loads_no_jax(tmp_path):
    """Six whole-index .bai files and an .fai through the port's indexcov
    with ``-n``, the reports and PNGs, on the CPU, in a fresh interpreter;
    then neither jax nor goleft_tpu is loaded, and the modules of the
    slice (the normalisation, its kernel's module, the report writer, and
    the CRAI reader imported beside them) are."""
    script = textwrap.dedent(f"""
        import struct, sys
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        from goleft_tpu_torch.commands.indexcov import run_indexcov
        import goleft_tpu_torch.io.crai
        d = {str(tmp_path)!r}
        lens = {{"chr1": 60 * 16384, "chrX": 30 * 16384, "chrY": 9 * 16384}}
        with open(d + "/ref.fa.fai", "w") as fh:
            for n, ln in lens.items():
                fh.write(f"{{n}}\\t{{ln}}\\t6\\t60\\t61\\n")
        rng = np.random.default_rng(3)
        paths = []
        for s in range(6):
            blob = bytearray(b"BAI\\x01") + struct.pack("<i", len(lens))
            for n, ln in lens.items():
                half = (n != "chr1" and s % 2 == 0)
                deltas = rng.integers(36000, 44000, ln // 16384)
                if half:
                    deltas //= 2
                if n == "chrY" and s % 2:
                    deltas = deltas // 1000
                iv = (np.cumsum(deltas).astype(np.uint64) << np.uint64(16))
                blob += struct.pack("<i", 1) + struct.pack("<Ii", 0x924A, 2)
                blob += struct.pack("<QQQQ", 0, 0, 1000, 10)
                blob += struct.pack("<i", len(iv)) + iv.astype("<u8").tobytes()
            p = f"{{d}}/s{{s}}.bai"
            open(p, "wb").write(bytes(blob))
            paths.append(p)
        res = run_indexcov(paths, d + "/out", fai=d + "/ref.fa.fai",
                           extra_normalize=True, device="cpu")
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "goleft_tpu"))
        mods = [m for m in ("goleft_tpu_torch.cohort.streaming",
                            "goleft_tpu_torch.ops.norm_kernel",
                            "goleft_tpu_torch.utils.report",
                            "goleft_tpu_torch.io.crai")
                if m in sys.modules]
        print("SEX", [int(0.5 + c) for c in res["sexes"]["chrX"]])
        print("MODS", len(mods))
        print("LOADED", bad)
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=120, cwd=str(tmp_path), env=env)
    assert r.returncode == 0, r.stderr
    assert "SEX [1, 2, 1, 2, 1, 2]" in r.stdout, r.stdout
    assert "MODS 4" in r.stdout and "LOADED []" in r.stdout, r.stdout
    for f in ("out-indexcov.bed.gz", "out-indexcov.ped", "index.html",
              "out-indexcov-depth-chr1.html"):
        assert (tmp_path / "out" / f).stat().st_size > 0, f


def test_cpu_cohortscan_run_loads_no_jax(tmp_path):
    """Six whole-index .bai files through the port's cohortscan with
    ``-n`` in chunks of 4, then an append of one sample under --resume
    with the chunks sized from the journal, on the CPU, in a fresh
    interpreter; then neither jax nor goleft_tpu
    is loaded, and the slice's modules are."""
    script = textwrap.dedent(f"""
        import struct, sys
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        from goleft_tpu_torch.cohort.scan import run_cohortscan
        d = {str(tmp_path)!r}
        lens = {{"chr1": 60 * 16384, "chrX": 30 * 16384, "chrY": 9 * 16384}}
        with open(d + "/ref.fa.fai", "w") as fh:
            for n, ln in lens.items():
                fh.write(f"{{n}}\\t{{ln}}\\t6\\t60\\t61\\n")
        rng = np.random.default_rng(3)
        paths = []
        for s in range(7):
            blob = bytearray(b"BAI\\x01") + struct.pack("<i", len(lens))
            for n, ln in lens.items():
                deltas = rng.integers(36000, 44000, ln // 16384)
                if n != "chr1" and s % 2 == 0:
                    deltas //= 2
                if n == "chrY" and s % 2:
                    deltas = deltas // 1000
                iv = (np.cumsum(deltas).astype(np.uint64) << np.uint64(16))
                blob += struct.pack("<i", 1) + struct.pack("<Ii", 0x924A, 2)
                blob += struct.pack("<QQQQ", 0, 0, 1000, 10)
                blob += struct.pack("<i", len(iv)) + iv.astype("<u8").tobytes()
            p = f"{{d}}/s{{s}}.bai"
            open(p, "wb").write(bytes(blob))
            paths.append(p)
        kw = dict(fai=d + "/ref.fa.fai", extra_normalize=True,
                  pca_mode="sharded", device="cpu")
        first = run_cohortscan(paths[:6], d + "/out", chunk_samples=4, **kw)
        res = run_cohortscan(paths, d + "/out", chunk_samples=0,
                             resume=True, **kw)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "goleft_tpu"))
        mods = [m for m in ("goleft_tpu_torch.cohort.manifest",
                            "goleft_tpu_torch.cohort.pca",
                            "goleft_tpu_torch.obs.memplane",
                            "goleft_tpu_torch.ops.norm_kernel")
                if m in sys.modules]
        print("SEX", [int(0.5 + c) for c in res["sexes"]["chrX"]])
        print("QC", first["qc"], res["qc"], res["diff"]["new"] == paths[6:])
        print("MODS", len(mods))
        print("LOADED", bad)
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=120, cwd=str(tmp_path), env=env)
    assert r.returncode == 0, r.stderr
    assert "SEX [1, 2, 1, 2, 1, 2, 1]" in r.stdout, r.stdout
    # -n: the append moves chr1's scalars, so chr1 recomputes all 7
    assert ("QC {'computed': 18, 'resumed': 0} {'computed': 9, "
            "'resumed': 12} True") in r.stdout, r.stdout
    assert "MODS 4" in r.stdout and "LOADED []" in r.stdout, r.stdout
    for f in ("out-indexcov.bed.gz", "out-indexcov.ped",
              "out-indexcov.roc", "out-indexcov.manifest.json"):
        assert (tmp_path / "out" / f).stat().st_size > 0, f


def test_cpu_multidepth_and_dcnv_runs_load_no_jax(tmp_path):
    """Three BAMs written with the port's BamWriter through the port's
    multidepth on the CPU, then a depth matrix and a FASTA through its
    dcnv, in a fresh interpreter; then neither jax nor goleft_tpu is
    loaded."""
    script = textwrap.dedent(f"""
        import io, sys
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        from goleft_tpu_torch.commands.dcnv_cmd import run_dcnv
        from goleft_tpu_torch.commands.multidepth import run_multidepth
        from goleft_tpu_torch.io.bai import build_bai, write_bai
        from goleft_tpu_torch.io.bam import BamWriter, parse_cigar
        d = {str(tmp_path)!r}
        rng = np.random.default_rng(1)
        paths = []
        for k in range(3):
            hdr = ("@HD\\tVN:1.6\\tSO:coordinate\\n"
                   "@SQ\\tSN:chr1\\tLN:40000\\n"
                   f"@RG\\tID:r\\tSM:s{{k}}\\n")
            pos = np.sort(rng.integers(5000, 15000, 2000))
            p = f"{{d}}/s{{k}}.bam"
            with open(p, "wb") as fh:
                with BamWriter(fh, hdr, ["chr1"], [40000]) as w:
                    for i, s in enumerate(pos):
                        w.write_record(0, int(s), parse_cigar("100M"),
                                       name=f"r{{i}}")
            write_bai(build_bai(p), p + ".bai")
            paths.append(p)
        buf = io.StringIO()
        run_multidepth(paths, "chr1", out=buf, device="cpu")
        rows = buf.getvalue().splitlines()
        with open(d + "/r.fa", "w") as fh:
            fh.write(">chr1\\n" + "ACGGT" * 8000 + "\\n")
        m = rng.gamma(40, 1.0, size=(30, 4)).round(1)
        with open(d + "/m.tsv", "w") as fh:
            fh.write("#chrom\\tstart\\tend\\ta\\tb\\tc\\td\\n")
            for w in range(30):
                fh.write(f"chr1\\t{{w * 1000}}\\t{{w * 1000 + 1000}}\\t"
                         + "\\t".join(str(v) for v in m[w]) + "\\n")
        out = io.StringIO()
        norm = run_dcnv(d + "/m.tsv", d + "/r.fa", out=out,
                        candidates_out=d + "/c.tsv")
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "goleft_tpu"))
        print("MD", rows[0], len(rows) > 1, rows[1].split("\\t")[1])
        print("DCNV", norm.shape, len(out.getvalue().splitlines()))
        print("LOADED", bad)
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=120, cwd=str(tmp_path), env=env)
    assert r.returncode == 0, r.stderr
    assert "MD #chrom\tstart\tend\ts0\ts1\ts2 True 5" in r.stdout, \
        r.stdout
    assert "DCNV (30, 4) 31" in r.stdout, r.stdout
    assert "LOADED []" in r.stdout, r.stdout


def test_cpu_map_run_loads_no_jax(tmp_path):
    """A fabricated reference and FASTQ through the port's map on the
    CPU, tuples and --depth-out, in a fresh interpreter; then neither
    jax nor goleft_tpu is loaded."""
    script = textwrap.dedent(f"""
        import io, sys
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        from goleft_tpu_torch.commands.map_cmd import run_map
        d = {str(tmp_path)!r}
        rng = np.random.default_rng(2)
        ref = bytes(rng.choice(list(b"ACGT"), 4000).tolist())
        with open(d + "/r.fa", "wb") as fh:
            fh.write(b">chr1\\n" + ref + b"\\n")
        with open(d + "/r.fq", "wb") as fh:
            for i in range(30):
                s = int(rng.integers(0, 3800))
                fh.write(b"@r%d\\n%s\\n+\\n%s\\n"
                         % (i, ref[s:s + 120], b"I" * 120))
        rc = run_map(d + "/r.fa", d + "/r.fq", out=d + "/t.tsv",
                     depth_out=d + "/d.bed", device="cpu")
        rows = open(d + "/t.tsv").read().splitlines()
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "goleft_tpu"))
        print("RC", rc, "ROWS", len(rows), len(open(d + "/d.bed").read()
                                               .splitlines()))
        print("LOADED", bad)
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert r.returncode == 0, r.stderr
    assert "RC 0 ROWS 30 16" in r.stdout, r.stdout
    assert "LOADED []" in r.stdout, r.stdout


def test_goleft_tools_run_without_a_card_and_load_no_jax(tmp_path):
    """samplename, covstats, indexsplit, anonymize, depthwed and cnveval
    through the port's CLI in a fresh interpreter where no card is
    visible: each exits 0 (none has a device stage, so none asks for
    one), and neither jax nor goleft_tpu is loaded."""
    script = textwrap.dedent(f"""
        import contextlib, io, sys
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        import torch
        assert not torch.cuda.is_available()
        from goleft_tpu_torch import cli
        from goleft_tpu_torch.io.bai import build_bai, write_bai
        from goleft_tpu_torch.io.bam import BamWriter, parse_cigar
        d = {str(tmp_path)!r}
        hdr = ("@HD\\tVN:1.6\\tSO:coordinate\\n@SQ\\tSN:chr1\\tLN:200000\\n"
               "@RG\\tID:r\\tSM:s0\\n")
        with open(d + "/t.bam", "wb") as fh:
            with BamWriter(fh, hdr, ["chr1"], [200000]) as w:
                for i, s in enumerate(range(0, 190000, 40)):
                    w.write_record(0, s, parse_cigar("100M"),
                                   flag=0x63 if i % 2 else 0x93,
                                   name=f"r{{i}}", mate_tid=0,
                                   mate_pos=s + 250, tlen=350)
        write_bai(build_bai(d + "/t.bam"), d + "/t.bam.bai")
        for n in "ab":
            with open(f"{{d}}/{{n}}.depth.bed", "w") as fh:
                for k in range(8):
                    fh.write(f"chr1\\t{{k * 250}}\\t{{k * 250 + 250}}\\t"
                             f"{{k}}.5\\n")
        with open(d + "/truth.bed", "w") as fh:
            fh.write("1\\t1000\\t15000\\t1\\ta\\n")
        with open(d + "/test.bed", "w") as fh:
            fh.write("1\\t1000\\t15000\\t1\\ta\\n")
        runs = [["samplename", d + "/t.bam"],
                ["covstats", "-n", "500", d + "/t.bam"],
                ["indexsplit", "-n", "4", d + "/t.bam"],
                ["anonymize", "coh", d + "/t.bam", "-d", d],
                ["depthwed", "-s", "500", d + "/a.depth.bed",
                 d + "/b.depth.bed"],
                ["cnveval", d + "/truth.bed", d + "/test.bed"]]
        rcs = []
        for argv in runs:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rcs.append(cli.main(argv))
            assert buf.getvalue(), argv
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "goleft_tpu"))
        print("RCS", rcs)
        print("LOADED", bad)
    """)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert r.returncode == 0, r.stderr
    assert "RCS [0, 0, 0, 0, 0, 0]" in r.stdout, r.stdout
    assert "LOADED []" in r.stdout, r.stdout
    assert (tmp_path / "sample_coh_0001.bam.bai").exists()


def test_indexcov_default_run_needs_a_card(monkeypatch, tmp_path):
    """``run_indexcov`` without ``device`` asks for the card: without one
    it raises before it writes anything."""
    from goleft_tpu_torch.commands.indexcov import run_indexcov

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(device.NoCudaDevice):
        run_indexcov(["x.bai"], str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()


def test_cpu_bench_suite_host_run_loads_no_jax(tmp_path):
    """``python -m goleft_tpu_torch --metrics-out m.json bench
    --suite-host --quick`` (toy sizes) in a fresh interpreter loads
    neither jax nor the JAX package; its manifest names the CPU and the
    kernels' launch counts (none on the CPU)."""
    script = textwrap.dedent(f"""
        import functools, sys
        sys.path.insert(0, {ROOT!r})
        from goleft_tpu_torch import bench, cli
        bench.COHORT_SIZES = {{True: (2, 100_000, 2)}}
        bench.COHORT_DEVICE_SIZES = {{True: (2, 100_000, 2)}}
        for name, kw in (("bench_depth_wholegenome",
                          dict(n_chrom=2, base_len=30_000)),
                         ("bench_indexcov_e2e",
                          dict(n_ix=2, chrom_lens=[800_000])),
                         ("bench_pairhmm_forward", dict(n_pairs=2)),
                         ("bench_read_mapping",
                          dict(ref_bp=8_000, n_reads=10)),
                         ("bench_decode_thread_scaling",
                          dict(n_files=2, ref_len=50_000)),
                         ("bench_cram31_codec_decode", dict(n=4096)),
                         ("bench_serve_throughput",
                          dict(n_clients=2, n_requests=2,
                               ref_len=20_000)),
                         ("bench_fleet_throughput",
                          dict(n_clients=2, n_requests=2,
                               ref_len=20_000)),
                         ("bench_cohort_resume_overhead",
                          dict(n_samples=2, ref_len=100_000, repeats=1)),
                         ("bench_wire_decode", dict(bs=1024, nb=3)),
                         ("bench_remote_fetch", dict(size_mb=1)),
                         ("bench_profiler_overhead",
                          dict(length=100_000, reps=1)),
                         ("bench_memory_overhead",
                          dict(length=100_000, reps=1))):
            setattr(bench, name,
                    functools.partial(getattr(bench, name), **kw))
        rc = cli.main(["--metrics-out", "m.json", "bench", "--suite-host",
                       "--quick", "--out-dir", "o"])
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "goleft_tpu"))
        print("RC", rc)
        print("LOADED", bad)
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert r.returncode == 0, r.stderr
    assert "RC 0" in r.stdout and "LOADED []" in r.stdout, r.stdout
    from goleft_tpu.obs.manifest import load_manifest

    man = load_manifest(str(tmp_path / "m.json"))
    assert man["command"] == "bench" and man["exit_code"] == 0
    assert man["backend"]["platform"] == "cpu"
    assert set(man["kernel_launches"]) >= {"depth", "pairhmm", "swalign",
                                           "rans"}


def test_cpu_trace_out_run_loads_no_jax(tmp_path):
    """The port's CLI with ``--trace-out``, ``--metrics-out``,
    ``--inject-faults`` and ``depth --cache`` in a fresh interpreter,
    the command's device pinned to the CPU; then neither jax nor
    goleft_tpu is loaded, and the trace holds the run."""
    script = textwrap.dedent(f"""
        import os, sys
        sys.path.insert(0, {ROOT!r})
        os.environ["GOLEFT_TPU_PROBE"] = "0"  # no card to probe
        import goleft_tpu_torch.device as d
        _r = d.resolve_device
        d.resolve_device = lambda device=None: _r("cpu")
        from goleft_tpu_torch import cli
        from goleft_tpu_torch.io.bai import build_bai, write_bai
        from goleft_tpu_torch.io.bam import BamWriter, parse_cigar
        t = {str(tmp_path)!r}
        with open(t + "/r.fa", "w") as fh:
            fh.write(">chr1\\n" + "ACGT" * 250 + "\\n")
        hdr = "@HD\\tVN:1.6\\tSO:coordinate\\n@SQ\\tSN:chr1\\tLN:1000\\n"
        with open(t + "/t.bam", "wb") as fh:
            with BamWriter(fh, hdr, ["chr1"], [1000]) as w:
                for i in range(50):
                    w.write_record(0, 10 * i, parse_cigar("100M"),
                                   name=f"r{{i}}")
        write_bai(build_bai(t + "/t.bam"), t + "/t.bam.bai")
        rc = cli.main(["--trace-out", t + "/t.json", "--metrics-out",
                       t + "/m.json", "--inject-faults", "shard:p=0",
                       "depth", "--cache", t + "/c", "--prefix", t + "/o",
                       "-r", t + "/r.fa", "-w", "100", t + "/t.bam"])
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "goleft_tpu"))
        print("RC", rc)
        print("LOADED", bad)
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=120, cwd=str(tmp_path), env=env)
    assert r.returncode == 0, r.stderr
    assert "RC 0" in r.stdout and "LOADED []" in r.stdout, r.stdout
    import json

    doc = json.load(open(tmp_path / "t.json"))
    names = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
    assert names.count("run.depth") == 1 and "device.depth" in names
    man = json.load(open(tmp_path / "m.json"))
    root = next(e for e in doc["traceEvents"] if e["name"] == "run.depth")
    assert man["trace_id"] == root["args"]["trace_id"]


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(device.NoCudaDevice):
        device.resolve_device()
    with pytest.raises(device.NoCudaDevice):
        device.resolve_device("cuda")
    with pytest.raises(device.NoCudaDevice):
        DepthEngine(250, 4, 0, 1)
    assert device.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        device.resolve_device("mps")


@pytest.mark.parametrize("entry", ["app", "cli"])
def test_serve_needs_a_card(monkeypatch, tmp_path, entry):
    """``ServeApp()`` and ``python -m goleft_tpu_torch serve`` ask for
    the card: without one the app raises NoCudaDevice before it starts
    a thread, and the command exits 1 with one line, never listening."""
    if entry == "app":
        from goleft_tpu_torch.serve.server import ServeApp

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        import threading

        before = threading.active_count()
        with pytest.raises(device.NoCudaDevice):
            ServeApp()
        assert threading.active_count() == before
        return
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    env.pop("GOLEFT_TPU_DEBUG", None)
    r = subprocess.run(
        [sys.executable, "-m", "goleft_tpu_torch", "serve", "--port", "0"],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env=env)
    assert r.returncode == 1 and "no CUDA device" in r.stderr, r.stderr
    assert "listening" not in r.stdout


def test_cpu_serve_run_loads_no_jax(tmp_path):
    """A port ServeApp asked for the CPU answers a depth request over
    HTTP in a fresh interpreter; then neither jax nor goleft_tpu is
    loaded."""
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        from goleft_tpu_torch.io.bai import build_bai, write_bai
        from goleft_tpu_torch.io.bam import BamWriter, parse_cigar
        from goleft_tpu_torch.serve.client import ServeClient
        from goleft_tpu_torch.serve.server import ServeApp, ServerThread
        d = {str(tmp_path)!r}
        with open(d + "/r.fa", "w") as fh:
            fh.write(">chr1\\n" + "ACGT" * 250 + "\\n")
        hdr = "@HD\\tVN:1.6\\tSO:coordinate\\n@SQ\\tSN:chr1\\tLN:1000\\n"
        with open(d + "/t.bam", "wb") as fh:
            with BamWriter(fh, hdr, ["chr1"], [1000]) as w:
                for i in range(50):
                    w.write_record(0, 10 * i, parse_cigar("100M"),
                                   name=f"r{{i}}")
        write_bai(build_bai(d + "/t.bam"), d + "/t.bam.bai")
        app = ServeApp(device="cpu")
        app.warmup()
        with ServerThread(app) as url:
            c = ServeClient(url, timeout_s=60)
            r = c.depth(d + "/t.bam", reference=d + "/r.fa", window=100)
            print("HEALTH", c.healthz()["platform"])
        print("ROW", r["depth_bed"].splitlines()[0])
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "goleft_tpu"))
        print("LOADED", bad)
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=120, cwd=str(tmp_path), env=env)
    assert r.returncode == 0, r.stderr
    assert "LOADED []" in r.stdout, r.stdout
    assert "HEALTH cpu" in r.stdout and "ROW chr1\t0\t100\t5.5" in r.stdout


def test_cli_without_cuda_exits_cleanly(monkeypatch, tmp_path, capsys):
    """The CLI's default run asks for the card: without one it exits 1
    with one line naming the cause, and writes its run manifest all the
    same."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("GOLEFT_TPU_DEBUG", raising=False)
    fa = tmp_path / "r.fa"
    fa.write_text(">chr1\n" + "A" * 100 + "\n")
    from goleft_tpu_torch.io.bam import BamWriter

    bam = tmp_path / "t.bam"
    with open(bam, "wb") as fh:
        BamWriter(fh, "", ["chr1"], [100]).close()
    from goleft_tpu_torch.io.bai import build_bai, write_bai

    write_bai(build_bai(str(bam)), str(bam) + ".bai")
    report = tmp_path / "rep.json"
    rc = cli.main(["depth", "--metrics-out", str(report), "--prefix",
                   str(tmp_path / "o"), "-r", str(fa), str(bam)])
    assert rc == 1
    assert "no CUDA device" in capsys.readouterr().err
    from goleft_tpu.obs.manifest import load_manifest

    rep = load_manifest(str(report))
    assert rep["command"] == "depth" and rep["exit_code"] == 1
    assert rep["kernel_launches"] == {"depth": 0, "pairhmm": 0, "rans": 0,
                                      "indexcov_norm": 0, "swalign": 0}
    assert rep["backend"]["platform"] == "cpu"
    assert rep["spans"]["run.depth"]["calls"] == 1


def test_metrics_out_is_the_reference_run_manifest(tmp_path):
    """``python -m goleft_tpu_torch --metrics-out FILE depth`` on the CPU
    in a fresh process (no card: exit 1, one line): the JAX package's
    ``load_manifest`` accepts the file as a ``goleft-tpu.run-manifest``
    of its own schema; the backend says "cpu" and no kernel launched
    (the card's probe refused it before any import);
    the port's own keys ride beside the required ones, and the port's
    loader reads it the same."""
    from goleft_tpu.obs import manifest as ref
    from goleft_tpu_torch.io.bai import build_bai, write_bai
    from goleft_tpu_torch.io.bam import BamWriter
    from goleft_tpu_torch.obs import manifest as port

    fa = tmp_path / "r.fa"
    fa.write_text(">chr1\n" + "A" * 100 + "\n")
    bam = tmp_path / "t.bam"
    with open(bam, "wb") as fh:
        BamWriter(fh, "", ["chr1"], [100]).close()
    write_bai(build_bai(str(bam)), str(bam) + ".bai")
    out = tmp_path / "run.json"
    # GOLEFT_TPU_PROBE_TTL_SECONDS=0: the card is probed, not looked up
    # in the probe's cache
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="",
               GOLEFT_TPU_PROBE_TTL_SECONDS="0")
    env.pop("GOLEFT_TPU_DEBUG", None)
    r = subprocess.run(
        [sys.executable, "-m", "goleft_tpu_torch", "--metrics-out",
         str(out), "depth", "--prefix", str(tmp_path / "o"), "-r",
         str(fa), str(bam)],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env=env)
    assert r.returncode == 1 and "no CUDA device" in r.stderr, r.stderr
    doc = ref.load_manifest(str(out))
    assert doc["schema"] == ref.SCHEMA == port.SCHEMA
    assert set(ref.REQUIRED_KEYS) == set(port.REQUIRED_KEYS) <= set(doc)
    assert doc["backend"]["platform"] == "cpu"
    assert doc["backend"]["device_kind"] == "cpu"
    assert doc["kernel_launches"] == {"depth": 0, "pairhmm": 0, "rans": 0,
                                      "indexcov_norm": 0, "swalign": 0}
    assert doc["command"] == "depth" and doc["exit_code"] == 1
    assert doc["argv"][0] == "goleft-tpu-torch depth"
    assert doc["spans"]["run.depth"]["calls"] == 1
    # the card's probe (a child) refused it before this process imported
    # torch or the command
    assert doc["import_seconds"] == 0 and "native_io" in doc
    assert doc["spans"]["device-probe"]["calls"] == 1
    assert "counters" in doc["metrics"] and "stage_seconds" not in doc
    # the run's trace id, of the reference's cli-<pid>-<n> shape
    assert re.fullmatch(r"cli-\d+-\d+", doc["trace_id"])
    assert port.load_manifest(str(out)) == doc
    bad = dict(doc, schema="goleft-tpu.run-manifest/2.0")
    (tmp_path / "bad.json").write_text(__import__("json").dumps(bad))
    for loader in (ref.load_manifest, port.load_manifest):
        with pytest.raises(ValueError, match="major"):
            loader(str(tmp_path / "bad.json"))


def test_cli_lists_depth():
    assert sorted(cli.PROGS) == ["anonymize", "bench", "cnv", "cnveval",
                                 "cohortdepth", "cohortscan", "covstats",
                                 "dcnv", "depth", "depthwed", "emdepth",
                                 "federation", "fleet", "indexcov",
                                 "indexsplit", "lint", "map", "memory",
                                 "multidepth", "pairhmm", "perf",
                                 "profile", "samplename", "serve", "trace",
                                 "warmup"]
    # the reference's 26 subcommands, each in the port
    from goleft_tpu.cli import PROGS as REF_PROGS

    assert sorted(cli.PROGS) == sorted(REF_PROGS)
    assert cli.main(["--help"]) == 0
    assert cli.main(["nope"]) == 1


# ---------------- the torch-free processes ----------------

#: the modules of the processes that never touch the card: the fleet's
#: router and supervisor, the federation, the HTTP clients of the
#: observability surfaces, and what they share with the device commands;
#: the host codecs, and the bench (torch loads inside its entries)
TORCH_FREE_MODULES = [
    "goleft_tpu_torch.fleet", "goleft_tpu_torch.fleet.federation",
    "goleft_tpu_torch.fleet.cachesync",
    "goleft_tpu_torch.commands.fleet",
    "goleft_tpu_torch.commands.federation",
    "goleft_tpu_torch.commands.trace_cmd",
    "goleft_tpu_torch.commands.warmup",
    "goleft_tpu_torch.commands.profile_cmd",
    "goleft_tpu_torch.commands.memory_cmd",
    "goleft_tpu_torch.obs.events", "goleft_tpu_torch.obs.fleetplane",
    "goleft_tpu_torch.resilience.policy", "goleft_tpu_torch.plan",
    "goleft_tpu_torch.io.remote", "goleft_tpu_torch.commands.indexsplit",
    "goleft_tpu_torch.errors", "goleft_tpu_torch.cli",
    "goleft_tpu_torch.parallel.mesh", "goleft_tpu_torch.serve.bisect_bench",
    "goleft_tpu_torch.analysis.cli", "goleft_tpu_torch.plan.lint",
    "goleft_tpu_torch.commands.perf", "goleft_tpu_torch.obs.ledger",
    "goleft_tpu_torch.obs.sentinel",
    "goleft_tpu_torch.io.remote_stub", "goleft_tpu_torch.io.native",
    "goleft_tpu_torch.io.cram", "goleft_tpu_torch.io.rans_nx16",
    "goleft_tpu_torch.io.arith", "goleft_tpu_torch.io.fqzcomp",
    "goleft_tpu_torch.io.tok3", "goleft_tpu_torch.utils.decode_scaling",
    "goleft_tpu_torch.bench", "goleft_tpu_torch.obs.provenance",
    "goleft_tpu_torch.obs.manifest", "goleft_tpu_torch.utils.device_guard",
]


@pytest.mark.parametrize("module", TORCH_FREE_MODULES)
def test_module_loads_no_torch(module):
    """A fresh interpreter that imports the module has neither torch nor
    jax nor the JAX package loaded: the retry policy names KernelFault
    from a torch-free module, so the router, supervisor and federation
    processes that share it never pay torch's import."""
    code = ("import sys, importlib\n"
            f"importlib.import_module({module!r})\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules}\n"
            "             & {'torch', 'jax', 'jaxlib', 'goleft_tpu'})\n"
            "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr
    assert "LOADED []" in r.stdout, r.stdout


def test_init_distributed_without_coordinator_loads_no_torch():
    """The dispatcher joins a world for every command: without
    GOLEFT_TPU_COORDINATOR that is a no-op that imports no torch."""
    code = ("import sys\n"
            "from goleft_tpu_torch.parallel.mesh import init_distributed\n"
            "init_distributed(); init_distributed()\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules}\n"
            "             & {'torch', 'jax', 'jaxlib', 'goleft_tpu'})\n"
            "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("GOLEFT_TPU_COORDINATOR", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr
    assert "LOADED []" in r.stdout, r.stdout


def test_kernel_fault_is_one_class_and_passes_the_retry_policy():
    """The class the kernels raise is the one the retry policy lets
    through unretried; device.py re-exports it."""
    from goleft_tpu_torch import errors
    from goleft_tpu_torch.ops import depth_kernel, pairhmm_kernel
    from goleft_tpu_torch.resilience import policy

    assert device.KernelFault is errors.KernelFault is policy.KernelFault
    assert depth_kernel.KernelFault is pairhmm_kernel.KernelFault \
        is errors.KernelFault
    assert device.NoCudaDevice is errors.NoCudaDevice is cli.NoCudaDevice
    calls = []

    def thunk():
        calls.append(1)
        raise depth_kernel.KernelFault("launch failed")

    with pytest.raises(errors.KernelFault):
        policy.RetryPolicy(retries=3, base_delay_s=0.0).call("k", thunk)
    assert len(calls) == 1


def _fixture_bam(d) -> str:
    from goleft_tpu_torch.io.bai import build_bai, write_bai
    from goleft_tpu_torch.io.bam import BamWriter, parse_cigar

    hdr = ("@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:50000\n"
           "@RG\tID:r\tSM:s0\n")
    bam = os.path.join(str(d), "t.bam")
    with open(bam, "wb") as fh:
        with BamWriter(fh, hdr, ["chr1"], [50000]) as w:
            for i, s in enumerate(range(0, 45000, 60)):
                w.write_record(0, s, parse_cigar("100M"), name=f"r{i}")
    write_bai(build_bai(bam), bam + ".bai")
    return bam


def test_host_commands_load_no_torch(tmp_path):
    """``python -m goleft_tpu_torch`` runs each host command (and the
    new fleet-tier commands, here against nothing; ``lint`` over the
    port and ``perf`` over a round artifact) without loading torch;
    ``--metrics-out`` on a host command writes a manifest of no kernel
    launches, also without torch."""
    bam = _fixture_bam(tmp_path)
    journal = tmp_path / "events.jsonl"
    journal.write_text("")
    perf_dir = tmp_path / "bench"
    perf_dir.mkdir()
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCH_r02.json"), perf_dir)
    dead = "http://127.0.0.1:9"
    runs = [
        (["samplename", bam], 0),
        (["--metrics-out", str(tmp_path / "m.json"), "samplename", bam],
         0),
        (["indexsplit", "-n", "2", bam], 0),
        (["fleet", "events", "--journal", str(journal), "--json"], 0),
        (["trace", "t-1", "--router", dead, "--timeout-s", "2"], 1),
        (["warmup", "export", "--url", dead, "--out",
          str(tmp_path / "w.json")], 1),
        (["memory", "--url", dead], 1),
        (["profile", "--url", dead, "--seconds", "0.1"], 1),
        (["lint", "--only", "plan-boundary"], 0),
        (["perf", "ingest", "--root", str(perf_dir)], 0),
        (["perf", "check", "--root", str(perf_dir)], 0),
        (["perf", "report", "--root", str(perf_dir)], 0),
    ]
    script = textwrap.dedent("""
        import contextlib, io, json, runpy, sys
        rcs = []
        for argv, _ in json.loads(sys.argv[1]):
            sys.argv = ["goleft_tpu_torch"] + argv
            with contextlib.redirect_stdout(io.StringIO()), \\
                    contextlib.redirect_stderr(io.StringIO()):
                try:
                    runpy.run_module("goleft_tpu_torch",
                                     run_name="__main__")
                    rcs.append(0)
                except SystemExit as e:
                    rcs.append(e.code or 0)
        bad = sorted({m.split(".")[0] for m in sys.modules}
                     & {"torch", "jax", "jaxlib", "goleft_tpu"})
        print("RCS", rcs)
        print("LOADED", bad)
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", script, json.dumps(runs)],
                       capture_output=True, text=True, timeout=120,
                       cwd=str(tmp_path), env=env)
    assert r.returncode == 0, r.stderr
    assert f"RCS {[rc for _, rc in runs]}" in r.stdout, r.stdout
    assert "LOADED []" in r.stdout, r.stdout
    from goleft_tpu.obs.manifest import load_manifest

    doc = load_manifest(str(tmp_path / "m.json"))
    assert doc["command"] == "samplename" and doc["exit_code"] == 0
    assert doc["kernel_launches"] == {}
    assert doc["backend"]["platform"] == "cpu"


class _FakeChild:
    """A Popen stand-in that announces a URL and records its argv."""

    seen: list = []

    def __init__(self, argv, **kw):
        import io as _io

        _FakeChild.seen.append(list(argv))
        self.stdout = _io.StringIO("goleft-tpu-torch serve: listening on "
                                   "http://127.0.0.1:1\n")
        self.pid = 4242

    def poll(self):
        return None


@pytest.mark.parametrize("where", ["supervisor", "fleet", "federation"])
def test_default_spawn_runs_the_port(monkeypatch, where):
    """The supervisor's default spawn and the fleet command's spawn run
    ``python -m goleft_tpu_torch serve``; the federation's runs
    ``python -m goleft_tpu_torch fleet`` (Popen replaced; nothing real
    is spawned)."""
    import subprocess as sp

    from goleft_tpu_torch.commands import federation as fed_cmd
    from goleft_tpu_torch.commands import fleet as fleet_cmd
    from goleft_tpu_torch.fleet import supervisor

    _FakeChild.seen = []
    monkeypatch.setattr(sp, "Popen", _FakeChild)
    if where == "supervisor":
        sup = supervisor.Supervisor(worker_args=["--max-batch", "8"],
                                    min_workers=1, max_workers=1)
        _, url = sup._spawn_serve(0)
        want = ["serve", "--port", "0", "--max-batch", "8"]
    elif where == "fleet":
        _, url = fleet_cmd._spawn_worker(["--cache", "c"], {})
        want = ["serve", "--port", "0", "--cache", "c"]
    else:
        _, url = fed_cmd._spawn_fleet(2, [], {})
        want = ["fleet", "--port", "0", "--workers", "2"]
    assert url == "http://127.0.0.1:1"
    (argv,) = _FakeChild.seen
    assert argv[:3] == [sys.executable, "-m", "goleft_tpu_torch"]
    assert argv[3:] == want
