"""The port stands alone: goleft_tpu_torch, chip_smoke.py and its fixture
writer import neither JAX nor the JAX package, and a default run needs a
CUDA card rather than dropping to the CPU."""

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
    yield os.path.join(ROOT, "tools", "bulk_bam.py")


def test_sources_import_neither_jax_nor_reference():
    seen = []
    for path in _sources():
        with open(path) as fh:
            hits = _FORBIDDEN.findall(fh.read())
        assert not hits, f"{path}: {hits}"
        seen.append(os.path.relpath(path, PKG))
    assert len(seen) > 10
    for sub in ("obs", "plan", "resilience", "models", "ops", "commands"):
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


def test_cli_without_cuda_exits_cleanly(monkeypatch, tmp_path, capsys):
    """The CLI's default run asks for the card: without one it exits 1
    with one line naming the cause, and writes its report all the
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
    import json

    rep = json.loads(report.read_text())
    assert rep["exit_code"] == 1
    assert rep["kernel_launches"] == {"depth": 0, "pairhmm": 0}


def test_cli_lists_depth():
    assert sorted(cli.PROGS) == ["depth", "pairhmm"]
    assert cli.main(["--help"]) == 0
    assert cli.main(["nope"]) == 1
