"""``goleft_tpu_torch map`` (commands/map_cmd.py) against the JAX
package's ``map`` on a fabricated reference and FASTQ, on the CPU: the
tuple stream and the ``--depth-out`` bed byte for byte, the
``--from-tuples`` rerun, a ``map`` fault retried to the same bytes, the
exit-3 contract on a corrupt FASTQ, and a CLI run without a card."""

import gzip

import numpy as np
import pytest
import torch

from goleft_tpu.commands import map_cmd as ref_map
from goleft_tpu_torch import cli
from goleft_tpu_torch.commands import map_cmd
from goleft_tpu_torch.device import resolve_device

_BASES = b"ACGT"


def _fixture(d, n_reads=90, seed=3):
    rng = np.random.default_rng(seed)
    chroms = {"chr1": bytes(rng.choice(list(_BASES), 3000).tolist()),
              "chr2": bytes(rng.choice(list(_BASES), 1700).tolist())}
    fa = d / "ref.fa"
    fa.write_bytes(b"".join(
        b">%s\n%s\n" % (c.encode(), s) for c, s in chroms.items()))
    recs = []
    for i in range(n_reads):
        c = ["chr1", "chr2"][i % 2]
        rlen = int(rng.integers(60, 151))
        s = int(rng.integers(0, len(chroms[c]) - rlen))
        frag = bytearray(chroms[c][s:s + rlen])
        for _ in range(2):
            frag[int(rng.integers(0, rlen))] = _BASES[int(rng.integers(4))]
        if i % 7 == 0:
            frag[int(rng.integers(0, rlen))] = ord("N")
        if i % 3 == 0:
            frag = bytearray(bytes(frag).translate(
                bytes.maketrans(b"ACGT", b"TGCA"))[::-1])
        recs.append(b"@r%d\n%s\n+\n%s\n"
                    % (i, bytes(frag), b"I" * len(frag)))
    recs.append(b"@tiny\nACG\n+\nIII\n")
    fq = d / "reads.fq.gz"
    fq.write_bytes(gzip.compress(b"".join(recs)))
    return str(fa), str(fq), recs


@pytest.fixture()
def cpu_cli(monkeypatch):
    """The port's CLI with map's default device pointed at the CPU."""
    monkeypatch.setattr(map_cmd, "resolve_device",
                        lambda device=None: resolve_device("cpu"))
    # the card's subprocess probe is skipped: the commands run on the
    # CPU here (utils/device_guard.py)
    monkeypatch.setenv("GOLEFT_TPU_PROBE", "0")
    yield
    from goleft_tpu_torch.resilience import faults

    faults.install(None)


@pytest.mark.parametrize("window,batch", [(250, 4096), (100, 7)])
def test_run_map_is_byte_identical_to_the_reference(tmp_path, window,
                                                    batch):
    fa, fq, _ = _fixture(tmp_path)
    w = dict(tup=tmp_path / "w.tsv", bed=tmp_path / "w.bed")
    g = dict(tup=tmp_path / "g.tsv", bed=tmp_path / "g.bed")
    assert ref_map.main([fa, fq, "-o", str(w["tup"]), "--depth-out",
                         str(w["bed"]), "--window", str(window),
                         "--batch", str(batch)]) == 0
    assert map_cmd.run_map(fa, fq, out=str(g["tup"]), depth_out=str(
        g["bed"]), window=window, batch=batch, device="cpu") == 0
    assert g["tup"].read_bytes() == w["tup"].read_bytes()
    assert g["bed"].read_bytes() == w["bed"].read_bytes()
    assert len(g["tup"].read_bytes().splitlines()) >= 80
    # --from-tuples: the same bed from the written stream
    again = tmp_path / "again.bed"
    assert map_cmd.run_map(fa, out=None, depth_out=str(again),
                           from_tuples=str(g["tup"]), window=window,
                           device="cpu") == 0
    assert again.read_bytes() == w["bed"].read_bytes()


def test_cli_flags_faults_and_from_tuples(tmp_path, cpu_cli):
    fa, fq, _ = _fixture(tmp_path, seed=5)
    want = tmp_path / "w.tsv"
    assert ref_map.main([fa, fq, "-o", str(want), "-k", "11", "-w", "5",
                         "--max-occ", "32", "--band", "24",
                         "--min-support", "3"]) == 0
    args = [fa, fq, "-k", "11", "-w", "5", "--max-occ", "32", "--band",
            "24", "--min-support", "3"]
    got = tmp_path / "g.tsv"
    assert cli.main(["map", *args, "-o", str(got)]) == 0
    assert got.read_bytes() == want.read_bytes()
    # a transient fault at the map site is retried to the same bytes
    faulty = tmp_path / "f.tsv"
    assert cli.main(["--inject-faults", "map:after=1:transient", "map",
                     *args, "-o", str(faulty)]) == 0
    assert faulty.read_bytes() == want.read_bytes()
    bed = tmp_path / "b.bed"
    assert cli.main(["map", fa, "--from-tuples", str(got), "--depth-out",
                     str(bed)]) == 0
    assert bed.read_bytes() and bed.read_bytes().count(b"\n") > 10
    with pytest.raises(SystemExit):
        cli.main(["map", fa, "--from-tuples", str(got)])
    with pytest.raises(SystemExit):
        cli.main(["map", fa])


def test_corrupt_fastq_exits_3_with_the_rows_before_it(tmp_path, capsys):
    fa, _, recs = _fixture(tmp_path, n_reads=40)
    bad = tmp_path / "bad.fq"
    bad.write_bytes(b"".join(recs[:25]) + b"@x\nACGT\n+\nII\n"
                    + b"".join(recs[25:]))
    want = tmp_path / "w.tsv"
    got = tmp_path / "g.tsv"
    assert ref_map.main([fa, str(bad), "-o", str(want), "--batch",
                         "8"]) == 3
    assert map_cmd.run_map(fa, str(bad), out=str(got), batch=8,
                           device="cpu") == 3
    assert got.read_bytes() == want.read_bytes()
    assert len(got.read_bytes().splitlines()) >= 20
    assert "quarantined" in capsys.readouterr().err
    # a FASTQ whose first record is corrupt: exit 1, nothing mapped
    first = tmp_path / "first.fq"
    first.write_bytes(b"@x\nACGT\n+\nII\n" + b"".join(recs))
    assert map_cmd.run_map(fa, str(first), out=str(got),
                           device="cpu") == 1
    assert ref_map.main([fa, str(first), "-o", str(want)]) == 1


def test_map_permanent_fault_quarantines_reads(tmp_path):
    from goleft_tpu_torch.resilience import faults

    fa, fq, _ = _fixture(tmp_path, n_reads=12)
    out = tmp_path / "o.tsv"
    try:
        faults.install("map:every=1:permanent")
        assert map_cmd.run_map(fa, fq, out=str(out), device="cpu") == 3
    finally:
        faults.install(None)
    assert out.read_bytes() == b""


def test_cli_without_cuda_exits_cleanly(monkeypatch, tmp_path, capsys):
    """The default map run asks for the card: without one the CLI exits
    1 with one line naming the cause, before it reads anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("GOLEFT_TPU_DEBUG", raising=False)
    fa, fq, _ = _fixture(tmp_path, n_reads=4)
    out = tmp_path / "o.tsv"
    assert cli.main(["map", fa, fq, "-o", str(out)]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not out.exists()
