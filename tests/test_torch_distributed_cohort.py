"""The port's cohort matrix across processes
(goleft_tpu_torch/parallel/distributed_cohort.py, cohortdepth's and
cnv's multi-process paths): two real processes on the CPU over Gloo,
samples split between them, byte-identical to the JAX package's
single-process output on tests/test_distributed_cohort.py's 5 BAMs — the
matrix, a cohort smaller than the world (process 1 decodes nothing and
only gathers), and cnv's calls and VCF (EM on process 0). Through the
CLI, process 1 prints nothing to stdout and process 0 only the matrix."""

import os
import sys

import numpy as np
import pytest

from torch_world import REPO, run_world

_CPU_CLI = """\
import sys
sys.path.insert(0, {root!r})
import goleft_tpu_torch.device as d
_r = d.resolve_device
d.resolve_device = lambda device=None: _r("cpu" if device is None
                                          else device)
_rs = d.resolve_devices
d.resolve_devices = lambda devices=None, device=None: _rs(
    devices, "cpu" if device is None else device)
from goleft_tpu_torch import cli
sys.exit(cli.main(sys.argv[1:]))
"""

_WORKER = """
from goleft_tpu_torch.commands.cohortdepth import run_cohortdepth
from goleft_tpu_torch.commands.cnv import run_cnv
assert SIZE == 2
bams = sorted(os.path.join(WORK, f) for f in os.listdir(WORK)
              if f.endswith(".bam"))
fai = os.path.join(WORK, "ref.fa.fai")

class Sink:
    def __init__(self): self.parts = []
    def write(self, s): self.parts.append(s)

def keep(name, text):
    if RANK == 0:
        open(os.path.join(WORK, name), "w").write(text)
    else:
        assert text == "", "only process 0 writes output"

for name, cohort in (("dist_full.tsv", bams), ("dist_one.tsv", bams[:1])):
    sink = Sink()
    rc = run_cohortdepth(cohort, fai=fai, window=500, out=sink,
                         processes=2, device="cpu")
    assert rc == 0
    keep(name, "".join(sink.parts))
sink = Sink()
vcf = os.path.join(WORK, f"dist_cnv{RANK}.vcf")
res = run_cnv(bams, fai=fai, window=2000, out=sink, vcf_out=vcf,
              processes=2, device="cpu")
keep("dist_cnv.tsv", "".join(sink.parts))
if RANK:
    assert res == [] and not os.path.exists(vcf)
print("DISTCOHORT_OK", RANK, flush=True)
"""


class Sink:
    def __init__(self):
        self.parts = []

    def write(self, s):
        self.parts.append(s)

    def text(self):
        return "".join(self.parts)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """tests/test_distributed_cohort.py's 5 BAMs and the JAX package's
    single-process outputs."""
    from goleft_tpu.commands.cnv import run_cnv
    from goleft_tpu.commands.cohortdepth import run_cohortdepth
    from goleft_tpu.io.fai import write_fai
    from helpers import write_bam_and_bai, write_fasta

    d = tmp_path_factory.mktemp("dist_cohort")
    rng = np.random.default_rng(5)
    ref_len = 80_000
    fa = write_fasta(str(d / "ref.fa"), {"chr1": "A" * ref_len})
    write_fai(fa)
    bams = []
    for i in range(5):
        starts = np.sort(rng.integers(0, ref_len - 100, size=1500))
        if i == 2:  # a planted drop for cnv to call
            m = ((starts >= 30_000) & (starts < 50_000)
                 & (rng.random(len(starts)) < 0.65))
            starts = starts[~m]
        reads = [(0, int(s), "100M", 60, 0) for s in starts]
        hdr = ("@HD\tVN:1.6\tSO:coordinate\n"
               f"@SQ\tSN:chr1\tLN:{ref_len}\n@RG\tID:r\tSM:w{i}\n")
        p = str(d / f"w{i}.bam")
        write_bam_and_bai(p, reads, ref_names=("chr1",),
                          ref_lens=(ref_len,), header_text=hdr)
        bams.append(p)
    want = {}
    for name, cohort_ in (("full", bams), ("one", bams[:1])):
        s = Sink()
        run_cohortdepth(cohort_, fai=fa + ".fai", window=500, out=s)
        want[name] = s.text()
    s = Sink()
    calls = run_cnv(bams, fai=fa + ".fai", window=2000, out=s,
                    vcf_out=str(d / "want.vcf"))
    assert any(r[3] == "w2" and r[4] < 2 for r in calls), calls
    want["cnv"] = s.text()
    want["vcf"] = open(d / "want.vcf").read()
    return d, fa, bams, want


@pytest.fixture(scope="module")
def world_run(cohort):
    d = cohort[0]
    outs = run_world(2, _WORKER, d, timeout=150)
    for rank, (_, out, _) in enumerate(outs):
        assert f"DISTCOHORT_OK {rank}" in out
    return d


def test_two_processes_matrix_byte_identical(cohort, world_run):
    assert open(world_run / "dist_full.tsv").read() == cohort[3]["full"]


def test_cohort_smaller_than_the_world(cohort, world_run):
    """One BAM over two processes: process 1 decodes nothing."""
    assert open(world_run / "dist_one.tsv").read() == cohort[3]["one"]


def test_two_processes_cnv_byte_identical(cohort, world_run):
    want = cohort[3]
    assert open(world_run / "dist_cnv.tsv").read() == want["cnv"]
    assert open(world_run / "dist_cnv0.vcf").read() == want["vcf"]


def test_cli_process_one_prints_nothing(cohort, tmp_path):
    """``python -m goleft_tpu_torch cohortdepth`` twice with the three
    variables set (the dispatcher joins the world): process 0's stdout is
    the matrix alone, process 1's is empty."""
    d, fa, bams, want = cohort
    runner = tmp_path / "cpu_cli.py"
    runner.write_text(_CPU_CLI.format(root=REPO))
    outs = run_world(2, "", tmp_path, timeout=150, argv=[
        sys.executable, str(runner), "cohortdepth", "--fai", fa + ".fai",
        "-w", "500", "-p", "2", *bams])
    assert outs[0][1] == want["full"]
    assert outs[1][1] == ""


def test_pack_names_truncates_on_codepoint_boundary():
    from goleft_tpu.parallel.distributed_cohort import (
        _pack_names as j_pack, _unpack_name as j_unpack)
    from goleft_tpu_torch.parallel.distributed_cohort import (
        _pack_names, _unpack_name)

    name = "€" * 100  # 300 utf-8 bytes; 256 % 3 == 1 splits a codepoint
    packed = _pack_names([name, "plain"], pad_to=2)
    assert packed.tobytes() == j_pack([name, "plain"], pad_to=2).tobytes()
    assert _unpack_name(packed[0]) == j_unpack(packed[0]) == "€" * 85
    assert _unpack_name(packed[1]) == "plain"


def test_checkpoint_dir_refused_in_a_world(cohort, tmp_path):
    """``checkpoint_dir``, and ``resume`` without it, are refused on every
    process of a world, before any decode."""
    d, fa, bams, _ = cohort
    code = (
        "from goleft_tpu_torch.commands.cohortdepth import run_cohortdepth\n"
        "import io\n"
        f"for kw in (dict(checkpoint_dir={str(tmp_path / 'ck')!r}),"
        " dict(resume=True)):\n"
        "    try:\n"
        f"        run_cohortdepth({bams!r}, fai={fa + '.fai'!r},"
        " out=io.StringIO(), device='cpu', **kw)\n"
        "    except SystemExit as e:\n"
        "        assert 'multi-process' in str(e)\n"
        "        print('REFUSED', RANK)\n")
    outs = run_world(2, code, tmp_path, timeout=120)
    assert [o[1].split() for o in outs] == [["REFUSED", "0"] * 2,
                                            ["REFUSED", "1"] * 2]
    assert not os.path.exists(tmp_path / "ck")


def test_fai_written_by_process_zero_when_missing(cohort, tmp_path):
    """The reference's ``.fai`` missing at launch: process 0 writes it and
    every process meets at the barrier, whichever sees the file first
    (process 1 starts late, after process 0 has written it)."""
    d, fa, bams, want = cohort
    ref = tmp_path / "ref.fa"
    ref.write_bytes(open(fa, "rb").read())
    code = (
        "import io, time\n"
        "from goleft_tpu_torch.commands.cohortdepth import run_cohortdepth\n"
        "if RANK == 1:\n"
        "    time.sleep(3)\n"
        "buf = io.StringIO()\n"
        f"assert run_cohortdepth({bams!r}, reference={str(ref)!r},"
        " window=500, out=buf, processes=2, device='cpu') == 0\n"
        "if RANK == 0:\n"
        "    open(os.path.join(WORK, 'm.tsv'), 'w').write(buf.getvalue())\n")
    run_world(2, code, tmp_path, timeout=90)
    assert open(tmp_path / "m.tsv").read() == want["full"]
    assert open(str(ref) + ".fai").read() == open(fa + ".fai").read()
