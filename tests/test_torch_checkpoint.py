"""The port's checkpoint store and ``cohortdepth --checkpoint-dir /
--resume`` on the CPU, against the JAX package.

- The store cases of tests/test_checkpoint.py on the port's
  ``CheckpointStore``: round trip and journal, a fresh open truncates,
  replay tolerates a torn tail and a vanished block, a corrupt block
  raises clearly, a failed write leaves no tmp file.
- The cohortdepth cases of tests/test_checkpoint.py, with the port's
  matrices held against ``goleft_tpu cohortdepth``'s: a resume is
  byte-identical and decodes nothing; a partial store resumes under
  prefetch; a rewritten input invalidates only its columns;
  ``quarantine.json`` survives a resume; ``--resume`` needs
  ``--checkpoint-dir``; a SIGKILL between commits, then a resume.
- A mid-stream failure quarantines and zero-fills as the JAX package
  does, reached through what the run calls: ``--engine device`` with a
  failing decode, and a permanent ``decode`` fault on a CRAM cohort.
- A store half-written by ``goleft_tpu cohortdepth`` (killed by its own
  ``shard:after=N:kill``) resumes under the port to the same bytes.
"""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from goleft_tpu.commands import cohortdepth as jcd
from goleft_tpu.commands import depth as jdepth
from goleft_tpu.io.fai import write_fai
from goleft_tpu.ops.decode_smoke import make_cram_cohort
from goleft_tpu.resilience import faults as jfaults
from goleft_tpu_torch.commands import cohortdepth as pcd
from goleft_tpu_torch.commands import depth as pdepth
from goleft_tpu_torch.obs import get_registry
from goleft_tpu_torch.resilience import faults as pfaults
from goleft_tpu_torch.resilience.checkpoint import (
    CheckpointCorrupt, CheckpointStore, key_digest,
)
from helpers import random_reads, write_bam_and_bai, write_fasta

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- the store ------------------------------------------------------------

def test_store_roundtrip_and_journal(tmp_path):
    d = str(tmp_path / "ck")
    with CheckpointStore(d) as st:
        assert not st.has(("k", 1))
        assert st.get(("k", 1), default="dflt") == "dflt"
        st.put(("k", 1), {"a": np.arange(3)})
        st.put_many([(("k", 2), "two"), (("k", 3), "three")])
        assert st.has(("k", 1)) and st.has(("k", 3))
        assert st.completed_count == 3
    lines = [json.loads(x) for x in open(os.path.join(d, "journal.jsonl"))]
    assert len(lines) == 3 and all("k" in r and "f" in r for r in lines)
    with CheckpointStore(d, resume=True) as st:
        assert st.completed_count == 3
        np.testing.assert_array_equal(st.get(("k", 1))["a"], np.arange(3))
        assert st.get(("k", 2)) == "two"


def test_put_many_journals_in_item_order_and_reads_back(tmp_path):
    """put_many writes its blocks on WRITE_THREADS threads; the journal
    still lists them in the order given, once each, and every block
    reads back after a resume."""
    d = str(tmp_path / "ck")
    items = [(("blk", i), np.full(i + 1, i, np.float32)) for i in range(50)]
    with CheckpointStore(d) as st:
        st.put_many(items)
    lines = [json.loads(x) for x in open(os.path.join(d, "journal.jsonl"))]
    assert [r["k"] for r in lines] == [key_digest(k) for k, _ in items]
    assert not [f for f in os.listdir(os.path.join(d, "blocks"))
                if f.endswith(".tmp")]
    with CheckpointStore(d, resume=True) as st:
        assert st.completed_count == len(items)
        for k, v in items:
            np.testing.assert_array_equal(st.get(k), v)


def test_store_fresh_open_truncates_journal(tmp_path):
    d = str(tmp_path / "ck")
    with CheckpointStore(d) as st:
        st.put(("k",), 1)
    with CheckpointStore(d) as st:
        assert st.completed_count == 0 and not st.has(("k",))
    with CheckpointStore(d, resume=True) as st:
        assert st.completed_count == 0


def test_store_replay_tolerates_torn_tail_and_missing_blocks(tmp_path):
    d = str(tmp_path / "ck")
    with CheckpointStore(d) as st:
        st.put(("a",), 1)
        st.put(("b",), 2)
        st.put(("c",), 3)
        b_path = os.path.join(d, st._completed[key_digest(("b",))])
    os.remove(b_path)
    with open(os.path.join(d, "journal.jsonl"), "a") as fh:
        fh.write('{"k": "torn')
    with CheckpointStore(d, resume=True) as st:
        assert st.has(("a",)) and st.has(("c",))
        assert not st.has(("b",))


def test_store_corrupt_block_raises_clearly(tmp_path):
    d = str(tmp_path / "ck")
    with CheckpointStore(d) as st:
        st.put(("k",), 1)
        path = os.path.join(d, st._completed[next(iter(st._completed))])
    with open(path, "wb") as fh:
        fh.write(b"not a pickle")
    with CheckpointStore(d, resume=True) as st:
        with pytest.raises(CheckpointCorrupt, match="--resume"):
            st.get(("k",))


def test_store_tmp_unlinked_on_failed_write(tmp_path):
    d = str(tmp_path / "ck")
    with CheckpointStore(d) as st:
        with pytest.raises(Exception):
            st.put(("k",), lambda: None)  # unpicklable
        assert not st.has(("k",))
    assert os.listdir(os.path.join(d, "blocks")) == []


@pytest.mark.parametrize("note", [False, True])
def test_store_files_read_by_the_reference_store(tmp_path, note):
    """Same digests, same journal lines, same pickles: each package's
    store replays the other's."""
    from goleft_tpu.resilience.checkpoint import (
        CheckpointStore as JStore, key_digest as jdigest,
    )

    key = ("cohortdepth", ("/x.bam", 10, 123), 200, 1, ("chr1", 0, 1000))
    assert key_digest(key) == jdigest(key)
    for writer, reader in ((CheckpointStore, JStore),
                           (JStore, CheckpointStore)):
        d = str(tmp_path / f"ck_{writer.__module__}")
        with writer(d) as st:
            st.put(key, np.arange(5, dtype=np.int64))
            if note:
                st.note(phase="one")
        with reader(d, resume=True) as st:
            np.testing.assert_array_equal(st.get(key), np.arange(5))
            assert st.meta == ({"phase": "one"} if note else {})


# ---- cohortdepth ------------------------------------------------------------

def _cohort(tmp_path, n=3, ref_len=4000, seed=0):
    rng = np.random.default_rng(seed)
    fa = write_fasta(str(tmp_path / "r.fa"), {"chr1": "A" * ref_len})
    write_fai(fa)
    bams = []
    for i in range(n):
        hdr = ("@HD\tVN:1.6\tSO:coordinate\n"
               f"@SQ\tSN:chr1\tLN:{ref_len}\n@RG\tID:r\tSM:s{i}\n")
        p = str(tmp_path / f"s{i}.bam")
        write_bam_and_bai(p, random_reads(rng, 400, 0, ref_len),
                          ref_names=("chr1",), ref_lens=(ref_len,),
                          header_text=hdr)
        bams.append(p)
    return fa, bams


def _port(bams, fa, **kw):
    buf = io.StringIO()
    rc = pcd.run_cohortdepth(bams, reference=fa, window=200, out=buf,
                             processes=2, device="cpu", **kw)
    return rc, buf.getvalue()


def _jax(bams, fa, **kw):
    buf = io.StringIO()
    rc = jcd.run_cohortdepth(bams, reference=fa, window=200, out=buf,
                             processes=2, **kw)
    return rc, buf.getvalue()


@pytest.fixture()
def four_regions(monkeypatch):
    monkeypatch.setattr(jdepth, "STEP", 1000)
    monkeypatch.setattr(pdepth, "STEP", 1000)
    monkeypatch.setattr(pcd, "STEP", 1000)


class _Counting:
    """Counts the port's decode calls on both engines: the device
    engine's segment decode and the hybrid engine's window_reduce."""

    def __init__(self, monkeypatch):
        from goleft_tpu_torch.io.bam import BamFile

        self.n = 0
        real_seg = pcd._decode_shard_segments
        real_wr = BamFile.window_reduce

        def seg(*a, **kw):
            self.n += 1
            return real_seg(*a, **kw)

        def wr(h, *a, **kw):
            self.n += 1
            return real_wr(h, *a, **kw)

        monkeypatch.setattr(pcd, "_decode_shard_segments", seg)
        monkeypatch.setattr(BamFile, "window_reduce", wr)


@pytest.mark.parametrize("engine", ["auto", "device"])
def test_resume_byte_identical_and_decodes_nothing(tmp_path, monkeypatch,
                                                   four_regions, engine):
    fa, bams = _cohort(tmp_path)
    rc, want = _jax(bams, fa)
    assert rc == 0 and want.count("\n") == 21
    ck = str(tmp_path / "ck")
    rc, got = _port(bams, fa, engine=engine, checkpoint_dir=ck)
    assert rc == 0 and got == want
    counting = _Counting(monkeypatch)
    resumed = get_registry().counter("checkpoint.shards_resumed_total")
    before = resumed.value
    rc, res = _port(bams, fa, engine=engine, checkpoint_dir=ck, resume=True)
    assert rc == 0 and res == want
    assert counting.n == 0
    assert resumed.value == before + 4 * 3  # regions x samples


def test_resume_with_prefetch_and_partial_store(tmp_path, four_regions):
    fa, bams = _cohort(tmp_path, seed=2)
    rc, want = _jax(bams, fa)
    ck = str(tmp_path / "ck")
    rc, _ = _port(bams, fa, checkpoint_dir=ck)
    jp = os.path.join(ck, "journal.jsonl")
    lines = open(jp).read().splitlines(keepends=True)
    with open(jp, "w") as fh:
        fh.writelines(lines[:3])  # one region x 3 samples
    rc, res = _port(bams, fa, checkpoint_dir=ck, resume=True,
                    prefetch_depth=2)
    assert rc == 0 and res == want


def test_stale_input_invalidates_only_its_shards(tmp_path, four_regions):
    fa, bams = _cohort(tmp_path, seed=3)
    ck = str(tmp_path / "ck")
    rc, cold = _port(bams, fa, checkpoint_dir=ck)
    rng = np.random.default_rng(99)
    hdr = ("@HD\tVN:1.6\tSO:coordinate\n"
           "@SQ\tSN:chr1\tLN:4000\n@RG\tID:r\tSM:s1\n")
    write_bam_and_bai(bams[1], random_reads(rng, 300, 0, 4000),
                      ref_names=("chr1",), ref_lens=(4000,),
                      header_text=hdr)
    written = get_registry().counter("checkpoint.shards_written_total")
    before = written.value
    rc, fresh = _port(bams, fa, checkpoint_dir=ck, resume=True)
    assert rc == 0
    rc, want = _jax(bams, fa)
    assert fresh == want and fresh != cold
    # every region recomputes (no region is whole), all columns commit
    assert written.value == before + 4 * 3


def test_quarantine_json_survives_resume(tmp_path, four_regions):
    fa, bams = _cohort(tmp_path, seed=6)
    with open(bams[2], "r+b") as fh:
        fh.write(b"\xff" * 64)
    ck = str(tmp_path / "ck")
    jck = str(tmp_path / "jck")
    rc, out = _port(bams, fa, checkpoint_dir=ck)
    jrc, jout = _jax(bams, fa, checkpoint_dir=jck)
    assert rc == jrc == 3 and out == jout
    qp = os.path.join(ck, "quarantine.json")
    assert [e["source"] for e in json.load(open(qp))["quarantined"]] \
        == [bams[2]]
    rc2, out2 = _port(bams, fa, checkpoint_dir=ck, resume=True,
                      prefetch_depth=2)
    assert rc2 == 3 and out2 == out
    assert [e["source"] for e in json.load(open(qp))["quarantined"]] \
        == [bams[2]]


def test_resume_requires_checkpoint_dir(tmp_path, capsys):
    with pytest.raises(SystemExit):
        pcd.main(["--resume", "x.bam"])
    assert "--resume requires --checkpoint-dir" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="requires --checkpoint-dir"):
        pcd.run_cohortdepth(["x.bam"], fai="x.fai", resume=True,
                            out=io.StringIO(), device="cpu")


def _failing(real, cut):
    def failing(h, bai, tid, s, e, mapq, *a, **kw):
        if s >= cut:
            raise ValueError("simulated mid-stream corruption")
        return real(h, bai, tid, s, e, mapq, *a, **kw)
    return failing


def test_midstream_failure_quarantines_and_zero_fills_as_jax(
        tmp_path, monkeypatch, four_regions, capsys):
    """tests/test_checkpoint.py's mid-stream case, on the path that calls
    ``_decode_shard_segments``: the device engine, in both packages."""
    fa, bams = _cohort(tmp_path, seed=4)
    rc, cold = _jax(bams, fa)
    monkeypatch.setattr(jcd, "_decode_shard_segments",
                        _failing(jcd._decode_shard_segments, 2000))
    monkeypatch.setattr(pcd, "_decode_shard_segments",
                        _failing(pcd._decode_shard_segments, 2000))
    ck, jck = str(tmp_path / "ck"), str(tmp_path / "jck")
    jrc, want = _jax(bams, fa, engine="device", checkpoint_dir=jck)
    rc, out = _port(bams, fa, engine="device", checkpoint_dir=ck)
    assert rc == jrc == 3 and out == want
    assert out.count("\n") == cold.count("\n")
    assert out.splitlines()[:11] == cold.splitlines()[:11]
    assert out.splitlines()[11].split("\t")[3:] == ["0", "0", "0"]
    q = json.load(open(os.path.join(ck, "quarantine.json")))
    assert q == json.load(open(os.path.join(jck, "quarantine.json")))
    assert len(q["quarantined"]) == 3
    assert {e["phase"] for e in q["quarantined"]} == {"decode"}
    assert "quarantined" in capsys.readouterr().err
    # quarantined columns are not committed: a resume fails again the same
    rc2, out2 = _port(bams, fa, engine="device", checkpoint_dir=ck,
                      resume=True)
    assert rc2 == 3 and out2 == out


def test_permanent_decode_fault_with_checkpoint_as_jax(tmp_path):
    """The mid-stream failure on a CRAM cohort through a permanent
    ``decode`` fault (the device rANS decode's Step), under a checkpoint
    store: the same exit code, matrix and quarantine as goleft_tpu."""
    crams, fai = make_cram_cohort(str(tmp_path))
    spec = "decode:after=2:permanent"
    outs = []
    for name, mod, run in (
            ("jck", jfaults, lambda ck: jcd.run_cohortdepth(
                crams, fai=fai, window=500, out=buf, processes=1,
                decode_device=True, checkpoint_dir=ck)),
            ("ck", pfaults, lambda ck: pcd.run_cohortdepth(
                crams, fai=fai, window=500, out=buf, processes=1,
                decode_device=True, checkpoint_dir=ck, device="cpu"))):
        buf = io.StringIO()
        ck = str(tmp_path / name)
        mod.install(spec)
        try:
            rc = run(ck)
        finally:
            mod.install(None)
        q = json.load(open(os.path.join(ck, "quarantine.json")))
        outs.append((rc, buf.getvalue(),
                     [(e["sample"], e["phase"], e["classification"])
                      for e in q["quarantined"]]))
    assert outs[0] == outs[1]
    assert outs[1][0] == 3 and len(outs[1][2]) == 1


_CPU_CLI = """\
import sys
sys.path.insert(0, {root!r})
import goleft_tpu_torch.device as d
_r = d.resolve_device
d.resolve_device = lambda device=None: _r("cpu" if device is None
                                          else device)
from goleft_tpu_torch import cli
sys.exit(cli.main(sys.argv[1:]))
"""


def _bed_cohort(tmp_path):
    fa, bams = _cohort(tmp_path, ref_len=6000, seed=5)
    bed = str(tmp_path / "regions.bed")
    with open(bed, "w") as fh:
        for lo in range(0, 6000, 1000):
            fh.write(f"chr1\t{lo}\t{lo + 1000}\n")
    return fa, bams, bed


def test_sigkill_crash_resume_subprocess(tmp_path):
    """A checkpointed run of the port's CLI killed by SIGKILL between
    journal commits, then resumed: the JAX package's bytes, and the
    replay skips the committed columns (the run manifest's counters)."""
    fa, bams, bed = _bed_cohort(tmp_path)
    rc, want = _jax(bams, fa, bed=bed)
    runner = tmp_path / "cpu_cli.py"
    runner.write_text(_CPU_CLI.format(root=ROOT))
    env = dict(os.environ)
    env.pop("GOLEFT_TPU_FAULTS", None)
    base = [sys.executable, str(runner), "cohortdepth", "-r", fa, "-w",
            "200", "-b", bed, "-p", "2"]
    ck = str(tmp_path / "ck")
    kill = subprocess.run(base + ["--checkpoint-dir", ck, "--inject-faults",
                                  "shard:after=4:kill"] + bams,
                          env=env, capture_output=True, timeout=300)
    assert kill.returncode == -9, kill.stderr.decode()
    committed = sum(1 for _ in open(os.path.join(ck, "journal.jsonl")))
    assert committed == 3 * 3  # 3 regions x 3 samples, then the kill
    manifest = str(tmp_path / "resume.json")
    res = subprocess.run(base + ["--checkpoint-dir", ck, "--resume",
                                 "--metrics-out", manifest] + bams,
                         env=env, capture_output=True, timeout=300)
    assert res.returncode == 0, res.stderr.decode()
    assert res.stdout.decode() == want
    counters = json.load(open(manifest))["metrics"]["counters"]
    assert counters["checkpoint.shards_resumed_total"] == committed
    assert counters["checkpoint.journal_entries_replayed"] == committed
    assert counters["checkpoint.shards_written_total"] == 3 * 3


def test_store_written_by_goleft_tpu_resumes_under_the_port(tmp_path):
    """``goleft_tpu cohortdepth`` killed by its own shard:after=N:kill
    leaves a half-written store; the port resumes it to the same bytes,
    restoring the reference's committed columns."""
    fa, bams, bed = _bed_cohort(tmp_path)
    rc, want = _jax(bams, fa, bed=bed)
    env = dict(os.environ, JAX_PLATFORMS="cpu", GOLEFT_TPU_PROBE="0",
               PYTHONPATH=ROOT)
    env.pop("GOLEFT_TPU_FAULTS", None)
    ck = str(tmp_path / "ck")
    kill = subprocess.run(
        [sys.executable, "-m", "goleft_tpu", "cohortdepth", "-r", fa, "-w",
         "200", "-b", bed, "-p", "2", "--checkpoint-dir", ck,
         "--inject-faults", "shard:after=3:kill"] + bams,
        env=env, capture_output=True, timeout=300)
    assert kill.returncode in (-9, 137), kill.stderr.decode()
    committed = sum(1 for _ in open(os.path.join(ck, "journal.jsonl")))
    assert committed == 2 * 3
    reg = get_registry()
    resumed0 = reg.counter("checkpoint.shards_resumed_total").value
    written0 = reg.counter("checkpoint.shards_written_total").value
    rc, got = _port(bams, fa, bed=bed, checkpoint_dir=ck, resume=True)
    assert rc == 0 and got == want
    assert reg.counter("checkpoint.shards_resumed_total").value \
        == resumed0 + committed
    assert reg.counter("checkpoint.shards_written_total").value \
        == written0 + 6 * 3 - committed
