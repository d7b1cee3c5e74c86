"""The port's mesh and sequence-parallel depth
(goleft_tpu_torch/parallel/{mesh,sharded_coverage}.py) against the JAX
package's: best_grid, the rank layout, partition_segments byte for byte,
and sharded_depth_fn in a real Gloo world of 4 spawned processes on the
CPU (grids (2, 2) and (1, 4), both carry modes), whose depth and window
sums must be exactly the reference's on its 8-device CPU mesh."""

import numpy as np
import pytest

from goleft_tpu.parallel import mesh as jmesh
from goleft_tpu.parallel import sharded_coverage as jsc
from goleft_tpu_torch.parallel import mesh as tmesh
from goleft_tpu_torch.parallel import sharded_coverage as tsc
from torch_world import run_world

GRIDS = {"2x2": None, "1x4": 4}  # name → prefer_seq over a world of 4
MODES = ("all_gather", "scan")


def _random_case():
    """tests/test_parallel.py's shapes: shard 4096, window 256, S 4, 900
    segments a sample, 10% keep-masked."""
    rng = np.random.default_rng(0)
    shard_len, window, S, n = 4096, 256, 4, 900
    L = 4 * shard_len
    starts = rng.integers(0, L - 500, size=(S, n)).astype(np.int32)
    ends = (starts + rng.integers(50, 2000, size=(S, n))).astype(np.int32)
    keep = rng.random((S, n)) < 0.9
    return shard_len, window, starts, ends, keep


def _boundary_case():
    """One read over the whole extent and reads straddling every shard
    boundary (tests/test_parallel.py's boundary case)."""
    shard_len, window = 1024, 128
    L = 4 * shard_len
    starts, ends = [0], [L]
    for q in range(1, 4):
        starts.append(q * shard_len - 10)
        ends.append(q * shard_len + 10)
    st = np.tile(np.asarray(starts, np.int32), (2, 1))
    en = np.tile(np.asarray(ends, np.int32), (2, 1))
    return shard_len, window, st, en, np.ones_like(st, dtype=bool)


CASES = {"random": _random_case, "boundary": _boundary_case}

_WORKER = """
from goleft_tpu_torch.parallel.mesh import make_mesh
from goleft_tpu_torch.parallel.sharded_coverage import (
    partition_segments, sharded_depth_fn)
import tests_cases
for grid, prefer in tests_cases.GRIDS.items():
    mesh = make_mesh(prefer_seq=prefer, device="cpu")
    assert (mesh.data_index, mesh.seq_index) == divmod(
        RANK, mesh.shape["seq"])
    for case, build in tests_cases.CASES.items():
        shard_len, window, st, en, kp = build()
        n_seq = mesh.shape["seq"]
        seg = partition_segments(st, en, kp, n_seq, shard_len)
        for mode in tests_cases.MODES:
            fn = sharded_depth_fn(mesh, shard_len, window, carry_mode=mode)
            depth, wsums = fn(*seg)
            assert depth.dtype == torch.int32 and depth.shape == (
                st.shape[0] // mesh.shape["data"], shard_len)
            d, w = fn.assemble(depth, wsums)
            if RANK == 0:
                np.savez(os.path.join(WORK, f"{grid}-{case}-{mode}.npz"),
                         depth=d, wsums=w)
print("WORLD_OK", RANK, flush=True)
"""


@pytest.fixture(scope="module")
def world_results(tmp_path_factory):
    work = tmp_path_factory.mktemp("parallel_world")
    # the worker reads the cases from this module, without jax
    src = open(__file__).read()
    cases = src[src.index("GRIDS = "):src.index("_WORKER = ")]
    (work / "tests_cases.py").write_text(
        "import numpy as np\n" + cases)
    outs = run_world(4, "sys.path.insert(0, WORK)\n" + _WORKER, work,
                     timeout=150)
    for rank, (_, out, _) in enumerate(outs):
        assert f"WORLD_OK {rank}" in out
    return work


def test_best_grid_matches_reference():
    for n in range(1, 17):
        assert tmesh.best_grid(n) == jmesh.best_grid(n)
    assert tmesh.best_grid(8, prefer_seq=8) == (1, 8)
    with pytest.raises(ValueError):
        tmesh.best_grid(8, prefer_seq=3)


@pytest.mark.parametrize("prefer", [None, 8, 2])
def test_rank_layout_is_the_reference_reshape(prefer):
    """Rank r sits where the JAX mesh puts device r: (r // seq, r %
    seq)."""
    jm = jmesh.make_mesh(8, prefer_seq=prefer)
    d, s = tmesh.best_grid(8, prefer)
    assert (jm.shape["data"], jm.shape["seq"]) == (d, s)
    for (i, j), dev in np.ndenumerate(jm.devices):
        m = tmesh.Mesh(d, s, dev.id, "cpu")
        assert (m.data_index, m.seq_index) == (i, j)
        assert m.seq_rank(j) == dev.id


def test_world_of_one_without_a_process_group():
    m = tmesh.make_mesh(device="cpu")
    assert m.shape == {"data": 1, "seq": 1} and m.size == 1
    assert tmesh.world() == (1, 0)


def test_asked_world_that_is_not_up_raises(monkeypatch):
    monkeypatch.delenv("GOLEFT_TPU_COORDINATOR", raising=False)
    monkeypatch.setenv("GOLEFT_TPU_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="asks for a world"):
        tmesh.world()


@pytest.mark.parametrize("layout", ["sorted", "unsorted", "pad_to"])
def test_partition_segments_byte_for_byte(layout):
    rng = np.random.default_rng(17)
    S, n, n_seq, shard_len = 3, 700, 4, 1000
    starts = rng.integers(-50, n_seq * shard_len + 50, (S, n))
    ends = starts + rng.integers(0, 900, (S, n))
    if layout != "unsorted":
        order = np.argsort(starts, axis=1, kind="stable")
        starts = np.take_along_axis(starts, order, 1)
        ends = np.take_along_axis(ends, order, 1)
    starts, ends = starts.astype(np.int32), ends.astype(np.int32)
    keep = rng.random((S, n)) < 0.8
    pad = 512 if layout == "pad_to" else None
    got = tsc.partition_segments(starts, ends, keep, n_seq, shard_len,
                                 pad_to=pad)
    want = jsc.partition_segments(starts, ends, keep, n_seq, shard_len,
                                  pad_to=pad)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_sharded_depth_exactly_the_reference(world_results, grid, case,
                                             mode):
    shard_len, window, st, en, kp = CASES[case]()
    jm = jmesh.make_mesh(4, prefer_seq=GRIDS[grid])
    n_seq = jm.shape["seq"]
    seg = jsc.partition_segments(st, en, kp, n_seq, shard_len)
    fn = jsc.sharded_depth_fn(jm, shard_len, window, carry_mode=mode)
    with jm:
        want_d, want_w = (np.asarray(x) for x in fn(*seg))
    got = np.load(world_results / f"{grid}-{case}-{mode}.npz")
    np.testing.assert_array_equal(got["depth"], want_d)
    assert got["wsums"].dtype == np.float32
    assert got["wsums"].tobytes() == want_w.astype(np.float32).tobytes()


def test_sharded_depth_world_of_one_on_plain_version():
    """A 1 x 1 mesh: the local step alone (the kernel's plain version on
    the CPU), no carry."""
    shard_len, window, st, en, kp = _random_case()
    L = 4 * shard_len
    m = tmesh.make_mesh(device="cpu")
    seg = tsc.partition_segments(st, en, kp, 1, L)
    fn = tsc.sharded_depth_fn(m, L, window)
    d, w = fn.assemble(*fn(*seg))
    jm = jmesh.make_mesh(1)
    want_d, want_w = (np.asarray(x) for x in jsc.sharded_depth_fn(
        jm, L, window)(*jsc.partition_segments(st, en, kp, 1, L)))
    np.testing.assert_array_equal(d, want_d)
    assert w.tobytes() == want_w.astype(np.float32).tobytes()


def test_local_step_goes_negative_before_the_carry():
    """The seq shard's local step: ends of reads that began to the left
    make the local depth negative; the carry brings it back."""
    import torch

    from goleft_tpu_torch.ops import depth_kernel as dk

    lo, L = 1000, 1000
    s = torch.tensor([2000, 1200], dtype=torch.int32)  # pad, a start
    e = torch.tensor([1100, 2000], dtype=torch.int32)  # an end, pad
    keep = torch.ones(2, dtype=torch.bool)
    sums, _, _, depth = dk.fused_depth_batch(
        s, e, [0, 2], lo, lo, lo + L, tsc.NO_CAP, 1, 0, L, 100, keep=keep,
        dense=True)
    assert int(depth[0, 150]) == -1 and int(depth[0, 250]) == 0
    assert float(sums[0, 0]) == 0.0 and float(sums[0, 1]) == -100.0


def test_local_clip_is_the_reference_clip():
    """The local step's clip (``clip_endpoints_plain`` with w0 = rs = lo,
    re = lo + shard_len) is the JAX package's sharded clip: where(keep,
    x - lo, shard_len) clipped to [0, shard_len]."""
    import torch

    from goleft_tpu_torch.ops.depth_kernel import clip_endpoints_plain

    rng = np.random.default_rng(23)
    lo, L = 40_000, 10_000
    s = rng.integers(lo - 3 * L, lo + 3 * L, 5_000).astype(np.int32)
    e = (s + rng.integers(0, 2 * L, 5_000)).astype(np.int32)
    keep = rng.random(5_000) < 0.8
    gs, ge = clip_endpoints_plain(torch.from_numpy(s), torch.from_numpy(e),
                                  torch.from_numpy(keep), lo, lo, lo + L, L)
    for got, x in ((gs, s), (ge, e)):
        want = np.clip(np.where(keep, x - lo, L), 0, L)
        np.testing.assert_array_equal(got.numpy(), want)
