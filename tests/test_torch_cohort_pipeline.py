"""The port's cohort step over a mesh (goleft_tpu_torch/parallel/
{cohort_pipeline,prefetch}.py) against the JAX package's
build_cohort_step, with tests/test_cohort_pipeline.py's planted dropout:
build_cohort_step on (1, 4) and (2, 2) grids, and build_chunked_cohort_step
through run_prefetched_cohort (prefetch depth 0 and 2, and a resumed
checkpoint prefix), in a real Gloo world of 4 spawned CPU processes and
in a world of one.

Depth and window means are exactly the reference's and CN equal. λ: the
reference's step normalises its float32 window means and runs its EM in
float32, the port in float64 (as its ``cnv`` does), so λ is held to the
reference's float32 step at the reference test's own rtol = 1e-5, atol =
1e-6, and to the reference's float64 EM on the float64 normalisation at
rtol = atol = 1e-9 (tests/test_torch_emdepth.py's tolerance)."""

import numpy as np
import pytest

from goleft_tpu.models import emdepth as jem
from goleft_tpu.parallel.cohort_pipeline import build_cohort_step
from goleft_tpu.parallel.mesh import make_mesh as j_make_mesh
from goleft_tpu.parallel.sharded_coverage import partition_segments
from torch_world import run_world

# tests/test_cohort_pipeline.py's monolithic case
MONO = dict(n_seq=4, shard_len=2048, window=256, S=8, n=3000)
# tests/test_prefetch.py's chunked case: three chunks of 4 x 1024
CHUNKED = dict(n_seq=4, shard_len=1024, window=128, n_chunks=3, S=8,
               n=3000)


def mono_case():
    rng = np.random.default_rng(4)
    L = MONO["n_seq"] * MONO["shard_len"]
    S, n = MONO["S"], MONO["n"]
    starts = np.sort(rng.integers(0, L - 150, size=(S, n))).astype(np.int32)
    ends = (starts + 150).astype(np.int32)
    keep = np.ones((S, n), dtype=bool)
    mid = (starts[5] > L // 3) & (starts[5] < L // 2)
    keep[5] = ~(mid & (rng.random(n) < 0.6))
    return starts, ends, keep


def chunked_case():
    rng = np.random.default_rng(11)
    total = CHUNKED["n_chunks"] * CHUNKED["n_seq"] * CHUNKED["shard_len"]
    S, n = CHUNKED["S"], CHUNKED["n"]
    starts = np.sort(
        rng.integers(0, total - 400, size=(S, n))).astype(np.int32)
    # long segments straddle chunk boundaries
    ends = (starts + rng.integers(50, 3000, size=(S, n))).astype(np.int32)
    keep = rng.random((S, n)) < 0.9
    # a dropout in sample 3, so CN varies
    drop = (starts[3] > total // 3) & (starts[3] < total // 2)
    keep[3] &= ~drop
    return starts, ends, keep


_WORKER = """
import pickle
from goleft_tpu_torch.parallel.cohort_pipeline import build_cohort_step
from goleft_tpu_torch.parallel.mesh import make_mesh
from goleft_tpu_torch.parallel.prefetch import run_prefetched_cohort
from goleft_tpu_torch.parallel.sharded_coverage import partition_segments
from goleft_tpu_torch.resilience.checkpoint import CheckpointStore
import cases as C

def save(name, out):
    if RANK == 0:
        with open(os.path.join(WORK, name + ".pkl"), "wb") as fh:
            pickle.dump({k: np.asarray(v) for k, v in out.items()}, fh)

st, en, kp = C.mono_case()
m = C.MONO
for grid, prefer in (("1x4", 4), ("2x2", None)):
    mesh = make_mesh(prefer_seq=prefer, device="cpu")
    assert mesh.shape["seq"] == (4 if prefer else 2)
    shard = m["n_seq"] * m["shard_len"] // mesh.shape["seq"]
    seg = partition_segments(st, en, kp, mesh.shape["seq"], shard)
    save("mono-" + grid, build_cohort_step(mesh, shard, m["window"])(*seg))

c = C.CHUNKED
st, en, kp = C.chunked_case()
mesh = make_mesh(prefer_seq=4, device="cpu")
l_chunk = c["n_seq"] * c["shard_len"]
decoded = []

def decode(ci):
    decoded.append(ci)
    return st - ci * l_chunk, en - ci * l_chunk, kp

for depth in (0, 2):
    save(f"chunked-{depth}", run_prefetched_cohort(
        mesh, c["shard_len"], c["window"], list(range(c["n_chunks"])),
        decode, c["S"], prefetch_depth=depth, processes=2))
ck = os.path.join(WORK, f"ck{RANK}")
store = CheckpointStore(ck)
run_prefetched_cohort(mesh, c["shard_len"], c["window"], [0, 1], decode,
                      c["S"], prefetch_depth=2, checkpoint=store,
                      processes=2)
store.close()
decoded.clear()
store = CheckpointStore(ck, resume=True)
out = run_prefetched_cohort(mesh, c["shard_len"], c["window"], [0, 1, 2],
                            decode, c["S"], prefetch_depth=2,
                            checkpoint=store, processes=2)
store.close()
out["decoded"] = np.asarray(decoded)
save("resumed", out)
print("WORLD_OK", RANK, flush=True)
"""


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    work = tmp_path_factory.mktemp("cohort_world")
    src = open(__file__).read()
    (work / "cases.py").write_text(
        "import numpy as np\n"
        + src[src.index("# tests/test_cohort_pipeline.py's monolithic"):
              src.index("_WORKER = ")])
    outs = run_world(4, "sys.path.insert(0, WORK)\n" + _WORKER, work,
                     timeout=170)
    for rank, (_, out, _) in enumerate(outs):
        assert f"WORLD_OK {rank}" in out

    def load(name):
        import pickle

        with open(work / f"{name}.pkl", "rb") as fh:
            return pickle.load(fh)

    return load


def _reference(starts, ends, keep, n_seq, shard_len, window):
    mesh = j_make_mesh(8, prefer_seq=n_seq)
    step = build_cohort_step(mesh, shard_len, window)
    out = step(*partition_segments(starts, ends, keep, n_seq, shard_len))
    return {k: np.asarray(v) for k, v in out.items()}


def _f64_em(wmeans):
    """The reference's float64 EM on the float64 normalisation of the
    reference's own float32 rounding."""
    vals = np.floor(wmeans + np.float32(0.5)).astype(np.float64)
    med = np.median(vals, axis=1)
    med[med == 0] = 1.0
    wm = (vals / med[:, None] * np.median(med)).T
    lam = np.asarray(jem.em_depth_batch(wm))
    return lam, np.asarray(jem.cn_batch(lam, wm))


def _check(got, want, with_depth=True):
    if with_depth:
        np.testing.assert_array_equal(got["depth"], want["depth"])
    assert got["wmeans"].dtype == np.float32
    assert got["wmeans"].tobytes() == want["wmeans"].tobytes()
    np.testing.assert_array_equal(got["cn"], want["cn"])
    np.testing.assert_allclose(got["lambdas"], want["lambdas"], rtol=1e-5,
                               atol=1e-6)
    lam64, cn64 = _f64_em(want["wmeans"])
    np.testing.assert_allclose(got["lambdas"], lam64, rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(got["cn"], cn64)


@pytest.fixture(scope="module")
def mono_want():
    m = MONO
    return _reference(*mono_case(), m["n_seq"], m["shard_len"], m["window"])


@pytest.fixture(scope="module")
def chunked_want():
    c = CHUNKED
    total = c["n_chunks"] * c["n_seq"] * c["shard_len"]
    return _reference(*chunked_case(), c["n_seq"], total // c["n_seq"],
                      c["window"])


@pytest.mark.parametrize("grid", ["1x4", "2x2"])
def test_cohort_step_matches_reference(world4, mono_want, grid):
    got = world4("mono-" + grid)
    _check(got, mono_want)
    # the planted dropout is called in sample 5
    L = MONO["n_seq"] * MONO["shard_len"]
    w = MONO["window"]
    assert np.median(got["cn"][(L // 3) // w + 1:(L // 2) // w - 1, 5]) < 2


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetched_cohort_matches_reference(world4, chunked_want, depth):
    got = world4(f"chunked-{depth}")
    _check(got, chunked_want)
    np.testing.assert_array_equal(got["carry"], chunked_want["depth"][:, -1])


def test_resumed_prefix_matches_reference(world4, chunked_want):
    got = world4("resumed")
    _check(got, chunked_want)
    # the committed prefix (chunks 0 and 1) is neither decoded nor run
    assert got["decoded"].tolist() == [2]


def test_world_of_one_is_bitwise_the_world_of_four(world4):
    """The chunked path in this process (a 1 x 1 mesh, one shard of the
    whole chunk) against the world of 4: the same bytes."""
    from goleft_tpu_torch.parallel.mesh import make_mesh
    from goleft_tpu_torch.parallel.prefetch import run_prefetched_cohort
    from goleft_tpu_torch.utils.profiling import StageTimer

    c = CHUNKED
    st, en, kp = chunked_case()
    l_chunk = c["n_seq"] * c["shard_len"]
    tm = StageTimer()
    got = run_prefetched_cohort(
        make_mesh(device="cpu"), l_chunk, c["window"],
        list(range(c["n_chunks"])),
        lambda ci: (st - ci * l_chunk, en - ci * l_chunk, kp), c["S"],
        prefetch_depth=2, timer=tm, processes=2, keep_depth=False)
    want = world4("chunked-2")
    assert "depth" not in got
    for k in ("wmeans", "lambdas", "cn", "carry"):
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k
    d = tm.as_dict()
    assert set(d) == {"decode", "stage", "transfer", "compute"}
    assert d["decode"]["calls"] == d["transfer"]["calls"] == 3
    assert d["compute"]["calls"] == 4  # 3 chunks + finalize


def test_prefetcher_transfer_and_memory_clamp():
    """The port's ChunkPrefetcher: ``transfer`` runs on the worker after
    ``produce``, in order; while a memory-pressure controller of the
    process is tripped, one chunk is staged at a time."""
    import threading
    import time

    from goleft_tpu_torch.obs import memplane
    from goleft_tpu_torch.parallel.prefetch import ChunkPrefetcher

    ctl = memplane.PressureController(high_water_bytes=10)
    assert ctl.update(100) == "pressure"
    lock = threading.Lock()
    state = {"now": 0, "peak": 0}

    def produce(i):
        with lock:
            state["now"] += 1
            state["peak"] = max(state["peak"], state["now"])
        time.sleep(0.01)
        with lock:
            state["now"] -= 1
        return i

    def run():
        with ChunkPrefetcher(range(6), produce, depth=4,
                             transfer=lambda v, meta: v + 100,
                             processes=4) as pf:
            return [c.value for c in pf]

    memplane.register_controller(ctl)
    try:
        assert run() == [100 + i for i in range(6)]
        assert state["peak"] == 1
    finally:
        memplane.unregister_controller(ctl)
    state["peak"] = 0
    assert run() == [100 + i for i in range(6)]
    assert state["peak"] > 1
