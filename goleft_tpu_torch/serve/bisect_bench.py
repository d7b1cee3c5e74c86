"""Measure serial vs parallel poison-bisection: the counterpart of the JAX
package's serve/bisect_bench.py (pure Python, a copy).

The batcher's ``_run_tree`` isolates a poison request by re-running
each half of a failed batch, recursively — O(log n) levels executed
SERIALLY. The open question: would running the two halves of each
level in parallel (worker threads) pay at realistic batch sizes?

This harness answers it with the cost model that actually governs the
serve path:

  - a pass costs ``overhead_s + per_item_s * len(batch)`` — dispatch
    overhead plus per-item compute (measured depth/pairhmm passes are
    in this shape; both knobs are parameters here)
  - the crucial constraint: DEVICE PASSES ARE SERIALIZED. The real
    executors share one device and one dispatcher; two bisection
    halves "in parallel" still queue on the device, so parallelism
    can only overlap the non-device overhead (host decode, python).
    The harness measures both regimes — ``device_locked=True`` (the
    real one: passes serialize on a lock) and ``device_locked=False``
    (the hypothetical free-parallel device) — so the decision is
    backed by numbers instead of intuition.

Run: ``python -m goleft_tpu_torch.serve.bisect_bench [--json]``.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import sys
import threading
import time


def _simulated_pass(n_items: int, overhead_s: float,
                    per_item_s: float, lock: threading.Lock | None):
    """One batch pass: sleep the modeled cost, under the device lock
    when the real serialization constraint is on."""
    cost = overhead_s + per_item_s * n_items
    if lock is None:
        time.sleep(cost)
        return
    with lock:
        time.sleep(cost)


def _bisect(items: list, poison, overhead_s: float, per_item_s: float,
            lock, pool: cf.ThreadPoolExecutor | None):
    """The batcher's isolation tree over a simulated executor; returns
    the number of passes run. ``pool`` None = serial halves (the
    shipped behavior), else both halves run as pool tasks."""
    _simulated_pass(len(items), overhead_s, per_item_s, lock)
    if poison not in items:
        return 1
    if len(items) == 1:
        return 1
    mid = len(items) // 2
    halves = (items[:mid], items[mid:])
    if pool is None:
        return 1 + sum(
            _bisect(h, poison, overhead_s, per_item_s, lock, None)
            for h in halves)
    futs = [pool.submit(_bisect, h, poison, overhead_s, per_item_s,
                        lock, pool) for h in halves]
    return 1 + sum(f.result() for f in futs)


def measure(batch_sizes=(8, 16, 32), overhead_s: float = 0.010,
            per_item_s: float = 0.004, repeats: int = 3) -> dict:
    """Wall-clock serial vs parallel bisection for a single poison at
    the worst-case position (isolated only at the last level), under
    both device regimes. The default costs are the JAX package's (~10ms
    dispatch overhead, ~4ms per batched sample); pass the port's own."""
    out = {"overhead_s": overhead_s, "per_item_s": per_item_s,
           "entries": []}
    for n in batch_sizes:
        items = list(range(n))
        poison = n - 1  # worst case: survives every split
        entry = {"batch": n}
        for regime, locked in (("device_locked", True),
                               ("free_device", False)):
            res = {}
            for mode in ("serial", "parallel"):
                best = None
                for _ in range(repeats):
                    lock = threading.Lock() if locked else None
                    t0 = time.perf_counter()
                    if mode == "serial":
                        passes = _bisect(items, poison, overhead_s,
                                         per_item_s, lock, None)
                    else:
                        with cf.ThreadPoolExecutor(8) as pool:
                            passes = _bisect(items, poison,
                                             overhead_s, per_item_s,
                                             lock, pool)
                    dt = time.perf_counter() - t0
                    best = dt if best is None else min(best, dt)
                res[mode] = {"seconds": round(best, 4),
                             "passes": passes}
            res["parallel_speedup"] = round(
                res["serial"]["seconds"]
                / res["parallel"]["seconds"], 3)
            entry[regime] = res
        out["entries"].append(entry)
    locked_speedups = [e["device_locked"]["parallel_speedup"]
                       for e in out["entries"]]
    out["decision"] = (
        "serial" if max(locked_speedups) < 1.15 else "parallel")
    out["note"] = (
        "device_locked is the shipped reality (one device, one "
        "dispatcher serializes passes); free_device is the "
        "hypothetical upper bound parallel bisection could reach"
    )
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    r = measure()
    if "--json" in argv:
        print(json.dumps(r, indent=2))
        return 0
    print(f"poison bisection: serial vs parallel halves "
          f"(overhead {r['overhead_s'] * 1e3:g}ms + "
          f"{r['per_item_s'] * 1e3:g}ms/item per pass)")
    for e in r["entries"]:
        dl, fd = e["device_locked"], e["free_device"]
        print(f"  batch {e['batch']:>2}: locked-device "
              f"serial {dl['serial']['seconds']:.3f}s vs parallel "
              f"{dl['parallel']['seconds']:.3f}s "
              f"(x{dl['parallel_speedup']}); free-device "
              f"x{fd['parallel_speedup']} "
              f"({dl['serial']['passes']} passes)")
    print(f"decision: {r['decision']} — {r['note']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
