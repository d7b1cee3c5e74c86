"""covstats: per-BAM coverage/insert-size estimates by read sampling.

A copy of the JAX package's commands/covstats.py over the port's
io/bam.py, io/cram.py and io/bai.py; no device stage, so it needs no
card.

Reference: covstats/covstats.go. The sequential sampling loop (":122-220")
is emulated exactly with vectorized column math over *streamed* decode
chunks (BamStatsAccumulator): skip the first 100k reads, then consume
records until n insert sizes are collected (or EOF, or 2n read-lengths
with zero inserts — single-end early stop), holding only O(n) state. Insert sizes come only from proper pairs upstream
of their mate with a single-M cigar (":169-172"); outliers are trimmed by
the 10-MAD upper filter (":57-76" — including its quirk of dropping the
final element when nothing exceeds the bound); coverage =
(1 - propBad) * mapped * readLenMean / genomeBases (":277").
"""

from __future__ import annotations

import argparse

import numpy as np

from ..io.bai import read_bai
from ..io.bam import ReadColumns, open_bam_file
from ..utils.xopen import xopen

N_MADS = 10
SKIP_READS = 100_000

FLAG_UNMAPPED = 0x4
FLAG_PROPER = 0x2
FLAG_DUP = 0x400
FLAG_QCFAIL = 0x200


def mad_filter(arr: np.ndarray, nmads: int = N_MADS) -> np.ndarray:
    arr = np.sort(arr)
    med = arr[len(arr) // 2]
    upper_diffs = np.sort(arr[len(arr) // 2 + 1 :] - med)
    if len(upper_diffs) == 0:
        return arr[: max(len(arr) - 1, 0)]
    umad = upper_diffs[len(upper_diffs) // 2]
    upper = med + nmads * umad
    over = np.flatnonzero(arr > upper)
    # reference quirk: when nothing exceeds the bound the final element is
    # still dropped (covstats.go:69-75 leaves i at len-1)
    cut = int(over[0]) if len(over) else len(arr) - 1
    return arr[:cut]


def mean_std(arr: np.ndarray) -> tuple[float, float]:
    if len(arr) == 0:
        return 0.0, 0.0
    m = float(np.mean(arr))
    return m, float(np.sqrt(np.mean((arr - m) ** 2)))


class BamStatsAccumulator:
    """Streaming emulation of the reference sampling loop over column
    chunks (covstats.go:122-220).

    State is O(n): bounded size/insert/template banks plus scalar
    counters, so a whole-file scan holds one decode window plus these
    banks — the same memory bound as the reference's record-at-a-time
    loop. ``update`` consumes a chunk; ``done`` flips once the sequential
    loop would have exited (n inserts banked, or the single-end early
    break at the 2n+1-th good record with no inserts yet, covstats.go's
    ``len(insertSizes) == 0`` branch — which fires *before* that record's
    own insert would be appended).
    """

    def __init__(self, n: int, skip: int = SKIP_READS):
        self.n = n
        self.skip = skip
        self.skip_left = skip
        self.total_seen = 0
        self.k = 0
        self.n_unmapped = 0
        self.n_bad = 0
        self.n_dup = 0
        self.n_proper = 0
        self._sizes: list[np.ndarray] = []
        self._n_sizes = 0
        self._total_good = 0
        self._inserts: list[np.ndarray] = []
        self._templates: list[np.ndarray] = []
        self._n_inserts = 0
        self.done = False

    def update(self, cols: ReadColumns) -> None:
        if self.done or cols.n_reads == 0:
            return
        self.total_seen += cols.n_reads
        s0 = 0
        if self.skip_left > 0:
            s0 = min(self.skip_left, cols.n_reads)
            self.skip_left -= s0
            if s0 >= cols.n_reads:
                return
        flag = cols.flag.astype(np.int64)[s0:]
        pos = cols.pos[s0:]
        end = cols.end[s0:]
        mate_pos = cols.mate_pos[s0:]
        tlen = cols.tlen[s0:]
        read_len = cols.read_len[s0:]
        single_m = cols.single_m[s0:]

        unmapped = (flag & FLAG_UNMAPPED) != 0
        mapped = ~unmapped
        bad = mapped & ((flag & (FLAG_DUP | FLAG_QCFAIL)) != 0)
        dup = mapped & ((flag & FLAG_DUP) != 0)
        good = mapped & ~bad
        proper = good & ((flag & FLAG_PROPER) != 0)
        ins_ok = (good & (pos < mate_pos)
                  & ((flag & FLAG_PROPER) != 0) & single_m)

        cum_ins = np.cumsum(ins_ok)
        stop = len(flag)
        hit = np.flatnonzero(cum_ins + self._n_inserts >= self.n)
        if len(hit):
            stop = int(hit[0]) + 1
            self.done = True
        if self._n_inserts == 0:
            # single-end early break: the first good record that finds the
            # size bank already full (cumulative good count = 2n+1) exits
            # before appending its own insert
            cum_good = np.cumsum(good) + self._total_good
            full = np.flatnonzero(cum_good >= 2 * self.n + 1)
            if len(full):
                j = int(full[0])
                if cum_ins[j] - int(ins_ok[j]) == 0 and j + 1 <= stop:
                    stop = j + 1
                    ins_ok[j] = False
                    self.done = True

        sl = slice(0, stop)
        self.k += int(np.sum(mapped[sl]))
        self.n_unmapped += int(np.sum(unmapped[sl]))
        self.n_bad += int(np.sum(bad[sl]))
        self.n_dup += int(np.sum(dup[sl]))
        self.n_proper += int(np.sum(proper[sl]))
        good_sl = good[sl]
        self._total_good += int(np.sum(good_sl))
        room = 2 * self.n - self._n_sizes
        if room > 0:
            sz = read_len[sl][good_sl][:room]
            if len(sz):
                self._sizes.append(sz)
                self._n_sizes += len(sz)
        ins_mask = ins_ok[sl]
        room_i = self.n - self._n_inserts
        if room_i > 0:
            ins = (mate_pos[sl] - end[sl])[ins_mask][:room_i]
            if len(ins):
                self._inserts.append(ins)
                self._templates.append(tlen[sl][ins_mask][:room_i])
                self._n_inserts += len(ins)

    def finalize(self) -> dict:
        import sys

        if not self.done and self.total_seen < self.skip:
            # reference warns only when EOF interrupts the skip loop,
            # i.e. STRICTLY fewer than skipReads records
            # (covstats.go:128-133), and proceeds with whatever remains;
            # a file with exactly skip records stays silent
            print("covstats: not enough reads to sample for bam stats",
                  file=sys.stderr)
        denom = max(self.k + self.n_unmapped, 1)
        st = {
            "prop_bad": self.n_bad / denom,
            "prop_dup": self.n_dup / denom,
            "prop_proper": self.n_proper / denom,
            "prop_unmapped": self.n_unmapped / denom,
            "insert_mean": 0.0, "insert_sd": 0.0,
            "insert_5": 0, "insert_95": 0,
            "template_mean": 0.0, "template_sd": 0.0,
            "read_len_mean": 0.0, "read_len_median": 0.0,
            "max_read_len": 0,
            "histogram": np.zeros(0),
        }
        if self._n_sizes:
            sizes = np.sort(np.concatenate(self._sizes))
            st["read_len_median"] = float(sizes[(len(sizes) - 1) // 2]) - 1
            st["read_len_mean"] = mean_std(sizes)[0]
            st["max_read_len"] = int(sizes[-1])
        if self._n_inserts:
            s_ins = np.sort(np.concatenate(self._inserts))
            l = float(len(s_ins) - 1)
            st["insert_5"] = int(s_ins[int(0.05 * l + 0.5)])
            st["insert_95"] = int(s_ins[int(0.95 * l + 0.5)])
            filt = mad_filter(s_ins)
            st["insert_mean"], st["insert_sd"] = mean_std(filt)
            tfilt = mad_filter(np.sort(np.concatenate(self._templates)))
            st["template_mean"], st["template_sd"] = mean_std(tfilt)
            # lumpy-style normalized template histogram (covstats.go:201-217)
            start = float(st["max_read_len"])
            stop_h = st["template_mean"] + st["template_sd"] * 4
            nbins = int(stop_h - start + 1)
            if nbins > 0:
                h = np.zeros(nbins)
                tv = tfilt[(tfilt >= start) & (tfilt <= stop_h)]
                np.add.at(h, (tv - start).astype(np.int64), 1)
                if len(tv):
                    h /= len(tv)
                st["histogram"] = h
        return st


def bam_stats(cols: ReadColumns, n: int, skip: int = SKIP_READS) -> dict:
    """Emulates BamStats over pre-decoded columns (one-shot form)."""
    acc = BamStatsAccumulator(n, skip)
    acc.update(cols)
    return acc.finalize()


def region_bases(bed_path: str) -> int:
    cov = 0
    with xopen(bed_path) as fh:
        for line in fh:
            t = line.rstrip("\n").split("\t", 4)
            cov += int(t[2]) - int(t[1])
    return cov


HEADER = ("coverage\tinsert_mean\tinsert_sd\tinsert_5th\tinsert_95th\t"
          "template_mean\ttemplate_sd\tpct_unmapped\tpct_bad_reads\t"
          "pct_duplicate\tpct_proper_pair\tread_length\tbam\tsample")


class _SamplingAborted(RuntimeError):
    """A healthy sampling stopped because ANOTHER file failed — never
    the root cause, so the driver must not surface it as the error."""


def _stats_one(path: str, n: int, skip: int,
               region_bases_total: int | None, cancel=None):
    """Full stats for one file — independent of every other file, so
    the driver can fan these out across decode threads. ``cancel`` (a
    threading.Event) aborts the streaming loop between decode windows
    so an in-flight sampling of a huge file can't delay the error exit
    after another file has already failed."""
    # lazy native handle: the compressed file is mmapped and only the
    # decode window is ever inflated, so peak RSS is O(window + n)
    # regardless of file size — matching the reference's streaming
    # record loop (covstats.go:122-220) instead of round 1's eager
    # whole-file inflate
    handle = open_bam_file(path)
    names = ",".join(handle.header.sample_names()) or \
        "<no-read-groups>"
    acc = BamStatsAccumulator(n, skip)
    for cols in handle.stream_columns():
        if cancel is not None and cancel.is_set():
            raise _SamplingAborted(f"covstats: {path}: aborted "
                                   "(another file failed)")
        acc.update(cols)
        if acc.done:
            break
    st = acc.finalize()

    genome_bases = sum(handle.header.ref_lens)
    mapped = 0
    # mapped totals come from the .bai; the reference does the same
    # and only for ".bam" paths (covstats.go:238-249), so CRAM input
    # reports coverage 0.00 there too — deliberate parity
    if not getattr(handle, "is_cram", False):
        try:
            import os

            bai_path = path + ".bai" if os.path.exists(path + ".bai") \
                else path[:-4] + ".bai"
            mapped = read_bai(bai_path).mapped_total
        except (OSError, ValueError):
            pass
    if region_bases_total is not None:
        genome_bases = region_bases_total
    coverage = ((1 - st["prop_bad"]) * mapped * st["read_len_mean"]
                / max(genome_bases, 1))
    st.update(coverage=coverage, bam=path, sample=names)
    return st


def run_covstats(bams: list[str], n: int = 1_000_000,
                 regions: str | None = None, skip: int = SKIP_READS,
                 out=None, processes: int = 4) -> list[dict]:
    import sys

    out = out or sys.stdout
    out.write(HEADER + "\n")
    results = []
    # the target-region total is the same for every file: parse once
    rb_total = region_bases(regions) if regions else None
    # files are independent: fan the sampling across decode threads
    # (native decode releases the GIL); ex.map preserves input order so
    # rows print exactly as the sequential loop would. Beyond-reference:
    # the Go tool samples files one after another (covstats.go:251-262)
    import concurrent.futures as cf

    import threading

    cancel = threading.Event()
    ex = cf.ThreadPoolExecutor(
        max_workers=max(1, min(processes, len(bams))))
    try:
        futures = [ex.submit(_stats_one, p, n, skip, rb_total, cancel)
                   for p in bams]
        # trip the cancel flag the moment ANY sampling fails — the
        # in-order consumer below may still be blocked on an earlier
        # (slow, healthy) file when a later file errors, and that
        # healthy sampling must stop at its next decode window instead
        # of running to completion first
        def _on_done(f):
            if not f.cancelled() and f.exception() is not None:
                cancel.set()

        for f in futures:
            f.add_done_callback(_on_done)
        for f in futures:  # input order; failures abort promptly
            st = f.result()
            results.append(st)
            path, names = st["bam"], st["sample"]
            coverage = st["coverage"]
            out.write(
                f"{coverage:.2f}\t{st['insert_mean']:.2f}"
                f"\t{st['insert_sd']:.2f}"
                f"\t{st['insert_5']}\t{st['insert_95']}"
                f"\t{st['template_mean']:.2f}\t{st['template_sd']:.2f}"
                f"\t{100 * st['prop_unmapped']:.2f}"
                f"\t{100 * st['prop_bad']:.1f}"
                f"\t{100 * st['prop_dup']:.1f}"
                f"\t{100 * st['prop_proper']:.1f}"
                f"\t{st['max_read_len']}\t{path}\t{names}\n"
            )
    except BaseException:
        # one corrupt file must not keep sampling the rest of a large
        # queued cohort before the error reaches the user; the cancel
        # flag also stops samplings already in flight at their next
        # decode-window boundary
        cancel.set()
        ex.shutdown(wait=False, cancel_futures=True)
        # if the in-order consumer tripped on a healthy file's
        # _SamplingAborted, surface the ROOT failure instead
        for g in futures:
            if g.done() and not g.cancelled():
                exc = g.exception()
                if exc is not None and not isinstance(
                        exc, _SamplingAborted):
                    raise exc from None
        raise
    ex.shutdown(wait=True)
    return results


def main(argv=None):
    p = argparse.ArgumentParser(
        "goleft-tpu-torch covstats",
        description="coverage and insert-size stats from sampled reads",
    )
    p.add_argument("-n", type=int, default=1_000_000,
                   help="number of reads to sample for length")
    p.add_argument("-r", "--regions", default=None,
                   help="optional bed of target regions")
    p.add_argument("-f", "--fasta", default=None,
                   help="reference fasta (accepted for reference-CLI "
                        "parity; CRAM decode here never reconstructs "
                        "bases, so it is not required)")
    p.add_argument("-p", "--processes", type=int, default=4,
                   help="files sampled in parallel (decode threads; "
                        "output order is unchanged)")
    from . import add_no_crc_flag, apply_no_crc

    add_no_crc_flag(p)
    p.add_argument("bams", nargs="+")
    a = p.parse_args(argv)
    apply_no_crc(a.no_crc)
    run_covstats(a.bams, n=a.n, regions=a.regions,
                 processes=a.processes)


if __name__ == "__main__":
    main()
