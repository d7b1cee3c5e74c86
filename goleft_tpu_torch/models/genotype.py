"""Genotype likelihoods from pair-HMM read×haplotype scores: the
counterpart of the JAX package's models/genotype.py, with the same host
f64 arithmetic.

Windows of (reads, candidate haplotypes) flatten into one read×hap batch
for :func:`ops.pairhmm.forward_pairs_partial`; each window's (R, H)
log10 matrix folds into diploid genotype likelihoods

    log10 P(reads | G=(a,b)) = Σ_r log10( (10^ll[r,a] + 10^ll[r,b]) / 2 )

over unordered haplotype pairs a ≤ b in VCF/GATK PL order (index =
b(b+1)/2 + a), normalised to phred PLs with the best genotype at 0 (cap
99999), and GQ = the second-smallest PL (cap 99). A bucket that fails
permanently quarantines exactly the windows with pairs in it.
"""

from __future__ import annotations

import numpy as np

from ..ops import pairhmm as ph

PL_CAP = 99999  # phred cap for zero-likelihood genotypes
GQ_CAP = 99


def genotype_likelihoods(loglik: np.ndarray) -> dict:
    """(R, H) per-read log10 P(read|hap) → {"gl": (G,) log10 likelihoods
    in PL order, "pl": (G,) int, "best": (a, b), "gq": int}. R may be 0
    (flat likelihoods, PL all 0, GQ 0)."""
    ll = np.asarray(loglik, dtype=np.float64)
    n_reads, n_haps = ll.shape
    if n_haps < 1:
        raise ValueError("genotype_likelihoods: need >= 1 haplotype")
    gl = []
    pairs = []
    log2 = np.log10(2.0)
    for b in range(n_haps):
        for a in range(b + 1):
            pairs.append((a, b))
            if n_reads == 0:
                gl.append(0.0)
                continue
            la, lb = ll[:, a], ll[:, b]
            m = np.maximum(la, lb)
            # log10((10^la + 10^lb)/2), stable around the max
            with np.errstate(invalid="ignore"):
                s = m + np.log10(np.power(10.0, la - m)
                                 + np.power(10.0, lb - m)) - log2
            s = np.where(np.isfinite(m), s, -np.inf)
            gl.append(float(np.sum(s)))
    gl = np.array(gl)
    best_i = int(np.argmax(gl))
    mx = gl[best_i]
    with np.errstate(invalid="ignore"):
        pl = np.where(np.isfinite(gl), np.rint(-10.0 * (gl - mx)), PL_CAP)
    pl = np.clip(pl, 0, PL_CAP).astype(np.int64)
    gq = int(min(np.partition(pl, 1)[1], GQ_CAP)) if len(pl) > 1 else 0
    return {"gl": gl, "pl": pl, "best": pairs[best_i], "gq": gq}


def score_windows(windows, *, gap_open: float = ph.DEFAULT_GAP_OPEN,
                  gap_ext: float = ph.DEFAULT_GAP_EXT,
                  dtype=np.float32, quarantine=None,
                  device=None):
    """Score encoded windows (the shape :func:`load_windows` produces)
    → (results, n_quarantined): one dict per surviving window, in input
    order. All windows' pairs run as one bucketed forward batch on
    ``device`` (None: the CUDA card). Windows hit by a permanently
    failed bucket are recorded in ``quarantine`` (when given) and
    skipped."""
    flat_reads, flat_quals, flat_haps, owner = [], [], [], []
    spans = []
    for wi, w in enumerate(windows):
        lo = len(flat_reads)
        for codes, quals in w["reads"]:
            for hap in w["haps"]:
                flat_reads.append(codes)
                flat_quals.append(quals)
                flat_haps.append(hap)
                owner.append(wi)
        spans.append((lo, len(flat_reads)))
    vals, failed = ph.forward_pairs_partial(
        flat_reads, flat_quals, flat_haps, gap_open=gap_open,
        gap_ext=gap_ext, dtype=dtype,
        allow_partial=quarantine is not None, device=device)
    with ph.TIMER.stage("genotype-format"):
        bad_windows = {owner[i]: err for i, err in failed.items()}
        results = []
        for wi, w in enumerate(windows):
            if wi in bad_windows:
                if quarantine is not None:
                    quarantine.add(
                        wi, f"{w['chrom']}:{w['start']}-{w['end']}",
                        w.get("source", ""), bad_windows[wi],
                        classification="permanent", phase="pairhmm")
                continue
            lo, hi = spans[wi]
            n_haps = len(w["haps"])
            n_reads = len(w["reads"])
            ll = vals[lo:hi].reshape(n_reads, n_haps) if n_haps else \
                np.zeros((n_reads, 0))
            g = genotype_likelihoods(ll)
            results.append({
                "chrom": w["chrom"], "start": w["start"], "end": w["end"],
                "n_reads": n_reads, "n_haps": n_haps,
                "genotype": f"{g['best'][0]}/{g['best'][1]}",
                "gq": g["gq"],
                "pl": [int(v) for v in g["pl"]],
                "read_hap_log10": ll,
            })
    return results, len(bad_windows)


HEADER = "#chrom\tstart\tend\treads\thaps\tgenotype\tGQ\tPL\n"


def format_table(results) -> str:
    """The pairhmm output table."""
    lines = [HEADER]
    for r in results:
        lines.append(
            f"{r['chrom']}\t{r['start']}\t{r['end']}\t{r['n_reads']}"
            f"\t{r['n_haps']}\t{r['genotype']}\t{r['gq']}\t"
            + ",".join(str(v) for v in r["pl"]) + "\n")
    return "".join(lines)


def load_windows(doc, source: str = "") -> list[dict]:
    """Validate + encode a pairhmm-windows document (schema
    ``goleft-tpu.pairhmm-windows/1``) into score_windows' input shape.
    Raises ValueError on anything malformed. Qualities: per-read int
    list, phred+33 string, or one int for every base (default 30), then
    clamped to 1..93."""
    if not isinstance(doc, dict):
        raise ValueError("pairhmm windows: document must be a JSON "
                         "object")
    schema = doc.get("schema", "")
    if not str(schema).startswith("goleft-tpu.pairhmm-windows/1"):
        raise ValueError(
            f"pairhmm windows: unsupported schema {schema!r} "
            "(want goleft-tpu.pairhmm-windows/1)")
    raw = doc.get("windows")
    if not isinstance(raw, list):
        raise ValueError("pairhmm windows: 'windows' must be a list")
    out = []
    for n, w in enumerate(raw):
        where = f"window {n}"
        if not isinstance(w, dict):
            raise ValueError(f"pairhmm windows: {where} must be an "
                             "object")
        try:
            chrom = str(w["chrom"])
            start = int(w["start"])
            end = int(w["end"])
        except (KeyError, TypeError, ValueError):
            raise ValueError(
                f"pairhmm windows: {where} needs chrom/start/end") \
                from None
        haps = w.get("haplotypes")
        if not isinstance(haps, list) or not haps:
            raise ValueError(
                f"pairhmm windows: {where} needs a non-empty "
                "'haplotypes' list")
        enc_haps = []
        for h in haps:
            if not isinstance(h, str) or not h:
                raise ValueError(
                    f"pairhmm windows: {where}: haplotypes must be "
                    "non-empty strings")
            enc_haps.append(ph.encode_seq(h))
        reads = []
        for r in w.get("reads", []):
            if not isinstance(r, dict) or not isinstance(
                    r.get("seq"), str) or not r["seq"]:
                raise ValueError(
                    f"pairhmm windows: {where}: each read needs a "
                    "non-empty 'seq' string")
            seq = r["seq"]
            q = r.get("quals", 30)
            if isinstance(q, str):
                quals = np.frombuffer(q.encode("ascii"),
                                      dtype=np.uint8).astype(np.int64) - 33
            elif isinstance(q, (int, float)):
                quals = np.full(len(seq), int(q), dtype=np.int64)
            elif isinstance(q, list):
                quals = np.asarray(q, dtype=np.int64)
            else:
                raise ValueError(
                    f"pairhmm windows: {where}: quals must be a "
                    "phred+33 string, an int, or an int list")
            if len(quals) != len(seq):
                raise ValueError(
                    f"pairhmm windows: {where}: quals length "
                    f"{len(quals)} != seq length {len(seq)}")
            if (quals < 0).any():
                raise ValueError(
                    f"pairhmm windows: {where}: negative quality")
            # phred clamp: q0 would make the emission prior 0 and past
            # ~q93 is noise
            quals = np.clip(quals, 1, 93)
            reads.append((ph.encode_seq(seq), quals))
        out.append({"chrom": chrom, "start": start, "end": end,
                    "haps": enc_haps, "reads": reads, "source": source})
    return out
