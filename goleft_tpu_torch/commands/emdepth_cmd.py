"""emdepth: EM copy-number calls from a depth matrix, on the CUDA card.

The counterpart of the JAX package's commands/emdepth_cmd.py, with the
same flags and output bytes. It reads a depthwed-style matrix
(``#chrom start end sample...``), scales each sample to its median, runs
the batched EM (models/emdepth.py) on the card in ``EM_CHUNK``-window
chunks, merges the per-window calls on the host with the 30 kb
streaming rule, and writes per-sample CNV calls as

  chrom  start  end  sample  CN  log2FC

Optional outputs: the per-window CN matrix (``--matrix-out``), the
merged calls as VCF 4.2 (``--vcf``), the cn.mops posterior-CN matrix and
information gain (``--mops-out``, ``--gain-out``, models/mops.py, on the
card too) and the calls as ``pairhmm --candidates`` intervals
(``--candidates-out``).

Stages (the ``--metrics-out`` manifest's ``spans``): ``matrix-read``,
``normalize`` (the per-sample medians), ``mops``, ``em-chunk`` (one per
chunk: the raw rows copied up and scaled on the card, the EM and CN,
the results copied down), ``merge`` and ``output``.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import sys

import numpy as np
import torch

from .. import obs
from ..device import resolve_device, resolve_devices
from ..models import emdepth as em
from ..utils.dtypes import preferred_float
from ..utils.profiling import StageTimer
from ..utils.xopen import xopen

TIMER = StageTimer()

EM_CHUNK = 16384  # windows per device batch


def read_matrix(path: str):
    """depthwed matrix → (chroms, starts, ends, depths (B, S), samples)."""
    chroms, starts, ends, rows = [], [], [], []
    with TIMER.stage("matrix-read"), xopen(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        samples = header[3:]
        for line in fh:
            t = line.rstrip("\n").split("\t")
            chroms.append(t[0])
            starts.append(int(t[1]))
            ends.append(int(t[2]))
            rows.append([float(x) for x in t[3:]])
    return (np.array(chroms), np.array(starts), np.array(ends),
            np.array(rows, dtype=preferred_float()), samples)


_TORCH_FLOAT = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}


def _norm_chunk(chunk: np.ndarray, med, medmed, dtype,
                device) -> torch.Tensor:
    """A chunk of the matrix on ``device`` in the compute dtype, scaled
    there by the elementwise ``v / med * median(med)``. The rows go up as
    they are (``cnv``'s int16 matrix: a quarter of the f64 bytes). IEEE
    division and multiplication round alike on the card and the host,
    so the values equal the host's, where the merge scales its rows."""
    t = torch.from_numpy(chunk).to(device).to(_TORCH_FLOAT[np.dtype(dtype)])
    if med is None:
        return t
    m = torch.from_numpy(np.asarray(med, dtype)).to(device)
    return torch.div(t, m).mul_(medmed)


def _batched_em(depths: np.ndarray, med=None, medmed=None, dtype=None,
                device=None, devices=None):
    """(λ (B, 9), CN (B, S) int8): the EM in ``EM_CHUNK``-window chunks,
    each chunk scaled on its device by ``med``/``medmed``
    (:func:`_norm_chunk`). The chunks split over ``devices``
    (:func:`~goleft_tpu_torch.device.resolve_devices`: every visible card
    unless the caller names ``device`` or a list), chunk k on device k
    mod n, one thread a device; every row is independent and each chunk
    keeps its shape, so the result is bitwise the one device's. The JAX
    package pads the last chunk with ones so that ``jit`` compiles one
    shape; eager PyTorch compiles nothing, so the last chunk runs at its
    own size."""
    devs = resolve_devices(devices, device)
    dtype = dtype or (depths.dtype if depths.dtype.kind == "f"
                      else preferred_float())
    lams = np.empty((len(depths), em.N_LAMBDA), dtype)
    cns = np.empty(depths.shape, np.int8)

    offsets = list(range(0, len(depths), EM_CHUNK))
    # the device threads' spans parent under the caller's span
    span_ctx = obs.capture()

    def one_device(k):
        for lo in offsets[k::len(devs)]:
            with obs.attach(span_ctx), TIMER.stage("em-chunk"):
                c = _norm_chunk(depths[lo:lo + EM_CHUNK], med, medmed,
                                dtype, devs[k])
                lam = em.em_depth_batch(c)
                cn = em.cn_batch(lam, c)
                lams[lo:lo + len(c)] = lam.cpu().numpy()
                cns[lo:lo + len(c)] = cn.cpu().numpy()

    with cf.ThreadPoolExecutor(len(devs)) as ex:
        for f in [ex.submit(one_device, k) for k in range(len(devs))]:
            f.result()
    return lams, cns


def _mops_outputs(chroms, starts, ends, depths, samples, med, medmed,
                  dtype, mops_out: str | None, gain_out: str | None,
                  device):
    """cn.mops outputs over the same normalised matrix the EM consumes:
    the per-window posterior CN matrix and/or the per-window information
    gain, in ``EM_CHUNK`` batches on ``device``."""
    from ..models import mops

    fhs = {}
    if mops_out:
        fhs["cn"] = xopen(mops_out, "w")
        fhs["cn"].write("#chrom\tstart\tend\t" + "\t".join(samples)
                        + "\n")
    if gain_out:
        fhs["gain"] = xopen(gain_out, "w")
        fhs["gain"].write("#chrom\tstart\tend\tgain\n")
    try:
        for lo in range(0, len(depths), EM_CHUNK):
            chunk = _norm_chunk(depths[lo:lo + EM_CHUNK], med, medmed,
                                dtype, device)
            aik = mops.mops_batch(chunk)["aik"]
            if "cn" in fhs:
                cn = mops.posterior_cn(aik).cpu().numpy()
                for i in range(len(cn)):
                    b = lo + i
                    fhs["cn"].write(
                        f"{chroms[b]}\t{starts[b]}\t{ends[b]}\t"
                        + "\t".join(str(int(c)) for c in cn[i]) + "\n"
                    )
            if "gain" in fhs:
                g = mops.information_gain(aik).cpu().numpy()
                for i in range(len(g)):
                    b = lo + i
                    fhs["gain"].write(
                        f"{chroms[b]}\t{starts[b]}\t{ends[b]}\t"
                        f"{float(g[i]):.4f}\n"
                    )
    finally:
        for fh in fhs.values():
            fh.close()


def sample_medians(depths: np.ndarray):
    """(med, medmed): each sample's median depth (0 → 1) and the median
    of those, a column at a time so an integer matrix never converts
    wholesale to float."""
    med = np.empty(depths.shape[1], dtype=np.float64)
    for j in range(depths.shape[1]):
        med[j] = np.median(depths[:, j])
    med[med == 0] = 1.0
    return med, float(np.median(med))


def call_cnvs(chroms, starts, ends, depths, samples, out=None,
              normalize: bool = True, matrix_out: str | None = None,
              vcf_out: str | None = None, mops_out: str | None = None,
              gain_out: str | None = None,
              contig_lengths: dict | None = None,
              ref_fasta: str | None = None,
              ref_fai: str | None = None,
              candidates_out: str | None = None, device=None):
    """EM copy-number calls from in-memory matrix arrays (``cnv`` passes
    the cohort matrix here directly) on ``device`` (the card unless
    ``"cpu"``) → the merged calls as (chrom, start, end, sample, CN,
    log2FC) tuples, also written to ``out``. The EM's chunks split over
    every visible card unless the caller names ``device``."""
    dev = resolve_device(device)
    out = out or sys.stdout
    if len(depths) == 0:
        return
    dt = depths.dtype if depths.dtype.kind == "f" else preferred_float()
    med = medmed = None
    if normalize:
        with TIMER.stage("normalize"):
            med, medmed = sample_medians(depths)

    if mops_out or gain_out:
        with TIMER.stage("mops"):
            _mops_outputs(chroms, starts, ends, depths, samples, med,
                          medmed, dt, mops_out, gain_out, dev)
    # every window's CN row comes back with its λ: the merge reads the
    # CN of aberrant windows from it, with no device call per window
    lambdas, cns = _batched_em(depths, med, medmed, dt, device=device)
    if matrix_out:
        with TIMER.stage("output"), open(matrix_out, "w") as mf:
            mf.write("#chrom\tstart\tend\t" + "\t".join(samples) + "\n")
            for b in range(len(cns)):
                mf.write(
                    f"{chroms[b]}\t{starts[b]}\t{ends[b]}\t"
                    + "\t".join(str(int(c)) for c in cns[b]) + "\n"
                )
    out.write("#chrom\tstart\tend\tsample\tCN\tlog2FC\n")
    cache = em.Cache()
    results = []

    def emit(cnvs, chrom):
        for c in cnvs:
            results.append(
                (chrom, c.positions[0][0], c.positions[-1][1],
                 samples[c.sample_i],
                 int(round(np.median(c.cn))),
                 float(np.mean(c.log2fc)))
            )

    # hoisted normalisation constants: the per-window loop runs B times
    med_dt = med.astype(dt) if med is not None else None
    mm = np.dtype(dt).type(medmed) if med is not None else None
    cur = None
    with TIMER.stage("merge"):
        for b in range(len(depths)):
            if chroms[b] != cur:
                emit(cache.clear(None), cur)
                cache = em.Cache()
                cur = chroms[b]
            row = depths[b].astype(dt)  # always a fresh copy
            if med_dt is not None:
                np.divide(row, med_dt, out=row)
                np.multiply(row, mm, out=row)
            e = em.EMD(lambdas[b], row, int(starts[b]), int(ends[b]),
                       cns[b])
            emit(cache.add(e), cur)
        emit(cache.clear(None), cur)
    with TIMER.stage("output"):
        for chrom, s, e, sample, cn, fc in results:
            out.write(f"{chrom}\t{s}\t{e}\t{sample}\t{cn}\t{fc:.3f}\n")
        if vcf_out:
            from ..utils.vcf import write_cnv_vcf

            write_cnv_vcf(vcf_out, results, samples,
                          contig_lengths=contig_lengths,
                          ref_fasta=ref_fasta, ref_fai=ref_fai)
        if candidates_out:
            from ..models.candidates import (
                candidates_from_calls, write_candidates,
            )

            write_candidates(candidates_out,
                             candidates_from_calls(results), "emdepth")
    return results


def run_emdepth(matrix_path: str, out=None, normalize: bool = True,
                matrix_out: str | None = None,
                vcf_out: str | None = None,
                mops_out: str | None = None,
                gain_out: str | None = None,
                candidates_out: str | None = None, device=None):
    """The CLI body on ``device`` (the card unless ``"cpu"``) → the
    merged calls."""
    resolve_device(device)  # no card: fail before the matrix is read
    return call_cnvs(*read_matrix(matrix_path), out=out,
                     normalize=normalize, matrix_out=matrix_out,
                     vcf_out=vcf_out, mops_out=mops_out,
                     gain_out=gain_out, candidates_out=candidates_out,
                     device=device)


def main(argv=None):
    p = argparse.ArgumentParser(
        "goleft-tpu-torch emdepth",
        description="EM copy-number calls from a depthwed matrix, on the "
                    "CUDA card",
    )
    p.add_argument("--no-normalize", action="store_true",
                   help="input is already normalized")
    p.add_argument("--matrix-out", default=None,
                   help="also write the per-window CN matrix here")
    p.add_argument("--vcf", default=None,
                   help="also write merged CNV calls as VCF 4.2 "
                        "(<DEL>/<DUP> symbolic alleles, GT:CN:L2FC)")
    p.add_argument("--mops-out", default=None,
                   help="write the cn.mops posterior-CN matrix here")
    p.add_argument("--gain-out", default=None,
                   help="write per-window cn.mops information gain here")
    p.add_argument("--candidates-out", default=None, metavar="FILE",
                   help="export the merged CNV calls as candidate "
                        "intervals (BED-style TSV, or JSON for "
                        "*.json), the `pairhmm --candidates` input")
    p.add_argument("matrix", help="depthwed-style matrix (tsv/gz)")
    a = p.parse_args(argv)
    run_emdepth(a.matrix, normalize=not a.no_normalize,
                matrix_out=a.matrix_out, vcf_out=a.vcf,
                mops_out=a.mops_out, gain_out=a.gain_out,
                candidates_out=a.candidates_out)


if __name__ == "__main__":
    main()
