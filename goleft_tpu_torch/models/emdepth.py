"""Batched EM copy-number caller (cn.mops-simplified): the counterpart of
the JAX package's models/emdepth.py, as batched PyTorch tensor ops on
the card (or the CPU when the caller passes CPU tensors).

Every genomic window is one row of a (windows × samples) batch. The
JAX package runs each row under ``vmap`` in a ``fori_loop`` of
``MAX_ITER`` iterations where converged rows freeze their λ; here the
same ten iterations run over the whole batch with the same per-row
freeze mask, with no early exit for the batch. Each step computes what
the JAX package computes, in its order of operations:

  - λ init: λ0 = 0.01·median, λ2 = median, λi = median·(i/2)^1.1, with
    the even-length median quirk: the mean of the two order statistics
    above the midpoint. At S = 2 the upper index is past the end; JAX
    clamps it to S - 1, and so does :func:`_median_even_quirk`
    (depths [10, 20] → median 20);
  - binning with the CN2 preference inside (λ1, λ3);
  - λ2 ← mean(bin 2), with the empty-bin fallback mixing bins 1..7;
    λi ← λ2·i/2; CN1/CN3 widened by span/1.5;
  - convergence when sum|Δλ| ≤ 0.01 or max|Δλ| ≤ 0.5;
  - CN: nearest λ, with the Poisson-pmf tiebreak toward CN2
    (o·0.9 < o2 → CN2).

The bins are nine masked sums over (B, S), not a (B, S, 9) one-hot, and
no float atomics (``scatter_add``/``index_add_``) take part, so λ is the
same from run to run. The (i/2)^1.1 factors are host constants from
C's ``pow``, as XLA folds them.

Documented divergence, kept from the JAX package: depths above λ8 get
CN = MAX_CN = 8.

The host-side streaming CNV merge (``Cache``, ``_make_cnv``) is a copy
of the JAX package's. An :class:`EMD` carries its window's row of the
batch's CN (int8), so the merge makes no device call per window.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

MAX_CN = 8
MAX_ITER = 10
EPS = 0.01
LOWER = -0.80
UPPER = 0.40
N_LAMBDA = MAX_CN + 1

#: λ_i / median at initialisation: EPS for CN0, 1 for CN2, (i/2)^1.1
#: otherwise
_INIT = [EPS] + [1.0 if i == 2 else (i / 2) ** 1.1
                 for i in range(1, N_LAMBDA)]
#: the empty-bin-2 fallback's per-bin scale to CN2, bins 1..7
_TO_CN2 = [2.0 / i for i in range(1, N_LAMBDA - 1)]


def _median_even_quirk(d: torch.Tensor) -> torch.Tensor:
    """Row median with the reference's even-length quirk: the mean of the
    two elements above the midpoint, the upper index clamped to S - 1."""
    s = torch.sort(d, dim=-1).values
    n = d.shape[-1]
    if n % 2 == 1:
        return s[..., n // 2]
    return (s[..., n // 2] + s[..., min(n // 2 + 1, n - 1)]) / 2


def _nearest(d: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """The nearest bin per (window, sample): with ``idx`` the count of λ
    below d, the closer of λ[idx] and λ[idx-1] (ties go down), 0 below
    λ0 and N_LAMBDA - 1 above λ8."""
    idx = (lam[:, None, :] < d[:, :, None]).sum(-1)
    hi = idx.clamp(max=N_LAMBDA - 1)
    lo = (idx - 1).clamp(min=0)
    near_hi = (d - lam.gather(1, hi)).abs() < (d - lam.gather(1, lo)).abs()
    pick = torch.where(near_hi, hi, lo)
    pick = torch.where(idx >= N_LAMBDA, N_LAMBDA - 1, pick)
    return torch.where(idx == 0, 0, pick)


def _assign_bins(d: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """(B, S) bin of each depth, with the CN2 preference."""
    pick = _nearest(d, lam)
    l1, l2, l3 = lam[:, 1:2], lam[:, 2:3], lam[:, 3:4]
    a2 = (d - l2).abs()
    pref2 = (d > l1) & (d < l3) & (a2 < (d - l1).abs()) \
        & (a2 < (d - l3).abs())
    return torch.where(pref2, 2, pick)


def em_depth_batch(depths: torch.Tensor) -> torch.Tensor:
    """(B, S) normalised depths → (B, 9) λ centres, on ``depths``'s
    device and in its dtype."""
    d = depths
    B, n = d.shape
    m = _median_even_quirk(d)
    lam = m[:, None] * torch.tensor(_INIT, dtype=d.dtype, device=d.device)
    i_arr = torch.arange(N_LAMBDA, dtype=d.dtype, device=d.device)
    to_cn2 = torch.tensor(_TO_CN2, dtype=d.dtype, device=d.device)
    active = torch.ones(B, dtype=torch.bool, device=d.device)
    for _ in range(MAX_ITER):
        bins = _assign_bins(d, lam)
        counts = torch.empty(B, N_LAMBDA, dtype=d.dtype, device=d.device)
        sums = torch.empty_like(counts)
        for k in range(N_LAMBDA):
            mask = bins == k
            counts[:, k] = mask.sum(-1)
            sums[:, k] = torch.where(mask, d, 0.0).sum(-1)
        means = torch.where(counts > 0, sums / counts.clamp(min=1), 0.0)
        # empty-bin-2 fallback: bins 1..7 scaled to CN2, weighted by
        # occupancy, summed in bin order
        t = means[:, 1:N_LAMBDA - 1] * to_cn2 \
            * (counts[:, 1:N_LAMBDA - 1] / n)
        fallback = t[:, 0]
        for k in range(1, t.shape[1]):
            fallback = fallback + t[:, k]
        lam2 = means[:, 2]
        lam2 = torch.where(lam2 != 0, lam2, fallback)
        new = lam2[:, None] * i_arr / 2
        new[:, 0] = lam[:, 0]
        span = new[:, 2] - new[:, 1]
        new[:, 1] += -span / 1.5
        new[:, 3] += span / 1.5
        diff = (new - lam).abs()
        still = (diff.sum(-1) > EPS) & (diff.amax(-1) > 0.5)
        lam = torch.where(active[:, None], new, lam)
        active = active & still
    return lam


def _poisson_pmf(k: torch.Tensor, lg: torch.Tensor,
                 mu: torch.Tensor) -> torch.Tensor:
    """Poisson pmf at integer-valued ``k`` with ``lg`` = lgamma(k + 1);
    log floor 1e-30 on μ."""
    return torch.exp(k * torch.log(mu.clamp(min=1e-30)) - lg - mu)


def cn_batch(lambdas: torch.Tensor, depths: torch.Tensor) -> torch.Tensor:
    """Posterior-max CN per (window, sample) with the Poisson CN2
    tiebreak. lambdas: (B, 9), depths: (B, S) → int8 (B, S)."""
    d = depths
    cn = _nearest(d, lambdas)  # above λ8: N_LAMBDA - 1 = MAX_CN
    dk = torch.floor(0.5 + d)
    lg = torch.lgamma(dk + 1)
    o = _poisson_pmf(dk, lg, lambdas.gather(1, cn.clamp(0, N_LAMBDA - 1)))
    o2 = _poisson_pmf(dk, lg, lambdas[:, 2:3])
    return torch.where((cn != 2) & (o * 0.9 < o2), 2, cn).to(torch.int8)


def log2fc_batch(lambdas: torch.Tensor, depths: torch.Tensor) -> torch.Tensor:
    """Fold change against CN2."""
    return torch.log2(depths / lambdas[:, 2:3])


# ---------------------------------------------------------------------------
# host-side streaming CNV merge


@dataclass
class EMD:
    """One window's EM result: λ, the window's depths, and its row of
    the batch's CN."""

    lam: np.ndarray  # (9,)
    depths: np.ndarray  # (S,)
    start: int
    end: int
    cns: np.ndarray  # (S,) int8
    _l2: np.ndarray | None = None

    def log2fc(self) -> np.ndarray:
        if self._l2 is None:
            with np.errstate(divide="ignore"):
                self._l2 = np.log2(
                    self.depths.astype(np.float64) / self.lam[2]
                )
        return self._l2

    def same(self, other: "EMD") -> tuple[list[int], list[int], float]:
        """(non-CN2-in-both samples, changed samples, share unchanged)."""
        ee = self.log2fc()
        oo = other.log2fc()
        non2, changed = [], []
        n_same = 0
        for i in range(len(ee)):
            if LOWER < ee[i] < UPPER and LOWER < oo[i] < UPPER:
                n_same += 1
            elif (oo[i] >= UPPER and ee[i] >= UPPER) or (
                oo[i] <= LOWER and ee[i] <= LOWER
            ):
                non2.append(i)
                n_same += 1
            else:
                changed.append(i)
        return non2, changed, n_same / len(self.depths)


def em_depth(depths, start: int = 0, end: int = 0, device=None) -> EMD:
    """One window through the batch EM and CN on ``device`` (the card
    unless ``"cpu"``)."""
    from ..device import resolve_device

    d = np.asarray(depths, dtype=np.float64)
    t = torch.from_numpy(d[None]).to(resolve_device(device))
    lam = em_depth_batch(t)
    return EMD(lam.cpu().numpy()[0], d, start, end,
               cn_batch(lam, t).cpu().numpy()[0])


@dataclass
class CNV:
    """Merged aberrant-depth run for one sample."""

    sample_i: int
    depth: list
    positions: list  # (start, end) tuples
    log2fc: list
    cn: list
    psize: int = 0


GAP = 30_000  # merge gap


@dataclass
class Cache:
    """Streaming CNV state tracker."""

    last: EMD | None = None
    cnvs: dict = field(default_factory=dict)

    def add(self, e: EMD) -> list[CNV]:
        if self.last is None:
            self.last = e
        ret = self.clear((e.start, e.end))
        non2, _, _ = self.last.same(e)
        for si in non2:
            self.cnvs.setdefault(si, []).append(e)
        self.last = e
        return ret

    def clear(self, pos=None) -> list[CNV]:
        if pos is None:
            if self.last is None:
                return []
            pos = (self.last.start + 100_000, self.last.end + 100_000)
        out = []
        done = []
        for si, emds in self.cnvs.items():
            if pos[0] - emds[-1].end < GAP:
                continue
            put = _make_cnv(emds, si)
            if put is not None:
                put.psize = len(self.cnvs)
                out.append(put)
            done.append(si)
        for k in done:
            del self.cnvs[k]
        return out


def _make_cnv(emds: list[EMD], sample_i: int) -> CNV | None:
    """Keep the windows with a fold change outside (-0.5, 0.3)."""
    cnv = None
    for e in emds:
        fc = e.log2fc()[sample_i]
        if -0.5 < fc < 0.3:
            continue
        cn = int(e.cns[sample_i])
        if cnv is None:
            cnv = CNV(sample_i, [float(e.depths[sample_i])],
                      [(e.start, e.end)], [float(fc)], [cn])
        else:
            cnv.depth.append(float(e.depths[sample_i]))
            cnv.positions.append((e.start, e.end))
            cnv.log2fc.append(float(fc))
            cnv.cn.append(cn)
    return cnv
