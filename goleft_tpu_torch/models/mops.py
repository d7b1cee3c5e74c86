"""cn.mops EM (eqns 1, 5-8 of the cn.mops paper), batched over windows:
the counterpart of the JAX package's models/mops.py, as batched PyTorch
tensor ops on the card (or the CPU for CPU tensors).

Per window, a posterior matrix α_ik over copy numbers 0..7 per sample,
a Dirichlet-prior M-step with G = 11 on CN2, and λ iterated until
|Δλ| ≤ 0.01, at most ``MAX_ITER`` times. The JAX package runs each row
under ``vmap`` in a ``while_loop`` that stops the row at its own
iteration; here ``MAX_ITER`` masked iterations run over the batch and a
row freezes (α, λ) once its condition fails. The initial λ = 3.4e37
forces at least one iteration.

The Poisson pmf is the log-space form exp(k·ln μ − lgamma(k+1) − μ) of
the JAX package. Means are sums divided by the count, as XLA computes
them. The E-step's pmf over (B, 8, S) is shared by its numerator and
its denominator, which differ only at CN0 (the denominator takes
μ = 0·λ there, the numerator μ = eps/2·λ).
"""

from __future__ import annotations

import math

import torch

MAX_CN = 8  # copy numbers 0..7
EPS = 0.001
MAX_ITER = 10
G = 11.0  # Dirichlet prior weight on CN2


def _pmf(k, lg, mu):
    return torch.exp(k * torch.log(mu.clamp(min=1e-30)) - lg - mu)


def _estep(k, lg, alpha, lam):
    """(aik (B, 8, S)) for weights ``alpha`` (B, 8) and λ (B,)."""
    B, S = k.shape
    i = torch.arange(MAX_CN, dtype=k.dtype, device=k.device)
    half = torch.where(i == 0, EPS, i) / 2
    p = torch.empty(B, MAX_CN, S, dtype=k.dtype, device=k.device)
    for c in range(MAX_CN):
        p[:, c] = _pmf(k, lg, (half[c] * lam)[:, None])
    # the denominator's CN0 term has μ = 0/2·λ
    denom = alpha[:, 0:1] * _pmf(k, lg, (i[0] / 2 * lam)[:, None])
    for c in range(1, MAX_CN):
        denom = denom + alpha[:, c:c + 1] * p[:, c]
    p *= alpha[:, :, None]
    p /= denom.clamp(min=1e-30)[:, None, :]
    return p


def _mstep(aik, dmean, n_samples):
    """(alpha (B, 8), λ (B,)) from the posterior."""
    n = MAX_CN
    amean = aik.sum(-1) / n_samples
    ys = n + G
    alpha_denom = 1 + 1 / n_samples * (ys - n)
    prior = torch.tensor([1 / n_samples * ((1.0 + G if c == 2 else 1.0) - 1)
                          for c in range(n)], dtype=aik.dtype,
                         device=aik.device)
    alpha = (amean + prior) / alpha_denom
    w = amean[:, 0] * (EPS / 2)
    for c in range(1, n):
        w = w + amean[:, c] * (c / 2)
    return alpha, dmean / w.clamp(min=1e-30)


def mops_batch(depths: torch.Tensor) -> dict:
    """(B, S) depths → {"aik": (B, 8, S), "alpha": (B, 8), "lambda":
    (B,)}, on ``depths``'s device and in its dtype."""
    d = depths
    B, S = d.shape
    k = torch.floor(d + 0.5)
    lg = torch.lgamma(k + 1)
    alpha = torch.full((B, MAX_CN), EPS, dtype=d.dtype, device=d.device)
    alpha[:, 2] = 1.0 - 5 * EPS * (MAX_CN - 1)
    dmean = d.sum(-1) / S
    lam = torch.full((B,), 3.4e37, dtype=d.dtype, device=d.device)
    nlam = dmean
    active = torch.ones(B, dtype=torch.bool, device=d.device)
    for _ in range(MAX_ITER):
        active = active & ((lam - nlam).abs() > 0.01)
        alpha2, nlam2 = _mstep(_estep(k, lg, alpha, nlam), dmean, S)
        alpha = torch.where(active[:, None], alpha2, alpha)
        lam = torch.where(active, nlam, lam)
        nlam = torch.where(active, nlam2, nlam)
    return {"aik": _estep(k, lg, alpha, nlam), "alpha": alpha,
            "lambda": nlam}


#: |ln(i/2)| per CN, CN0 at eps/2
_GAIN_W = [abs(math.log((EPS if c == 0 else c) / 2)) for c in range(MAX_CN)]


def information_gain(aik: torch.Tensor) -> torch.Tensor:
    """cn.mops eqn 8: per-window evidence of any CNV, (B, 8, S) → (B,)."""
    amean = aik.sum(-1) / aik.shape[-1]
    g = amean[:, 0] * _GAIN_W[0]
    for c in range(1, MAX_CN):
        g = g + amean[:, c] * _GAIN_W[c]
    return g


def posterior_cn(aik: torch.Tensor) -> torch.Tensor:
    """Per-sample argmax copy number of the posterior (the first maximum
    on a tie), (B, 8, S) → int8 (B, S)."""
    return torch.argmax(aik, dim=-2).to(torch.int8)
