"""Dtype policy of the EM and cn.mops math: float64 on the CPU and on the
card.

The JAX package's policy is float64 where its backend supports it and
float32 on the TPU, which has no native f64. An H100 has IEEE f64, so
the port runs the EM in f64 everywhere: its output is then comparable to
the JAX package's CPU/x64 output, which is what that package's tests
check. The host-side normalisation is numpy, so the policy names a numpy
dtype; the device tensors take the same width.
"""

from __future__ import annotations

import numpy as np


def preferred_float() -> type:
    """The float type of the EM's depths and λ, on the CPU and on a
    CUDA card alike: ``np.float64``."""
    return np.float64
