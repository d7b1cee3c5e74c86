"""goleft_tpu_torch: the PyTorch + CUDA port of goleft_tpu for one NVIDIA
H100.

The JAX package ``goleft_tpu`` stays the reference. This package imports
torch, numpy and the standard library only, and keeps its own copies of
the host code it needs. Subcommands land slice by slice: ``depth`` and
``pairhmm``, each with a hand-written CUDA kernel as its device stage.

Subpackages:
  io         host-side file-format codecs (BGZF, BAM, BAI, FAI) + the
             native C++ decoder (csrc/fastio.cpp)
  ops        the kernels (csrc/depth_kernel.cu, csrc/pairhmm_kernel.cu),
             their wrappers and plain PyTorch versions, the per-shard
             depth pipeline and the pair-HMM host layer
  models     genotype likelihoods and CNV candidate intervals (pairhmm)
  plan       the Step executor with retries
  resilience fault injection, retry policy, quarantine
  obs        counters and logger
  parallel   ordered thread-pool shard scheduler
  commands   CLI subcommands
  utils      transparent IO, stage timers
"""

__version__ = "0.1.0"
