"""goleft_tpu_torch: the PyTorch + CUDA port of goleft_tpu for one NVIDIA
H100.

The JAX package ``goleft_tpu`` stays the reference. This package imports
torch, numpy and the standard library only, and keeps its own copies of
the host code it needs. Subcommands land slice by slice: ``depth``,
``pairhmm`` and ``cohortdepth``, each with a hand-written CUDA kernel as
its device stage (``cohortdepth --decode-device`` adds the rANS-Nx16
decode kernel).

Subpackages:
  io         host-side file-format codecs (BGZF, BAM, BAI, FAI, CRAM and
             its block codecs) + the native C++ BAM decoder
             (csrc/fastio.cpp)
  ops        the kernels (csrc/depth_kernel.cu, csrc/pairhmm_kernel.cu,
             csrc/rans_kernel.cu), their wrappers and plain PyTorch
             versions, the per-shard depth pipeline, the pair-HMM host
             layer and the device CRAM block decoder
  models     genotype likelihoods and CNV candidate intervals (pairhmm)
  plan       the Step executor with retries
  resilience fault injection, retry policy, quarantine
  obs        counters and logger
  parallel   ordered thread-pool shard scheduler, chunk prefetcher and
             pinned-buffer staging; the world of processes over Gloo and
             its (data, seq) mesh, the sequence-parallel depth on the
             depth kernel, the chunked cohort step and the cohort matrix
             across processes
  commands   CLI subcommands
  utils      transparent IO, stage timers, decode-pool sizing
"""

__version__ = "0.1.0"
