"""goleft_tpu_torch: the PyTorch + CUDA port of goleft_tpu for one NVIDIA
H100.

The JAX package ``goleft_tpu`` stays the reference. This package imports
torch, numpy and the standard library only, and keeps its own copies of
the host code it needs. Subcommands land slice by slice; the first is
``depth``, whose device stage is a hand-written CUDA kernel.

Subpackages:
  io        host-side file-format codecs (BGZF, BAM, BAI, FAI) + the
            native C++ decoder (csrc/fastio.cpp)
  ops       the depth kernel (csrc/depth_kernel.cu), its plain PyTorch
            version and the per-shard pipeline
  parallel  ordered thread-pool shard scheduler
  commands  CLI subcommands
  utils     transparent IO, stage timers
"""

__version__ = "0.1.0"
