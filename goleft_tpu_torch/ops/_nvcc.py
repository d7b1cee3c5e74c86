"""Build-and-load of the port's CUDA kernels: one ``nvcc`` call per
source into ``build/torch/``, cached by a hash of the source and the
flags, loaded with ctypes.

Each kernel module keeps its own ctypes signatures and build log; this
module only compiles. The sources include no PyTorch header, so a build
is one short nvcc call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

from ..device import KernelFault

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch")
#: flags every kernel is built with
BASE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc_path(what: str) -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.exists(cand):
            return cand
    raise KernelFault(f"{what}: nvcc not found (set CUDA_HOME)")


def build(source: str, flags: list[str], what: str
          ) -> tuple[ctypes.CDLL, str]:
    """Compile ``csrc/<source>`` with ``flags`` (once per source version
    and flag set) and load it. Returns (library, the ptxas report of
    this process's build, or "" when the library was already built).
    Raises :class:`~goleft_tpu_torch.device.KernelFault` when nvcc is
    missing or fails."""
    src = os.path.join(CSRC, source)
    with open(src, "rb") as fh:
        tag = hashlib.sha256(
            fh.read() + " ".join(flags).encode()).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    out = os.path.join(BUILD_DIR, f"lib{stem}-{tag}.so")
    log = ""
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        r = subprocess.run([nvcc_path(what), *flags, "-o", tmp, src],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise KernelFault(f"{what}: nvcc failed:\n{r.stderr[-4000:]}")
        log = r.stderr
        os.replace(tmp, out)
    return ctypes.CDLL(out), log
