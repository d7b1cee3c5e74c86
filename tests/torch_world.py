"""Run a snippet in a real ``torch.distributed`` world of spawned
processes on the CPU (Gloo), for the port's multi-process tests.

Each process gets ``GOLEFT_TPU_COORDINATOR``, ``GOLEFT_TPU_NUM_PROCESSES``
and ``GOLEFT_TPU_PROCESS_ID`` (as ``python -m goleft_tpu_torch`` reads
them), ``GOLEFT_WORK`` (a directory the snippet writes its results to)
and the repository on ``sys.path``; none imports jax. Every process has
its own timeout and is killed when it passes.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = """
import os, sys
sys.path.insert(0, os.environ["GOLEFT_REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
from goleft_tpu_torch.parallel.mesh import init_distributed, world
init_distributed()
SIZE, RANK = world()
WORK = os.environ["GOLEFT_WORK"]
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def world_env(n: int, rank: int, port: int, work: str) -> dict:
    env = dict(os.environ, GOLEFT_REPO=REPO, GOLEFT_WORK=str(work),
               GOLEFT_TPU_COORDINATOR=f"127.0.0.1:{port}",
               GOLEFT_TPU_NUM_PROCESSES=str(n),
               GOLEFT_TPU_PROCESS_ID=str(rank), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return env


def run_world(n: int, code: str, work, timeout: float = 120.0,
              argv: list[str] | None = None) -> list:
    """Start ``n`` processes running PRELUDE + ``code`` (or, with
    ``argv``, that command line) → [(returncode, stdout, stderr)] by
    rank; a process past ``timeout`` seconds is killed (returncode -9)."""
    port = free_port()
    procs = []
    for rank in range(n):
        cmd = argv or [sys.executable, "-c", PRELUDE + code]
        procs.append(subprocess.Popen(
            cmd, env=world_env(n, rank, port, work), cwd=str(work),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, err = p.communicate()
            err += f"\nkilled after {timeout} s"
        outs.append((p.returncode, out, err))
    for rank, (rc, _, err) in enumerate(outs):
        assert rc == 0, f"rank {rank} rc={rc}\n{err[-3000:]}"
    return outs
