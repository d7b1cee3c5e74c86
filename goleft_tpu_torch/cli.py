"""goleft-tpu-torch: subcommand dispatcher.

The counterpart of the JAX package's cli.py: a name → (help, main)
table; unknown or missing subcommands print the sorted table. Subcommands
register here as their slices of the port land.

Global flag, valid before or after the subcommand name:

  --metrics-out FILE  write a JSON run report at exit: command, argv,
                      exit code, the command's seconds, the seconds
                      spent importing torch and the subcommand, card
                      provenance, kernel launch counts, per-stage
                      seconds, the counters of obs/ and whether the
                      native host decoder was loaded
"""

from __future__ import annotations

import json
import sys
import time

from . import __version__


# seconds spent importing the device module (torch comes with it) and
# each subcommand's module
IMPORT_SECONDS: dict[str, float] = {}


def _lazy(module: str):
    def runner(argv):
        import importlib

        t0 = time.perf_counter()
        mod = importlib.import_module(module, package=__package__)
        IMPORT_SECONDS[module] = time.perf_counter() - t0
        return mod.main(argv)

    return runner


PROGS = {
    "depth": ("windowed depth + callable regions on the CUDA card",
              _lazy(".commands.depth")),
    "pairhmm": ("pair-HMM genotype likelihoods over candidate windows "
                "on the CUDA card", _lazy(".commands.pairhmm_cmd")),
}


def usage() -> str:
    lines = [f"goleft-tpu-torch Version: {__version__}", ""]
    for name in sorted(PROGS):
        lines.append(f"{name:<11}: {PROGS[name][0]}")
    lines += ["", "global flags (before or after the subcommand):",
              "  --metrics-out FILE  JSON run report (provenance, kernel "
              "launches, stage seconds)"]
    return "\n".join(lines)


def _extract_metrics_out(argv: list[str]):
    out, rest, i = None, [], 0
    while i < len(argv):
        a = argv[i]
        if a == "--metrics-out":
            if i + 1 >= len(argv):
                raise ValueError("--metrics-out needs a value")
            out = argv[i + 1]
            i += 2
            continue
        if a.startswith("--metrics-out="):
            out = a.split("=", 1)[1]
        else:
            rest.append(a)
        i += 1
    return out, rest


def _run_command(prog: str, argv: list[str]) -> int:
    """Dispatch with the reference's error contract: 0 / 1 on bad input
    or a missing card (one clean line) / 141 on a closed stdout."""
    t0 = time.perf_counter()
    from .device import NoCudaDevice  # the first import of torch

    IMPORT_SECONDS[".device"] = time.perf_counter() - t0
    sys.argv = [f"goleft-tpu-torch {prog}"] + argv
    try:
        ret = PROGS[prog][1](argv)
        sys.stdout.flush()
    except BrokenPipeError:
        import os

        try:
            devnull = os.open(os.devnull, os.O_WRONLY)
            os.dup2(devnull, sys.stdout.fileno())
        except (OSError, ValueError, AttributeError):
            pass
        return 141
    except (ValueError, NoCudaDevice) as e:
        import os

        if os.environ.get("GOLEFT_TPU_DEBUG"):
            raise
        print(f"goleft-tpu-torch {prog}: {e}", file=sys.stderr)
        return 1
    return int(ret or 0)


def _write_report(path: str, prog: str, argv: list[str], rc: int,
                  seconds: float) -> None:
    from .device import card_provenance
    from .io import native
    from .obs import get_registry
    from .ops import depth_kernel, pairhmm_kernel
    from .utils.profiling import process_totals

    report = {
        "command": prog,
        "argv": argv,
        "exit_code": rc,
        "seconds": seconds,
        "import_seconds": sum(IMPORT_SECONDS.values()),
        "provenance": card_provenance(),
        "kernel_launches": {**depth_kernel.LAUNCHES,
                            **pairhmm_kernel.LAUNCHES},
        "stage_seconds": process_totals(),
        "counters": get_registry().snapshot()["counters"],
        "native_io": native.get_lib() is not None,
    }
    with open(path, "w") as fh:
        json.dump(report, fh, indent=1, sort_keys=True)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("-v", "--version", "version"):
        print(__version__)
        return 0
    try:
        metrics_out, argv = _extract_metrics_out(argv)
    except ValueError as e:
        print(f"goleft-tpu-torch: {e}", file=sys.stderr)
        return 1
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(usage(), file=sys.stderr)
        return 0
    prog = argv[0]
    if prog not in PROGS:
        print(f"unknown subcommand: {prog}\n", file=sys.stderr)
        print(usage(), file=sys.stderr)
        return 1
    rc = 1
    t0 = time.perf_counter()
    try:
        rc = _run_command(prog, argv[1:])
        return rc
    finally:
        # written even when the command failed: a failed run's report is
        # the one most worth keeping
        if metrics_out:
            _write_report(metrics_out, prog, argv[1:], rc,
                          time.perf_counter() - t0)


if __name__ == "__main__":
    sys.exit(main())
