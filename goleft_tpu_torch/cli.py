"""goleft-tpu-torch: subcommand dispatcher.

The counterpart of the JAX package's cli.py: a name → (help, main)
table; unknown or missing subcommands print the sorted table. Subcommands
register here as their slices of the port land.

Global flags, valid before or after the subcommand name (stripped here,
so no command declares them), as the JAX package's cli.py has them:

  --trace-out FILE    write the run's span timeline as Chrome trace-event
                      JSON (loads in Perfetto): the ``run.<command>``
                      root, the stages under it on every thread, and one
                      fenced ``device.<kernel>`` span per kernel launch
                      (--trace-out turns device events on; each fence
                      waits on the launching thread's stream)
  --log-level LEVEL   debug/info/warning/error on the goleft-tpu-torch.*
                      logger tree
  -v / -vv            shorthand for --log-level info / debug
                      (``-v`` as the only argument prints the version)
  --inject-faults S   install a deterministic fault schedule
                      (resilience/faults.py grammar, also settable via
                      GOLEFT_TPU_FAULTS), e.g. shard:after=3:kill
  --metrics-out FILE  write the run manifest at exit, the reference's
                      ``goleft-tpu.run-manifest/1.3`` (obs/manifest.py):
                      argv, env, backend (card provenance, platform),
                      spans (per-stage seconds and calls; the command's
                      own under ``run.<command>``), metrics (the
                      counters of obs/), the run's trace_id; and the
                      port's own keys: command, exit_code,
                      import_seconds (torch and the subcommand),
                      kernel_launches and native_io (the native host
                      decoder was loaded)

Every invocation runs under a run-scoped trace: the ``run.<command>``
root span parents the pipeline's stages, whichever threads record them.
"""

from __future__ import annotations

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
    "anonymize": ("make shareable header-only bam+bai fixtures",
                  _lazy(".commands.anonymize")),
    "cnv": ("CNV calls straight from BAMs: cohort depth matrix + EM copy "
            "number on the CUDA card", _lazy(".commands.cnv")),
    "cohortdepth": ("windowed depth matrix for a cohort of BAM/CRAM files "
                    "on the CUDA card", _lazy(".commands.cohortdepth")),
    "cohortscan": ("streaming, incremental indexcov for biobank-scale "
                   "cohorts on the CUDA card", _lazy(".commands.cohortscan")),
    "cnveval": ("evaluate CNV calls against a truth set",
                _lazy(".commands.cnveval_cmd")),
    "covstats": ("coverage and insert-size statistics by sampling",
                 _lazy(".commands.covstats")),
    "dcnv": ("GC-debias + normalize a depth matrix",
             _lazy(".commands.dcnv_cmd")),
    "depth": ("windowed depth + callable regions on the CUDA card",
              _lazy(".commands.depth")),
    "depthwed": ("matricize depth bed files to n-sites * n-samples",
                 _lazy(".commands.depthwed")),
    "emdepth": ("EM copy-number calls from a depth matrix on the CUDA card",
                _lazy(".commands.emdepth_cmd")),
    "indexcov": ("cohort coverage QC from BAM/CRAM indexes only on the "
                 "CUDA card", _lazy(".commands.indexcov")),
    "indexsplit": ("create regions of even data size across bams/crams",
                   _lazy(".commands.indexsplit")),
    "map": ("map FASTQ reads: minimizer seeding + banded "
            "Smith-Waterman on the CUDA card", _lazy(".commands.map_cmd")),
    "multidepth": ("joint depth over many bams with min-coverage blocks "
                   "on the CUDA card", _lazy(".commands.multidepth")),
    "pairhmm": ("pair-HMM genotype likelihoods over candidate windows "
                "on the CUDA card", _lazy(".commands.pairhmm_cmd")),
    "samplename": ("report samples in a bam file",
                   _lazy(".commands.samplename")),
}

_VALUE_FLAGS = {"--trace-out": "trace_out",
                "--metrics-out": "metrics_out",
                "--log-level": "log_level",
                "--inject-faults": "inject_faults"}


def _extract_global_flags(argv: list[str]):
    """Strip the global flags from anywhere in argv → (options, the rest
    of argv). Raises ValueError on a flag without its value, an unknown
    level or a bad fault spec. ``-v``/``-vv`` count as verbosity here;
    the caller has already taken ``-v`` alone as the version."""
    opts = {"trace_out": None, "metrics_out": None, "log_level": None,
            "inject_faults": None, "verbose": 0}
    rest: list[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        key = _VALUE_FLAGS.get(a)
        if key is not None:
            if i + 1 >= len(argv):
                raise ValueError(f"{a} needs a value")
            opts[key] = argv[i + 1]
            i += 2
            continue
        flag, eq, val = a.partition("=")
        key = _VALUE_FLAGS.get(flag)
        if key is not None and eq:
            opts[key] = val
        elif a == "-v":
            opts["verbose"] += 1
        elif a == "-vv":
            opts["verbose"] += 2
        else:
            rest.append(a)
        i += 1
    if opts["log_level"] is not None:
        from .obs.logging import parse_level

        parse_level(opts["log_level"])
    if opts["inject_faults"] is not None:
        from .resilience.faults import parse_faults

        parse_faults(opts["inject_faults"])
    return opts, rest


def usage() -> str:
    lines = [f"goleft-tpu-torch Version: {__version__}", ""]
    for name in sorted(PROGS):
        lines.append(f"{name:<11}: {PROGS[name][0]}")
    lines += [
        "",
        "global flags (before or after the subcommand):",
        "  --trace-out FILE    Perfetto/Chrome trace of the run's spans, "
        "with fenced device spans",
        "  --metrics-out FILE  JSON run manifest (provenance, spans, "
        "counters, kernel launches)",
        "  --log-level LEVEL   debug|info|warning|error",
        "  -v / -vv            info / debug logging",
        "  --inject-faults S   deterministic fault schedule (e.g. "
        "shard:after=3:kill)",
    ]
    return "\n".join(lines)


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


def _write_manifest(path: str, prog: str, argv: list[str], rc: int,
                    seconds: float, trace_id: str | None) -> None:
    from .io import native
    from .obs.manifest import write_manifest
    from .ops import (depth_kernel, norm_kernel, pairhmm_kernel, rans_kernel,
                      swalign_kernel)

    try:
        write_manifest(
            path, argv=[f"goleft-tpu-torch {prog}"] + argv,
            trace_id=trace_id,
            spans={f"run.{prog}": {"seconds": seconds, "calls": 1}},
            extra={"command": prog, "exit_code": rc,
                   "import_seconds": sum(IMPORT_SECONDS.values()),
                   "kernel_launches": {**depth_kernel.LAUNCHES,
                                       **pairhmm_kernel.LAUNCHES,
                                       **rans_kernel.LAUNCHES,
                                       **norm_kernel.LAUNCHES,
                                       **swalign_kernel.LAUNCHES},
                   "native_io": native.get_lib() is not None})
    except OSError as e:
        print(f"goleft-tpu-torch: could not write --metrics-out: {e}",
              file=sys.stderr)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("-v", "--version", "version"):
        print(__version__)
        return 0
    try:
        gopts, argv = _extract_global_flags(argv)
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

    from . import obs

    obs.configure_logging(gopts["log_level"] or (
        "debug" if gopts["verbose"] >= 2
        else "info" if gopts["verbose"] else "warning"))
    if gopts["inject_faults"]:
        from .resilience import faults

        faults.install(gopts["inject_faults"])
    if gopts["trace_out"]:
        obs.set_device_events(True)
    trace_id = None
    rc = 1
    t0 = time.perf_counter()
    try:
        with obs.trace(f"run.{prog}", kind="cli",
                       argv=" ".join(argv[1:])) as root:
            trace_id = root.trace_id
            rc = _run_command(prog, argv[1:])
            root.attrs["exit_code"] = rc
        return rc
    finally:
        # written even when the command failed: a failed run's trace and
        # manifest are the ones most worth keeping
        if gopts["trace_out"]:
            try:
                obs.get_tracer().write_chrome_trace(gopts["trace_out"])
            except OSError as e:
                print(f"goleft-tpu-torch: could not write --trace-out: "
                      f"{e}", file=sys.stderr)
        if gopts["metrics_out"]:
            _write_manifest(gopts["metrics_out"], prog, argv[1:], rc,
                            time.perf_counter() - t0, trace_id)


if __name__ == "__main__":
    sys.exit(main())
