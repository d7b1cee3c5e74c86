"""goleft-tpu-torch: subcommand dispatcher.

The counterpart of the JAX package's cli.py: a name → (help, main)
table; a missing subcommand prints the sorted table, and an unknown one
a close match ("did you mean depth?") or, with none close, the table.

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

import os
import sys
import time

from . import __version__
from .errors import NoCudaDevice


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


def _lazy_device(module: str):
    """The device of a command that resolves its own: what its module's
    ``run_device`` answers from the command's argv."""
    def device_of(argv):
        import importlib

        return importlib.import_module(
            module, package=__package__).run_device(argv)

    return device_of


# name -> (help, runner, device), the reference's table: only the device
# commands (True, the card; or a callable that answers from the argv)
# import torch (``.device``) before they run; the host tools and the
# fleet tier (router, supervisor, federation and the HTTP clients of the
# observability surfaces) never load it
PROGS = {
    "anonymize": ("make shareable header-only bam+bai fixtures",
                  _lazy(".commands.anonymize"), False),
    "bench": ("run the port's benchmark suite on the CUDA card",
              _lazy(".commands.bench_cmd"),
              _lazy_device(".commands.bench_cmd")),
    "cnv": ("CNV calls straight from BAMs: cohort depth matrix + EM copy "
            "number on the CUDA card", _lazy(".commands.cnv"), True),
    "cohortdepth": ("windowed depth matrix for a cohort of BAM/CRAM files "
                    "on the CUDA card", _lazy(".commands.cohortdepth"),
                    True),
    "cohortscan": ("streaming, incremental indexcov for biobank-scale "
                   "cohorts on the CUDA card", _lazy(".commands.cohortscan"),
                   True),
    "cnveval": ("evaluate CNV calls against a truth set",
                _lazy(".commands.cnveval_cmd"), False),
    "covstats": ("coverage and insert-size statistics by sampling",
                 _lazy(".commands.covstats"), False),
    "dcnv": ("GC-debias + normalize a depth matrix",
             _lazy(".commands.dcnv_cmd"),
             _lazy_device(".commands.dcnv_cmd")),
    "depth": ("windowed depth + callable regions on the CUDA card",
              _lazy(".commands.depth"), True),
    "depthwed": ("matricize depth bed files to n-sites * n-samples",
                 _lazy(".commands.depthwed"), False),
    "emdepth": ("EM copy-number calls from a depth matrix on the CUDA card",
                _lazy(".commands.emdepth_cmd"), True),
    "federation": ("multi-fleet failover tier with tenant-scoped "
                   "overload isolation", _lazy(".commands.federation"),
                   False),
    "fleet": ("multi-worker serve fleet behind a file-affinity router",
              _lazy(".commands.fleet"), False),
    "indexcov": ("cohort coverage QC from BAM/CRAM indexes only on the "
                 "CUDA card", _lazy(".commands.indexcov"), True),
    "indexsplit": ("create regions of even data size across bams/crams",
                   _lazy(".commands.indexsplit"), False),
    "lint": ("AST invariant analyzer: determinism, tracer hygiene, "
             "lock discipline", _lazy(".analysis.cli"), False),
    "map": ("map FASTQ reads: minimizer seeding + banded "
            "Smith-Waterman on the CUDA card", _lazy(".commands.map_cmd"),
            True),
    "memory": ("render the host/device memory observatory of a "
               "worker or fleet", _lazy(".commands.memory_cmd"), False),
    "multidepth": ("joint depth over many bams with min-coverage blocks "
                   "on the CUDA card", _lazy(".commands.multidepth"), True),
    "pairhmm": ("pair-HMM genotype likelihoods over candidate windows "
                "on the CUDA card", _lazy(".commands.pairhmm_cmd"), True),
    "perf": ("perf ledger: ingest bench history, trend report, "
             "regression gate", _lazy(".commands.perf"), False),
    "profile": ("collect + render a fleet-wide sampling CPU profile",
                _lazy(".commands.profile_cmd"), False),
    "samplename": ("report samples in a bam file",
                   _lazy(".commands.samplename"), False),
    "serve": ("long-running coverage service with request micro-batching "
              "on the CUDA card", _lazy(".commands.serve"), True),
    "trace": ("fetch + pretty-print a stitched cross-process fleet "
              "trace", _lazy(".commands.trace_cmd"), False),
    "warmup": ("export the compile observatory's warmup manifest "
               "from a live worker or router", _lazy(".commands.warmup"),
               False),
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


def _device_of(prog: str, argv: list[str]) -> str | None:
    """The device ``prog`` runs on with ``argv``: "cuda" (the card),
    "cpu", or None for a host command."""
    dev = PROGS[prog][2]
    if callable(dev):
        return dev(argv)
    return "cuda" if dev else None


def _run_command(prog: str, argv: list[str], run: dict) -> int:
    """Dispatch with the reference's error contract: 0 / 1 on bad input
    or a missing card (one clean line) / 141 on a closed stdout. A world
    of processes (``GOLEFT_TPU_COORDINATOR``) is joined first, before
    any device bring-up; without one this imports no torch. A command on
    the card probes it first (:func:`_probe_card`, which notes a hung
    probe in ``run``) and brings CUDA up under the watchdog before it
    runs."""
    from .parallel.mesh import init_distributed

    if os.environ.get("GOLEFT_TPU_COORDINATOR"):
        t0 = time.perf_counter()
        import torch.distributed  # noqa: F401 (torch's import, timed)

        IMPORT_SECONDS["torch.distributed"] = time.perf_counter() - t0
    init_distributed()
    on = _device_of(prog, argv)
    sys.argv = [f"goleft-tpu-torch {prog}"] + argv
    try:
        if on == "cuda":
            _probe_card(run)
        if on is not None:
            t0 = time.perf_counter()
            from . import device  # noqa: F401 (the first import of torch)

            IMPORT_SECONDS[".device"] = time.perf_counter() - t0
        if on == "cuda":
            from .utils.device_guard import devices_with_watchdog

            devices_with_watchdog()
        ret = PROGS[prog][1](argv)
        sys.stdout.flush()
    except BrokenPipeError:
        try:
            devnull = os.open(os.devnull, os.O_WRONLY)
            os.dup2(devnull, sys.stdout.fileno())
        except (OSError, ValueError, AttributeError):
            pass
        return 141
    except (ValueError, NoCudaDevice) as e:
        if os.environ.get("GOLEFT_TPU_DEBUG"):
            raise
        print(f"goleft-tpu-torch {prog}: {e}", file=sys.stderr)
        return 1
    return int(ret or 0)


def _probe_card(run: dict) -> None:
    """A card command's bring-up check, before this process imports
    torch: the card is probed in a child process (utils/device_guard.py,
    cached; a failed or hung probe raises NoCudaDevice with one line).
    A hung probe's line goes into ``run["probe_hung"]``: the card may be
    wedged, so the run's manifest then asks CUDA nothing."""
    from .utils import device_guard

    try:
        device_guard.ensure_card()
    except device_guard.ProbeHung as e:
        run["probe_hung"] = str(e)
        raise


def _kernel_launches() -> dict:
    from .ops import (depth_kernel, norm_kernel, pairhmm_kernel, rans_kernel,
                      swalign_kernel)

    return {**depth_kernel.LAUNCHES, **pairhmm_kernel.LAUNCHES,
            **rans_kernel.LAUNCHES, **norm_kernel.LAUNCHES,
            **swalign_kernel.LAUNCHES}


def _write_manifest(path: str, prog: str, argv: list[str], rc: int,
                    seconds: float, trace_id: str | None,
                    probe_hung: str | None = None) -> None:
    """A device command's manifest carries the card's provenance and the
    kernels' launch counts; a host command launches no kernel and its
    manifest names the host only (neither loads torch). When the card's
    probe hung, the backend block is the reference's ``{"error": ...}``
    record with the guard's line, and no kernel module is loaded."""
    from .io import native
    from .obs.manifest import HOST_BACKEND, write_manifest

    device = _device_of(prog, argv)
    # a card whose probe hung is not asked again, and no kernel ran
    launched = device is not None and probe_hung is None
    backend = (HOST_BACKEND if device is None
               else {"error": probe_hung} if probe_hung else None)
    try:
        write_manifest(
            path, argv=[f"goleft-tpu-torch {prog}"] + argv,
            trace_id=trace_id,
            spans={f"run.{prog}": {"seconds": seconds, "calls": 1}},
            device=device, backend=backend,
            extra={"command": prog, "exit_code": rc,
                   "import_seconds": sum(IMPORT_SECONDS.values()),
                   "kernel_launches": (_kernel_launches() if launched
                                       else {}),
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
        # a close match is almost always a typo: suggest it in place of
        # the table, which still prints when no name is close
        import difflib

        close = difflib.get_close_matches(prog, PROGS, n=1, cutoff=0.6)
        if close:
            print(f"unknown subcommand: {prog} — did you mean "
                  f"{close[0]}?", file=sys.stderr)
        else:
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
    run: dict = {}
    t0 = time.perf_counter()
    try:
        with obs.trace(f"run.{prog}", kind="cli",
                       argv=" ".join(argv[1:])) as root:
            trace_id = root.trace_id
            rc = _run_command(prog, argv[1:], run)
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
                            time.perf_counter() - t0, trace_id,
                            run.get("probe_hung"))


if __name__ == "__main__":
    sys.exit(main())
