"""Device bring-up guard: a subprocess probe of the card and a hang
watchdog over the first CUDA discovery.

The port's copy of the JAX package's utils/device_guard.py, without its
two fallbacks: there is no ``GOLEFT_TPU_CPU`` pin and no step down to
the host. A card that hangs or fails in bring-up makes a device command
fail with one line (:class:`~goleft_tpu_torch.errors.NoCudaDevice`,
which the CLI turns into exit 1) instead of hanging it:

- :func:`ensure_card` runs :func:`probe_device` (a child process that
  initialises CUDA and runs one small op on ``cuda:0``) and raises when
  it fails or hangs. A success is cached for
  ``GOLEFT_TPU_PROBE_TTL_SECONDS`` (300; 0 turns caching off), a failure
  for ``GOLEFT_TPU_PROBE_FAIL_TTL_SECONDS`` (120), in the port's own
  files ``goleft-tpu-torch-probe-{ok,fail}-{uid}`` under the temp dir.
  ``GOLEFT_TPU_PROBE=0`` and a process world
  (``GOLEFT_TPU_COORDINATOR``) skip the probe; the command still runs on
  the card.
- :func:`devices_with_watchdog` runs the first CUDA discovery in this
  process and warns when it takes longer than
  ``GOLEFT_TPU_DEVICE_WATCHDOG_SECONDS`` (30), while it goes on.

Importing this module does not import torch; the probe's child does.
"""

from __future__ import annotations

import os
import threading

from ..errors import NoCudaDevice
from ..obs.logging import get_logger

log = get_logger("device")


class ProbeHung(NoCudaDevice):
    """The probe's child did not finish within its timeout (now or, from
    the failure cache, within the failure TTL): the card may be wedged,
    so nothing in this process should ask CUDA anything."""


def _watchdog_seconds() -> float:
    raw = os.environ.get("GOLEFT_TPU_DEVICE_WATCHDOG_SECONDS", "30")
    try:
        v = float(raw)
    except ValueError:
        log.warning(
            "ignoring malformed GOLEFT_TPU_DEVICE_WATCHDOG_SECONDS=%r",
            raw)
        return 30.0
    return v if v > 0 else 30.0


WATCHDOG_SECONDS = _watchdog_seconds()

#: the probe child: CUDA visible, initialised, and one op on cuda:0
#: finished; it prints the card's name
_PROBE_SNIPPET = (
    "import sys, torch\n"
    "if not torch.cuda.is_available():\n"
    "    sys.exit('no CUDA device is visible')\n"
    "torch.cuda.init()\n"
    "x = torch.arange(8, dtype=torch.float32, device='cuda:0')\n"
    "s = float((x * 2).sum())\n"
    "torch.cuda.synchronize()\n"
    "assert s == 56.0, s\n"
    "print(torch.cuda.get_device_name(0))\n")


def arm_traceback_snippet(snippet: str, timeout_s: float) -> str:
    """Prefix a ``python -c`` probe snippet with a faulthandler timer
    that dumps every thread's stack to stderr at 0.8 × the parent's
    timeout: a hung bring-up then leaves its traceback in the probe
    record. ``exit=False``: the child is never killed (see
    :func:`probe_device`), so the dump does not end it either."""
    arm = max(1.0, timeout_s * 0.8)
    return (f"import faulthandler; "
            f"faulthandler.dump_traceback_later({arm:.1f}, exit=False)\n"
            + snippet)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _probe_cache_path(kind: str = "ok") -> str:
    import tempfile

    uid = os.getuid() if hasattr(os, "getuid") else 0
    return os.path.join(tempfile.gettempdir(),
                        f"goleft-tpu-torch-probe-{kind}-{uid}")


def probe_device(timeout_s: float | None = None, argv=None) -> dict:
    """Probe the card's bring-up in a child process: a wedged driver
    hangs CUDA initialisation, and only a child can be left behind. The
    child is never killed; on a timeout it is left to finish on its own
    and the probe reports not-ok. Its output goes to temp files, so a
    verbose failure cannot block it on a full pipe.

    ``argv`` replaces the probe command (tests stand in a sleeping or
    failing child). Returns {ok, seconds, rc, stdout?, error?,
    traceback_tail?}."""
    import subprocess
    import sys
    import tempfile
    import time

    if timeout_s is None:
        timeout_s = WATCHDOG_SECONDS
    rec: dict = {}
    t0 = time.monotonic()
    fo = tempfile.TemporaryFile(mode="w+")
    fe = tempfile.TemporaryFile(mode="w+")
    try:
        # gtlint: ok res-leak — a hung child is left to finish on its
        # own by design (docstring); the poll() loop reaps the rest
        child = subprocess.Popen(
            argv or [sys.executable, "-c",
                     arm_traceback_snippet(_PROBE_SNIPPET, timeout_s)],
            stdout=fo, stderr=fe,
        )
    except OSError as e:
        rec.update(ok=False, rc=None, error=f"spawn failed: {e!r}")
        return rec
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        rc = child.poll()
        if rc is not None:
            rec.update(ok=rc == 0, rc=rc,
                       seconds=round(time.monotonic() - t0, 3))
            if rc != 0:
                fe.seek(0)
                tail = (fe.read().strip().splitlines()
                        or ["<no stderr>"])[-1]
                rec["error"] = tail[:300]
            else:
                fo.seek(0)
                rec["stdout"] = fo.read().strip()[:300]
            return rec
        time.sleep(0.05)
    rec.update(ok=False, rc=None,
               seconds=round(time.monotonic() - t0, 3),
               error=f"hung past {timeout_s:g}s (child left to finish)")
    # what the child wrote so far: with the default argv, the
    # faulthandler dump armed at 0.8 × timeout says where it hung
    try:
        fe.seek(0)
        tail = fe.read().strip()
        if tail:
            rec["traceback_tail"] = tail[-1500:]
    except (OSError, ValueError):
        pass
    return rec


def _write_tail(tail: str) -> str:
    """Write a hung probe's traceback tail to a file of its own; its
    path, or "nowhere" when it could not be written."""
    import tempfile

    try:
        fd, path = tempfile.mkstemp(prefix="goleft-tpu-torch-probe-hang-",
                                    suffix=".txt")
        with os.fdopen(fd, "w") as fh:
            fh.write(tail + "\n")
        return path
    except OSError:
        return "nowhere"


def _probe_failure(rec: dict) -> str:
    """One line naming the cause of a failed probe."""
    err = rec.get("error", "failed")
    if rec.get("rc") is None and "traceback_tail" in rec:
        return (f"CUDA device probe {err}; its traceback tail is in "
                f"{_write_tail(rec['traceback_tail'])}")
    if rec.get("rc") is None:
        return f"CUDA device probe {err}"
    return f"CUDA device probe failed (exit {rec['rc']}): {err}"


def _counter(name: str) -> None:
    from ..obs.metrics import get_registry

    get_registry().counter(name).inc()


def ensure_card(probe_argv=None) -> str:
    """A device command's bring-up check: probe the card in a child
    and raise :class:`NoCudaDevice` with one line when the probe fails,
    hangs (:class:`ProbeHung`), or did either within the failure TTL.
    Returns "probed" (the probe passed), "cached" (one passed within the
    TTL) or "unprobed" (``GOLEFT_TPU_PROBE=0``, or a process world under
    ``GOLEFT_TPU_COORDINATOR``). ``probe_argv`` replaces the probe
    command and bypasses both caches.

    The probe's wall clock goes into the run manifest's spans as
    ``device-probe``; the counters ``device.probe_total`` and
    ``device.probe_cached_total`` say which path was taken."""
    import time

    if os.environ.get("GOLEFT_TPU_PROBE", "1").lower() in (
            "0", "no", "false"):
        return "unprobed"
    if os.environ.get("GOLEFT_TPU_COORDINATOR"):
        return "unprobed"  # a world of processes brings its cards up
    ttl = _env_float("GOLEFT_TPU_PROBE_TTL_SECONDS", 300.0)
    # failures cache too, on a shorter TTL: a wedged card then costs the
    # probe's timeout once, not once a command. Off when the main TTL
    # turns caching off, unless its own variable is set.
    fail_ttl = _env_float("GOLEFT_TPU_PROBE_FAIL_TTL_SECONDS",
                          120.0 if ttl > 0 else 0.0)
    cache = _probe_cache_path()
    fail_cache = _probe_cache_path("fail")
    if probe_argv is None:
        if ttl > 0:
            try:
                if time.time() - os.path.getmtime(cache) < ttl:
                    _counter("device.probe_cached_total")
                    return "cached"
            except OSError:
                pass
        if fail_ttl > 0:
            try:
                age = time.time() - os.path.getmtime(fail_cache)
                if age < fail_ttl:
                    with open(fail_cache) as fh:
                        kind, _, cause = fh.read().strip().partition("\t")
                    raise (ProbeHung if kind == "hung" else NoCudaDevice)(
                        f"{cause or 'CUDA device probe failed'} ({age:.0f}s "
                        f"ago, cached; remove {fail_cache} or set "
                        "GOLEFT_TPU_PROBE_FAIL_TTL_SECONDS=0 to re-probe)")
            except OSError:
                pass
    from .profiling import StageTimer

    with StageTimer().stage("device-probe"):
        rec = probe_device(argv=probe_argv)
    _counter("device.probe_total")
    if rec["ok"]:
        if probe_argv is None:
            try:
                os.remove(fail_cache)  # recovered: forget the failure
            except OSError:
                pass
            if ttl > 0:
                _write(cache, rec.get("stdout", ""))
        return "probed"
    line = _probe_failure(rec)
    spawn = str(rec.get("error", "")).startswith("spawn failed")
    hung = rec.get("rc") is None and not spawn
    # a spawn failure is about this host's moment, not the card: it is
    # not cached
    if fail_ttl > 0 and probe_argv is None and not spawn:
        _write(fail_cache, f"{'hung' if hung else 'failed'}\t{line}")
    raise (ProbeHung if hung else NoCudaDevice)(line)


def _write(path: str, text: str) -> None:
    try:
        with open(path, "w") as fh:
            fh.write(text + "\n")
    except OSError:
        pass


def _cuda_devices() -> list:
    """The first CUDA discovery: initialise CUDA and list the visible
    cards (none when CUDA sees none: the command's own
    ``resolve_device`` then raises)."""
    import torch

    if not torch.cuda.is_available():
        return []
    torch.cuda.init()
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def devices_with_watchdog(seconds: float | None = None, discover=None):
    """``discover()`` (by default the first CUDA discovery,
    :func:`_cuda_devices`) with a hang warning: when it takes longer
    than ``seconds``, log what is probably wrong while it goes on. Its
    wall clock goes into the manifest's spans as ``device-bringup``."""
    from .profiling import StageTimer

    deadline = WATCHDOG_SECONDS if seconds is None else seconds
    done = threading.Event()

    def _warn():
        if not done.wait(deadline):
            log.warning(
                "CUDA bring-up has taken >%.0fs: the driver or the card "
                "may be wedged (nvidia-smi shows its state). "
                "GOLEFT_TPU_DEVICE_WATCHDOG_SECONDS sets this deadline.",
                deadline,
            )

    t = threading.Thread(target=_warn, daemon=True)
    t.start()
    try:
        with StageTimer().stage("device-bringup"):
            return (discover or _cuda_devices)()
    finally:
        done.set()
        # wait() returns as soon as done is set, so this join is
        # immediate; without it the thread could fire a stale warning
        # after the caller has its devices
        t.join(timeout=5.0)
