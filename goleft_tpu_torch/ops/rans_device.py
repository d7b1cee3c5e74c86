"""Device-resident rANS-Nx16 entropy decode (CRAM 3.1 method 5) on the card.

The counterpart of the JAX package's ops/rans_device.py. Compressed block
bytes and their table arrays cross to the card; the interleaved-rANS
state machine runs there in the hand-written CUDA kernel
(ops/rans_kernel.py, csrc/rans_kernel.cu: ORDER0 and ORDER1), and the
RLE and PACK expansions and the STRIPE interleave run as PyTorch ops on
the card (cumsum, searchsorted, gathers), as the JAX package left them to
XLA outside its Pallas kernel. One device path: the JAX package's
``backend`` / ``interpret`` arguments have no counterpart.

Blocks pad to power-of-two bucket signatures (payload length, round
count, expansion caps) and each signature is one kernel launch over its
blocks. The process-wide cap on distinct signatures
(``MAX_BUCKET_SIGNATURES``) bounds XLA compiles in the JAX package; the
port has no compile per shape but keeps the cap, its counters and its
host decode of blocks past it, which is the reference's observable
behaviour. The cap applies to admission only and never hides a kernel
fault.

``DeviceBlockDecoder`` is the CRAM-facing object: io/cram.py hands it a
container's raw (still compressed) blocks; supported rANS blocks decode
on the card through one content-keyed plan Step at the ``decode`` fault
site; everything else decodes on the host, byte-identically and counted.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..io import rans_nx16 as _rx
from ..device import KernelFault
from ..io.rans_nx16 import ParsedNx16, parse_nx16
from ..obs import get_registry
from ..obs.logging import get_logger
from .rans_kernel import rans_decode

TF_SHIFT = _rx.TF_SHIFT
TOTFREQ = _rx.TOTFREQ

log = get_logger("ops.rans_device")

#: minimum pad bucket for payload/output axes (pow-2 above)
MIN_BUCKET = 64

#: process-wide cap on distinct bucket signatures (decode buckets +
#: stripe interleave shapes), as in the JAX package; blocks whose NEW
#: signature would exceed it decode on the host, a per-block fallback
#: and never an error
MAX_BUCKET_SIGNATURES = 128

_SIG_LOCK = threading.Lock()
_SEEN_SIGS: set[tuple] = set()
_CAP_TRIPPED = False


def bucket(n: int, minimum: int = MIN_BUCKET) -> int:
    b = minimum
    while b < n:
        b <<= 1
    return b


def reset_signature_registry() -> None:
    """Test hook: forget admitted signatures."""
    global _CAP_TRIPPED
    with _SIG_LOCK:
        _SEEN_SIGS.clear()
        _CAP_TRIPPED = False


def _admit_signatures(sigs: list[tuple]) -> bool:
    """Admit a block's signatures against the process cap, all-or-nothing
    (a stripe block needs every lane signature plus its interleave
    shape). Over the cap, NEW signatures are refused and the block falls
    back to the host codec; already-seen signatures always pass."""
    global _CAP_TRIPPED
    with _SIG_LOCK:
        fresh = [s for s in dict.fromkeys(sigs) if s not in _SEEN_SIGS]
        if not fresh:
            return True
        if len(_SEEN_SIGS) + len(fresh) > MAX_BUCKET_SIGNATURES:
            if not _CAP_TRIPPED:
                _CAP_TRIPPED = True
                log.warning(
                    "decode: bucket-signature cap reached (%d); new "
                    "block shapes fall back to the host codec "
                    "(decode.bucket_cap_fallback_total counts them)",
                    MAX_BUCKET_SIGNATURES)
            return False
        _SEEN_SIGS.update(fresh)
        get_registry().counter("decode.bucket_signatures").inc(len(fresh))
        return True


def _signature(p: ParsedNx16) -> tuple:
    """Pad-to-bucket signature: every axis rounds up to a power of two.
    ORDER1 adds (shift, n_ctx_cap) axes and widens the round count by
    N-1 (the last lane's tail rounds beyond F)."""
    n = p.n_states
    lit_cap = bucket(max(p.inner_len, 1))
    if not p.cat:
        rounds = (lit_cap + n - 1) // n
        lit_cap = rounds * n
        if p.order1:
            rounds += n - 1
    else:
        rounds = 0
    p_cap = bucket(max(p.payload.shape[0], 1))
    if p.cat:
        p_cap = max(p_cap, lit_cap)  # CAT payload IS the literals
    mid_cap = bucket(max(p.rle_out_len, 1)) if p.rle else lit_cap
    out_cap = bucket(max(p.final_len, 1)) if p.pack else mid_cap
    runs_cap = bucket(len(p.rle_runs) if p.rle_runs is not None
                      else 0, minimum=16)
    shift = p.shift if p.order1 else TF_SHIFT
    n_ctx_cap = bucket(max(p.n_ctx, 1), minimum=16) if p.order1 else 1
    return (n, p.cat, p.order1, shift, p.rle, p.pack, rounds, p_cap,
            lit_cap, mid_cap, out_cap, runs_cap, n_ctx_cap)


def _stripe_shape(p: ParsedNx16) -> tuple[int, int, int]:
    """(n_lanes, lane_cap, out_cap) of a stripe container's interleave."""
    lane_cap = bucket(max((p.final_len + p.n_lanes - 1) // p.n_lanes, 1))
    return (p.n_lanes, lane_cap, bucket(max(p.final_len, 1)))


def plan_signatures(p: ParsedNx16) -> list[tuple]:
    """Every signature decoding this block requires (a stripe container
    needs each lane's bucket plus its interleave shape): the admission
    unit for the ``MAX_BUCKET_SIGNATURES`` cap."""
    if p.stripe:
        sigs = [_signature(ch) for ch in p.children or []]
        sigs.append(("ilv",) + _stripe_shape(p))
        return sigs
    return [_signature(p)]


def _host_arrays(grp: list[ParsedNx16], sig: tuple) -> dict:
    """One bucket's padded host arrays (the wire layout)."""
    (n, cat, order1, _shift, rle, pack, _rounds, p_cap, _lit_cap,
     _mid_cap, _out_cap, runs_cap, n_ctx_cap) = sig
    B = len(grp)
    host = dict(payload=np.zeros((B, p_cap), np.uint8),
                plen=np.zeros(B, np.int32), inner=np.zeros(B, np.int32),
                final=np.zeros(B, np.int32))
    if not cat:
        host["states"] = np.zeros((B, n), np.uint32)
        if order1:
            host["ctx_index"] = np.full((B, 256), -1, np.int16)
            host["ctx_freq"] = np.zeros((B, n_ctx_cap, n_ctx_cap), np.int16)
            host["alphabet"] = np.zeros((B, n_ctx_cap), np.int16)
        else:
            host["freq"] = np.zeros((B, 256), np.int16)
    if rle:
        host["rle_tab"] = np.zeros((B, 256), bool)
        host["runs"] = np.zeros((B, runs_cap), np.int32)
        host["rle_out"] = np.zeros(B, np.int32)
    if pack:
        host["pmap"] = np.zeros((B, 16), np.int32)
        host["bits"] = np.zeros(B, np.int32)
    for j, p in enumerate(grp):
        host["payload"][j, :p.payload.shape[0]] = p.payload
        host["plen"][j] = p.payload.shape[0]
        host["inner"][j] = p.inner_len
        host["final"][j] = p.final_len
        if not cat:
            host["states"][j] = p.states
            if order1:
                host["ctx_index"][j] = p.ctx_index
                host["ctx_freq"][j, :p.n_ctx, :p.n_ctx] = \
                    p.ctx_freq.astype(np.int16)
                host["alphabet"][j, :p.n_ctx] = p.alphabet
            else:
                host["freq"][j] = p.freq.astype(np.int16)
        if rle:
            host["rle_tab"][j] = p.rle_tab
            host["runs"][j, :len(p.rle_runs)] = p.rle_runs
            host["rle_out"][j] = p.rle_out_len
        if pack:
            host["pmap"][j] = p.pack_map
            host["bits"][j] = p.pack_bits
    return host


def _expand_rle(lit, inner, rle_tab, runs, rle_out, mid_cap: int):
    """RLE expansion, batched: each marked literal repeats 1 + its run
    extension; output position p maps back to the literal whose
    cumulative start covers it (searchsorted over the exclusive cumsum).
    Returns (mid (B, mid_cap) u8, rle_total (B,), marked_total (B,))."""
    dev = lit.device
    lit_cap = lit.shape[1]
    idx = torch.arange(lit_cap, device=dev)[None, :]
    in_range = idx < inner[:, None]
    marked = rle_tab.gather(1, lit.to(torch.int64)) & in_range
    mi = marked.to(torch.int64)
    rank = torch.cumsum(mi, 1) - mi
    rcap = runs.shape[1]
    ext = runs.to(torch.int64).gather(1, torch.clamp(rank, 0, rcap - 1))
    rep = torch.where(in_range, 1 + torch.where(marked, ext, 0), 0)
    starts = torch.cumsum(rep, 1) - rep
    rle_total = starts[:, -1] + rep[:, -1]
    posn = torch.arange(mid_cap, device=dev).expand(lit.shape[0], mid_cap)
    src = torch.clamp(torch.searchsorted(starts, posn.contiguous(),
                                         right=True) - 1, 0, lit_cap - 1)
    mid = torch.where(posn < rle_out[:, None], lit.gather(1, src), 0)
    return mid.to(torch.uint8), rle_total, mi.sum(1)


def _expand_pack(mid, pmap, bits, final, out_cap: int):
    """PACK expansion: shift/mask gathers (bits in {0, 1, 2, 4},
    LSB-first). Returns (out (B, out_cap) u8, vmax (B,))."""
    dev = mid.device
    mid_cap = mid.shape[1]
    i = torch.arange(out_cap, device=dev)[None, :]
    b = bits.to(torch.int64)[:, None]
    per = torch.div(8, torch.clamp_min(b, 1), rounding_mode="floor")
    idxp = torch.clamp(torch.div(i, per, rounding_mode="floor"), 0,
                       mid_cap - 1)
    sh = b * (i % per)
    maskb = (1 << b) - 1
    v = (mid.to(torch.int64).gather(1, idxp) >> sh) & maskb
    pm = pmap.to(torch.int64)
    outb = torch.where(b == 0, pm[:, :1], pm.gather(1, torch.clamp(v, 0, 15)))
    vmax = torch.where((i < final[:, None]) & (b > 0), v, 0).amax(1)
    return outb.to(torch.uint8), vmax


def _decode_group(dev: dict, sig: tuple):
    """One bucket on the card: the kernel (or the CAT literals), then the
    expansions. Returns (out (B, out_cap) u8, diag (B, 4) int64:
    [rle_total, marked_total, pack_vmax, missing_ctx])."""
    (n, cat, order1, shift, rle, pack, _rounds, _p_cap, lit_cap, mid_cap,
     out_cap, _runs_cap, _n_ctx_cap) = sig
    inner = dev["inner"]
    B = inner.shape[0]
    zeros = torch.zeros(B, dtype=torch.int64, device=inner.device)
    bad = zeros
    if cat:
        lit = dev["payload"][:, :lit_cap]
    elif order1:
        lit, bad = rans_decode(
            dev["payload"], dev["plen"], dev["states"], inner, n_states=n,
            out_len=lit_cap, ctx_index=dev["ctx_index"],
            ctx_freq=dev["ctx_freq"], alphabet=dev["alphabet"], shift=shift)
    else:
        lit, _ = rans_decode(dev["payload"], dev["plen"], dev["states"],
                             inner, n_states=n, out_len=lit_cap,
                             freq=dev["freq"])
    if rle:
        mid, rle_total, marked_total = _expand_rle(
            lit, inner, dev["rle_tab"], dev["runs"], dev["rle_out"],
            mid_cap)
    else:
        mid, rle_total, marked_total = lit, inner.to(torch.int64), zeros
    if pack:
        out, vmax = _expand_pack(mid, dev["pmap"], dev["bits"],
                                 dev["final"], out_cap)
    else:
        out, vmax = mid, zeros
    diag = torch.stack([rle_total.to(torch.int64), marked_total,
                        vmax.to(torch.int64), bad.to(torch.int64)], 1)
    return out, diag


def _check_diag(p: ParsedNx16, sig: tuple, diag) -> None:
    """The JAX package's per-block diagnostics, word for word."""
    order1, rle, pack = sig[2], sig[4], sig[5]
    if order1 and int(diag[3]):
        raise ValueError(
            "rans-nx16: missing order-1 context")
    if rle:
        if int(diag[0]) != p.rle_out_len:
            raise ValueError(
                "rans-nx16: rle expansion length mismatch")
        if p.rle_runs is not None \
                and int(diag[1]) > len(p.rle_runs):
            raise ValueError(
                "rans-nx16: rle metadata exhausted")
    if pack and p.pack_bits > 0 \
            and int(diag[2]) >= p.pack_nsym:
        raise ValueError(
            "rans-nx16: pack index out of range")


def _sync(device) -> None:
    """Wait for the card's queued work. An error a kernel left on the
    card surfaces here as :class:`KernelFault`, not as a plain
    RuntimeError at the next copy, which the retry policy would take for
    transient and the sample Step would quarantine."""
    if device.type != "cuda":
        return
    try:
        torch.cuda.synchronize(device)
    except RuntimeError as e:
        raise KernelFault(f"rans decode failed on the card: {e}") from e


def _decode_flat(plans: list[ParsedNx16], device) -> list:
    """The bucketed dispatch over non-stripe plans: one kernel launch per
    signature. Each bucket's host arrays are staged through
    parallel.prefetch.stage_block_arrays (pinned buffers, counted), the
    uint32 states as their int32 bits. Returns each plan's decoded device
    row (valid through its final_len); the diagnostics are checked here,
    after one fetch of all of them."""
    from ..parallel.prefetch import stage_block_arrays

    results: list = [None] * len(plans)
    groups: dict[tuple, list[int]] = {}
    for i, p in enumerate(plans):
        groups.setdefault(_signature(p), []).append(i)
    pending = []
    for sig in sorted(groups):
        idxs = groups[sig]
        host = _host_arrays([plans[i] for i in idxs], sig)
        if "states" in host:
            host["states"] = host["states"].view(np.int32)
        out, diag = _decode_group(stage_block_arrays(host, device), sig)
        pending.append((sig, idxs, out, diag))
    if not pending:
        return results
    _sync(device)
    diags = torch.cat([d for *_, d in pending]).cpu().numpy()
    k = 0
    for sig, idxs, out, _ in pending:
        for j, i in enumerate(idxs):
            _check_diag(plans[i], sig, diags[k])
            results[i] = out[j]
            k += 1
    return results


def _interleave(lanes_arr, final, n_lanes: int, out_cap: int):
    """Batched STRIPE reassembly: (B, n_lanes, lane_cap) lane bytes →
    (B, out_cap); output position i comes from lane i mod N' at offset
    i // N'."""
    idx = torch.arange(out_cap, device=lanes_arr.device)
    # positions past final_len are masked; clamp their offsets in range
    off = torch.clamp(idx // n_lanes, max=lanes_arr.shape[2] - 1)
    out = lanes_arr[:, idx % n_lanes, off]
    return torch.where(idx[None, :] < final[:, None], out, 0)


def decode_parsed(plans: list[ParsedNx16], *, device=None) -> list[bytes]:
    """Decode parsed streams on the card (``device``; the CPU runs the
    kernel's plain version), bucketed; returns bytes per stream,
    byte-identical to ``rans_nx16.decode``.

    STRIPE containers flatten into their lane sub-streams (decoded
    through the same buckets as standalone blocks) and reassemble with one
    batched interleave gather per stripe shape; lane rows stay on the
    card in between."""
    from ..device import resolve_device

    device = resolve_device(device)
    flat: list[ParsedNx16] = []
    spec: list[tuple] = []
    for p in plans:
        if p.stripe:
            idxs = []
            for ch in p.children or []:
                idxs.append(len(flat))
                flat.append(ch)
            spec.append(("stripe", idxs, p))
        else:
            spec.append(("plain", len(flat), p))
            flat.append(p)
    decoded = _decode_flat(flat, device)

    rows: list = [None] * len(plans)
    stripe_groups: dict[tuple, list[int]] = {}
    for i, entry in enumerate(spec):
        if entry[0] == "plain":
            rows[i] = decoded[entry[1]]
        else:
            stripe_groups.setdefault(_stripe_shape(entry[2]), []).append(i)
    for shape in sorted(stripe_groups):
        n_lanes, lane_cap, out_cap = shape
        members = stripe_groups[shape]
        lane_rows = []
        for i in members:
            for k in spec[i][1]:
                # a lane row is valid through the lane's final_len, and
                # the interleave never reads past it for output
                # positions < final_len
                r = decoded[k]
                if r.shape[0] >= lane_cap:
                    r = r[:lane_cap]
                else:
                    r = torch.nn.functional.pad(r, (0, lane_cap - r.shape[0]))
                lane_rows.append(r)
        lanes_arr = torch.stack(lane_rows).reshape(len(members), n_lanes,
                                                   lane_cap)
        final = torch.tensor([spec[i][2].final_len for i in members],
                             dtype=torch.int64, device=device)
        out = _interleave(lanes_arr, final, n_lanes, out_cap)
        for b, i in enumerate(members):
            rows[i] = out[b]
    _sync(device)
    results = []
    for p, r in zip(plans, rows):
        results.append(bytes(r[:p.final_len].cpu().numpy()))
    return results


def decode_streams(datas: list[bytes],
                   expected_lens: list[int | None] | None = None,
                   *, device=None) -> list[bytes | None]:
    """Parse + device-decode many standalone Nx16 streams; None marks a
    stream that stays on the host (unsupported/corrupt layout, or a new
    bucket shape past the signature cap: the caller falls back to
    ``rans_nx16.decode``)."""
    if expected_lens is None:
        expected_lens = [None] * len(datas)
    plans, order = [], []
    results: list[bytes | None] = [None] * len(datas)
    for i, (d, el) in enumerate(zip(datas, expected_lens)):
        p = parse_nx16(d, el)
        if p is not None and _admit_signatures(plan_signatures(p)):
            plans.append(p)
            order.append(i)
    decoded = decode_parsed(plans, device=device)
    for i, b in zip(order, decoded):
        results[i] = b
    return results


class DeviceBlockDecoder:
    """Per-container CRAM block decode with the entropy stage on the card.

    io/cram.py hands :meth:`decode_blocks` one container's raw (still
    compressed) blocks. rANS-Nx16 blocks decode on the card in one
    bucketed dispatch, the full method-5 matrix (ORDER0/ORDER1 ×
    CAT/PACK/RLE/NOSZ/STRIPE, N=4/X32), as a content-keyed plan Step at
    the ``decode`` fault site (span ``decode.device``), so a transient
    fault costs one backoff and the per-sample quarantine above composes
    unchanged. Host decodes: corrupt or foreign rANS streams and new
    bucket shapes past ``MAX_BUCKET_SIGNATURES``
    (``decode.device_fallback_total``; cap refusals also in
    ``decode.bucket_cap_fallback_total``), and non-rANS methods
    (``decode.host_blocks_total``).

    Wire accounting: compressed payload plus the table arrays cross to
    the card instead of the inflated bytes
    (``decode.wire_bytes_compressed_total`` vs
    ``decode.wire_bytes_uncompressed_total``, the table share in
    ``decode.table_bytes_total``); the prefetch byte counters record the
    staging too.
    """

    def __init__(self, device=None):
        from ..device import resolve_device
        from ..plan import Executor

        self.device = resolve_device(device)
        self._pex = Executor()
        reg = get_registry()
        self._c_dev = reg.counter("decode.device_blocks_total")
        self._c_fall = reg.counter("decode.device_fallback_total")
        self._c_cap = reg.counter("decode.bucket_cap_fallback_total")
        self._c_host = reg.counter("decode.host_blocks_total")
        self._c_wire_c = reg.counter("decode.wire_bytes_compressed_total")
        self._c_wire_u = reg.counter(
            "decode.wire_bytes_uncompressed_total")
        self._c_table = reg.counter("decode.table_bytes_total")

    def decode_blocks(self, raws) -> list[bytes]:
        """raw blocks (io.cram.RawBlock) → uncompressed bytes, in order;
        byte-identical to the host path for every block."""
        from ..io import cram as _cram
        from ..plan import Step

        results: list[bytes | None] = [None] * len(raws)
        plans: list[ParsedNx16] = []
        order: list[int] = []
        for i, rb in enumerate(raws):
            if rb.method == _cram.M_RANSNX16:
                p = parse_nx16(rb.raw, rb.rsize)
                if p is not None:
                    if _admit_signatures(plan_signatures(p)):
                        plans.append(p)
                        order.append(i)
                        continue
                    self._c_cap.inc()
                self._c_fall.inc()
            elif rb.method != _cram.M_RAW:
                self._c_host.inc()
            results[i] = _cram._decompress(rb.method, rb.raw, rb.rsize)
        if plans:
            table_b = sum(p.table_bytes for p in plans)
            wire_c = sum(p.payload_bytes for p in plans) + table_b
            wire_u = sum(p.final_len for p in plans)
            crc = tcrc = 0
            for p in plans:
                crc = p.payload_crc(crc)
                tcrc = p.table_crc(tcrc)
            # the table CRC joins the content key: the same payload
            # bytes under another table are another decode
            key = ("decode", len(plans), wire_c, crc, tcrc)
            decoded = self._pex.run(Step(
                key=key, site="decode", span="decode.device",
                attrs={"blocks": len(plans), "wire_bytes": wire_c},
                fn=lambda: decode_parsed(plans, device=self.device)))
            self._c_dev.inc(len(plans))
            self._c_wire_c.inc(wire_c)
            self._c_wire_u.inc(wire_u)
            self._c_table.inc(table_b)
            for i, b in zip(order, decoded):
                results[i] = b
        return results
