"""Device-resident rANS-Nx16 entropy decode (CRAM 3.1 method 5) on the card.

The counterpart of the JAX package's ops/rans_device.py. Compressed block
bytes and their table arrays cross to the card; the interleaved-rANS
state machine runs there in the hand-written CUDA kernel
(ops/rans_kernel.py, csrc/rans_kernel.cu: ORDER0 and ORDER1), and the
RLE and PACK expansions and the STRIPE interleave run as PyTorch ops on
the card (cumsum, searchsorted, gathers), as the JAX package left them to
XLA outside its Pallas kernel. One device path: the JAX package's
``backend`` / ``interpret`` arguments have no counterpart.

Launch plan: the streams of one call (STRIPE lanes flattened) group by
(ORDER1, N, shift), and each group is one kernel launch
(:func:`launch_groups`). The kernel loops over each stream's own payload
and rounds, so a group's payloads lie back to back, each at an offset
that is a multiple of 16 bytes (the kernel's 16-byte copies), followed
by the kernel's PAYLOAD_TAIL bytes (it copies whole chunks), and its
ORDER1 tables are as wide as its widest (zero-frequency padding, which
no context reaches). Output rows are as wide as the group's longest
stream. CAT streams need no launch. Inside a group, rows sort by their
(RLE, PACK) transforms so each expansion runs on a slice.

Streams: every call runs on one CUDA stream, the caller's current one,
or under :class:`DeviceBlockDecoder` the calling thread's own, so the
containers of several sample threads overlap on the card. A call waits
on its stream only, then copies all its decoded rows (and the
diagnostics) to the host in one transfer into one pinned buffer.

``DeviceBlockDecoder`` is the CRAM-facing object: io/cram.py hands it a
container's raw (still compressed) blocks; supported rANS blocks decode
on the card through one content-keyed plan Step at the ``decode`` fault
site; everything else decodes on the host, byte-identically and counted.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from .. import obs
from ..io import rans_nx16 as _rx
from ..device import KernelFault
from ..io.rans_nx16 import ParsedNx16, parse_nx16
from ..obs import get_registry
from .rans_kernel import PAYLOAD_TAIL, payload_rows, rans_decode

TF_SHIFT = _rx.TF_SHIFT
TOTFREQ = _rx.TOTFREQ

#: streams start in a group's payload at multiples of this many bytes:
#: the kernel copies a payload into shared memory 16 bytes at a time
PAYLOAD_ALIGN = 16


def group_key(p: ParsedNx16) -> tuple | None:
    """The launch a stream joins: (ORDER1, N, shift), or None for a CAT
    stream, whose literals are its payload."""
    if p.cat:
        return None
    return (bool(p.order1), p.n_states, p.shift if p.order1 else TF_SHIFT)


def _flatten(plans: list[ParsedNx16]) -> list[ParsedNx16]:
    """STRIPE containers replaced by their lane streams."""
    return [c for p in plans for c in (p.children or [] if p.stripe
                                       else [p])]


def _grouped(plans: list[ParsedNx16]) -> list[tuple]:
    """[(key, indices)] over ``plans`` (no STRIPE containers), CAT first,
    then the kernel groups in key order; inside a group the indices sort
    by (RLE, PACK), so each transform's rows are one slice."""
    groups: dict = {}
    for i, p in enumerate(plans):
        groups.setdefault(group_key(p), []).append(i)
    return [(k, sorted(groups[k], key=lambda i: (plans[i].rle,
                                                 plans[i].pack)))
            for k in sorted(groups, key=lambda k: (k is not None, k or ()))]


def lit_width(grp: list[ParsedNx16]) -> int:
    """Columns of a group's literal rows: its longest inner length."""
    return max(max(p.inner_len for p in grp), 1)


def _host_arrays(grp: list[ParsedNx16], key: tuple | None) -> dict:
    """One group's host arrays (the wire layout): the payloads back to
    back, stream j from byte 16·poff[j] on, then the kernel's
    PAYLOAD_TAIL zero bytes; ORDER1 tables as wide as the group's
    widest."""
    B = len(grp)
    lens = np.array([p.payload.shape[0] for p in grp], np.int64)
    units = -(-lens // PAYLOAD_ALIGN)  # the 16-byte units of each stream
    host = dict(payload=np.zeros(int(units.sum()) * PAYLOAD_ALIGN
                                 + PAYLOAD_TAIL, np.uint8),
                poff=(np.cumsum(units) - units).astype(np.int32),
                plen=lens.astype(np.int32), inner=np.zeros(B, np.int32),
                final=np.zeros(B, np.int32))
    if key is not None:
        order1, n, _shift = key
        n_ctx = max(p.n_ctx for p in grp) if order1 else 0
        host["states"] = np.zeros((B, n), np.uint32)
        if order1:
            host["ctx_index"] = np.full((B, 256), -1, np.int16)
            host["ctx_freq"] = np.zeros((B, n_ctx, n_ctx), np.int16)
            host["alphabet"] = np.zeros((B, n_ctx), np.int16)
        else:
            host["freq"] = np.zeros((B, 256), np.int16)
    if any(p.rle for p in grp):
        runs_w = max(max(len(p.rle_runs) for p in grp if p.rle), 1)
        host["rle_tab"] = np.zeros((B, 256), bool)
        host["runs"] = np.zeros((B, runs_w), np.int32)
        host["rle_out"] = np.zeros(B, np.int32)
    if any(p.pack for p in grp):
        host["pmap"] = np.zeros((B, 16), np.int32)
        host["bits"] = np.zeros(B, np.int32)
    for j, p in enumerate(grp):
        o = int(host["poff"][j]) * PAYLOAD_ALIGN
        host["payload"][o:o + p.payload.shape[0]] = p.payload
        host["inner"][j] = p.inner_len
        host["final"][j] = p.final_len
        if key is not None:
            host["states"][j] = p.states
            if order1:
                c = p.n_ctx
                host["ctx_index"][j] = p.ctx_index
                host["ctx_freq"][j, :c, :c] = p.ctx_freq
                host["alphabet"][j, :c] = p.alphabet
            else:
                host["freq"][j] = p.freq.astype(np.int16)
        if p.rle:
            host["rle_tab"][j] = p.rle_tab
            host["runs"][j, :len(p.rle_runs)] = p.rle_runs
            host["rle_out"][j] = p.rle_out_len
        if p.pack:
            host["pmap"][j] = p.pack_map
            host["bits"][j] = p.pack_bits
    if key is not None:
        host["states"] = host["states"].view(np.int32)  # the uint32 bits
    return host


def launch_groups(plans: list[ParsedNx16]) -> list[tuple]:
    """The kernel launches that decoding ``plans`` makes, one per
    (ORDER1, N, shift) group of their non-CAT streams (STRIPE
    lanes flattened): [(key, the group's streams, its host arrays)], in
    launch order. :func:`group_stage` runs one of them."""
    flat = _flatten(plans)
    out = []
    for key, idxs in _grouped(flat):
        if key is not None:
            grp = [flat[i] for i in idxs]
            out.append((key, grp, _host_arrays(grp, key)))
    return out


def group_stage(key: tuple, grp: list[ParsedNx16], t: dict,
                fn=rans_decode):
    """The rANS stage of one launch group, on its arrays ``t`` (host
    arrays as tensors, where the call should run): ``fn`` is
    :func:`~.rans_kernel.rans_decode` (the kernel on the card) or
    :func:`~.rans_kernel.rans_decode_plain`. Returns (literals (B,
    lit_width) u8, missing-context flags (B,) i32 or None)."""
    order1, n, shift = key
    tables = dict(ctx_index=t["ctx_index"], ctx_freq=t["ctx_freq"],
                  alphabet=t["alphabet"], shift=shift) if order1 \
        else dict(freq=t["freq"])
    return fn(t["payload"], t["poff"], t["plen"], t["states"], t["inner"],
              n_states=n, out_len=lit_width(grp), **tables)


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


def _decode_group(key, grp: list[ParsedNx16], t: dict) -> list:
    """One group on the device: the kernel (or the CAT literals), then
    the expansions, each on the slice of rows that has it. Returns
    [(row slice, out (b, w) u8, diag (b, 4) int64: [rle_total,
    marked_total, pack_vmax, missing_ctx])]."""
    inner = t["inner"]
    B = inner.shape[0]
    zeros = torch.zeros(B, dtype=torch.int64, device=inner.device)
    bad = zeros
    if key is None:  # a CAT payload is its literals
        lit = payload_rows(t["payload"], t["poff"], t["plen"],
                           lit_width(grp))
    else:
        # one launch; under device events a fenced device.rans span
        # that waits on this thread's current stream only
        lit, flags = obs.dispatch("rans", group_stage, key, grp, t)
        if flags is not None:
            bad = flags.to(torch.int64)
    parts = []
    a = 0
    while a < B:
        rle, pack = grp[a].rle, grp[a].pack
        e = a
        while e < B and (grp[e].rle, grp[e].pack) == (rle, pack):
            e += 1
        sub = slice(a, e)
        cur, n_in, z = lit[sub], inner[sub], zeros[sub]
        if rle:
            cur, rle_total, marked = _expand_rle(
                cur, n_in, t["rle_tab"][sub], t["runs"][sub],
                t["rle_out"][sub],
                max(max(p.rle_out_len for p in grp[sub]), 1))
        else:
            rle_total, marked = n_in.to(torch.int64), z
        vmax = z
        if pack:
            cur, vmax = _expand_pack(cur, t["pmap"][sub], t["bits"][sub],
                                     t["final"][sub],
                                     max(max(p.final_len for p in grp[sub]),
                                         1))
        diag = torch.stack([rle_total.to(torch.int64), marked,
                            vmax.to(torch.int64), bad[sub]], 1)
        parts.append((sub, cur, diag))
        a = e
    return parts


def _check_diag(p: ParsedNx16, diag) -> None:
    """The JAX package's per-block diagnostics, word for word."""
    if p.order1 and int(diag[3]):
        raise ValueError(
            "rans-nx16: missing order-1 context")
    if p.rle:
        if int(diag[0]) != p.rle_out_len:
            raise ValueError(
                "rans-nx16: rle expansion length mismatch")
        if p.rle_runs is not None \
                and int(diag[1]) > len(p.rle_runs):
            raise ValueError(
                "rans-nx16: rle metadata exhausted")
    if p.pack and p.pack_bits > 0 \
            and int(diag[2]) >= p.pack_nsym:
        raise ValueError(
            "rans-nx16: pack index out of range")


def _sync(stream) -> None:
    """Wait for the work queued on ``stream`` (None on the CPU). An error
    a kernel left on the card surfaces here as :class:`KernelFault`, not
    as a plain RuntimeError at the next copy, which the retry policy
    would take for transient and the sample Step would quarantine."""
    if stream is None:
        return
    try:
        stream.synchronize()
    except RuntimeError as e:
        raise KernelFault(f"rans decode failed on the card: {e}") from e


def _decode_flat(plans: list[ParsedNx16], device) -> tuple[list, list]:
    """The grouped dispatch over non-stripe plans: one kernel launch per
    (ORDER1, N, shift) group. Each group's host arrays are staged
    through parallel.prefetch.stage_block_arrays (pinned buffers,
    counted). Returns (each plan's decoded device row, valid through its
    final_len; [(plan indices, their diag rows)])."""
    from ..parallel.prefetch import stage_block_arrays

    rows: list = [None] * len(plans)
    diags = []
    for key, idxs in _grouped(plans):
        grp = [plans[i] for i in idxs]
        t = stage_block_arrays(_host_arrays(grp, key), device)
        for sub, out, diag in _decode_group(key, grp, t):
            for j, i in enumerate(idxs[sub]):
                rows[i] = out[j]
            diags.append((idxs[sub], diag))
    return rows, diags


def _interleave(lanes_arr, n_lanes: int, out_w: int):
    """Batched STRIPE reassembly: (B, n_lanes, lane_w) lane bytes →
    (B, out_w); output position i comes from lane i mod N' at offset
    i // N'. Positions past a stream's final_len are not read."""
    idx = torch.arange(out_w, device=lanes_arr.device)
    off = torch.clamp(idx // n_lanes, max=lanes_arr.shape[2] - 1)
    return lanes_arr[:, idx % n_lanes, off]


def decode_parsed(plans: list[ParsedNx16], *, device=None,
                  stream=None) -> list[bytes]:
    """Decode parsed streams on the card (``device``; the CPU runs the
    kernel's plain version), grouped; returns bytes per stream,
    byte-identical to ``rans_nx16.decode``.

    Every launch, expansion and copy goes on ``stream`` (default: the
    current stream of ``device``); the call waits on it alone. STRIPE
    containers flatten into their lane streams (decoded in the same
    groups as standalone blocks) and reassemble with one batched
    interleave gather per lane count; lane rows stay on the card in
    between. The decoded rows and the diagnostics come back in one
    transfer."""
    from ..device import resolve_device

    device = resolve_device(device)
    if device.type == "cuda":
        stream = stream or torch.cuda.current_stream(device)
        ctx = torch.cuda.stream(stream)
    else:
        stream, ctx = None, contextlib.nullcontext()
    flat = _flatten(plans)
    with ctx:
        decoded, diags = _decode_flat(flat, device)
        rows: list = []
        stripes: dict[int, list[int]] = {}
        k = 0
        for i, p in enumerate(plans):
            if p.stripe:
                n = len(p.children or [])
                stripes.setdefault(n, []).append(i)
                rows.append(decoded[k:k + n])
                k += n
            else:
                rows.append(decoded[k])
                k += 1
        for n_lanes in sorted(stripes):
            members = stripes[n_lanes]
            lane_w = max(max((c.final_len for i in members
                              for c in plans[i].children), default=1), 1)
            lanes = [torch.nn.functional.pad(r[:lane_w],
                                             (0, lane_w - min(r.shape[0],
                                                              lane_w)))
                     for i in members for r in rows[i]]
            out = _interleave(
                torch.stack(lanes).reshape(len(members), n_lanes, lane_w),
                n_lanes, max(max(plans[i].final_len for i in members), 1))
            for b, i in enumerate(members):
                rows[i] = out[b]
        # one transfer: the diagnostics (8-byte aligned first), then
        # every row's bytes
        parts = [d.contiguous().view(torch.uint8).reshape(-1)
                 for _, d in diags]
        parts += [r[:p.final_len] for p, r in zip(plans, rows)]
        n_diag = 32 * sum(len(ix) for ix, _ in diags)
        host = torch.empty(n_diag + sum(p.final_len for p in plans),
                           dtype=torch.uint8,
                           pin_memory=stream is not None)
        if parts:
            host.copy_(torch.cat(parts), non_blocking=True)
    _sync(stream)
    buf = host.numpy()
    diag_rows = buf[:n_diag].view(np.int64).reshape(-1, 4)
    k = 0
    for idxs, _ in diags:
        for i in idxs:
            _check_diag(flat[i], diag_rows[k])
            k += 1
    k = n_diag
    results = []
    for p in plans:
        results.append(buf[k:k + p.final_len].tobytes())
        k += p.final_len
    return results


def decode_streams(datas: list[bytes],
                   expected_lens: list[int | None] | None = None,
                   *, device=None) -> list[bytes | None]:
    """Parse + device-decode many standalone Nx16 streams; None marks a
    stream that stays on the host (an unsupported or corrupt layout: the
    caller falls back to ``rans_nx16.decode``)."""
    if expected_lens is None:
        expected_lens = [None] * len(datas)
    plans, order = [], []
    results: list[bytes | None] = [None] * len(datas)
    for i, (d, el) in enumerate(zip(datas, expected_lens)):
        p = parse_nx16(d, el)
        if p is not None:
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
    grouped dispatch, the full method-5 matrix (ORDER0/ORDER1 ×
    CAT/PACK/RLE/NOSZ/STRIPE, N=4/X32), as a content-keyed plan Step at
    the ``decode`` fault site (span ``decode.device``), so a transient
    fault costs one backoff and the per-sample quarantine above composes
    unchanged. Each calling thread decodes on its own CUDA stream, so
    the sample threads' containers overlap on the card. Host decodes:
    corrupt or foreign rANS streams (``decode.device_fallback_total``)
    and non-rANS methods (``decode.host_blocks_total``).

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
        self._local = threading.local()
        reg = get_registry()
        self._c_dev = reg.counter("decode.device_blocks_total")
        self._c_fall = reg.counter("decode.device_fallback_total")
        self._c_host = reg.counter("decode.host_blocks_total")
        self._c_wire_c = reg.counter("decode.wire_bytes_compressed_total")
        self._c_wire_u = reg.counter(
            "decode.wire_bytes_uncompressed_total")
        self._c_table = reg.counter("decode.table_bytes_total")

    def _stream(self):
        """The calling thread's CUDA stream (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        s = getattr(self._local, "stream", None)
        if s is None:
            s = self._local.stream = torch.cuda.Stream(self.device)
        return s

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
                    plans.append(p)
                    order.append(i)
                    continue
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
            stream = self._stream()
            decoded = self._pex.run(Step(
                key=key, site="decode", span="decode.device",
                attrs={"blocks": len(plans), "wire_bytes": wire_c},
                fn=lambda: decode_parsed(plans, device=self.device,
                                         stream=stream)))
            self._c_dev.inc(len(plans))
            self._c_wire_c.inc(wire_c)
            self._c_wire_u.inc(wire_u)
            self._c_table.inc(table_b)
            for i, b in zip(order, decoded):
                results[i] = b
        return results
