"""ctypes loader for the port's C++ host-IO fast path (csrc/fastio.cpp).

Builds ``build/torch/libgoleftio.so`` with g++ on first use and falls
back to the pure-Python codecs on any failure (missing toolchain, build
error). The native calls release the GIL, so the shard-decode thread
pool scales.

``GOLEFT_TPU_TORCH_NATIVE_LIB`` names a library to load in its place, a
sanitizer build from ``tools/native_sanitize.py``: it is loaded as named,
never built or replaced, and a library that does not load raises. The
name is the port's own, so a test that holds the port against the JAX
package's ``goleft_tpu.io.native`` (which reads ``GOLEFT_TPU_ASAN_LIB``)
still loads each package's own library.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

log = logging.getLogger("goleft_tpu_torch.native")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "csrc", "fastio.cpp")
LIB = os.path.join(os.path.dirname(_PKG), "build", "torch", "libgoleftio.so")
#: the environment variable naming a library to load in place of LIB
OVERRIDE_ENV = "GOLEFT_TPU_TORCH_NATIVE_LIB"


def _build(src: str, out: str) -> bool:
    try:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        base = ["g++", "-O3", "-march=native", "-shared", "-fPIC", src]
        # libdeflate inflates BGZF 2-3x faster than zlib; fall back to a
        # zlib-only build where it isn't installed, or where it links but
        # its shared object is not on the loader's path
        err = ""
        for extra in (["-lz", "-ldeflate"], ["-DNO_LIBDEFLATE", "-lz"]):
            r = subprocess.run(
                base + extra + ["-o", tmp],
                capture_output=True, text=True, timeout=120,
            )
            if r.returncode != 0:
                err = r.stderr[-500:]
                continue
            try:
                ctypes.CDLL(tmp)
            except OSError as e:
                err = str(e)
                continue
            os.replace(tmp, out)
            return True
        log.warning("native build failed: %s", err)
        return False
    except Exception as e:  # noqa: BLE001
        log.warning("native build unavailable: %s", e)
        return False


def get_lib() -> ctypes.CDLL | None:
    """The loaded native library, or None (pure-Python fallback).

    ``_tried`` is set only once the outcome is in ``_lib``: a thread
    that finds it set outside the lock sees the loaded library, never a
    None left by another thread that is still building or loading it
    (the sample threads of a cohort open their inputs at once)."""
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if not _tried:
            _lib = _load()
            _tried = True
        return _lib


def _load() -> ctypes.CDLL | None:
    override = os.environ.get(OVERRIDE_ENV)
    if override:
        # OSError when it does not load: a run asked for this library
        lib = ctypes.CDLL(override)
    else:
        stale = not os.path.exists(LIB) or (
            os.path.getmtime(SRC) > os.path.getmtime(LIB))
        if stale and not _build(SRC, LIB):
            return None
        try:
            lib = ctypes.CDLL(LIB)
        except OSError as e:
            # a library built on another host (copied build tree) may
            # name shared objects this host lacks: build it here
            if stale or not _build(SRC, LIB):
                log.warning("native load failed: %s", e)
                return None
            lib = ctypes.CDLL(LIB)
    for name in ("bgzf_scan", "bgzf_inflate_range", "bgzf_deflate_block",
                 "bam_decode", "bam_segments_stream", "bam_window_reduce",
                 "bam_window_reduce_stream", "bam_window_acc_stream",
                 "bgzf_stream_inflate_only", "bai_scan",
                 "rans4x8_decode", "ransnx16_decode0", "ransnx16_decode1",
                 "arith_decode_body", "fqzcomp_decode", "tok3_assemble",
                 "format_matrix_rows", "format_depth_rows",
                 "format_class_rows", "format_float_matrix_rows",
                 "format_xy_json"):
        getattr(lib, name).restype = ctypes.c_long
    return lib


def _as_u8(data) -> np.ndarray:
    """bytes / mmap / ndarray → zero-copy uint8 view."""
    if isinstance(data, np.ndarray):
        return data
    return np.frombuffer(data, dtype=np.uint8)


def _ptr(arr: np.ndarray, t=ctypes.c_ubyte):
    return arr.ctypes.data_as(ctypes.POINTER(t))


def bgzf_scan(data):
    """(coffsets, uoffsets, total_uncompressed) via the native scanner;
    None when native is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    buf = _as_u8(data)
    max_blocks = max(len(buf) // 28 + 2, 16)
    co = np.zeros(max_blocks, dtype=np.int64)
    uo = np.zeros(max_blocks, dtype=np.int64)
    total = ctypes.c_long(0)
    n = lib.bgzf_scan(
        _ptr(buf), ctypes.c_long(len(buf)),
        _ptr(co, ctypes.c_long), _ptr(uo, ctypes.c_long),
        ctypes.c_long(max_blocks), ctypes.byref(total),
    )
    if n < 0:
        raise ValueError(f"bgzf scan: {_err(n)}")
    return co[:n], uo[:n], int(total.value)


def bgzf_inflate_range(data, c_begin: int, c_end: int,
                       cap: int) -> np.ndarray | None:
    """Inflate only blocks with compressed offset in [c_begin, c_end)."""
    lib = get_lib()
    if lib is None:
        return None
    buf = _as_u8(data)
    out = np.empty(cap, dtype=np.uint8)
    r = lib.bgzf_inflate_range(
        _ptr(buf), ctypes.c_long(len(buf)), ctypes.c_long(c_begin),
        ctypes.c_long(c_end), _ptr(out), ctypes.c_long(cap),
    )
    if r < 0:
        raise ValueError(
            f"bgzf: {_err(r)} (blocks at {c_begin}..{c_end})"
        )
    return out[:r]


_ERRS = {
    -1: "bad gzip magic",
    -2: "missing BC subfield (not BGZF)",
    -3: "output capacity exceeded",
    -4: "zlib init failed",
    -5: "corrupt deflate stream",
    -6: "truncated block",
    -7: "CRC mismatch (corrupt block)",
    -8: "corrupt block header geometry",
    -10: "bad gzip magic",
}

# bam_decode has its own error space (fastio.cpp bam_decode header)
_BAM_ERRS = {
    -1: "truncated record stream",
    -2: "capacity exceeded",
    -9: "malformed BAM record geometry",
}


def _err(code) -> str:
    return _ERRS.get(int(code), f"error {code}")


def _stream_err(code) -> str:
    """The streaming walk mixes both error spaces: -1/-9 come from the
    record walk, everything else from the BGZF layer."""
    code = int(code)
    if code in (-1, -9):
        return _BAM_ERRS[code]
    return _err(code)


def bam_decode(body: np.ndarray, offset: int, target_tid: int,
               start: int, end: int, cap_reads: int | None = None):
    """Decode records into columnar arrays; returns a dict of arrays plus
    consumed byte count, or None when native is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    remaining = len(body) - offset
    if cap_reads is None:
        cap_reads = max(remaining // 40 + 16, 1024)
    while True:
        cap_segs = cap_reads * 4
        a = {
            "tid": np.empty(cap_reads, np.int32),
            "pos": np.empty(cap_reads, np.int32),
            "end": np.empty(cap_reads, np.int32),
            "mapq": np.empty(cap_reads, np.uint8),
            "flag": np.empty(cap_reads, np.uint16),
            "tlen": np.empty(cap_reads, np.int32),
            "read_len": np.empty(cap_reads, np.int32),
            "mate_pos": np.empty(cap_reads, np.int32),
            "single_m": np.empty(cap_reads, np.uint8),
            "seg_start": np.empty(cap_segs, np.int32),
            "seg_end": np.empty(cap_segs, np.int32),
            "seg_read": np.empty(cap_segs, np.int32),
        }
        n_segs = ctypes.c_long(0)
        consumed = ctypes.c_long(0)
        done = ctypes.c_int32(0)

        def ptr(x, t):
            return a[x].ctypes.data_as(ctypes.POINTER(t))

        nr = lib.bam_decode(
            _ptr(body), ctypes.c_long(len(body)), ctypes.c_long(offset),
            ctypes.c_int(target_tid), ctypes.c_int(start),
            ctypes.c_int(end), ctypes.c_long(cap_reads),
            ctypes.c_long(cap_segs),
            ptr("tid", ctypes.c_int32), ptr("pos", ctypes.c_int32),
            ptr("end", ctypes.c_int32), ptr("mapq", ctypes.c_uint8),
            ptr("flag", ctypes.c_uint16), ptr("tlen", ctypes.c_int32),
            ptr("read_len", ctypes.c_int32),
            ptr("mate_pos", ctypes.c_int32),
            ptr("single_m", ctypes.c_uint8),
            ptr("seg_start", ctypes.c_int32),
            ptr("seg_end", ctypes.c_int32),
            ptr("seg_read", ctypes.c_int32),
            ctypes.byref(n_segs), ctypes.byref(consumed),
            ctypes.byref(done),
        )
        if nr == -2:
            cap_reads *= 2
            continue
        if nr < 0:
            raise ValueError(
                f"bam_decode: {_BAM_ERRS.get(int(nr), f'error {nr}')}")
        ns = int(n_segs.value)
        out = {k: v[: (ns if k.startswith("seg_") else nr)]
               for k, v in a.items()}
        out["n_reads"] = int(nr)
        out["consumed"] = int(consumed.value)
        out["done"] = bool(done.value)
        return out


def rans4x8_decode(data, pos: int, order: int,
                   out_len: int) -> bytes | None:
    """CRAM 4x8 rANS decode (orders 0/1) in C; None when native is
    unavailable (callers fall back to the pure-Python decoders).
    Raises ValueError on malformed streams / missing o1 contexts."""
    lib = get_lib()
    if lib is None:
        return None
    buf = _as_u8(data)
    out = np.empty(out_len, dtype=np.uint8)
    r = lib.rans4x8_decode(
        _ptr(buf), ctypes.c_long(len(buf)), ctypes.c_long(pos),
        ctypes.c_int(order), _ptr(out), ctypes.c_long(out_len),
    )
    if r == -9:
        raise ValueError("cram: rans missing order-1 context")
    if r < 0:
        raise ValueError("cram: malformed rans stream")
    return out.tobytes()


def ransnx16_decode0(data, pos: int, out_len: int,
                     n_states: int) -> bytes | None:
    """rANS-Nx16 order-0 decode in C; None when native is unavailable
    OR the stream needs the lenient pure-Python path (which also owns
    every error message) — callers always fall back on None."""
    lib = get_lib()
    if lib is None:
        return None
    buf = _as_u8(data)
    out = np.empty(out_len, dtype=np.uint8)
    r = lib.ransnx16_decode0(
        _ptr(buf), ctypes.c_long(len(buf)), ctypes.c_long(pos),
        _ptr(out), ctypes.c_long(out_len), ctypes.c_int(n_states),
    )
    return out.tobytes() if r == 0 else None


def arith_decode_body(data, pos: int, out_len: int, order: int,
                      rle: bool) -> bytes | None:
    """Adaptive-arithmetic coded-body decode in C (order 0/1, with or
    without the integrated RLE run models); None → fall back to the
    pure-Python decoder, which owns every error message."""
    lib = get_lib()
    if lib is None:
        return None
    buf = _as_u8(data)
    out = np.empty(out_len, dtype=np.uint8)
    r = lib.arith_decode_body(
        _ptr(buf), ctypes.c_long(len(buf)), ctypes.c_long(pos),
        _ptr(out), ctypes.c_long(out_len),
        ctypes.c_int(1 if order else 0), ctypes.c_int(1 if rle else 0),
    )
    return out.tobytes() if r == 0 else None


def fqzcomp_decode(data, out_len: int) -> bytes | None:
    """fqzcomp full-stream decode in C; None → fall back to the
    pure-Python decoder, which owns every error message (including
    the zero-length case, whose header checks C skips)."""
    lib = get_lib()
    if lib is None or out_len == 0:
        return None
    buf = _as_u8(data)
    out = np.empty(out_len, dtype=np.uint8)
    r = lib.fqzcomp_decode(
        _ptr(buf), ctypes.c_long(len(buf)), _ptr(out),
        ctypes.c_long(out_len),
    )
    return out.tobytes() if r == 0 else None


def tok3_assemble(streams: dict, n_names: int, sep: int,
                  out_len: int) -> bytes | None:
    """Name assembly over already-decompressed tok3 streams in C;
    ``streams`` maps (position, field) → raw bytes. None → fall back
    to the pure-Python assembly, which owns every error message."""
    lib = get_lib()
    if lib is None:
        return None
    # n_names/out_len come from attacker-controlled varints; absurd
    # values must fall back to the Python path's typed errors rather
    # than raise OverflowError from ctypes or MemoryError from the
    # allocation (every name contributes at least its separator, so
    # valid inputs satisfy n_names <= out_len)
    if not 0 <= n_names <= out_len or out_len > (1 << 40):
        return None
    offs = np.full(256 * 13, -1, dtype=np.int64)
    lens = np.zeros(256 * 13, dtype=np.int64)
    parts = []
    off = 0
    for (p, f), raw in streams.items():
        if not 0 <= p < 256 or not 0 <= f < 13:
            return None
        slot = p * 13 + f
        offs[slot] = off
        lens[slot] = len(raw)
        parts.append(raw)
        off += len(raw)
    blob = np.frombuffer(b"".join(parts), dtype=np.uint8) if parts \
        else np.empty(0, dtype=np.uint8)
    try:
        out = np.empty(out_len, dtype=np.uint8)
    except MemoryError:
        # a huge declared size the host cannot hold: the Python
        # assembly fails with its own typed error long before
        # allocating this much
        return None
    r = lib.tok3_assemble(
        _ptr(blob), offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_long(n_names), ctypes.c_ubyte(sep),
        _ptr(out), ctypes.c_long(out_len),
    )
    return out.tobytes() if r == 0 else None


def ransnx16_decode1(data, pos: int, table, table_pos: int,
                     table_inline: bool, shift: int, out_len: int,
                     n_states: int) -> bytes | None:
    """rANS-Nx16 order-1 decode in C (table either inline ahead of the
    states or in a separately decompressed buffer); None → fall back
    to the pure-Python decoder."""
    lib = get_lib()
    if lib is None:
        return None
    buf = _as_u8(data)
    tbl = buf if table_inline else _as_u8(table)
    out = np.empty(out_len, dtype=np.uint8)
    r = lib.ransnx16_decode1(
        _ptr(buf), ctypes.c_long(len(buf)), ctypes.c_long(pos),
        _ptr(tbl), ctypes.c_long(len(tbl)), ctypes.c_long(table_pos),
        ctypes.c_int(1 if table_inline else 0), ctypes.c_int(shift),
        _ptr(out), ctypes.c_long(out_len), ctypes.c_int(n_states),
    )
    return out.tobytes() if r == 0 else None


def bgzf_deflate_block(chunk: bytes, level: int) -> bytes | None:
    """One complete BGZF member (header + deflate + crc/isize) for
    ``chunk`` (≤ 65280 bytes); None when native is unavailable (callers
    fall back to zlib)."""
    lib = get_lib()
    if lib is None:
        return None
    buf = _as_u8(chunk)
    cap = len(buf) * 2 + 4096
    out = np.empty(cap, dtype=np.uint8)
    n = lib.bgzf_deflate_block(
        _ptr(buf), ctypes.c_long(len(buf)), ctypes.c_int(level),
        _ptr(out), ctypes.c_long(cap),
    )
    if n < 0:
        return None  # fall back to the zlib path
    return out[:n].tobytes()


def bgzf_stream_inflate_only(comp, check_crc: bool = True):
    """Total uncompressed bytes after streaming the whole BGZF file
    through the product ring driver with a no-op walk — isolates the
    inflate(+CRC) floor of the fused decode stage for the bench's
    decode-floor evidence. None when native is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    buf = _as_u8(comp)
    total = ctypes.c_int64(0)
    r = lib.bgzf_stream_inflate_only(
        _ptr(buf), ctypes.c_long(len(buf)), ctypes.c_long(0),
        ctypes.c_long(0), ctypes.c_int(1 if check_crc else 0),
        ctypes.byref(total),
    )
    if r < 0:
        raise ValueError(f"bgzf stream inflate: {_stream_err(r)}")
    return int(total.value)


def bai_scan(data):
    """Single-pass .bai structure scan → dict of per-ref arrays
    (bins_start, bins_end, n_intv, intv_off, mapped, unmapped), or None
    without native. Negative returns raise with a specific message."""
    lib = get_lib()
    if lib is None:
        return None
    buf = _as_u8(data)
    if len(buf) < 8:
        raise ValueError("bai: truncated or corrupt index (-2)")
    # every reference costs >= 8 bytes, so a corrupt header cannot
    # demand a larger allocation than the bytes could hold
    max_ref = max(int(np.frombuffer(buf[4:8], "<i4")[0]), 0)
    max_ref = min(max_ref, len(buf) // 8 + 1)
    keys = ("bins_start", "bins_end", "n_intv", "intv_off", "mapped",
            "unmapped")
    arrs = {k: np.empty(max_ref, np.int64) for k in keys}
    n = lib.bai_scan(
        _ptr(buf), ctypes.c_long(len(buf)), ctypes.c_long(max_ref),
        *(_ptr(arrs[k], ctypes.c_int64) for k in keys),
    )
    if n == -1:
        raise ValueError("not a BAI file (bad magic)")
    if n == -3:
        raise ValueError("bai: implausible n_ref (over what the bytes "
                         "can hold)")
    if n < 0:
        raise ValueError(f"bai: truncated or corrupt index ({n})")
    return {k: v[:n] for k, v in arrs.items()}


def format_matrix_rows(chrom: str, starts: np.ndarray, ends: np.ndarray,
                       vals: np.ndarray) -> bytes | None:
    """'chrom\\tstart\\tend\\tv...' rows as one bytes blob; None without
    native. vals is (n_cols, n_rows) — cohortdepth's (samples, windows)
    layout, consumed column-major so no transpose happens anywhere."""
    lib = get_lib()
    if lib is None:
        return None
    n_cols, n_rows = vals.shape
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    cb = chrom.encode()
    cap = n_rows * (len(cb) + 2 * 21 + n_cols * 21 + 2) + 16
    out = np.empty(cap, dtype=np.uint8)
    w = lib.format_matrix_rows(
        ctypes.c_char_p(cb), ctypes.c_long(len(cb)),
        _ptr(starts, ctypes.c_int64), _ptr(ends, ctypes.c_int64),
        _ptr(vals, ctypes.c_int64), ctypes.c_long(n_rows),
        ctypes.c_long(n_cols), _ptr(out, ctypes.c_char),
        ctypes.c_long(cap),
    )
    if w < 0:
        raise ValueError("format_matrix_rows: capacity exceeded")
    return out[:w].tobytes()


def format_depth_rows(chrom: str, starts: np.ndarray, ends: np.ndarray,
                      means: np.ndarray) -> bytes | None:
    """'chrom\\tstart\\tend\\t%.4g' rows; None without native."""
    lib = get_lib()
    if lib is None:
        return None
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    means = np.ascontiguousarray(means, dtype=np.float64)
    cb = chrom.encode()
    n = len(starts)
    cap = n * (len(cb) + 2 * 21 + 44) + 16
    out = np.empty(cap, dtype=np.uint8)
    w = lib.format_depth_rows(
        ctypes.c_char_p(cb), ctypes.c_long(len(cb)),
        _ptr(starts, ctypes.c_int64), _ptr(ends, ctypes.c_int64),
        _ptr(means, ctypes.c_double), ctypes.c_long(n),
        _ptr(out, ctypes.c_char), ctypes.c_long(cap),
    )
    if w < 0:
        raise ValueError("format_depth_rows: capacity exceeded")
    return out[:w].tobytes()


def format_class_rows(chrom: str, starts: np.ndarray, ends: np.ndarray,
                      cls: np.ndarray) -> bytes | None:
    """'chrom\\tstart\\tend\\tCLASS_NAME' rows; None without native."""
    lib = get_lib()
    if lib is None:
        return None
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    cls = np.ascontiguousarray(cls, dtype=np.uint8)
    cb = chrom.encode()
    n = len(starts)
    cap = n * (len(cb) + 2 * 21 + 24) + 16
    out = np.empty(cap, dtype=np.uint8)
    w = lib.format_class_rows(
        ctypes.c_char_p(cb), ctypes.c_long(len(cb)),
        _ptr(starts, ctypes.c_int64), _ptr(ends, ctypes.c_int64),
        _ptr(cls, ctypes.c_uint8), ctypes.c_long(n),
        _ptr(out, ctypes.c_char), ctypes.c_long(cap),
    )
    if w == -2:
        raise ValueError("format_class_rows: class id out of range")
    if w < 0:
        raise ValueError("format_class_rows: capacity exceeded")
    return out[:w].tobytes()


def bam_segments_stream(comp, c_begin: int, in_block: int,
                        target_tid: int, start: int, end: int,
                        min_mapq: int, flag_mask: int,
                        check_crc: bool | None = None,
                        cap_hint: int | None = None):
    """Streaming extraction of the region's FILTERED clipped segment
    endpoints — the depth path's host stage (csrc/fastio.cpp::
    bam_segments_stream). Returns (seg_start, seg_end) int32 arrays
    (absolute, clipped to [start, end)), or None when native is
    unavailable. ``check_crc`` defaults to on; GOLEFT_TPU_SKIP_CRC=1
    (``--no-crc``) turns it off."""
    lib = get_lib()
    if lib is None:
        return None
    if end < 0:
        raise ValueError("bam_segments_stream requires an explicit end")
    if check_crc is None:
        check_crc = not os.environ.get("GOLEFT_TPU_SKIP_CRC")
    buf = _as_u8(comp)
    cap = int(cap_hint) if cap_hint else 65536
    while True:
        seg_s = np.empty(cap, np.int32)
        seg_e = np.empty(cap, np.int32)
        n = ctypes.c_long(0)
        nk = lib.bam_segments_stream(
            _ptr(buf), ctypes.c_long(len(buf)),
            ctypes.c_long(c_begin), ctypes.c_long(in_block),
            ctypes.c_int(target_tid), ctypes.c_int(start),
            ctypes.c_int(end), ctypes.c_int(min_mapq),
            ctypes.c_int(flag_mask),
            ctypes.c_int(1 if check_crc else 0),
            _ptr(seg_s, ctypes.c_int32), _ptr(seg_e, ctypes.c_int32),
            ctypes.c_long(cap), ctypes.byref(n),
        )
        if nk < 0:
            raise ValueError(f"bam_segments_stream: {_stream_err(nk)}")
        if n.value <= cap:
            # copy: a slice view would pin the full cap-sized buffers
            return (seg_s[:n.value].copy(), seg_e[:n.value].copy())
        cap = int(n.value) + 16  # one exact-size retry


def _window_args(end: int, length: int, window: int, what: str) -> int:
    if end < 0:
        raise ValueError(f"{what} requires an explicit end")
    if length % window:
        raise ValueError("length must be a multiple of window")
    return length // window


def bam_window_reduce(body: np.ndarray, offset: int, target_tid: int,
                      start: int, end: int, w0: int, length: int,
                      window: int, depth_cap: int, min_mapq: int,
                      flag_mask: int):
    """Fused decode + per-window depth sums over an uncompressed body
    (csrc/fastio.cpp::bam_window_reduce): clip to [start, end), capped
    cumsum, the [w0, w0 + length) window grid, int64 sums. Returns
    dict(wsums int64 (length // window,), n_kept, consumed, done) or None
    when native is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n_win = _window_args(end, length, window, "bam_window_reduce")
    wsums = np.empty(n_win, dtype=np.int64)
    delta = np.zeros(length + 1, dtype=np.int32)  # the C side wants zeros
    consumed = ctypes.c_long(0)
    done = ctypes.c_int32(0)
    nk = lib.bam_window_reduce(
        _ptr(body), ctypes.c_long(len(body)), ctypes.c_long(offset),
        ctypes.c_int(target_tid), ctypes.c_int(start), ctypes.c_int(end),
        ctypes.c_long(w0), ctypes.c_long(length), ctypes.c_long(window),
        ctypes.c_int(depth_cap), ctypes.c_int(min_mapq),
        ctypes.c_int(flag_mask),
        _ptr(wsums, ctypes.c_int64), _ptr(delta, ctypes.c_int32),
        ctypes.byref(consumed), ctypes.byref(done),
    )
    if nk < 0:
        raise ValueError(f"bam_window_reduce: {_BAM_ERRS.get(int(nk), nk)}")
    return {"wsums": wsums, "n_kept": int(nk),
            "consumed": int(consumed.value), "done": bool(done.value)}


def bam_window_reduce_stream(comp, c_begin: int, in_block: int,
                             target_tid: int, start: int, end: int,
                             w0: int, length: int, window: int,
                             depth_cap: int, min_mapq: int,
                             flag_mask: int,
                             check_crc: bool | None = None):
    """:func:`bam_window_reduce` streamed over the raw BGZF bytes: each
    block inflates into a small recycled ring and its records are walked
    cache-hot. Returns dict(wsums int64, n_kept) or None when native is
    unavailable. ``check_crc`` as in :func:`bam_segments_stream`."""
    lib = get_lib()
    if lib is None:
        return None
    n_win = _window_args(end, length, window, "bam_window_reduce_stream")
    if check_crc is None:
        check_crc = not os.environ.get("GOLEFT_TPU_SKIP_CRC")
    buf = _as_u8(comp)
    wsums = np.empty(n_win, dtype=np.int64)
    delta = np.zeros(length + 1, dtype=np.int32)  # the C side wants zeros
    nk = lib.bam_window_reduce_stream(
        _ptr(buf), ctypes.c_long(len(buf)), ctypes.c_long(c_begin),
        ctypes.c_long(in_block),
        ctypes.c_int(target_tid), ctypes.c_int(start), ctypes.c_int(end),
        ctypes.c_long(w0), ctypes.c_long(length), ctypes.c_long(window),
        ctypes.c_int(depth_cap), ctypes.c_int(min_mapq),
        ctypes.c_int(flag_mask), ctypes.c_int(1 if check_crc else 0),
        _ptr(wsums, ctypes.c_int64), _ptr(delta, ctypes.c_int32),
    )
    if nk < 0:
        raise ValueError(f"bam_window_reduce_stream: {_stream_err(nk)}")
    return {"wsums": wsums, "n_kept": int(nk)}


def bam_window_acc_stream(comp, c_begin: int, in_block: int,
                          target_tid: int, start: int, end: int,
                          w0: int, length: int, window: int,
                          min_mapq: int, flag_mask: int,
                          check_crc: bool | None = None):
    """Lean streaming accumulation: each aligned segment adds its clipped
    overlap to the 1-2 windows it spans, with no per-base pass. The sums
    are UNCAPPED; ``max_overlap`` bounds the pileup depth of every
    window, so a caller enforcing ``depth_cap`` reruns the shard through
    :func:`bam_window_reduce_stream` when ``max_overlap > depth_cap``.
    Returns dict(wsums, n_kept, max_overlap) or None."""
    lib = get_lib()
    if lib is None:
        return None
    n_win = _window_args(end, length, window, "bam_window_acc_stream")
    if check_crc is None:
        check_crc = not os.environ.get("GOLEFT_TPU_SKIP_CRC")
    buf = _as_u8(comp)
    wsums = np.empty(n_win, dtype=np.int64)
    wcount = np.empty(n_win, dtype=np.int32)
    mx = ctypes.c_long(0)
    nk = lib.bam_window_acc_stream(
        _ptr(buf), ctypes.c_long(len(buf)), ctypes.c_long(c_begin),
        ctypes.c_long(in_block),
        ctypes.c_int(target_tid), ctypes.c_int(start), ctypes.c_int(end),
        ctypes.c_long(w0), ctypes.c_long(length), ctypes.c_long(window),
        ctypes.c_int(min_mapq), ctypes.c_int(flag_mask),
        ctypes.c_int(1 if check_crc else 0),
        _ptr(wsums, ctypes.c_int64), _ptr(wcount, ctypes.c_int32),
        ctypes.byref(mx),
    )
    if nk < 0:
        raise ValueError(f"bam_window_acc_stream: {_stream_err(nk)}")
    return {"wsums": wsums, "n_kept": int(nk),
            "max_overlap": int(mx.value)}


def format_float_matrix_rows(chrom: str, starts: np.ndarray,
                             ends: np.ndarray, vals: np.ndarray,
                             valid: np.ndarray,
                             prec: int = 3) -> bytes | None:
    """Float matrix bed rows (%.{prec}g; invalid cells → "0"); None
    without native. vals/valid are (n_cols, n_rows)."""
    lib = get_lib()
    if lib is None:
        return None
    n_cols, n_rows = vals.shape
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    valid = np.ascontiguousarray(valid, dtype=np.uint8)
    cb = chrom.encode()
    cap = n_rows * (len(cb) + 2 * 21 + n_cols * 34 + 4) + 16
    out = np.empty(cap, dtype=np.uint8)
    w = lib.format_float_matrix_rows(
        ctypes.c_char_p(cb), ctypes.c_long(len(cb)),
        _ptr(starts, ctypes.c_int64), _ptr(ends, ctypes.c_int64),
        _ptr(vals, ctypes.c_double), _ptr(valid, ctypes.c_uint8),
        ctypes.c_long(n_rows), ctypes.c_long(n_cols),
        ctypes.c_int(prec), _ptr(out, ctypes.c_char),
        ctypes.c_long(cap),
    )
    if w < 0:
        raise ValueError("format_float_matrix_rows: capacity exceeded")
    return out[:w].tobytes()


def format_xy_json(xs: np.ndarray, ys: np.ndarray, xprec: int = 10,
                   yprec: int = 5) -> bytes | None:
    """'[{"x":..,"y":..},...]' JSON bytes; None without native."""
    lib = get_lib()
    if lib is None:
        return None
    xs = np.ascontiguousarray(xs, dtype=np.float64)
    ys = np.ascontiguousarray(ys, dtype=np.float64)
    if len(xs) != len(ys):
        raise ValueError("format_xy_json: x/y length mismatch")
    n = len(xs)
    cap = n * 80 + 16
    out = np.empty(cap, dtype=np.uint8)
    w = lib.format_xy_json(
        _ptr(xs, ctypes.c_double), _ptr(ys, ctypes.c_double),
        ctypes.c_long(n), ctypes.c_int(xprec), ctypes.c_int(yprec),
        _ptr(out, ctypes.c_char), ctypes.c_long(cap),
    )
    if w < 0:
        raise ValueError("format_xy_json: capacity exceeded")
    return out[:w].tobytes()
