// Host-IO fast path of the port: BGZF block scan/inflate/deflate, BAM
// record decode, the streaming segment walk that feeds the depth kernel
// (and its inflate-only floor), the host-side window reductions of
// cohortdepth's hybrid engine, the .bai structure scan, the depth/callable
// BED row formatters, cohortdepth's integer matrix rows, indexcov's %.3g
// matrix rows and chart-point JSON, and the host CRAM block codecs
// (rANS 4x8, rANS-Nx16, adaptive arithmetic, fqzcomp, tok3 assembly).
//
// A copy of the JAX package's csrc/fastio.cpp trimmed to the entry points
// goleft_tpu_torch/io/native.py binds.
// Build (done lazily by native.py):
//   g++ -O3 -shared -fPIC fastio.cpp -lz -ldeflate -o libgoleftio.so
// or with -DNO_LIBDEFLATE -lz where libdeflate is missing.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <locale.h>
#include <zlib.h>

// libdeflate (when present at build time) inflates BGZF blocks 2-3x
// faster than zlib and computes crc32 with PCLMUL — on a single-core
// host the inflate is the decode pipeline's floor, so this is a direct
// end-to-end multiplier. native.py builds with -ldeflate and falls back
// to a zlib-only build (-DNO_LIBDEFLATE) if the library is missing.
#ifndef NO_LIBDEFLATE
#include <libdeflate.h>
#endif

extern "C" {

// Scan BGZF headers: record each block's compressed offset and the
// cumulative uncompressed offset. Returns the number of blocks, or a
// negative error. total_out gets the total uncompressed size.
long bgzf_scan(const uint8_t* data, long len, long* coffsets,
               long* uoffsets, long max_blocks, long* total_out) {
    long off = 0, n = 0, total = 0;
    while (off + 28 <= len) {
        if (data[off] != 0x1f || data[off + 1] != 0x8b) return -1;
        uint16_t xlen;
        memcpy(&xlen, data + off + 10, 2);
        long xoff = off + 12, xend = xoff + xlen;
        if (xend > len) return -6;  // header truncated
        long bsize = -1;
        while (xoff + 4 <= xend) {
            uint8_t si1 = data[xoff], si2 = data[xoff + 1];
            uint16_t slen;
            memcpy(&slen, data + xoff + 2, 2);
            if (si1 == 0x42 && si2 == 0x43 && slen == 2) {
                uint16_t bs;
                memcpy(&bs, data + xoff + 4, 2);
                bsize = (long)bs + 1;
                break;
            }
            xoff += 4 + slen;
        }
        if (bsize < 0) return -2;
        if (off + bsize > len) return -6;  // truncated final block
        uint32_t isize;
        memcpy(&isize, data + off + bsize - 4, 4);
        if (n >= max_blocks) return -3;
        coffsets[n] = off;
        uoffsets[n] = total;
        total += isize;
        n++;
        off += bsize;
    }
    *total_out = total;
    return n;
}

// Inflate only the blocks whose compressed offset lies in
// [c_begin, c_end) — the region-decode fast path that keeps host
// memory proportional to a shard, not the whole file.
long bgzf_inflate_range(const uint8_t* data, long len, long c_begin,
                        long c_end, uint8_t* out, long out_cap) {
    long off = c_begin, total = 0;
    if (c_end > len) c_end = len;
    z_stream zs;
#ifndef NO_LIBDEFLATE
    struct libdeflate_decompressor* dec = libdeflate_alloc_decompressor();
    if (!dec) return -4;
#define BGZF_FAIL(code) do { libdeflate_free_decompressor(dec); \
                             return (code); } while (0)
#else
#define BGZF_FAIL(code) return (code)
#endif
    while (off < c_end && off + 28 <= len) {
        uint16_t xlen;
        memcpy(&xlen, data + off + 10, 2);
        long xoff = off + 12, xend = xoff + xlen;
        if (xend > len) BGZF_FAIL(-6);  // header truncated
        long bsize = -1;
        while (xoff + 4 <= xend) {
            uint8_t si1 = data[xoff], si2 = data[xoff + 1];
            uint16_t slen;
            memcpy(&slen, data + xoff + 2, 2);
            if (si1 == 0x42 && si2 == 0x43 && slen == 2) {
                uint16_t bs;
                memcpy(&bs, data + xoff + 4, 2);
                bsize = (long)bs + 1;
                break;
            }
            xoff += 4 + slen;
        }
        if (bsize < 0) BGZF_FAIL(-2);
        if (off + bsize > len) BGZF_FAIL(-6);  // truncated final block
        long cdata_off = off + 12 + xlen;
        long cdata_len = bsize - 12 - xlen - 8;
        if (cdata_len < 0) BGZF_FAIL(-8);  // corrupt header geometry
        uint32_t isize;
        memcpy(&isize, data + off + bsize - 4, 4);
        if (total + (long)isize > out_cap) BGZF_FAIL(-3);
        if (isize > 0) {
            uint32_t want_crc;
            memcpy(&want_crc, data + off + bsize - 8, 4);
#ifndef NO_LIBDEFLATE
            size_t actual = 0;
            enum libdeflate_result r = libdeflate_deflate_decompress(
                dec, data + cdata_off, (size_t)cdata_len, out + total,
                (size_t)isize, &actual);
            if (r != LIBDEFLATE_SUCCESS || actual != (size_t)isize)
                BGZF_FAIL(-5);
            uint32_t got = libdeflate_crc32(0, out + total, isize);
#else
            memset(&zs, 0, sizeof(zs));
            if (inflateInit2(&zs, -15) != Z_OK) BGZF_FAIL(-4);
            zs.next_in = const_cast<uint8_t*>(data + cdata_off);
            zs.avail_in = (uInt)cdata_len;
            zs.next_out = out + total;
            zs.avail_out = isize;
            int r = inflate(&zs, Z_FINISH);
            inflateEnd(&zs);
            if (r != Z_STREAM_END) BGZF_FAIL(-5);
            uint32_t got = crc32(0L, out + total, isize);
#endif
            if (got != want_crc) BGZF_FAIL(-7);  // corrupt payload
        }
        total += isize;
        off += bsize;
    }
    (void)zs;
#ifndef NO_LIBDEFLATE
    libdeflate_free_decompressor(dec);
#endif
#undef BGZF_FAIL
    return total;
}

// Compress one BGZF block: write the 18-byte member header, the raw
// deflate payload, and the crc32/isize trailer into out. Returns the
// total member size, or negative: -2 payload over the 65280-byte BGZF
// input cap, -3 out_cap too small, -4 allocator failure, -5 compressor
// error, -6 member would exceed the 65536-byte BGZF limit (cannot
// happen for payloads within the input cap). The libdeflate compressor
// is cached per (thread, level) — allocation is the expensive part of
// small-block compression.
long bgzf_deflate_block(const uint8_t* data, long len, int level,
                        uint8_t* out, long out_cap) {
    if (len < 0 || len > 65280) return -2;  // BGZF cap minus overhead
#ifndef NO_LIBDEFLATE
    static thread_local struct libdeflate_compressor* comp = nullptr;
    static thread_local int comp_level = -1;
    if (comp == nullptr || comp_level != level) {
        if (comp) libdeflate_free_compressor(comp);
        comp = libdeflate_alloc_compressor(level);
        comp_level = level;
        if (!comp) return -4;
    }
    size_t max_out = libdeflate_deflate_compress_bound(comp, (size_t)len);
    if ((long)(18 + max_out + 8) > out_cap) return -3;
    size_t clen = libdeflate_deflate_compress(comp, data, (size_t)len,
                                              out + 18, max_out);
    if (clen == 0) return -5;
    uint32_t crc = libdeflate_crc32(0, data, (size_t)len);
#else
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8,
                     Z_DEFAULT_STRATEGY) != Z_OK)
        return -4;
    zs.next_in = const_cast<uint8_t*>(data);
    zs.avail_in = (uInt)len;
    zs.next_out = out + 18;
    zs.avail_out = (uInt)(out_cap - 26 > 0 ? out_cap - 26 : 0);
    int r = deflate(&zs, Z_FINISH);
    size_t clen = zs.total_out;
    deflateEnd(&zs);
    if (r != Z_STREAM_END) return -3;
    uint32_t crc = crc32(0L, data, (uInt)len);
#endif
    long bsize = 18 + (long)clen + 8;
    if (bsize > out_cap) return -3;
    if (bsize > 65536) return -6;
    // 18-byte BGZF member header with the BC subfield
    out[0] = 0x1F; out[1] = 0x8B; out[2] = 8; out[3] = 4;
    memset(out + 4, 0, 6);
    out[9] = 0xFF;
    out[10] = 6; out[11] = 0;          // XLEN
    out[12] = 0x42; out[13] = 0x43;    // 'B' 'C'
    out[14] = 2; out[15] = 0;
    uint16_t bs16 = (uint16_t)(bsize - 1);
    memcpy(out + 16, &bs16, 2);
    memcpy(out + 18 + clen, &crc, 4);
    uint32_t isize = (uint32_t)len;
    memcpy(out + 18 + clen + 4, &isize, 4);
    return bsize;
}


// CIGAR op properties: MIDNSHP=X
static const int CONSUMES_REF[9] = {1, 0, 1, 1, 0, 0, 0, 1, 1};
static const int CONSUMES_QUERY[9] = {1, 1, 0, 0, 1, 0, 0, 1, 1};
static const int IS_ALIGNED[9] = {1, 0, 0, 0, 0, 0, 0, 1, 1};

// Decode BAM records from an uncompressed body buffer starting at
// `offset`, keeping records on `target_tid` overlapping [start, end)
// (target_tid < 0 keeps everything). Fills columnar outputs; returns
// number of reads decoded, with n_segs_out/consumed_out side outputs.
// Error codes: -1 truncated, -2 capacity exceeded, -9 malformed record
// geometry (BGZF CRC only validates compression, so a corrupt or
// mid-record-truncated BAM body reaches this code; every record-relative
// read below must be bounded by block_size before it happens).
long bam_decode(const uint8_t* body, long body_len, long offset,
                int target_tid, int start, int end, long cap_reads,
                long cap_segs,
                int32_t* tid, int32_t* pos, int32_t* rend,
                uint8_t* mapq, uint16_t* flag, int32_t* tlen,
                int32_t* read_len, int32_t* mate_pos, uint8_t* single_m,
                int32_t* seg_start, int32_t* seg_end, int32_t* seg_read,
                long* n_segs_out, long* consumed_out, int32_t* done_out) {
    long off = offset;
    long nr = 0, ns = 0;
    // done=1: clean stop (past region / sorted-past-tid / exact EOF);
    // done=0: buffer ended mid-record — caller must extend the window.
    *done_out = 1;
    while (off + 4 <= body_len) {
        int32_t block_size;
        memcpy(&block_size, body + off, 4);
        // A record is at least the 32-byte fixed header; a negative
        // block_size would otherwise pass the truncation check below and
        // walk `off` backwards (infinite loop + unbounded retry upstream).
        if (block_size < 32) return -9;
        if (off + 4 + (long)block_size > body_len) {
            *done_out = 0;  // truncated tail
            break;
        }
        const uint8_t* p = body + off + 4;
        int32_t rtid, rpos;
        memcpy(&rtid, p, 4);
        memcpy(&rpos, p + 4, 4);
        uint8_t l_rn = p[8], q = p[9];
        uint16_t n_cig, fl;
        memcpy(&n_cig, p + 12, 2);
        memcpy(&fl, p + 14, 2);
        int32_t l_seq, mtid, mpos, tl;
        memcpy(&l_seq, p + 16, 4);
        memcpy(&mtid, p + 20, 4);
        memcpy(&mpos, p + 24, 4);
        memcpy(&tl, p + 28, 4);
        // Variable-length sections (read name + CIGAR) must fit inside
        // the record's own block, or the CIGAR loop reads past it.
        if (32L + l_rn + 4L * n_cig > (long)block_size) return -9;
        if (target_tid >= 0) {
            if (rtid > target_tid || rtid < 0) break;  // sorted: done
            if (rtid < target_tid) { off += 4 + block_size; continue; }
            if (end >= 0 && rpos >= end) break;
        }
        const uint8_t* cig = p + 32 + l_rn;
        long ref_len = 0, query_len = 0;
        for (int c = 0; c < n_cig; c++) {
            uint32_t v;
            memcpy(&v, cig + 4 * c, 4);
            uint32_t opl = v >> 4, opc = v & 0xF;
            if (opc < 9 && CONSUMES_REF[opc]) ref_len += opl;
            if (opc < 9 && CONSUMES_QUERY[opc]) query_len += opl;
        }
        int32_t re = rpos + (int32_t)ref_len;
        if (target_tid >= 0 && re <= start) { off += 4 + block_size; continue; }
        if (nr >= cap_reads) return -2;
        tid[nr] = rtid; pos[nr] = rpos; rend[nr] = re;
        mapq[nr] = q; flag[nr] = fl; tlen[nr] = tl;
        // read length from l_seq, falling back to the CIGAR query length
        // when SEQ is omitted ('*') — the reference measures the CIGAR
        read_len[nr] = l_seq > 0 ? l_seq : (int32_t)query_len;
        mate_pos[nr] = mpos;
        int32_t cursor = rpos;
        int nseg_rec = 0;
        uint32_t first_op = 9;
        for (int c = 0; c < n_cig; c++) {
            uint32_t v;
            memcpy(&v, cig + 4 * c, 4);
            uint32_t opl = v >> 4, opc = v & 0xF;
            if (c == 0) first_op = opc;
            if (opc < 9 && IS_ALIGNED[opc]) {
                if (ns >= cap_segs) return -2;
                seg_start[ns] = cursor;
                seg_end[ns] = cursor + (int32_t)opl;
                seg_read[ns] = (int32_t)nr;
                ns++; nseg_rec++;
            }
            if (opc < 9 && CONSUMES_REF[opc]) cursor += opl;
        }
        single_m[nr] = (n_cig == 1 && first_op == 0) ? 1 : 0;
        nr++;
        off += 4 + block_size;
    }
    if (off < body_len && off + 4 > body_len) *done_out = 0;
    *n_segs_out = ns;
    *consumed_out = off - offset;
    return nr;
}

}  // extern "C" — the record-walk template below needs C++ linkage

// Record-walk state: the header parse, geometry bounds checks,
// sorted-region stop and mapq/flag filter live in the walk template;
// the per-segment action is the accumulator injected statically.
struct WalkCommon {
    int target_tid, start, end;
    long w0, length;
    int min_mapq, flag_mask;
    long nk;
};

// Walk complete BAM records in buf[*rpos_io, have); accumulate clipped
// M/=/X segments via St::segment. Returns 1 on a clean stop (sorted
// past region/tid), 0 when the buffer ended mid-record (caller supplies
// more bytes), negative error.
template <class St>
static long bam_walk_records(St* st, const uint8_t* buf, long have,
                             long* rpos_io) {
    long off = *rpos_io;
    const int target_tid = st->target_tid;
    const int start = st->start, end = st->end;
    const long w0 = st->w0, length = st->length;
    const int min_mapq = st->min_mapq, flag_mask = st->flag_mask;
    long ret = 0;
    while (off + 4 <= have) {
        int32_t block_size;
        memcpy(&block_size, buf + off, 4);
        if (block_size < 32) { ret = -9; break; }
        if (off + 4 + (long)block_size > have) break;  // need more
        const uint8_t* p = buf + off + 4;
        __builtin_prefetch(p + 4 + block_size);
        int32_t rtid, rpos;
        memcpy(&rtid, p, 4);
        memcpy(&rpos, p + 4, 4);
        uint8_t l_rn = p[8], q = p[9];
        uint16_t n_cig, fl;
        memcpy(&n_cig, p + 12, 2);
        memcpy(&fl, p + 14, 2);
        if (32L + l_rn + 4L * n_cig > (long)block_size) { ret = -9; break; }
        if (target_tid >= 0) {
            if (rtid > target_tid || rtid < 0) { ret = 1; break; }
            if (rtid < target_tid) { off += 4 + block_size; continue; }
            if (end >= 0 && rpos >= end) { ret = 1; break; }
        }
        off += 4 + block_size;
        if (q < min_mapq || (fl & flag_mask) != 0) continue;
        const uint8_t* cig = p + 32 + l_rn;
        long cursor = rpos;
        long touched = 0;
        for (int c = 0; c < n_cig; c++) {
            uint32_t v;
            memcpy(&v, cig + 4 * c, 4);
            uint32_t opl = v >> 4, opc = v & 0xF;
            if (opc < 9 && IS_ALIGNED[opc]) {
                long bs = cursor, be = cursor + opl;
                if (bs < start) bs = start;
                if (be > end && end >= 0) be = end;
                long s = bs - w0, e = be - w0;
                if (s < 0) s = 0;
                if (s > length) s = length;
                if (e < 0) e = 0;
                if (e > length) e = length;
                if (e > s) {
                    st->segment(s, e);
                    touched = 1;
                }
            }
            if (opc < 9 && CONSUMES_REF[opc]) cursor += opl;
        }
        st->nk += touched;
    }
    *rpos_io = off;
    return ret;
}

// Segment collector: append each clipped, filter-passing M/=/X segment
// — the device segment path's host stage. Past cap the walk keeps
// counting (no writes) so the caller can size one retry.
struct BsgState : WalkCommon {
    int32_t* seg_s;
    int32_t* seg_e;
    long cap, n;
    inline void segment(long s, long e) {
        if (n < cap) {
            seg_s[n] = (int32_t)s;
            seg_e[n] = (int32_t)e;
        }
        n++;
    }
};

static long bsg_walk(void* stv, const uint8_t* buf, long have,
                     long* rpos_io) {
    return bam_walk_records((BsgState*)stv, buf, have, rpos_io);
}

// Lemire's fast division: magic = floor(2^64/window)+1 gives exact
// j/window for 0 <= j < 2^32 (window >= 2; magic 0 flags window == 1).
static inline uint64_t win_magic_for(long window) {
    if (window <= 1) return 0;
    return (uint64_t)(((unsigned __int128)1 << 64) / (uint64_t)window) + 1;
}

static inline long win_idx(long j, uint64_t magic) {
    if (!magic) return j;  // window == 1
    return (long)((unsigned __int128)(uint64_t)j * magic >> 64);
}

// Dense accumulator: per-base coverage deltas (delta holds length+1
// zeroed int32); exact under depth_cap via bwr_tail's capped cumsum.
struct BwrState : WalkCommon {
    int32_t* delta;
    inline void segment(long s, long e) {
        delta[s] += 1;
        delta[e] -= 1;
    }
};

// Lean accumulator: each clipped segment adds its overlap directly to
// the 1-2 windows it spans; wcount bounds max pileup depth per window.
struct BwaState : WalkCommon {
    long window;
    uint64_t win_magic;  // see win_magic_for
    int64_t* wsums;
    int32_t* wcount;
    inline void segment(long s, long e) {
        long wl = win_idx(s, win_magic);
        long wh = win_idx(e - 1, win_magic);
        if (wl == wh) {
            wsums[wl] += e - s;
            wcount[wl] += 1;
        } else {
            for (long w = wl; w <= wh; w++) {
                long a = w * window, b = a + window;
                long lo = s > a ? s : a, hi = e < b ? e : b;
                wsums[w] += hi - lo;
                wcount[w] += 1;
            }
        }
    }
};

static long bwr_walk(void* stv, const uint8_t* buf, long have,
                     long* rpos_io) {
    return bam_walk_records((BwrState*)stv, buf, have, rpos_io);
}

static long bwa_walk(void* stv, const uint8_t* buf, long have,
                     long* rpos_io) {
    return bam_walk_records((BwaState*)stv, buf, have, rpos_io);
}

// Capped cumsum + region mask + window sums in one scan, re-zeroing each
// delta entry as it is consumed. Windows fully inside [rs, re) skip the
// per-base mask test and skip 8-wide runs of zero deltas (most of the
// array at typical coverage — depth only changes at read boundaries).
static void bwr_tail(long length, long window, long rs, long re_,
                     int depth_cap, int32_t* delta, int64_t* wsums) {
    long n_win = length / window;
    int64_t run = 0;
    const int64_t cap64 = depth_cap;
    for (long wi = 0; wi < n_win; wi++) {
        int64_t acc = 0;
        long base = wi * window;
        long wend = base + window;
        if (base >= rs && wend <= re_) {
            int64_t capped = run < cap64 ? run : cap64;
            long j = base;
            for (; j + 8 <= wend; j += 8) {
                uint64_t a0, a1, a2, a3;
                memcpy(&a0, delta + j, 8);
                memcpy(&a1, delta + j + 2, 8);
                memcpy(&a2, delta + j + 4, 8);
                memcpy(&a3, delta + j + 6, 8);
                if ((a0 | a1 | a2 | a3) == 0) {
                    acc += capped * 8;  // flat run, already zeroed
                    continue;
                }
                for (long k = j; k < j + 8; k++) {
                    run += delta[k];
                    delta[k] = 0;
                    acc += run < cap64 ? run : cap64;
                }
                capped = run < cap64 ? run : cap64;
            }
            for (; j < wend; j++) {
                run += delta[j];
                delta[j] = 0;
                acc += run < cap64 ? run : cap64;
            }
        } else {
            for (long j = base; j < wend; j++) {
                run += delta[j];
                delta[j] = 0;
                if (j >= rs && j < re_)
                    acc += run < cap64 ? run : cap64;
            }
        }
        wsums[wi] = acc;
    }
    delta[length] = 0;  // clipped endpoints land here
}

extern "C" {

// Fused decode + window reduction over an UNCOMPRESSED body buffer: walk
// BAM records and accumulate per-window depth sums directly, in int64 —
// the cohortdepth hybrid engine's exact sums. Returns kept-record count,
// or a negative bam_decode error code.
long bam_window_reduce(const uint8_t* body, long body_len, long offset,
                       int target_tid, int start, int end,
                       long w0, long length, long window,
                       int depth_cap, int min_mapq, int flag_mask,
                       int64_t* wsums, int32_t* delta_scratch,
                       long* consumed_out, int32_t* done_out) {
    BwrState st = {{target_tid, start, end, w0, length, min_mapq,
                    flag_mask, 0}, delta_scratch};
    long off = offset;
    long status = bwr_walk(&st, body, body_len, &off);
    if (status < 0) {
        memset(delta_scratch, 0, (length + 1) * sizeof(int32_t));
        return status;
    }
    // done=1: clean stop or exact EOF; done=0: ended mid-record — the
    // caller must extend the inflate window.
    *done_out = (status == 1 || off == body_len) ? 1 : 0;
    *consumed_out = off - offset;
    bwr_tail(length, window, (long)start - w0, (long)end - w0,
             depth_cap, delta_scratch, wsums);
    return st.nk;
}

// Generic streaming loop: inflate BGZF blocks from compressed offset
// c_begin into a small recycled ring buffer and invoke `walk` on the
// growing record window while the bytes are cache-hot — the shard's
// uncompressed body (tens of MB) never materializes, so record walks
// read from L2 instead of DRAM and host RSS stays O(1MB) per call.
// rpos starts at in_block (an uncompressed skip into the first block:
// a BAI virtual offset's low 16 bits, or the header length for
// c_begin=0 — the skip may span whole blocks). check_crc=0 skips BGZF
// payload CRC verification (trusted local files; the record walk still
// bounds-checks all geometry). Returns 1 (clean stop) or 0 (clean EOF),
// or a negative bgzf/BAM error (-1 when the stream ends mid-record).
typedef long (*bam_walk_fn)(void* st, const uint8_t* buf, long have,
                            long* rpos_io);

static long bgzf_stream_walk(const uint8_t* comp, long comp_len,
                             long c_begin, long in_block, int check_crc,
                             bam_walk_fn walk, void* st) {
    long cap = 1L << 20;
    uint8_t* buf = (uint8_t*)malloc(cap);
    if (!buf) return -4;
#ifndef NO_LIBDEFLATE
    struct libdeflate_decompressor* dec = libdeflate_alloc_decompressor();
    if (!dec) { free(buf); return -4; }
#define BSW_FAIL(code) do { \
        libdeflate_free_decompressor(dec); free(buf); \
        return (code); } while (0)
#else
#define BSW_FAIL(code) do { free(buf); return (code); } while (0)
#endif
    long have = 0, rpos = in_block, off = c_begin;
    long status = 0;
    while (off + 28 <= comp_len) {
        if (comp[off] != 0x1f || comp[off + 1] != 0x8b) BSW_FAIL(-10);
        uint16_t xlen;
        memcpy(&xlen, comp + off + 10, 2);
        long xoff = off + 12, xend = xoff + xlen;
        if (xend > comp_len) BSW_FAIL(-6);
        long bsize = -1;
        while (xoff + 4 <= xend) {
            uint8_t si1 = comp[xoff], si2 = comp[xoff + 1];
            uint16_t slen;
            memcpy(&slen, comp + xoff + 2, 2);
            if (si1 == 0x42 && si2 == 0x43 && slen == 2) {
                uint16_t bs;
                memcpy(&bs, comp + xoff + 4, 2);
                bsize = (long)bs + 1;
                break;
            }
            xoff += 4 + slen;
        }
        if (bsize < 0) BSW_FAIL(-2);
        if (off + bsize > comp_len) BSW_FAIL(-6);
        long cdata_off = off + 12 + xlen;
        long cdata_len = bsize - 12 - xlen - 8;
        if (cdata_len < 0) BSW_FAIL(-8);
        uint32_t isize;
        memcpy(&isize, comp + off + bsize - 4, 4);
        if (isize > 0) {
            if (rpos >= have) {
                // nothing unconsumed buffered (also covers a header or
                // in-block skip spanning past everything inflated so far)
                rpos -= have;
                have = 0;
            }
            if (have + (long)isize > cap) {
                memmove(buf, buf + rpos, have - rpos);
                have -= rpos;
                rpos = 0;
                while (have + (long)isize > cap) {
                    cap *= 2;
                    uint8_t* nb = (uint8_t*)realloc(buf, cap);
                    if (!nb) BSW_FAIL(-4);
                    buf = nb;
                }
            }
#ifndef NO_LIBDEFLATE
            size_t actual = 0;
            enum libdeflate_result r = libdeflate_deflate_decompress(
                dec, comp + cdata_off, (size_t)cdata_len, buf + have,
                (size_t)isize, &actual);
            if (r != LIBDEFLATE_SUCCESS || actual != (size_t)isize)
                BSW_FAIL(-5);
            if (check_crc) {
                uint32_t want_crc;
                memcpy(&want_crc, comp + off + bsize - 8, 4);
                if (libdeflate_crc32(0, buf + have, isize) != want_crc)
                    BSW_FAIL(-7);
            }
#else
            z_stream zs;
            memset(&zs, 0, sizeof(zs));
            if (inflateInit2(&zs, -15) != Z_OK) BSW_FAIL(-4);
            zs.next_in = const_cast<uint8_t*>(comp + cdata_off);
            zs.avail_in = (uInt)cdata_len;
            zs.next_out = buf + have;
            zs.avail_out = isize;
            int r = inflate(&zs, Z_FINISH);
            inflateEnd(&zs);
            if (r != Z_STREAM_END) BSW_FAIL(-5);
            if (check_crc) {
                uint32_t want_crc;
                memcpy(&want_crc, comp + off + bsize - 8, 4);
                if (crc32(0L, buf + have, isize) != want_crc)
                    BSW_FAIL(-7);
            }
#endif
            have += isize;
            status = walk(st, buf, have, &rpos);
            if (status != 0) break;
        }
        off += bsize;
    }
    if (status < 0) BSW_FAIL(status);
    if (status == 0 && rpos < have) BSW_FAIL(-1);  // truncated record
#ifndef NO_LIBDEFLATE
    libdeflate_free_decompressor(dec);
#endif
    free(buf);
#undef BSW_FAIL
    return status;
}

// Streaming fused inflate + decode + window reduction over the RAW BGZF
// file (exact capped semantics — see bam_window_reduce). Stops at the
// region's clean stop or EOF. Returns kept-record count or a negative
// error.
long bam_window_reduce_stream(const uint8_t* comp, long comp_len,
                              long c_begin, long in_block,
                              int target_tid, int start, int end,
                              long w0, long length, long window,
                              int depth_cap, int min_mapq, int flag_mask,
                              int check_crc,
                              int64_t* wsums, int32_t* delta_scratch) {
    BwrState st = {{target_tid, start, end, w0, length, min_mapq,
                    flag_mask, 0}, delta_scratch};
    long status = bgzf_stream_walk(comp, comp_len, c_begin, in_block,
                                   check_crc, bwr_walk, &st);
    if (status < 0) {
        memset(delta_scratch, 0, (length + 1) * sizeof(int32_t));
        return status;
    }
    bwr_tail(length, window, (long)start - w0, (long)end - w0,
             depth_cap, delta_scratch, wsums);
    return st.nk;
}

// Streaming fused inflate + lean window accumulation (see BwaState):
// no dense per-base pass. wsums/wcount are (length/window) int64/int32,
// zeroed HERE. wcount[w] counts segments touching window w, an upper
// bound on its pileup depth; max_overlap_out reports max(wcount). When
// it exceeds depth_cap the uncapped sums may be inexact and the caller
// must rerun the shard via bam_window_reduce_stream. Other semantics and
// error codes match bam_window_reduce_stream.
long bam_window_acc_stream(const uint8_t* comp, long comp_len,
                           long c_begin, long in_block,
                           int target_tid, int start, int end,
                           long w0, long length, long window,
                           int min_mapq, int flag_mask, int check_crc,
                           int64_t* wsums, int32_t* wcount,
                           long* max_overlap_out) {
    long n_win = length / window;
    memset(wsums, 0, n_win * sizeof(int64_t));
    memset(wcount, 0, n_win * sizeof(int32_t));
    BwaState st = {{target_tid, start, end, w0, length, min_mapq,
                    flag_mask, 0},
                   window, win_magic_for(window), wsums, wcount};
    long status = bgzf_stream_walk(comp, comp_len, c_begin, in_block,
                                   check_crc, bwa_walk, &st);
    if (status < 0) return status;
    long mx = 0;
    for (long w = 0; w < n_win; w++)
        if (wcount[w] > mx) mx = wcount[w];
    *max_overlap_out = mx;
    return st.nk;
}

// Streaming segment extraction for the device segment path: walk the
// region once and emit absolute [s, e) endpoints of every clipped,
// mapq/flag-passing aligned segment (w0 = 0, clip ceiling = end).
// Returns kept-read count; *n_out = segments emitted (when > cap the
// buffers were too small and the caller re-calls with cap >= *n_out —
// nothing was written past cap). Explicit end required.
long bam_segments_stream(const uint8_t* comp, long comp_len,
                         long c_begin, long in_block,
                         int target_tid, int start, int end,
                         int min_mapq, int flag_mask, int check_crc,
                         int32_t* seg_s, int32_t* seg_e, long cap,
                         long* n_out) {
    if (end < 0) return -8;
    BsgState st = {{target_tid, start, end, /*w0=*/0, /*length=*/end,
                    min_mapq, flag_mask, 0},
                   seg_s, seg_e, cap, 0};
    long status = bgzf_stream_walk(comp, comp_len, c_begin, in_block,
                                   check_crc, bsg_walk, &st);
    if (status < 0) return status;
    *n_out = st.n;
    return st.nk;
}

// Scan a .bai: per reference, the bin-section byte range, linear-index
// range, and stats-bin (0x924A) counts — without materializing per-bin
// chunk lists (Python parses one reference's bins lazily if a region
// query ever needs them; indexcov needs only intervals + stats, and the
// pure-Python bin walk was ~0.7s per whole-genome index). Returns n_ref
// or negative: -1 bad magic, -2 truncated, -3 over max_ref.
long bai_scan(const uint8_t* data, long len, long max_ref,
              int64_t* bins_start, int64_t* bins_end,
              int64_t* n_intv_out, int64_t* intv_off,
              int64_t* mapped, int64_t* unmapped) {
    if (len < 8 || memcmp(data, "BAI\x01", 4) != 0) return -1;
    long off = 4;
    int32_t n_ref;
    memcpy(&n_ref, data + off, 4);
    off += 4;
    if (n_ref < 0 || n_ref > max_ref) return -3;
    for (long r = 0; r < n_ref; r++) {
        if (off + 4 > len) return -2;
        int32_t n_bin;
        memcpy(&n_bin, data + off, 4);
        off += 4;
        if (n_bin < 0) return -2;
        bins_start[r] = off;
        mapped[r] = -1;
        unmapped[r] = -1;
        for (long b = 0; b < n_bin; b++) {
            if (off + 8 > len) return -2;
            uint32_t bno;
            int32_t n_chunk;
            memcpy(&bno, data + off, 4);
            memcpy(&n_chunk, data + off + 4, 4);
            off += 8;
            if (n_chunk < 0 || off + 16L * n_chunk > len) return -2;
            if (bno == 0x924A && n_chunk == 2) {
                uint64_t m, u;
                memcpy(&m, data + off + 16, 8);
                memcpy(&u, data + off + 24, 8);
                mapped[r] = (int64_t)m;
                unmapped[r] = (int64_t)u;
            }
            off += 16L * n_chunk;
        }
        bins_end[r] = off;
        if (off + 4 > len) return -2;
        int32_t n_intv;
        memcpy(&n_intv, data + off, 4);
        off += 4;
        if (n_intv < 0 || off + 8L * n_intv > len) return -2;
        n_intv_out[r] = n_intv;
        intv_off[r] = off;
        off += 8L * n_intv;
    }
    return n_ref;
}

static long fmt_g(double v, char* p, int prec);

// Fast non-negative int64 → decimal; returns chars written.
static inline long itoa_u(int64_t v, char* p) {
    char tmp[24];
    int n = 0;
    if (v <= 0) { p[0] = '0'; return 1; }
    while (v > 0) { tmp[n++] = (char)('0' + v % 10); v /= 10; }
    for (int i = 0; i < n; i++) p[i] = tmp[n - 1 - i];
    return n;
}

// Format depth bed rows "chrom\tstart\tend\t%.4g\n" (matches Python's
// f"{m:.4g}": printf %g semantics, pinned to the C numeric locale so a
// host application's setlocale() can't change the decimal separator).
// Returns bytes or -1.
long format_depth_rows(const char* chrom, long chrom_len,
                       const int64_t* starts, const int64_t* ends,
                       const double* means, long n, char* out,
                       long out_cap) {
    // magic static: thread-safe one-time init (callers run GIL-free)
    static locale_t c_loc = newlocale(LC_NUMERIC_MASK, "C", (locale_t)0);
    locale_t old = c_loc != (locale_t)0 ? uselocale(c_loc) : (locale_t)0;
    long w = 0;
    for (long r = 0; r < n; r++) {
        if (w + chrom_len + 2 * 21 + 40 > out_cap) {
            w = -1;
            break;
        }
        memcpy(out + w, chrom, chrom_len);
        w += chrom_len;
        out[w++] = '\t';
        w += itoa_u(starts[r], out + w);
        out[w++] = '\t';
        w += itoa_u(ends[r], out + w);
        out[w++] = '\t';
        w += snprintf(out + w, 40, "%.4g", means[r]);
        out[w++] = '\n';
    }
    if (old != (locale_t)0)
        uselocale(old);
    return w;
}

// Format callable-class rows "chrom\tstart\tend\tNAME\n" for class ids
// 0..3 (NO/LOW/CALLABLE/EXCESSIVE — ops/coverage.py CLASS_NAMES order).
static const char* CLASS_NAMES_C[4] = {
    "NO_COVERAGE", "LOW_COVERAGE", "CALLABLE", "EXCESSIVE_COVERAGE",
};

long format_class_rows(const char* chrom, long chrom_len,
                       const int64_t* starts, const int64_t* ends,
                       const uint8_t* cls, long n, char* out,
                       long out_cap) {
    for (long r = 0; r < n; r++)
        if (cls[r] > 3) return -2;
    long w = 0;
    for (long r = 0; r < n; r++) {
        const char* nm = CLASS_NAMES_C[cls[r]];
        long nl = (long)strlen(nm);
        if (w + chrom_len + 2 * 21 + nl + 4 > out_cap) return -1;
        memcpy(out + w, chrom, chrom_len);
        w += chrom_len;
        out[w++] = '\t';
        w += itoa_u(starts[r], out + w);
        out[w++] = '\t';
        w += itoa_u(ends[r], out + w);
        out[w++] = '\t';
        memcpy(out + w, nm, nl);
        w += nl;
        out[w++] = '\n';
    }
    return w;
}

// Float matrix rows "chrom\tstart\tend\t%.{prec}g...\n" with a validity
// mask (invalid cells print "0" — shorter samples' missing tail bins,
// indexcov.go:678-680). vals/valid are (n_cols, n_rows) col-major like
// format_matrix_rows. Byte-identical to numpy's np.char.mod("%.3g").
long format_float_matrix_rows(const char* chrom, long chrom_len,
                              const int64_t* starts, const int64_t* ends,
                              const double* vals, const uint8_t* valid,
                              long n_rows, long n_cols, int prec,
                              char* out, long out_cap) {
    if (prec > 17) prec = 17;  // "%.17g" worst case fits the 33B budget
    static locale_t c_loc3 = newlocale(LC_NUMERIC_MASK, "C", (locale_t)0);
    locale_t old = c_loc3 != (locale_t)0 ? uselocale(c_loc3)
                                         : (locale_t)0;
    long w = 0;
    for (long r = 0; r < n_rows; r++) {
        if (w + chrom_len + 2 * 21 + n_cols * 34 + 2 > out_cap) {
            w = -1;
            break;
        }
        memcpy(out + w, chrom, chrom_len);
        w += chrom_len;
        out[w++] = '\t';
        w += itoa_u(starts[r], out + w);
        out[w++] = '\t';
        w += itoa_u(ends[r], out + w);
        for (long c = 0; c < n_cols; c++) {
            out[w++] = '\t';
            if (valid[c * n_rows + r]) {
                double v = vals[c * n_rows + r];
                long fw = fmt_g(v, out + w, prec);
                if (fw >= 0)
                    w += fw;
                else
                    w += snprintf(out + w, 33, "%.*g", prec, v);
            } else {
                out[w++] = '0';
            }
        }
        out[w++] = '\n';
    }
    if (old != (locale_t)0)
        uselocale(old);
    return w;
}

// %.{prec}g-compatible fast formatter for the fixed-notation regime
// (1e-4 <= v < 10^prec): round to prec significant decimal digits,
// place the point, strip trailing fraction zeros. Returns chars
// written, or -1 to defer to snprintf (out of regime, or the scaled
// value sits within 1e-7 of a .5 rounding tie where double arithmetic
// can't decide the way printf's exact-decimal rounding would).
static long fmt_g(double v, char* p, int prec) {
    static const double P10[22] = {
        1e0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9, 1e10, 1e11,
        1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21,
    };
    if (prec < 1 || prec > 15) return -1;
    if (v != v) return -1;  // NaN: snprintf prints "nan"
    long w = 0;
    if (v < 0) {
        p[w++] = '-';
        v = -v;
    }
    if (v == 0.0) {
        if (std::signbit(v)) p[w++] = '-';  // %g prints "-0" for -0.0
        p[w++] = '0';
        return w;
    }
    if (v < 1e-4 || v >= P10[prec]) return -1;  // exponential regime
    int e = 0;  // v = d.ddd... * 10^e
    double t = v;
    while (t >= 10.0) { t /= 10.0; e++; }
    while (t < 1.0) { t *= 10.0; e--; }
    // e in [-4, prec-1] -> index in [0, prec+3]
    double scaled = v * P10[prec - 1 - e];
    double fr = scaled - (double)(long)scaled;
    double d = fr - 0.5;
    if (d < 1e-7 && d > -1e-7) return -1;  // ambiguous rounding tie
    long ndig = (long)(scaled + 0.5);
    long full = (long)P10[prec];
    if (ndig >= full) {  // e.g. 999.6 at prec 3 -> 1.00e(e+1)
        ndig = full / 10;
        e++;
        if (e >= prec) return -1;
    }
    char digs[16];
    for (int k = prec - 1; k >= 0; k--) {
        digs[k] = (char)('0' + ndig % 10);
        ndig /= 10;
    }
    int last = prec - 1;  // strip trailing zeros of the fraction only
    while (last > e && last > 0 && digs[last] == '0') last--;
    if (e >= 0) {
        for (int k = 0; k <= e; k++) p[w++] = digs[k];
        if (last > e) {
            p[w++] = '.';
            for (int k = e + 1; k <= last; k++) p[w++] = digs[k];
        }
    } else {
        p[w++] = '0';
        p[w++] = '.';
        for (int k = 0; k < -e - 1; k++) p[w++] = '0';
        for (int k = 0; k <= last; k++) p[w++] = digs[k];
    }
    return w;
}

// Serialize chart point pairs as JSON: [{"x":..,"y":..},...] with %.*g
// values (C locale). Non-finite values emit null (valid JSON; chart.js
// skips them). This is the report writer's hot loop (tens of millions
// of points at whole-genome sizes), so the common cases skip snprintf:
// integral x up to 10 digits with xprec>=10 go through itoa (identical
// bytes), and fixed-regime y values through the generalized fmt_g.
// Returns bytes written or -1 on capacity.
long format_xy_json(const double* xs, const double* ys, long n,
                    int xprec, int yprec, char* out, long out_cap) {
    if (xprec > 17) xprec = 17;  // "%.17g" fits the 32B point budget
    if (yprec > 17) yprec = 17;
    static locale_t c_loc2 = newlocale(LC_NUMERIC_MASK, "C", (locale_t)0);
    locale_t old = c_loc2 != (locale_t)0 ? uselocale(c_loc2)
                                         : (locale_t)0;
    long w = 0;
    out[w++] = '[';
    for (long i = 0; i < n; i++) {
        if (w + 2 * 32 + 16 > out_cap) {
            w = -1;
            break;
        }
        if (i) out[w++] = ',';
        memcpy(out + w, "{\"x\":", 5);
        w += 5;
        double x = xs[i], y = ys[i];
        if (x == x && x - x == 0.0) {
            long xi = (long)x;
            if (xprec >= 10 && (double)xi == x && x < 1e10 && x >= 0)
                w += itoa_u(xi, out + w);
            else
                w += snprintf(out + w, 32, "%.*g", xprec, x);
        } else {
            memcpy(out + w, "null", 4);
            w += 4;
        }
        memcpy(out + w, ",\"y\":", 5);
        w += 5;
        if (y == y && y - y == 0.0) {
            long fw = fmt_g(y, out + w, yprec);
            if (fw >= 0)
                w += fw;
            else
                w += snprintf(out + w, 32, "%.*g", yprec, y);
        } else {
            memcpy(out + w, "null", 4);
            w += 4;
        }
        out[w++] = '}';
    }
    if (w >= 0) out[w++] = ']';
    if (old != (locale_t)0)
        uselocale(old);
    return w;
}

}  // extern "C"

// ------------------------------------------------------------------
// Decode floor and cohortdepth's matrix writer.

extern "C" {


// Inflate-only variant of the streaming walk (the walk consumes every
// byte and reduces nothing): isolates the BGZF inflate(+CRC) floor of
// the decode stage so bench.py can record what fraction of
// decode_window_reduce is libdeflate running at hardware rates vs the
// record walk. Returns total uncompressed bytes or a negative bgzf
// error.
static long inflate_only_walk(void* st, const uint8_t*, long have,
                              long* rpos_io) {
    *(int64_t*)st += have - *rpos_io;
    *rpos_io = have;  // consume everything; keep streaming
    return 0;
}

long bgzf_stream_inflate_only(const uint8_t* comp, long comp_len,
                              long c_begin, long in_block,
                              int check_crc, int64_t* total_out) {
    // reuses the product driver minus the record walk. One deliberate
    // divergence: the consume-all walk keeps the ring at offset 0, so
    // the compaction/growth branches a real walk can trigger never run
    // — the recorded floor is a (slightly best-case-locality) LOWER
    // bound on the production inflate cost, which is the right
    // direction for a floor measurement
    int64_t total = 0;
    long status = bgzf_stream_walk(comp, comp_len, c_begin, in_block,
                                   check_crc, inflate_only_walk, &total);
    if (status < 0) return status;
    *total_out = total;
    return 0;
}


// Format "chrom\tstart\tend\tv0\t...\tvN\n" matrix rows into out.
// vals is column-major from the producer: (n_cols, n_rows), i.e.
// vals[c * n_rows + r] — exactly cohortdepth's (samples, windows)
// layout, so no transpose copy is needed. Values are non-negative.
// Returns bytes written, or -1 when out_cap would overflow.
long format_matrix_rows(const char* chrom, long chrom_len,
                        const int64_t* starts, const int64_t* ends,
                        const int64_t* vals, long n_rows, long n_cols,
                        char* out, long out_cap) {
    long w = 0;
    for (long r = 0; r < n_rows; r++) {
        // worst case for this row: chrom + 2 positions + n_cols values,
        // each value ≤ 20 digits + one separator
        if (w + chrom_len + 2 * 21 + n_cols * 21 + 2 > out_cap) return -1;
        memcpy(out + w, chrom, chrom_len);
        w += chrom_len;
        out[w++] = '\t';
        w += itoa_u(starts[r], out + w);
        out[w++] = '\t';
        w += itoa_u(ends[r], out + w);
        for (long c = 0; c < n_cols; c++) {
            out[w++] = '\t';
            w += itoa_u(vals[c * n_rows + r], out + w);
        }
        out[w++] = '\n';
    }
    return w;
}

}  // extern "C"

// ------------------------------------------------------------------
extern "C" {


// ---- rANS 4x8 decode (CRAM 3.0 block method 4) ---------------------
//
// C port of io/cram.py::_rans_decode_0/_rans_decode_1 (the pure-Python
// loops were ~55% of CRAM decode wall). Layout: u7 frequencies (1 byte
// <128, else 0x80|hi,lo), symbol/context lists with adjacent-run RLE,
// 12-bit frequencies, 4 interleaved states with 8-bit renormalization
// below 1<<23. Order-0 interleaves round-robin (i&3); order-1 splits
// the output into quarters with per-stream context carry. Returns 0,
// or negative: -1 malformed/truncated stream, -9 missing o1 context.

// order-1 context tables shared by the 4x8 and Nx16 ports (they never
// run concurrently on one thread): 1.4MB per thread, lazily
// allocated, freed on thread exit — per-call pools destroy worker
// threads, so a bare thread_local pointer would leak per thread
struct RansCtx {
    uint16_t freq[256];
    uint32_t cum[257];
    uint8_t lut[4096];
};
struct RansCtxPool {
    RansCtx* p = nullptr;
    ~RansCtxPool() { free(p); }
    RansCtx* get() {
        if (!p) p = (RansCtx*)malloc(256 * sizeof(RansCtx));
        return p;
    }
};
static thread_local RansCtxPool g_rans_ctxs;

static inline long rans_u7(const uint8_t* buf, long len, long* pos,
                           uint32_t* v) {
    if (*pos >= len) return -1;
    uint8_t b0 = buf[(*pos)++];
    if (b0 < 0x80) { *v = b0; return 0; }
    if (*pos >= len) return -1;
    *v = ((uint32_t)(b0 & 0x7F) << 8) | buf[(*pos)++];
    return 0;
}

// Parse one order-0 frequency table into freq[256]/cum[257]/lut[4096].
static long rans_freqs0(const uint8_t* buf, long len, long* pos,
                        uint16_t* freq, uint32_t* cum, uint8_t* lut) {
    memset(freq, 0, 256 * sizeof(uint16_t));
    if (*pos >= len) return -1;
    int sym = buf[(*pos)++];
    int last_sym = sym;
    int rle = 0;
    while (1) {
        uint32_t f;
        if (rans_u7(buf, len, pos, &f) < 0) return -1;
        freq[sym] = (uint16_t)f;
        if (rle > 0) {
            rle--;
            sym++;
            if (sym > 255) return -1;
        } else {
            if (*pos >= len) return -1;
            sym = buf[(*pos)++];
            if (sym == last_sym + 1) {
                if (*pos >= len) return -1;
                rle = buf[(*pos)++];
            }
            last_sym = sym;
        }
        if (sym == 0 && rle == 0) break;
    }
    uint32_t c = 0;
    for (int s = 0; s < 256; s++) {
        cum[s] = c;
        c += freq[s];
    }
    cum[256] = c;
    if (c > 4096) return -1;
    for (int s = 0; s < 256; s++)
        if (freq[s])
            memset(lut + cum[s], s, freq[s]);
    return 0;
}

long rans4x8_decode(const uint8_t* buf, long len, long pos, int order,
                    uint8_t* out, long out_len) {
    if (out_len == 0) return 0;
    if (order == 0) {
        uint16_t freq[256];
        uint32_t cum[257];
        static thread_local uint8_t lut[4096];
        memset(lut, 0, sizeof(lut));
        if (rans_freqs0(buf, len, &pos, freq, cum, lut) < 0) return -1;
        if (pos + 16 > len) return -1;
        uint32_t R[4];
        memcpy(R, buf + pos, 16);
        pos += 16;
        for (long i = 0; i < out_len; i++) {
            int j = i & 3;
            uint32_t x = R[j];
            uint32_t m = x & 4095;
            uint8_t s = lut[m];
            out[i] = s;
            x = (uint32_t)freq[s] * (x >> 12) + m - cum[s];
            while (x < (1u << 23) && pos < len)
                x = (x << 8) | buf[pos++];
            R[j] = x;
        }
        return 0;
    }
    if (order != 1) return -1;
    // order-1: lazily allocated per-context tables (shared pool)
    static thread_local uint8_t present[256];
    RansCtx* const ctxs = g_rans_ctxs.get();
    if (!ctxs) return -4;
    memset(present, 0, 256);
    if (pos >= len) return -1;
    int ctx = buf[pos++];
    int last_ctx = ctx;
    int rle = 0;
    while (1) {
        if (ctx < 0 || ctx > 255) return -1;
        memset(ctxs[ctx].lut, 0, 4096);
        if (rans_freqs0(buf, len, &pos, ctxs[ctx].freq, ctxs[ctx].cum,
                        ctxs[ctx].lut) < 0)
            return -1;
        present[ctx] = 1;
        if (rle > 0) {
            rle--;
            ctx++;
        } else {
            if (pos >= len) return -1;
            ctx = buf[pos++];
            if (ctx == last_ctx + 1) {
                if (pos >= len) return -1;
                rle = buf[pos++];
            }
            last_ctx = ctx;
        }
        if (ctx == 0 && rle == 0) break;
    }
    if (pos + 16 > len) return -1;
    uint32_t R[4];
    memcpy(R, buf + pos, 16);
    pos += 16;
    long F = out_len >> 2;
    long idx[4] = {0, F, 2 * F, 3 * F};
    long ends[4] = {F, 2 * F, 3 * F, out_len};
    uint8_t last[4] = {0, 0, 0, 0};
    while (1) {
        int done = 1;
        for (int j = 0; j < 4; j++) {
            if (idx[j] >= ends[j]) continue;
            done = 0;
            uint32_t x = R[j];
            uint8_t c = last[j];
            if (!present[c]) return -9;
            uint32_t m = x & 4095;
            uint8_t s = ctxs[c].lut[m];
            out[idx[j]] = s;
            x = (uint32_t)ctxs[c].freq[s] * (x >> 12) + m - ctxs[c].cum[s];
            while (x < (1u << 23) && pos < len)
                x = (x << 8) | buf[pos++];
            R[j] = x;
            last[j] = s;
            idx[j]++;
        }
        if (done) break;
    }
    return 0;
}

}  // extern "C"

// ------------------------------------------------------------------
// C port of io/rans_nx16.py::_decode_rans0/_decode_rans1 (CRAM 3.1
// block method 5 — the pure-Python loops dominate foreign-3.1 CRAM
// decode wall). Layout per io/rans_nx16.py: uint7 varints, ascending
// symbol alphabet with adjacent-run RLE, frequencies normalized to
// 4096 (o0) / 1<<shift (o1), N interleaved states (4 or 32) with one
// 16-bit renormalization step below 1<<15; order-0 decodes
// round-robin, order-1 fills N contiguous slices (last state carries
// the tail) with per-slice context carry. The C path is an
// accelerator only: any nonzero return makes the caller fall back to
// the pure-Python decoder, which owns the lenient cases (tables
// needing renormalization, shift > 12, non-minimal varints past 5
// bytes) and every error message.

static inline long nx16_u7(const uint8_t* buf, long len, long* pos,
                           uint32_t* v) {
    uint64_t acc = 0;  // 5 groups carry 35 bits: must not wrap u32
    for (int k = 0; k < 5; k++) {
        if (*pos >= len) return -1;
        uint8_t b = buf[(*pos)++];
        acc = (acc << 7) | (b & 0x7F);
        if (!(b & 0x80)) {
            if (acc > 0xFFFFFFFFull) return -2;
            *v = (uint32_t)acc;
            return 0;
        }
    }
    return -2;  // longer non-minimal form: let Python handle it
}

static long nx16_alphabet(const uint8_t* buf, long len, long* pos,
                          uint8_t* syms, int* n_syms) {
    int n = 0, rle = 0, last = -2;
    if (*pos >= len) return -1;
    int sym = buf[(*pos)++];
    while (1) {
        if (n >= 256 || sym > 255) return -1;
        syms[n++] = (uint8_t)sym;
        if (rle > 0) {
            rle--;
            sym++;
        } else {
            last = sym;
            if (*pos >= len) return -1;
            sym = buf[(*pos)++];
            if (sym == last + 1) {
                if (*pos >= len) return -1;
                rle = buf[(*pos)++];
            }
        }
        if (rle == 0 && sym == 0) break;
    }
    *n_syms = n;
    return 0;
}

extern "C" {

long ransnx16_decode0(const uint8_t* buf, long len, long pos,
                      uint8_t* out, long out_len, int n_states) {
    if (out_len == 0) return 0;
    if (n_states != 4 && n_states != 32) return -1;
    uint8_t syms[256];
    int n;
    if (nx16_alphabet(buf, len, &pos, syms, &n) < 0) return -1;
    uint16_t freq[256];
    uint32_t cum[257];
    static thread_local uint8_t lut[4096];
    memset(freq, 0, sizeof(freq));
    memset(lut, 0, sizeof(lut));
    for (int i = 0; i < n; i++) {
        uint32_t f;
        long r = nx16_u7(buf, len, &pos, &f);
        if (r < 0) return r;
        if (f > 4096) return -2;
        freq[syms[i]] = (uint16_t)f;
    }
    uint32_t c = 0;
    for (int s = 0; s < 256; s++) {
        cum[s] = c;
        c += freq[s];
    }
    cum[256] = c;
    // validate the FINAL array sum (duplicate alphabet symbols
    // overwrite entries; Python normalizes from the final array, so
    // anything but an exact 4096 goes to the lenient Python path)
    if (c != 4096) return -2;
    for (int s = 0; s < 256; s++)
        if (freq[s]) memset(lut + cum[s], s, freq[s]);
    if (pos + 4L * n_states > len) return -1;
    uint32_t R[32];
    memcpy(R, buf + pos, 4L * n_states);
    pos += 4L * n_states;
    for (long i = 0; i < out_len; i++) {
        int j = (int)(i % n_states);
        uint32_t x = R[j];
        uint32_t m = x & 4095;
        uint8_t s = lut[m];
        out[i] = s;
        x = (uint32_t)freq[s] * (x >> 12) + m - cum[s];
        if (x < (1u << 15) && pos + 1 < len) {
            x = (x << 16) | buf[pos] | ((uint32_t)buf[pos + 1] << 8);
            pos += 2;
        }
        R[j] = x;
    }
    return 0;
}

long ransnx16_decode1(const uint8_t* buf, long len, long pos,
                      const uint8_t* tbl, long tlen, long tpos,
                      int table_inline, int shift,
                      uint8_t* out, long out_len, int n_states) {
    if (out_len == 0) return 0;
    if (n_states != 4 && n_states != 32) return -1;
    if (shift < 1 || shift > 12) return -2;  // lut capped at 4096
    const uint32_t target = 1u << shift;
    static thread_local uint8_t present[256];
    RansCtx* const ctxs = g_rans_ctxs.get();
    if (!ctxs) return -4;
    memset(present, 0, 256);
    const uint8_t* tb = table_inline ? buf : tbl;
    long tl = table_inline ? len : tlen;
    long tp = table_inline ? pos : tpos;
    uint8_t syms[256];
    int n;
    if (nx16_alphabet(tb, tl, &tp, syms, &n) < 0) return -1;
    for (int ci = 0; ci < n; ci++) {
        RansCtx* cx = &ctxs[syms[ci]];
        memset(cx->freq, 0, sizeof(cx->freq));
        memset(cx->lut, 0, target);
        for (int si = 0; si < n; si++) {
            uint32_t f;
            long r = nx16_u7(tb, tl, &tp, &f);
            if (r < 0) return r;
            if (f > target) return -2;
            cx->freq[syms[si]] = (uint16_t)f;
        }
        uint32_t cum = 0;
        for (int s = 0; s < 256; s++) {
            cx->cum[s] = cum;
            cum += cx->freq[s];
        }
        cx->cum[256] = cum;
        // final-array sum, as in nx16 o0: rows either sum to the
        // target or are all-zero (Python keeps zero rows as-is)
        if (cum != 0 && cum != target) return -2;
        for (int s = 0; s < 256; s++)
            if (cx->freq[s]) memset(cx->lut + cx->cum[s], s, cx->freq[s]);
        present[syms[ci]] = 1;
    }
    if (table_inline) pos = tp;
    if (pos + 4L * n_states > len) return -1;
    uint32_t R[32];
    memcpy(R, buf + pos, 4L * n_states);
    pos += 4L * n_states;
    long F = out_len / n_states;
    long idx[32], ends[32];
    uint8_t lastc[32];
    for (int j = 0; j < n_states; j++) {
        idx[j] = j * F;
        ends[j] = (j == n_states - 1) ? out_len : (j + 1) * F;
        lastc[j] = 0;
    }
    const uint32_t mask = target - 1;
    while (1) {
        int done = 1;
        for (int j = 0; j < n_states; j++) {
            if (idx[j] >= ends[j]) continue;
            done = 0;
            uint32_t x = R[j];
            RansCtx* cx = &ctxs[lastc[j]];
            if (!present[lastc[j]]) return -9;
            uint32_t m = x & mask;
            uint8_t s = cx->lut[m];
            out[idx[j]] = s;
            x = (uint32_t)cx->freq[s] * (x >> shift) + m - cx->cum[s];
            if (x < (1u << 15) && pos + 1 < len) {
                x = (x << 16) | buf[pos] | ((uint32_t)buf[pos + 1] << 8);
                pos += 2;
            }
            R[j] = x;
            lastc[j] = s;
            idx[j]++;
        }
        if (done) break;
    }
    return 0;
}

}  // extern "C"

// ------------------------------------------------------------------
// C port of io/arith.py::_decode_body (CRAM 3.1 block method 6 — the
// adaptive-model loops are the slowest pure-Python codec path; the
// name tokeniser's streams can ride this coder too). Carry-counting
// range decoder (32-bit range, 5-byte preload, byte renorm below
// 2^24) + adaptive models (+16 per update, halve past 2^16-16,
// adjacent swap), order 0/1 byte models and the integrated RLE run
// models keyed by literal symbol / shared continuation context —
// exactly the state machine io/arith.py documents. Accelerator only:
// nonzero return → caller falls back to the pure-Python decoder,
// which owns every error message.

struct AModel {
    uint8_t sym[256];
    uint16_t freq[256];
    uint32_t total;
    uint16_t nsym;
    uint8_t live;
};

static inline void amodel_init(AModel* m, int nsym) {
    for (int i = 0; i < nsym; i++) {
        m->sym[i] = (uint8_t)i;
        m->freq[i] = 1;
    }
    m->total = nsym;
    m->nsym = (uint16_t)nsym;
    m->live = 1;
}

struct ARange {
    const uint8_t* buf;
    long len;
    long pos;
    uint32_t code;
    uint32_t range;
};

static inline void arange_init(ARange* rc, const uint8_t* buf, long len,
                               long pos) {
    rc->buf = buf;
    rc->len = len;
    rc->pos = pos;
    rc->code = 0;
    rc->range = 0xFFFFFFFFu;
    for (int i = 0; i < 5; i++) {
        uint8_t b = rc->pos < len ? buf[rc->pos] : 0;
        rc->pos++;
        rc->code = (rc->code << 8) | b;
    }
}

static inline void amodel_bump(AModel* m, int i) {
    m->freq[i] += 16;
    m->total += 16;
    if (m->total > (1u << 16) - 16) {
        uint32_t total = 0;
        for (int j = 0; j < m->nsym; j++) {
            uint16_t f = m->freq[j];
            f -= f >> 1;
            m->freq[j] = f;
            total += f;
        }
        m->total = total;
    }
    if (i && m->freq[i] > m->freq[i - 1]) {
        uint16_t tf = m->freq[i];
        m->freq[i] = m->freq[i - 1];
        m->freq[i - 1] = tf;
        uint8_t ts = m->sym[i];
        m->sym[i] = m->sym[i - 1];
        m->sym[i - 1] = ts;
    }
}

// returns symbol, or -1 on a corrupt stream
static inline int amodel_decode(AModel* m, ARange* rc) {
    rc->range /= m->total;
    uint32_t f = rc->code / rc->range;
    if (f >= m->total) return -1;
    uint32_t acc = 0;
    int i = 0;
    while (acc + m->freq[i] <= f) {
        acc += m->freq[i];
        i++;
        if (i >= m->nsym) return -1;
    }
    rc->code -= acc * rc->range;
    rc->range *= m->freq[i];
    while (rc->range < (1u << 24)) {
        uint8_t b = rc->pos < rc->len ? rc->buf[rc->pos] : 0;
        rc->pos++;
        rc->code = (rc->code << 8) | b;
        rc->range <<= 8;
    }
    int s = m->sym[i];
    amodel_bump(m, i);
    return s;
}

extern "C" {

long arith_decode_body(const uint8_t* buf, long len, long pos,
                       uint8_t* out, long out_len, int order, int rle) {
    if (out_len == 0) return 0;
    if (pos >= len) return -1;
    int nsym = buf[pos];
    pos++;
    if (nsym == 0) nsym = 256;
    // byte models (1 for o0, 256 lazily-initialized for o1) plus 257
    // run models (one per literal symbol + the shared continuation
    // context): ~400KB, heap-held per thread like the rANS pools
    struct Pool {
        AModel* p = nullptr;
        ~Pool() { free(p); }
    };
    static thread_local Pool pool;
    const int N_BYTE = 256, N_RUN = 257;
    if (!pool.p) {
        pool.p = (AModel*)malloc((N_BYTE + N_RUN) * sizeof(AModel));
        if (!pool.p) return -4;
    }
    AModel* byte_m = pool.p;
    AModel* run_m = pool.p + N_BYTE;
    for (int i = 0; i < N_BYTE + N_RUN; i++) pool.p[i].live = 0;
    ARange rc;
    arange_init(&rc, buf, len, pos);
    long i = 0;
    int prev = 0;
    if (!rle) {
        for (; i < out_len; i++) {
            AModel* m = &byte_m[order ? prev : 0];
            if (!m->live) amodel_init(m, nsym);
            int s = amodel_decode(m, &rc);
            if (s < 0) return -1;
            out[i] = (uint8_t)s;
            prev = s;
        }
        return 0;
    }
    while (i < out_len) {
        AModel* m = &byte_m[order ? prev : 0];
        if (!m->live) amodel_init(m, nsym);
        int s = amodel_decode(m, &rc);
        if (s < 0) return -1;
        prev = s;
        long run = 0;
        int ctx = s;
        while (1) {
            AModel* rm = &run_m[ctx];
            if (!rm->live) amodel_init(rm, 256);
            int part = amodel_decode(rm, &rc);
            if (part < 0) return -1;
            run += part;
            if (part != 255) break;
            if (run > out_len) return -1;  // truncated-stream loop bound
            ctx = 256;
        }
        if (i + run + 1 > out_len) return -1;
        memset(out + i, s, run + 1);
        i += run + 1;
    }
    return 0;
}

}  // extern "C"

// ------------------------------------------------------------------
// C port of io/fqzcomp.py::_decode (CRAM 3.1 block method 7): full
// stream decode — version/gflags, parameter sets (selector table,
// qmap, transmitted or shift-clamp default context tables), and the
// record loop (selector, 4-byte lengths through dedicated models,
// reversal flags applied after decode, dedup copies, quality symbols
// from the 16-bit mixed context). Reuses the arith coder's AModel /
// ARange. Accelerator only: nonzero return → the pure-Python decoder
// (which owns every error message) takes over.

struct FqzParam {
    uint32_t seed;
    uint8_t pflags;
    int max_sym;
    int qbits, qshift, pbits, pshift, dbits, dshift;
    int qloc, sloc, ploc, dloc;
    int have_qmap;
    uint8_t qmap[256];
    uint32_t qtab[256];
    uint32_t ptab[1024];
    uint32_t dtab[256];
};

static long fqz_table(const uint8_t* buf, long len, long* pos,
                      uint32_t* out, int size) {
    int n = 0;
    while (n < size) {
        uint32_t v, r;
        long rc = nx16_u7(buf, len, pos, &v);  // same uint7 varint
        if (rc < 0) return rc;
        rc = nx16_u7(buf, len, pos, &r);
        if (rc < 0) return rc;
        if (r == 0 || n + (long)r > size) return -1;
        for (uint32_t k = 0; k < r; k++) out[n++] = v;
    }
    return 0;
}

static void fqz_default_table(uint32_t* out, int size, int bits,
                              int shift) {
    if (bits < 1) bits = 1;
    uint32_t cap = (1u << bits) - 1;
    for (int v = 0; v < size; v++) {
        uint32_t x = (uint32_t)v >> shift;
        out[v] = x < cap ? x : cap;
    }
}

static long fqz_param_parse(const uint8_t* buf, long len, long* pos,
                            FqzParam* p) {
    if (*pos + 9 > len) return -1;
    p->seed = buf[*pos] | ((uint32_t)buf[*pos + 1] << 8);
    p->pflags = buf[*pos + 2];
    p->max_sym = buf[*pos + 3];
    const uint8_t* nib = buf + *pos + 4;
    *pos += 9;
    p->qbits = nib[0] >> 4; p->qshift = nib[0] & 15;
    p->pbits = nib[1] >> 4; p->pshift = nib[1] & 15;
    p->dbits = nib[2] >> 4; p->dshift = nib[2] & 15;
    p->qloc = nib[3] >> 4;  p->sloc = nib[3] & 15;
    p->ploc = nib[4] >> 4;  p->dloc = nib[4] & 15;
    p->have_qmap = (p->pflags & 0x10) != 0;
    if (p->have_qmap) {
        if (*pos + p->max_sym > len) return -1;
        memcpy(p->qmap, buf + *pos, p->max_sym);
        *pos += p->max_sym;
    }
    long r;
    if (p->qbits && (p->pflags & 0x80)) {
        if ((r = fqz_table(buf, len, pos, p->qtab, 256)) < 0) return r;
    } else {
        fqz_default_table(p->qtab, 256, p->qbits, p->qshift);
    }
    if (p->pbits && (p->pflags & 0x20)) {
        if ((r = fqz_table(buf, len, pos, p->ptab, 1024)) < 0) return r;
    } else {
        fqz_default_table(p->ptab, 1024, p->pbits, p->pshift);
    }
    if (p->dbits && (p->pflags & 0x40)) {
        if ((r = fqz_table(buf, len, pos, p->dtab, 256)) < 0) return r;
    } else {
        fqz_default_table(p->dtab, 256, p->dbits, p->dshift);
    }
    return 0;
}

static inline uint32_t fqz_mix(const FqzParam* p, uint32_t qhist,
                               long remaining, uint32_t delta,
                               uint32_t sel) {
    uint32_t ctx = p->seed;
    if (p->qbits)
        ctx += (qhist & ((1u << p->qbits) - 1)) << p->qloc;
    if (p->pbits) {
        long rr = remaining < 1023 ? remaining : 1023;
        ctx += p->ptab[rr] << p->ploc;
    }
    if (p->dbits) {
        uint32_t dd = delta < 255 ? delta : 255;
        ctx += p->dtab[dd] << p->dloc;
    }
    if (p->pflags & 0x08)
        ctx += sel << p->sloc;
    return ctx & 0xFFFF;
}

extern "C" {

long fqzcomp_decode(const uint8_t* buf, long len, uint8_t* out,
                    long out_len) {
    if (out_len == 0) return 0;
    if (len < 2 || buf[0] != 5) return -1;
    int gflags = buf[1];
    long pos = 2;
    int nparam = 1;
    if (gflags & 0x01) {  // MULTI_PARAM
        if (pos >= len) return -1;
        nparam = buf[pos++];
    }
    if (nparam == 0) return -1;
    int max_sel = nparam - 1;
    uint32_t stab[256];
    if (gflags & 0x02) {  // HAVE_STAB
        if (pos >= len) return -1;
        max_sel = buf[pos++];
        if (fqz_table(buf, len, &pos, stab, 256) < 0) return -1;
    } else {
        for (int i = 0; i < 256; i++)
            stab[i] = i < nparam ? i : nparam - 1;
    }
    // everything below frees through this holder on every exit path
    struct Scratch {
        FqzParam* params = nullptr;
        AModel** qual = nullptr;     // 65536 lazily-allocated models
        long* revs = nullptr;        // (start, len) pairs
        ~Scratch() {
            free(params);
            if (qual) {
                for (int i = 0; i < 65536; i++) free(qual[i]);
                free(qual);
            }
            free(revs);
        }
    } s;
    s.params = (FqzParam*)malloc(nparam * sizeof(FqzParam));
    if (!s.params) return -4;
    for (int i = 0; i < nparam; i++) {
        long r = fqz_param_parse(buf, len, &pos, &s.params[i]);
        if (r < 0) return r;
    }
    int nsym = 0;
    for (int i = 0; i < nparam; i++)
        if (s.params[i].max_sym > nsym) nsym = s.params[i].max_sym;
    nsym += 1;
    if (nsym > 256) return -1;
    s.qual = (AModel**)calloc(65536, sizeof(AModel*));
    if (!s.qual) return -4;
    AModel sel_m, len_m[4], rev_m, dup_m;
    int have_sel = max_sel > 0;
    if (have_sel) amodel_init(&sel_m, max_sel + 1);
    for (int j = 0; j < 4; j++) amodel_init(&len_m[j], 256);
    amodel_init(&rev_m, 2);
    amodel_init(&dup_m, 2);
    long n_revs = 0, cap_revs = 0;
    ARange rc;
    arange_init(&rc, buf, len, pos);
    long i = 0;
    uint32_t sel = 0;
    FqzParam* p = &s.params[0];
    long rec_len = 0, last_len = 0, remaining = 0;
    uint32_t qhist = 0, delta = 0;
    int prevq = 0;
    while (i < out_len) {
        if (remaining == 0) {
            if (have_sel) {
                int sv = amodel_decode(&sel_m, &rc);
                if (sv < 0 || stab[sv] >= (uint32_t)nparam) return -1;
                sel = (uint32_t)sv;
                p = &s.params[stab[sv]];
            }
            if ((p->pflags & 0x04) || last_len == 0) {  // DO_LEN
                uint32_t l = 0;
                for (int j = 0; j < 4; j++) {
                    int b = amodel_decode(&len_m[j], &rc);
                    if (b < 0) return -1;
                    l |= (uint32_t)b << (8 * j);
                }
                rec_len = (long)l;
                last_len = rec_len;
            } else {
                rec_len = last_len;
            }
            if (rec_len == 0 || i + rec_len > out_len) return -1;
            if (gflags & 0x04) {  // DO_REV
                int rv = amodel_decode(&rev_m, &rc);
                if (rv < 0) return -1;
                if (rv) {
                    if (n_revs == cap_revs) {
                        cap_revs = cap_revs ? cap_revs * 2 : 64;
                        long* nr = (long*)realloc(
                            s.revs, cap_revs * 2 * sizeof(long));
                        if (!nr) return -4;
                        s.revs = nr;
                    }
                    s.revs[n_revs * 2] = i;
                    s.revs[n_revs * 2 + 1] = rec_len;
                    n_revs++;
                }
            }
            if (p->pflags & 0x02) {  // DO_DEDUP
                int dv = amodel_decode(&dup_m, &rc);
                if (dv < 0) return -1;
                if (dv) {
                    if (i < rec_len) return -1;
                    memmove(out + i, out + i - rec_len, rec_len);
                    i += rec_len;
                    continue;
                }
            }
            remaining = rec_len;
            qhist = 0;
            prevq = 0;
            delta = 0;
        }
        uint32_t ctx = fqz_mix(p, qhist, remaining, delta, sel);
        AModel* qm = s.qual[ctx];
        if (!qm) {
            qm = (AModel*)malloc(sizeof(AModel));
            if (!qm) return -4;
            amodel_init(qm, nsym);
            s.qual[ctx] = qm;
        }
        int q = amodel_decode(qm, &rc);
        if (q < 0) return -1;
        if (p->have_qmap) {
            if (q >= p->max_sym) return -1;
            out[i] = p->qmap[q];
        } else {
            out[i] = (uint8_t)q;
        }
        qhist = (qhist << p->qshift) + p->qtab[q];
        if (p->dbits)
            delta += (uint32_t)(prevq != q);
        prevq = q;
        remaining--;
        i++;
    }
    for (long r = 0; r < n_revs; r++) {
        long a = s.revs[r * 2], ln = s.revs[r * 2 + 1];
        for (long x = a, y = a + ln - 1; x < y; x++, y--) {
            uint8_t t = out[x];
            out[x] = out[y];
            out[y] = t;
        }
    }
    return 0;
}

}  // extern "C"

// ------------------------------------------------------------------
// C port of io/tok3.py's name assembly (CRAM 3.1 block method 8).
// The per-(position, field) streams are already decompressed by the
// C-backed rANS-Nx16/arith decoders on the Python side; this routine
// replays the token machine over them: DUP copies a whole earlier
// name, DIFF rebuilds token-by-token (MATCH copies the template
// token, DDELTA/DDELTA0 add a u8 to its numeric value — DDELTA0
// keeping the template's zero-padded width - DIGITS/DIGITS0/ALPHA/
// CHAR read fresh payloads). Streams arrive as one concatenated blob
// with a 256x13 (position, field) offset/length table, -1 = absent.
// Accelerator only: nonzero return → the pure-Python assembly (which
// owns every error message) takes over.

#define TOK3_SLOTS (256 * 13)
#define T3_TYPE 0
#define T3_ALPHA 1
#define T3_CHAR 2
#define T3_DIGITS0 3
#define T3_DZLEN 4
#define T3_DUP 5
#define T3_DIFF 6
#define T3_DIGITS 7
#define T3_DDELTA 8
#define T3_DDELTA0 9
#define T3_MATCH 10
#define T3_NOP 11
#define T3_END 12

struct Tok3Tok {
    int32_t start;  // offset of the token text in `out`
    int32_t len;
    uint8_t type;   // T3_ALPHA / T3_CHAR / T3_DIGITS / T3_DIGITS0
};

extern "C" {

long tok3_assemble(const uint8_t* blob, const int64_t* offs,
                   const int64_t* lens, long n_names, uint8_t sep,
                   uint8_t* out, long out_cap) {
    // every valid name contributes at least its separator byte, so
    // a name count beyond out_cap (attacker-controlled varint) can
    // never assemble — reject before sizing any scratch from it
    if (n_names < 0 || n_names > out_cap) return -1;
    long cur[TOK3_SLOTS];
    memset(cur, 0, sizeof(cur));
    struct Scratch {
        Tok3Tok* toks = nullptr;
        int64_t* name_tok0 = nullptr;  // first token index per name
        int32_t* name_ntok = nullptr;
        int64_t* name_start = nullptr;  // offset of name in out
        int32_t* name_len = nullptr;
        ~Scratch() {
            free(toks);
            free(name_tok0);
            free(name_ntok);
            free(name_start);
            free(name_len);
        }
    } s;
    long tok_cap = 4096, n_toks = 0;
    s.toks = (Tok3Tok*)malloc(tok_cap * sizeof(Tok3Tok));
    s.name_tok0 = (int64_t*)malloc(n_names * sizeof(int64_t));
    s.name_ntok = (int32_t*)malloc(n_names * sizeof(int32_t));
    s.name_start = (int64_t*)malloc(n_names * sizeof(int64_t));
    s.name_len = (int32_t*)malloc(n_names * sizeof(int32_t));
    if (!s.toks || !s.name_tok0 || !s.name_ntok || !s.name_start ||
        !s.name_len)
        return -4;

#define SLOT(p, f) ((p) * 13 + (f))
#define HAVE(sl) (offs[sl] >= 0)
#define TAKE1(sl, v)                                   \
    do {                                               \
        if (!HAVE(sl) || cur[sl] >= lens[sl]) return -1; \
        (v) = blob[offs[sl] + cur[sl]++];              \
    } while (0)

    long w = 0;  // write position in out
    for (long n = 0; n < n_names; n++) {
        int t0;
        TAKE1(SLOT(0, T3_TYPE), t0);
        uint32_t dist;
        if (t0 == T3_DUP || t0 == T3_DIFF) {
            int sl = SLOT(0, t0);
            if (!HAVE(sl) || cur[sl] + 4 > lens[sl]) return -1;
            memcpy(&dist, blob + offs[sl] + cur[sl], 4);
            cur[sl] += 4;
        } else {
            return -1;
        }
        long src = n - 1 - (long)dist;
        if (t0 == T3_DUP) {
            if (src < 0 || src >= n) return -1;
            long ln = s.name_len[src];
            if (w + ln + 1 > out_cap) return -1;
            memcpy(out + w, out + s.name_start[src], ln);
            s.name_tok0[n] = s.name_tok0[src];
            s.name_ntok[n] = s.name_ntok[src];
            s.name_start[n] = w;
            s.name_len[n] = (int32_t)ln;
            w += ln;
            out[w++] = sep;
            continue;
        }
        if (n && (src < 0 || src >= n)) return -1;
        // keep the template as an INDEX: the token arena reallocs
        // while this name decodes, so a pointer would dangle
        long tmpl0 = n ? s.name_tok0[src] : 0;
        int tmpl_n = n ? s.name_ntok[src] : 0;
        long my_tok0 = n_toks;
        long name_w0 = w;
        int t = 1;
        while (1) {
            if (t >= 256) return -1;  // stream keys are single bytes
            int typ;
            TAKE1(SLOT(t, T3_TYPE), typ);
            if (typ == T3_END) break;
            if (typ == T3_NOP) {
                t++;
                continue;
            }
            if (n_toks == tok_cap) {
                tok_cap *= 2;
                Tok3Tok* nt = (Tok3Tok*)realloc(
                    s.toks, tok_cap * sizeof(Tok3Tok));
                if (!nt) return -4;
                s.toks = nt;
            }
            Tok3Tok* me = &s.toks[n_toks];
            const Tok3Tok* tm = (t - 1 < tmpl_n)
                ? &s.toks[tmpl0 + t - 1] : nullptr;
            long start = w;
            if (typ == T3_MATCH) {
                if (!tm) return -1;
                if (w + tm->len > out_cap) return -1;
                memcpy(out + w, out + tm->start, tm->len);
                w += tm->len;
                me->type = tm->type;
            } else if (typ == T3_ALPHA) {
                int sl = SLOT(t, T3_ALPHA);
                if (!HAVE(sl)) return -1;
                const uint8_t* base = blob + offs[sl];
                long p = cur[sl];
                while (p < lens[sl] && base[p] != 0) p++;
                if (p >= lens[sl]) return -1;  // unterminated
                long ln = p - cur[sl];
                if (w + ln > out_cap) return -1;
                memcpy(out + w, base + cur[sl], ln);
                w += ln;
                cur[sl] = p + 1;
                me->type = T3_ALPHA;
            } else if (typ == T3_CHAR) {
                int c;
                TAKE1(SLOT(t, T3_CHAR), c);
                if (w + 1 > out_cap) return -1;
                out[w++] = (uint8_t)c;
                me->type = T3_CHAR;
            } else if (typ == T3_DIGITS || typ == T3_DDELTA) {
                uint32_t v;
                uint64_t vv;
                if (typ == T3_DIGITS) {
                    int sl = SLOT(t, T3_DIGITS);
                    if (!HAVE(sl) || cur[sl] + 4 > lens[sl]) return -1;
                    memcpy(&v, blob + offs[sl] + cur[sl], 4);
                    cur[sl] += 4;
                    vv = v;
                } else {
                    if (!tm || (tm->type != T3_DIGITS &&
                                tm->type != T3_DIGITS0))
                        return -1;
                    int d;
                    TAKE1(SLOT(t, T3_DDELTA), d);
                    // parse the template's decimal value; the sum can
                    // exceed u32 (the Python reference prints the full
                    // value), so keep 64 bits through the formatting
                    uint64_t tv = 0;
                    for (int k = 0; k < tm->len; k++) {
                        uint8_t c = out[tm->start + k];
                        if (c < '0' || c > '9') return -1;
                        tv = tv * 10 + (c - '0');
                        if (tv > 0xFFFFFFFFull) return -1;
                    }
                    vv = tv + (uint64_t)d;
                }
                char dec[24];
                int ln = snprintf(dec, sizeof(dec), "%llu",
                                  (unsigned long long)vv);
                if (ln <= 0 || w + ln > out_cap) return -1;
                memcpy(out + w, dec, ln);
                w += ln;
                me->type = T3_DIGITS;
            } else if (typ == T3_DIGITS0 || typ == T3_DDELTA0) {
                uint32_t v;
                uint64_t vv;
                int z;
                if (typ == T3_DIGITS0) {
                    int sl = SLOT(t, T3_DIGITS0);
                    if (!HAVE(sl) || cur[sl] + 4 > lens[sl]) return -1;
                    memcpy(&v, blob + offs[sl] + cur[sl], 4);
                    cur[sl] += 4;
                    TAKE1(SLOT(t, T3_DZLEN), z);
                    vv = v;
                } else {
                    if (!tm || (tm->type != T3_DIGITS &&
                                tm->type != T3_DIGITS0))
                        return -1;
                    int d;
                    TAKE1(SLOT(t, T3_DDELTA0), d);
                    uint64_t tv = 0;
                    for (int k = 0; k < tm->len; k++) {
                        uint8_t c = out[tm->start + k];
                        if (c < '0' || c > '9') return -1;
                        tv = tv * 10 + (c - '0');
                        if (tv > 0xFFFFFFFFull) return -1;
                    }
                    vv = tv + (uint64_t)d;
                    z = tm->len;
                }
                char dec[24];
                int ln = snprintf(dec, sizeof(dec), "%llu",
                                  (unsigned long long)vv);
                if (ln <= 0 || ln > z || z > 255) return -1;
                if (w + z > out_cap) return -1;
                memset(out + w, '0', z - ln);
                memcpy(out + w + (z - ln), dec, ln);
                w += z;
                me->type = T3_DIGITS0;
            } else {
                return -1;  // unknown token type
            }
            me->start = (int32_t)start;
            me->len = (int32_t)(w - start);
            n_toks++;
            t++;
        }
        s.name_tok0[n] = my_tok0;
        s.name_ntok[n] = (int32_t)(n_toks - my_tok0);
        s.name_start[n] = name_w0;
        s.name_len[n] = (int32_t)(w - name_w0);
        if (w + 1 > out_cap) return -1;
        out[w++] = sep;
    }
    if (w != out_cap) return -1;  // must fill the declared size exactly
    return 0;
#undef SLOT
#undef HAVE
#undef TAKE1
}

}  // extern "C"
