// Host-IO fast path of the port: BGZF block scan/inflate/deflate, BAM
// record decode, the streaming segment walk that feeds the depth kernel,
// the .bai structure scan and the depth/callable BED row formatters.
//
// A copy of the JAX package's csrc/fastio.cpp trimmed to the entry points
// goleft_tpu_torch/io/native.py binds; the CRAM codecs and the host-side
// window reductions are left out. Build (done lazily by native.py):
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

extern "C" {

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

}  // extern "C"
