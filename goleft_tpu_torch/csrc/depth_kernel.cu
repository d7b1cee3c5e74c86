// Per-shard depth pipeline on Hopper (sm_90a): segment endpoints →
// per-base depth → cap + in-region mask → window sums + callable classes
// → 2-bit packed classes.
//
// Replaces the TPU kernel goleft_tpu/ops/pallas_coverage.py::pallas_depth
// (the per-base depth) together with the XLA epilogue of
// goleft_tpu/ops/depth_pipeline.py::_pipeline_body, so that only the
// window sums and the packed classes (and, when asked for, the dense
// depth and classes) leave the card.
//
// What bounds it: bytes. A 10 Mb shard on the packed u16 wire brings
// about 2 M segments (4 bytes each: start delta + length) and takes out
// 2.5 MB of packed classes and 40 KB of window sums; the work per byte is
// a few integer operations: 0.0033 ms at the card's 3.35 TB/s. The TPU
// kernel carried the running depth across its sequential grid; blocks
// on this card run in no order, and a per-base delta buffer in device
// memory (the first design: zeroed, scattered, scanned, read, nine
// stream operations a shard) moves ten times the function's bytes.
//
// The design now, on the u16 wire (the main path), three stream
// operations a shard: one memset of a small header (under 100 KB), then
//   A. wire_starts: absolute starts from the u16 deltas in one pass, a
//      single-pass scan with decoupled look-back (tiles of 4,096 entries
//      taken in order from an atomic ticket, so a tile only ever waits
//      on tiles that are already running). The look-back carries, beside
//      the sum of the deltas, how far the furthest segment end reaches
//      past the last start, so the furthest end is known at every entry.
//      It writes the start before every 32-entry chunk and two index
//      marks every GRAIN positions: the first entry whose start reaches
//      the mark, and the first entry at which the furthest end passes it
//      (before that entry no segment can cover the mark). Starts and
//      furthest ends are non-decreasing, so each mark has exactly one
//      writer and needs no atomics.
//   B. depth_tiles: one block per tile of positions [lo, hi). Its marks
//      give, in one round trip, the entries that can reach the tile; a
//      warp rebuilds a chunk's starts from its base start and a warp scan
//      of its deltas. Each segment adds +1 at max(s, lo) and -1 at its
//      end in shared memory; a segment that starts left of the tile
//      enters at lo, so the block owns its carry and no block waits for
//      another. The block scans its tile, then caps, masks, classifies,
//      packs 2 bits a base and sums its windows: tiles hold whole windows
//      wherever lcm(window, 16) fits a tile (the default window of 250
//      gives tiles of 4,000), and each block rounds its own int64 window
//      sums to float32. Windows wider than that add int64 partial sums
//      with global atomics, and the last tile to arrive at a window (a
//      per-window arrival count) rounds it.
// No per-base buffer is written to device memory except the dense
// outputs when they are asked for; the input is read once by A and
// about once more by B. The halo costs what the segments that cross a
// tile's left edge cost: a tile reads the entries from the first one
// whose furthest end passes it, so one 65,535-base segment makes only
// the 17 tiles it covers read back to it.
//
// What the measurements taught (tools/depth_bench.py and per-block
// timers, PERF.md §6): with every tile of A resident at once, look-back
// reads of packed descriptors met on a few L2 lines (descriptors now
// one to a line); volatile descriptor loads are system-scope and were
// issued one at a time (now relaxed device-scope, all in flight);
// scattered mark stores cost A more than their instructions (one mark
// per 512 positions, not 128); a class branch diverged at every position
// and 64-bit divisions sat in every thread of B (both gone). B still
// takes two thirds of the time: about 7 us a tile of latency, through
// five barriers, with five tiles resident an SM.
//
// The int32 wire (unsorted endpoints + keep mask; off the main path)
// keeps a global-atomic scatter into a zeroed int32 delta buffer; the
// same tile kernel then loads its tile of deltas and takes its carry by
// a decoupled look-back over the position tiles. Three stream
// operations as well: the memset (delta buffer and header), the scatter,
// the tile kernel.
//
// Measured by tools/depth_bench.py (NVIDIA H100 80GB HBM3, 700.00 W;
// PERF.md §6), a 10 Mb shard of chip_smoke.py, device time: 0.0477 ms on
// the u16 wire (memset 0.0011, A 0.0142, B 0.0321) against the per-base
// buffer design's 0.1910 in the same call; 0.0487 with one 65,535-base
// segment more (0.1908); 0.1577 on the int32 wire (0.2275), where the
// scatter's 4 M global atomics take 0.098.
//
// A batch (the serve daemon's coalesced /v1/depth pass) runs B samples'
// segments over the same region in the same three stream operations:
// the samples' entries lie back to back (int64 entry offsets, a u16-wire
// base a sample), the grids are (tiles, B) and blockIdx.y picks the
// sample (sample_args). Each sample has its own workspace slab, laid out
// for the batch's longest segment count: the zeroed heads of all samples
// first, so that one memset zeroes them, then the tails. Tickets come
// from the sample's own header, so a tile only waits on tiles of its own
// sample that are already running; launch A's grid is as wide as the
// longest sample, and the blocks a shorter sample does not need leave at
// once. A single shard is a batch of one.
//
// Integer arithmetic that can wrap (start reconstruction, region clip,
// prefix sums, carries) is done in uint32 so that it wraps exactly like
// the int32 arithmetic of the reference. The tile decomposition of the
// u16 wire further assumes what the wire's packer guarantees: starts are
// non-decreasing and a segment's end does not wrap, i.e. coordinates
// stay below 2^31 - 65,536.
//
// Interface: plain C, loaded with ctypes (goleft_tpu_torch/ops/
// depth_kernel.py). The caller allocates every buffer: one workspace,
// whose first part it zeroes, and the outputs. The launches go on the
// caller's stream and nothing synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define NWARPS (THREADS / 32)
#define PER_THREAD 16                     // entries or positions a thread
#define CHUNK (THREADS * PER_THREAD)      // wire entries a launch-A tile
#define TILE_MAX CHUNK                    // positions a launch-B tile, at most
#define GRAIN_SHIFT 9
#define GRAIN (1 << GRAIN_SHIFT)          // positions between index marks

// look-back descriptor: status (1 aggregate, 2 inclusive prefix) in bits
// 48-49, D in bits 32-47, S in bits 0-31. S is a sum of start deltas
// (the int32 wire: of per-base deltas); D = max(0, the furthest segment
// end - the last start), at most 65,535 (0 on the int32 wire).
#define LB_AGG 1ull
#define LB_INCL 2ull
// one descriptor per 128-byte line: every tile of a launch can be
// resident at once, and then each reads up to 256 predecessors; packed
// descriptors would put all of those reads on a few L2 lines
#define LB_STRIDE 16

__device__ __forceinline__ unsigned long long lb_desc(unsigned long long st,
                                                      uint32_t s, int d) {
    return st << 48 | (unsigned long long)d << 32 | s;
}

// The zeroed head of the workspace.
struct Header {
    unsigned int ticket;   // look-back tile tickets taken so far
    unsigned int n_live;   // 1 + index of the last entry of nonzero length
    int x_first;           // shard-relative start of entry 0
    int x_last;            // shard-relative start of entry n - 1
    int y_first;           // shard-relative end of entry 0
    int y_last;            // the furthest shard-relative end of all entries
};

__device__ __forceinline__ uint32_t warp_incl_scan(uint32_t v) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        uint32_t n = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += n;
    }
    return v;
}

// Exclusive scan of one value a thread over the block; *total receives
// the block total. Every thread must call it.
__device__ __forceinline__ uint32_t block_excl_scan(uint32_t v,
                                                    uint32_t* total) {
    __shared__ uint32_t warp_sums[NWARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    uint32_t incl = warp_incl_scan(v);
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        uint32_t w = lane < NWARPS ? warp_sums[lane] : 0u;
        w = warp_incl_scan(w);
        if (lane < NWARPS) warp_sums[lane] = w;
    }
    __syncthreads();
    uint32_t prefix = warp ? warp_sums[warp - 1] : 0u;
    *total = warp_sums[NWARPS - 1];
    __syncthreads();  // warp_sums may be reused by the next call
    return prefix + incl - v;
}

// Maximum over the block, returned to every thread.
__device__ __forceinline__ uint32_t block_max(uint32_t v) {
    __shared__ uint32_t warp_max[NWARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) warp_max[warp] = v;
    __syncthreads();
    v = warp_max[0];
#pragma unroll
    for (int w = 1; w < NWARPS; w++) v = max(v, warp_max[w]);
    __syncthreads();
    return v;
}

// Exclusive max-scan of one int a thread over the block (-1 before the
// first thread); *total receives the block maximum.
__device__ __forceinline__ int block_excl_max(int v, int* total) {
    __shared__ int warp_max[NWARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int n = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl = max(incl, n);
    }
    int ex = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) ex = -1;
    if (lane == 31) warp_max[warp] = incl;
    __syncthreads();
    int before = -1, all = -1;
#pragma unroll
    for (int w = 0; w < NWARPS; w++) {
        if (w < warp) before = max(before, warp_max[w]);
        all = max(all, warp_max[w]);
    }
    *total = all;
    __syncthreads();
    return max(before, ex);
}

// Look-back descriptors: relaxed loads and stores at device scope. A
// descriptor carries its own payload, so no ordering with other memory
// is needed; volatile would make them system-scope strong accesses,
// each a separate round trip.
__device__ __forceinline__ void store_flag(unsigned long long* p,
                                           unsigned long long v) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
                 : "memory");
}

__device__ __forceinline__ unsigned long long load_flag(
    const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                 : "=l"(v)
                 : "l"(p)
                 : "memory");
    return v;
}

struct Prefix {
    uint32_t s;  // sum over the tiles before this one
    int d;       // their D, or -1 before tile 0
};

// Decoupled look-back: publish this tile's aggregate (s_t, d_t), then
// combine the predecessors' values back to the nearest inclusive prefix
// and publish this tile's own. Returns the tile's exclusive prefix to
// every thread. Tiles are numbered by ticket, so every predecessor is
// already running and publishes its aggregate without waiting. A warp
// reads 256 predecessors a round (8 a lane): all tiles of a launch may
// be resident at once, and then no predecessor has its inclusive prefix
// yet. Tiles combine in order as (S, D) of A then B = (S_A + S_B,
// max(D_B, D_A - S_B)).
__device__ Prefix lookback(unsigned long long* flags, long t, uint32_t s_t,
                           int d_t) {
    __shared__ Prefix excl_sh;
    if (threadIdx.x == 0) {
        store_flag(flags + t * LB_STRIDE,
                   lb_desc(t == 0 ? LB_INCL : LB_AGG, s_t, d_t));
        if (t == 0) excl_sh = Prefix{0u, -1};
    }
    if (t > 0 && threadIdx.x < 32) {
        const int lane = threadIdx.x;
        uint32_t s_acc = 0;     // the tiles walked so far, nearest first
        long long d_acc = -1;
        long pred = t - 1;
        while (true) {
            unsigned long long f[8];
            while (true) {  // all eight loads in flight at once
#pragma unroll
                for (int m = 0; m < 8; m++) {
                    const long j = pred - 8L * lane - m;
                    f[m] = load_flag(flags + (j >= 0 ? j : t) * LB_STRIDE);
                    if (j < 0) f[m] = LB_INCL << 48;
                }
                bool ready = true;
#pragma unroll
                for (int m = 0; m < 8; m++) ready &= (f[m] >> 48) != 0;
                if (__all_sync(0xffffffffu, ready)) break;
                __nanosleep(64);
            }
            int stop_m = 8;
#pragma unroll
            for (int m = 7; m >= 0; m--)
                if ((f[m] >> 48) == LB_INCL) stop_m = m;
            const unsigned incl = __ballot_sync(0xffffffffu, stop_m < 8);
            const int stop_lane = incl ? __ffs(incl) - 1 : 31;
            // this lane's tiles combined, nearest first
            uint32_t s_l = 0;
            long long d_l = -1;
            const int last_m = lane < stop_lane ? 7
                               : (lane == stop_lane ? stop_m : -1);
#pragma unroll
            for (int m = 0; m < 8; m++) {
                if (m <= last_m) {
                    const long j = pred - 8L * lane - m;
                    const uint32_t s_m = (uint32_t)f[m];
                    const long long d_m =
                        j >= 0 ? (long long)(f[m] >> 32 & 0xffffu) : -1;
                    d_l = max(d_l, d_m - (long long)s_l);
                    s_l += s_m;
                }
            }
            // lanes combined, nearest first: exclusive sums of s_l
            uint32_t s_ex = warp_incl_scan(s_l) - s_l;
            long long d_w = d_l - (long long)s_ex;
            uint32_t s_w = s_l;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
                d_w = max(d_w, __shfl_xor_sync(0xffffffffu, d_w, o));
                s_w += __shfl_xor_sync(0xffffffffu, s_w, o);
            }
            d_acc = max(d_acc, d_w - (long long)s_acc);
            s_acc += s_w;
            if (incl) break;
            pred -= 256;
        }
        if (lane == 0) {
            const int d_ex = (int)max(d_acc, 0LL);
            const long long d_in = max((long long)d_t,
                                       (long long)d_ex - (long long)s_t);
            store_flag(flags + t * LB_STRIDE,
                       lb_desc(LB_INCL, s_acc + s_t, (int)max(d_in, 0LL)));
            excl_sh = Prefix{s_acc, d_ex};
        }
    }
    __syncthreads();
    return excl_sh;
}

__device__ __forceinline__ bool aligned16(const void* p) {
    return ((uintptr_t)p & 15) == 0;
}

// 16 consecutive u16 entries from i0 (0 past n).
__device__ __forceinline__ void load16_u16(const uint16_t* p, long i0,
                                           long n, uint32_t* out) {
    if (i0 + PER_THREAD <= n && aligned16(p)) {
        const uint4 a = *reinterpret_cast<const uint4*>(p + i0);
        const uint4 b = *reinterpret_cast<const uint4*>(p + i0 + 8);
        const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int k = 0; k < 8; k++) {
            out[2 * k] = w[k] & 0xffffu;
            out[2 * k + 1] = w[k] >> 16;
        }
    } else {
#pragma unroll
        for (int k = 0; k < PER_THREAD; k++)
            out[k] = i0 + k < n ? (uint32_t)p[i0 + k] : 0u;
    }
}

struct TileArgs {
    // the wires, the whole batch's (sample_args moves them to one
    // sample's entries): u16 deltas + lengths, or int32 endpoints + keep
    const uint16_t* deltas;
    const uint16_t* lens;
    const int32_t* seg_s;
    const int32_t* seg_e;
    const uint8_t* keep;
    const long* offs;      // int64[B + 1] entry offsets; NULL: one sample
    const int32_t* bases;  // int32[B] u16-wire bases; NULL: base
    long n;                // entries (of sample 0 until sample_args)
    int32_t base;
    // sample 0's workspace; sample b's head lies b * head_stride bytes
    // on, its tail b * tail_stride
    Header* hd;
    unsigned long long* flags;
    int32_t* delta;              // int32 wire: the scattered deltas
    unsigned long long* wsum;    // windows wider than a tile only
    unsigned int* wcnt;
    int32_t* cbase;              // u16 wire: launch A's outputs
    int32_t* marks;
    int32_t* reach;
    long head_stride, tail_stride;
    long length, window, tile, n_marks;
    long wpt, n_win;  // windows a tile (0 when they cross tiles), in all
    int32_t w0, rs, re, cap, min_cov, max_mean;
    // outputs, row b of each for sample b
    float* sums;       // [B][n_win]
    uint8_t* packed;   // [B][ld_packed]
    int32_t* depth_out;  // [B][ld_pos] or NULL
    int8_t* cls_out;     // [B][ld_pos] or NULL
    long ld_packed, ld_pos;
};

template <typename T>
__device__ __forceinline__ T* shift(T* p, long bytes) {
    return p ? (T*)((char*)p + bytes) : p;
}

// The arguments of sample blockIdx.y.
__device__ __forceinline__ TileArgs sample_args(const TileArgs& a0) {
    TileArgs a = a0;
    const long b = blockIdx.y;
    if (a.offs) {
        const long o = a.offs[b];
        a.n = a.offs[b + 1] - o;
        a.deltas = shift(a.deltas, 2 * o);
        a.lens = shift(a.lens, 2 * o);
        a.seg_s = shift(a.seg_s, 4 * o);
        a.seg_e = shift(a.seg_e, 4 * o);
        a.keep = shift(a.keep, o);
    }
    if (a.bases) a.base = a.bases[b];
    if (b) {
        const long h = b * a.head_stride, t = b * a.tail_stride;
        a.hd = shift(a.hd, h);
        a.flags = shift(a.flags, h);
        a.delta = shift(a.delta, h);
        a.wsum = shift(a.wsum, h);
        a.wcnt = shift(a.wcnt, h);
        a.cbase = shift(a.cbase, t);
        a.marks = shift(a.marks, t);
        a.reach = shift(a.reach, t);
        a.sums += b * a.n_win;
        a.packed += b * a.ld_packed;
        a.depth_out = shift(a.depth_out, 4 * b * a.ld_pos);
        a.cls_out = shift(a.cls_out, b * a.ld_pos);
    }
    return a;
}

// Region clip of one segment, as _pipeline_body does it:
// s = clip(max(seg_start, rs) - w0, 0, length), e likewise with
// min(seg_end, re); keep-masked segments go to `length`.
__device__ __forceinline__ void clip_segment(int32_t ss, int32_t ee,
                                             bool keep, int32_t w0,
                                             int32_t rs, int32_t re,
                                             int32_t length, int32_t* s,
                                             int32_t* e) {
    int32_t a = (int32_t)((uint32_t)max(ss, rs) - (uint32_t)w0);
    int32_t b = (int32_t)((uint32_t)min(ee, re) - (uint32_t)w0);
    a = min(max(a, 0), length);
    b = min(max(b, 0), length);
    *s = keep ? a : length;
    *e = keep ? b : length;
}

// Where position k of a tile lives in shared memory: its 16-byte chunk
// XOR-ed with bits 3-4 of the chunk index. A thread owns 16 consecutive
// positions (four chunks, 64 bytes apart); without the swizzle a
// quarter-warp's 16-byte accesses would meet in two bank groups, four
// ways each, and the tile's zeroing, loading and storing would take four
// times the bank cycles. Consecutive positions stay within a 128-byte line.
__device__ __forceinline__ int sw(int k) { return k ^ ((k >> 5 & 3) << 2); }

// Launch A, u16 wire: absolute starts, two kinds of index marks, and
// n_live. For 0 <= g <= n_marks:
//   marks[g] = the first entry whose shard-relative start reaches g*GRAIN,
//   reach[g] = the first entry at which the furthest segment end so far
//              passes g*GRAIN (no segment before it can cover g*GRAIN);
// each written only where some entry before it has not yet got there
// (the rest is read off the header), by exactly one thread: starts and
// furthest ends are non-decreasing.
__global__ void __launch_bounds__(THREADS) wire_starts(TileArgs a0) {
    __shared__ unsigned int tile_sh;
    // each thread's prefixes and lengths, [k][thread]: out of registers
    // during the look-back, and read back without bank conflicts
    __shared__ uint32_t q_sh[PER_THREAD][THREADS];
    __shared__ uint16_t l_sh[PER_THREAD][THREADS];
    const TileArgs a = sample_args(a0);
    const uint16_t* deltas = a.deltas;
    const uint16_t* lens = a.lens;
    const long n = a.n;
    const int32_t base = a.base, w0 = a.w0;
    Header* hd = a.hd;
    int32_t* cbase = a.cbase;
    int32_t* marks = a.marks;
    int32_t* reach = a.reach;
    if (threadIdx.x == 0) tile_sh = atomicAdd(&hd->ticket, 1u);
    __syncthreads();
    const long tile = tile_sh;
    if (tile * CHUNK >= n) return;  // a tile this sample does not need
    const long i0 = tile * CHUNK + (long)PER_THREAD * threadIdx.x;
    uint32_t total, live = 0;
    int r_thr = -1;  // furthest end, relative to the tile's base start
    {
        uint32_t d[PER_THREAD], ln[PER_THREAD];
        load16_u16(deltas, i0, n, d);
        load16_u16(lens, i0, n, ln);
        uint32_t run = 0;
#pragma unroll
        for (int k = 0; k < PER_THREAD; k++) {
            run += d[k];
            d[k] = run;
            if (ln[k]) live = (uint32_t)(i0 + k + 1);
        }
        const uint32_t ex = block_excl_scan(run, &total);
#pragma unroll
        for (int k = 0; k < PER_THREAD; k++) {
            const uint32_t q = ex + d[k];
            q_sh[k][threadIdx.x] = q;
            l_sh[k][threadIdx.x] = (uint16_t)ln[k];
            if (i0 + k < n) r_thr = max(r_thr, (int)(q + ln[k]));
        }
    }
    int r_tile;
    const int r_ex = block_excl_max(r_thr, &r_tile);
    const Prefix pre = lookback(a.flags, tile, total,
                                max(r_tile - (int)total, 0));
    // the start of entry tile*CHUNK - 1 (base for tile 0)
    const uint32_t tile_base = (uint32_t)base + pre.s;
    const uint32_t rel0 = tile_base - (uint32_t)w0;
    // start of entry i0 - 1 (relative to the tile's base start)
    const uint32_t q_prev =
        threadIdx.x ? q_sh[PER_THREAD - 1][threadIdx.x - 1] : 0u;
    if ((i0 & 31) == 0 && i0 < n)  // this thread starts a 32-entry chunk
        cbase[i0 >> 5] = (int32_t)(tile_base + q_prev);
    const int32_t xp = (int32_t)(rel0 + q_prev);
    int rp = max(pre.d, r_ex);
    const int g_max = (int)a.n_marks;
    // the last mark passed by the start before, and the last mark at or
    // below the furthest end before (an arithmetic shift: floor division
    // by GRAIN); a mark is written where an entry moves past it
    int gx = xp >> GRAIN_SHIFT;
    int gy = ((int32_t)(rel0 + (uint32_t)rp) - 1) >> GRAIN_SHIFT;
#pragma unroll
    for (int k = 0; k < PER_THREAD; k++) {
        const long i = i0 + k;
        if (i >= n) break;
        const uint32_t q = q_sh[k][threadIdx.x];
        const uint32_t l = l_sh[k][threadIdx.x];
        const int32_t x = (int32_t)(rel0 + q);
        rp = max(rp, (int)(q + l));
        const int32_t y = (int32_t)(rel0 + (uint32_t)rp);
        const int nx = x >> GRAIN_SHIFT, ny = (y - 1) >> GRAIN_SHIFT;
        if (i == 0) {  // marks up to entry 0 are read off the header
            hd->x_first = x;
            hd->y_first = y;
        } else {  // mostly no mark or one: a store, not a loop
            if (nx == gx + 1) {
                if (nx >= 0 && nx <= g_max) marks[nx] = (int32_t)i;
            } else if (nx > gx) {
                for (int g = max(gx + 1, 0); g <= min(nx, g_max); g++)
                    marks[g] = (int32_t)i;
            }
            if (ny == gy + 1) {
                if (ny >= 0 && ny <= g_max) reach[ny] = (int32_t)i;
            } else if (ny > gy) {
                for (int g = max(gy + 1, 0); g <= min(ny, g_max); g++)
                    reach[g] = (int32_t)i;
            }
        }
        if (i == n - 1) {
            hd->x_last = x;
            hd->y_last = y;
        }
        gx = nx;
        gy = ny;
    }
    live = block_max(live);
    if (threadIdx.x == 0 && live) atomicMax(&hd->n_live, live);
}

// Launch 1 of the int32 wire: absolute endpoints + keep mask, ±1 per
// segment into the zeroed delta buffer (a segment whose clipped ends
// coincide adds nothing, so keep-masked padding costs no atomics).
__global__ void __launch_bounds__(THREADS) scatter_endpoints(TileArgs a0) {
    const TileArgs a = sample_args(a0);
    const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.n) return;
    int32_t s, e;
    clip_segment(a.seg_s[i], a.seg_e[i], a.keep[i] != 0, a.w0, a.rs, a.re,
                 (int32_t)a.length, &s, &e);
    if (s != e) {  // +1 and -1 at one index cancel
        atomicAdd(a.delta + s, 1);
        atomicAdd(a.delta + e, -1);
    }
}

// Depth and class of four consecutive positions from p (depth before
// the cap: off + v[r]), 2 bits each, low first; with MASK the region
// mask and the tile's end, else the caller knows all four are inside.
// Selects, not branches: a class branch diverges at every position.
template <bool MASK>
__device__ __forceinline__ uint32_t finish4(const TileArgs& a,
                                            const uint32_t* v, uint32_t off,
                                            long p, long hi, bool has_mm,
                                            int32_t* d4) {
    uint32_t bits = 0;
#pragma unroll
    for (int r = 0; r < 4; r++) {
        int32_t d = min((int32_t)(off + v[r]), a.cap);
        if (MASK) {
            const int32_t pos = (int32_t)((uint32_t)(p + r) + (uint32_t)a.w0);
            d = (pos < a.rs || pos >= a.re || p + r >= hi) ? 0 : d;
        }
        const uint32_t hi_cl = (has_mm && d >= a.max_mean) ? 3u : 2u;
        const uint32_t cl = d == 0 ? 0u : (d < a.min_cov ? 1u : hi_cl);
        bits |= cl << (2 * r);
        d4[r] = d;
    }
    return bits;
}

// Launch B: one block per tile of positions, PER_THREAD consecutive
// positions a thread (four packed class bytes).
template <bool WIRE16>
__global__ void __launch_bounds__(THREADS) depth_tiles(TileArgs a0) {
    const TileArgs a = sample_args(a0);
    __shared__ __align__(16) int32_t sh[TILE_MAX];
    __shared__ long range_sh[2];
    __shared__ unsigned int tile_sh;
    long t;
    if (WIRE16) {
        t = blockIdx.x;
    } else {
        if (threadIdx.x == 0) tile_sh = atomicAdd(&a.hd->ticket, 1u);
        __syncthreads();
        t = tile_sh;
    }
    const long lo = t * a.tile;
    const long hi = lo + a.tile < a.length ? lo + a.tile : a.length;
    const int base_k = PER_THREAD * threadIdx.x;
    const long p0 = lo + base_k;
    uint32_t v[PER_THREAD];

    if (WIRE16) {
        if (threadIdx.x == 0) {
            // the entries that can reach [lo, hi): from the first whose
            // furthest end passes the mark at or below lo, to the first
            // whose start reaches the mark at or above hi; one round trip
            long i0 = 0, i1 = 0;
            if (a.n > 0) {
                const long g0 = lo / GRAIN, g1 = (hi + GRAIN - 1) / GRAIN;
                const Header h = *a.hd;
                const long r0 = a.reach[g0], m1 = a.marks[g1];
                i0 = g0 * GRAIN < h.y_first ? 0
                     : (g0 * GRAIN >= h.y_last ? a.n : r0);
                i1 = g1 * GRAIN <= h.x_first ? 0
                     : (g1 * GRAIN > h.x_last ? a.n : m1);
                if (i1 > (long)h.n_live) i1 = h.n_live;
            }
            range_sh[0] = i0;
            range_sh[1] = i1;
        }
#pragma unroll
        for (int k = 0; k < 4; k++)
            *reinterpret_cast<int4*>(sh + sw(base_k + 4 * k)) =
                make_int4(0, 0, 0, 0);
        __syncthreads();
        const long i0 = range_sh[0], i1 = range_sh[1];
        const int32_t len32 = (int32_t)a.length;
        // a warp takes 32-entry chunks; a chunk's starts are its base
        // start plus a warp scan of its deltas; four chunks in flight
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        for (long c = (i0 >> 5) + warp; c << 5 < i1; c += 4 * NWARPS) {
            uint32_t dl[4], ln[4], cb[4];
#pragma unroll
            for (int u = 0; u < 4; u++) {  // all loads first
                const long cu = c + u * NWARPS, j = (cu << 5) + lane;
                const bool in = j < i1;
                dl[u] = in ? (uint32_t)a.deltas[j] : 0u;
                ln[u] = in ? (uint32_t)a.lens[j] : 0u;
                cb[u] = cu << 5 < i1 ? (uint32_t)a.cbase[cu] : 0u;
            }
#pragma unroll
            for (int u = 0; u < 4; u++) {
                const uint32_t st = cb[u] + warp_incl_scan(dl[u]);
                const long j = ((c + u * NWARPS) << 5) + lane;
                // gap filler, padding, before i0 or past i1
                if (!ln[u] || j < i0) continue;
                int32_t s, e;
                clip_segment((int32_t)st, (int32_t)(st + ln[u]), true, a.w0,
                             a.rs, a.re, len32, &s, &e);
                const long from = s > lo ? (long)s : lo;
                if (from < hi && from < e) {
                    atomicAdd(sh + sw((int)(from - lo)), 1);
                    if (e < hi) atomicAdd(sh + sw((int)(e - lo)), -1);
                }
            }
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < 4; k++) {
            const int4 x =
                *reinterpret_cast<const int4*>(sh + sw(base_k + 4 * k));
            v[4 * k] = x.x;
            v[4 * k + 1] = x.y;
            v[4 * k + 2] = x.z;
            v[4 * k + 3] = x.w;
        }
    } else {
        if (p0 + PER_THREAD <= hi) {
            const int4* q = reinterpret_cast<const int4*>(a.delta + p0);
#pragma unroll
            for (int k = 0; k < 4; k++) {
                const int4 x = q[k];
                v[4 * k] = x.x;
                v[4 * k + 1] = x.y;
                v[4 * k + 2] = x.z;
                v[4 * k + 3] = x.w;
            }
        } else {
#pragma unroll
            for (int k = 0; k < PER_THREAD; k++)
                v[k] = p0 + k < hi ? (uint32_t)a.delta[p0 + k] : 0u;
        }
    }

    uint32_t run = 0;
#pragma unroll
    for (int k = 0; k < PER_THREAD; k++) {
        run += v[k];
        v[k] = run;
    }
    uint32_t total;
    uint32_t off = block_excl_scan(run, &total);
    if (!WIRE16) off += lookback(a.flags, t, total, 0).s;

    // cap, region mask, classes, 2-bit pack, four positions at a time;
    // depth back into sh for the window sums (every thread has read its
    // deltas: the scan's barriers). A thread whose positions all lie in
    // the region (coordinates that cannot wrap) needs no mask.
    const bool full = p0 + PER_THREAD <= a.length;
    const long r_lo = (long)a.rs - a.w0, r_hi = (long)a.re - a.w0;
    const bool inside = (long)a.w0 + a.length <= 0x7fffffffL &&
                        p0 >= r_lo && p0 + PER_THREAD <= r_hi &&
                        p0 + PER_THREAD <= hi;
    const bool has_mm = a.max_mean > 0;
    uint32_t bytes = 0;
#pragma unroll
    for (int q = 0; q < 4; q++) {
        int32_t d4[4];
        const long p = p0 + 4 * q;
        bytes |= (inside ? finish4<false>(a, v + 4 * q, off, p, hi, has_mm, d4)
                         : finish4<true>(a, v + 4 * q, off, p, hi, has_mm,
                                         d4))
                 << (8 * q);
        if (p0 < hi) {
            const int4 x = make_int4(d4[0], d4[1], d4[2], d4[3]);
            *reinterpret_cast<int4*>(sh + sw(base_k + 4 * q)) = x;
            if (full && a.depth_out)
                reinterpret_cast<int4*>(a.depth_out + p0)[q] = x;
        }
    }
    if (p0 < hi) {
        if (full) {
            *reinterpret_cast<uint32_t*>(a.packed + p0 / 4) = bytes;
            if (a.cls_out) {
                uint32_t c[4];
#pragma unroll
                for (int j = 0; j < 4; j++) {
                    const uint32_t b = (bytes >> (8 * j)) & 0xffu;
                    c[j] = (b & 3u) | ((b >> 2 & 3u) << 8) |
                           ((b >> 4 & 3u) << 16) | ((b >> 6 & 3u) << 24);
                }
                *reinterpret_cast<uint4*>(a.cls_out + p0) =
                    make_uint4(c[0], c[1], c[2], c[3]);
            }
        } else {  // the shard's ragged end
            for (int k = 0; k < PER_THREAD && p0 + k < a.length; k++) {
                if (k % 4 == 0)
                    a.packed[(p0 + k) / 4] = (uint8_t)(bytes >> (2 * k));
                if (a.depth_out) a.depth_out[p0 + k] = sh[sw(base_k + k)];
                if (a.cls_out)
                    a.cls_out[p0 + k] = (int8_t)(bytes >> (2 * k) & 3u);
            }
        }
    }
    __syncthreads();

    // window sums, exact in int64, rounded once to float32
    const long W = a.window;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (a.wsum == nullptr) {  // the tile holds whole windows
        // tile-relative and 32-bit, and no division left to the threads:
        // a tile holds wpt windows (the last tile may hold fewer)
        const int Wi = (int)W;
        const long wbase = t * a.wpt;
        const int nloc = (int)(a.n_win - wbase < a.wpt ? a.n_win - wbase
                                                       : a.wpt);
        if (Wi <= 32) {
            for (int k = threadIdx.x; k < nloc; k += THREADS) {
                long long s = 0;
                for (int j = k * Wi; j < (k + 1) * Wi; j++) s += sh[sw(j)];
                a.sums[wbase + k] = __ll2float_rn(s);
            }
        } else {
            for (int k = warp; k < nloc; k += NWARPS) {
                long long s = 0;
                for (int j = k * Wi + lane; j < (k + 1) * Wi; j += 32)
                    s += sh[sw(j)];
#pragma unroll
                for (int o = 16; o > 0; o >>= 1)
                    s += __shfl_xor_sync(0xffffffffu, s, o);
                if (lane == 0) a.sums[wbase + k] = __ll2float_rn(s);
            }
        }
    } else {  // windows cross tiles: partial sums meet in global memory
        const long wf = lo / W, wl = (hi - 1) / W;
        for (long w = wf + warp; w <= wl; w += NWARPS) {
            const long jlo = (w * W > lo ? w * W : lo) - lo;
            const long jhi = ((w + 1) * W < hi ? (w + 1) * W : hi) - lo;
            long long s = 0;
            for (long j = jlo + lane; j < jhi; j += 32) s += sh[sw((int)j)];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                s += __shfl_xor_sync(0xffffffffu, s, o);
            if (lane == 0) {
                const long need =
                    ((w + 1) * W - 1) / a.tile - (w * W) / a.tile + 1;
                if (need == 1) {
                    a.sums[w] = __ll2float_rn(s);
                } else {
                    atomicAdd(a.wsum + w, (unsigned long long)s);
                    __threadfence();
                    const unsigned int c = atomicAdd(a.wcnt + w, 1u);
                    if (c == need - 1) {  // the last tile to arrive
                        __threadfence();
                        const unsigned long long tot =
                            atomicAdd(a.wsum + w, 0ull);
                        a.sums[w] = __ll2float_rn((long long)tot);
                    }
                }
            }
        }
    }
}

static inline long align16(long x) { return (x + 15) & ~15L; }

// Workspace layout: the zeroed part first (header, look-back flags, the
// int32 wire's delta buffer, wide windows' sums and arrival counts),
// then launch A's chunk base starts and both kinds of marks.
struct Layout {
    long flags, delta, wsum, wcnt, zeroed, cbase, marks, reach, total;
};

static Layout layout(int wire, long n, long length, long window,
                     long tile) {
    Layout l;
    const long n_tiles = (length + tile - 1) / tile;
    const long n_lb = wire ? (n + CHUNK - 1) / CHUNK : n_tiles;
    const bool wide = tile % window != 0;
    const long n_win = length / window;
    long off = align16(sizeof(Header));
    l.flags = off;
    off = align16(off + 8 * LB_STRIDE * (n_lb > 0 ? n_lb : 1));
    l.delta = off;
    if (!wire) off = align16(off + 4 * (length + 1));
    l.wsum = off;
    if (wide) off = align16(off + 8 * n_win);
    l.wcnt = off;
    if (wide) off = align16(off + 4 * n_win);
    l.zeroed = off;
    l.cbase = off;
    if (wire) off = align16(off + 4 * ((n + 31) / 32));
    const long n_marks = (length + GRAIN - 1) / GRAIN + 1;
    l.marks = off;
    if (wire) off = align16(off + 4 * n_marks);
    l.reach = off;
    if (wire) off = align16(off + 4 * n_marks);
    l.total = off;
    return l;
}

#define LAUNCH_CHECK()                                  \
    do {                                                \
        cudaError_t err_ = cudaGetLastError();          \
        if (err_ != cudaSuccess) return (int)err_;      \
    } while (0)

extern "C" {

// Bytes of the workspace of a batch of `batch` samples of at most n
// entries each; *zeroed receives how many of its first bytes the caller
// must zero (every sample's head).
long depth_workspace_bytes(int wire, long n, long length, long window,
                           long tile, long batch, long* zeroed) {
    const Layout l = layout(wire, n, length, window, tile);
    *zeroed = batch * l.zeroed;
    return batch * l.total;
}

// Enqueue the pipeline for a batch of `batch` samples over one region
// on `stream`; a single shard is a batch of one with offs NULL.
//   wire 0: a = int32 seg_start[], b = int32 seg_end[], keep = u8[]
//   wire 1: a = u16 deltas[], b = u16 lens[], keep unused; sample s
//           starts from bases[s] (base when bases is NULL)
// offs: int64[batch + 1] device offsets of each sample's entries in a, b
// and keep (NULL: one sample of n entries); n: the most entries of any
// sample (the workspace's layout). tile: positions a tile (a multiple of
// 16, at most 4,096); windows are summed inside their tile when
// tile % window == 0. ws: depth_workspace_bytes(...) bytes, 16-byte
// aligned, the first *zeroed of them zero. Row s of each output is
// sample s's: sums f32[batch][length/window], packed
// u8[batch][ld_packed], depth_out int32[batch][ld_pos] and cls_out
// int8[batch][ld_pos] (both may be NULL); rows 16-byte aligned, packed
// at least ceil(length/4) and the dense ones length wide. length must
// be a multiple of window. Returns 0 or the CUDA error code of the
// first failed launch.
int depth_pipeline_batch_launch(
    int wire, const void* a, const void* b, const uint8_t* keep,
    const long* offs, const int32_t* bases, long n, long batch,
    int32_t base, int32_t w0, int32_t rs, int32_t re, int32_t cap,
    int32_t min_cov, int32_t max_mean, long length, long window,
    long tile, void* ws, float* sums, uint8_t* packed, long ld_packed,
    int32_t* depth_out, int8_t* cls_out, long ld_pos, void* stream) {
    if (tile < 16 || tile > TILE_MAX || tile % 16 || length < 1 ||
        window < 1 || length % window || batch < 1 || batch > 65535 ||
        n < 0 || (batch > 1 && !offs))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const Layout l = layout(wire, n, length, window, tile);
    char* w = (char*)ws;
    char* tail = w + batch * l.zeroed - l.zeroed;  // sample 0's tail - zeroed
    const bool wide = tile % window != 0;
    TileArgs t;
    t.deltas = wire ? (const uint16_t*)a : nullptr;
    t.lens = wire ? (const uint16_t*)b : nullptr;
    t.seg_s = wire ? nullptr : (const int32_t*)a;
    t.seg_e = wire ? nullptr : (const int32_t*)b;
    t.keep = wire ? nullptr : keep;
    t.offs = offs;
    t.bases = wire ? bases : nullptr;
    t.n = n;
    t.base = base;
    t.hd = (Header*)w;
    t.flags = (unsigned long long*)(w + l.flags);
    t.delta = (int32_t*)(w + l.delta);
    t.wsum = wide ? (unsigned long long*)(w + l.wsum) : nullptr;
    t.wcnt = wide ? (unsigned int*)(w + l.wcnt) : nullptr;
    t.cbase = (int32_t*)(tail + l.cbase);
    t.marks = (int32_t*)(tail + l.marks);
    t.reach = (int32_t*)(tail + l.reach);
    t.head_stride = l.zeroed;
    t.tail_stride = l.total - l.zeroed;
    t.length = length;
    t.window = window;
    t.tile = tile;
    t.n_marks = (length + GRAIN - 1) / GRAIN;
    t.wpt = wide ? 0 : tile / window;
    t.n_win = length / window;
    t.w0 = w0;
    t.rs = rs;
    t.re = re;
    t.cap = cap;
    t.min_cov = min_cov;
    t.max_mean = max_mean;
    t.sums = sums;
    t.packed = packed;
    t.depth_out = depth_out;
    t.cls_out = cls_out;
    t.ld_packed = ld_packed;
    t.ld_pos = ld_pos;
    const dim3 tiles((unsigned)((length + tile - 1) / tile),
                     (unsigned)batch);
    if (wire) {
        if (n > 0) {
            wire_starts<<<dim3((unsigned)((n + CHUNK - 1) / CHUNK),
                               (unsigned)batch),
                          THREADS, 0, st>>>(t);
            LAUNCH_CHECK();
        }
        depth_tiles<true><<<tiles, THREADS, 0, st>>>(t);
        LAUNCH_CHECK();
    } else {
        if (n > 0) {
            scatter_endpoints<<<dim3((unsigned)((n + THREADS - 1) / THREADS),
                                     (unsigned)batch),
                                THREADS, 0, st>>>(t);
            LAUNCH_CHECK();
        }
        depth_tiles<false><<<tiles, THREADS, 0, st>>>(t);
        LAUNCH_CHECK();
    }
    return 0;
}

const char* depth_kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
