// Per-shard depth pipeline on Hopper (sm_90a): segment endpoints →
// per-base depth → cap + in-region mask → window sums + callable classes
// → 2-bit packed classes.
//
// Replaces the TPU kernel goleft_tpu/ops/pallas_coverage.py::pallas_depth
// (the per-base depth) together with the XLA epilogue of
// goleft_tpu/ops/depth_pipeline.py::_pipeline_body, so that only the
// window sums and the packed classes leave device memory.
//
// The TPU kernel sorted and bucketed endpoints per 1024-base tile on the
// host (the TPU has no cheap scatter) and carried the running depth
// across its sequential grid. A GPU has fast atomics and no sequential
// grid, so the design here is:
//   1. scatter ±1 per segment endpoint into a zeroed int32 delta buffer
//      with atomicAdd (endpoints arrive unsorted, as the pipeline makes
//      them; a segment whose clipped ends coincide adds nothing and is
//      skipped, so keep-masked padding costs no atomics);
//   2. inclusive scan of each 1024-element tile in shared memory
//      (warp-shuffle scan, block scan over warp totals), writing the tile
//      total;
//   3. one block scans the tile totals into per-tile carries;
//   4. a finishing pass adds the carry and fuses min(depth, cap), the
//      in-region mask, the window sums (int64, block-local in shared
//      memory, then one global atomic per window per block), the class
//      codes and the 2-bit pack (low bits first);
//   5. the int64 window sums are rounded once to float32.
// The packed u16 wire (sorted start deltas + lengths) runs steps 2-3 on
// the deltas first to rebuild absolute starts, fused into its scatter.
//
// What bounds it: bytes. A 10 Mb shard moves its 40 MB int32 delta
// buffer through device memory four times (zero, scatter, scan, finish)
// while the function's own inputs and outputs are 11 MB (u16 wire, 2 M
// segments) to 21 MB (int32 wire), so this simple design sits well above
// its bytes bound: chip_smoke.py measured 0.26 ms per shard on the u16
// wire against a bound of 0.0033 ms (NVIDIA H100 80GB HBM3, 700 W; see
// PERF.md). A single-pass look-back scan fused with the scatter is later
// work.
//
// Integer arithmetic that can wrap (start reconstruction, prefix sums,
// carries) is done in uint32 so that it wraps exactly like the int32
// arithmetic of the reference.
//
// Interface: plain C, loaded with ctypes (goleft_tpu_torch/ops/
// depth_kernel.py). The caller allocates every buffer; the launches go
// on the caller's stream and nothing synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 1024
#define TILE_THREADS 256  // 4 elements per thread
#define CARRY_THREADS 1024

__device__ __forceinline__ uint32_t warp_incl_scan(uint32_t v) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        uint32_t n = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += n;
    }
    return v;
}

// Exclusive scan of one value per thread over a block of NT threads;
// *total receives the block total. Every thread must call it.
template <int NT>
__device__ __forceinline__ uint32_t block_excl_scan(uint32_t v,
                                                    uint32_t* total) {
    __shared__ uint32_t warp_sums[NT / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    uint32_t incl = warp_incl_scan(v);
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        uint32_t w = lane < NT / 32 ? warp_sums[lane] : 0u;
        w = warp_incl_scan(w);
        if (lane < NT / 32) warp_sums[lane] = w;
    }
    __syncthreads();
    uint32_t prefix = warp ? warp_sums[warp - 1] : 0u;
    *total = warp_sums[NT / 32 - 1];
    __syncthreads();  // warp_sums may be reused by the next call
    return prefix + incl - v;
}

// Step 2: inclusive scan of each TILE-element tile of in[0, n) into out
// (in == out is allowed: each thread reads its elements before the
// block scan's barriers and writes only its own), tile totals to
// totals[tile]. Elements at or past n read as 0 and are not written.
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
tile_scan(const T* in, int32_t* out, int32_t* totals, long n) {
    const long base = (long)blockIdx.x * TILE + 4L * threadIdx.x;
    uint32_t a[4];
    uint32_t run = 0;
#pragma unroll
    for (int k = 0; k < 4; k++) {
        long i = base + k;
        run += i < n ? (uint32_t)in[i] : 0u;
        a[k] = run;
    }
    uint32_t total;
    uint32_t ex = block_excl_scan<TILE_THREADS>(run, &total);
#pragma unroll
    for (int k = 0; k < 4; k++) {
        long i = base + k;
        if (i < n) out[i] = (int32_t)(ex + a[k]);
    }
    if (threadIdx.x == 0) totals[blockIdx.x] = (int32_t)total;
}

// Step 3: tile totals → exclusive per-tile carries, in place, by one
// block walking the totals in chunks of CARRY_THREADS.
__global__ void __launch_bounds__(CARRY_THREADS)
scan_carries(int32_t* totals, long n_tiles) {
    uint32_t running = 0;
    for (long chunk = 0; chunk < n_tiles; chunk += CARRY_THREADS) {
        long i = chunk + threadIdx.x;
        uint32_t v = i < n_tiles ? (uint32_t)totals[i] : 0u;
        uint32_t total;
        uint32_t ex = block_excl_scan<CARRY_THREADS>(v, &total);
        if (i < n_tiles) totals[i] = (int32_t)(running + ex);
        running += total;
    }
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

__device__ __forceinline__ void scatter_one(int32_t* delta, int32_t s,
                                            int32_t e) {
    if (s != e) {  // +1 and -1 at one index cancel
        atomicAdd(delta + s, 1);
        atomicAdd(delta + e, -1);
    }
}

// Step 1, int32 wire: absolute endpoints + keep mask.
__global__ void __launch_bounds__(TILE_THREADS)
scatter_endpoints(const int32_t* seg_s, const int32_t* seg_e,
                  const uint8_t* keep, long n, int32_t w0, int32_t rs,
                  int32_t re, int32_t length, int32_t* delta) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int32_t s, e;
    clip_segment(seg_s[i], seg_e[i], keep[i] != 0, w0, rs, re, length, &s,
                 &e);
    scatter_one(delta, s, e);
}

// Step 1, u16 wire: start = base + inclusive prefix of the deltas
// (tile partials + carries from steps 2-3 on the deltas), end = start +
// len, keep = len > 0 (zero-length entries are padding/gap fillers).
__global__ void __launch_bounds__(TILE_THREADS)
scatter_wire(const uint16_t* lens, const int32_t* start_partial,
             const int32_t* start_carry, long n, int32_t base, int32_t w0,
             int32_t rs, int32_t re, int32_t length, int32_t* delta) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t st = (uint32_t)base + (uint32_t)start_partial[i] +
                  (uint32_t)start_carry[i / TILE];
    uint32_t ln = lens[i];
    int32_t s, e;
    clip_segment((int32_t)st, (int32_t)(st + ln), ln > 0, w0, rs, re,
                 length, &s, &e);
    scatter_one(delta, s, e);
}

// Step 4: one block per tile, 4 consecutive positions per thread (one
// packed class byte). `partial` holds the tile-local inclusive scan and
// is readable through the end of the last tile.
__global__ void __launch_bounds__(TILE_THREADS)
finish_tiles(const int32_t* partial, const int32_t* carry, long length,
             long window, int32_t w0, int32_t rs, int32_t re,
             int32_t cap, int32_t min_cov, int32_t max_mean,
             unsigned long long* wsum, uint8_t* packed,
             int32_t* depth_out, int8_t* cls_out) {
    __shared__ unsigned long long acc[TILE + 2];
    const long tile_lo = (long)blockIdx.x * TILE;
    const long tile_hi = tile_lo + TILE < length ? tile_lo + TILE : length;
    const long wlo = tile_lo / window;
    const long nloc = (tile_hi - 1) / window - wlo + 1;
    for (long i = threadIdx.x; i < nloc; i += blockDim.x) acc[i] = 0ull;
    __syncthreads();

    const uint32_t c = (uint32_t)carry[blockIdx.x];
    const long p0 = tile_lo + 4L * threadIdx.x;
    const int4 part = *reinterpret_cast<const int4*>(partial + p0);
    const int32_t raw[4] = {part.x, part.y, part.z, part.w};
    uint32_t byte = 0;
    long long cur_w = -1;
    bool one_window = true;
    unsigned long long run = 0;
#pragma unroll
    for (int k = 0; k < 4; k++) {
        const long p = p0 + k;
        if (p < length) {
            int32_t d = (int32_t)((uint32_t)raw[k] + c);
            d = min(d, cap);
            const int32_t pos = (int32_t)((uint32_t)p + (uint32_t)w0);
            if (pos < rs || pos >= re) d = 0;
            const int32_t cl =
                d == 0 ? 0
                       : (d < min_cov ? 1
                                      : ((max_mean > 0 && d >= max_mean)
                                             ? 3 : 2));
            byte |= (uint32_t)cl << (2 * k);
            if (depth_out) depth_out[p] = d;
            if (cls_out) cls_out[p] = (int8_t)cl;
            const long long w = p / window;
            if (w != cur_w) {
                if (cur_w >= 0) {
                    atomicAdd(&acc[cur_w - wlo], run);
                    one_window = false;
                }
                cur_w = w;
                run = 0;
            }
            run += (unsigned long long)(long long)d;
        }
    }
    if (p0 < length) packed[p0 / 4] = (uint8_t)byte;

    // Where the whole warp's positions fall in one window (the common
    // case for windows of 128 bases and more), reduce over the warp
    // and add once; otherwise each thread adds its own run.
    const long long w_lane0 = __shfl_sync(0xffffffffu, cur_w, 0);
    const bool uniform = __all_sync(
        0xffffffffu, p0 + 3 < length && one_window && cur_w == w_lane0);
    if (uniform) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            run += __shfl_down_sync(0xffffffffu, run, o);
        if ((threadIdx.x & 31) == 0) atomicAdd(&acc[cur_w - wlo], run);
    } else if (cur_w >= 0) {
        atomicAdd(&acc[cur_w - wlo], run);
    }
    __syncthreads();
    for (long i = threadIdx.x; i < nloc; i += blockDim.x)
        if (acc[i]) atomicAdd(wsum + wlo + i, acc[i]);
}

// Step 5: exact int64 window sums → float32, rounded once.
__global__ void sums_to_f32(const unsigned long long* wsum, float* sums,
                            long n_win) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n_win) sums[i] = __ll2float_rn((long long)wsum[i]);
}

static inline unsigned blocks_for(long n, int threads) {
    return (unsigned)((n + threads - 1) / threads);
}

#define LAUNCH_CHECK()                                  \
    do {                                                \
        cudaError_t err_ = cudaGetLastError();          \
        if (err_ != cudaSuccess) return (int)err_;      \
    } while (0)

extern "C" {

// Enqueue the whole pipeline for one shard on `stream`.
//   wire 0: a = int32 seg_start[n], b = int32 seg_end[n], keep = u8[n]
//   wire 1: a = u16 deltas[n], b = u16 lens[n], keep unused, base used;
//           wire_scan int32[n] and wire_carry int32[ceil(n/TILE)] scratch
// delta: int32, ZEROED, >= ceil(length/TILE)*TILE + 4 entries (the
// finishing pass reads whole tiles); tile_carry: int32[ceil(length/TILE)];
// wsum: u64[length/window], ZEROED; sums: f32[length/window];
// packed: u8[ceil(length/4)]; depth_out (int32[length]) and cls_out
// (int8[length]) may be NULL. length must be a multiple of window.
// Returns 0 or the CUDA error code of the first failed launch.
int depth_pipeline_launch(int wire, const void* a, const void* b,
                          const uint8_t* keep, long n, int32_t base,
                          int32_t w0, int32_t rs, int32_t re, int32_t cap,
                          int32_t min_cov, int32_t max_mean, long length,
                          long window, int32_t* delta, int32_t* tile_carry,
                          int32_t* wire_scan, int32_t* wire_carry,
                          unsigned long long* wsum, float* sums,
                          uint8_t* packed, int32_t* depth_out,
                          int8_t* cls_out, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const long n_tiles = (length + TILE - 1) / TILE;
    const int32_t len32 = (int32_t)length;
    if (n > 0) {
        if (wire == 0) {
            scatter_endpoints<<<blocks_for(n, TILE_THREADS), TILE_THREADS,
                                0, st>>>(
                (const int32_t*)a, (const int32_t*)b, keep, n, w0, rs, re,
                len32, delta);
            LAUNCH_CHECK();
        } else {
            const long wt = (n + TILE - 1) / TILE;
            tile_scan<uint16_t><<<(unsigned)wt, TILE_THREADS, 0, st>>>(
                (const uint16_t*)a, wire_scan, wire_carry, n);
            LAUNCH_CHECK();
            scan_carries<<<1, CARRY_THREADS, 0, st>>>(wire_carry, wt);
            LAUNCH_CHECK();
            scatter_wire<<<blocks_for(n, TILE_THREADS), TILE_THREADS, 0,
                           st>>>(
                (const uint16_t*)b, wire_scan, wire_carry, n, base, w0, rs,
                re, len32, delta);
            LAUNCH_CHECK();
        }
    }
    tile_scan<int32_t><<<(unsigned)n_tiles, TILE_THREADS, 0, st>>>(
        delta, delta, tile_carry, length);
    LAUNCH_CHECK();
    scan_carries<<<1, CARRY_THREADS, 0, st>>>(tile_carry, n_tiles);
    LAUNCH_CHECK();
    finish_tiles<<<(unsigned)n_tiles, TILE_THREADS, 0, st>>>(
        delta, tile_carry, length, window, w0, rs, re, cap, min_cov,
        max_mean, wsum, packed, depth_out, cls_out);
    LAUNCH_CHECK();
    const long n_win = length / window;
    sums_to_f32<<<blocks_for(n_win, 256), 256, 0, st>>>(wsum, sums, n_win);
    LAUNCH_CHECK();
    return 0;
}

const char* depth_kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
