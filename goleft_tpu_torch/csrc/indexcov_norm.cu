// indexcov's cross-sample normalisation, pass 2: normalise and 7-tap
// smooth every sample lane of a chromosome's (samples x bins) depth
// matrix, given the per-bin cohort scalars (m, skip) of the host's f64
// pass 1 (cohort/streaming.py::NormStats).
//
// Replaces the JAX package's cohort/streaming.py:156 apply_normalization,
// a jax.lax.scan over the bin axis (no Pallas kernel). Per lane, bin by
// bin, with p0..p2 the lane's three previous outputs and r1..r3 its next
// three raw values (0 past the matrix):
//   scaled   = valid_j ? col / m : col
//   smoothed = ((((((p0 + p1) + p2) + scaled) + r1/m) + r2/m) + r3/m) * k7
//   out      = skip ? col : (valid_j && j > 2 && j < len - 3 ? smoothed
//                                                             : scaled)
// The reference's source divides the sum by 7.0; XLA's algebraic
// simplifier rewrites that as a multiply by float32(1/7), so the
// reference's answer, which the port follows, is the multiply by
// k7 = 0x1.24924ap-3f. (Pass 1, NormStats, is the reference's numpy and
// keeps its f64 division by 7.0.)
//
// Bounds at chr1 x 2,504 samples (15,195 bins of 16 KB):
// - bytes: each input read once, each output written once, 8 bytes a
//   cell: 304 MB, 0.091 ms at 3.35 TB/s;
// - the dependence chain: o_j depends on o_{j-1} (as p2) through five
//   adds, the multiply by k7 and the select, about 7 x 4 = 28 cycles a
//   bin (assumed, not measured): 15,195 x 28 cycles = 0.21 ms at
//   1.98 GHz, whatever the number of lanes. It is the larger bound and
//   the one this design aims at. The bin axis cannot be split: a second
//   segment would need the first's three outputs, and any split of the
//   recurrence (an associative scan) reassociates the f32 sums, which
//   would not be the reference's bits.
//
// Design: a block per 32 sample lanes (ceil(n / 32) blocks). Warp 0 is
// the chain warp, lane = sample; it does only the chain: per bin one
// 16-byte shared load (f, q1, q2, q3), five adds, the multiply and a
// select, and one shared store of the output. The kProducers producer
// warps do everything that does not depend on the carry, kTile bins at
// a time. Each owns a few (row, 32-bin chunk) items of every tile, lane =
// bin:
// - they copy the raw tile (and its 3 look-ahead bins, 0 past b) with
//   4-byte cp.async, coalesced along the bins, into a ring of
//   kLoadStages raw stages laid out [bin][lane] in rows of 33 floats
//   (distinct banks for both sides), three tiles ahead; m and skip come
//   with them. No register holds a load in flight;
// - they compute per cell, with IEEE division: f = skip ? col : scaled,
//   q1..q3 = r1/m, r2/m, r3/m, and the flag use = !skip && valid && 2 < j
//   < len - 3 (a ballot: one word a chunk and lane). Where the chain
//   smooths, f is scaled; where it does not, the sum is discarded, so f
//   stands in for scaled in the sum;
// - they store the cells into the chain's ring of kStages stages as
//   [bin][lane] float4s, rows of 33: a quarter warp's 16-byte stores
//   (lane = bin) fall in distinct banks, and the chain's loads (lane =
//   sample) are contiguous;
// - after the chain is done with a stage they copy its [bin][lane] output
//   tile (rows of 33 floats) back coalesced along the bins, then refill.
// The four divisions of a cell share one IEEE reciprocal of m (div_by),
// and 15 producer warps hide the latency that is left. Measured on an
// H100, the producers' instruction issue (about 125 warp instructions a
// 32-cell item, four schedulers a block), not the chain, sets the pace:
// PERF.md section 6.
// Named barriers hand each chain stage over: FULL(s) (producers arrive,
// the chain waits) and DONE(s) (the chain arrives, producers wait); the
// producers' own barrier orders each raw stage's copies and its reuse.
// TMA is not used: a row pitch of b x 4 bytes is not a multiple of 16
// for most b.
//
// Arithmetic is the reference's order, operation by operation, with IEEE
// quotients (div_by's, or nvcc's default -prec-div=true division) and
// built with -fmad=false, so the kernel is bitwise equal to its plain
// PyTorch version (ops/norm_kernel.py::apply_normalization_plain). Rows
// past n are zero-filled in shared memory, read nothing from global
// memory and are never written back.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;                  // sample lanes a block
constexpr int kTile = 64;                   // bins a stage
constexpr int kChunks = kTile / 32;         // 32-bin chunks of a tile row
constexpr int kProducers = 15;              // producer warps a block
constexpr int kThreads = 32 * (1 + kProducers);
constexpr int kItems = kLanes * kChunks;    // (row, chunk) items a tile
constexpr int kPerWarp = (kItems + kProducers - 1) / kProducers;
constexpr int kStages = 4;                  // the chain's ring
constexpr int kLoadStages = 4;              // raw tiles in flight: 3 ahead
constexpr int kProducerBar = 1 + 2 * kStages;  // after FULL(s), DONE(s)
constexpr float kInv7 = 0x1.24924ap-3f;     // float32(1/7)

// a raw tile as cp.async lands it: [bin][lane], 3 look-ahead bins
struct RawStage {
    float raw[kTile + 3][kLanes + 1];
    float m[kTile];
    uint8_t skip[kTile];
};
// what the chain reads and writes
struct Stage {
    float4 v[kTile][kLanes + 1];    // (f, q1, q2, q3), [bin][lane]
    float out[kTile][kLanes + 1];   // the chain's outputs, [bin][lane]
    uint32_t use[kChunks][kLanes];  // bit u: bin 32 c + u smooths
};
constexpr int kRawBytes = (int)sizeof(RawStage);
constexpr int kStageBytes = (int)sizeof(Stage);
constexpr int kSmemBytes = kStages * kStageBytes + kLoadStages * kRawBytes;

__device__ __forceinline__ int full_id(int s) { return 1 + s; }
__device__ __forceinline__ int done_id(int s) { return 1 + kStages + s; }

__device__ __forceinline__ void bar_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
    asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// 4 bytes global -> shared, of which the first `bytes` are read and the
// rest zero-filled
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 ::"r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// this thread's copies of all but the newest kLoadStages - 2 groups done
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(kLoadStages - 2)
                 : "memory");
}

// IEEE division, one branch a cell instead of one a quotient. nvcc's
// div.rn.f32 is MUFU.RCP, five FFMAs and an FCHK range check whose
// failure calls a slow path, and the branch keeps ptxas from overlapping
// two divisions; with it the kernel took 1.8x as long on an H100
// (PERF.md section 6). A cell's four quotients share the divisor m, so
// they share r = RN(1/m) (__frcp_rn, IEEE); then q0 = RN(x r), e =
// RN(x - m q0) and RN(q0 + r e). q0 need not be faithful (x = 2 - 2^-22,
// m = 2 - 2^-23 gives q0 = 1), but |q0 + r e - x/m| < 2^-46 for x, m in
// [1, 2), so the result is the IEEE quotient unless x/m lies that close
// to a float32 midpoint; every such pair, for every mantissa of m, is
// checked on the CPU (tests/test_torch_indexcov_norm.py::
// test_div_by_is_ieee_division_near_every_midpoint). Powers of two scale
// every step exactly wherever nothing overflows, underflows or turns
// subnormal: m and x in [2^-60, 2^61), or x = +0 (div_fast). Any other
// operand (m <= 0, a negative or -0 depth, extremes, NaN) takes the
// compiler's division.
__device__ __forceinline__ bool div_fast(float x, bool zero_ok) {
    const unsigned u = __float_as_uint(x);
    return (u - 0x21800000u < 0x3c800000u) | (zero_ok & (u == 0u));
}

__device__ __forceinline__ float div_by(float x, float m, float r) {
    const float q0 = __fmaf_rn(x, r, 0.f);
    return __fmaf_rn(r, __fmaf_rn(-m, q0, x), q0);
}

// warp 0: the recurrence, lane = sample. The loads of the next 8 bins
// are issued before this 8's stores: the compiler cannot tell the output
// stores from the cell loads apart, so it would otherwise keep each load
// behind the previous bin's store, on the chain.
__device__ __forceinline__ void chain(Stage* ring, int tiles, int lane) {
    constexpr int kBatch = 8;
    float p0 = 0.f, p1 = 0.f, p2 = 0.f;
    for (int t = 0; t < tiles; ++t) {
        const int s = t % kStages;
        Stage& st = ring[s];
        bar_sync(full_id(s), kThreads);
        uint32_t use[kChunks];
#pragma unroll
        for (int c = 0; c < kChunks; ++c) use[c] = st.use[c][lane];
        float4 cur[kBatch], nxt[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) cur[u] = st.v[u][lane];
#pragma unroll
        for (int j0 = 0; j0 < kTile; j0 += kBatch) {
            if (j0 + kBatch < kTile) {
#pragma unroll
                for (int u = 0; u < kBatch; ++u)
                    nxt[u] = st.v[j0 + kBatch + u][lane];
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
                const int j = j0 + u;
                const float4 v = cur[u];
                float sm = p0 + p1;
                sm = sm + p2;
                sm = sm + v.x;
                sm = sm + v.y;
                sm = sm + v.z;
                sm = sm + v.w;
                sm = sm * kInv7;
                const float o = ((use[j / 32] >> (j % 32)) & 1u) ? sm : v.x;
                st.out[j][lane] = o;
                p0 = p1;
                p1 = p2;
                p2 = o;
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u) cur[u] = nxt[u];
        }
        bar_arrive(done_id(s), kThreads);
    }
}

// warps 1..kProducers: copies, divisions, flags and write-back. Item k
// of producer warp pw is (row, 32-bin chunk) pw + kProducers k of a tile,
// the same every tile; lane = bin. Rows past n are copied as zeros and
// computed, but never written back.
__device__ __forceinline__ void produce(
    RawStage* raws, Stage* ring, const float* __restrict__ depths,
    const int32_t* __restrict__ lengths, const float* __restrict__ m_all,
    const uint8_t* __restrict__ skip_all, float* __restrict__ out, int n,
    int b, int tiles, int pw, int lane) {
    // the last item exists for the first kItems - kProducers (kPerWarp-1)
    // warps only (warp-uniform)
    const int items = pw + kProducers * (kPerWarp - 1) < kItems
                          ? kPerWarp : kPerWarp - 1;
    const float* src[kPerWarp];   // the item's row at its lane's bin
    float* dst[kPerWarp];
    int row_of[kPerWarp], jt_of[kPerWarp], len[kPerWarp];
    bool live[kPerWarp];
#pragma unroll
    for (int k = 0; k < kPerWarp; ++k) {
        const int idx = min(pw + kProducers * k, kItems - 1);
        const int r = idx % kLanes;
        const int s = blockIdx.x * kLanes + r;
        live[k] = s < n;  // warp-uniform
        row_of[k] = r;
        jt_of[k] = idx / kLanes * 32 + lane;
        len[k] = live[k] ? lengths[s] : 0;
        const size_t off = live[k] ? (size_t)s * (size_t)b : 0;
        src[k] = depths + off + jt_of[k];
        dst[k] = out + off + jt_of[k];
    }
    // tile t's raw values (0 past b and past n), m and skip into its load
    // stage
    auto load = [&](int t) {
        RawStage& rs = raws[t % kLoadStages];
        const int j0 = t * kTile;
#pragma unroll
        for (int k = 0; k < kPerWarp; ++k) {
            if (k == kPerWarp - 1 && items < kPerWarp) break;
            const bool in = live[k] && j0 + jt_of[k] < b;
            cp_async4(&rs.raw[jt_of[k]][row_of[k]], in ? src[k] + j0 : depths,
                      in ? 4 : 0);
            if (jt_of[k] >= kTile - 32 && lane < 3) {  // the look-ahead
                const bool ina = live[k] && j0 + kTile + lane < b;
                cp_async4(&rs.raw[kTile + lane][row_of[k]],
                          ina ? src[k] - jt_of[k] + j0 + kTile + lane : depths,
                          ina ? 4 : 0);
            }
        }
        if (pw == 0) {
#pragma unroll
            for (int c = 0; c < kChunks; ++c) {
                const int j = j0 + c * 32 + lane;
                cp_async4(&rs.m[c * 32 + lane], j < b ? m_all + j : m_all,
                          j < b ? 4 : 0);
            }
        } else if (pw == 1 && lane < kTile / 4) {
            const int j = j0 + 4 * lane;
            const int left = b - j;
            cp_async4(&rs.skip[4 * lane], left > 0 ? skip_all + j : skip_all,
                      left >= 4 ? 4 : left > 0 ? left : 0);
        }
    };
    auto write_back = [&](int t) {
        const Stage& st = ring[t % kStages];
        const int j0 = t * kTile;
#pragma unroll
        for (int k = 0; k < kPerWarp; ++k) {
            if (k == kPerWarp - 1 && items < kPerWarp) break;
            const float o = st.out[jt_of[k]][row_of[k]];
            if (live[k] && j0 + jt_of[k] < b) dst[k][j0] = o;
        }
    };
    for (int t = 0; t < kLoadStages - 1; ++t) {
        if (t < tiles) load(t);
        cp_async_commit();
    }
    for (int t = 0; t < tiles; ++t) {
        // this tile's copies landed, every producer's; every producer is
        // done with tile t - 1, whose load stage the next copies refill
        cp_async_wait();
        bar_sync(kProducerBar, 32 * kProducers);
        if (t + kLoadStages - 1 < tiles) load(t + kLoadStages - 1);
        cp_async_commit();
        const int s = t % kStages;
        if (t >= kStages) {
            bar_sync(done_id(s), kThreads);
            write_back(t - kStages);
        }
        const RawStage& rs = raws[t % kLoadStages];
        Stage& st = ring[s];
        const int j0 = t * kTile;
        unsigned slow = 0;  // items of this lane outside div_fast
#pragma unroll
        for (int k = 0; k < kPerWarp; ++k) {
            if (k == kPerWarp - 1 && items < kPerWarp) break;
            const int r = row_of[k], jt = jt_of[k], j = j0 + jt;
            const float x = rs.raw[jt][r], x1 = rs.raw[jt + 1][r];
            const float x2 = rs.raw[jt + 2][r], x3 = rs.raw[jt + 3][r];
            const float m = rs.m[jt];
            const bool sk = rs.skip[jt] != 0;
            const bool valid = len[k] > j;
            const float rm = __frcp_rn(m);
            float4 v;
            v.x = sk | !valid ? x : div_by(x, m, rm);
            v.y = div_by(x1, m, rm);
            v.z = div_by(x2, m, rm);
            v.w = div_by(x3, m, rm);
            st.v[jt][r] = v;
            // bitwise, not short-circuit: no branch
            const bool fast = div_fast(m, false) & div_fast(x, true) &
                              div_fast(x1, true) & div_fast(x2, true) &
                              div_fast(x3, true);
            slow |= (fast ? 0u : 1u) << k;
            const bool use = !sk & valid & (j > 2) & (j < len[k] - 3);
            const uint32_t mask = __ballot_sync(0xffffffffu, use);
            if (lane == 0) st.use[jt / 32][r] = mask;
        }
        if (slow) {  // rare: m = 0, the bins past b, extreme values
#pragma unroll
            for (int k = 0; k < kPerWarp; ++k) {
                if (!((slow >> k) & 1u)) continue;
                const int r = row_of[k], jt = jt_of[k];
                const float x = rs.raw[jt][r], m = rs.m[jt];
                float4 v;
                v.x = rs.skip[jt] || len[k] <= j0 + jt ? x : x / m;
                v.y = rs.raw[jt + 1][r] / m;
                v.z = rs.raw[jt + 2][r] / m;
                v.w = rs.raw[jt + 3][r] / m;
                st.v[jt][r] = v;
            }
        }
        bar_arrive(full_id(s), kThreads);
    }
    for (int t = tiles > kStages ? tiles - kStages : 0; t < tiles; ++t) {
        bar_sync(done_id(t % kStages), kThreads);
        write_back(t);
    }
}

__global__ void __launch_bounds__(kThreads, 1)
norm_scan_kernel(const float* __restrict__ depths,
                 const int32_t* __restrict__ lengths,
                 const float* __restrict__ m_all,
                 const uint8_t* __restrict__ skip_all,
                 float* __restrict__ out, int n, int b) {
    extern __shared__ __align__(16) unsigned char smem[];
    Stage* ring = reinterpret_cast<Stage*>(smem);
    RawStage* raws =
        reinterpret_cast<RawStage*>(smem + (size_t)kStages * kStageBytes);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int tiles = (b + kTile - 1) / kTile;
    if (warp == 0)
        chain(ring, tiles, lane);
    else
        produce(raws, ring, depths, lengths, m_all, skip_all, out, n, b,
                tiles, warp - 1, lane);
}

}  // namespace

extern "C" {

// depths (n, b) f32 row-major, lengths (n,) i32, m (b,) f32, skip (b,) u8,
// out (n, b) f32; launches on ``stream`` with the wrapper's launch plan
// (ops/norm_kernel.py::launch_plan), which must be this build's: blocks
// = ceil(n / 32), threads = 32 x (1 + producer warps), tile_bins, stages,
// load_stages, smem_bytes. ``skip`` must be 4-byte aligned (the wrapper
// copies a view that is not). Returns the
// cudaError_t of the launch (0 = launched; nothing is launched for an
// empty matrix; cudaErrorInvalidValue for another plan or a misaligned
// skip).
int indexcov_norm_launch(const float* depths, const int32_t* lengths,
                         const float* m, const uint8_t* skip, float* out,
                         int n, int b, int blocks, int threads,
                         int tile_bins, int stages, int load_stages,
                         int smem_bytes, void* stream) {
    if (n <= 0 || b <= 0) return 0;
    if (blocks != (n + kLanes - 1) / kLanes || threads != kThreads ||
        tile_bins != kTile || stages != kStages ||
        load_stages != kLoadStages || smem_bytes != kSmemBytes ||
        (uintptr_t)skip % 4 != 0)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        norm_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    norm_scan_kernel<<<blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
        depths, lengths, m, skip, out, n, b);
    return (int)cudaGetLastError();
}

const char* indexcov_norm_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
