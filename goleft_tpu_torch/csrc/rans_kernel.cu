// rANS-Nx16 entropy decode on Hopper (sm_90a): the ORDER0 and ORDER1
// rANS stage of CRAM 3.1 block method 5, one stream per warp.
//
// Replaces the TPU kernel goleft_tpu/ops/rans_device.py::pallas_decode0
// (the ORDER0 rANS stage) and also carries the ORDER1 branch of the XLA
// scan goleft_tpu/ops/rans_device.py::_decode_bucket_impl, written from
// that function. The RLE / PACK expansions and the STRIPE interleave stay
// PyTorch ops around it (ops/rans_device.py), as the JAX package left them
// to XLA outside its Pallas kernel.
//
// An Nx16 stream is N (4 or 32) interleaved rANS states that share one
// byte stream. One round advances every active state once:
//   1. m = R & (2^shift - 1) picks a slot;
//   2. x = f * (R >> shift) + bias, with the slot's symbol, frequency and
//      bias (uint32, as the XLA scan does);
//   3. a lane with x < 2^15 that is granted reads a little-endian 16-bit
//      word at pos + 2*rank, rank = the earlier lanes of this round that
//      renormalise; a lane is granted while rank < (plen - pos)/2, so a
//      denied lane denies every later lane of the round (the scalar
//      decoder's bytes-left guard);
//   4. pos advances by twice the number of granted lanes;
//   5. the symbol is written.
// ORDER0 lanes are active while r*N + lane < inner_len (round robin).
// ORDER1 lane j decodes the contiguous slice [j*F, (j+1)*F), F =
// inner_len / N, the last lane carrying the tail; each lane's previous
// symbol (0 at the start) is its context, mapped to a table row by
// ctx_index; a context absent from the table on an active lane sets the
// missing-context diagnostic, which the caller raises as the host's error.
//
// Design. Layout: one warp per stream (grid = B streams), lane j = state
// j, so N <= 32 always holds. The rank is __popc(ballot & lanemask_lt)
// and the round's count __popc(ballot), replacing the cumsum. Symbols go
// straight to linear order (ORDER1 needs no post-scan gather), and the
// warp zero-fills its row from inner_len to the row's end, so the whole
// output is defined.
//   ORDER0 tables: the warp expands the shipped freq[256] row into a
//   4096-slot table in shared memory (16 KB), one uint32 per slot packing
//   sym | (freq-1) << 8 | bias << 20: a valid table (cum[256] = 4096,
//   checked by the parser) gives every slot a symbol of freq >= 1.
//   ORDER1 tables: n_ctx_cap x 2^shift expanded slots do not fit in
//   shared memory (5 MB per stream at 256 contexts and shift 12), so the
//   warp builds the compact cumulative rows (n_ctx_cap x (n_ctx_cap+1)
//   uint16, at most 132 KB of dynamic shared memory) and each lane binary-
//   searches its context's row every round: the largest column k with
//   cum[k] <= m, which is the XLA scan's searchsorted. Expanding the
//   slots into device memory first would cost a pass over up to megabytes
//   per stream and a device-memory load in every round's dependent chain;
//   the search keeps the chain in shared memory.
//
// What bounds it: the dependent chain, not bytes. Every round of a stream
// depends on the previous one (states and the read pointer), so a stream
// of R rounds takes R times one round's latency: slot load (shared),
// multiply-add, ballot, 16-bit payload load. A 10,000-record CRAM
// container's 1.5 MB quality block at N = 4 is 375,000 rounds in one
// warp, while the launch holds only as many warps as the container has
// rANS blocks. PERF.md gives both bounds and the measured times.
//
// Interface: plain C, loaded with ctypes (goleft_tpu_torch/ops/
// rans_kernel.py). The caller allocates every buffer; the launch goes on
// the caller's stream and nothing synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

#define RANS_LOW 32768u
#define TF_SHIFT 12
#define TOTFREQ 4096
#define MAX_CTX 256

__device__ __forceinline__ uint32_t lanemask_lt() {
    uint32_t m;
    asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
    return m;
}

// Steps 3-4 of a round for every lane of the warp (inactive lanes pass
// want = false). Returns the renormalised state; advances pos.
__device__ __forceinline__ uint32_t renorm(uint32_t x, bool want,
                                           const uint8_t* __restrict__ pay,
                                           int32_t plen, int32_t& pos) {
    const uint32_t wmask = __ballot_sync(0xffffffffu, want);
    const int32_t rank = __popc(wmask & lanemask_lt());
    const int32_t avail = (plen - pos) / 2;  // pos <= plen always holds
    const bool need = want && rank < avail;
    if (need) {
        const int32_t off = pos + 2 * rank;  // off + 1 < plen
        const uint32_t b0 = __ldg(pay + off);
        const uint32_t b1 = __ldg(pay + off + 1);
        x = (x << 16) | b0 | (b1 << 8);
    }
    const int32_t total = __popc(wmask);
    pos += 2 * (total < avail ? total : (avail > 0 ? avail : 0));
    return x;
}

__device__ __forceinline__ void zero_tail(uint8_t* row, long from,
                                          long to) {
    for (long p = from + (threadIdx.x & 31); p < to; p += 32) row[p] = 0;
}

// ORDER0: grid (B,), block (32,).
__global__ void __launch_bounds__(32)
rans_order0(const uint8_t* __restrict__ payload, long p_stride,
            const int32_t* __restrict__ plen,
            const uint32_t* __restrict__ states,
            const int16_t* __restrict__ freq,
            const int32_t* __restrict__ inner_len, int n_states,
            uint8_t* __restrict__ out, long out_stride) {
    __shared__ uint32_t slot[TOTFREQ];
    __shared__ int32_t cum[257];
    const int b = blockIdx.x, lane = threadIdx.x;
    const int16_t* fr = freq + (long)b * 256;

    // cum = exclusive prefix of freq: 8 symbols per lane, warp scan
    int32_t loc[8], run = 0;
#pragma unroll
    for (int k = 0; k < 8; k++) {
        loc[k] = run;
        run += fr[lane * 8 + k];
    }
    int32_t incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        int32_t n = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += n;
    }
    const int32_t base = incl - run;
#pragma unroll
    for (int k = 0; k < 8; k++) cum[lane * 8 + k] = base + loc[k];
    if (lane == 31) cum[256] = incl;
    __syncwarp();
    // slot m -> the largest s with cum[s] <= m (searchsorted right - 1)
    for (int m = lane; m < TOTFREQ; m += 32) {
        int lo = 0, hi = 256;  // cum[lo] <= m < cum[hi] (or hi = 256)
        while (hi - lo > 1) {
            const int mid = (lo + hi) >> 1;
            if (cum[mid] <= m) lo = mid; else hi = mid;
        }
        const uint32_t f = (uint32_t)fr[lo];
        slot[m] = (uint32_t)lo | ((f - 1u) & 0xfffu) << 8
                  | (uint32_t)(m - cum[lo]) << 20;
    }
    __syncwarp();

    const uint8_t* pay = payload + (long)b * p_stride;
    const int32_t pl = plen[b], n_in = inner_len[b];
    const int N = n_states;
    uint8_t* row = out + (long)b * out_stride;
    uint32_t R = lane < N ? states[(long)b * N + lane] : 0u;
    int32_t pos = 0;
    const int32_t rounds = (n_in + N - 1) / N;
    for (int32_t r = 0; r < rounds; r++) {
        const int32_t p = r * N + lane;
        const bool active = lane < N && p < n_in;
        const uint32_t t = slot[R & (TOTFREQ - 1)];
        uint32_t x = (((t >> 8) & 0xfffu) + 1u) * (R >> TF_SHIFT)
                     + (t >> 20);
        x = renorm(x, active && x < RANS_LOW, pay, pl, pos);
        if (active) {
            R = x;
            if (p < out_stride) row[p] = (uint8_t)(t & 0xffu);
        }
    }
    zero_tail(row, n_in, out_stride);
}

// ORDER1: grid (B,), block (32,), dynamic shared memory
// n_ctx_cap * (n_ctx_cap + 1) * 2 bytes.
__global__ void __launch_bounds__(32)
rans_order1(const uint8_t* __restrict__ payload, long p_stride,
            const int32_t* __restrict__ plen,
            const uint32_t* __restrict__ states,
            const int16_t* __restrict__ ctx_index,
            const int16_t* __restrict__ ctx_freq,
            const int16_t* __restrict__ alphabet, int n_ctx_cap,
            const int32_t* __restrict__ inner_len, int n_states, int shift,
            uint8_t* __restrict__ out, long out_stride,
            int32_t* __restrict__ bad_ctx) {
    extern __shared__ uint16_t cum1[];  // [n_ctx_cap][n_ctx_cap + 1]
    __shared__ int16_t cidx[256];
    __shared__ uint8_t alpha[MAX_CTX];
    const int b = blockIdx.x, lane = threadIdx.x;
    const int C = n_ctx_cap, W = n_ctx_cap + 1;
    const int16_t* cf = ctx_freq + (long)b * C * C;
    for (int c = lane; c < C; c += 32) {
        uint32_t run = 0;
        cum1[c * W] = 0;
        for (int k = 0; k < C; k++) {
            run += (uint32_t)cf[c * C + k];
            cum1[c * W + k + 1] = (uint16_t)run;
        }
        alpha[c] = (uint8_t)alphabet[(long)b * C + c];
    }
    for (int s = lane; s < 256; s += 32)
        cidx[s] = ctx_index[(long)b * 256 + s];
    __syncwarp();

    const uint8_t* pay = payload + (long)b * p_stride;
    const int32_t pl = plen[b], n_in = inner_len[b];
    const int N = n_states;
    const int32_t F = n_in / N;
    const int32_t len = lane < N ? F + (lane == N - 1 ? n_in - F * N : 0)
                                 : 0;
    const int32_t rounds = F + (n_in - F * N);  // the last lane's length
    const uint32_t mask = (1u << shift) - 1u;
    uint8_t* row = out + (long)b * out_stride;
    uint32_t R = lane < N ? states[(long)b * N + lane] : 0u;
    int32_t pos = 0, last = 0;
    bool bad = false;
    for (int32_t r = 0; r < rounds; r++) {
        const bool active = r < len;
        int row_i = cidx[last];
        bad |= active && row_i < 0;
        if (row_i < 0) row_i = 0;
        const uint16_t* cr = cum1 + row_i * W;
        const uint32_t m = R & mask;
        int lo = 0, hi = C;  // the largest k in [0, C) with cr[k] <= m
        while (hi - lo > 1) {
            const int mid = (lo + hi) >> 1;
            if (cr[mid] <= m) lo = mid; else hi = mid;
        }
        const uint32_t f = (uint32_t)(cr[lo + 1] - cr[lo]);
        uint32_t x = f * (R >> shift) + (m - cr[lo]);
        const uint8_t s = alpha[lo];
        x = renorm(x, active && x < RANS_LOW, pay, pl, pos);
        if (active) {
            R = x;
            last = s;
            const long p = (long)lane * F + r;
            if (p < out_stride) row[p] = s;
        }
    }
    zero_tail(row, n_in, out_stride);
    const bool any_bad = __any_sync(0xffffffffu, bad);
    if (lane == 0) bad_ctx[b] = any_bad ? 1 : 0;
}

extern "C" {

// ORDER0 decode of B streams. payload u8[B][p_stride], plen i32[B],
// states u32[B][n_states], freq i16[B][256], inner_len i32[B],
// out u8[B][out_stride]: symbols past out_stride are dropped, so the
// caller sizes it to the longest inner_len.
// Returns 0 or the CUDA error code of the launch.
int rans_order0_launch(const uint8_t* payload, long p_stride,
                       const int32_t* plen, const uint32_t* states,
                       const int16_t* freq, const int32_t* inner_len,
                       int n_states, int n_streams, uint8_t* out,
                       long out_stride, void* stream) {
    if (n_states < 1 || n_states > 32) return (int)cudaErrorInvalidValue;
    if (n_streams == 0) return 0;
    rans_order0<<<n_streams, 32, 0, (cudaStream_t)stream>>>(
        payload, p_stride, plen, states, freq, inner_len, n_states, out,
        out_stride);
    return (int)cudaGetLastError();
}

// ORDER1 decode of B streams. ctx_index i16[B][256] (context -> row or
// -1), ctx_freq i16[B][n_ctx_cap][n_ctx_cap] (compact rows, columns are
// alphabet positions), alphabet i16[B][n_ctx_cap] (column -> symbol);
// bad_ctx i32[B] receives the missing-context diagnostic.
int rans_order1_launch(const uint8_t* payload, long p_stride,
                       const int32_t* plen, const uint32_t* states,
                       const int16_t* ctx_index, const int16_t* ctx_freq,
                       const int16_t* alphabet, int n_ctx_cap,
                       const int32_t* inner_len, int n_states, int shift,
                       int n_streams, uint8_t* out, long out_stride,
                       int32_t* bad_ctx, void* stream) {
    if (n_states < 1 || n_states > 32 || n_ctx_cap < 1
            || n_ctx_cap > MAX_CTX || shift < 1 || shift > TF_SHIFT)
        return (int)cudaErrorInvalidValue;
    if (n_streams == 0) return 0;
    const size_t smem = (size_t)n_ctx_cap * (n_ctx_cap + 1) * 2;
    cudaError_t e = cudaFuncSetAttribute(
        rans_order1, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    rans_order1<<<n_streams, 32, smem, (cudaStream_t)stream>>>(
        payload, p_stride, plen, states, ctx_index, ctx_freq, alphabet,
        n_ctx_cap, inner_len, n_states, shift, out, out_stride, bad_ctx);
    return (int)cudaGetLastError();
}

const char* rans_kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
