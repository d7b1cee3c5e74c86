// rANS-Nx16 entropy decode on Hopper (sm_90a): the ORDER0 and ORDER1
// rANS stage of CRAM 3.1 block method 5, one stream per block.
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
//   3. a state with x < 2^15 that is granted reads a little-endian 16-bit
//      word at pos + 2*rank, rank = the earlier states of this round that
//      renormalise; a state is granted while rank < (plen - pos)/2, so a
//      denied state denies every later state of the round (the scalar
//      decoder's bytes-left guard);
//   4. pos advances by twice the number of granted states;
//   5. the symbol is written.
// ORDER0 states are active while r*N + j < inner_len (round robin).
// ORDER1 state j decodes the contiguous slice [j*F, (j+1)*F), F =
// inner_len / N, the last state carrying the tail; each state's previous
// symbol (0 at the start) is its context, mapped to a table row by
// ctx_index; a context absent from the table on an active state sets the
// missing-context diagnostic, which the caller raises as the host's error.
//
// What bounds it: the dependent chain, not bytes. Every round of a stream
// depends on the previous one (the states and the read pointer), so a
// stream of R rounds takes R times one round's latency, and one block can
// do nothing about it but shorten the round. A 10,000-record CRAM
// container's 1.5 MB quality block at N = 4 is 375,000 rounds. The round's
// dependent chain at N = 4: ORDER0, the state's 64-bit slot load, a mask
// and the multiply-add, the compare, the rank adds, two byte permutes and
// a select; ORDER1, the bucket entry load (its address from the previous
// entry) in place of the slot load. PERF.md gives the chain bound and the
// measured cycles a round.
//
// Design. A block of 128 threads per stream builds the tables in shared
// memory; then warps 1-3 leave and warp 0 decodes. It replaces one warp
// per stream with a lane per state, the rank by ballot, payload loads
// from device memory, a byte store per symbol and, for ORDER1, a binary
// search per round.
//   N = 4: every lane of warp 0 runs the same round on the same values and
//   holds all four states in registers, so the round carries no warp-
//   collective instruction: the renormalisation rank of state j is the sum
//   of the 0/1 wants of states 0..j-1, not a ballot. The four table loads
//   of a round are independent and issue back to back. Loads of one shared
//   address by the whole warp are one broadcast, so the 32 copies cost what
//   one thread would; the lanes differ only where they cooperate: the
//   payload copies and the output flushes. The round names shared memory
//   by 32-bit address (inline ld.shared): through generic pointers the
//   compiler rebuilt the shared window's base on every round's address
//   path.
//   X32 (N = 32): lane j = state j, the rank from __ballot_sync + __popc
//   (32 states would be 32 table loads a round in one thread); its payload
//   words come from the same shared ring, so no device-memory load is on
//   its chain either.
//   Rounds run in blocks of 512/N: the payload ring is checked and the
//   staged symbols flushed once a block, not once a round, and a block
//   whose read window lies wholly inside plen runs without the bytes-left
//   guard (every wanting state is granted).
//   Payload: the group's streams lie back to back in one buffer, each at
//   a 16-byte-aligned offset (given in 16-byte units, so no other offset
//   can be passed), and the buffer runs on at least RING bytes past every
//   stream's end (checked; the kernel traps on a shorter one). A ring of
//   two 4 KB chunks in shared memory is filled ahead of the read pointer
//   by cp.async (16 bytes a lane), whole chunks, which may take bytes
//   past the stream's end: the bytes-left guard never grants them, and
//   the ring keeps no length of its own (one more value live through the
//   round loop made both loops slower on the card; PERF.md). The next
//   chunk is issued when pos enters the newer chunk and waited for only
//   when a block's read window [pos, pos + 2N(512/N + 1)) reaches it.
//   A round reads the four candidate words at pos as three aligned
//   32-bit shared loads and two funnel shifts, beside the table loads:
//   they depend on pos only. pos is always even (it starts at 0 and
//   moves by whole words). State j's word is a byte permute of that
//   window by its rank, and the merge (x << 16) | word one more.
//   Output: symbols go to a 1 KB staging ring in shared memory and are
//   flushed to the output row with 16-byte stores (bytes only at the ends
//   of a range) once a block. The ring is indexed by output position, so a
//   16-byte-aligned row position is a 16-byte-aligned ring slot; ORDER1
//   gives each state its own 1024/N-byte slice of the ring.
//   ORDER0 tables: freq[256] expands into 4096 slots of 64 bits (32 KB),
//   {f | sym << 16, bias}: one load gives the frequency, the symbol and
//   the bias. A valid table (cum[256] = 4096, checked by the parser) gives
//   every slot a symbol of freq >= 1.
//   ORDER1 tables: C x 2^shift slots do not fit (5 MB at C = 256, shift
//   12). Each context row keeps its compact cumulative row (C x (C+1)
//   uint16, <= 132 KB) and 2^nbl bucket entries of 64 bits, nbl =
//   min(shift, 8), fewer when the tables would pass 200 KB (32 at
//   C = 256). The entry of bucket b is the column whose interval holds
//   slot b << (shift - nbl), with its bounds, its symbol and the row of the
//   context that symbol makes; it is exact for shift <= nbl. A round loads
//   the entry and, only when m lies past that column, steps forward over
//   the cumulative row. The missing-context diagnostic rides in the entry
//   (a context with no row), checked on the state's next active round.
//   A launch's C is its group's widest table: a narrower one comes padded
//   with zero-frequency rows and columns, which take no bucket and which
//   no context reaches.
//
// Interface: plain C, loaded with ctypes (goleft_tpu_torch/ops/
// rans_kernel.py). The caller allocates every buffer; the launch goes on
// the caller's stream and nothing synchronises. The ORDER1 kernel's
// shared memory limit is raised once per device, under a lock, to the
// most a launch asks for, so host threads may launch at once.

#include <climits>
#include <cuda_runtime.h>
#include <mutex>
#include <stdint.h>

#define RANS_LOW 32768u
#define TF_SHIFT 12
#define TOTFREQ 4096
#define MAX_CTX 256
#define THREADS 128
#define CHUNK 4096             // payload ring chunk, bytes
#define RING (2 * CHUNK)       // payload ring, bytes
#define OUT_RING 1024          // symbol staging ring, bytes
#define BLOCK_BYTES 512        // symbols of one block of rounds (K = 512/N)
#define O1_SMEM_BUDGET 200000  // ORDER1 dynamic shared memory, at most

// ---- shared memory by 32-bit address -----------------------------------
// The round's loads name shared memory by its 32-bit address, computed
// once: through a generic pointer, the compiler rebuilt the shared
// window's base (S2UR SR_CgaCtaId) on the address path of every round.

__device__ __forceinline__ uint32_t saddr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t lds32(uint32_t a) {
    uint32_t v;
    asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a));
    return v;
}

__device__ __forceinline__ uint2 lds64(uint32_t a) {
    uint2 v;
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
                 : "=r"(v.x), "=r"(v.y) : "r"(a));
    return v;
}

__device__ __forceinline__ uint4 lds128(uint32_t a) {
    uint4 v;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a));
    return v;
}

__device__ __forceinline__ uint32_t lds16(uint32_t a) {
    uint16_t v;
    asm volatile("ld.shared.u16 %0, [%1];" : "=h"(v) : "r"(a));
    return v;
}

__device__ __forceinline__ void sts32(uint32_t a, uint32_t v) {
    asm volatile("st.shared.u32 [%0], %1;" :: "r"(a), "r"(v) : "memory");
}

__device__ __forceinline__ void sts8(uint32_t a, uint32_t v) {
    asm volatile("st.shared.u8 [%0], %1;" :: "r"(a), "r"(v) : "memory");
}

// ---- payload ring ------------------------------------------------------

__device__ __forceinline__ void cp_async16(uint32_t s, const void* gmem) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem) : "memory");
}

struct Ring {
    const uint8_t* src;  // the stream's payload, 16-byte aligned
    uint32_t buf;        // RING bytes of shared memory (32-bit address)
    int32_t have;        // end of the chunks issued and waited for
    int32_t thr;         // pos at which ring_advance has work
    int32_t look;        // bytes a block of rounds may read from its pos
    bool pending;        // the chunk at `have` is in flight
};

// Copy the chunk at byte offset off (a multiple of CHUNK) into its slot;
// every lane of the warp issues its 16-byte pieces, then one group.
__device__ __forceinline__ void issue_chunk(const Ring& g, int32_t off,
                                            int lane) {
    const uint32_t dst = g.buf + (off & (RING - 1));
    for (int32_t i = lane * 16; i < CHUNK; i += 32 * 16)
        cp_async16(dst + i, g.src + off + i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void ring_set_thr(Ring& g, int32_t plen) {
    g.thr = g.pending ? g.have - g.look + 1
                      : (g.have < plen ? g.have - CHUNK : INT_MAX);
}

// Warp 0, all lanes: chunks 0 and 1 in flight.
__device__ __forceinline__ void ring_start(Ring& g, const uint8_t* src,
                                           uint32_t buf, int lane) {
    g.src = src;
    g.buf = buf;
    issue_chunk(g, 0, lane);
    issue_chunk(g, CHUNK, lane);
    g.have = RING;
    g.pending = false;
}

__device__ __forceinline__ void ring_wait() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
}

// After the table build: chunks 0 and 1 resident; a block of rounds
// reads at most look (<= CHUNK) bytes from its first pos.
__device__ __forceinline__ void ring_ready(Ring& g, int look,
                                           int32_t plen) {
    ring_wait();
    g.look = look;
    ring_set_thr(g, plen);
}

// Make [pos, pos + look) resident, keeping the next chunk in flight.
// All lanes, at the start of a block of rounds, when pos >= g.thr.
__device__ __forceinline__ void ring_advance(Ring& g, int32_t pos,
                                             int32_t plen, int lane) {
    for (;;) {
        if (g.pending && pos + g.look > g.have) {
            ring_wait();
            g.have += CHUNK;
            g.pending = false;
        }
        // pos in the newer chunk: the older one is dead, refill its slot
        if (g.pending || g.have >= plen || pos < g.have - CHUNK) break;
        issue_chunk(g, g.have, lane);
        g.pending = true;
    }
    ring_set_thr(g, plen);
}

// The four 16-bit words at pos (even) as two registers, W0 = words 0-1,
// W1 = words 2-3: three aligned 32-bit loads and two funnel shifts.
__device__ __forceinline__ void window4(uint32_t ring, int32_t pos,
                                        uint32_t& W0, uint32_t& W1) {
    const uint32_t q = (uint32_t)pos & ~3u, sh = ((uint32_t)pos & 2u) << 3;
    const uint32_t a0 = lds32(ring + (q & (RING - 1)));
    const uint32_t a1 = lds32(ring + ((q + 4) & (RING - 1)));
    const uint32_t a2 = lds32(ring + ((q + 8) & (RING - 1)));
    W0 = __funnelshift_r(a0, a1, sh);
    W1 = __funnelshift_r(a1, a2, sh);
}

// ---- staging ring -> output row --------------------------------------

// Row positions [a, e) (clamped to lim) from ring slots q & rmask; the
// ring slice is 16-byte aligned and rmask + 1 a multiple of 16, so an
// aligned position is an aligned slot. All lanes of the warp.
__device__ __forceinline__ void flush(uint8_t* __restrict__ row, long a,
                                      long e, long lim,
                                      const uint8_t* ring, uint32_t rmask,
                                      int lane) {
    if (e > lim) e = lim;
    if (a >= e) return;
    const long a16 = (a + 15) & ~15L, e16 = e & ~15L;
    if (a16 >= e16) {
        for (long q = a + lane; q < e; q += 32) row[q] = ring[q & rmask];
        return;
    }
    if (lane < a16 - a) row[a + lane] = ring[(a + lane) & rmask];
    if (lane < e - e16) row[e16 + lane] = ring[(e16 + lane) & rmask];
    for (long q = a16 + 16L * lane; q < e16; q += 32 * 16)
        *(uint4*)(row + q) = *(const uint4*)(ring + (q & rmask));
}

// Zero row positions [a, e): the part of the row past inner_len.
__device__ __forceinline__ void zero_fill(uint8_t* __restrict__ row, long a,
                                          long e, int lane) {
    if (a >= e) return;
    const long a16 = (a + 15) & ~15L, e16 = e & ~15L;
    if (a16 >= e16) {
        for (long q = a + lane; q < e; q += 32) row[q] = 0;
        return;
    }
    if (lane < a16 - a) row[a + lane] = 0;
    if (lane < e - e16) row[e16 + lane] = 0;
    for (long q = a16 + 16L * lane; q < e16; q += 32 * 16)
        *(uint4*)(row + q) = make_uint4(0, 0, 0, 0);
}

// ---- renormalisation -----------------------------------------------------

// Steps 3-4 of an N = 4 round: x[j] are the decoded states, W0:W1 the
// four words at pos. State j's rank is the count of states before it
// that renormalise (adds of 0/1), its word byte-permuted out of W0:W1 by
// the rank, and the merge (x << 16) | word one more permute. GUARD: the
// bytes-left guard and the active mask act; without it every state is
// active and pos + 8 <= plen holds.
template <bool GUARD>
__device__ __forceinline__ void renorm4(uint32_t (&R)[4],
                                        const uint32_t (&x)[4], uint32_t W0,
                                        uint32_t W1, int32_t plen,
                                        int32_t& pos, int act) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; j++)
        w[j] = ((GUARD ? (act >> j) & 1 : 1) & (x[j] < RANS_LOW)) ? 1u : 0u;
    const uint32_t rk[4] = {0u, w[0], w[0] + w[1], w[0] + w[1] + w[2]};
    const uint32_t tot = rk[3] + w[3];
    const int32_t avail = GUARD ? max((plen - pos) >> 1, 0) : 4;
#pragma unroll
    for (int j = 0; j < 4; j++) {
        const uint32_t word = __byte_perm(W0, W1, 0x10u + rk[j] * 0x22u);
        const bool grant = w[j] && (!GUARD || (int32_t)rk[j] < avail);
        const uint32_t nx = grant ? __byte_perm(word, x[j], 0x5410) : x[j];
        if (!GUARD || ((act >> j) & 1)) R[j] = nx;
    }
    pos += 2 * (GUARD ? min((int32_t)tot, avail) : (int32_t)tot);
}

__device__ __forceinline__ uint32_t lanemask_lt() {
    uint32_t m;
    asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
    return m;
}

// X32, lane j = state j: steps 3-4 of a round with the rank from a
// ballot. Returns the renormalised state; advances pos (uniform).
__device__ __forceinline__ uint32_t renorm_lane(uint32_t x, bool want,
                                                uint32_t ring, int32_t plen,
                                                int32_t& pos) {
    const uint32_t wm = __ballot_sync(0xffffffffu, want);
    const int32_t rank = __popc(wm & lanemask_lt());
    const int32_t avail = max((plen - pos) >> 1, 0);  // pos <= plen
    const uint32_t w = lds16(ring + ((pos + 2 * rank) & (RING - 1)));
    if (want && rank < avail) x = (x << 16) | w;
    pos += 2 * min(__popc(wm), avail);
    return x;
}

// ---- ORDER0 --------------------------------------------------------------
// Slot table: 4096 uint2 {f | sym << 16, bias}, so a round reads f, the
// symbol and the bias with one 64-bit load and takes f with one mask.

// One N = 4 round; returns its four symbols packed (position 4r + j in
// byte j).
template <bool GUARD>
__device__ __forceinline__ uint32_t o0_round4(uint32_t (&R)[4],
                                              uint32_t slot, uint32_t ring,
                                              int32_t plen, int32_t& pos,
                                              int act) {
    uint2 e[4];
#pragma unroll
    for (int j = 0; j < 4; j++) e[j] = lds64(slot + ((R[j] & (TOTFREQ - 1)) << 3));
    uint32_t W0, W1;
    window4(ring, pos, W0, W1);
    uint32_t x[4];
#pragma unroll
    for (int j = 0; j < 4; j++)
        x[j] = (e[j].x & 0xffffu) * (R[j] >> TF_SHIFT) + e[j].y;
    renorm4<GUARD>(R, x, W0, W1, plen, pos, act);
    return __byte_perm(__byte_perm(e[0].x, e[1].x, 0x0062),
                       __byte_perm(e[2].x, e[3].x, 0x0062), 0x5410);
}

__device__ __forceinline__ void o0_n4(Ring& g, uint32_t slot,
                                      const uint32_t* st, int32_t plen,
                                      int32_t n_in, uint8_t* row, long lim,
                                      uint8_t* oring, int lane) {
    constexpr int K = BLOCK_BYTES / 4;  // rounds a block
    const uint32_t ob = saddr(oring);
    uint32_t R[4] = {st[0], st[1], st[2], st[3]};
    int32_t pos = 0;
    const int32_t full = n_in >> 2;  // rounds with every state active
    for (int32_t rb = 0; rb < full; rb += K) {
        if (pos >= g.thr) ring_advance(g, pos, plen, lane);
        const int32_t re = min(rb + K, full);
        if (pos + g.look <= plen) {  // no state of the block is denied
            for (int32_t r = rb; r < re; r++)
                sts32(ob + ((4 * r) & (OUT_RING - 1)),
                      o0_round4<false>(R, slot, g.buf, plen, pos, 0xf));
        } else {
            for (int32_t r = rb; r < re; r++)
                sts32(ob + ((4 * r) & (OUT_RING - 1)),
                      o0_round4<true>(R, slot, g.buf, plen, pos, 0xf));
        }
        __syncwarp();
        flush(row, 4L * rb, 4L * re, lim, oring, OUT_RING - 1, lane);
        __syncwarp();
    }
    if (n_in & 3) {  // the last round: states 0 .. n_in%4 - 1
        if (pos >= g.thr) ring_advance(g, pos, plen, lane);
        sts32(ob + ((4 * full) & (OUT_RING - 1)),
              o0_round4<true>(R, slot, g.buf, plen, pos,
                              (1 << (n_in & 3)) - 1));
        __syncwarp();
        flush(row, 4L * full, n_in, lim, oring, OUT_RING - 1, lane);
    }
}

__device__ __forceinline__ void o0_x32(Ring& g, uint32_t slot,
                                       const uint32_t* st, int32_t plen,
                                       int32_t n_in, uint8_t* row, long lim,
                                       uint8_t* oring, int lane) {
    constexpr int K = BLOCK_BYTES / 32;
    const uint32_t ob = saddr(oring);
    uint32_t R = st[lane];
    int32_t pos = 0;
    const int32_t rounds = (n_in + 31) >> 5;
    for (int32_t rb = 0; rb < rounds; rb += K) {
        if (pos >= g.thr) ring_advance(g, pos, plen, lane);
        const int32_t re = min(rb + K, rounds);
        for (int32_t r = rb; r < re; r++) {
            const bool on = r * 32 + lane < n_in;
            const uint2 e = lds64(slot + ((R & (TOTFREQ - 1)) << 3));
            uint32_t x = (e.x & 0xffffu) * (R >> TF_SHIFT) + e.y;
            x = renorm_lane(x, on && x < RANS_LOW, g.buf, plen, pos);
            if (on) R = x;
            sts8(ob + ((r * 32 + lane) & (OUT_RING - 1)), e.x >> 16);
        }
        __syncwarp();
        flush(row, 32L * rb, min(32L * re, (long)n_in), lim, oring,
              OUT_RING - 1, lane);
        __syncwarp();
    }
}

// ORDER0: grid (B,), block (THREADS,).
__global__ void __launch_bounds__(THREADS)
rans_order0(const uint8_t* __restrict__ payload, long p_bytes,
            const int32_t* __restrict__ poff,
            const int32_t* __restrict__ plen,
            const uint32_t* __restrict__ states,
            const int16_t* __restrict__ freq,
            const int32_t* __restrict__ inner_len, int n_states,
            uint8_t* __restrict__ out, long out_stride) {
    __shared__ __align__(16) uint2 slot[TOTFREQ];
    __shared__ int32_t cum[257];
    __shared__ __align__(16) uint8_t pring[RING];
    __shared__ __align__(16) uint8_t oring[OUT_RING];
    const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
    const int16_t* fr = freq + (long)b * 256;
    if (16L * poff[b] + plen[b] + RING > p_bytes) __trap();
    Ring g;
    if (tid < 32) {
        // the first two payload chunks load while the table builds
        ring_start(g, payload + 16L * poff[b], saddr(pring), lane);
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
            const int32_t n = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl += n;
        }
        const int32_t base = incl - run;
#pragma unroll
        for (int k = 0; k < 8; k++) cum[lane * 8 + k] = base + loc[k];
        if (lane == 31) cum[256] = incl;
    }
    __syncthreads();
    // slot m -> the largest s with cum[s] <= m (searchsorted right - 1)
    for (int m = tid; m < TOTFREQ; m += THREADS) {
        int lo = 0, hi = 256;  // cum[lo] <= m < cum[hi] (or hi = 256)
        while (hi - lo > 1) {
            const int mid = (lo + hi) >> 1;
            if (cum[mid] <= m) lo = mid; else hi = mid;
        }
        slot[m] = make_uint2(((uint32_t)fr[lo] & 0xffffu) | (uint32_t)lo << 16,
                             (uint32_t)(m - cum[lo]));
    }
    __syncthreads();
    if (tid >= 32) return;

    const int32_t pl = plen[b], n_in = inner_len[b];
    uint8_t* row = out + (long)b * out_stride;
    const uint32_t* st = states + (long)b * n_states;
    ring_ready(g, 2 * n_states * (BLOCK_BYTES / n_states + 1), pl);
    if (n_states == 4)
        o0_n4(g, saddr(slot), st, pl, n_in, row, out_stride, oring, lane);
    else
        o0_x32(g, saddr(slot), st, pl, n_in, row, out_stride, oring, lane);
    zero_fill(row, n_in, out_stride, lane);
}

// ---- ORDER1 --------------------------------------------------------------
// Per context row c and bucket b (2^nbl of them; slot m is in bucket
// m >> (shift - nbl)), one uint2 entry for the column k whose interval
// holds the bucket's first slot:
//   .x = lo | absent << 15 | f << 16   (lo = cum[k], f = cum[k+1] - lo;
//                                       absent: the context sym has no row)
//   .y = sym | k << 8 | rowoff << 16   (rowoff = row of sym << nbl, 0 when
//                                       absent)
// A state carries the rowoff and the absent bit of its context. A round
// loads its entry, and only when m lies past the column (a bucket that
// holds a column boundary) steps forward over the cumulative row; col[k]
// holds the .x flag and .y word of every column for that step.

struct O1Tab {
    uint32_t ent;  // entries [C][2^nbl] uint2
    uint32_t cum;  // cumulative rows [C][C + 1] uint16
    uint32_t col;  // [C] uint2 {absent << 15, sym | k << 8 | rowoff << 16}
    int W, C, bs, shift;
    uint32_t mask;
};

// The rare step of a lookup: m lies past the entry's column (its bucket
// holds a column boundary), so walk the context's cumulative row forward
// to the column that holds m and take that column's words.
__device__ __forceinline__ uint2 o1_step(const O1Tab& T, uint32_t rowoff,
                                      uint32_t m, uint2 e, uint32_t& lo,
                                      uint32_t& f) {
    const uint32_t row = (rowoff >> (T.shift - T.bs)) * T.W;
    uint32_t k = (e.y >> 8) & 0xffu;
    while (m - lo >= f && k < (uint32_t)T.C - 1) {
        k++;
        lo = lds16(T.cum + 2 * (row + k));
        f = lds16(T.cum + 2 * (row + k + 1)) - lo;
    }
    return lds64(T.col + 8 * k);
}

// One state's table lookup, for lane-per-state X32: from its context's
// rowoff and its state R, the decoded state x and the entry words.
__device__ __forceinline__ uint2 o1_lookup(const O1Tab& T, uint32_t R,
                                           uint32_t rowoff, uint32_t& x) {
    const uint32_t m = R & T.mask;
    uint2 e = lds64(T.ent + ((rowoff + (m >> T.bs)) << 3));
    uint32_t lo = e.x & 0x7fffu, f = e.x >> 16;
    if (m - lo >= f) e = o1_step(T, rowoff, m, e, lo, f);
    x = f * (R >> T.shift) + (m - lo);
    return e;
}

// One N = 4 round (GUARD: state j active when bit j of act is set). Each
// state carries its context (the absent bit in .x, rowoff in .y) as the
// entry of its last symbol; the round returns the symbols in sym. The
// four entry loads issue back to back, before any state's check.
template <bool GUARD>
__device__ __forceinline__ void o1_round4(uint32_t (&R)[4], uint2 (&ctx)[4],
                                          uint32_t (&sym)[4], bool& bad,
                                          const O1Tab& T, uint32_t ring,
                                          int32_t plen, int32_t& pos,
                                          int act) {
    uint2 e[4];
    uint32_t m[4], lo[4], f[4], x[4];
#pragma unroll
    for (int j = 0; j < 4; j++) {
        const bool on = !GUARD || ((act >> j) & 1);
        bad |= on && (ctx[j].x & 0x8000u);
        m[j] = R[j] & T.mask;
        e[j] = lds64(T.ent + (((ctx[j].y >> 16) + (m[j] >> T.bs)) << 3));
    }
    uint32_t W0, W1;
    window4(ring, pos, W0, W1);
#pragma unroll
    for (int j = 0; j < 4; j++) {
        lo[j] = e[j].x & 0x7fffu;
        f[j] = e[j].x >> 16;
    }
    // one branch for the four states, rarely taken: a branch a state
    // cost the round more than a shared load each
    bool step = false;
#pragma unroll
    for (int j = 0; j < 4; j++) step |= m[j] - lo[j] >= f[j];
    if (__builtin_expect(step, 0)) {
#pragma unroll
        for (int j = 0; j < 4; j++)
            if (m[j] - lo[j] >= f[j])
                e[j] = o1_step(T, ctx[j].y >> 16, m[j], e[j], lo[j], f[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; j++)
        x[j] = f[j] * (R[j] >> T.shift) + (m[j] - lo[j]);
    renorm4<GUARD>(R, x, W0, W1, plen, pos, act);
#pragma unroll
    for (int j = 0; j < 4; j++) {
        if (!GUARD || ((act >> j) & 1)) ctx[j] = e[j];
        sym[j] = e[j].y & 0xffu;
    }
}

// Row positions of rounds [r0, r1) of every state, from each state's
// slice of the staging ring (OUT_RING / N bytes).
template <int N>
__device__ __forceinline__ void o1_flush(uint8_t* row, int32_t F,
                                         int32_t n_in, int32_t r0,
                                         int32_t r1, long lim,
                                         const uint8_t* oring, int lane) {
    constexpr int S = OUT_RING / N;
    __syncwarp();
    for (int j = 0; j < N; j++) {
        const int32_t len = j == N - 1 ? n_in - (N - 1) * F : F;
        const long s = (long)j * F;
        flush(row, s + min(r0, len), s + min(r1, len), lim, oring + j * S,
              S - 1, lane);
    }
    __syncwarp();
}

__device__ __forceinline__ bool o1_n4(Ring& g, const O1Tab& T, uint2 ctx0,
                                      const uint32_t* st, int32_t plen,
                                      int32_t n_in, uint8_t* row, long lim,
                                      uint8_t* oring, int lane) {
    constexpr int K = BLOCK_BYTES / 4, S = OUT_RING / 4;
    const uint32_t ob = saddr(oring);
    uint32_t R[4] = {st[0], st[1], st[2], st[3]};
    uint2 ctx[4] = {ctx0, ctx0, ctx0, ctx0};
    uint32_t sym[4];
    bool bad = false;
    int32_t pos = 0;
    const int32_t F = n_in >> 2, rounds = F + (n_in & 3);
    for (int32_t rb = 0; rb < F; rb += K) {
        if (pos >= g.thr) ring_advance(g, pos, plen, lane);
        const int32_t re = min(rb + K, F);
        if (pos + g.look <= plen) {  // no state of the block is denied
            for (int32_t r = rb; r < re; r++) {
                o1_round4<false>(R, ctx, sym, bad, T, g.buf, plen, pos, 0xf);
#pragma unroll
                for (int j = 0; j < 4; j++)
                    sts8(ob + j * S + ((j * F + r) & (S - 1)), sym[j]);
            }
        } else {
            for (int32_t r = rb; r < re; r++) {
                o1_round4<true>(R, ctx, sym, bad, T, g.buf, plen, pos, 0xf);
#pragma unroll
                for (int j = 0; j < 4; j++)
                    sts8(ob + j * S + ((j * F + r) & (S - 1)), sym[j]);
            }
        }
        o1_flush<4>(row, F, n_in, rb, re, lim, oring, lane);
    }
    if (rounds > F) {  // the last state's tail, fewer than 4 rounds
        if (pos >= g.thr) ring_advance(g, pos, plen, lane);
        for (int32_t r = F; r < rounds; r++) {
            o1_round4<true>(R, ctx, sym, bad, T, g.buf, plen, pos, 8);
            sts8(ob + 3 * S + ((3 * F + r) & (S - 1)), sym[3]);
        }
        o1_flush<4>(row, F, n_in, F, rounds, lim, oring, lane);
    }
    return bad;
}

__device__ __forceinline__ bool o1_x32(Ring& g, const O1Tab& T, uint2 ctx,
                                       const uint32_t* st, int32_t plen,
                                       int32_t n_in, uint8_t* row, long lim,
                                       uint8_t* oring, int lane) {
    constexpr int K = BLOCK_BYTES / 32, S = OUT_RING / 32;
    const uint32_t ob = saddr(oring);
    const int32_t F = n_in >> 5, rounds = F + (n_in & 31);
    const int32_t len = lane == 31 ? rounds : F;
    uint32_t R = st[lane];
    bool bad = false;
    int32_t pos = 0;
    for (int32_t rb = 0; rb < rounds; rb += K) {
        if (pos >= g.thr) ring_advance(g, pos, plen, lane);
        const int32_t re = min(rb + K, rounds);
        for (int32_t r = rb; r < re; r++) {
            const bool on = r < len;
            bad |= on && (ctx.x & 0x8000u);
            uint32_t x;
            const uint2 e = o1_lookup(T, R, ctx.y >> 16, x);
            x = renorm_lane(x, on && x < RANS_LOW, g.buf, plen, pos);
            if (on) {
                R = x;
                ctx = e;
                sts8(ob + lane * S + ((lane * F + r) & (S - 1)), e.y);
            }
        }
        o1_flush<32>(row, F, n_in, rb, re, lim, oring, lane);
    }
    return __any_sync(0xffffffffu, bad);
}

// Dynamic shared memory of an ORDER1 launch: the cumulative rows, then
// the entries.
__host__ __device__ __forceinline__ size_t o1_cum_bytes(int C) {
    return ((size_t)C * (C + 1) * 2 + 15) & ~(size_t)15;
}

__host__ __device__ __forceinline__ size_t o1_smem(int C, int nbl) {
    return o1_cum_bytes(C) + ((size_t)C << nbl) * 8;
}

// ORDER1: grid (B,), block (THREADS,), dynamic shared memory
// o1_smem(n_ctx_cap, nbl) with 2^nbl buckets a row.
__global__ void __launch_bounds__(THREADS)
rans_order1(const uint8_t* __restrict__ payload, long p_bytes,
            const int32_t* __restrict__ poff,
            const int32_t* __restrict__ plen,
            const uint32_t* __restrict__ states,
            const int16_t* __restrict__ ctx_index,
            const int16_t* __restrict__ ctx_freq,
            const int16_t* __restrict__ alphabet, int n_ctx_cap,
            const int32_t* __restrict__ inner_len, int n_states, int shift,
            int nbl, uint8_t* __restrict__ out, long out_stride,
            int32_t* __restrict__ bad_ctx) {
    extern __shared__ __align__(16) uint8_t dyn[];
    __shared__ __align__(16) uint8_t pring[RING];
    __shared__ __align__(16) uint8_t oring[OUT_RING];
    __shared__ int16_t ctxi[256];
    __shared__ __align__(8) uint2 col[MAX_CTX];
    const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
    const int C = n_ctx_cap, W = n_ctx_cap + 1;
    const int NB = 1 << nbl, bs = shift - nbl;
    uint16_t* cum1 = (uint16_t*)dyn;
    uint2* ent = (uint2*)(dyn + o1_cum_bytes(C));
    const int32_t pl = plen[b];
    if (16L * poff[b] + pl + RING > p_bytes) __trap();
    Ring g;
    if (tid < 32)
        ring_start(g, payload + 16L * poff[b], saddr(pring), lane);
    const int16_t* cf = ctx_freq + (long)b * C * C;
    for (int c = tid; c < C; c += THREADS) {
        uint32_t run = 0;
        cum1[c * W] = 0;
        for (int k = 0; k < C; k++) {
            run += (uint32_t)cf[c * C + k];
            cum1[c * W + k + 1] = (uint16_t)run;
        }
    }
    for (int s = tid; s < 256; s += THREADS)
        ctxi[s] = ctx_index[(long)b * 256 + s];
    __syncthreads();
    for (int k = tid; k < C; k += THREADS) {
        const uint32_t a = (uint32_t)alphabet[(long)b * C + k] & 0xffu;
        const int r = ctxi[a];
        col[k] = make_uint2(r < 0 ? 0x8000u : 0u,
                            a | (uint32_t)k << 8
                            | (r < 0 ? 0u : (uint32_t)r << nbl) << 16);
    }
    __syncthreads();
    // entries: column i takes the buckets whose first slot lies in
    // [cum[i], cum[i+1]) (cum[C+1] = infinity), clamped to C - 1; a
    // non-decreasing row gives every bucket exactly one column
    for (int p = tid; p < C * W; p += THREADS) {
        const int c = p / W, i = p - c * W;
        const uint16_t* cr = cum1 + c * W;
        const int wd = (1 << bs) - 1;
        const int lo_b = ((int)cr[i] + wd) >> bs;
        const int hi_b = i < C ? min(((int)cr[i + 1] + wd) >> bs, NB) : NB;
        if (lo_b >= hi_b) continue;
        const int k = min(i, C - 1);
        const uint32_t lo = cr[k], f = (uint32_t)cr[k + 1] - lo;
        const uint2 v = make_uint2(col[k].x | lo | f << 16, col[k].y);
        for (int bb = lo_b; bb < hi_b; bb++) ent[c * NB + bb] = v;
    }
    __syncthreads();
    if (tid >= 32) return;

    const O1Tab T{saddr(ent), saddr(cum1), saddr(col), W, C, bs, shift,
                  (1u << shift) - 1u};
    const int r0 = ctxi[0];
    const uint2 ctx0 = make_uint2(r0 < 0 ? 0x8000u : 0u,
                                  r0 < 0 ? 0u : (uint32_t)r0 << nbl << 16);
    const int32_t n_in = inner_len[b];
    uint8_t* row = out + (long)b * out_stride;
    const uint32_t* st = states + (long)b * n_states;
    ring_ready(g, 2 * n_states * (BLOCK_BYTES / n_states + 1), pl);
    const bool bad = n_states == 4
        ? o1_n4(g, T, ctx0, st, pl, n_in, row, out_stride, oring, lane)
        : o1_x32(g, T, ctx0, st, pl, n_in, row, out_stride, oring, lane);
    zero_fill(row, n_in, out_stride, lane);
    if (lane == 0) bad_ctx[b] = bad ? 1 : 0;
}

// The ORDER1 kernel's dynamic shared memory limit, raised once per device
// to the most any launch asks for. A per-launch limit of that launch's
// own size raced: the host threads of a cohort launch at once, and one
// thread's smaller limit could land between another's set and launch.
static int o1_smem_limit() {
    static std::mutex mu;
    static bool ready[64];
    int dev;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(mu);
    if (!ready[dev]) {
        e = cudaFuncSetAttribute(rans_order1,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 O1_SMEM_BUDGET);
        if (e != cudaSuccess) return (int)e;
        ready[dev] = true;
    }
    return 0;
}

extern "C" {

// ORDER0 decode of B streams. payload u8[p_bytes], 16-byte aligned,
// holds stream b from byte 16 * poff[b] on, plen[b] bytes, and runs on at
// least RING bytes past each stream (a launch that finds it shorter
// traps); plen i32[B], states u32[B][n_states], freq i16[B][256],
// inner_len i32[B], out u8[B][out_stride]: symbols past out_stride are
// dropped, so the caller sizes it to the longest inner_len. out_stride is
// a multiple of 16 and out 16-byte aligned; n_states is 4 or 32.
// Returns 0 or the CUDA error code of the launch.
int rans_order0_launch(const uint8_t* payload, long p_bytes,
                       const int32_t* poff,
                       const int32_t* plen, const uint32_t* states,
                       const int16_t* freq, const int32_t* inner_len,
                       int n_states, int n_streams, uint8_t* out,
                       long out_stride, void* stream) {
    if ((n_states != 4 && n_states != 32) || out_stride % 16)
        return (int)cudaErrorInvalidValue;
    if (n_streams == 0) return 0;
    rans_order0<<<n_streams, THREADS, 0, (cudaStream_t)stream>>>(
        payload, p_bytes, poff, plen, states, freq, inner_len, n_states,
        out, out_stride);
    return (int)cudaGetLastError();
}

// ORDER1 decode of B streams. ctx_index i16[B][256] (context -> row or
// -1), ctx_freq i16[B][n_ctx_cap][n_ctx_cap] (compact rows, columns are
// alphabet positions), alphabet i16[B][n_ctx_cap] (column -> symbol);
// bad_ctx i32[B] receives the missing-context diagnostic. Each row gets
// 2^min(shift, 8) buckets, halved until the tables fit O1_SMEM_BUDGET.
int rans_order1_launch(const uint8_t* payload, long p_bytes,
                       const int32_t* poff,
                       const int32_t* plen, const uint32_t* states,
                       const int16_t* ctx_index, const int16_t* ctx_freq,
                       const int16_t* alphabet, int n_ctx_cap,
                       const int32_t* inner_len, int n_states, int shift,
                       int n_streams, uint8_t* out, long out_stride,
                       int32_t* bad_ctx, void* stream) {
    if ((n_states != 4 && n_states != 32) || n_ctx_cap < 1
            || n_ctx_cap > MAX_CTX || shift < 1 || shift > TF_SHIFT
            || out_stride % 16)
        return (int)cudaErrorInvalidValue;
    if (n_streams == 0) return 0;
    const int rc = o1_smem_limit();
    if (rc) return rc;
    int nbl = shift < 8 ? shift : 8;
    while (nbl > 0 && o1_smem(n_ctx_cap, nbl) > O1_SMEM_BUDGET) nbl--;
    rans_order1<<<n_streams, THREADS, o1_smem(n_ctx_cap, nbl),
                  (cudaStream_t)stream>>>(
        payload, p_bytes, poff, plen, states, ctx_index, ctx_freq, alphabet,
        n_ctx_cap, inner_len, n_states, shift, nbl, out, out_stride,
        bad_ctx);
    return (int)cudaGetLastError();
}

const char* rans_kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
