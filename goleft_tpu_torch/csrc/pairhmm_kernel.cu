// Pair-HMM forward wavefront for one length bucket: the Hopper (sm_90a)
// counterpart of the JAX package's ops/pairhmm.py::pallas_forward_bucket
// (the Pallas TPU kernel) and of the XLA wavefront _forward_bucket_impl,
// which is the reference's product path. Wrapper, plain PyTorch version
// and launch count: goleft_tpu_torch/ops/pairhmm_kernel.py.
//
// What it computes. B pairs in the layout of _pack_bucket: reads (B, r1)
// u8 with index 0 the N sentinel of the boundary row, pm/px (B, r1)
// match/mismatch priors, rlens (B,), haps (B, hcap) u8, hlens (B,),
// trans (>= 4,) [tMM, tMI=tMD, tIM=tDM, tII=tDD]. For each anti-diagonal
// k in [1, r1 + hcap) it updates M/I/D of every read row i (cell (i, k-i))
// and writes the final-row contribution M[rlen, k-rlen] + I[rlen, k-rlen]
// and its scale counter: contribs (B, r1 + hcap) and shifts (B, r1 + hcap)
// i32. Index 0 is 0. The host folds them in exact f64.
//
// float: rescaled. Row i's stored values are the true ones times
// 2^(30 s[i]); cross-row terms are reconciled by 2^(30 clip(ds, -4, 3));
// a row whose max leaves [2^-30, 2^30] is renormalised by 2^-+30; an
// all-zero row takes its left neighbour's new counter. double: the same
// recurrence unscaled, shifts 0 (the reference's --f64 path).
//
// Hopper form. The TPU kernel walked the pairs in a sequential grid, one
// pair per step, with the rows as one lane vector. Here each pair is one
// block, so a bucket's pairs run in parallel over the SMs. Thread t owns
// read row (strip*blockDim + t) and keeps its M/I/D/scale of the previous
// diagonal in registers, and the row above's values of the two previous
// diagonals (received by __shfl_up_sync inside a warp). Across warps the
// last lane publishes its row in a double-buffered shared slot; one
// __syncthreads per diagonal. The scale adoption needs the row above's new
// counter of the SAME diagonal: inside a warp it comes by shuffle, and lane
// 0 finalises its adoption at the start of the next diagonal, from the
// slot, before anything reads its counter. A read longer than one block
// (1,024 rows) runs as strips of rows one after the other: the last row of
// a strip writes its values of every diagonal to a global record that the
// next strip's first row reads, so reads of any length run unchanged.
// The hap base of cell (i, k-i) is read from global memory (L1-cached,
// neighbouring threads at neighbouring bytes) instead of the Pallas
// kernel's shift register.
//
// Numerics. The source is built with -fmad=false and keeps the plain
// version's order of operations, each product and sum rounded on its
// own; the scale factors are exact powers of two (ldexp) and 1/hlen is
// IEEE division. So contribs and shifts equal the plain version's
// bitwise on the card (chip_smoke.py holds them so, f32 and f64).
//
// Bound. Compute: about 24 float operations per cell; a bucket of 4,096
// 150 bp reads x 416 bp haps moves ~27 MB and needs ~6e9 operations, so
// the f32 rate (67 TFLOP/s without tensor cores) bounds it, not HBM. This
// simple form does one cell per thread per diagonal with a block barrier
// per diagonal and keeps idle rows busy on the ramp-up and ramp-down
// (r1 + hcap diagonals for r1 x hlen cells); packing several rows per
// thread and several pairs per SM is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SCALE_EXP = 30;
constexpr int DMIN = -4;
constexpr int DMAX = 3;
constexpr uint8_t N_CODE = 4;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct Slot {
  T m, i, d;
  int s, sb;
};

// 2^(30 clip(s_to - s_from, -4, 3)), exact
__device__ __forceinline__ float scale_fix(int s_to, int s_from) {
  int d = s_to - s_from;
  d = d < DMIN ? DMIN : (d > DMAX ? DMAX : d);
  return ldexpf(1.0f, SCALE_EXP * d);
}

template <typename T, bool RESCALE>
__global__ void __launch_bounds__(MAX_THREADS)
pairhmm_forward_kernel(const uint8_t* __restrict__ reads,
                       const T* __restrict__ pm, const T* __restrict__ px,
                       const int32_t* __restrict__ rlens,
                       const uint8_t* __restrict__ haps,
                       const int32_t* __restrict__ hlens,
                       const T* __restrict__ trans, int r1, int hcap,
                       T* __restrict__ contribs, int32_t* __restrict__ shifts,
                       T* __restrict__ rec_v, int32_t* __restrict__ rec_s) {
  __shared__ Slot<T> slots[2][MAX_WARPS];
  const int p = blockIdx.x;
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int steps = r1 + hcap;
  const int rlen = rlens[p];
  const int hlen = hlens[p];
  const T t_mm = trans[0], t_mi = trans[1], t_im = trans[2], t_ii = trans[3];
  const T zero = T(0);
  const T inv_h = T(1) / T(hlen);
  const T below = T(1.0 / 1073741824.0);  // 2^-30
  const T above = T(1073741824.0);        // 2^30
  const uint8_t* hap = haps + (size_t)p * hcap;
  T* out_c = contribs + (size_t)p * steps;
  int32_t* out_s = shifts + (size_t)p * steps;
  if (tid == 0) {
    out_c[0] = zero;
    out_s[0] = 0;
  }
  const Slot<T> none = {zero, zero, zero, 0, 0};
  const int n_strips = rlen / nthreads + 1;  // strips above rlen: no output
  for (int q = 0; q < n_strips; ++q) {
    const int i = q * nthreads + tid;
    const bool in_read = i < r1;
    const size_t at = (size_t)p * r1 + i;
    const uint8_t rb = in_read ? reads[at] : N_CODE;
    const T pmv = in_read ? pm[at] : zero;
    const T pxv = in_read ? px[at] : zero;
    // global records of the last row of strips q-1 (read) and q (written)
    const T* prev_v = rec_v + ((size_t)p * 2 + ((q + 1) & 1)) * 3 * steps;
    const int32_t* prev_s =
        rec_s + ((size_t)p * 2 + ((q + 1) & 1)) * 2 * steps;
    T* cur_v = rec_v + ((size_t)p * 2 + (q & 1)) * 3 * steps;
    int32_t* cur_s = rec_s + ((size_t)p * 2 + (q & 1)) * 2 * steps;
    const bool writes_rec = tid == nthreads - 1 && q + 1 < n_strips;

    // own row after diagonal k-1; the row above after k-1 and k-2
    T m1 = zero, i1 = zero, d1 = (i == 0) ? inv_h : zero;
    int s1 = 0;
    T nm1 = zero, ni1 = zero, nd1 = zero, nm2, ni2, nd2;
    int ns1 = 0, ns2;
    int sb = 0;
    bool pend = false;  // lane 0: counter adoption left to finalise

    if (tid < MAX_WARPS) slots[0][tid] = none;
    __syncthreads();
    for (int k = 1; k < steps; ++k) {
      // 1. the row above after diagonal k-1; lane 0 finalises its
      //    adoption of diagonal k-1 before anyone reads its counter
      Slot<T> nb = none;
      if (lane == 0) {
        if (warp > 0) {
          nb = slots[(k - 1) & 1][warp - 1];
        } else if (q > 0 && k > 1) {
          nb.m = prev_v[k - 1];
          nb.i = prev_v[steps + k - 1];
          nb.d = prev_v[2 * steps + k - 1];
          nb.s = prev_s[k - 1];
          nb.sb = prev_s[steps + k - 1];
        }
        if (pend) s1 = nb.sb;
      }
      nm2 = nm1;
      ni2 = ni1;
      nd2 = nd1;
      ns2 = ns1;
      nm1 = __shfl_up_sync(FULL, m1, 1);
      ni1 = __shfl_up_sync(FULL, i1, 1);
      nd1 = __shfl_up_sync(FULL, d1, 1);
      ns1 = __shfl_up_sync(FULL, s1, 1);
      if (lane == 0) {
        nm1 = nb.m;
        ni1 = nb.i;
        nd1 = nb.d;
        ns1 = nb.s;
      }

      // 2. cell (i, k - i), in the plain version's order of operations
      const int j = k - i;
      const bool in_h = j >= 1 && j <= hlen;
      // j <= hcap holds for every hlen the host layer packs; the test
      // keeps an out-of-contract hlen from reading past the pair's row
      const uint8_t hb = in_h && j <= hcap ? __ldg(hap + j - 1) : N_CODE;
      const bool valid = i >= 1 && i <= rlen && in_h;
      const bool match = rb == hb || rb == N_CODE || hb == N_CODE;
      const T prior = match ? pmv : pxv;
      T mterm = t_mm * nm2;
      mterm = mterm + t_im * ni2;
      mterm = mterm + t_im * nd2;
      T iterm = t_mi * nm1;
      iterm = iterm + t_ii * ni1;
      if (RESCALE) {
        mterm = mterm * T(scale_fix(s1, ns2));
        iterm = iterm * T(scale_fix(s1, ns1));
      }
      T mk = prior * mterm;
      T ik = iterm;
      T dk = t_mi * m1;
      dk = dk + t_ii * d1;
      if (!valid) {
        mk = zero;
        ik = zero;
        dk = zero;
      }
      if (i == 0) dk = (k <= hlen) ? inv_h : zero;  // D[0, j] = 1/|hap|
      if (i == rlen) {
        const bool live = k - rlen >= 1 && k - rlen <= hlen;
        out_c[k] = live ? mk + ik : zero;
        out_s[k] = RESCALE ? s1 : 0;
      }
      int s_new = s1;
      if (RESCALE) {
        const T mx = fmax(fmax(mk, ik), dk);
        const bool alive = mx > zero;
        const int grow = alive && mx < below;
        const int shrink = mx > above;
        const T f = grow ? above : (shrink ? below : T(1));
        mk = mk * f;
        ik = ik * f;
        dk = dk * f;
        sb = s1 + grow - shrink;
        const int nsb = __shfl_up_sync(FULL, sb, 1);
        if (lane > 0) {
          s_new = alive ? sb : nsb;
        } else {
          s_new = sb;
          pend = !alive;
        }
      }
      m1 = mk;
      i1 = ik;
      d1 = dk;
      s1 = s_new;

      // 3. publish the warp's last row (final: its adoption is in-warp)
      if (lane == 31) slots[k & 1][warp] = Slot<T>{m1, i1, d1, s1, sb};
      if (writes_rec) {
        cur_v[k] = m1;
        cur_v[steps + k] = i1;
        cur_v[2 * steps + k] = d1;
        cur_s[k] = s1;
        cur_s[steps + k] = sb;
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" {

// f64 != 0: double, unscaled; else float, rescaled. rec_v / rec_s: the
// strip records, (b, 2, 3, r1 + hcap) and (b, 2, 2, r1 + hcap), needed
// only when r1 > 1024. Returns cudaGetLastError() after the launch.
int pairhmm_forward_launch(int f64, const void* reads, const void* pm,
                           const void* px, const void* rlens,
                           const void* haps, const void* hlens,
                           const void* trans, int b, int r1, int hcap,
                           void* contribs, void* shifts, void* rec_v,
                           void* rec_s, void* stream) {
  if (b <= 0) return 0;
  int threads = (r1 + 31) / 32 * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* r = (const uint8_t*)reads;
  const int32_t* rl = (const int32_t*)rlens;
  const uint8_t* h = (const uint8_t*)haps;
  const int32_t* hl = (const int32_t*)hlens;
  int32_t* sh = (int32_t*)shifts;
  int32_t* rs = (int32_t*)rec_s;
  if (f64) {
    pairhmm_forward_kernel<double, false><<<b, threads, 0, st>>>(
        r, (const double*)pm, (const double*)px, rl, h, hl,
        (const double*)trans, r1, hcap, (double*)contribs, sh,
        (double*)rec_v, rs);
  } else {
    pairhmm_forward_kernel<float, true><<<b, threads, 0, st>>>(
        r, (const float*)pm, (const float*)px, rl, h, hl,
        (const float*)trans, r1, hcap, (float*)contribs, sh, (float*)rec_v,
        rs);
  }
  return (int)cudaGetLastError();
}

const char* pairhmm_kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
