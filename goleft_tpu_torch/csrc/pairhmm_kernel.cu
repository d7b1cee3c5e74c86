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
// all-zero cell takes the new counter of the row above on the same
// diagonal. double: the same recurrence unscaled, shifts 0 (the
// reference's --f64 path).
//
// Hopper form. The TPU kernel walked the pairs in a sequential grid, one
// pair per step, with the rows as one lane vector. Here one warp runs one
// pair, four pairs (warps) to a block, each warp on its own: the diagonal
// loop has warp shuffles and no block barrier. Lane L holds the R
// consecutive rows [32R q + L R, 32R q + L R + R) of strip q (R, a
// template parameter up to 8, is ceil(r1 / 32) clamped to 8: a bucket of
// r1 <= 256 rows is one strip) and keeps each row's M/I/D/counter of
// diagonals k-1 and k-2 in registers; the row loop is unrolled, so
// nothing goes to local memory. Each lane walks its rows top-down within
// a diagonal k: a row's all-zero cell adopts the counter its upper
// neighbour just computed on the same diagonal. (A column sweep with one
// step of lag per lane would compute cell (i-1, j+1) after (i, j) and
// differ from the reference.) Only the band's top row takes the row above
// from lane L-1, by __shfl_up_sync: the values of diagonal k-1 and, to
// finalise its own adoption of diagonal k-1, lane L-1's new counter of
// that diagonal; the shuffles happen at the start of diagonal k, before
// anything reads that counter. A read longer than 256 rows runs as strips
// of 256 rows one after the other (R = 8): the last row of a strip writes
// its values of every diagonal to a global record that the next strip's
// lane 0 reads a diagonal ahead, so reads of any length run unchanged.
// The hap base of cell (i, k-i) comes from a register window of R bases
// per lane, shifted by one each diagonal; the next diagonal's base is
// loaded a diagonal ahead. A cell outside the hap's columns is zeroed
// through its prior and its D alone (its I is 0 by construction), and
// rows past rlen are not masked at all: nothing they hold reaches row
// rlen.
//
// Numerics. The source is built with -fmad=false and keeps the plain
// version's order of operations, each product and sum rounded on its
// own; the scale factors are exact powers of two built from their
// exponent bits and 1/hlen is IEEE division. So contribs and shifts
// equal the plain version's bitwise on the card (chip_smoke.py holds them
// so, f32 and f64).
//
// Bound. Compute: 24 float operations a cell in f32 (12 in f64), each
// its own instruction without FMA, at 132 SMs x 128 (f32) or 64 (f64)
// lanes x 1.98 GHz; a bucket of 4,096 150 bp reads x 416 bp haps moves
// ~27 MB, so compute bounds it, not HBM. What the kernel spends is
// instruction issue: about 57 instructions a cell in f32 (the FP work,
// the scale factors, the counter bookkeeping, the selects and the
// register moves of the diagonal rotation) over the r1 + hcap diagonals
// and the band's 32 R rows (32 R >= r1), where the useful cells are
// rlen x hlen. One warp runs a pair's strips in turn, so a bucket of a
// few long reads is bound by one warp's issue rate (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SCALE_EXP = 30;
constexpr int DMIN = -4;
constexpr int DMAX = 3;
constexpr int N_CODE = 4;
constexpr int OFF_HAP = 256;  // window code of a column outside [1, hlen]
constexpr int LANES = 32;
constexpr int WARPS = 4;  // pairs a block, one warp each
constexpr int MAX_R = 8;  // rows a lane holds
constexpr unsigned FULL = 0xffffffffu;

// 2^(30 clip(s_to - s_from, -4, 3)), exact: the float whose exponent
// field is 127 + 30 d (normal for every d in [-4, 3])
__device__ __forceinline__ float scale_fix(int s_to, int s_from) {
  const int d = min(max(s_to - s_from, DMIN), DMAX);
  return __int_as_float((127 + SCALE_EXP * d) << 23);
}

// window code of hap column j (1-based): the base, N past hcap (an
// out-of-contract hlen), OFF_HAP outside [1, hlen]
__device__ __forceinline__ int hap_code(const uint8_t* hap, int j, int hlen,
                                        int hcap) {
  if (j < 1 || j > hlen) return OFF_HAP;
  return j <= hcap ? (int)__ldg(hap + j - 1) : N_CODE;
}

// The minimum of one block an SM only steers ptxas's register target:
// without it the double R = 2 instantiation spilled 8 bytes.
template <typename T, bool RESCALE, int R>
__global__ void __launch_bounds__(WARPS * LANES, 1)
pairhmm_forward_kernel(const uint8_t* __restrict__ reads,
                       const T* __restrict__ pm, const T* __restrict__ px,
                       const int32_t* __restrict__ rlens,
                       const uint8_t* __restrict__ haps,
                       const int32_t* __restrict__ hlens,
                       const T* __restrict__ trans, int b, int r1,
                       int hcap, T* __restrict__ contribs,
                       int32_t* __restrict__ shifts, T* __restrict__ rec_v,
                       int32_t* __restrict__ rec_s) {
  constexpr int STRIP = LANES * R;
  const int lane = threadIdx.x & (LANES - 1);
  const int p = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (p >= b) return;  // the whole warp: no barrier waits for it
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
  if (lane == 0) {
    out_c[0] = zero;
    out_s[0] = 0;
  }
  const int n_strips = rlen / STRIP + 1;  // strips below rlen: no output
  for (int q = 0; q < n_strips; ++q) {
    const int i0 = q * STRIP + lane * R;  // the lane's first row
    // the read's rows: base and priors. An N read base matches every
    // hap base, so its mismatch prior is its match prior. Row 0 has no
    // M; rows past rlen feed no output and need no mask.
    int rb[R];
    T pmv[R], pxv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r;
      const bool in_read = i >= 1 && i < r1;
      const size_t at = (size_t)p * r1 + i;
      rb[r] = in_read ? (int)reads[at] : N_CODE;
      pmv[r] = in_read ? pm[at] : zero;
      pxv[r] = rb[r] == N_CODE ? pmv[r] : px[at];
    }
    // global records of the last row of strips q-1 (read) and q (written)
    const T* prev_v = rec_v + ((size_t)p * 2 + ((q + 1) & 1)) * 3 * steps;
    const int32_t* prev_s =
        rec_s + ((size_t)p * 2 + ((q + 1) & 1)) * 2 * steps;
    T* cur_v = rec_v + ((size_t)p * 2 + (q & 1)) * 3 * steps;
    int32_t* cur_s = rec_s + ((size_t)p * 2 + (q & 1)) * 2 * steps;
    // strips exist only at R = MAX_R (the host's choice of R): the
    // record code is compiled there alone
    constexpr bool STRIPS = R == MAX_R;
    const bool writes_rec = STRIPS && lane == LANES - 1 && q + 1 < n_strips;
    const bool reads_rec = STRIPS && lane == 0 && q > 0;
    const int r_out = rlen - i0;  // the band's row that is row rlen

    // own rows after diagonal k-1 (m1..) and k-2 (m2..); the row above
    // the band after k-1 (um1..) and k-2 (um2..)
    T m1[R], i1[R], d1[R], m2[R], i2[R], d2[R];
    int s1[R], s2[R], hw[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m1[r] = i1[r] = d1[r] = m2[r] = i2[r] = d2[r] = zero;
      s1[r] = s2[r] = 0;
      hw[r] = OFF_HAP;
    }
    if (i0 == 0) d1[0] = inv_h;  // diagonal 0: cell (0, 0)
    T um1 = zero, ui1 = zero, ud1 = zero, um2, ui2, ud2;
    int us1 = 0, us2;
    int sb_last = 0;    // the band's last row's new counter, diagonal k-1
    bool pend = false;  // the top row's adoption of k-1 to finalise
    // lane 0: the row above its band after diagonal k-1 (row 0 has none:
    // zeros), loaded from the previous strip's record a diagonal ahead
    T rm = zero, ri = zero, rd = zero;
    int rs = 0, rsb = 0;
    int next_hb = hap_code(hap, 1 - i0, hlen, hcap);
    __syncwarp();  // strip q-1's record is written before lane 0 reads it

    for (int k = 1; k < steps; ++k) {
      // 1. the row above after diagonal k-1; the top row finalises its
      //    adoption of diagonal k-1 before anything reads its counter
      int sbu = __shfl_up_sync(FULL, sb_last, 1);
      if (lane == 0) sbu = rsb;
      if (RESCALE && pend) s1[0] = sbu;
      um2 = um1;
      ui2 = ui1;
      ud2 = ud1;
      us2 = us1;
      um1 = __shfl_up_sync(FULL, m1[R - 1], 1);
      ui1 = __shfl_up_sync(FULL, i1[R - 1], 1);
      ud1 = __shfl_up_sync(FULL, d1[R - 1], 1);
      if (RESCALE) us1 = __shfl_up_sync(FULL, s1[R - 1], 1);
      if (lane == 0) {
        um1 = rm;
        ui1 = ri;
        ud1 = rd;
        us1 = rs;
      }
      if (reads_rec) {  // for diagonal k + 1
        rm = prev_v[k];
        ri = prev_v[steps + k];
        rd = prev_v[2 * steps + k];
        rs = prev_s[k];
        rsb = prev_s[steps + k];
      }

      // 2. the hap window: row r's cell is in column k - i0 - r
#pragma unroll
      for (int r = R - 1; r > 0; --r) hw[r] = hw[r - 1];
      hw[0] = next_hb;
      next_hb = hap_code(hap, k + 1 - i0, hlen, hcap);

      // 3. the band's rows top-down, in the plain version's order of
      //    operations; a_* is the row above before diagonal k
      T am1 = um1, ai1 = ui1, ad1 = ud1, am2 = um2, ai2 = ui2, ad2 = ud2;
      int as1 = us1, as2 = us2, asb = sbu;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // a cell outside the hap's columns is 0: its M through a zero
        // prior, its D by the mask, its I because the row above's cell
        // in the same column is 0 too (row 0 has no I)
        const int hb = hw[r];
        const bool valid = hb != OFF_HAP;
        T prior = (rb[r] == hb || hb == N_CODE) ? pmv[r] : pxv[r];
        if (!valid) prior = zero;
        T mterm = t_mm * am2;
        mterm = mterm + t_im * ai2;
        mterm = mterm + t_im * ad2;
        T iterm = t_mi * am1;
        iterm = iterm + t_ii * ai1;
        if (RESCALE) {
          mterm = mterm * T(scale_fix(s1[r], as2));
          iterm = iterm * T(scale_fix(s1[r], as1));
        }
        T mk = prior * mterm;
        T ik = iterm;
        T dk = t_mi * m1[r];
        dk = dk + t_ii * d1[r];
        if (!valid) dk = zero;
        if (r == 0 && i0 == 0) dk = (k <= hlen) ? inv_h : zero;  // D[0, j]
        if (r == r_out) {  // invalid cells are +0, so mk + ik is the gate
          out_c[k] = mk + ik;
          out_s[k] = RESCALE ? s1[r] : 0;
        }
        int s_new = s1[r], sb = 0;
        if (RESCALE) {
          const T mx = fmax(fmax(mk, ik), dk);
          const bool alive = mx > zero;
          const int grow = alive && mx < below;
          const int shrink = mx > above;
          const T f = grow ? above : (shrink ? below : T(1));
          mk = mk * f;
          ik = ik * f;
          dk = dk * f;
          sb = s1[r] + grow - shrink;
          if (r == 0) {
            s_new = sb;
            pend = !alive;  // the row above's counter comes next diagonal
          } else {
            s_new = alive ? sb : asb;
          }
        }
        // the next row's row above: this row before diagonal k
        am2 = m2[r];
        ai2 = i2[r];
        ad2 = d2[r];
        as2 = s2[r];
        am1 = m1[r];
        ai1 = i1[r];
        ad1 = d1[r];
        as1 = s1[r];
        asb = sb;
        m2[r] = m1[r];
        i2[r] = i1[r];
        d2[r] = d1[r];
        s2[r] = s1[r];
        m1[r] = mk;
        i1[r] = ik;
        d1[r] = dk;
        s1[r] = s_new;
      }
      sb_last = asb;
      if (writes_rec) {  // R = 8 here: the last row's counter is final
        cur_v[k] = m1[R - 1];
        cur_v[steps + k] = i1[R - 1];
        cur_v[2 * steps + k] = d1[R - 1];
        cur_s[k] = s1[R - 1];
        cur_s[steps + k] = sb_last;
      }
    }
  }
}

template <typename T, bool RESCALE>
void launch_rows(int rows, int b, cudaStream_t st, const uint8_t* r,
                 const T* pm, const T* px, const int32_t* rl,
                 const uint8_t* h, const int32_t* hl, const T* trans,
                 int r1, int hcap, T* contribs, int32_t* sh, T* rec_v,
                 int32_t* rs) {
  const dim3 grid((b + WARPS - 1) / WARPS), block(WARPS * LANES);
#define PAIRHMM_ROWS(n)                                                    \
  case n:                                                                  \
    pairhmm_forward_kernel<T, RESCALE, n><<<grid, block, 0, st>>>(        \
        r, pm, px, rl, h, hl, trans, b, r1, hcap, contribs, sh, rec_v, rs); \
    break;
  switch (rows) {
    PAIRHMM_ROWS(1)
    PAIRHMM_ROWS(2)
    PAIRHMM_ROWS(3)
    PAIRHMM_ROWS(4)
    PAIRHMM_ROWS(5)
    PAIRHMM_ROWS(6)
    PAIRHMM_ROWS(7)
    PAIRHMM_ROWS(8)
  }
#undef PAIRHMM_ROWS
}

}  // namespace

extern "C" {

// f64 != 0: double, unscaled; else float, rescaled. rows: the rows a
// lane holds, in [1, 8]; a read of more than 32 x rows rows runs in
// strips and needs rows = 8. rec_v / rec_s: the strip records,
// (b, 2, 3, r1 + hcap) and (b, 2, 2, r1 + hcap), needed only when
// r1 > 256. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a rows / r1 pair the kernel does not take.
int pairhmm_forward_launch(int f64, const void* reads, const void* pm,
                           const void* px, const void* rlens,
                           const void* haps, const void* hlens,
                           const void* trans, int b, int r1, int hcap,
                           int rows, void* contribs, void* shifts,
                           void* rec_v, void* rec_s, void* stream) {
  if (b <= 0) return 0;
  if (rows < 1 || rows > MAX_R || (rows < MAX_R && r1 > LANES * rows) ||
      (r1 > LANES * MAX_R && (rec_v == nullptr || rec_s == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* r = (const uint8_t*)reads;
  const int32_t* rl = (const int32_t*)rlens;
  const uint8_t* h = (const uint8_t*)haps;
  const int32_t* hl = (const int32_t*)hlens;
  int32_t* sh = (int32_t*)shifts;
  int32_t* rs = (int32_t*)rec_s;
  if (f64) {
    launch_rows<double, false>(rows, b, st, r, (const double*)pm,
                               (const double*)px, rl, h, hl,
                               (const double*)trans, r1, hcap,
                               (double*)contribs, sh, (double*)rec_v, rs);
  } else {
    launch_rows<float, true>(rows, b, st, r, (const float*)pm,
                             (const float*)px, rl, h, hl,
                             (const float*)trans, r1, hcap,
                             (float*)contribs, sh, (float*)rec_v, rs);
  }
  return (int)cudaGetLastError();
}

const char* pairhmm_kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
