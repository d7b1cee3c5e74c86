// Banded Smith-Waterman of one bucket of read/window pairs on Hopper
// (sm_90a): affine-gap local alignment in exact int32, each pair's best
// cell, a direction plane of 4 bits a cell that stays on the card, and
// the traceback walked on the card into run-length CIGAR ops.
//
// Replaces the XLA program goleft_tpu/ops/swalign.py::_sw_bucket_impl (a
// vmapped lax.fori_loop of r1 + w_pad anti-diagonal steps, no Pallas),
// the mapper's extend stage, and the host walk ops/swalign.py::traceback
// that followed it. It computes exactly what those compute:
//
//   the cells are {1 <= i <= min(rlen, r1 - 1), 1 <= j <= wlen,
//   i + j <= r1 + w_pad - 1} (the reference's loop stops at its last
//   step); row 0 and column 0 are the boundary, H = 0, E = F = NEG;
//   a window column past w_pad reads the window's last base; an N (code
//   4) never matches;
//   H = max(0, H[i-1,j-1] + sub, E, F)
//   E = max(H[i,j-1] + open + ext, E[i,j-1] + ext)
//   F = max(H[i-1,j] + open + ext, F[i-1,j] + ext)
//   a cell's 4 direction bits: bits 0-1 H's source (0 stop when h <= 0,
//   1 diag, 2 E, 3 F, in that tie order), bit 2 E extends (e_ext >=
//   e_open), bit 3 F extends (f_ext >= f_open);
//   the best cell is the lexicographic maximum of (h, -(i+j), -i) over
//   the cells with h > 0, and (0, 0, 0) when there is none;
//   the walk back from it is ops/swalign.py::traceback's.
//
// Design: a warp a pair, no block barrier. Lane L owns a strip of R
// consecutive read rows (R = ceil(rows / 32), a template constant up to
// R_MAX = 8, so the strip's H and E stay in registers) and walks the
// window's columns with a skew of one column a lane: at step t it
// computes column t - L + 1 for its R rows, top to bottom, F running
// down the strip in registers. The strip's bottom H and F go to lane
// L + 1 by __shfl_up_sync, the warp's only synchronisation. A pair takes
// at most wlen + 31 steps (243 for a 150 bp read against its 214 bp
// window: 30 lanes of 5 rows; the design it replaces took 416 block-wide
// barriers), and a lane computes
// only the cells of the set plus the strip rows past the read's end and
// the warp's skew. Reads longer than 32 x R_MAX rows run in bands of 256
// rows, one after the other in the same warp: each band's bottom row (H
// and F a column) goes to a device scratch that the next band's lane 0
// reads in place of a shuffle (two buffers, by band parity).
//
// The max-plus recurrence uses Hopper's DPX instructions, each checked
// against the reference's tie rules: __vibmax_s32(e_ext, e_open, &p)
// gives E and its extend bit (p = e_ext >= e_open), the same for F;
// __vimax3_s32_relu gives H = max(0, h_diag, E, F). No tensor core
// applies: the recurrence is int32 max-plus with a dependence on the
// previous anti-diagonal.
//
// The best cell: each lane keeps, a row, the first column of the row's
// greatest h (the columns come in order), merges its rows by the full
// (h, -(i+j), -i) key at the end of a band, and the warp reduces once by
// the same key.
//
// The direction plane: one 32-bit word a (band, step, lane) holds the
// lane's R <= 8 rows x 4 bits, so a warp's store at one step is one
// 128-byte line. It lives in device memory. It is allocated for every
// column a cell can reach, r1 + w_pad - 2, so the launch reads nothing
// of its inputs on the host: at the main path's larger bucket (r1 161,
// w_pad 256, R = 5) 446 steps x 128 B, 57 KB a pair, 233.8 MB for 4,096
// pairs. A pair writes only its lanes' columns: a 150 bp read against a
// 214 bp window writes 30 lanes x 214 words (20 of each word's 32 bits
// used at R = 5), 25.7 KB, about 105 MB a bucket. The map path packs no
// window past w_pad, so a third of the allocation (the steps past
// w_pad + 31) is never written; words never written are never read
// either, so they cost no traffic, and PyTorch's caching allocator
// keeps the block from one launch to the next. In shared memory a
// pair's 57 KB (31 KB for its 243 steps, were the plane sized a pair,
// which needs each wlen on the host) would hold an SM's 228 KB to 3
// pairs (7), 3 to 7 of its 64 warp slots: too few warps to cover the
// latency of the step's dependent DPX chain and shuffles. In device
// memory every pair of a bucket is resident at once (4,096 warps, 8 a
// block, over 132 SMs), and its 105 MB of stores take about 0.03 ms at
// 3.35 TB/s, under the compute time.
//
// The warp then walks its pair's plane back from the best cell (after a
// __syncwarp that orders the warp's stores), reading through L2: lane l
// reads the cell l steps on along the current state's run and a ballot
// finds where the run ends, so a run of up to 32 cells costs one round
// of loads, not 32 dependent ones. Lane 0 writes read_start, win_start and
// the CIGAR as run-length ops, (length << 2) | op with op 0 M, 1 I, 2 D,
// in the order the CIGAR reads. The plane never leaves the card on the
// main path.
//
// What bounds it: operations. At the main path's bucket (4,096 pairs of
// 150 bp reads against 214 bp windows) 1.315e8 cells of at least 16
// int32 instructions (chip_smoke.py's recount) at the int32 rate,
// against kilobytes of inputs and alignments; the plane's 4 bits a cell
// are an intermediate. The design's answer: no barrier, no shared-memory
// round trip a cell, DPX max-plus, and the skew's empty lane-steps held
// to 31 a band. What is left sets the pace on the integer pipe: the
// direction nibble's compares and selects (__vibmax_s32 itself compiles
// to a compare and a select). No length cap.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t NEG = -(1 << 28);
constexpr int N_CODE = 4;
constexpr int WARP = 32;
constexpr int R_MAX = 8;
constexpr int WARPS_PER_BLOCK = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr int OP_M = 0, OP_I = 1, OP_D = 2;
// an N of the read and an N of the window never match: their codes are
// moved apart, so a match is one compare
constexpr int READ_N = -1, WIN_N = -2;

struct Args {
  const uint8_t* reads;
  const int32_t* rlens;
  const uint8_t* wins;
  const int32_t* wlens;
  const int32_t* scores;
  int b, r1, wcap, ncols, bands, plane_steps;  // ncols = r1 + wcap - 2
  int32_t* scratch;  // b x 4 x (ncols + 1) when bands > 1, else null
  uint32_t* plane;   // (b, bands, plane_steps, 32)
  int32_t* meta;     // (6, b)
  int32_t* runs;     // (r1 + wcap, b)
};

struct Best {
  int32_t v, k, i;
};

// (v, -k, -i) greater than (bv, -bk, -bi)
__device__ __forceinline__ bool better(int32_t v, int32_t k, int32_t i,
                                       const Best& b) {
  return v > b.v || (v == b.v && (k < b.k || (k == b.k && i < b.i)));
}

// One band of the pair: rows i_base + 1 .. i_base + 32R.
template <int R, bool CLIP>
__device__ __forceinline__ void band(const Args& a, int pair, int lane,
                                     int bnd, bool feeds, int rows,
                                     int wlen, int kmax,
                                     const uint8_t* read,
                                     const uint8_t* win, Best& best) {
  const int32_t s_match = a.scores[0];
  const int32_t s_mis = a.scores[1];
  const int32_t s_ext = a.scores[3];
  // (h + open) + ext: int32 addition wraps, so the sum is the same
  const int32_t s_oe = a.scores[2] + a.scores[3];
  const int i_base = bnd * WARP * R;
  const int lanes = (min(WARP * R, rows - i_base) + R - 1) / R;
  const int i0 = i_base + lane * R + 1;
  // the lane's last column: a cell of its first row with i + j > kmax
  // lies past the reference's last step
  const int jl = lane < lanes ? min(wlen, kmax - i0) : 0;
  const int steps = min(wlen, kmax - i_base - 1) + lanes - 1;

  int rb[R];
  int32_t hl[R], el[R], bv[R], bj[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = i0 + r <= rows ? read[i0 + r] : N_CODE;
    rb[r] = c == N_CODE ? READ_N : c;
    hl[r] = 0;  // H[i, j - 1]
    el[r] = NEG;  // E[i, j - 1]
    bv[r] = 0;
    bj[r] = 0;
  }
  const size_t sc_n = static_cast<size_t>(a.ncols) + 1;
  int32_t* sc = a.scratch + static_cast<size_t>(pair) * 4 * sc_n;
  int32_t* w_h = sc + 2 * (bnd & 1) * sc_n;  // this band's bottom row
  int32_t* w_f = w_h + sc_n;
  const int32_t* r_h = sc + 2 * ((bnd + 1) & 1) * sc_n;  // the one above
  const int32_t* r_f = r_h + sc_n;
  uint32_t* prow = a.plane +
                   (static_cast<size_t>(pair) * a.bands + bnd) *
                       a.plane_steps * WARP + lane;
  const bool from_scratch = lane == 0 && bnd > 0;
  const bool to_scratch = feeds && lane == WARP - 1;
  const int wlast = a.wcap - 1;

  int32_t uh = 0;  // H[i0 - 1, j], then H[i0 - 1, j - 1] a step later
  int32_t sh_h = 0, sh_f = NEG;  // what lane L - 1 passed at the last step
  for (int t = 0; t < steps; ++t, prow += WARP) {
    const int j = t - lane + 1;
    const bool act = j >= 1 && j <= jl;
    int32_t in_h = lane == 0 ? 0 : sh_h;
    int32_t in_f = lane == 0 ? NEG : sh_f;
    if (from_scratch && act) {
      in_h = r_h[j];
      in_f = r_f[j];
    }
    const int32_t uhp = uh;
    uh = in_h;
    int32_t out_h = 0, out_f = NEG;  // column 0's, before the lane starts
    if (act) {
      const int wc = win[min(j - 1, wlast)];
      const int wb = wc == N_CODE ? WIN_N : wc;
      int32_t diag = uhp, up = in_h, fu = in_f;
      uint32_t word = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int32_t hd = diag + (rb[r] == wb ? s_match : s_mis);
        bool pe, pf;
        const int32_t e = __vibmax_s32(el[r] + s_ext, hl[r] + s_oe, &pe);
        const int32_t f = __vibmax_s32(fu + s_ext, up + s_oe, &pf);
        const int32_t h = __vimax3_s32_relu(hd, e, f);
        const uint32_t src = h == hd ? 1u : h == e ? 2u : 3u;
        word |= ((h > 0 ? src : 0u) | (pe ? 4u : 0u) | (pf ? 8u : 0u))
                << (4 * r);
        // strict, in column order: the row's first column of its maximum
        if (h > bv[r] && (!CLIP || i0 + r + j <= kmax)) {
          bv[r] = h;
          bj[r] = j;
        }
        diag = hl[r];
        hl[r] = h;
        el[r] = e;
        up = h;
        fu = f;
      }
      out_h = up;
      out_f = fu;
      *prow = word;
      if (to_scratch) {
        w_h[j] = out_h;
        w_f[j] = out_f;
      }
    }
    sh_h = __shfl_up_sync(FULL, out_h, 1);
    sh_f = __shfl_up_sync(FULL, out_f, 1);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r;
    if (i <= rows && bv[r] > 0 && better(bv[r], i + bj[r], i, best)) {
      best = {bv[r], i + bj[r], i};
    }
  }
}

template <int R>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * WARP)
sw_warp_kernel(Args a) {
  const int lane = threadIdx.x & (WARP - 1);
  const int pair = blockIdx.x * WARPS_PER_BLOCK + threadIdx.x / WARP;
  if (pair >= a.b) {
    return;  // the whole warp: nothing waits on it
  }
  const uint8_t* read = a.reads + static_cast<size_t>(pair) * a.r1;
  const uint8_t* win = a.wins + static_cast<size_t>(pair) * a.wcap;
  const int rows = max(0, min(a.rlens[pair], a.r1 - 1));
  const int wlen = max(0, a.wlens[pair]);
  const int kmax = a.r1 + a.wcap - 1;  // the reference's last step

  Best best{0, 0, 0};
  if (rows > 0 && wlen > 0) {
    const int nb = (rows + WARP * R - 1) / (WARP * R);
    const bool clip = rows + wlen > kmax;
    for (int bnd = 0; bnd < nb; ++bnd) {
      const bool feeds = bnd + 1 < nb;
      if (clip) {
        band<R, true>(a, pair, lane, bnd, feeds, rows, wlen, kmax, read,
                      win, best);
      } else {
        band<R, false>(a, pair, lane, bnd, feeds, rows, wlen, kmax, read,
                       win, best);
      }
      __syncwarp();  // the band's scratch row and plane before their reads
    }
  }
#pragma unroll
  for (int off = WARP / 2; off > 0; off >>= 1) {
    const Best o{__shfl_xor_sync(FULL, best.v, off),
                 __shfl_xor_sync(FULL, best.k, off),
                 __shfl_xor_sync(FULL, best.i, off)};
    if (better(o.v, o.k, o.i, best)) {
      best = o;
    }
  }
  // The walk back from the best cell, ops/swalign.py::traceback's, by
  // the whole warp: lane l reads the cell l steps on along the state's
  // direction (the diagonal in H, the row in E, the column in F), and a
  // ballot finds where the state's run ends, so a run of up to 32 cells
  // costs one round of loads instead of 32 dependent ones. Lane 0 writes
  // the runs.
  const size_t b = a.b;
  int32_t* runs = a.runs + pair;
  const uint32_t* pl = a.plane + static_cast<size_t>(pair) * a.bands *
                                     a.plane_steps * WARP;
  int i = best.i, j = best.k - best.i, n = 0;
  if (best.v > 0) {
    int state = 0;  // 0 H, 1 E, 2 F
    int op = -1, len = 0;
    auto emit = [&](int o, int cnt) {
      if (o == op) {
        len += cnt;
        return;
      }
      if (len > 0) {
        if (lane == 0) {
          runs[n * b] = (len << 2) | op;
        }
        ++n;
      }
      op = o;
      len = cnt;
    };
    for (;;) {
      const int ci = i - (state == 1 ? 0 : lane);
      const int cj = j - (state == 2 ? 0 : lane);
      uint32_t d = 0;  // row 0 and column 0 hold no bits
      if (ci > 0 && cj > 0) {
        const int q = ci - 1;
        const int bnd = q / (WARP * R);
        const int lq = (q - bnd * WARP * R) / R;
        const int r = q - bnd * WARP * R - lq * R;
        d = (__ldcg(pl + (static_cast<size_t>(bnd) * a.plane_steps + cj -
                          1 + lq) * WARP + lq) >>
             (4 * r)) & 15u;
      }
      if (state == 0) {  // diagonal steps while the source is diag
        const unsigned ends = __ballot_sync(FULL, (d & 3u) != 1u);
        const int m = ends ? __ffs(ends) - 1 : WARP;
        if (m > 0) {
          emit(OP_M, m);
          i -= m;
          j -= m;
        }
        if (m < WARP) {
          const uint32_t src = __shfl_sync(FULL, d, m) & 3u;
          if (src == 0u) {
            break;
          }
          state = static_cast<int>(src) - 1;  // E or F at this cell
        }
      } else {  // a gap: one op a cell up to the first that does not extend
        const uint32_t bit = state == 1 ? 4u : 8u;
        const unsigned ends = __ballot_sync(FULL, (d & bit) == 0u);
        const int m = ends ? __ffs(ends) : WARP;
        if (state == 1) {  // a gap in the read: window bases
          emit(OP_D, m);
          j -= m;
        } else {  // a gap in the window: read bases
          emit(OP_I, m);
          i -= m;
        }
        if (ends) {
          state = 0;
        }
      }
    }
    if (lane == 0) {
      runs[n * b] = (len << 2) | op;
    }
    ++n;
  }
  if (lane != 0) {
    return;
  }
  for (int lo = 0, hi = n - 1; lo < hi; ++lo, --hi) {
    const int32_t x = runs[lo * b];
    runs[lo * b] = runs[hi * b];
    runs[hi * b] = x;
  }
  a.meta[pair] = best.v;
  a.meta[b + pair] = best.i;
  a.meta[2 * b + pair] = best.k - best.i;
  a.meta[3 * b + pair] = i;
  a.meta[4 * b + pair] = j;
  a.meta[5 * b + pair] = n;
}

}  // namespace

extern "C" {

// The launch plan of a bucket of r1 read lanes (r1 - 1 rows) and wcap
// window columns: rows a lane (R), bands of 32R rows, pairs (warps) a
// block, int32 of device scratch a pair (the band boundary rows, 0 for
// one band), steps a band in the plane. The plane holds every column a
// cell can reach, ncols = r1 + wcap - 2 (j <= the last step - i): the
// inputs need not be read to size it, and words of columns past a
// pair's window are never written (the steps past wcap + 31 when no
// wlen passes wcap, as on the map path). No shared memory: the state is
// in registers and shuffles, the plane in device memory.
void swalign_plan(int r1, int wcap, int* rows_per_lane, int* bands,
                  int* pairs_per_block, int* scratch_ints,
                  int* plane_steps) {
  const int rows = max(r1 - 1, 1);
  const int ncols = max(r1 + wcap - 2, 1);
  const int r = min(R_MAX, (rows + WARP - 1) / WARP);
  *rows_per_lane = r;
  *bands = (rows + WARP * r - 1) / (WARP * r);
  *pairs_per_block = WARPS_PER_BLOCK;
  *scratch_ints = *bands > 1 ? 4 * (ncols + 1) : 0;
  *plane_steps = ncols + WARP - 1;
}

// One bucket: b pairs, r1 read lanes (lane 0 the boundary), wcap window
// columns. scratch: b x scratch_ints int32 where swalign_plan asks for
// it (may be null otherwise); plane: b x bands x plane_steps x 32
// uint32; meta: (6, b) int32, best, bi, bj, read_start, win_start, runs;
// runs: (r1 + wcap, b) int32, a pair's first meta[5] rows written.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for arguments the kernel does not take.
int swalign_launch(const void* reads_p, const void* rlens, const void* wins,
                   const void* wlens, const void* scores, int b, int r1,
                   int wcap, void* scratch, void* plane, void* meta,
                   void* runs, void* stream) {
  if (b < 1 || r1 < 1 || wcap < 1 || plane == nullptr || meta == nullptr ||
      runs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int r, bands, per_block, scratch_ints, plane_steps;
  swalign_plan(r1, wcap, &r, &bands, &per_block, &scratch_ints,
               &plane_steps);
  if (scratch_ints > 0 && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const uint8_t*>(reads_p),
               static_cast<const int32_t*>(rlens),
               static_cast<const uint8_t*>(wins),
               static_cast<const int32_t*>(wlens),
               static_cast<const int32_t*>(scores),
               b, r1, wcap, plane_steps - (WARP - 1), bands, plane_steps,
               static_cast<int32_t*>(scratch),
               static_cast<uint32_t*>(plane),
               static_cast<int32_t*>(meta),
               static_cast<int32_t*>(runs)};
  const dim3 grid((b + per_block - 1) / per_block);
  const dim3 block(per_block * WARP);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 1: sw_warp_kernel<1><<<grid, block, 0, s>>>(a); break;
    case 2: sw_warp_kernel<2><<<grid, block, 0, s>>>(a); break;
    case 3: sw_warp_kernel<3><<<grid, block, 0, s>>>(a); break;
    case 4: sw_warp_kernel<4><<<grid, block, 0, s>>>(a); break;
    case 5: sw_warp_kernel<5><<<grid, block, 0, s>>>(a); break;
    case 6: sw_warp_kernel<6><<<grid, block, 0, s>>>(a); break;
    case 7: sw_warp_kernel<7><<<grid, block, 0, s>>>(a); break;
    default: sw_warp_kernel<8><<<grid, block, 0, s>>>(a); break;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* swalign_kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

}  // extern "C"
