// Banded Smith-Waterman wavefront of one bucket of read/window pairs on
// Hopper (sm_90a): affine-gap local alignment in exact int32, with a
// direction-bit plane for the host traceback and each pair's best cell.
//
// Replaces the XLA program goleft_tpu/ops/swalign.py::_sw_bucket_impl (a
// vmapped lax.fori_loop of r1 + w_pad steps, no Pallas), the mapper's
// extend stage. It computes exactly what that program computes:
//
//   lane i (0..r1-1) of step k (1..steps-1) is cell (i, j = k - i);
//   lane 0 is the boundary row: H enters it as 0, E and F as NEG;
//   a base is N (code 4) when it is padding or j lies outside the
//   window, and an N never matches;
//   H = max(0, H[i-1,j-1] + sub, E, F)
//   E = max(H[i,j-1] + open + ext, E[i,j-1] + ext)   (own lane)
//   F = max(H[i-1,j] + open + ext, F[i-1,j] + ext)   (lane i - 1)
//   invalid cells write h = 0, e = f = NEG and d = 0;
//   dirs[b, k, i]: bits 0-1 H's source (0 stop when h <= 0, 1 diag,
//   2 E, 3 F, in that tie order), bit 2 E extends (e_ext >= e_open),
//   bit 3 F extends; dirs[b, 0, :] = 0;
//   the best cell is the greatest h over valid cells, the earliest step
//   among equal values, then the smallest i; 0, 0, 0 when no h > 0.
//
// The reference takes the best cell step by step (strict `m > best`,
// then the first lane of the step). That equals the lexicographic
// (value, -k, -i) maximum over all cells, so each thread keeps its own
// best over its lanes (ascending) and steps (ascending) and the block
// reduces once at the end.
//
// Design (a simple kernel that is right): one block per pair, lane i on
// thread i mod blockDim (several lanes a thread for reads longer than
// the block), one barrier a step. A lane needs its own E and H of the
// step before, and lane i - 1's H of the two steps before and F of the
// step before: H is kept in three rotating rows, F in two, E in one (a
// lane reads and writes only its own E), 24 bytes a lane. They live in
// shared memory when 6 x r1 int32 fit in 40 KB (r1 up to 1,706, beside
// the 3 KB of the final reduction, under the 48 KB a block takes without
// an opt-in); a longer read keeps them in a device-memory scratch of
// 24 bytes a lane a pair, through the same code. swalign_plan is the one
// place that decides this: the wrapper allocates what it asks for.
// No length cap.
//
// What bounds it: at the main path's bucket (4,096 pairs of 150 bp reads,
// r1 161, w_pad 256, 417 steps) 2.7e8 lane-steps of about 32 integer
// operations each, against 275 MB of direction bits written once: by
// operations. The TPU program kept the whole loop in one XLA program;
// here the loop is inside the kernel, so a bucket is one launch instead
// of a Python loop of ~12,500 small ones.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t NEG = -(1 << 28);
constexpr int N_CODE = 4;
constexpr int MAX_THREADS = 256;
// dynamic shared memory for the wavefront rows: 6 int32 a lane
constexpr int kStateInts = 6;
constexpr size_t kSharedStateBytes = 40 * 1024;

__global__ void __launch_bounds__(MAX_THREADS)
sw_wavefront(const uint8_t* __restrict__ reads_p,
             const int32_t* __restrict__ rlens,
             const uint8_t* __restrict__ wins,
             const int32_t* __restrict__ wlens,
             const int32_t* __restrict__ scores, int r1, int wcap,
             int32_t* __restrict__ state_global, int32_t* __restrict__ best,
             int32_t* __restrict__ best_i, int32_t* __restrict__ best_j,
             uint8_t* __restrict__ dirs) {
  extern __shared__ int32_t smem[];
  __shared__ int32_t red_v[MAX_THREADS], red_k[MAX_THREADS],
      red_i[MAX_THREADS];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int steps = r1 + wcap;
  int32_t* st = state_global != nullptr
                    ? state_global + static_cast<size_t>(b) * kStateInts * r1
                    : smem;
  const uint8_t* read = reads_p + static_cast<size_t>(b) * r1;
  const uint8_t* win = wins + static_cast<size_t>(b) * wcap;
  uint8_t* dir = dirs + static_cast<size_t>(b) * steps * r1;
  const int rlen = rlens[b];
  const int wlen = wlens[b];
  const int32_t s_match = scores[0];
  const int32_t s_mis = scores[1];
  const int32_t s_ext = scores[3];
  // (h + open) + ext: int32 addition wraps, so the sum is the same
  const int32_t s_oe = scores[2] + scores[3];

  int32_t* h2p = st;            // H of step k - 2
  int32_t* h1p = st + r1;       // H of step k - 1
  int32_t* hcp = st + 2 * r1;   // H of step k
  int32_t* f1p = st + 3 * r1;   // F of step k - 1
  int32_t* fcp = st + 4 * r1;   // F of step k
  int32_t* e_own = st + 5 * r1; // E, own lane
  for (int i = t; i < r1; i += nt) {
    h2p[i] = 0;
    h1p[i] = 0;
    f1p[i] = NEG;
    e_own[i] = NEG;
    dir[i] = 0;  // step 0
  }
  __syncthreads();

  int32_t bv = 0, bk = 0, bi = 0;
  for (int k = 1; k < steps; ++k) {
    uint8_t* drow = dir + static_cast<size_t>(k) * r1;
    for (int i = t; i < r1; i += nt) {
      const int jj = k - i;
      const bool in_w = jj >= 1 && jj <= wlen;
      // the column is clamped to the window's width, as the reference
      // clips it: a wlen past wcap reads the last column, not the next
      // pair's row
      const int wb =
          in_w ? static_cast<int>(win[min(jj - 1, wcap - 1)]) : N_CODE;
      const bool valid = i >= 1 && i <= rlen && in_w;
      const int rb = read[i];
      const bool is_match = rb == wb && rb != N_CODE && wb != N_CODE;
      const int32_t sub = is_match ? s_match : s_mis;
      const int32_t h_diag = (i > 0 ? h2p[i - 1] : 0) + sub;
      const int32_t e_open = h1p[i] + s_oe;
      const int32_t e_ext = e_own[i] + s_ext;
      int32_t e = max(e_open, e_ext);
      const int32_t f_open = (i > 0 ? h1p[i - 1] : 0) + s_oe;
      const int32_t f_ext = (i > 0 ? f1p[i - 1] : NEG) + s_ext;
      int32_t f = max(f_open, f_ext);
      int32_t h = max(max(0, h_diag), max(e, f));
      uint8_t d = 0;
      if (valid) {
        const int src = h <= 0 ? 0 : h == h_diag ? 1 : h == e ? 2 : 3;
        d = static_cast<uint8_t>(src | (e_ext >= e_open ? 4 : 0) |
                                 (f_ext >= f_open ? 8 : 0));
        if (h > bv) {  // strict: keeps this thread's earliest (k, i)
          bv = h;
          bk = k;
          bi = i;
        }
      } else {
        h = 0;
        e = NEG;
        f = NEG;
      }
      hcp[i] = h;
      fcp[i] = f;
      e_own[i] = e;
      drow[i] = d;
    }
    __syncthreads();
    int32_t* tmp = h2p;
    h2p = h1p;
    h1p = hcp;
    hcp = tmp;
    tmp = f1p;
    f1p = fcp;
    fcp = tmp;
  }

  red_v[t] = bv;
  red_k[t] = bk;
  red_i[t] = bi;
  __syncthreads();
  if (t == 0) {
    int32_t v = red_v[0], kk = red_k[0], ii = red_i[0];
    for (int u = 1; u < nt; ++u) {
      const int32_t uv = red_v[u], uk = red_k[u], ui = red_i[u];
      if (uv > v || (uv == v && uv > 0 &&
                     (uk < kk || (uk == kk && ui < ii)))) {
        v = uv;
        kk = uk;
        ii = ui;
      }
    }
    best[b] = v;
    best_i[b] = ii;
    best_j[b] = kk - ii;
  }
}

}  // namespace

extern "C" {

// The launch plan of a bucket of r1 read lanes: threads a block (lanes
// round up to a warp, at most MAX_THREADS), and the int32 of device
// scratch a pair that swalign_launch needs (0 when the wavefront rows
// fit in shared memory).
void swalign_plan(int r1, int* threads, int* scratch_ints) {
  *threads = min(MAX_THREADS, max(32, (r1 + 31) / 32 * 32));
  const size_t bytes = static_cast<size_t>(kStateInts) * r1 * sizeof(int32_t);
  *scratch_ints = bytes <= kSharedStateBytes ? 0 : kStateInts * r1;
}

// One bucket: b pairs, r1 read lanes (lane 0 the boundary), wcap window
// columns. state: a device scratch of b x scratch_ints int32 where
// swalign_plan asks for one, else ignored (may be null). Writes best,
// best_i, best_j (b,) and dirs (b, r1 + wcap, r1), every byte. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.
int swalign_launch(const void* reads_p, const void* rlens, const void* wins,
                   const void* wlens, const void* scores, int b, int r1,
                   int wcap, void* state, void* best, void* best_i,
                   void* best_j, void* dirs, void* stream) {
  if (b < 1 || r1 < 1 || wcap < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int threads, scratch_ints;
  swalign_plan(r1, &threads, &scratch_ints);
  if (scratch_ints > 0 && state == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int32_t* rows = scratch_ints > 0 ? static_cast<int32_t*>(state) : nullptr;
  const size_t smem =
      rows != nullptr ? 0
                      : static_cast<size_t>(kStateInts) * r1 * sizeof(int32_t);
  sw_wavefront<<<b, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(reads_p),
      static_cast<const int32_t*>(rlens),
      static_cast<const uint8_t*>(wins), static_cast<const int32_t*>(wlens),
      static_cast<const int32_t*>(scores), r1, wcap, rows,
      static_cast<int32_t*>(best), static_cast<int32_t*>(best_i),
      static_cast<int32_t*>(best_j), static_cast<uint8_t*>(dirs));
  return static_cast<int>(cudaGetLastError());
}

const char* swalign_kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

}  // extern "C"
