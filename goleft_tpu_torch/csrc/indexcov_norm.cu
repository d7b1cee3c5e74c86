// indexcov's cross-sample normalisation, pass 2: normalise and 7-tap
// smooth every sample lane of a chromosome's (samples x bins) depth
// matrix, given the per-bin cohort scalars (m, skip) of the host's f64
// pass 1 (cohort/streaming.py::NormStats).
//
// Replaces the JAX package's cohort/streaming.py::apply_normalization, a
// jax.lax.scan over the bin axis (no Pallas kernel): per lane, bin by bin,
//   scaled   = valid_j ? col / m : col
//   smoothed = ((((((p0 + p1) + p2) + scaled) + r1/m) + r2/m) + r3/m) / 7
//   out      = skip ? col : (valid_j && j > 2 && j < len - 3 ? smoothed
//                                                             : scaled)
// with p0..p2 the lane's three previous outputs and r1..r3 its next three
// raw values (0 past the matrix). The recurrence runs along the bins, so
// the parallelism is across the lanes: one thread a sample lane, the three
// outputs and the three raw look-ahead values in registers, m and skip
// read as broadcasts (every thread of a warp reads the same bin's). A
// thread issues the loads of the next 8 bins (raw values, m, skip) before
// it computes the current 8, so a load's latency is paid once in 8 bins
// and not on every bin of the dependent chain.
//
// Bound: bytes. Each input value is read once and each output written
// once (8 bytes a cell; 2,504 samples x 15,195 bins of chr1 is 304 MB,
// 0.091 ms at 3.35 TB/s). The kernel reads row-major rows, so the
// 32 threads of a warp touch 32 rows (uncoalesced; each 32-byte sector
// serves one thread 8 bins running), and a cohort of a few thousand
// samples fills only a few blocks of the 132 SMs. A (bins, samples)
// layout or tiles staged in shared memory is later work.
//
// Arithmetic is the reference's order, operation by operation, with IEEE
// division (nvcc's default -prec-div=true) and built with -fmad=false, so
// the kernel is bitwise equal to its plain PyTorch version
// (ops/norm_kernel.py::apply_normalization_plain).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
// bins a thread walks between two batches of loads: the next batch's
// raw values, m and skip are in flight while this batch computes
constexpr int kAhead = 8;

__global__ void __launch_bounds__(kThreads)
norm_scan_kernel(const float* __restrict__ depths,
                 const int32_t* __restrict__ lengths,
                 const float* __restrict__ m_all,
                 const uint8_t* __restrict__ skip_all,
                 float* __restrict__ out, int n, int b) {
    const int s = blockIdx.x * kThreads + threadIdx.x;
    if (s >= n) return;
    const float* row = depths + (size_t)s * (size_t)b;
    float* orow = out + (size_t)s * (size_t)b;
    const int len = lengths[s];
    float p0 = 0.f, p1 = 0.f, p2 = 0.f;
    // c, r1..r3: raw bins j..j+3; nxt: bins j+4.. of the next batch
    float c = row[0];
    float r1 = b > 1 ? row[1] : 0.f;
    float r2 = b > 2 ? row[2] : 0.f;
    float r3 = b > 3 ? row[3] : 0.f;
    float nxt[kAhead], nm[kAhead];
    uint8_t nsk[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
        nxt[u] = 4 + u < b ? row[4 + u] : 0.f;
        nm[u] = u < b ? m_all[u] : 1.f;
        nsk[u] = u < b ? skip_all[u] : 1;
    }
    for (int j0 = 0; j0 < b; j0 += kAhead) {
        float cur[kAhead], cm[kAhead];
        uint8_t csk[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
            cur[u] = nxt[u];
            cm[u] = nm[u];
            csk[u] = nsk[u];
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
            const int k = j0 + kAhead + u;
            nxt[u] = k + 4 < b ? row[k + 4] : 0.f;
            nm[u] = k < b ? m_all[k] : 1.f;
            nsk[u] = k < b ? skip_all[k] : 1;
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
            const int j = j0 + u;
            if (j >= b) break;
            const float m = cm[u];
            const bool valid = len > j;
            const float scaled = valid ? c / m : c;
            float sm = p0 + p1;
            sm = sm + p2;
            sm = sm + scaled;
            sm = sm + r1 / m;
            sm = sm + r2 / m;
            sm = sm + r3 / m;
            sm = sm / 7.0f;
            const bool smooth = valid && j > 2 && j < len - 3;
            const float o = csk[u] ? c : (smooth ? sm : scaled);
            orow[j] = o;
            p0 = p1;
            p1 = p2;
            p2 = o;
            c = r1;
            r1 = r2;
            r2 = r3;
            r3 = cur[u];
        }
    }
}

}  // namespace

extern "C" {

// depths (n, b) f32 row-major, lengths (n,) i32, m (b,) f32, skip (b,) u8,
// out (n, b) f32; launches on ``stream``. Returns the cudaError_t of the
// launch (0 = launched; nothing is launched for an empty matrix).
int indexcov_norm_launch(const float* depths, const int32_t* lengths,
                         const float* m, const uint8_t* skip, float* out,
                         int n, int b, void* stream) {
    if (n <= 0 || b <= 0) return 0;
    const int grid = (n + kThreads - 1) / kThreads;
    norm_scan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        depths, lengths, m, skip, out, n, b);
    return (int)cudaGetLastError();
}

const char* indexcov_norm_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
