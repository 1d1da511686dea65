// Tropical (min, +) matrix product, hand-written for sm_90a.
//
// Replaces repro/kernels/minplus.py::minplus_tiled_pallas (minplus.py:419,
// kernel body _minplus_kernel :404), which apsp_tiled_pallas (:448) squares
// with.  For A [M, K] and B [K, N] (float32, contiguous) it computes
//   out[i, j] = min(1e9, min_k A[i, k] + B[k, j]),
// the Pallas kernel's semantics: its accumulator starts at 1e9 and its
// padding is 1e9 (see repro_torch/kernels/ref.py::minplus_ref).  Each sum is
// rounded once (__fadd_rn) and min is exact, so the result is bit for bit
// the plain version's whatever the order over k.  Ragged edges are masked:
// a k beyond K contributes 1e9 + 1e9, which never wins against an
// accumulator that starts at 1e9, and rows or columns beyond M or N are
// not stored.
//
// Bound on an H100 SXM: 2 * M * N * K float32 operations (one add, one min)
// at 67 TFLOP/s, with no tensor-core form, against (M*K + K*N + M*N) * 4
// bytes at 3.35 TB/s; operations bound it at every square size above a
// few dozen, 0.108 ms at M = N = K = 1536.
//
// Design: the classic shared-memory tiling of a matrix product.  A block
// computes a 64 x 64 tile of out with 256 threads, each holding a 4 x 4 set
// of accumulators in registers (strided by 16 so that neighbouring threads
// read neighbouring words).  K is walked in steps of 16: the block stages
// A's 64 x 16 slab (transposed, k-major) and B's 16 x 64 slab in shared
// memory, and every thread then does 16 adds and 16 mins per 8 shared
// loads.  Left for later: double-buffered cp.async staging and larger
// register tiles.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kNoEdge = 1.0e9f;
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kMicro = 4;
constexpr int kT = kBM / kMicro;     // 16 threads along each tile axis
constexpr int kThreads = kT * kT;    // 256

__global__ void __launch_bounds__(kThreads)
minplus_kernel(const float* __restrict__ A, const float* __restrict__ B,
               float* __restrict__ out, int M, int N, int K) {
  __shared__ float As[kBK][kBM + 1];  // [k][i]; +1 breaks the store's
  __shared__ float Bs[kBK][kBN];      // bank conflicts; [k][j]
  const int ty = threadIdx.x / kT;
  const int tx = threadIdx.x % kT;
  const int i0 = blockIdx.y * kBM;
  const int j0 = blockIdx.x * kBN;
  float acc[kMicro][kMicro];
#pragma unroll
  for (int r = 0; r < kMicro; ++r)
#pragma unroll
    for (int c = 0; c < kMicro; ++c) acc[r][c] = kNoEdge;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = threadIdx.x; e < kBM * kBK; e += kThreads) {
      const int ii = e / kBK;         // A read along k: coalesced
      const int kk = e % kBK;
      const int i = i0 + ii;
      const int k = k0 + kk;
      As[kk][ii] = (i < M && k < K) ? A[static_cast<size_t>(i) * K + k]
                                    : kNoEdge;
    }
    for (int e = threadIdx.x; e < kBK * kBN; e += kThreads) {
      const int kk = e / kBN;
      const int jj = e % kBN;
      const int k = k0 + kk;
      const int j = j0 + jj;
      Bs[kk][jj] = (k < K && j < N) ? B[static_cast<size_t>(k) * N + j]
                                    : kNoEdge;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kMicro], b[kMicro];
#pragma unroll
      for (int r = 0; r < kMicro; ++r) a[r] = As[kk][ty + kT * r];
#pragma unroll
      for (int c = 0; c < kMicro; ++c) b[c] = Bs[kk][tx + kT * c];
#pragma unroll
      for (int r = 0; r < kMicro; ++r)
#pragma unroll
        for (int c = 0; c < kMicro; ++c)
          acc[r][c] = fminf(acc[r][c], __fadd_rn(a[r], b[c]));
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kMicro; ++r) {
    const int i = i0 + ty + kT * r;
#pragma unroll
    for (int c = 0; c < kMicro; ++c) {
      const int j = j0 + tx + kT * c;
      if (i < M && j < N) out[static_cast<size_t>(i) * N + j] = acc[r][c];
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) of `device` and returns
// cudaGetLastError() as an int (0 on success).  A [M, K], B [K, N] and
// out [M, N] are contiguous float32 device buffers; out is written in full.
int minplus_f32(const float* A, const float* B, float* out, int M, int N,
                int K, int device, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  minplus_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      A, B, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
