// Batched Floyd-Warshall with shortest-path counts, hand-written for sm_90a.
//
// Replaces repro/kernels/minplus.py::fw_counts_pallas (kernel body
// _fw_counts_kernel), the PlaceIT scorer's hot spot.  For each placement b
// of W[B, V, V] (float32, zero diagonal, 1e9 = no edge) it computes the
// distances D and the shortest-path counts N, bit for bit equal to the plain
// version repro_torch/kernels/ref.py::fw_counts_ref:
//   N0 = 1 on finite off-diagonal edges, plus the identity;
//   at pivot k, row k and column k are masked out;
//   cand < D  -> D = cand, N = min(n_ik * n_kj, 1e30);
//   cand == D and cand < 1e8 -> N = min(N + min(n_ik * n_kj, 1e30), 1e30).
// Exactness: every float operation is one IEEE round-to-nearest op written
// with __fadd_rn / __fmul_rn, and the library is built with -fmad=false, so
// no multiply-add is contracted.  Cells that neither improve nor tie keep N
// unchanged, which equals the reference's N + 0.0 clipped at 1e30 because N
// is never negative and never above the clip.
//
// Bound on an H100 SXM.  One call does B * V * (V-1)^2 relaxations of 10
// float32 operations each as the reference writes them (add, mul, min, three
// compares, add, two selects, min), against 67 TFLOP/s outside the tensor
// cores (min-plus with counts has no tensor-core form), and moves 3 * B * V^2
// * 4 bytes (W read once, D and N written once) at 3.35 TB/s.  So it is
// bound by operations at the main path's shapes: about 24 us at B = 16,
// V = 216, and 0.26 ms at B = 16, V = 480.
//
// Design.  The TPU kernel keeps D and N of one placement in VMEM; here they
// take 2 * V^2 * 4 bytes (365 KiB at V = 216), more than the 227 KB of shared
// memory a block can have.  So one block of 1024 threads owns one placement,
// D and N live in device memory (B * 2 * V^2 * 4 bytes, 6 MB at B = 16,
// V = 216, so they stay in the 50 MB L2), and each warp walks whole rows so
// that neighbouring lanes touch neighbouring addresses.  At pivot k, row k
// and column k are read and never written, so after one barrier they are
// staged in shared memory, and one more barrier closes the pivot.
//
// What this leaves on the table: a call uses B of the 132 SMs (16 at the
// scorer's chunk), and every relaxation reads and writes D and N through L2
// instead of registers.  Thread-block clusters holding row slabs in
// distributed shared memory, or a grid over tiles, would fill the card.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kInfCut = 1.0e8f;
constexpr float kCountClip = 1.0e30f;
constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
fw_counts_kernel(const float* __restrict__ W, float* __restrict__ D,
                 float* __restrict__ N, int V) {
  extern __shared__ float smem[];
  float* row_d = smem;            // D[k, :]
  float* row_n = smem + V;        // N[k, :]
  float* col_d = smem + 2 * V;    // D[:, k]
  float* col_n = smem + 3 * V;    // N[:, k]

  const size_t vv = static_cast<size_t>(V) * V;
  const float* w = W + blockIdx.x * vv;
  float* d = D + blockIdx.x * vv;
  float* n = N + blockIdx.x * vv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int i = warp; i < V; i += n_warps) {
    for (int j = lane; j < V; j += 32) {
      const size_t ij = static_cast<size_t>(i) * V + j;
      const float x = w[ij];
      d[ij] = x;
      n[ij] = (i == j) ? 1.0f : (x < kInfCut ? 1.0f : 0.0f);
    }
  }
  __syncthreads();

  for (int k = 0; k < V; ++k) {
    for (int t = threadIdx.x; t < V; t += blockDim.x) {
      row_d[t] = d[static_cast<size_t>(k) * V + t];
      row_n[t] = n[static_cast<size_t>(k) * V + t];
      col_d[t] = d[static_cast<size_t>(t) * V + k];
      col_n[t] = n[static_cast<size_t>(t) * V + k];
    }
    __syncthreads();
    for (int i = warp; i < V; i += n_warps) {
      if (i == k) continue;
      const float d_ik = col_d[i];
      const float n_ik = col_n[i];
      float* d_row = d + static_cast<size_t>(i) * V;
      float* n_row = n + static_cast<size_t>(i) * V;
      for (int j = lane; j < V; j += 32) {
        if (j == k) continue;
        const float cand = __fadd_rn(d_ik, row_d[j]);
        const float d_ij = d_row[j];
        if (cand < d_ij) {
          d_row[j] = cand;
          n_row[j] = fminf(__fmul_rn(n_ik, row_n[j]), kCountClip);
        } else if (cand == d_ij && cand < kInfCut) {
          const float n_cand = fminf(__fmul_rn(n_ik, row_n[j]), kCountClip);
          n_row[j] = fminf(__fadd_rn(n_row[j], n_cand), kCountClip);
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) of `device` and returns
// cudaGetLastError() as an int (0 on success).  W, D and N are contiguous
// [B, V, V] float32 device buffers; D and N are written in full.
int fw_counts_f32(const float* W, float* D, float* N, int B, int V,
                  int device, void* stream) {
  if (B <= 0 || V <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = 4 * static_cast<size_t>(V) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fw_counts_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fw_counts_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      W, D, N, V);
  return static_cast<int>(cudaGetLastError());
}

const char* reprotorch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
