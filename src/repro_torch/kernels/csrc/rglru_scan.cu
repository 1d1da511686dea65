// RG-LRU linear recurrence (recurrentgemma), hand-written for sm_90a.
//
// Replaces repro/kernels/rglru_scan.py::rglru_scan_pallas (rglru_scan.py:38,
// kernel body _rglru_kernel :21).  For x, a [B, S, D] (both float32 or both
// bfloat16, contiguous) and h0 [B, D] float32 it computes, as
// repro_torch/kernels/ref.py::rglru_ref states it, in float32:
//   h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * x_t
// and writes every h_t [B, S, D] in x's dtype and h_final [B, D] float32.
//
// Bound on an H100 SXM: the bytes.  A step of a channel reads a and x and
// writes h (6 bytes in bfloat16) against about eight float operations and
// one square root: recurrentgemma-9b's prefill (S = 2048, D = 4096) moves
// about 50 MB, 0.015 ms at 3.35 TB/s.
//
// Design: the Pallas kernel transposes to [B, D, S] and pads D to its
// block; here the [B, S, D] layout stays, one thread per channel, so a
// warp's loads of one step are 32 neighbouring channels, and a ragged D is
// a bounds check.  The state is one register.  Each step depends on the
// one before, so the thread must never wait on device memory inside the
// walk: it holds a chunk of 32 steps of a and x in registers and issues
// the next chunk's loads before it walks the current one.  Blocks are one
// warp, so that D = 4096 at B = 1 gives 128 blocks for the 132 SMs; with
// one warp an SM, the chunk in flight is all that hides the memory's
// latency.  Left for later: a parallel (chunked) scan over S.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 32;     // channels per block
constexpr int kSteps = 32;       // time steps per chunk

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ x, const T* __restrict__ a,
                  const float* __restrict__ h0, T* __restrict__ y,
                  float* __restrict__ hf, int S, int D) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= D) return;                   // no barrier or shuffle below
  const size_t b = blockIdx.y;
  const T* xb = x + b * S * D + c;
  const T* ab = a + b * S * D + c;
  T* yb = y + b * S * D + c;
  float h = h0[b * D + c];

  // Raw values of the current chunk and of the next one in flight.
  T ca[kSteps], cx[kSteps], na[kSteps], nx[kSteps];
  auto fetch = [&](int t0, T (&ra)[kSteps], T (&rx)[kSteps]) {
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int t = t0 + i;
      const size_t at = static_cast<size_t>(t) * D;
      ra[i] = t < S ? ab[at] : T(0.f);
      rx[i] = t < S ? xb[at] : T(0.f);
    }
  };
  fetch(0, ca, cx);
  for (int t0 = 0; t0 < S; t0 += kSteps) {
    if (t0 + kSteps < S) fetch(t0 + kSteps, na, nx);
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      if (t0 + i < S) {
        const float at = to_float(ca[i]);
        const float bt = sqrtf(fmaxf(1.f - at * at, 0.f)) * to_float(cx[i]);
        h = fmaf(at, h, bt);
        store(yb + static_cast<size_t>(t0 + i) * D, h);
      }
    }
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      ca[i] = na[i];
      cx[i] = nx[i];
    }
  }
  hf[b * D + c] = h;
}

template <typename T>
cudaError_t launch(const void* x, const void* a, const float* h0, void* y,
                   float* hf, int B, int S, int D, cudaStream_t stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), h0,
      static_cast<T*>(y), hf, S, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) of `device` and returns
// cudaGetLastError() as an int (0 on success; cudaErrorInvalidValue for a
// dtype code it has no instance for).  dtype: 0 float32, 1 bfloat16, the
// same for x, a and y.  Every buffer is contiguous; y and hf are written in
// full.
int rglru_scan_fwd(const void* x, const void* a, const float* h0, void* y,
                   float* hf, int B, int S, int D, int dtype, int device,
                   void* stream) {
  if (B <= 0 || D <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = launch<float>(x, a, h0, y, hf, B, S, D, s); break;
    case 1: err = launch<__nv_bfloat16>(x, a, h0, y, hf, B, S, D, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
