// Mamba-1 selective scan, hand-written for sm_90a.
//
// Replaces repro/kernels/selective_scan.py::selective_scan_pallas
// (selective_scan.py:50, kernel body _sscan_kernel :26).  For x, dt
// [Bt, S, Di] (float32 or bfloat16 each), A [Di, N], B, C [Bt, S, N],
// D [Di] and h0 [Bt, Di, N] (all float32, contiguous) it computes, as
// repro_torch/kernels/ref.py::selective_scan_ref states it, in float32:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
//   y_t = sum_n h_t[n] * C_t[n] + D * x_t
// and writes y [Bt, S, Di] in x's dtype and h_final [Bt, Di, N] float32.
// N <= 16 (every published Mamba-1 model has N = 16).
//
// Bound on an H100 SXM: the special-function units.  Every (step, channel,
// state) needs one exp, and the SMs' SFUs issue 16 a clock each: at
// falcon-mamba-7b's prefill (S = 2048, Di = 8192, N = 16) that is 268 M
// exps, about 0.064 ms at 1.98 GHz, against about 0.040 ms for the bytes
// (x and y in bfloat16, dt in float32, each read or written once).
//
// Design: the Pallas kernel transposes to [Bt, Di, S] and pads Di to its
// block because TPU lanes want a channel vector per step; here the
// [Bt, S, Di] layout stays, so a warp's loads of one time step cover
// neighbouring channels, and a ragged Di is a bounds check.  The grid is
// (channel blocks of 32, batch rows).  Each channel gets 4 threads (a
// quad), each holding up to 4 of its N states in registers (state
// n = lane + 4 j), so a block is 128 threads and falcon-mamba's Di = 8192
// gives 256 blocks at B = 1 (one thread per channel would give 64 blocks
// of 128 threads for 132 SMs, and 16 serial exps a step in each thread).
// The quad sums its partial y_t with two shuffles.  B_t and C_t are shared
// by all channels: a block stages a chunk of 32 steps of x, dt, B and C in
// shared memory, and while it walks one chunk it already has the next
// chunk's global loads in flight (registers, then the other shared buffer),
// so no step waits on device memory.  y goes through shared memory too and
// is written a chunk at a time, coalesced.  The Pallas wrapper's chunk of
// 256 steps (models/ssm.py::_scan_chunked) existed only because a block
// held (bd, S) in VMEM; this kernel streams S, so a whole prompt is one
// launch, and h0 / h_final still let a sequence be split across calls.
// Left for later: a parallel (chunked) scan over S for small Bt * Di.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kChannels = 32;                   // channels per block
constexpr int kLanes = 4;                       // threads per channel
constexpr int kThreads = kChannels * kLanes;    // 128
constexpr int kMaxN = 16;
constexpr int kPerLane = kMaxN / kLanes;        // states per thread
constexpr int kSteps = 32;                      // time steps per chunk
constexpr int kXPer = kSteps * kChannels / kThreads;   // x values a thread
constexpr int kBPer = kSteps * kMaxN / kThreads;       // B values a thread

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename TX, typename TD>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const TX* __restrict__ x, const TD* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ Dskip,
                      const float* __restrict__ h0, TX* __restrict__ y,
                      float* __restrict__ hf, int S, int Di, int N) {
  __shared__ float xs[2][kSteps][kChannels];
  __shared__ float dts[2][kSteps][kChannels];
  __shared__ float bs[2][kSteps][kMaxN];
  __shared__ float cs[2][kSteps][kMaxN];
  __shared__ float ys[2][kSteps][kChannels];

  const int tid = threadIdx.x;
  const int cl = tid / kLanes;                  // channel in the block
  const int q = tid % kLanes;                   // lane in the quad
  const int c0 = blockIdx.x * kChannels;
  const int c = c0 + cl;
  const size_t b = blockIdx.y;
  const TX* xb = x + b * S * Di;
  const TD* dtb = dt + b * S * Di;
  const float* Bb = Bm + b * S * N;
  const float* Cb = Cm + b * S * N;
  TX* yb = y + b * S * Di;

  // States past N and channels past Di hold 0 with A = 0: their B and C
  // are staged as 0, so they stay 0 and add nothing to y.
  float Av[kPerLane], h[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int n = q + kLanes * j;
    const bool on = c < Di && n < N;
    Av[j] = on ? A[static_cast<size_t>(c) * N + n] : 0.f;
    h[j] = on ? h0[(b * Di + c) * N + n] : 0.f;
  }
  const float Dc = c < Di ? Dskip[c] : 0.f;

  // One chunk's global loads into registers (fetch), then into shared
  // buffer `buf` (stash).  A warp loads one step's 32 channels together.
  float rx[kXPer], rdt[kXPer], rb[kBPer], rc[kBPer];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int i = 0; i < kXPer; ++i) {
      const int e = tid + i * kThreads;
      const int t = t0 + e / kChannels, ch = c0 + e % kChannels;
      const bool in = t < S && ch < Di;
      const size_t at = static_cast<size_t>(t) * Di + ch;
      rx[i] = in ? to_float(xb[at]) : 0.f;
      rdt[i] = in ? to_float(dtb[at]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int e = tid + i * kThreads;
      const int t = t0 + e / kMaxN, n = e % kMaxN;
      const bool in = t < S && n < N;
      const size_t at = static_cast<size_t>(t) * N + n;
      rb[i] = in ? Bb[at] : 0.f;
      rc[i] = in ? Cb[at] : 0.f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kXPer; ++i) {
      const int e = tid + i * kThreads;
      xs[buf][e / kChannels][e % kChannels] = rx[i];
      dts[buf][e / kChannels][e % kChannels] = rdt[i];
    }
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int e = tid + i * kThreads;
      bs[buf][e / kMaxN][e % kMaxN] = rb[i];
      cs[buf][e / kMaxN][e % kMaxN] = rc[i];
    }
  };

  const int chunks = (S + kSteps - 1) / kSteps;
  if (chunks > 0) {
    fetch(0);
    stash(0);
  }
  __syncthreads();
  for (int k = 0; k < chunks; ++k) {
    const int cur = k & 1;
    const int t0 = k * kSteps;
    if (k + 1 < chunks) fetch(t0 + kSteps);     // in flight during the walk
    const int steps = min(kSteps, S - t0);
#pragma unroll 4
    for (int tt = 0; tt < steps; ++tt) {
      const float xv = xs[cur][tt][cl];
      const float dtv = dts[cur][tt][cl];
      const float dtx = dtv * xv;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int n = q + kLanes * j;
        const float dA = expf(dtv * Av[j]);
        h[j] = fmaf(dA, h[j], dtx * bs[cur][tt][n]);
        acc = fmaf(h[j], cs[cur][tt][n], acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (q == 0) ys[cur][tt][cl] = acc + Dc * xv;
    }
    if (k + 1 < chunks) stash(cur ^ 1);
    __syncthreads();
    // Chunk k's outputs, a warp writing one step's 32 channels.  ys[cur]
    // is written again only after the next chunk's barrier.
#pragma unroll
    for (int i = 0; i < kXPer; ++i) {
      const int e = tid + i * kThreads;
      const int t = t0 + e / kChannels, ch = c0 + e % kChannels;
      if (t < S && ch < Di)
        store(yb + static_cast<size_t>(t) * Di + ch,
              ys[cur][e / kChannels][e % kChannels]);
    }
  }
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int n = q + kLanes * j;
    if (c < Di && n < N) hf[(b * Di + c) * N + n] = h[j];
  }
}

template <typename TX, typename TD>
cudaError_t launch(const void* x, const void* dt, const float* A,
                   const float* B, const float* C, const float* D,
                   const float* h0, void* y, float* hf, int Bt, int S,
                   int Di, int N, cudaStream_t stream) {
  const dim3 grid((Di + kChannels - 1) / kChannels, Bt);
  selective_scan_kernel<TX, TD><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TD*>(dt), A, B, C, D, h0,
      static_cast<TX*>(y), hf, S, Di, N);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch_dt(int dt_dtype, const void* x, const void* dt,
                      const float* A, const float* B, const float* C,
                      const float* D, const float* h0, void* y, float* hf,
                      int Bt, int S, int Di, int N, cudaStream_t stream) {
  switch (dt_dtype) {
    case 0: return launch<TX, float>(x, dt, A, B, C, D, h0, y, hf, Bt, S,
                                     Di, N, stream);
    case 1: return launch<TX, __nv_bfloat16>(x, dt, A, B, C, D, h0, y, hf,
                                             Bt, S, Di, N, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) of `device` and returns
// cudaGetLastError() as an int (0 on success; cudaErrorInvalidValue for a
// dtype code it has no instance for or N outside 1..16).  Dtype codes:
// 0 float32, 1 bfloat16, for x (and y) and for dt.  Every buffer is
// contiguous; y and hf are written in full.
int selective_scan_fwd(const void* x, const void* dt, const float* A,
                       const float* B, const float* C, const float* D,
                       const float* h0, void* y, float* hf, int Bt, int S,
                       int Di, int N, int x_dtype, int dt_dtype, int device,
                       void* stream) {
  if (N < 1 || N > kMaxN) return cudaErrorInvalidValue;
  if (Bt <= 0 || Di <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0:
      err = launch_dt<float>(dt_dtype, x, dt, A, B, C, D, h0, y, hf, Bt, S,
                             Di, N, s);
      break;
    case 1:
      err = launch_dt<__nv_bfloat16>(dt_dtype, x, dt, A, B, C, D, h0, y, hf,
                                     Bt, S, Di, N, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
