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
// Design: specialised warps.  A block covers 32 channels over all of S.
// - Producer warps (8) stream a and x a chunk of 64 steps at a time by
//   16-byte cp.async (plain loads where D % 8 breaks the alignment) into a
//   ring of four stages, three chunks (24 KB in bfloat16) in flight a
//   block.  For each landed chunk they compute b = sqrt(max(1 - a^2, 0)) x
//   in float32 (the correctly rounded sqrtf) and a in float32 into one of
//   two work buffers; steps past S get a = 1, b = 0, which leaves h as it
//   is.  (Measured on an H100: 8 producer warps against 4 took S = 2048
//   from 0.043 to 0.029 ms; 3 to 10 stages, or 128-step chunks, moved it
//   by under 4 %.)
// - One walker warp, a lane a channel, runs the recurrence over a work
//   buffer: LDS a, LDS b, h = fmaf(a, h, b), STS h over b; only the FMA is
//   carried from step to step, 16 steps a trip.
// - The producers write the walked chunk's h out in x's dtype, coalesced,
//   16 bytes a store, before they refill that work buffer.
// - Hand-offs: named barriers, FULL[j] (producers arrive, the walker
//   waits) and EMPTY[j] (the walker arrives, the producers wait) for work
//   buffer j; a producer reads only the ring and work entries it copied or
//   wrote itself, so producers never wait on each other.
// Each h_t is the same fmaf sequence from h0 as a serial walk of one
// channel.  Grid: (D / 32, B); at recurrentgemma-9b's D = 4096 and B = 1
// that is 128 blocks, one an SM (64 KB of shared memory in bfloat16).  A
// larger B * D (a batch of prompts) gives more blocks than SMs: three fit
// an SM at once (288 threads and 64 KB each), and the rest run in further
// waves, each block still walking all of S.
// Not taken: a chunked parallel scan over S, which would carry each chunk
// in as P h + L.  Its float32 rounding would depend on where a call's
// chunks fall, so a sequence split across two calls (h_final handed on as
// h0) would no longer equal one call, as chip_smoke.py requires bit for
// bit; and the serial walk (about 4 instructions, one 4-clock FMA on the
// chain, a step) is about 4 us of S = 2048, under the bytes bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

using mma_bf16::cp_async16;
using mma_bf16::cp_async_commit;
using mma_bf16::cp_async_wait;

constexpr int kCh = 32;                         // channels a block
constexpr int kProducers = 8;                   // producer warps
constexpr int kThreads = 32 * (1 + kProducers); // warp 0 walks
constexpr int kSteps = 64;                      // steps a chunk
constexpr int kStages = 4;                      // ring stages
constexpr int kVec = 8;                         // channels a producer item
constexpr int kItems = kSteps * kCh / kVec / (32 * kProducers);  // 1
constexpr int kUnroll = 16;                     // steps a walker trip
// Named barrier ids (0 is __syncthreads, which this kernel does not use).
constexpr int kFull = 1;                        // kFull + j, j = 0, 1
constexpr int kEmpty = 3;                       // kEmpty + j

static_assert(kSteps * kCh % (kVec * 32 * kProducers) == 0, "items");
static_assert(kSteps % kUnroll == 0, "walker trips");

template <typename T>
struct Smem {
  alignas(16) T a[kStages][kSteps][kCh];
  alignas(16) T x[kStages][kSteps][kCh];
  alignas(16) float af[2][kSteps][kCh];
  alignas(16) float bf[2][kSteps][kCh];         // b, then h once walked
};

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(kThreads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(kThreads) : "memory");
}

__device__ __forceinline__ void to_floats(const float* p, float (&v)[kVec]) {
#pragma unroll
  for (int i = 0; i < kVec; i += 4) {
    const float4 w = *reinterpret_cast<const float4*>(p + i);
    v[i] = w.x;
    v[i + 1] = w.y;
    v[i + 2] = w.z;
    v[i + 3] = w.w;
  }
}
__device__ __forceinline__ void to_floats(const __nv_bfloat16* p,
                                          float (&v)[kVec]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void from_floats(float* p, const float (&v)[kVec]) {
#pragma unroll
  for (int i = 0; i < kVec; i += 4)
    *reinterpret_cast<float4*>(p + i) =
        make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}
__device__ __forceinline__ void from_floats(__nv_bfloat16* p,
                                            const float (&v)[kVec]) {
  uint4 w;
  uint32_t* u = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    u[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = w;
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ x, const T* __restrict__ a,
                  const float* __restrict__ h0, T* __restrict__ y,
                  float* __restrict__ hf, float* __restrict__ h32, int S,
                  int D, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T>& sm = *reinterpret_cast<Smem<T>*>(smem_raw);

  const int c0 = blockIdx.x * kCh;
  const size_t b = blockIdx.y;
  const int K = (S + kSteps - 1) / kSteps;

  if (threadIdx.x < 32) {
    // The walker: lane = channel.
    const int lane = threadIdx.x;
    const int c = c0 + lane;
    float h = c < D ? h0[b * D + c] : 0.f;
    for (int k = 0; k < K; ++k) {
      const int j = k & 1;
      bar_sync(kFull + j);
      const int steps = min(kSteps, S - k * kSteps);
      for (int r = 0; r < steps; r += kUnroll) {
        float av[kUnroll], bv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          av[u] = sm.af[j][r + u][lane];
          bv[u] = sm.bf[j][r + u][lane];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          h = fmaf(av[u], h, bv[u]);
          sm.bf[j][r + u][lane] = h;
        }
      }
      bar_arrive(kEmpty + j);
    }
    if (c < D) hf[b * D + c] = h;
    return;
  }

  // The producers: item i of a chunk is (step r, channels col .. col + 7),
  // the same for every producer role, so each reads only what it wrote.
  const int p = threadIdx.x - 32;
  const T* ab = a + b * S * D;
  const T* xb = x + b * S * D;
  T* yb = y + b * S * D;
  auto item = [&](int i, int& r, int& col) {
    const int e = p + i * 32 * kProducers;
    r = e / (kCh / kVec);
    col = (e % (kCh / kVec)) * kVec;
  };
  auto fill = [&](int st, int k) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      int r, col;
      item(i, r, col);
      const int t = k * kSteps + r;
      if (vec) {
#pragma unroll
        for (int v = 0; v < kVec; v += kPer) {
          const bool in = t < S && c0 + col + v < D;
          const size_t at = static_cast<size_t>(t) * D + c0 + col + v;
          cp_async16(&sm.a[st][r][col + v], in ? ab + at : ab, in);
          cp_async16(&sm.x[st][r][col + v], in ? xb + at : xb, in);
        }
      } else {
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          const bool in = t < S && c0 + col + v < D;
          const size_t at = static_cast<size_t>(t) * D + c0 + col + v;
          sm.a[st][r][col + v] = in ? ab[at] : T(0.f);
          sm.x[st][r][col + v] = in ? xb[at] : T(0.f);
        }
      }
    }
  };
  auto compute = [&](int st, int k, int j) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      int r, col;
      item(i, r, col);
      const bool in = k * kSteps + r < S;
      float av[kVec], xv[kVec], bv[kVec];
      to_floats(&sm.a[st][r][col], av);
      to_floats(&sm.x[st][r][col], xv);
      // Past S the ring holds zeros: b = sqrt(1) 0 = 0 there already.
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        bv[v] = sqrtf(fmaxf(1.f - av[v] * av[v], 0.f)) * xv[v];
        av[v] = in ? av[v] : 1.f;
      }
      from_floats(&sm.af[j][r][col], av);
      from_floats(&sm.bf[j][r][col], bv);
    }
  };
  auto write_out = [&](int k, int j) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      int r, col;
      item(i, r, col);
      const int t = k * kSteps + r;
      if (t >= S) continue;
      float hv[kVec];
      to_floats(&sm.bf[j][r][col], hv);
      T* dst = yb + static_cast<size_t>(t) * D + c0 + col;
      if (vec) {
        if (c0 + col < D) from_floats(dst, hv);
      } else {
#pragma unroll
        for (int v = 0; v < kVec; ++v)
          if (c0 + col + v < D) store(dst + v, hv[v]);
      }
      if (h32 != nullptr) {           // every h in float32 as well
        float* d32 = h32 + (b * S + t) * D + c0 + col;
        if (vec) {
          if (c0 + col < D) from_floats(d32, hv);
        } else {
#pragma unroll
          for (int v = 0; v < kVec; ++v)
            if (c0 + col + v < D) d32[v] = hv[v];
        }
      }
    }
  };

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < K) fill(k, k);
    cp_async_commit();
  }
  for (int k = 0; k < K; ++k) {
    const int j = k & 1;
    cp_async_wait<kStages - 2>();   // this thread's copies of chunk k
    if (k + kStages - 1 < K) fill((k + kStages - 1) % kStages,
                                  k + kStages - 1);
    cp_async_commit();
    if (k >= 2) {
      bar_sync(kEmpty + j);         // chunk k - 2 walked
      write_out(k - 2, j);
    }
    compute(k % kStages, k, j);
    bar_arrive(kFull + j);
  }
  for (int k = K < 2 ? 0 : K - 2; k < K; ++k) {
    bar_sync(kEmpty + (k & 1));
    write_out(k, k & 1);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* a, const float* h0, void* y,
                   float* hf, float* h32, int B, int S, int D,
                   cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = D % 8 == 0 && aligned(x) && aligned(a) && aligned(y) &&
                   (h32 == nullptr || aligned(h32));
  constexpr int bytes = sizeof(Smem<T>);
  static bool sized = false;        // per instance, on the first launch
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        rglru_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const dim3 grid((D + kCh - 1) / kCh, B);
  rglru_scan_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), h0,
      static_cast<T*>(y), hf, h32, S, D, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) of `device` and returns
// cudaGetLastError() as an int (0 on success; cudaErrorInvalidValue for a
// dtype code it has no instance for).  dtype: 0 float32, 1 bfloat16, the
// same for x, a and y.  Every buffer is contiguous; y and hf are written in
// full, and so is h32 [B, S, D] unless it is null: every h in float32,
// which the backward (rglru_scan_bwd.cu) takes h_{t-1} from.  The writes
// leave y and hf as they are without them.
int rglru_scan_fwd(const void* x, const void* a, const float* h0, void* y,
                   float* hf, float* h32, int B, int S, int D, int dtype,
                   int device, void* stream) {
  if (B <= 0 || D <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = launch<float>(x, a, h0, y, hf, h32, B, S, D, s); break;
    case 1:
      err = launch<__nv_bfloat16>(x, a, h0, y, hf, h32, B, S, D, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
