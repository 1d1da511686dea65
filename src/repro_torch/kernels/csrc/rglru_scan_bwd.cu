// Backward of the RG-LRU linear recurrence (recurrentgemma), hand-written
// for sm_90a.
//
// Replaces no TPU kernel: the JAX package differentiates its plain version
// (repro/kernels/ref.py::rglru_ref under jax.vjp).  This is the gradient of
// the port's forward kernel (rglru_scan.cu, which replaces
// repro/kernels/rglru_scan.py::rglru_scan_pallas), as
// repro_torch/kernels/ref.py::rglru_bwd_ref states it.  From x, a and dy
// [B, S, D] (one dtype, float32 or bfloat16), the forward's every h in
// float32, h32 [B, S, D], h0 [B, D] and dh_final [B, D] (or null: zeros),
// with s_t = sqrt(max(1 - a_t^2, 0)) and G_t = dy_t + a_{t+1} G_{t+1} walked
// from t = S down (a_{S+1} G_{S+1} = dh_final), in float32:
//   dx_t = G_t s_t      da_t = G_t (h_{t-1} + x_t s'_t)      dh0 = a_1 G_1
// with s' as jax.grad of the reference takes it: -a / s where 1 - a^2 >= 0
// (-a / 0 = -inf sign(a) where it is 0, so da is +-inf, or NaN where
// x G = 0), NaN where 1 - a^2 < 0.  Writes dx and da in x's dtype, dh0 in
// float32.
//
// Bound on an H100 SXM: the bytes.  A step of a channel reads a, x, dy (2
// bytes each in bfloat16) and h_{t-1} (4) and writes dx and da (2 each)
// against about ten float operations, one square root and one division:
// recurrentgemma-9b's training shape (B = 1, S = 4096, D = 4096) moves
// about 235 MB, 0.070 ms at 3.35 TB/s.
//
// Design: the forward's specialised warps, reversed in time.  A block
// covers 32 channels over all of S, walking chunks of 64 steps from the
// last to the first.
// - Producer warps (8) stream a, x, dy and h_{t-1} (h32 one row back; h0
//   for t = 0) a chunk at a time by 16-byte cp.async (plain loads where
//   D % 8 breaks the alignment) into a ring of three stages.  For each
//   landed chunk they compute, in float32, a, dy, s and q = h_{t-1} + x s'
//   into one of two work buffers; steps past S get a = 1, dy = 0, which
//   leave G as it is.
// - One walker warp, a lane a channel, carries G from the chunk's last step
//   to its first: G = fmaf(a_{t+1}, G, dy_t), with a_{t+1} the a it read
//   the step before (1 before the first): only the FMA is on the chain.  It
//   writes G over dy.
// - The producers then write dx = G s and da = G q in x's dtype, 16 bytes a
//   store, before they refill that work buffer.
// - Hand-offs as the forward's: named barriers FULL[j] and EMPTY[j] for
//   work buffer j; a producer reads only the ring and work entries it
//   copied or wrote itself.
// Grid (D / 32, B): at recurrentgemma-9b's D = 4096 and B = 1, 128 blocks,
// one an SM (124 KB of shared memory in bfloat16).
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
constexpr int kStages = 3;                      // ring stages
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
  alignas(16) T dy[kStages][kSteps][kCh];
  alignas(16) float hp[kStages][kSteps][kCh];   // h_{t-1}
  alignas(16) float af[2][kSteps][kCh];
  alignas(16) float gf[2][kSteps][kCh];         // dy, then G once walked
  alignas(16) float sf[2][kSteps][kCh];         // s
  alignas(16) float qf[2][kSteps][kCh];         // h_{t-1} + x s'
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
// s' where 1 - a^2 < 0.
__device__ __forceinline__ float quiet_nan() {
  return __int_as_float(0x7fc00000);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_bwd_kernel(const T* __restrict__ x, const T* __restrict__ a,
                 const T* __restrict__ dy, const float* __restrict__ h32,
                 const float* __restrict__ h0, const float* __restrict__ dhf,
                 T* __restrict__ dx, T* __restrict__ da,
                 float* __restrict__ dh0, int S, int D, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T>& sm = *reinterpret_cast<Smem<T>*>(smem_raw);

  const int c0 = blockIdx.x * kCh;
  const size_t b = blockIdx.y;
  const int K = (S + kSteps - 1) / kSteps;
  // Walk i takes chunk K - 1 - i.

  if (threadIdx.x < 32) {
    // The walker: lane = channel.
    const int lane = threadIdx.x;
    const int c = c0 + lane;
    float G = c < D && dhf != nullptr ? dhf[b * D + c] : 0.f;
    float an = 1.f;                             // a_{t+1}
    for (int i = 0; i < K; ++i) {
      const int j = i & 1;
      const int k = K - 1 - i;
      bar_sync(kFull + j);
      const int steps = min(kSteps, S - k * kSteps);
      for (int r = (steps + kUnroll - 1) / kUnroll * kUnroll - kUnroll;
           r >= 0; r -= kUnroll) {
        float av[kUnroll], gv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          av[u] = sm.af[j][r + u][lane];
          gv[u] = sm.gf[j][r + u][lane];
        }
#pragma unroll
        for (int u = kUnroll - 1; u >= 0; --u) {
          G = fmaf(an, G, gv[u]);
          an = av[u];
          sm.gf[j][r + u][lane] = G;
        }
      }
      bar_arrive(kEmpty + j);
    }
    if (c < D) dh0[b * D + c] = an * G;
    return;
  }

  // The producers: item i of a chunk is (step r, channels col .. col + 7),
  // the same for every producer role, so each reads only what it wrote.
  const int p = threadIdx.x - 32;
  const T* ab = a + b * S * D;
  const T* xb = x + b * S * D;
  const T* dyb = dy + b * S * D;
  const float* hb = h32 + b * S * D;
  T* dxb = dx + b * S * D;
  T* dab = da + b * S * D;
  auto item = [&](int i, int& r, int& col) {
    const int e = p + i * 32 * kProducers;
    r = e / (kCh / kVec);
    col = (e % (kCh / kVec)) * kVec;
  };
  // h_{t-1} of channel c: row t - 1 of h32, or h0 at t = 0.
  auto hprev = [&](int t, int c) -> const float* {
    return t > 0 ? hb + static_cast<size_t>(t - 1) * D + c : h0 + b * D + c;
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
          cp_async16(&sm.dy[st][r][col + v], in ? dyb + at : dyb, in);
        }
#pragma unroll
        for (int v = 0; v < kVec; v += 4) {
          const bool in = t < S && c0 + col + v < D;
          cp_async16(&sm.hp[st][r][col + v],
                     in ? hprev(t, c0 + col + v) : h0, in);
        }
      } else {
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          const bool in = t < S && c0 + col + v < D;
          const size_t at = static_cast<size_t>(t) * D + c0 + col + v;
          sm.a[st][r][col + v] = in ? ab[at] : T(0.f);
          sm.x[st][r][col + v] = in ? xb[at] : T(0.f);
          sm.dy[st][r][col + v] = in ? dyb[at] : T(0.f);
          sm.hp[st][r][col + v] = in ? *hprev(t, c0 + col + v) : 0.f;
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
      float av[kVec], xv[kVec], gv[kVec], hv[kVec], sv[kVec], qv[kVec];
      to_floats(&sm.a[st][r][col], av);
      to_floats(&sm.x[st][r][col], xv);
      to_floats(&sm.dy[st][r][col], gv);
      to_floats(&sm.hp[st][r][col], hv);
      // Past S the ring holds zeros: dy = 0 there already.
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const float u = 1.f - av[v] * av[v];
        sv[v] = sqrtf(fmaxf(u, 0.f));
        const float sp = u >= 0.f ? -av[v] / sv[v] : quiet_nan();
        qv[v] = hv[v] + xv[v] * sp;
        av[v] = in ? av[v] : 1.f;
      }
      from_floats(&sm.af[j][r][col], av);
      from_floats(&sm.gf[j][r][col], gv);
      from_floats(&sm.sf[j][r][col], sv);
      from_floats(&sm.qf[j][r][col], qv);
    }
  };
  auto write_out = [&](int k, int j) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      int r, col;
      item(i, r, col);
      const int t = k * kSteps + r;
      if (t >= S) continue;
      float gv[kVec], sv[kVec], qv[kVec], dxv[kVec], dav[kVec];
      to_floats(&sm.gf[j][r][col], gv);
      to_floats(&sm.sf[j][r][col], sv);
      to_floats(&sm.qf[j][r][col], qv);
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        dxv[v] = gv[v] * sv[v];
        dav[v] = gv[v] * qv[v];
      }
      const size_t at = static_cast<size_t>(t) * D + c0 + col;
      if (vec) {
        if (c0 + col < D) {
          from_floats(dxb + at, dxv);
          from_floats(dab + at, dav);
        }
      } else {
#pragma unroll
        for (int v = 0; v < kVec; ++v)
          if (c0 + col + v < D) {
            store(dxb + at + v, dxv[v]);
            store(dab + at + v, dav[v]);
          }
      }
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < K) fill(i, K - 1 - i);
    cp_async_commit();
  }
  for (int i = 0; i < K; ++i) {
    const int j = i & 1;
    cp_async_wait<kStages - 2>();   // this thread's copies of walk i
    if (i + kStages - 1 < K) fill((i + kStages - 1) % kStages,
                                  K - 1 - (i + kStages - 1));
    cp_async_commit();
    if (i >= 2) {
      bar_sync(kEmpty + j);         // walk i - 2 done
      write_out(K - 1 - (i - 2), j);
    }
    compute(i % kStages, K - 1 - i, j);
    bar_arrive(kFull + j);
  }
  for (int i = K < 2 ? 0 : K - 2; i < K; ++i) {
    bar_sync(kEmpty + (i & 1));
    write_out(K - 1 - i, i & 1);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* a, const void* dy,
                   const float* h32, const float* h0, const float* dhf,
                   void* dx, void* da, float* dh0, int B, int S, int D,
                   cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = D % 8 == 0 && aligned(x) && aligned(a) && aligned(dy) &&
                   aligned(h32) && aligned(h0) && aligned(dx) &&
                   aligned(da);
  constexpr int bytes = sizeof(Smem<T>);
  static bool sized = false;        // per instance, on the first launch
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        rglru_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const dim3 grid((D + kCh - 1) / kCh, B);
  rglru_bwd_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const T*>(dy), h32, h0, dhf, static_cast<T*>(dx),
      static_cast<T*>(da), dh0, S, D, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) of `device` and returns
// cudaGetLastError() as an int (0 on success; cudaErrorInvalidValue for a
// dtype code it has no instance for).  dtype: 0 float32, 1 bfloat16, the
// same for x, a, dy, dx and da; h32, h0, dhf and dh0 are float32.  Every
// buffer is contiguous; dhf may be null (zeros).  dx, da and dh0 are
// written in full.
int rglru_scan_bwd(const void* x, const void* a, const void* dy,
                   const float* h32, const float* h0, const float* dhf,
                   void* dx, void* da, float* dh0, int B, int S, int D,
                   int dtype, int device, void* stream) {
  if (B <= 0 || D <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = launch<float>(x, a, dy, h32, h0, dhf, dx, da, dh0, B, S, D, s);
      break;
    case 1:
      err = launch<__nv_bfloat16>(x, a, dy, h32, h0, dhf, dx, da, dh0, B, S,
                                  D, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
