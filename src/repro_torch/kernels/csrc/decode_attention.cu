// Flash-decode: one new token's GQA attention over a KV cache, hand-written
// for sm_90a.
//
// Replaces repro/kernels/decode_attention.py::decode_attention_pallas
// (decode_attention.py:74, kernel body _decode_kernel :25).  For
// q [B, Hq, d] and caches k, v [B, S, Hkv, d] (float32 or bfloat16,
// contiguous) and lengths [B] (int32) it computes, as
// repro_torch/kernels/ref.py::decode_attention_ref states it:
//   - query head h reads KV head h / (Hq / Hkv);
//   - row b sees the cache positions p < lengths[b] (and p < S); with a
//     window w >= 0 only those with p >= lengths[b] - w; softcap c > 0
//     turns logits s into c * tanh(s / c);
//   - a row that sees no position (length 0) gives zeros;
//   - sums in float32, the output in q's dtype, contiguous [B, Hq, d].
// Head dims 16, 32, 64, 128 and 256 are template instances.
//
// Bound on an H100 SXM: the bytes.  Each valid K and V row is read once
// (2 * d * itemsize bytes per position and KV head) against about 4 * g * d
// operations on it, g = Hq / Hkv query rows: far below the 295 operations
// per byte at which bf16 compute would bind.  So the kernel's one job is
// to stream the valid rows of the cache at the memory rate.
//
// Design: one block of 8 warps per (chunk of up to 8 query rows of one KV
// head, KV head, batch row); qwen3-1.7b (g = 2) has one chunk, so a block
// reads its KV head's valid rows exactly once.  The chunk's query rows sit
// in registers, each lane holding d/32 channels.  The warps stride over the
// valid positions, 4 positions a step: each lane loads its channels of the
// 4 K rows and 4 V rows first (vector loads of up to 16 bytes, 8 loads in
// flight), then the 4 x rows dot products are reduced across the warp by
// shuffles, and one online-softmax update per query row folds the 4
// positions into the warp's running max, sum and accumulator.  At the end
// the 8 warps' partial states are merged through shared memory.  Only the
// valid positions are visited (the Pallas body's block skip, per
// position).  Left for later: a split over S (flash-decoding proper) to
// fill all 132 SMs when B * Hkv is small, and cp.async/TMA staging.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;       // query rows per block at most
constexpr int kUnroll = 4;     // positions per warp step
constexpr float kNegInf = -1.0e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// A 32-bit word of T values, widened exactly to float.
__device__ __forceinline__ void unpack(uint32_t w, float* out, float) {
  out[0] = __uint_as_float(w);
}
__device__ __forceinline__ void unpack(uint32_t w, float* out,
                                       __nv_bfloat16) {
  out[0] = __uint_as_float(w << 16);            // low half: first value
  out[1] = __uint_as_float(w & 0xffff0000u);
}

// E consecutive T values from `src` into float: 16-byte loads where the E
// values fill them, else one 8- or 4-byte load, else a scalar load.
// The wrapper checks that the buffers are 16-byte aligned; every lane's
// offset is a multiple of E values.
template <int E, typename T>
__device__ __forceinline__ void load_vec(const T* src, float (&dst)[E]) {
  constexpr int kBytes = E * static_cast<int>(sizeof(T));
  constexpr int kPer = 4 / static_cast<int>(sizeof(T));   // values a word
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      const uint4 w = reinterpret_cast<const uint4*>(src)[i];
      unpack(w.x, dst + i * 4 * kPer + 0 * kPer, T());
      unpack(w.y, dst + i * 4 * kPer + 1 * kPer, T());
      unpack(w.z, dst + i * 4 * kPer + 2 * kPer, T());
      unpack(w.w, dst + i * 4 * kPer + 3 * kPer, T());
    }
  } else if constexpr (kBytes == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(src);
    unpack(w.x, dst, T());
    unpack(w.y, dst + kPer, T());
  } else if constexpr (kBytes == 4) {
    unpack(*reinterpret_cast<const uint32_t*>(src), dst, T());
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) dst[e] = to_float(src[e]);
  }
}

template <int D>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float)) * kWarps * kRows * (D + 2);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc,
                        const int* __restrict__ lengths, T* __restrict__ o,
                        int S, int Hq, int Hkv, float scale, float softcap,
                        int window) {
  constexpr int E = D >= 32 ? D / 32 : 1;      // channels per lane
  extern __shared__ float smem[];
  float* sm_m = smem;                           // [kWarps][kRows]
  float* sm_l = sm_m + kWarps * kRows;          // [kWarps][kRows]
  float* sm_acc = sm_l + kWarps * kRows;        // [kWarps][kRows][D]

  const int g = Hq / Hkv;
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, g - r0);
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool active = lane * E < D;             // d = 16: half the lanes
  const int c0 = active ? lane * E : 0;

  const long long qrow0 = static_cast<long long>(b) * Hq + hk * g + r0;
  float qr[kRows][E];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int e = 0; e < E; ++e) qr[r][e] = 0.0f;
    if (r < nr && active) load_vec<E, T>(q + (qrow0 + r) * D + c0, qr[r]);
  }

  const int raw = lengths[b];
  const int p_end = min(raw, S);
  const int p_begin = window >= 0 ? max(0, raw - window) : 0;
  const long long pos_stride = static_cast<long long>(Hkv) * D;
  const T* kb = kc + static_cast<long long>(b) * S * pos_stride + hk * D + c0;
  const T* vb = vc + static_cast<long long>(b) * S * pos_stride + hk * D + c0;

  float m[kRows], l[kRows], acc[kRows][E];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.0f;
  }

  for (int p0 = p_begin + warp * kUnroll; p0 < p_end;
       p0 += kWarps * kUnroll) {
    float kr[kUnroll][E], vr[kUnroll][E];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int e = 0; e < E; ++e) kr[u][e] = vr[u][e] = 0.0f;
      if (p0 + u < p_end && active) {
        load_vec<E, T>(kb + (p0 + u) * pos_stride, kr[u]);
        load_vec<E, T>(vb + (p0 + u) * pos_stride, vr[u]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= nr) break;                       // uniform across the block
      float s[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float dot = 0.0f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qr[r][e], kr[u][e], dot);
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        float x = dot * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        s[u] = p0 + u < p_end ? x : kNegInf;
      }
      float m_new = m[r];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) m_new = fmaxf(m_new, s[u]);
      const float alpha = expf(m[r] - m_new);
      float p[kUnroll];
      float sum = 0.0f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u] = p0 + u < p_end ? expf(s[u] - m_new) : 0.0f;
        sum += p[u];
      }
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float x = acc[r][e] * alpha;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) x = fmaf(p[u], vr[u][e], x);
        acc[r][e] = x;
      }
    }
  }

  // Merge the warps' partial states.  A warp that saw no position holds
  // m = -1e30, l = 0 and a zero accumulator, so it adds nothing.
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= nr) break;
    if (lane == 0) {
      sm_m[warp * kRows + r] = m[r];
      sm_l[warp * kRows + r] = l[r];
    }
    if (active) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        sm_acc[(warp * kRows + r) * D + c0 + e] = acc[r][e];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nr * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * kRows + r]);
    float L = 0.0f, A = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w * kRows + r] - mx);
      L = fmaf(sm_l[w * kRows + r], f, L);
      A = fmaf(sm_acc[(w * kRows + r) * D + c], f, A);
    }
    store(o + (qrow0 + r) * D + c, A / (L == 0.0f ? 1.0f : L));
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* o, int B, int S, int Hq,
                   int Hkv, float scale, float softcap, int window,
                   cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<D, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int g = Hq / Hkv;
  const dim3 grid((g + kRows - 1) / kRows, Hkv, B);
  decode_attention_kernel<D, T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), S, Hq, Hkv,
      scale, softcap, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v,
                     const int* lengths, void* o, int B, int S, int Hq,
                     int Hkv, float scale, float softcap, int window,
                     cudaStream_t stream) {
  switch (d) {
    case 16: return launch<16, T>(q, k, v, lengths, o, B, S, Hq, Hkv, scale,
                                  softcap, window, stream);
    case 32: return launch<32, T>(q, k, v, lengths, o, B, S, Hq, Hkv, scale,
                                  softcap, window, stream);
    case 64: return launch<64, T>(q, k, v, lengths, o, B, S, Hq, Hkv, scale,
                                  softcap, window, stream);
    case 128: return launch<128, T>(q, k, v, lengths, o, B, S, Hq, Hkv,
                                    scale, softcap, window, stream);
    case 256: return launch<256, T>(q, k, v, lengths, o, B, S, Hq, Hkv,
                                    scale, softcap, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) of `device` and returns
// cudaGetLastError() as an int (0 on success; cudaErrorInvalidValue for a
// head dim or dtype code it has no instance for).  dtype: 0 float32,
// 1 bfloat16, the same for q, the caches and out.  q [B, Hq, d], the
// caches [B, S, Hkv, d] and out [B, Hq, d] are contiguous and 16-byte
// aligned; lengths is [B] int32; out is written in full.
int decode_attention_fwd(const void* q, const void* k_cache,
                         const void* v_cache, const int* lengths, void* out,
                         int B, int S, int Hq, int Hkv, int d, int dtype,
                         float scale, float softcap, int window, int device,
                         void* stream) {
  if (B <= 0 || Hq <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = launch_d<float>(d, q, k_cache, v_cache, lengths, out, B, S, Hq,
                            Hkv, scale, softcap, window, s);
      break;
    case 1:
      err = launch_d<__nv_bfloat16>(d, q, k_cache, v_cache, lengths, out, B,
                                    S, Hq, Hkv, scale, softcap, window, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
