// Flash attention (prefill and training), hand-written for sm_90a.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas
// (flash_attention.py:92, kernel body _flash_kernel :30).  For
// q [B, Sq, Hq, d] and k, v [B, Sk, Hkv, d] (float32 or bfloat16, the last
// axis contiguous, any other strides) it computes GQA attention with an
// online softmax, as repro_torch/kernels/ref.py::attention_ref states it:
//   - query head h reads KV head h / (Hq / Hkv);
//   - query i sits at position pos_offset + i (the caller passes Sk - Sq
//     for the reference's end alignment), key j at position j;
//   - causal: key j is seen where j <= pos; window w >= 0: where
//     j > pos - w; softcap c > 0: logits become c * tanh(s / c);
//   - a row that sees no key gives zeros;
//   - sums in float32, the output in q's dtype, contiguous [B, Sq, Hq, d].
// Head dims 16, 32, 64, 128 and 256 are template instances.
//
// Bound on an H100 SXM: 4 * B * Hq * d * (pairs seen) operations (two
// products, each a multiply and an add per pair and channel; half of
// Sq * Sk when causal and square) at the bf16 tensor-core peak of
// 989 TFLOP/s, against reading q, k, v and writing out once at 3.35 TB/s.
// For qwen3-1.7b's heads the bytes bound it below about a thousand
// tokens and the operations above.  This kernel does its products in
// float32 on the CUDA cores (no mma.sync or wgmma yet), so it cannot come
// near that bound: it is the simple kernel that is right, and tensor
// cores, TMA and a wider tile are the next step.
//
// Design: one block of 256 threads per (64-row query tile, query head,
// batch row).  The query tile and a 64-row K and V tile, widened to
// float32, sit in dynamic shared memory (rows of Q and K padded by one
// word so that the 16 threads reading 16 different rows hit 16 banks);
// each thread owns 4 query rows x 4 key columns of the logits tile and
// 4 rows x d/16 channels of the output accumulator, in registers.  Per
// K tile: logits (explicit fmaf: the library is built with -fmad=false),
// scale, cap and mask; the row max and row sum across the 16 threads of
// a row by warp shuffles; the running max, sum and accumulator rescaled
// as in the Pallas body; P through shared memory into P V.  K tiles
// wholly past the causal limit or before the window are not visited, the
// Pallas body's block skip, so a causal square call reads about half of
// K and V.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kT = 16;         // threads along each axis of a tile
constexpr int kMicro = 4;      // rows (and key columns) per thread
constexpr int kThreads = kT * kT;
constexpr float kNegInf = -1.0e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh;  // element strides (batch, sequence, head)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int Sq, Sk, Hq, Hkv;
  float scale, softcap;        // softcap <= 0: none
  int causal, window;          // window < 0: none
  int pos_offset;
};

template <int D>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float)) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Args a) {
  constexpr int kC = D / kT;   // output channels per thread
  extern __shared__ float smem[];
  float* Qs = smem;                     // [kBQ][D + 1]
  float* Ks = Qs + kBQ * (D + 1);       // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);       // [kBK][D]
  float* Ps = Vs + kBK * D;             // [kBQ][kBK + 1]

  const int tid = threadIdx.x;
  const int ty = tid / kT;
  const int tx = tid % kT;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D;
    const int c = e % D;
    const int s = q0 + r;
    Qs[r * (D + 1) + c] = s < a.Sq ? to_float(q[s * a.q_ss + c]) : 0.0f;
  }

  // The keys any row of this tile may see: [k_begin, k_end).
  const int q_lo = q0 + a.pos_offset;
  const int q_hi = min(q0 + kBQ, a.Sq) - 1 + a.pos_offset;
  int k_end = a.Sk;
  if (a.causal) k_end = min(k_end, q_hi + 1);
  int k_begin = 0;
  if (a.window >= 0) k_begin = max(0, q_lo - a.window + 1);
  k_begin = (k_begin / kBK) * kBK;

  float m[kMicro], l[kMicro], acc[kMicro][kC];
#pragma unroll
  for (int r = 0; r < kMicro; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[r][c] = 0.0f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();   // Q staged; the last tile's readers are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D;
      const int c = e % D;
      const int s = k0 + r;
      const bool in = s < a.Sk;
      Ks[r * (D + 1) + c] = in ? to_float(k[s * a.k_ss + c]) : 0.0f;
      Vs[r * D + c] = in ? to_float(v[s * a.v_ss + c]) : 0.0f;
    }
    __syncthreads();

    float s[kMicro][kMicro];
#pragma unroll
    for (int r = 0; r < kMicro; ++r)
#pragma unroll
      for (int j = 0; j < kMicro; ++j) s[r][j] = 0.0f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qa[kMicro], kb[kMicro];
#pragma unroll
      for (int r = 0; r < kMicro; ++r)
        qa[r] = Qs[(ty + kT * r) * (D + 1) + c];
#pragma unroll
      for (int j = 0; j < kMicro; ++j)
        kb[j] = Ks[(tx + kT * j) * (D + 1) + c];
#pragma unroll
      for (int r = 0; r < kMicro; ++r)
#pragma unroll
        for (int j = 0; j < kMicro; ++j)
          s[r][j] = fmaf(qa[r], kb[j], s[r][j]);
    }

#pragma unroll
    for (int r = 0; r < kMicro; ++r) {
      const int qp = q_lo + ty + kT * r;
      bool ok[kMicro];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        const int kp = k0 + tx + kT * j;
        float x = s[r][j] * a.scale;
        if (a.softcap > 0.0f) x = a.softcap * tanhf(x / a.softcap);
        ok[j] = kp < a.Sk && (!a.causal || kp <= qp) &&
                (a.window < 0 || kp > qp - a.window);
        s[r][j] = ok[j] ? x : kNegInf;
        mx = fmaxf(mx, s[r][j]);
      }
#pragma unroll
      for (int off = kT / 2; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        const float p = ok[j] ? expf(s[r][j] - m_new) : 0.0f;
        Ps[(ty + kT * r) * (kBK + 1) + tx + kT * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = kT / 2; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[kMicro], vv[kC];
#pragma unroll
      for (int r = 0; r < kMicro; ++r) p[r] = Ps[(ty + kT * r) * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < kC; ++c) vv[c] = Vs[j * D + tx + kT * c];
#pragma unroll
      for (int r = 0; r < kMicro; ++r)
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[r][c] = fmaf(p[r], vv[c], acc[r][c]);
    }
  }

  T* o = static_cast<T*>(a.o);
#pragma unroll
  for (int r = 0; r < kMicro; ++r) {
    const int s = q0 + ty + kT * r;
    if (s >= a.Sq) continue;
    const float inv = 1.0f / (l[r] == 0.0f ? 1.0f : l[r]);
    T* row = o + ((static_cast<long long>(b) * a.Sq + s) * a.Hq + h) * D;
#pragma unroll
    for (int c = 0; c < kC; ++c) store(row + tx + kT * c, acc[r][c] * inv);
  }
}

template <int D, typename T>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.Hq, B);
  flash_attention_kernel<D, T><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Args& a, int B, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<16, T>(a, B, stream);
    case 32: return launch<32, T>(a, B, stream);
    case 64: return launch<64, T>(a, B, stream);
    case 128: return launch<128, T>(a, B, stream);
    case 256: return launch<256, T>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) of `device` and returns
// cudaGetLastError() as an int (0 on success; cudaErrorInvalidValue for a
// head dim or dtype code it has no instance for).  dtype: 0 float32,
// 1 bfloat16, the same for q, k, v and out.  Strides are in elements;
// out is a contiguous [B, Sq, Hq, d] buffer, written in full.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                        long long q_sb, long long q_ss, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        int B, int Sq, int Sk, int Hq, int Hkv, int d,
                        int dtype, float scale, float softcap, int causal,
                        int window, int pos_offset, int device,
                        void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{q, k, v, out, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
               v_sh, Sq, Sk, Hq, Hkv, scale, softcap, causal, window,
               pos_offset};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = launch_d<float>(a, B, d, s); break;
    case 1: err = launch_d<__nv_bfloat16>(a, B, d, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
