// The backward of flash attention (training), hand-written for sm_90a.
//
// The gradient of repro/kernels/flash_attention.py::flash_attention_pallas
// (flash_attention.py:92), which has no backward of its own: the JAX
// package differentiates its plain version.  Here the forward
// (csrc/flash_attention.cu) leaves each query row's log-sum-exp lse, and
// this file computes, for q [B, Sq, Hq, d], k and v [B, Sk, Hkv, d], the
// forward's output o and its gradient dO (the last axis contiguous, any
// other strides, float32 or bfloat16), as
// repro_torch/kernels/ref.py::attention_bwd_ref states it:
//   s = scale q.k;  z = s, or c tanh(s / c) with a soft-cap c;
//   P = exp(z - lse) where the forward's mask sees the key (0 elsewhere,
//       and in a row with lse = -inf, which saw no key);
//   D = rowsum(dO o O);  dP = dO.v;  dZ = P (dP - D);
//   dS = dZ, or dZ (1 - tanh^2(s / c)) with a soft-cap;
//   dv = sum_i P dO_i;  dk = scale sum_i dS q_i;  dq = scale sum_j dS k_j;
// a KV head's dk and dv sum over its group of Hq / Hkv query heads.  The
// options are the forward's: causal or not, window, soft-cap, query
// offset (query i at position pos_offset + i), GQA, head dims 16 to 256.
// Sums in float32; dq, dk and dv in the operands' dtype, contiguous.
//
// Three kernels, each on the current stream, without atomics, so that
// repeated calls give the same bits:
//   1. flash_bwd_dot_kernel: D, one warp a row (the lanes over the
//      channels, then a butterfly of shuffles);
//   2. flash_bwd_dkdv_kernel: one block a (key tile, KV head, batch row);
//      it loops over the query heads of the group and, for each, over the
//      query tiles that can see the key tile (the causal limit and the
//      window cut the range), recomputes P and dS for the pair of tiles
//      and adds P^T dO and dS^T q into dk and dv held in registers;
//   3. flash_bwd_dq_kernel: one block a (query tile, query head, batch
//      row); it loops over the key tiles the query tile can see and adds
//      dS k into dq held in registers (the last query tiles of a causal
//      call, which see the most keys, are launched first).
// Both recompute the logits and dP: seven products a (query, key) pair
// and channel in all, where the forward has two.
//
// Bound on an H100 SXM: the five products of the gradient (the logits,
// dP, dv, dk, dq) are 10 B Hq d operations a (query, key) pair that the
// mask sees, at the bf16 tensor-core peak of 989 TFLOP/s, against reading
// q, k, v, o, dO and lse and writing dq, dk and dv once at 3.35 TB/s; at
// the training shapes (S = 2048) the operations bound it.  This first
// version runs on the CUDA cores in float32 (67 TFLOP/s at most, and
// every product here reads both operands from shared memory, two
// multiply-adds a load): far from the bound.  Its design: 256 threads as
// 16 x 16, tiles of 64 queries x 64 keys (32 x 32 at head dim 256, for
// shared memory), each thread 4 x 4 (2 x 2) entries of the logits tile
// and 4 (2) rows x d / 16 channels of its accumulators; q, dO, k and v
// tiles in float32 in dynamic shared memory, rows padded by one word so
// that the 16 rows a product step reads fall in 16 banks; P and dS
// through shared memory between the pair's logits and its products.
// Next steps: mma.sync or wgmma for the products, as the forward.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kT = 16;              // threads along each axis of a tile
constexpr int kThreads = kT * kT;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;            // [B, Hq, Sq]
  float* dsum;                 // [B, Hq, Sq]: D = rowsum(dO o O)
  void* dq;                    // [B, Sq, Hq, d], contiguous
  void* dk;                    // [B, Sk, Hkv, d], contiguous
  void* dv;
  long long q_sb, q_ss, q_sh;  // element strides (batch, sequence, head)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long g_sb, g_ss, g_sh;  // dO
  int Sq, Sk, Hq, Hkv;
  float scale, softcap;        // softcap <= 0: none
  int causal, window;          // window < 0: none
  int pos_offset;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Tiles of BT queries x BT keys; d = 256 takes 32 for shared memory.
template <int D>
struct Tile {
  static constexpr int kBT = D >= 256 ? 32 : 64;
  static constexpr int kM = kBT / kT;          // rows (keys) a thread
  static constexpr int kC = D / kT;            // channels a thread
  static constexpr int kLD = D + 1;            // padded row (floats)
  // q, dO, k, v tiles, then P and dS, then lse and D of the query rows.
  static constexpr int kSmem = static_cast<int>(sizeof(float)) *
      (4 * kBT * kLD + 2 * kBT * (kBT + 1) + 2 * kBT);
};

// ---------------------------------------------------------------------------
// 1. D = rowsum(dO o O)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dot_kernel(const BwdArgs a, int B, int d) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) +
                        threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(B) * a.Hq * a.Sq) return;
  const int i = static_cast<int>(row % a.Sq);
  const int h = static_cast<int>((row / a.Sq) % a.Hq);
  const int b = static_cast<int>(row / (static_cast<long long>(a.Sq) * a.Hq));
  const T* o = static_cast<const T*>(a.o) + b * a.o_sb + i * a.o_ss +
               h * a.o_sh;
  const T* g = static_cast<const T*>(a.dout) + b * a.g_sb + i * a.g_ss +
               h * a.g_sh;
  float acc = 0.0f;
  for (int c = lane; c < d; c += 32) acc = fmaf(ld(g + c), ld(o + c), acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.dsum[row] = acc;
}

// ---------------------------------------------------------------------------
// The pair of tiles shared by kernels 2 and 3.
// ---------------------------------------------------------------------------

// Rows [r0, r0 + BT) of a [B, S, H, d] operand, head h, into a padded
// float tile; rows past S are zero.
template <int D, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* base,
                                          long long ss, int r0, int S) {
  constexpr int BT = Tile<D>::kBT;
  constexpr int LD = Tile<D>::kLD;
  for (int e = threadIdx.x; e < BT * D; e += kThreads) {
    const int r = e / D;
    const int c = e % D;
    const int s = r0 + r;
    dst[r * LD + c] = s < S ? ld(base + s * ss + c) : 0.0f;
  }
}

// For the query tile at i0 (q, dO, lse and D staged) and the key tile at
// k0 (k and v staged): P and dS into Ps and dSs ([query][key]); Ps may be
// null (kernel 3 needs only dS).
template <int D>
__device__ __forceinline__ void pair_tiles(const BwdArgs& a, int i0, int k0,
                                           const float* Qs, const float* Gs,
                                           const float* Ks, const float* Vs,
                                           const float* lse_s,
                                           const float* dsum_s, float* Ps,
                                           float* dSs) {
  using C = Tile<D>;
  constexpr int M = C::kM;
  constexpr int LD = C::kLD;
  constexpr int BT = C::kBT;
  const int ty = threadIdx.x / kT;
  const int tx = threadIdx.x % kT;
  float s[M][M], dp[M][M];
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      s[r][j] = 0.0f;
      dp[r][j] = 0.0f;
    }
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float qa[M], ga[M], kb[M], vb[M];
#pragma unroll
    for (int r = 0; r < M; ++r) {
      qa[r] = Qs[(ty + kT * r) * LD + c];
      ga[r] = Gs[(ty + kT * r) * LD + c];
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
      kb[j] = Ks[(tx + kT * j) * LD + c];
      vb[j] = Vs[(tx + kT * j) * LD + c];
    }
#pragma unroll
    for (int r = 0; r < M; ++r)
#pragma unroll
      for (int j = 0; j < M; ++j) {
        s[r][j] = fmaf(qa[r], kb[j], s[r][j]);
        dp[r][j] = fmaf(ga[r], vb[j], dp[r][j]);
      }
  }
  const bool capped = a.softcap > 0.0f;
#pragma unroll
  for (int r = 0; r < M; ++r) {
    const int row = ty + kT * r;
    const int qi = i0 + row;
    const int qp = qi + a.pos_offset;
    const float lse = lse_s[row];
    const float dsum = dsum_s[row];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const int col = tx + kT * j;
      const int kp = k0 + col;
      const bool ok = qi < a.Sq && kp < a.Sk && lse != -INFINITY &&
                      (!a.causal || kp <= qp) &&
                      (a.window < 0 || kp > qp - a.window);
      float z = s[r][j] * a.scale;
      float t = 0.0f;
      if (capped) {
        t = tanhf(z / a.softcap);
        z = a.softcap * t;
      }
      const float p = ok ? expf(z - lse) : 0.0f;
      float ds = p * (dp[r][j] - dsum);
      if (capped) ds *= 1.0f - t * t;
      if (Ps != nullptr) Ps[row * (BT + 1) + col] = p;
      dSs[row * (BT + 1) + col] = ds;
    }
  }
}

// ---------------------------------------------------------------------------
// 2. dk and dv: one block a (key tile, KV head, batch row).
// ---------------------------------------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const BwdArgs a) {
  using C = Tile<D>;
  constexpr int BT = C::kBT;
  constexpr int M = C::kM;
  constexpr int NC = C::kC;
  constexpr int LD = C::kLD;
  extern __shared__ float smem[];
  float* Qs = smem;                     // [BT][LD]
  float* Gs = Qs + BT * LD;             // dO
  float* Ks = Gs + BT * LD;
  float* Vs = Ks + BT * LD;
  float* Ps = Vs + BT * LD;             // [BT][BT + 1]
  float* dSs = Ps + BT * (BT + 1);
  float* lse_s = dSs + BT * (BT + 1);   // [BT]
  float* dsum_s = lse_s + BT;

  const int ty = threadIdx.x / kT;
  const int tx = threadIdx.x % kT;
  const int k0 = blockIdx.x * BT;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  load_rows<D>(Ks, static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh,
               a.k_ss, k0, a.Sk);
  load_rows<D>(Vs, static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh,
               a.v_ss, k0, a.Sk);

  // The query rows that may see a key of [k0, k_last]: causal, position
  // >= k0; windowed, position < k_last + window.
  const int k_last = min(k0 + BT, a.Sk) - 1;
  int i_begin = 0;
  if (a.causal) i_begin = max(0, k0 - a.pos_offset);
  i_begin = (i_begin / BT) * BT;
  int i_end = a.Sq;
  if (a.window >= 0) i_end = min(i_end, k_last + a.window - a.pos_offset);

  float dk[M][NC], dv[M][NC];
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[r][c] = 0.0f;
      dv[r][c] = 0.0f;
    }

  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* g = static_cast<const T*>(a.dout) + b * a.g_sb + h * a.g_sh;
    const long long row0 = (static_cast<long long>(b) * a.Hq + h) * a.Sq;
    for (int i0 = i_begin; i0 < i_end; i0 += BT) {
      __syncthreads();   // the last pair's readers are done
      load_rows<D>(Qs, q, a.q_ss, i0, a.Sq);
      load_rows<D>(Gs, g, a.g_ss, i0, a.Sq);
      for (int r = threadIdx.x; r < BT; r += kThreads) {
        const bool in = i0 + r < a.Sq;
        lse_s[r] = in ? a.lse[row0 + i0 + r] : -INFINITY;
        dsum_s[r] = in ? a.dsum[row0 + i0 + r] : 0.0f;
      }
      __syncthreads();
      pair_tiles<D>(a, i0, k0, Qs, Gs, Ks, Vs, lse_s, dsum_s, Ps, dSs);
      __syncthreads();
      // dv[j] += sum_i P[i][j] dO[i];  dk[j] += sum_i dS[i][j] q[i]
#pragma unroll 4
      for (int i = 0; i < BT; ++i) {
        float p[M], ds[M], gc[NC], qc[NC];
#pragma unroll
        for (int r = 0; r < M; ++r) {
          p[r] = Ps[i * (BT + 1) + ty + kT * r];
          ds[r] = dSs[i * (BT + 1) + ty + kT * r];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          gc[c] = Gs[i * LD + tx + kT * c];
          qc[c] = Qs[i * LD + tx + kT * c];
        }
#pragma unroll
        for (int r = 0; r < M; ++r)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dv[r][c] = fmaf(p[r], gc[c], dv[r][c]);
            dk[r][c] = fmaf(ds[r], qc[c], dk[r][c]);
          }
      }
    }
  }

  T* dk_out = static_cast<T*>(a.dk);
  T* dv_out = static_cast<T*>(a.dv);
#pragma unroll
  for (int r = 0; r < M; ++r) {
    const int s = k0 + ty + kT * r;
    if (s >= a.Sk) continue;
    const long long base =
        ((static_cast<long long>(b) * a.Sk + s) * a.Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      st(dk_out + base + tx + kT * c, dk[r][c] * a.scale);
      st(dv_out + base + tx + kT * c, dv[r][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dq: one block a (query tile, query head, batch row).
// ---------------------------------------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const BwdArgs a) {
  using C = Tile<D>;
  constexpr int BT = C::kBT;
  constexpr int M = C::kM;
  constexpr int NC = C::kC;
  constexpr int LD = C::kLD;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Gs = Qs + BT * LD;
  float* Ks = Gs + BT * LD;
  float* Vs = Ks + BT * LD;
  float* Ps = Vs + BT * LD;             // unused here
  float* dSs = Ps + BT * (BT + 1);
  float* lse_s = dSs + BT * (BT + 1);
  float* dsum_s = lse_s + BT;

  const int ty = threadIdx.x / kT;
  const int tx = threadIdx.x % kT;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const long long row0 = (static_cast<long long>(b) * a.Hq + h) * a.Sq;
  load_rows<D>(Qs, static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh,
               a.q_ss, i0, a.Sq);
  load_rows<D>(Gs, static_cast<const T*>(a.dout) + b * a.g_sb + h * a.g_sh,
               a.g_ss, i0, a.Sq);
  for (int r = threadIdx.x; r < BT; r += kThreads) {
    const bool in = i0 + r < a.Sq;
    lse_s[r] = in ? a.lse[row0 + i0 + r] : -INFINITY;
    dsum_s[r] = in ? a.dsum[row0 + i0 + r] : 0.0f;
  }
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  // The keys the tile's queries may see, as the forward's key_range.
  const int q_lo = i0 + a.pos_offset;
  const int q_hi = min(i0 + BT, a.Sq) - 1 + a.pos_offset;
  int k_end = a.Sk;
  if (a.causal) k_end = min(k_end, q_hi + 1);
  int k_begin = 0;
  if (a.window >= 0) k_begin = max(0, q_lo - a.window + 1);
  k_begin = (k_begin / BT) * BT;

  float dq[M][NC];
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[r][c] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += BT) {
    __syncthreads();   // q staged; the last pair's readers are done
    load_rows<D>(Ks, k, a.k_ss, k0, a.Sk);
    load_rows<D>(Vs, v, a.v_ss, k0, a.Sk);
    __syncthreads();
    pair_tiles<D>(a, i0, k0, Qs, Gs, Ks, Vs, lse_s, dsum_s, nullptr, dSs);
    __syncthreads();
    // dq[i] += sum_j dS[i][j] k[j]
#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      float ds[M], kc[NC];
#pragma unroll
      for (int r = 0; r < M; ++r) ds[r] = dSs[(ty + kT * r) * (BT + 1) + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) kc[c] = Ks[j * LD + tx + kT * c];
#pragma unroll
      for (int r = 0; r < M; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) dq[r][c] = fmaf(ds[r], kc[c], dq[r][c]);
    }
  }

  T* dq_out = static_cast<T*>(a.dq);
#pragma unroll
  for (int r = 0; r < M; ++r) {
    const int s = i0 + ty + kT * r;
    if (s >= a.Sq) continue;
    const long long base =
        ((static_cast<long long>(b) * a.Sq + s) * a.Hq + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      st(dq_out + base + tx + kT * c, dq[r][c] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

template <int D, typename T>
cudaError_t launch(const BwdArgs& a, int B, cudaStream_t stream) {
  using C = Tile<D>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<D, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const long long rows = static_cast<long long>(B) * a.Hq * a.Sq;
  const int per_block = kThreads / 32;
  cudaError_t err = cudaSuccess;
  if (rows > 0) {
    flash_bwd_dot_kernel<T><<<static_cast<unsigned>(
                                  (rows + per_block - 1) / per_block),
                              kThreads, 0, stream>>>(a, B, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (a.Sk > 0) {
    const dim3 grid_kv((a.Sk + C::kBT - 1) / C::kBT, a.Hkv, B);
    flash_bwd_dkdv_kernel<D, T><<<grid_kv, kThreads, C::kSmem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (rows == 0) return cudaSuccess;
  const dim3 grid_q((a.Sq + C::kBT - 1) / C::kBT, a.Hq, B);
  flash_bwd_dq_kernel<D, T><<<grid_q, kThreads, C::kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const BwdArgs& a, int B, int d, cudaStream_t stream) {
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

// Launches the three kernels on `stream` (a cudaStream_t) of `device` and
// returns cudaGetLastError() as an int (0 on success; cudaErrorInvalidValue
// for a head dim or dtype code it has no instance for).  dtype: 0 float32,
// 1 bfloat16, the same for q, k, v, o, dO, dq, dk and dv.  Strides are in
// elements; lse and dsum are float32 [B, Hq, Sq] buffers (dsum scratch,
// written here); dq [B, Sq, Hq, d] and dk, dv [B, Sk, Hkv, d] are
// contiguous and written in full.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        float* dsum, void* dq, void* dk, void* dv,
                        long long q_sb, long long q_ss, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        long long o_sb, long long o_ss, long long o_sh,
                        long long g_sb, long long g_ss, long long g_sh,
                        int B, int Sq, int Sk, int Hq, int Hkv, int d,
                        int dtype, float scale, float softcap, int causal,
                        int window, int pos_offset, int device,
                        void* stream) {
  if (B <= 0 || Hq <= 0 || (Sq <= 0 && Sk <= 0)) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdArgs a{q, k, v, o, dout, lse, dsum, dq, dk, dv,
                  q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                  o_sb, o_ss, o_sh, g_sb, g_ss, g_sh,
                  Sq, Sk, Hq, Hkv, scale, softcap, causal, window,
                  pos_offset};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = launch_d<float>(a, B, d, s); break;
    case 1: err = launch_d<bf16>(a, B, d, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
