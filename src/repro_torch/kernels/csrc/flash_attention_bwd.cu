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
// Bound on an H100 SXM: the five products of the gradient (the logits,
// dP, dv, dk, dq) are 10 B Hq d operations a (query, key) pair that the
// mask sees, at the bf16 tensor-core peak of 989 TFLOP/s, against reading
// q, k, v, o, dO and lse and writing dq, dk and dv once at 3.35 TB/s; at
// the training shapes (S = 2048) the operations bound it.
//
// Three kernels, each on the current stream, without atomics, so that
// repeated calls give the same bits:
//   1. flash_bwd_dot_kernel: D, one warp a row (the lanes over the
//      channels, then a butterfly of shuffles);
//   2. the dk/dv kernel: one block a (key tile, KV head, batch row); it
//      loops over the query heads of the group in order and, for each,
//      over the query tiles that can see the key tile (the causal limit
//      and the window cut the range), recomputes P and dS for the pair of
//      tiles and adds P^T dO and dS^T q into dk and dv held in registers;
//   3. the dq kernel: one block a (query tile, query head, batch row); it
//      loops over the key tiles the query tile can see and adds dS k into
//      dq held in registers (the last query tiles of a causal call, which
//      see the most keys, are launched first).
// Both recompute the logits and dP: seven products a (query, key) pair,
// 1.4x the bound's five, the price of owning each of dq, dk and dv in one
// block (a fused pass would sum dq across key tiles, in an order that
// atomics would make change from call to call).
//
// bfloat16 (training): flash_bwd_dkdv_mma_kernel and
// flash_bwd_dq_mma_kernel, the FlashAttention-2 layout on the tensor
// cores (mma.sync.m16n8k16, bf16 operands, float32 sums; csrc/mma_bf16.cuh
// as the forward).  Blocks of 4 warps.
//   - dk/dv: a key tile of 64 keys, each warp 16 of them (at d = 256, 32
//     keys, two warps a 16-key row, each half of the channels of dk and
//     dv, since 16 rows x 256 channels of both do not fit a warp's
//     registers; both warps of a row form its S^T and dP^T).  K and V are
//     copied once into shared memory and their A fragments re-read by
//     ldmatrix; query tiles (64 rows at d <= 64, 32 above) of q and dO,
//     with their rows' lse and D, stream through a three-stage cp.async
//     ring (the next two tiles in flight while the current one is
//     multiplied, one barrier a tile), rows padded by 16 bytes so that the
//     8 rows an ldmatrix reads fall in 8 bank groups.  For each tile,
//     S^T = K q^T and dP^T = V dO^T (q and dO the B operands by ldmatrix),
//     then P^T = 2^(s scale log2 e - lse log2 e) by ex2.approx (-inf rows
//     give 0) and dS^T = P^T (dP^T - D) (times 1 - tanh^2 under a
//     soft-cap), in the accumulator fragments; the mask is evaluated only
//     on tiles that cross a limit.  P^T and dS^T are repacked from the
//     accumulators straight into A fragments, and dv += P^T dO,
//     dk += dS^T q with dO and q the B operands by ldmatrix.trans.
//     Nothing of P or dS goes through shared memory.
//   - dq: a query tile of 64 rows, each warp 16; K and V tiles (64 keys at
//     d <= 64, 32 above) stream through the same kind of ring.  The warp's
//     q and dO fragments are loaded once into registers (re-read by
//     ldmatrix at d = 256, where they would take 128 registers); S = q K^T
//     and dP = dO V^T, then dS as above with each thread's two rows' lse
//     and D in registers, and dq += dS K with K by ldmatrix.trans.
//   Registers are capped for 3 blocks an SM at d <= 64 (168 a thread; at
//   d = 64 ptxas spills a few hundred bytes, which L1 holds, and the call
//   is still 6-7 % faster than at 2 blocks without spills), 2 at d = 128
//   (at 3 both kernels spill and the call is 25-30 % slower), 1 at
//   d = 256.  Chosen over two stages, query tiles of 32 or 64 in dk/dv,
//   key tiles of 32 or 64 in dq, q and dO re-read in dq, and blocks of 8
//   warps, on the H100 (launch/kernel_variants.py --set bwd; PERF.md
//   section 6).  Per instance (ptxas, sm_90a; spill stores / loads in
//   bytes):
//     d                    16      32      64        128     256
//     dk/dv shared bytes  26112   42496   75264     87808  135936
//           registers       164     168     168       243     245
//           spills            0       0    64 / 84      0       0
//     dq    shared bytes  24576   40960   73728     87040  168960
//           registers       148     168     168       245     248
//           spills            0       0   112 / 360     0       0
//   Rounding: P and dS are rounded once to bf16 for their products, as
//   FlashAttention-2 does; every sum is float32.  The split into bf16
//   hi + lo that the forward needs for P V (its FULL_LIMIT has no term
//   scaled to the largest output) is not needed here: a plain model of
//   this rounding (repro_torch.testing.attention_bwd_rounded, checked on
//   the CPU by tests/test_torch_attention_bwd.py) stays within about 0.4
//   of chip_smoke.py's BWD_LIMIT at the training shapes and of the 2e-2
//   tolerance of the bf16 cases.
//
// float32 (tests; the tolerance of 2e-5 excludes TF32):
// flash_bwd_dkdv_kernel and flash_bwd_dq_kernel on the CUDA cores.  256
// threads as 16 x 16, tiles of 64 queries x 64 keys (32 x 32 at head dim
// 256, for shared memory), each thread 4 x 4 (2 x 2) entries of the
// logits tile and 4 (2) rows x d / 16 channels of its accumulators; q,
// dO, k and v tiles in float32 in dynamic shared memory, rows padded by
// one word; P and dS through shared memory between the pair's logits and
// its products.
//
// Next: wgmma with the tiles brought by TMA and a producer warp (warp
// specialisation), and a fused single pass that owns a key tile and sums
// dq across key tiles in a fixed order (a per-tile semaphore, as
// FlashAttention-3's deterministic mode), five products a pair instead of
// seven.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace mma_bf16;

constexpr float kLog2e = 1.4426950408889634f;
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

// float32 tiles of BT queries x BT keys; d = 256 takes 32 for shared
// memory.
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
// float32: the pair of tiles shared by kernels 2 and 3.
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
// 2 (float32). dk and dv: one block a (key tile, KV head, batch row).
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
// 3 (float32). dq: one block a (query tile, query head, batch row).
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
// bfloat16: tensor cores (mma.sync m16n8k16), cp.async rings.
// ---------------------------------------------------------------------------

// A 4-byte cp.async.ca (global -> shared); with pred false it writes 4
// zero bytes and reads nothing.  For the lse and D rows, whose [B, Hq, Sq]
// rows start on any float.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(smem)), "l"(gmem), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return as_u32(__floats2bfloat162_rn(lo, hi));
}

// -lse log2(e), the exponent's offset of a query row; -inf for a row that
// saw no key (lse = -inf), so that its P is 2^-inf = 0.
__device__ __forceinline__ float neg_lse2(float lse) {
  return lse == -INFINITY ? -INFINITY : -lse * kLog2e;
}

// P (or P^T) from a logit s and its row's -lse log2(e), and dS from P,
// dP and D; soft-capped: t = tanh(s scale / c), P = 2^(c t log2 e + nl),
// dS = P (dP - D) (1 - t^2).
struct Grad {
  float s_scale;     // scale log2(e) (no cap)
  float cap_in;      // scale / c
  float cap_out;     // c log2(e)
  bool capped;
  __device__ __forceinline__ void operator()(float s, float dp, float nl,
                                             float dsum, float& p,
                                             float& ds) const {
    if (capped) {
      const float t = tanhf(s * cap_in);
      p = exp2_approx(fmaf(t, cap_out, nl));
      ds = p * (dp - dsum) * (1.0f - t * t);
    } else {
      p = exp2_approx(fmaf(s, s_scale, nl));
      ds = p * (dp - dsum);
    }
  }
};

__device__ __forceinline__ Grad make_grad(const BwdArgs& a) {
  Grad g;
  g.capped = a.softcap > 0.0f;
  g.s_scale = a.scale * kLog2e;
  g.cap_in = g.capped ? a.scale / a.softcap : 0.0f;
  g.cap_out = a.softcap * kLog2e;
  return g;
}

// Query qi (at position qi + pos_offset) sees key kp.
__device__ __forceinline__ bool sees(const BwdArgs& a, int qi, int kp) {
  const int qp = qi + a.pos_offset;
  return qi < a.Sq && kp < a.Sk && (!a.causal || kp <= qp) &&
         (a.window < 0 || kp > qp - a.window);
}

// Blocks of 4 warps.  dk/dv: a key tile of 64 keys, each warp 16 (at
// d = 256, 32 keys: two warps a 16-key row, each half of its channels),
// query tiles of kBQs rows in the ring.  dq: a query tile of 64 rows,
// each warp 16, key tiles of kBK keys in the ring.  Rows padded by 16
// bytes.
template <int D>
struct MmaCfg {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kSplit = D >= 256 ? 2 : 1;   // warps a 16-key row
  static constexpr int kDC = D / kSplit;            // dk/dv channels a warp
  static constexpr int kBKV = 16 * kWarps / kSplit; // keys a dk/dv block
  static constexpr int kBQs = D >= 128 ? 32 : 64;   // queries a ring tile
  static constexpr int kBQ = 16 * kWarps;           // queries a dq block
  static constexpr int kBK = D >= 128 ? 32 : 64;    // keys a ring tile
  static constexpr int kStages = 3;
  static constexpr bool kHoldQ = D <= 128;          // dq: q, dO fragments
  static constexpr int kMinBlocks = D >= 256 ? 1 : D >= 128 ? 2 : 3;
  static constexpr int kLD = D + 8;                 // row stride (bf16)
  static constexpr int kChunks = D / 8;             // 16-byte chunks a row
  static constexpr int kRow = static_cast<int>(sizeof(bf16)) * kLD;
  // K and V; then the stages of q and dO, and of lse and D.
  static constexpr int kDkdvSmem =
      2 * kBKV * kRow + kStages * (2 * kBQs * kRow + 2 * kBQs * 4);
  // q and dO; then the stages of K and V.
  static constexpr int kDqSmem = 2 * kBQ * kRow + kStages * 2 * kBK * kRow;
};

// The lane's ldmatrix row offsets in a tile (as the forward's):
//   A (row-major [m][k]):              row lane % 16, column (lane / 16) 8;
//   B of X Y^T (Y row-major [n][k]):   row (lane / 16) 8 + lane % 8,
//                                      column ((lane / 8) % 2) 8;
//   B of X Y (Y row-major [k][n],      row ((lane / 8) % 2) 8 + lane % 8,
//     ldmatrix.trans):                 column (lane / 16) 8.
struct Lanes {
  int a_row, a_col, b_row, b_col, t_row, t_col;
  __device__ __forceinline__ explicit Lanes(int lane)
      : a_row(lane % 16), a_col((lane / 16) * 8),
        b_row((lane / 16) * 8 + lane % 8), b_col(((lane / 8) % 2) * 8),
        t_row(((lane / 8) % 2) * 8 + lane % 8), t_col((lane / 16) * 8) {}
};

// Rows [r0, r0 + R) of a [B, S, H, d] operand (base at batch row and
// head), 16 bytes a copy, into a tile of stride kLD; rows past S zero.
template <int D, int R>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* base,
                                          long long ss, int r0, int S) {
  constexpr int NC = D / 8;
  for (int c = threadIdx.x; c < R * NC; c += MmaCfg<D>::kThreads) {
    const int r = c / NC;
    const int col = (c % NC) * 8;
    const int s = r0 + r;
    const bool in = s < S;
    cp_async16(dst + r * MmaCfg<D>::kLD + col,
               base + (in ? s : 0) * ss + col, in);
  }
}

// acc (the warp's 16 rows x N) += X (16 x BQ, in accumulator fragments)
// Y (BQ x N, row-major in shared memory, by ldmatrix.trans): X's
// accumulator tiles are repacked to bf16 A fragments, as the forward does
// with P.
template <int BQ, int N, int LD>
__device__ __forceinline__ void acc_product(float (&acc)[N / 8][4],
                                            const float (&x)[BQ / 8][4],
                                            const bf16* y,
                                            const Lanes& ln) {
#pragma unroll
  for (int kc = 0; kc < BQ / 16; ++kc) {
    uint32_t xa[4];
    xa[0] = pack_bf16x2(x[2 * kc][0], x[2 * kc][1]);
    xa[1] = pack_bf16x2(x[2 * kc][2], x[2 * kc][3]);
    xa[2] = pack_bf16x2(x[2 * kc + 1][0], x[2 * kc + 1][1]);
    xa[3] = pack_bf16x2(x[2 * kc + 1][2], x[2 * kc + 1][3]);
#pragma unroll
    for (int db = 0; db < N / 16; ++db) {
      uint32_t yb[4];
      ldmatrix_x4_trans(yb, y + (kc * 16 + ln.t_row) * LD + db * 16 +
                                ln.t_col);
      mma_bf16_16816(acc[2 * db], xa, yb[0], yb[1]);
      mma_bf16_16816(acc[2 * db + 1], xa, yb[2], yb[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// 2 (bf16). dk and dv: one block a (key tile, KV head, batch row).
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(MmaCfg<D>::kThreads,
                                  MmaCfg<D>::kMinBlocks)
flash_bwd_dkdv_mma_kernel(const BwdArgs a) {
  using C = MmaCfg<D>;
  constexpr int LD = C::kLD;
  constexpr int BKV = C::kBKV;
  constexpr int BQ = C::kBQs;
  constexpr int DC = C::kDC;
  constexpr int NS = C::kStages;   // ring stages
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // [BKV][LD]
  bf16* Vs = Ks + BKV * LD;
  bf16* Qs = Vs + BKV * LD;                       // [NS][BQ][LD]
  bf16* Gs = Qs + NS * BQ * LD;                   // dO
  float* Ls = reinterpret_cast<float*>(Gs + NS * BQ * LD);
  float* Ds = Ls + NS * BQ;                       // [NS][BQ]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const Lanes ln(lane);
  const int rb = warp / C::kSplit;            // the warp's 16 keys
  const int c0 = (warp % C::kSplit) * DC;     // its dk/dv channels
  const int k0 = blockIdx.x * BKV;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  copy_rows<D, BKV>(Ks, static_cast<const bf16*>(a.k) + b * a.k_sb +
                            hk * a.k_sh, a.k_ss, k0, a.Sk);
  copy_rows<D, BKV>(Vs, static_cast<const bf16*>(a.v) + b * a.v_sb +
                            hk * a.v_sh, a.v_ss, k0, a.Sk);

  // The query rows that may see a key of [k0, k_last]: causal, position
  // >= k0; windowed, position < k_last + window.  Tile t of the ring is
  // query tile t % per_head of the group's head t / per_head.
  const int k_last = min(k0 + BKV, a.Sk) - 1;
  int i_begin = 0;
  if (a.causal) i_begin = max(0, k0 - a.pos_offset);
  i_begin = (i_begin / BQ) * BQ;
  int i_end = a.Sq;
  if (a.window >= 0) i_end = min(i_end, k_last + a.window - a.pos_offset);
  const int per_head = i_end > i_begin ? (i_end - i_begin + BQ - 1) / BQ : 0;
  const int n_tiles = per_head * group;

  auto load_q = [&](int tile, int stage) {
    const int h = hk * group + tile / per_head;
    const int i0 = i_begin + (tile % per_head) * BQ;
    copy_rows<D, BQ>(Qs + stage * BQ * LD, static_cast<const bf16*>(a.q) +
                         b * a.q_sb + h * a.q_sh, a.q_ss, i0, a.Sq);
    copy_rows<D, BQ>(Gs + stage * BQ * LD,
                     static_cast<const bf16*>(a.dout) + b * a.g_sb +
                         h * a.g_sh, a.g_ss, i0, a.Sq);
    const long long row0 = (static_cast<long long>(b) * a.Hq + h) * a.Sq;
    for (int r = tid; r < 2 * BQ; r += C::kThreads) {
      const int s = i0 + r % BQ;
      const bool in = s < a.Sq;
      const float* src = (r < BQ ? a.lse : a.dsum) + row0 + (in ? s : 0);
      cp_async4((r < BQ ? Ls : Ds) + stage * BQ + r % BQ, src, in);
    }
  };
  // Group j holds query tile j (group 0 also K and V).
  for (int j = 0; j < NS - 1; ++j) {
    if (j < n_tiles) load_q(j, j);
    cp_async_commit();
  }

  const Grad grad = make_grad(a);
  const int kp[2] = {k0 + rb * 16 + g, k0 + rb * 16 + g + 8};
  const bf16* k_frag = Ks + (rb * 16 + ln.a_row) * LD + ln.a_col;
  const bf16* v_frag = Vs + (rb * 16 + ln.a_row) * LD + ln.a_col;
  float dk[DC / 8][4], dv[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[j][e] = 0.0f;
      dv[j][e] = 0.0f;
    }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<NS - 2>();   // K, V and tile t have landed, and
    __syncthreads();                // every warp is done with tile t - 1,
    const int ahead = t + NS - 1;   // whose stage is refilled now
    if (ahead < n_tiles) load_q(ahead, ahead % NS);
    cp_async_commit();
    const int stage = t % NS;
    const bf16* qs = Qs + stage * BQ * LD;
    const bf16* gs = Gs + stage * BQ * LD;
    const float* ls = Ls + stage * BQ;
    const float* dd = Ds + stage * BQ;
    const int i0 = i_begin + (t % per_head) * BQ;

    // S^T = K q^T, dP^T = V dO^T: 16 keys x BQ queries a warp.
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.0f;
        dp[j][e] = 0.0f;
      }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      ldmatrix_x4(ka, k_frag + kk * 16);
      ldmatrix_x4(va, v_frag + kk * 16);
#pragma unroll
      for (int nb = 0; nb < BQ / 16; ++nb) {
        uint32_t qb[4], gb[4];
        ldmatrix_x4(qb, qs + (nb * 16 + ln.b_row) * LD + kk * 16 + ln.b_col);
        ldmatrix_x4(gb, gs + (nb * 16 + ln.b_row) * LD + kk * 16 + ln.b_col);
        mma_bf16_16816(s[2 * nb], ka, qb[0], qb[1]);
        mma_bf16_16816(s[2 * nb + 1], ka, qb[2], qb[3]);
        mma_bf16_16816(dp[2 * nb], va, gb[0], gb[1]);
        mma_bf16_16816(dp[2 * nb + 1], va, gb[2], gb[3]);
      }
    }

    // P^T into s, dS^T into dp; the mask only on a tile that crosses a
    // limit (rows past Sq, keys past Sk, the causal or window edge).
    const int q_lo = i0 + a.pos_offset;
    const bool masked = i0 + BQ > a.Sq || k0 + BKV > a.Sk ||
                        (a.causal && k0 + BKV - 1 > q_lo) ||
                        (a.window >= 0 && k0 <= q_lo + BQ - 1 - a.window);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int col = j * 8 + 2 * t4;          // the fragment's queries
      const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
      const float2 d2 = *reinterpret_cast<const float2*>(dd + col);
      const float nl[2] = {neg_lse2(l2.x), neg_lse2(l2.y)};
      const float dsum[2] = {d2.x, d2.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p, ds;
        grad(s[j][e], dp[j][e], nl[e % 2], dsum[e % 2], p, ds);
        if (masked && !sees(a, i0 + col + e % 2, kp[e / 2])) {
          p = 0.0f;
          ds = 0.0f;
        }
        s[j][e] = p;
        dp[j][e] = ds;
      }
    }

    // dv += P^T dO, dk += dS^T q over the warp's channels.
    acc_product<BQ, DC, LD>(dv, s, gs + c0, ln);
    acc_product<BQ, DC, LD>(dk, dp, qs + c0, ln);
  }
  cp_async_wait<0>();

  bf16* dk_out = static_cast<bf16*>(a.dk);
  bf16* dv_out = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kp[r] >= a.Sk) continue;
    const long long base =
        ((static_cast<long long>(b) * a.Sk + kp[r]) * a.Hkv + hk) * D + c0;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      const int col = j * 8 + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(dk_out + base + col) =
          __floats2bfloat162_rn(dk[j][2 * r] * a.scale,
                                dk[j][2 * r + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv_out + base + col) =
          __floats2bfloat162_rn(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3 (bf16). dq: one block a (query tile, query head, batch row).
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(MmaCfg<D>::kThreads,
                                  MmaCfg<D>::kMinBlocks)
flash_bwd_dq_mma_kernel(const BwdArgs a) {
  using C = MmaCfg<D>;
  constexpr int LD = C::kLD;
  constexpr int BQ = C::kBQ;
  constexpr int BK = C::kBK;
  constexpr int NS = C::kStages;   // ring stages
  constexpr int KH = C::kHoldQ ? D / 16 : 1;   // held fragments
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LD]
  bf16* Gs = Qs + BQ * LD;                         // dO
  bf16* Ks = Gs + BQ * LD;                         // [NS][BK][LD]
  bf16* Vs = Ks + NS * BK * LD;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const Lanes ln(lane);
  const int i0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  copy_rows<D, BQ>(Qs, static_cast<const bf16*>(a.q) + b * a.q_sb +
                           h * a.q_sh, a.q_ss, i0, a.Sq);
  copy_rows<D, BQ>(Gs, static_cast<const bf16*>(a.dout) + b * a.g_sb +
                           h * a.g_sh, a.g_ss, i0, a.Sq);
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;

  // The keys the tile's queries may see, as the forward's key_range.
  const int q_lo = i0 + a.pos_offset;
  const int q_hi = min(i0 + BQ, a.Sq) - 1 + a.pos_offset;
  int k_end = a.Sk;
  if (a.causal) k_end = min(k_end, q_hi + 1);
  int k_begin = 0;
  if (a.window >= 0) k_begin = max(0, q_lo - a.window + 1);
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  auto load_kv = [&](int tile, int stage) {
    const int kt = k_begin + tile * BK;
    copy_rows<D, BK>(Ks + stage * BK * LD, k, a.k_ss, kt, a.Sk);
    copy_rows<D, BK>(Vs + stage * BK * LD, v, a.v_ss, kt, a.Sk);
  };
  // Group j holds key tile j (group 0 also q and dO).
  for (int j = 0; j < NS - 1; ++j) {
    if (j < n_tiles) load_kv(j, j);
    cp_async_commit();
  }

  // The thread's rows g and g + 8 of the warp: -lse log2(e) and D (a row
  // past Sq as one that saw no key: P = 0).
  const Grad grad = make_grad(a);
  const long long row0 = (static_cast<long long>(b) * a.Hq + h) * a.Sq;
  const int qi[2] = {i0 + warp * 16 + g, i0 + warp * 16 + g + 8};
  float nl[2], dsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = qi[r] < a.Sq;
    nl[r] = in ? neg_lse2(a.lse[row0 + qi[r]]) : -INFINITY;
    dsum[r] = in ? a.dsum[row0 + qi[r]] : 0.0f;
  }
  const bf16* q_frag = Qs + (warp * 16 + ln.a_row) * LD + ln.a_col;
  const bf16* g_frag = Gs + (warp * 16 + ln.a_row) * LD + ln.a_col;
  uint32_t qa[KH][4], ga[KH][4];
  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<NS - 2>();   // q, dO and tile t have landed, and
    __syncthreads();                // every warp is done with tile t - 1,
    const int ahead = t + NS - 1;   // whose stage is refilled now
    if (ahead < n_tiles) load_kv(ahead, ahead % NS);
    cp_async_commit();
    if constexpr (C::kHoldQ) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          ldmatrix_x4(qa[kk], q_frag + kk * 16);
          ldmatrix_x4(ga[kk], g_frag + kk * 16);
        }
      }
    }
    const bf16* ks = Ks + (t % NS) * BK * LD;
    const bf16* vs = Vs + (t % NS) * BK * LD;
    const int k0 = k_begin + t * BK;

    // S = q K^T, dP = dO V^T: 16 queries x BK keys a warp.
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.0f;
        dp[j][e] = 0.0f;
      }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qf[4], gf[4];
      if constexpr (C::kHoldQ) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qf[e] = qa[kk][e];
          gf[e] = ga[kk][e];
        }
      } else {
        ldmatrix_x4(qf, q_frag + kk * 16);
        ldmatrix_x4(gf, g_frag + kk * 16);
      }
#pragma unroll
      for (int nb = 0; nb < BK / 16; ++nb) {
        uint32_t kb[4], vb[4];
        ldmatrix_x4(kb, ks + (nb * 16 + ln.b_row) * LD + kk * 16 + ln.b_col);
        ldmatrix_x4(vb, vs + (nb * 16 + ln.b_row) * LD + kk * 16 + ln.b_col);
        mma_bf16_16816(s[2 * nb], qf, kb[0], kb[1]);
        mma_bf16_16816(s[2 * nb + 1], qf, kb[2], kb[3]);
        mma_bf16_16816(dp[2 * nb], gf, vb[0], vb[1]);
        mma_bf16_16816(dp[2 * nb + 1], gf, vb[2], vb[3]);
      }
    }

    // dS into s; the mask only on a tile that crosses a limit.
    const bool masked = k0 + BK > a.Sk ||
                        (a.causal && k0 + BK - 1 > q_lo) ||
                        (a.window >= 0 && k0 <= q_hi - a.window);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p, ds;
        grad(s[j][e], dp[j][e], nl[e / 2], dsum[e / 2], p, ds);
        if (masked && !sees(a, qi[e / 2], k0 + j * 8 + 2 * t4 + e % 2))
          ds = 0.0f;
        s[j][e] = ds;
      }
    }

    // dq += dS K.
    acc_product<BK, D, LD>(dq, s, ks, ln);
  }
  cp_async_wait<0>();

  bf16* dq_out = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= a.Sq) continue;
    const long long base =
        ((static_cast<long long>(b) * a.Sq + qi[r]) * a.Hq + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dq_out + base + j * 8 + 2 * t4) =
          __floats2bfloat162_rn(dq[j][2 * r] * a.scale,
                                dq[j][2 * r + 1] * a.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

// Raises the dynamic shared-memory limit of `kernel` to `bytes`.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The three kernels of one call: D, then dk/dv (one block a key tile of
// `bkv` keys) and dq (one block a query tile of `bq` rows).
template <typename T, typename KV, typename Q>
cudaError_t launch_three(const BwdArgs& a, int B, int d, KV dkdv, int bkv,
                         int dkdv_smem, int dkdv_threads, Q dq, int bq,
                         int dq_smem, int dq_threads, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * a.Hq * a.Sq;
  const int per_block = kThreads / 32;
  cudaError_t err = cudaSuccess;
  if (rows > 0) {
    flash_bwd_dot_kernel<T><<<static_cast<unsigned>(
                                  (rows + per_block - 1) / per_block),
                              kThreads, 0, stream>>>(a, B, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (a.Sk > 0) {
    const dim3 grid_kv((a.Sk + bkv - 1) / bkv, a.Hkv, B);
    dkdv<<<grid_kv, dkdv_threads, dkdv_smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (rows == 0) return cudaSuccess;
  const dim3 grid_q((a.Sq + bq - 1) / bq, a.Hq, B);
  dq<<<grid_q, dq_threads, dq_smem, stream>>>(a);
  return cudaGetLastError();
}

// kMma: the bfloat16 tensor-core kernels, else the float32 ones.  Each
// instance raises its shared-memory limits once, on its first launch.
template <int D, bool kMma>
cudaError_t launch(const BwdArgs& a, int B, cudaStream_t stream) {
  static bool attr_set = false;
  if constexpr (kMma) {
    using C = MmaCfg<D>;
    if (!attr_set) {
      cudaError_t err = allow_smem(flash_bwd_dkdv_mma_kernel<D>,
                                   C::kDkdvSmem);
      if (err == cudaSuccess)
        err = allow_smem(flash_bwd_dq_mma_kernel<D>, C::kDqSmem);
      if (err != cudaSuccess) return err;
      attr_set = true;
    }
    return launch_three<bf16>(a, B, D, flash_bwd_dkdv_mma_kernel<D>,
                              C::kBKV, C::kDkdvSmem, C::kThreads,
                              flash_bwd_dq_mma_kernel<D>, C::kBQ,
                              C::kDqSmem, C::kThreads, stream);
  } else {
    using C = Tile<D>;
    if (!attr_set) {
      cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<D, float>,
                                   C::kSmem);
      if (err == cudaSuccess)
        err = allow_smem(flash_bwd_dq_kernel<D, float>, C::kSmem);
      if (err != cudaSuccess) return err;
      attr_set = true;
    }
    return launch_three<float>(a, B, D, flash_bwd_dkdv_kernel<D, float>,
                               C::kBT, C::kSmem, kThreads,
                               flash_bwd_dq_kernel<D, float>, C::kBT,
                               C::kSmem, kThreads, stream);
  }
}

template <bool kMma>
cudaError_t launch_d(const BwdArgs& a, int B, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<16, kMma>(a, B, stream);
    case 32: return launch<32, kMma>(a, B, stream);
    case 64: return launch<64, kMma>(a, B, stream);
    case 128: return launch<128, kMma>(a, B, stream);
    case 256: return launch<256, kMma>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the three kernels on `stream` (a cudaStream_t) of `device` and
// returns cudaGetLastError() as an int (0 on success; cudaErrorInvalidValue
// for a head dim or dtype code it has no instance for).  dtype: 0 float32
// (the CUDA-core kernels), 1 bfloat16 (the tensor-core kernels: the base
// pointers of q, k, v and dO and their strides in bytes must be multiples
// of 16), the same for q, k, v, o, dO, dq, dk and dv.  Strides are in
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
    case 0: err = launch_d<false>(a, B, d, s); break;
    case 1: err = launch_d<true>(a, B, d, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
