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
//   - sums in float32, the output in q's dtype, contiguous [B, Sq, Hq, d];
//   - where the caller passes an lse buffer (training: the backward,
//     csrc/flash_attention_bwd.cu, recomputes P from it), each row's
//     log-sum-exp of its seen logits in float32, [B, Hq, Sq], -inf for a
//     row that sees no key; the output is the same with or without it.
// Head dims 16, 32, 64, 128 and 256 are template instances.
//
// Bound on an H100 SXM: 4 * B * Hq * d * (pairs seen) operations (two
// products, each a multiply and an add per pair and channel; half of
// Sq * Sk when causal and square) at the bf16 tensor-core peak of
// 989 TFLOP/s, against reading q, k, v and writing out once at 3.35 TB/s.
// For qwen3-1.7b's heads the bytes bound it below about a thousand
// tokens and the operations above.
//
// bfloat16 (the served models): flash_attention_mma_kernel, the
// FlashAttention-2 layout on the tensor cores.  A block of 4 warps takes
// a 64-row query tile of one head (each warp 16 rows; the last tiles of a
// causal call, which see the most keys, are launched first).  K and V
// come in tiles of 32 keys by 16-byte cp.async into a two-stage ring in
// shared memory, the next tile in flight while the current one is
// multiplied, with one barrier a tile; rows are padded by 16 bytes, so
// the 8 rows an ldmatrix reads fall in 8 different bank groups.  Q K^T
// runs as mma.sync.m16n8k16 (bf16 in, float32 sums), Q's fragments
// re-read from shared memory for every tile; a thread holds 160
// registers at d = 128, three blocks an SM (at d = 256 the 128 float32
// accumulators of O take 255, two blocks an SM).  The logits, the
// running max and sum and the accumulator O stay in registers, in the
// accumulator fragments: the row max is reduced across the 4 lanes that
// hold a row, p = 2^(s scale log2(e) - m) is one multiply-add and one
// ex2.approx (the special-function unit), the accumulator is rescaled
// only when a row's max moved, and the row sum is reduced once at the
// end.  P V rounds P to bf16 for the tensor cores, which at these lengths
// costs up to ~100 bf16 ulps of an output against the float32 plain
// version; so P is split as P_hi = bf16(P), P_lo = bf16(P - P_hi), and
// both products go into the same float32 accumulator (16 significant bits
// of P, 1.5x the tensor work of one P V).  Key tiles wholly past the
// causal limit or before the window are not visited (the Pallas body's
// block skip); only tiles that cross a limit evaluate the mask.  The
// output goes through shared memory so that it is written in 16-byte
// stores.  Next steps: wgmma with the tiles brought by TMA and warp
// specialisation (mma.sync reaches about a sixth of the bf16 peak here).
//
// float32 (tests; the tolerance of 2e-5 excludes TF32):
// flash_attention_kernel, products on the CUDA cores.  One block of 256
// threads per (64-row query tile, query head, batch row).  The query tile
// and a 64-row K and V tile sit in dynamic shared memory (rows of Q and K
// padded by one word); each thread owns 4 query rows x 4 key columns of
// the logits tile and 4 rows x d/16 channels of the output accumulator,
// in registers.  Per K tile: logits (explicit fmaf: the library is built
// with -fmad=false), scale, cap and mask; the row max and row sum across
// the 16 threads of a row by warp shuffles; the running max, sum and
// accumulator rescaled as in the Pallas body; P through shared memory
// into P V.  The same block skip as above.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace mma_bf16;

constexpr float kNegInf = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                  // [B, Hq, Sq], or null: not written
  long long q_sb, q_ss, q_sh;  // element strides (batch, sequence, head)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int Sq, Sk, Hq, Hkv;
  float scale, softcap;        // softcap <= 0: none
  int causal, window;          // window < 0: none
  int pos_offset;
};

// The keys any query of [q0, q0 + rows) may see, [k_begin, k_end), with
// k_begin rounded down to a multiple of bk.
struct KeyRange {
  int q_lo, q_hi, k_begin, k_end;
};

__device__ __forceinline__ KeyRange key_range(const Args& a, int q0,
                                              int rows, int bk) {
  KeyRange r;
  r.q_lo = q0 + a.pos_offset;
  r.q_hi = min(q0 + rows, a.Sq) - 1 + a.pos_offset;
  r.k_end = a.Sk;
  if (a.causal) r.k_end = min(r.k_end, r.q_hi + 1);
  r.k_begin = 0;
  if (a.window >= 0) r.k_begin = max(0, r.q_lo - a.window + 1);
  r.k_begin = (r.k_begin / bk) * bk;
  return r;
}

// ---------------------------------------------------------------------------
// float32: CUDA cores.
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kT = 16;         // threads along each axis of a tile
constexpr int kMicro = 4;      // rows (and key columns) per thread
constexpr int kThreads = kT * kT;

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
    Qs[r * (D + 1) + c] = s < a.Sq ? q[s * a.q_ss + c] : 0.0f;
  }

  const KeyRange kr = key_range(a, q0, kBQ, kBK);
  const int q_lo = kr.q_lo;

  float m[kMicro], l[kMicro], acc[kMicro][kC];
#pragma unroll
  for (int r = 0; r < kMicro; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[r][c] = 0.0f;
  }

  for (int k0 = kr.k_begin; k0 < kr.k_end; k0 += kBK) {
    __syncthreads();   // Q staged; the last tile's readers are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D;
      const int c = e % D;
      const int s = k0 + r;
      const bool in = s < a.Sk;
      Ks[r * (D + 1) + c] = in ? k[s * a.k_ss + c] : 0.0f;
      Vs[r * D + c] = in ? v[s * a.v_ss + c] : 0.0f;
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
    if (a.lse != nullptr && tx == 0)
      a.lse[(static_cast<long long>(b) * a.Hq + h) * a.Sq + s] =
          l[r] > 0.0f ? m[r] + logf(l[r]) : -INFINITY;
    T* row = o + ((static_cast<long long>(b) * a.Sq + s) * a.Hq + h) * D;
#pragma unroll
    for (int c = 0; c < kC; ++c) row[tx + kT * c] = acc[r][c] * inv;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16), cp.async ring.
// ---------------------------------------------------------------------------

// A block: 4 warps of 16 query rows; K/V tiles of 32 keys in a ring of 2
// stages.  Registers are capped for 3 blocks an SM (160 a thread at
// d = 128); at d = 256 the 128 float32 accumulators of O need 255 (2
// blocks an SM, which shared memory also allows).  Chosen over 64-key
// tiles, Q's fragments held in registers, 3 or 4 stages and two 16-row
// m-tiles a warp on the H100 (PERF.md section 6).
template <int D>
struct MmaCfg {
  static constexpr int kThreads = 128;
  static constexpr int kBQ = 64;                   // query rows a block
  static constexpr int kBK = 32;                   // keys a tile
  static constexpr int kStages = 2;
  static constexpr int kMinBlocks = D >= 256 ? 1 : 3;
  static constexpr int kLD = D + 8;                // row stride (bf16)
  static constexpr int kChunks = D / 8;            // 16-byte chunks a row
  // Q, then the stages of K and of V.
  static constexpr int kSmem = static_cast<int>(sizeof(bf16)) * kLD *
                               (kBQ + 2 * kStages * kBK);
};

template <int D, typename T>
__global__ void __launch_bounds__(MmaCfg<D>::kThreads,
                                  MmaCfg<D>::kMinBlocks)
flash_attention_mma_kernel(const Args a) {
  using C = MmaCfg<D>;
  constexpr int BK = C::kBK;
  constexpr int BQ = C::kBQ;
  constexpr int NT = C::kThreads;
  constexpr int LD = C::kLD;
  constexpr int NC = C::kChunks;
  constexpr int kStages = C::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                         // [kStages][BK][LD]
  bf16* Vs = Ks + kStages * BK * LD;               // [kStages][BK][LD]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;        // the fragment row (and row + 8)
  const int t4 = lane % 4;       // the fragment column pair
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  // The query tile, rows past Sq zero.
  for (int c = tid; c < BQ * NC; c += NT) {
    const int r = c / NC;
    const int col = (c % NC) * 8;
    const int s = q0 + r;
    const bool in = s < a.Sq;
    cp_async16(Qs + r * LD + col, q + (in ? s : 0) * a.q_ss + col, in);
  }
  const KeyRange kr = key_range(a, q0, BQ, BK);
  const int n_tiles =
      kr.k_end > kr.k_begin ? (kr.k_end - kr.k_begin + BK - 1) / BK : 0;
  // K and V rows of tile `tile` into ring stage `stage`; rows past Sk are
  // zero (never read from memory).
  auto load_kv = [&](int tile, int stage) {
    const int k0 = kr.k_begin + tile * BK;
    bf16* ks = Ks + stage * BK * LD;
    bf16* vs = Vs + stage * BK * LD;
    for (int c = tid; c < BK * NC; c += NT) {
      const int r = c / NC;
      const int col = (c % NC) * 8;
      const int s = k0 + r;
      const bool in = s < a.Sk;
      const long long row = in ? s : 0;
      cp_async16(ks + r * LD + col, k + row * a.k_ss + col, in);
      cp_async16(vs + r * LD + col, v + row * a.v_ss + col, in);
    }
  };
  // Group j holds tile j (group 0 also Q).
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_tiles) load_kv(j, j);
    cp_async_commit();
  }

  // This warp's query rows g and g + 8 (positions), and its state.
  const int qp[2] = {kr.q_lo + warp * 16 + g, kr.q_lo + warp * 16 + g + 8};
  const bool capped = a.softcap > 0.0f;
  const float s_scale = capped ? 1.0f : a.scale * kLog2e;
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};

  // The lane's ldmatrix row addresses, as offsets in a tile.
  const int a_row = lane % 16;                         // A: Q rows
  const int a_col = (lane / 16) * 8;
  const int b_row = (lane / 16) * 8 + lane % 8;        // B of Q K^T: keys
  const int b_col = ((lane / 8) % 2) * 8;
  const int v_row = ((lane / 8) % 2) * 8 + lane % 8;   // B of P V: keys
  const int v_col = (lane / 16) * 8;
  const bf16* q_warp = Qs + (warp * 16 + a_row) * LD + a_col;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();   // Q and tile t have landed (this
    __syncthreads();                // thread's part, then everyone's), and
                                    // every warp is done with tile t - 1,
    const int ahead = t + kStages - 1;   // whose stage is refilled now
    if (ahead < n_tiles) load_kv(ahead, ahead % kStages);
    cp_async_commit();
    const bf16* ks = Ks + (t % kStages) * BK * LD;
    const bf16* vs = Vs + (t % kStages) * BK * LD;
    const int k0 = kr.k_begin + t * BK;

    // S = Q K^T: 16 rows x BK keys a warp.
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      ldmatrix_x4(qa, q_warp + kk * 16);
#pragma unroll
      for (int nb = 0; nb < BK / 16; ++nb) {
        uint32_t kb[4];
        ldmatrix_x4(kb, ks + (nb * 16 + b_row) * LD + kk * 16 + b_col);
        mma_bf16_16816(s[2 * nb], qa, kb[0], kb[1]);
        mma_bf16_16816(s[2 * nb + 1], qa, kb[2], kb[3]);
      }
    }

    // Logits x (the capped logits in log2 units where there is a cap),
    // -inf where the mask, evaluated only on a tile that crosses a limit,
    // hides them; p = 2^(x c - m) with c = scale log2(e) (1 with a cap).
    const bool masked = k0 + BK > a.Sk ||
                        (a.causal && k0 + BK - 1 > kr.q_lo) ||
                        (a.window >= 0 && k0 <= kr.q_hi - a.window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e];
        if (capped) x = a.softcap * tanhf(x * a.scale / a.softcap) * kLog2e;
        if (masked) {
          const int kp = k0 + j * 8 + 2 * t4 + (e % 2);
          const bool ok = kp < a.Sk && (!a.causal || kp <= qp[e / 2]) &&
                          (a.window < 0 || kp > qp[e / 2] - a.window);
          x = ok ? x : -INFINITY;
        }
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * s_scale);
      // A row that has seen no key yet keeps p = 0 (and alpha = 0).
      m_use[r] = m_new == -INFINITY ? 0.0f : m_new;
      alpha[r] = exp2_approx(m[r] - m_use[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(fmaf(s[j][e], s_scale, -m_use[e / 2]));
        s[j][e] = p;
        l[e / 2] += p;
      }
    }
    // The accumulator is rescaled only where a row's max moved.
    if (!__all_sync(0xffffffffu, alpha[0] == 1.0f && alpha[1] == 1.0f)) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
    }

    // O += P V, P as hi + lo bf16 fragments (16 keys a step).
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t ph[4], pl[4];
      split_bf16x2(s[2 * kc][0], s[2 * kc][1], ph[0], pl[0]);
      split_bf16x2(s[2 * kc][2], s[2 * kc][3], ph[1], pl[1]);
      split_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1], ph[2], pl[2]);
      split_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int db = 0; db < D / 16; ++db) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + (kc * 16 + v_row) * LD + db * 16 + v_col);
        mma_bf16_16816(o[2 * db], ph, vb[0], vb[1]);
        mma_bf16_16816(o[2 * db], pl, vb[0], vb[1]);
        mma_bf16_16816(o[2 * db + 1], ph, vb[2], vb[3]);
        mma_bf16_16816(o[2 * db + 1], pl, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();         // no copy into Qs is pending (n_tiles == 0)

  // O / l through this warp's rows of Qs, then 16-byte stores.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.0f ? 1.0f / l[r] : 0.0f;
  }
  // The log-sum-exp in natural units: m is the row max in log2 units of
  // the (capped) logits, l the sum of 2^(x - m).
  if (a.lse != nullptr && t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = q0 + warp * 16 + g + 8 * r;
      if (s < a.Sq)
        a.lse[(static_cast<long long>(b) * a.Hq + h) * a.Sq + s] =
            l[r] > 0.0f ? (m[r] + log2f(l[r])) * kLn2 : -INFINITY;
    }
  }
  bf16* stage = Qs + warp * 16 * LD;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(stage + g * LD + col) =
        __floats2bfloat162_rn(o[j][0] * inv[0], o[j][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * LD + col) =
        __floats2bfloat162_rn(o[j][2] * inv[1], o[j][3] * inv[1]);
  }
  __syncwarp();
  T* out = static_cast<T*>(a.o);
  for (int c = lane; c < 16 * NC; c += 32) {
    const int r = c / NC;
    const int col = (c % NC) * 8;
    const int s = q0 + warp * 16 + r;
    if (s >= a.Sq) continue;
    T* row = out + ((static_cast<long long>(b) * a.Sq + s) * a.Hq + h) * D;
    *reinterpret_cast<uint4*>(row + col) =
        *reinterpret_cast<const uint4*>(stage + r * LD + col);
  }
}

// Launches `kernel` on a grid of query tiles x heads x batch rows.  Each
// instance raises its dynamic shared-memory limit once, on its first
// launch (`attr_set` is the instance's own flag).
cudaError_t launch_with(void (*kernel)(Args), int bytes, int threads,
                        int rows, bool& attr_set, const Args& a, int B,
                        cudaStream_t stream) {
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((a.Sq + rows - 1) / rows, a.Hq, B);
  kernel<<<grid, threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// kMma: the bfloat16 tensor-core kernel, else the float32 one.
template <int D, bool kMma>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  static bool attr_set = false;
  if constexpr (kMma) {
    return launch_with(flash_attention_mma_kernel<D, bf16>, MmaCfg<D>::kSmem,
                       MmaCfg<D>::kThreads, MmaCfg<D>::kBQ, attr_set, a, B,
                       stream);
  } else {
    return launch_with(flash_attention_kernel<D, float>, smem_bytes<D>(),
                       kThreads, kBQ, attr_set, a, B, stream);
  }
}

template <bool kMma>
cudaError_t launch_d(const Args& a, int B, int d, cudaStream_t stream) {
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

// Launches the kernel on `stream` (a cudaStream_t) of `device` and returns
// cudaGetLastError() as an int (0 on success; cudaErrorInvalidValue for a
// head dim or dtype code it has no instance for).  lse: a float32
// [B, Hq, Sq] buffer for each row's log-sum-exp, or null.  dtype: 0
// float32 (the CUDA-core kernel), 1 bfloat16 (the tensor-core kernel: the
// base pointers and the strides in bytes must be multiples of 16), the
// same for q, k, v and out.  Strides are in elements; out is a contiguous
// [B, Sq, Hq, d] buffer, written in full.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                        float* lse, long long q_sb, long long q_ss,
                        long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        int B, int Sq, int Sk, int Hq, int Hkv, int d,
                        int dtype, float scale, float softcap, int causal,
                        int window, int pos_offset, int device,
                        void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{q, k, v, out, lse, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
               v_ss, v_sh, Sq, Sk, Hq, Hkv, scale, softcap, causal, window,
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
