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
//   - sums in float32, the output in q's dtype, contiguous [B, Hq, d];
//   - where asked (lse not null), each row's log-sum-exp of its seen
//     logits, [B, Hq] float32, -inf for a row that sees no position: the
//     merged (m, l) of the splits, (m + log2 l) ln 2.  With it the outputs
//     of a cache cut into pieces (over ranks, repro_torch/kernels/
//     on_shards.py) merge into the uncut call's.
// Head dims 16, 32, 64, 128 and 256 are template instances.
//
// Bound on an H100 SXM: the bytes.  Each valid K and V row is read once
// (2 * d * itemsize bytes per position and KV head) against about 4 * g * d
// operations on it, g = Hq / Hkv query rows: far below the 295 operations
// per byte at which bf16 compute would bind.  So the kernel's one job is
// to stream the valid rows of the cache at the memory rate, on all SMs.
//
// Split over S (flash-decoding).  The grid is (splits x row chunks, Hkv,
// B): each block takes a fixed chunk of cache positions of one KV head and
// every query row of that head (up to 16 a block on the tensor cores, 8 on
// the CUDA cores; qwen3-1.7b's g = 2 and recurrentgemma-9b's g = 16 are
// one chunk, so each K/V row is read once).  The wrapper picks the number
// of splits from S, B and Hkv alone (decode_attention.py::decode_splits),
// never from the lengths, which would cost the host a sync; a block whose
// chunk lies outside the row's valid range writes an empty partial and
// returns.  With one split the block writes the output itself.  Else each
// block writes a float32 partial (running max in log2 units, sum,
// unnormalised accumulator) to scratch that the wrapper allocates, and the
// last block of a (batch row, KV head, row chunk) to finish, found by an
// atomic ticket that it then resets to 0, merges the partials in split
// order: one launch, and two launches on the same inputs are bitwise
// equal.
//
// bfloat16 (the served models): decode_attention_mma_kernel.  The g query
// rows of the chunk, zero-padded to 16, are the A operand of
// mma.sync.m16n8k16, so Q K^T and P V run on the tensor cores with no
// shuffle per position.  Each of the 4 warps walks its own 16-position
// tiles of the chunk with a private two-stage cp.async ring (16-byte
// copies; positions outside the valid range are zero-filled, never read),
// keeps its online softmax in the accumulator fragments (exp2f of
// log2(e)-prescaled logits), and splits P into bf16 hi + lo for P V as
// flash_attention.cu does (16 significant bits of P).  The 4 warps' states
// merge through shared memory.
//
// float32 (tests): decode_attention_kernel, on the CUDA cores.  One block
// of 8 warps per (split, chunk of up to 8 query rows, KV head, batch row);
// the rows sit in registers, each lane holding d/32 channels.  The warps
// stride over the chunk's valid positions, 4 a step: each lane loads its
// channels of the 4 K rows and 4 V rows first (vector loads of up to 16
// bytes, 8 loads in flight), the dot products are reduced across the warp
// by shuffles, and one online-softmax update per query row folds the 4
// positions in; the 8 warps' states merge through shared memory.
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
constexpr int kMaxSplits = 64;    // decode_attention.py::MAX_SPLITS

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* o;
  float* lse;        // [B * Hq] or null
  float* part;       // [B * Hq * n_split][d] acc, then (m, l) of each
  int* tickets;      // [B * Hkv * row chunks], 0 between launches
  int S, Hq, Hkv;
  float scale, softcap;   // softcap <= 0: none
  int window;             // < 0: none
  int n_split, chunk;     // positions [split * chunk, + chunk) a block
};

// The positions block (split, b) covers: [lo, hi), empty if lo >= hi.
struct Span {
  int lo, hi;
};

__device__ __forceinline__ Span block_span(const Args& a, int b, int split) {
  const int raw = a.lengths[b];
  const int p_end = min(raw, a.S);
  const int p_begin = a.window >= 0 ? max(0, raw - a.window) : 0;
  const int c0 = split * a.chunk;
  return Span{max(c0, p_begin), min(min(c0 + a.chunk, a.S), p_end)};
}

// A row's log-sum-exp from its merged max m (log2 units) and sum l.
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.0f ? (m + log2f(l)) * kLn2 : -INFINITY;
}

// One (row, channel) of a block's result: the output itself with one
// split (and the row's lse with channel 0), else the block's partial (the
// row's m and l with channel 0).
// The scratch holds the accumulators [B * Hq * n_split][D] first (so that
// each row of them starts on 16 bytes), then (m, l) pairs.
template <int D, typename T>
__device__ __forceinline__ void emit(const Args& a, long long row, int split,
                                     int c, float m, float l, float acc) {
  if (a.n_split == 1) {
    store(static_cast<T*>(a.o) + row * D + c, l > 0.0f ? acc / l : 0.0f);
    if (c == 0 && a.lse != nullptr) a.lse[row] = row_lse(m, l);
    return;
  }
  const long long slot = row * a.n_split + split;
  const long long n_slots =
      static_cast<long long>(gridDim.z) * a.Hq * a.n_split;
  a.part[slot * D + c] = acc;
  if (c == 0) {
    a.part[n_slots * D + 2 * slot] = l > 0.0f ? m : kNegInf;
    a.part[n_slots * D + 2 * slot + 1] = l;
  }
}

// After every thread of the block has emitted its partial (n_split > 1):
// the block takes a ticket; the last of the row chunk's n_split blocks
// merges the partials of rows [row0, row0 + nr) in split order, writes
// the output and resets the ticket.  Its loads go to L2 (the partials of
// other SMs), 4 channels a load, 4 such groups a thread at a time and 4
// splits unrolled, so that many are in flight.
template <int D, typename T>
__device__ void merge_splits(const Args& a, long long row0, int nr,
                             int ticket) {
  __shared__ int s_last;
  __shared__ float s_fac[kMaxSplits][16];
  __shared__ float s_l[16];
  __threadfence();            // this block's partial, visible to all
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(a.tickets + ticket, 1) == a.n_split - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const long long n_slots =
      static_cast<long long>(gridDim.z) * a.Hq * a.n_split;
  if (threadIdx.x < nr) {
    const int r = threadIdx.x;
    const float* ml = a.part + n_slots * D + 2 * (row0 + r) * a.n_split;
    float M = kNegInf;
    for (int s = 0; s < a.n_split; ++s)
      if (__ldcg(ml + 2 * s + 1) > 0.0f) M = fmaxf(M, __ldcg(ml + 2 * s));
    float L = 0.0f;
    for (int s = 0; s < a.n_split; ++s) {
      const float l = __ldcg(ml + 2 * s + 1);
      const float f = l > 0.0f ? exp2f(__ldcg(ml + 2 * s) - M) : 0.0f;
      s_fac[s][r] = f;
      L = fmaf(l, f, L);
    }
    s_l[r] = L;
    if (a.lse != nullptr) a.lse[row0 + r] = row_lse(M, L);
  }
  __syncthreads();
  // kPer groups of 4 channels a thread at a time: kPer * n_split loads of
  // 16 bytes, all independent.
  constexpr int kPer = 4;
  const int n4 = nr * (D / 4);
  for (int i0 = threadIdx.x; i0 < n4; i0 += kPer * blockDim.x) {
    const float4* acc[kPer];
    float A[kPer][4];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int idx = min(i0 + e * static_cast<int>(blockDim.x), n4 - 1);
      acc[e] = reinterpret_cast<const float4*>(
          a.part + (row0 + idx / (D / 4)) * a.n_split * D +
          (idx % (D / 4)) * 4);
#pragma unroll
      for (int c = 0; c < 4; ++c) A[e][c] = 0.0f;
    }
#pragma unroll 4
    for (int s = 0; s < a.n_split; ++s) {
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int idx = min(i0 + e * static_cast<int>(blockDim.x), n4 - 1);
        const float f = s_fac[s][idx / (D / 4)];
        const float4 x = __ldcg(acc[e] + s * (D / 4));
        A[e][0] = fmaf(x.x, f, A[e][0]);
        A[e][1] = fmaf(x.y, f, A[e][1]);
        A[e][2] = fmaf(x.z, f, A[e][2]);
        A[e][3] = fmaf(x.w, f, A[e][3]);
      }
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int idx = i0 + e * static_cast<int>(blockDim.x);
      if (idx >= n4) break;
      const int r = idx / (D / 4);
      const float L = s_l[r];
      T* o = static_cast<T*>(a.o) + (row0 + r) * D + (idx % (D / 4)) * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) store(o + c, L > 0.0f ? A[e][c] / L : 0.0f);
    }
  }
  if (threadIdx.x == 0) a.tickets[ticket] = 0;
}

// ---------------------------------------------------------------------------
// float32: CUDA cores.
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;       // query rows per block at most
constexpr int kUnroll = 4;     // positions per warp step

// E consecutive floats from `src`: 16-byte loads where they fill them,
// else one 8-byte load, else scalar loads.  The wrapper checks that the
// buffers are 16-byte aligned; every lane's offset is a multiple of E.
template <int E>
__device__ __forceinline__ void load_vec(const float* src, float (&dst)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const float4 w = reinterpret_cast<const float4*>(src)[i];
      dst[4 * i] = w.x;
      dst[4 * i + 1] = w.y;
      dst[4 * i + 2] = w.z;
      dst[4 * i + 3] = w.w;
    }
  } else if constexpr (E == 2) {
    const float2 w = *reinterpret_cast<const float2*>(src);
    dst[0] = w.x;
    dst[1] = w.y;
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) dst[e] = src[e];
  }
}

template <int D>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float)) * kWarps * kRows * (D + 2);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const Args a) {
  constexpr int E = D >= 32 ? D / 32 : 1;      // channels per lane
  extern __shared__ float smem[];
  float* sm_m = smem;                           // [kWarps][kRows]
  float* sm_l = sm_m + kWarps * kRows;          // [kWarps][kRows]
  float* sm_acc = sm_l + kWarps * kRows;        // [kWarps][kRows][D]

  const int g = a.Hq / a.Hkv;
  const int split = blockIdx.x % a.n_split;
  const int rc = blockIdx.x / a.n_split;
  const int r0 = rc * kRows;
  const int nr = min(kRows, g - r0);
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool active = lane * E < D;             // d = 16: half the lanes
  const int c0 = active ? lane * E : 0;
  const T* q = static_cast<const T*>(a.q);

  const long long qrow0 = static_cast<long long>(b) * a.Hq + hk * g + r0;
  float qr[kRows][E];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int e = 0; e < E; ++e) qr[r][e] = 0.0f;
    if (r < nr && active) load_vec<E>(q + (qrow0 + r) * D + c0, qr[r]);
  }

  const Span sp = block_span(a, b, split);
  const long long pos_stride = static_cast<long long>(a.Hkv) * D;
  const long long base = static_cast<long long>(b) * a.S * pos_stride +
                         hk * D + c0;
  const T* kb = static_cast<const T*>(a.k) + base;
  const T* vb = static_cast<const T*>(a.v) + base;
  const bool capped = a.softcap > 0.0f;
  const float s_scale = capped ? a.scale : a.scale * kLog2e;

  float m[kRows], l[kRows], acc[kRows][E];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.0f;
  }

  for (int p0 = sp.lo + warp * kUnroll; p0 < sp.hi;
       p0 += kWarps * kUnroll) {
    float kr[kUnroll][E], vr[kUnroll][E];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int e = 0; e < E; ++e) kr[u][e] = vr[u][e] = 0.0f;
      if (p0 + u < sp.hi && active) {
        load_vec<E>(kb + (p0 + u) * pos_stride, kr[u]);
        load_vec<E>(vb + (p0 + u) * pos_stride, vr[u]);
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
        float x = dot * s_scale;
        if (capped) x = a.softcap * tanhf(x / a.softcap) * kLog2e;
        s[u] = p0 + u < sp.hi ? x : kNegInf;
      }
      float m_new = m[r];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) m_new = fmaxf(m_new, s[u]);
      const float alpha = exp2f(m[r] - m_new);
      float p[kUnroll];
      float sum = 0.0f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u] = p0 + u < sp.hi ? exp2f(s[u] - m_new) : 0.0f;
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
      const float f = exp2f(sm_m[w * kRows + r] - mx);
      L = fmaf(sm_l[w * kRows + r], f, L);
      A = fmaf(sm_acc[(w * kRows + r) * D + c], f, A);
    }
    emit<D, T>(a, qrow0 + r, split, c, mx, L, A);
  }
  if (a.n_split > 1)
    merge_splits<D, T>(a, qrow0, nr,
                       (b * a.Hkv + hk) * (gridDim.x / a.n_split) + rc);
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16), a cp.async ring a warp.
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 16;    // query rows a block (one m16 tile)
constexpr int kTile = 16;       // positions a warp tile

// A block: 4 warps, each with a two-stage cp.async ring (chosen over 2 or
// 8 warps and 3 stages on the H100, PERF.md section 6).
template <int D>
struct MmaCfg {
  static constexpr int kWarps = 4;
  static constexpr int kStages = 2;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kLD = D + 8;                // row stride (bf16)
  static constexpr int kChunks = D / 8;            // 16-byte chunks a row
  static constexpr bool kQRegs = D <= 128;         // Q fragments in regs
  static constexpr int kQBytes = 2 * kMmaRows * kLD;
  // Each warp's ring: kStages x (K, V) x kTile rows.
  static constexpr int kRingBytes = 2 * kWarps * kStages * 2 * kTile * kLD;
  // The warps' states for the merge (reusing the ring): m, l, the rows'
  // weights, each row's max and sum, acc.
  static constexpr int kMergeBytes =
      4 * (kWarps * kMmaRows * (D + 3) + 2 * kMmaRows);
  static constexpr int kSmem =
      kQBytes + (kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes);
};

template <int D, typename T>
__global__ void __launch_bounds__(MmaCfg<D>::kThreads)
decode_attention_mma_kernel(const Args a) {
  using C = MmaCfg<D>;
  constexpr int kMmaWarps = C::kWarps;
  constexpr int kMmaThreads = C::kThreads;
  constexpr int LD = C::kLD;
  constexpr int NC = C::kChunks;
  constexpr int KQ = C::kQRegs ? D / 16 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);                 // [16][LD]
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + C::kQBytes);
  float* sm_m = reinterpret_cast<float*>(smem_raw + C::kQBytes);
  float* sm_l = sm_m + kMmaWarps * kMmaRows;              // [warps][16]
  float* sm_f = sm_l + kMmaWarps * kMmaRows;              // [warps][16]
  float* sm_row = sm_f + kMmaWarps * kMmaRows;            // [16][2]
  float* sm_acc = sm_row + 2 * kMmaRows;                  // [warps][16][D]

  const int g = a.Hq / a.Hkv;
  const int split = blockIdx.x % a.n_split;
  const int rc = blockIdx.x / a.n_split;
  const int r0 = rc * kMmaRows;
  const int nr = min(kMmaRows, g - r0);
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gr = lane / 4;       // the fragment row (and row + 8)
  const int t4 = lane % 4;       // the fragment column pair

  // The chunk's query rows, zero past nr.
  const long long qrow0 = static_cast<long long>(b) * a.Hq + hk * g + r0;
  const T* q = static_cast<const T*>(a.q);
  for (int c = tid; c < kMmaRows * NC; c += kMmaThreads) {
    const int r = c / NC;
    const int col = (c % NC) * 8;
    uint4 w = make_uint4(0, 0, 0, 0);
    if (r < nr) w = *reinterpret_cast<const uint4*>(q + (qrow0 + r) * D + col);
    *reinterpret_cast<uint4*>(Qs + r * LD + col) = w;
  }

  const Span sp = block_span(a, b, split);
  const int lo_al = sp.lo - sp.lo % kTile;
  const int n_tiles = sp.hi > sp.lo ? (sp.hi - lo_al + kTile - 1) / kTile : 0;
  const int my_tiles = warp < n_tiles ? (n_tiles - warp + kMmaWarps - 1) /
                                            kMmaWarps : 0;
  const long long pos_stride = static_cast<long long>(a.Hkv) * D;
  const long long base = static_cast<long long>(b) * a.S * pos_stride +
                         hk * D;
  const T* kg = static_cast<const T*>(a.k) + base;
  const T* vg = static_cast<const T*>(a.v) + base;
  bf16* my_ring = ring + warp * C::kStages * 2 * kTile * LD;
  // This warp's j-th tile (positions lo_al + 16 (warp + 4 j) ..) into ring
  // stage `stage`; positions outside [lo, hi) are zero.
  auto load_tile = [&](int j, int stage) {
    const int p0 = lo_al + (warp + kMmaWarps * j) * kTile;
    bf16* ks = my_ring + stage * 2 * kTile * LD;
    bf16* vs = ks + kTile * LD;
    for (int c = lane; c < kTile * NC; c += 32) {
      const int r = c / NC;
      const int col = (c % NC) * 8;
      const int p = p0 + r;
      const bool in = p >= sp.lo && p < sp.hi;
      const long long off = (in ? p : 0) * pos_stride + col;
      cp_async16(ks + r * LD + col, kg + off, in);
      cp_async16(vs + r * LD + col, vg + off, in);
    }
  };
  constexpr int kStages = C::kStages;
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < my_tiles) load_tile(j, j);
    cp_async_commit();
  }
  __syncthreads();               // Qs written

  const bool capped = a.softcap > 0.0f;
  const float s_scale = capped ? a.scale : a.scale * kLog2e;
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};
  uint32_t qf[KQ][4];
  const bf16* q_frag = Qs + (lane % 16) * LD + (lane / 16) * 8;
  if constexpr (C::kQRegs) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qf[kk], q_frag + kk * 16);
  }
  const int b_row = (lane / 16) * 8 + lane % 8;        // B of Q K^T
  const int b_col = ((lane / 8) % 2) * 8;
  const int v_row = ((lane / 8) % 2) * 8 + lane % 8;   // B of P V
  const int v_col = (lane / 16) * 8;

  for (int j = 0; j < my_tiles; ++j) {
    const int ahead = j + kStages - 1;
    if (ahead < my_tiles) load_tile(ahead, ahead % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();   // tile j has landed
    __syncwarp();
    const bf16* ks = my_ring + (j % kStages) * 2 * kTile * LD;
    const bf16* vs = ks + kTile * LD;
    const int p0 = lo_al + (warp + kMmaWarps * j) * kTile;

    // S = Q K^T: 16 rows x 16 positions.
    float s[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      if constexpr (C::kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        ldmatrix_x4(qa, q_frag + kk * 16);
      }
      uint32_t kb[4];
      ldmatrix_x4(kb, ks + b_row * LD + kk * 16 + b_col);
      mma_bf16_16816(s[0], qa, kb[0], kb[1]);
      mma_bf16_16816(s[1], qa, kb[2], kb[3]);
    }

    // Online softmax on the fragments (rows gr and gr + 8).
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + n * 8 + 2 * t4 + (e % 2);
        float x = s[n][e] * s_scale;
        if (capped) x = a.softcap * tanhf(x / a.softcap) * kLog2e;
        x = p >= sp.lo && p < sp.hi ? x : -INFINITY;
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      m_use[r] = m_new == -INFINITY ? 0.0f : m_new;
      alpha[r] = exp2f(m[r] - m_use[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m_use[e / 2]);
        s[n][e] = p;
        l[e / 2] += p;
      }
    }
    uint32_t ph[4], pl[4];
    split_bf16x2(s[0][0], s[0][1], ph[0], pl[0]);
    split_bf16x2(s[0][2], s[0][3], ph[1], pl[1]);
    split_bf16x2(s[1][0], s[1][1], ph[2], pl[2]);
    split_bf16x2(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
    for (int db = 0; db < D / 16; ++db) {
      o[2 * db][0] *= alpha[0];
      o[2 * db][1] *= alpha[0];
      o[2 * db][2] *= alpha[1];
      o[2 * db][3] *= alpha[1];
      o[2 * db + 1][0] *= alpha[0];
      o[2 * db + 1][1] *= alpha[0];
      o[2 * db + 1][2] *= alpha[1];
      o[2 * db + 1][3] *= alpha[1];
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vs + v_row * LD + db * 16 + v_col);
      mma_bf16_16816(o[2 * db], ph, vb[0], vb[1]);
      mma_bf16_16816(o[2 * db], pl, vb[0], vb[1]);
      mma_bf16_16816(o[2 * db + 1], ph, vb[2], vb[3]);
      mma_bf16_16816(o[2 * db + 1], pl, vb[2], vb[3]);
    }
    __syncwarp();                // stage j % kStages is refilled next
  }
  cp_async_wait<0>();
  __syncthreads();               // every warp is done with its ring

  // The warps' states (m in log2 units; m = -1e30 for a warp that saw no
  // position) into shared memory, then merged.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (t4 == 0) {
    sm_m[warp * kMmaRows + gr] = m[0] == -INFINITY ? kNegInf : m[0];
    sm_m[warp * kMmaRows + gr + 8] = m[1] == -INFINITY ? kNegInf : m[1];
    sm_l[warp * kMmaRows + gr] = l[0];
    sm_l[warp * kMmaRows + gr + 8] = l[1];
  }
  float* my_acc = sm_acc + warp * kMmaRows * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t4;
    if (gr < nr) {
      my_acc[gr * D + col] = o[j][0];
      my_acc[gr * D + col + 1] = o[j][1];
    }
    if (gr + 8 < nr) {
      my_acc[(gr + 8) * D + col] = o[j][2];
      my_acc[(gr + 8) * D + col + 1] = o[j][3];
    }
  }
  __syncthreads();
  // Each row's weight of each warp, e^(m_w - M), and the row's M and sum.
  if (tid < nr) {
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) M = fmaxf(M, sm_m[w * kMmaRows + tid]);
    float L = 0.0f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) {
      const float f = exp2f(sm_m[w * kMmaRows + tid] - M);
      sm_f[w * kMmaRows + tid] = f;
      L = fmaf(sm_l[w * kMmaRows + tid], f, L);
    }
    sm_row[2 * tid] = M;
    sm_row[2 * tid + 1] = L;
  }
  __syncthreads();
  for (int idx = tid; idx < nr * D; idx += kMmaThreads) {
    const int r = idx / D;
    const int c = idx % D;
    float A = 0.0f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w)
      A = fmaf(sm_acc[(w * kMmaRows + r) * D + c], sm_f[w * kMmaRows + r], A);
    emit<D, T>(a, qrow0 + r, split, c, sm_row[2 * r], sm_row[2 * r + 1], A);
  }
  if (a.n_split > 1)
    merge_splits<D, T>(a, qrow0, nr,
                       (b * a.Hkv + hk) * (gridDim.x / a.n_split) + rc);
}

// Launches `kernel` on the grid (splits x row chunks, Hkv, B).  Each
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
  const int g = a.Hq / a.Hkv;
  const dim3 grid(a.n_split * ((g + rows - 1) / rows), a.Hkv, B);
  kernel<<<grid, threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// kMma: the bfloat16 tensor-core kernel, else the float32 one.
template <int D, bool kMma>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  static bool attr_set = false;
  if constexpr (kMma) {
    return launch_with(decode_attention_mma_kernel<D, bf16>,
                       MmaCfg<D>::kSmem, MmaCfg<D>::kThreads, kMmaRows,
                       attr_set, a, B, stream);
  } else {
    return launch_with(decode_attention_kernel<D, float>, smem_bytes<D>(),
                       kThreads, kRows, attr_set, a, B, stream);
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
// head dim, dtype code or split it does not take).  dtype: 0 float32 (the
// CUDA-core kernel), 1 bfloat16 (the tensor-core kernel), the same for q,
// the caches and out.  q [B, Hq, d], the caches [B, S, Hkv, d] and
// out [B, Hq, d] are contiguous and 16-byte aligned; lengths is [B]
// int32; out is written in full, and so is lse [B, Hq] (float32) unless
// it is null.  The cache is split into n_split chunks
// of `chunk` positions (n_split * chunk >= S); with n_split > 1, `part`
// holds B * Hq * n_split * (d + 2) float32 of scratch and `tickets`
// B * Hkv * ceil(Hq / Hkv / 8) int32 that are 0 at the launch (the kernel
// leaves them 0).
int decode_attention_fwd(const void* q, const void* k_cache,
                         const void* v_cache, const int* lengths, void* out,
                         float* lse, float* part, int* tickets, int B,
                         int S, int Hq, int Hkv, int d, int dtype,
                         float scale,
                         float softcap, int window, int n_split, int chunk,
                         int device, void* stream) {
  if (B <= 0 || Hq <= 0) return 0;
  if (n_split < 1 || n_split > kMaxSplits ||
      static_cast<long long>(n_split) * chunk < S)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{q,    k_cache, v_cache, lengths, out, lse,     part, tickets,
               S,    Hq,      Hkv,     scale,   softcap, window, n_split,
               chunk};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = launch_d<false>(a, B, d, s); break;
    case 1: err = launch_d<true>(a, B, d, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
