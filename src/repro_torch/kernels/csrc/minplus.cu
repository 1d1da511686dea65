// Tropical (min, +) matrix product, hand-written for sm_90a.
//
// Replaces repro/kernels/minplus.py::minplus_tiled_pallas (minplus.py:419,
// kernel body _minplus_kernel :404), which apsp_tiled_pallas (:448) squares
// with.  For A [M, K] and B [K, N] (float32, contiguous) it computes
//   out[i, j] = min(1e9, min_k A[i, k] + B[k, j]),
// the Pallas kernel's semantics: its accumulator starts at 1e9 and its
// padding is 1e9 (see repro_torch/kernels/ref.py::minplus_ref).  With a
// third operand C [M, N] the accumulator starts at min(1e9, C[i, j]), which
// fuses APSP's D = min(D, D (min,+) D) into one launch (ref.py::
// minplus_ref with C).  Each sum is rounded once (__fadd_rn, -fmad=false)
// and every min is min.NaN (a NaN operand gives NaN, as jnp.minimum and
// torch.minimum do; fminf would drop it), so the result is bit for bit the
// plain version's whatever the order over k.  Ragged edges are padded with
// 1e9: a k beyond K contributes 1e9 + 1e9, which never wins against an
// accumulator that starts at 1e9, and rows or columns beyond M or N are not
// stored.
//
// Bound on an H100 SXM: an update is two instructions, an FADD and an
// FMNMX, that nothing on Hopper fuses or packs, so M * N * K updates take
// 2 M N K lane-instructions at 128 lanes a clock on each of 132 SMs:
// 0.2167 ms at M = N = K = 1536 and 1 980 MHz.  (The data sheet's
// 67 TFLOP/s counts an FFMA as two operations; min-plus cannot reach it.)
// FMNMX issues at 64 lanes a clock an SM, which gives the same bound.
//
// Design: a block computes a BM x BN tile of out; each thread holds TM x 8
// accumulators (two float4 columns BN / 2 apart, rows TY apart).  K is
// walked in steps of BK through a STAGES-deep ring of shared-memory slabs
// filled by cp.async, one barrier a step.  A's slab is stored i-major (as
// in memory, rows padded by 4 floats), so a thread reads 4 consecutive k of
// one row as a float4; with B's k-rows read as float4 too, a thread issues
// TM + 8 shared loads a 4 k, one per 32 TM / (TM + 8) updates.  Slabs with
// every k inside K are staged by unguarded 16-byte copies, in a loop of
// their own, where K and N are multiples of 4 and A and B 16-byte aligned;
// a tile's rows beyond M and columns beyond N are copied from the last row
// or column (they feed only entries that are not stored), so only the last
// partial K-step takes a guarded copy that writes the 1e9 padding.  Any
// other shape stages every slab by the guarded 4-byte copies.  KG > 1
// splits each slab's k among KG groups of threads that share the tile and
// merges their accumulators through shared memory at the end (min is
// exact, so any split is): more warps a tile, and a block
// whose warps spread evenly over an SM's four schedulers, so that no
// scheduler's warps wait at the barrier for another's (a 6-warp block took
// 0.39 ms at 1536^3, the same tile in 12 warps 0.31; launch/
// kernel_variants.py --set minplus).  One instance: 96 x 96 tiles of 6 x 8
// a thread in two k-groups (384 threads, one block an SM), whose 256 tiles
// fill 132 SMs to 0.97 at APSP's V = 1536 (kernels/minplus.py::tile_fill).
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

using mma_bf16::cp_async16;
using mma_bf16::cp_async_commit;
using mma_bf16::cp_async_wait;
using mma_bf16::smem_addr;

constexpr float kNoEdge = 1.0e9f;
// The tile (kernels/minplus.py TILE is kBM x kBN).
constexpr int kBM = 96;
constexpr int kBN = 96;
constexpr int kTM = 6;
constexpr int kKG = 2;
constexpr int kBK = 32;
constexpr int kStages = 3;
constexpr int kMinBlocks = 1;

// NaN-propagating min: one FMNMX.NAN.
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// A cp.async of V floats: 16 bytes bypassing L1, or 4 bytes through it
// (the guarded copies).
template <int V>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem) {
  if constexpr (V == 4) {
    cp_async16(smem, gmem, true);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(smem_addr(smem)), "l"(gmem), "n"(4 * V));
  }
}

__device__ __forceinline__ float lane(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

template <int BM_, int BN_, int TM_, int KG_, int BK_, int STAGES_,
          int MINB_>
struct Geometry {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, KG = KG_, BK = BK_;
  static constexpr int STAGES = STAGES_, MINB = MINB_;
  static constexpr int TX = BN / 8;          // threads along a tile row
  static constexpr int TY = BM / TM;         // along a tile column
  static constexpr int kGroup = TX * TY;     // threads of one k-group
  static constexpr int kThreads = kGroup * KG;
  static constexpr int SA = BK + 4;          // A slab row stride (floats)
  static constexpr int kKs = BK / KG;        // k of a slab a group takes
  static constexpr int kStage = BM * SA + BK * BN;  // floats a stage
  static constexpr int kRing = STAGES * kStage;
  static constexpr int kMerge = (KG - 1) * BM * BN;
  static constexpr int kSmemBytes =
      4 * (kRing > kMerge ? kRing : kMerge);
  static_assert(BN % 8 == 0 && BM % TM == 0, "tile");
  static_assert(BK % KG == 0 && kKs % 4 == 0, "k-groups take 4 k at a time");
  static_assert(kThreads % 32 == 0, "whole warps");
  static_assert(STAGES >= 2, "ring");
};

// How a slab is copied V floats at a time (4: full slabs, 1: guarded ones):
// each thread's copies of A lie RA rows apart (kItA of them), its copies of
// B RB rows apart.
template <class G, int V>
struct Staging {
  static constexpr int kRowA = G::BK / V, kRowB = G::BN / V;  // copies a row
  static_assert(G::kThreads % kRowA == 0 && G::kThreads % kRowB == 0,
                "a thread's copies lie whole rows apart");
  static constexpr int RA = G::kThreads / kRowA;
  static constexpr int RB = G::kThreads / kRowB;
  static_assert(G::BM % RA == 0 && G::BK % RB == 0,
                "every thread makes the same number of copies");
  static constexpr int kItA = G::BM / RA, kItB = G::BK / RB;
};

using Tile = Geometry<kBM, kBN, kTM, kKG, kBK, kStages, kMinBlocks>;

// One full slab (every k inside K) by unguarded 16-byte copies: this
// thread's copies of A from a[it] + ka (rows RA apart, clamped to M - 1)
// and of B from b (RB rows apart, columns clamped to N - 4) into stage st
// at offsets sa and sb.  The clamped rows and columns fill only entries of
// out that are not stored.
template <class G>
__device__ __forceinline__ void load_full(
    float* st, int sa, int sb, const float* const (&a)[Staging<G, 4>::kItA],
    int ka, const float* b, int N) {
  using S = Staging<G, 4>;
#pragma unroll
  for (int it = 0; it < S::kItA; ++it)
    cp_async<4>(st + sa + it * S::RA * G::SA, a[it] + ka);
#pragma unroll
  for (int it = 0; it < S::kItB; ++it)
    cp_async<4>(st + sb + it * S::RB * G::BN,
                b + static_cast<size_t>(it * S::RB) * N);
}

// A guarded slab (the last, partial one, k0 + BK > K, or any slab of a
// shape without 16-byte copies) by 4-byte copies of the k inside K, 1e9
// beyond it (rows and columns clamped as in load_full).  A thread's copies
// of A all take one k (so one guard), its copies of B one column.
template <class G>
__device__ __forceinline__ void load_guarded(float* st, const float* A,
                                             const float* B, int i0, int j0,
                                             int k0, int M, int N, int K) {
  using S = Staging<G, 1>;
  const int tid = threadIdx.x;
  const int ra = tid / S::kRowA, qa = tid % S::kRowA;
  const int rb = tid / S::kRowB, qb = tid % S::kRowB;
  const int ka = k0 + qa;
  const int j = min(j0 + qb, N - 1);
  float* As = st + ra * G::SA + qa;
  float* Bs = st + G::BM * G::SA + rb * G::BN + qb;
#pragma unroll
  for (int it = 0; it < S::kItA; ++it) {
    const int i = min(i0 + ra + it * S::RA, M - 1);
    float* dst = As + it * S::RA * G::SA;
    if (ka < K) {
      cp_async<1>(dst, A + static_cast<size_t>(i) * K + ka);
    } else {
      *dst = kNoEdge;
    }
  }
#pragma unroll
  for (int it = 0; it < S::kItB; ++it) {
    const int k = k0 + rb + it * S::RB;
    float* dst = Bs + it * S::RB * G::BN;
    if (k < K) {
      cp_async<1>(dst, B + static_cast<size_t>(k) * N + j);
    } else {
      *dst = kNoEdge;
    }
  }
}

// The updates of one slab: this thread's group's kKs k, 4 at a time.
// a_off / b_off: the thread's row / column offsets in the slab.
template <class G>
__device__ __forceinline__ void compute(const float* st, int a_off, int b_off,
                                        float (&acc)[G::TM][8]) {
  const float* As = st + a_off;
  const float* Bs = st + G::BM * G::SA + b_off;
#pragma unroll
  for (int kc = 0; kc < G::kKs / 4; ++kc) {
    float4 a[G::TM];
#pragma unroll
    for (int r = 0; r < G::TM; ++r)
      a[r] = *reinterpret_cast<const float4*>(As + r * G::TY * G::SA +
                                              4 * kc);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* brow = Bs + (4 * kc + u) * G::BN;
      const float4 b0 = *reinterpret_cast<const float4*>(brow);
      const float4 b1 = *reinterpret_cast<const float4*>(brow + G::BN / 2);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < G::TM; ++r) {
        const float ar = lane(a[r], u);
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[r][c] = min_nan(acc[r][c], __fadd_rn(ar, b[c]));
      }
    }
  }
}

// full: K and N multiples of 4 and A and B 16-byte aligned, so that full
// slabs are copied 16 bytes at a time (else every slab is guarded).
// vec_out: N a multiple of 4 and out 16-byte aligned, so rows of out are
// stored as float4.
template <class G>
__global__ void __launch_bounds__(G::kThreads, G::MINB)
minplus_kernel(const float* __restrict__ A, const float* __restrict__ B,
               const float* __restrict__ C, float* __restrict__ out, int M,
               int N, int K, int full, int vec_out) {
  using S = Staging<G, 4>;
  constexpr int V = 4;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int g = tid / G::kGroup;
  const int tg = tid % G::kGroup;
  const int tx = tg % G::TX, ty = tg / G::TX;
  const int i0 = blockIdx.y * G::BM, j0 = blockIdx.x * G::BN;
  const int nk = (K + G::BK - 1) / G::BK;
  const int n_full = full ? K / G::BK : 0;   // slabs copied unguarded
  const int a_off = ty * G::SA + g * G::kKs;
  const int b_off = g * G::kKs * G::BN + 4 * tx;
  // The full slabs' copies: this thread's first lies in row ra of A's slab
  // and row rb of B's.
  const int ra = tid / S::kRowA, rb = tid / S::kRowB;
  const int qa = V * (tid % S::kRowA), qb = V * (tid % S::kRowB);
  const int sa = ra * G::SA + qa;
  const int sb = G::BM * G::SA + rb * G::BN + qb;
  const float* a_src[S::kItA];
#pragma unroll
  for (int it = 0; it < S::kItA; ++it)
    a_src[it] = A + static_cast<size_t>(min(i0 + ra + it * S::RA, M - 1)) *
                        K + qa;
  const float* b_src =
      B + static_cast<size_t>(rb) * N + min(j0 + qb, max(N - V, 0));
  const size_t b_step = static_cast<size_t>(G::BK) * N;

  // Slabs 0 .. STAGES - 2 into the ring.
#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) {
    float* st = smem + s * G::kStage;
    if (s < n_full) {
      load_full<G>(st, sa, sb, a_src, s * G::BK, b_src + s * b_step, N);
    } else if (s < nk) {
      load_guarded<G>(st, A, B, i0, j0, s * G::BK, M, N, K);
    }
    cp_async_commit();
  }

  // The accumulators start at min(1e9, C) (group 0; the others at 1e9).
  float acc[G::TM][8];
#pragma unroll
  for (int r = 0; r < G::TM; ++r) {
    const int i = i0 + ty + r * G::TY;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = j0 + (c / 4) * (G::BN / 2) + 4 * tx + c % 4;
      acc[r][c] = (C != nullptr && g == 0 && i < M && j < N)
                      ? min_nan(kNoEdge, C[static_cast<size_t>(i) * N + j])
                      : kNoEdge;
    }
  }

  // Step t computes slab t from stage rd and stages slab t + STAGES - 1
  // into stage wr (the one read a step before); both advance a stage a
  // step.  Three loops: full slabs staged by unguarded 16-byte copies (the
  // steady state), then guarded slabs, then the ring's last STAGES - 1
  // steps, which stage nothing.
  float* const last = smem + (G::STAGES - 1) * G::kStage;
  float* rd = smem;
  float* wr = last;
  int t = 0;
  {
    int ka = (G::STAGES - 1) * G::BK;
    const float* pb = b_src + (G::STAGES - 1) * b_step;
    for (; t + G::STAGES - 1 < n_full; ++t) {
      cp_async_wait<G::STAGES - 2>();
      __syncthreads();
      load_full<G>(wr, sa, sb, a_src, ka, pb, N);
      cp_async_commit();
      compute<G>(rd, a_off, b_off, acc);
      ka += G::BK;
      pb += b_step;
      rd = rd == last ? smem : rd + G::kStage;
      wr = wr == last ? smem : wr + G::kStage;
    }
  }
  for (; t + G::STAGES - 1 < nk; ++t) {
    cp_async_wait<G::STAGES - 2>();
    __syncthreads();
    load_guarded<G>(wr, A, B, i0, j0, (t + G::STAGES - 1) * G::BK, M, N, K);
    cp_async_commit();
    compute<G>(rd, a_off, b_off, acc);
    rd = rd == last ? smem : rd + G::kStage;
    wr = wr == last ? smem : wr + G::kStage;
  }
  for (; t < nk; ++t) {
    cp_async_wait<G::STAGES - 2>();
    __syncthreads();
    cp_async_commit();
    compute<G>(rd, a_off, b_off, acc);
    rd = rd == last ? smem : rd + G::kStage;
  }

  if constexpr (G::KG > 1) {
    // Merge the k-groups' accumulators into group 0's.
    cp_async_wait<0>();
    __syncthreads();
    float* red = smem;
    if (g > 0) {
#pragma unroll
      for (int r = 0; r < G::TM; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float4*>(
              red + ((g - 1) * G::BM + ty + r * G::TY) * G::BN +
              h * (G::BN / 2) + 4 * tx) =
              make_float4(acc[r][4 * h], acc[r][4 * h + 1],
                          acc[r][4 * h + 2], acc[r][4 * h + 3]);
    }
    __syncthreads();
    if (g > 0) return;
#pragma unroll
    for (int gg = 0; gg < G::KG - 1; ++gg)
#pragma unroll
      for (int r = 0; r < G::TM; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(
              red + (gg * G::BM + ty + r * G::TY) * G::BN + h * (G::BN / 2) +
              4 * tx);
          acc[r][4 * h] = min_nan(acc[r][4 * h], v.x);
          acc[r][4 * h + 1] = min_nan(acc[r][4 * h + 1], v.y);
          acc[r][4 * h + 2] = min_nan(acc[r][4 * h + 2], v.z);
          acc[r][4 * h + 3] = min_nan(acc[r][4 * h + 3], v.w);
        }
  }

#pragma unroll
  for (int r = 0; r < G::TM; ++r) {
    const int i = i0 + ty + r * G::TY;
    if (i >= M) continue;
    float* row = out + static_cast<size_t>(i) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + h * (G::BN / 2) + 4 * tx;
      if (vec_out && j + 4 <= N) {
        *reinterpret_cast<float4*>(row + j) =
            make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                        acc[r][4 * h + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (j + c < N) row[j + c] = acc[r][4 * h + c];
      }
    }
  }
}

// Full slabs take 16-byte copies: K and N multiples of 4, A and B 16-byte
// aligned.
bool copies16(const float* A, const float* B, int N, int K) {
  return K % 4 == 0 && N % 4 == 0 &&
         ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(B)) &
          15) == 0;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The kernel raises its dynamic shared-memory limit once, on first use.
cudaError_t prepare() {
  static bool attr_set = false;
  if (attr_set) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      minplus_kernel<Tile>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile::kSmemBytes);
  if (err == cudaSuccess) attr_set = true;
  return err;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) of `device` and returns
// cudaGetLastError() as an int (0 on success).  A [M, K], B [K, N], C
// [M, N] (or null) and out [M, N] are contiguous float32 device buffers;
// out is written in full and must not overlap A, B or C.
int minplus_f32(const float* A, const float* B, const float* C, float* out,
                int M, int N, int K, int device, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = prepare();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + Tile::BN - 1) / Tile::BN,
                  (M + Tile::BM - 1) / Tile::BM);
  minplus_kernel<Tile><<<grid, Tile::kThreads, Tile::kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      A, B, C, out, M, N, K, copies16(A, B, N, K),
      N % 4 == 0 && aligned16(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
