// Blocked (three-phase) Floyd-Warshall with shortest-path counts,
// hand-written for sm_90a.
//
// Replaces repro/kernels/minplus.py::fw_counts_tiled_pallas (minplus.py:305;
// kernel bodies _fw_diag_kernel :193, _fw_panel_kernel :222 and
// _fw_outer_kernel :276).  For W[B, V, V] (float32, zero diagonal, 1e9 = no
// edge) it computes the distances D and the shortest-path counts N, bit for
// bit equal to repro_torch/kernels/ref.py::fw_counts_ref (and to the plain
// blocked version fw_counts_tiled_ref, whose snapshot scheme it follows).
//
// The snapshot scheme.  V is padded to Vt, a multiple of the tile BT, with
// isolated nodes (zero diagonal, no edges), which no relaxation can use:
// every path through one costs at least 1e9, and a tie there fails the
// cand < 1e8 test.  For each pivot block kk (pivots k0 .. k0+BT-1):
//   phase 1 (one block per placement) relaxes the diagonal tile over its BT
//     pivots, masking the pivot's row and column, and records row k and
//     column k of the tile at pivot k's time (its snapshots);
//   phase 2 (one block per panel tile, row and column panels) relaxes each
//     panel tile over the BT pivots.  A row-panel tile takes its left operand
//     D[i, k] from the diagonal column snapshot and its right operand from
//     its own row k, masking row k; a column-panel tile the transpose.  Each
//     records its own snapshots;
//   phase 3 (one block per outer tile, skipping the pivot rows and columns)
//     replays the BT pivots from the column-panel and row-panel snapshots.
// Every (cell, pivot) update thus sees the reference's operands in the
// reference's order.  The pivot row and column tiles are updated once, by
// phases 1 and 2 only: N's tie accumulation is not idempotent.
// Snapshots live in device memory k-major: rs[b][k][j] = D[k0 + k][j] and
// cs[b][k][i] = D[i][k0 + k] at pivot k's time, each [B, BT, Vt].
//
// Exactness, as in fw_counts.cu: every float op is one IEEE round-to-nearest
// op (__fadd_rn, __fmul_rn), the library is built with -fmad=false, the
// count product is clipped at 1e30 before the add, < and == compare as the
// reference does, and the tie rule applies only while cand < 1e8.
//
// Bound on an H100 SXM.  One call does about B * V^3 relaxations of 10
// float32 operations each (add, mul, min, three compares, add, two selects,
// min), against 67 TFLOP/s outside the tensor cores (min-plus with counts
// has no tensor-core form), and moves 3 * B * V^2 * 4 bytes at 3.35 TB/s.
// It is bound by operations: 0.54 ms at B = 1, V = 1536 (homog256 placeit).
//
// Design.  Each thread owns a 4 x 4 set of cells of a tile, strided by
// BT / 4 so that neighbouring threads touch neighbouring addresses, and
// holds their D and N in registers for the whole phase.  Phase 1 and 2
// need one barrier per pivot: the owners of row (or column) k write it to
// its own shared-memory slot, which no later pivot overwrites, so one
// barrier orders the write before every read.  Phase 3 stages the tile's
// column-panel and row-panel snapshots (4 * BT^2 floats, 64 KB at BT = 64)
// in shared memory once and walks the BT pivots with no barrier between
// them, because the snapshots are only read.  Phase 3 runs on B * nb^2
// blocks, which is what fills the 132 SMs where the one-block-per-placement
// kernel (fw_counts.cu) uses B of them.
//
// Tile.  BT = 64.  On an NVIDIA H100 80GB HBM3 at 700 W a 32 tile was
// slower at the scorer's shapes of the 100+-chiplet families: it doubles the
// serial phase-1 and phase-2 work and the launches (PERF.md, section 6).
// BT = 128 would need 256 KB of snapshots in phase 3, over the 227 KB a
// block may have.
//
// What this leaves for later: phases 1 and 2 serialise on nb * BT barriers
// per call on few blocks (55 % of the time at homog256 placeit, by
// torch.profiler on the H100 above); phase 3 reads its snapshots with
// plain loads (cp.async or TMA would overlap them with the previous tile's
// work) and holds 16 cells a thread (larger register tiles would cut the
// shared memory traffic per relaxation).
#include <cuda_runtime.h>

#include <cstddef>
#include <initializer_list>

namespace {

constexpr float kInfCut = 1.0e8f;
constexpr float kCountClip = 1.0e30f;
constexpr float kNoEdge = 1.0e9f;
constexpr int BT = 64;     // the tile: BT x BT cells per block
constexpr int kMicro = 4;  // cells per thread along each tile axis
constexpr int T = BT / kMicro;
constexpr int kThreads = T * T;

// One pivot update of one cell, in the reference's order.
__device__ __forceinline__ void relax(float& d, float& n, float a_d,
                                      float a_n, float b_d, float b_n) {
  const float cand = __fadd_rn(a_d, b_d);
  const float n_cand = fminf(__fmul_rn(a_n, b_n), kCountClip);
  if (cand < d) {
    d = cand;
    n = n_cand;
  } else if (cand == d && cand < kInfCut) {
    n = fminf(__fadd_rn(n, n_cand), kCountClip);
  }
}

// D = W padded with isolated nodes; N0 = 1 on finite off-diagonal edges
// plus the identity.  Grid (x, B), grid-stride over the Vt * Vt cells.
__global__ void init_kernel(const float* __restrict__ W, float* __restrict__ D,
                            float* __restrict__ N, int V, int Vt) {
  const size_t b = blockIdx.y;
  const size_t vv = static_cast<size_t>(Vt) * Vt;
  const float* w = W + b * V * V;
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       e < vv; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int i = static_cast<int>(e / Vt);
    const int j = static_cast<int>(e % Vt);
    float x;
    if (i < V && j < V) {
      x = w[static_cast<size_t>(i) * V + j];
    } else {
      x = (i == j) ? 0.0f : kNoEdge;
    }
    D[b * vv + e] = x;
    N[b * vv + e] = (i == j) ? 1.0f : (x < kInfCut ? 1.0f : 0.0f);
  }
}

// Loads / stores the thread's 4 x 4 cells of the BT x BT tile at `t`
// (row stride Vt): cell (r, c) is (ty + T*r, tx + T*c).
__device__ __forceinline__ void load_tile(const float* t, int Vt, int ty,
                                          int tx, float (&x)[kMicro][kMicro]) {
#pragma unroll
  for (int r = 0; r < kMicro; ++r)
#pragma unroll
    for (int c = 0; c < kMicro; ++c)
      x[r][c] = t[static_cast<size_t>(ty + T * r) * Vt + tx + T * c];
}

__device__ __forceinline__ void store_tile(float* t, int Vt, int ty, int tx,
                                           const float (&x)[kMicro][kMicro]) {
#pragma unroll
  for (int r = 0; r < kMicro; ++r)
#pragma unroll
    for (int c = 0; c < kMicro; ++c)
      t[static_cast<size_t>(ty + T * r) * Vt + tx + T * c] = x[r][c];
}

// Copies a k-major [BT][BT] slab between shared memory and device memory
// (row stride Vt), all threads of the block cooperating.
template <bool kToGlobal>
__device__ __forceinline__ void copy_slab(float* smem, float* g, int Vt) {
  for (int e = threadIdx.x; e < BT * BT; e += kThreads) {
    const int k = e / BT;
    const int x = e % BT;
    float* gp = g + static_cast<size_t>(k) * Vt + x;
    if (kToGlobal) {
      *gp = smem[e];
    } else {
      smem[e] = *gp;
    }
  }
}

// Phase 1: the diagonal tile of placement blockIdx.x.
__global__ void __launch_bounds__(kThreads)
diag_kernel(float* __restrict__ D, float* __restrict__ N,
            float* __restrict__ rs_d, float* __restrict__ rs_n,
            float* __restrict__ cs_d, float* __restrict__ cs_n, int Vt,
            int k0) {
  extern __shared__ float smem[];
  float* row_d = smem;                // [k][j]: row k at pivot k's time
  float* row_n = smem + BT * BT;
  float* col_d = smem + 2 * BT * BT;  // [k][i]: column k at pivot k's time
  float* col_n = smem + 3 * BT * BT;
  const int ty = threadIdx.x / T;
  const int tx = threadIdx.x % T;
  const size_t b = blockIdx.x;
  const size_t vv = static_cast<size_t>(Vt) * Vt;
  const size_t tile = b * vv + static_cast<size_t>(k0) * Vt + k0;
  float d[kMicro][kMicro], n[kMicro][kMicro];
  load_tile(D + tile, Vt, ty, tx, d);
  load_tile(N + tile, Vt, ty, tx, n);

#pragma unroll
  for (int g = 0; g < kMicro; ++g) {
    for (int q = 0; q < T; ++q) {
      const int k = g * T + q;        // row k is (ty = q, r = g); column k
      if (ty == q) {                  // is (tx = q, c = g)
#pragma unroll
        for (int c = 0; c < kMicro; ++c) {
          row_d[k * BT + tx + T * c] = d[g][c];
          row_n[k * BT + tx + T * c] = n[g][c];
        }
      }
      if (tx == q) {
#pragma unroll
        for (int r = 0; r < kMicro; ++r) {
          col_d[k * BT + ty + T * r] = d[r][g];
          col_n[k * BT + ty + T * r] = n[r][g];
        }
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kMicro; ++r) {
        const int i = ty + T * r;
        const float a_d = col_d[k * BT + i];
        const float a_n = col_n[k * BT + i];
#pragma unroll
        for (int c = 0; c < kMicro; ++c) {
          const int j = tx + T * c;
          if (i != k && j != k) {
            relax(d[r][c], n[r][c], a_d, a_n, row_d[k * BT + j],
                  row_n[k * BT + j]);
          }
        }
      }
    }
  }
  store_tile(D + tile, Vt, ty, tx, d);
  store_tile(N + tile, Vt, ty, tx, n);
  // Every slot was written before the last pivot's barrier.
  const size_t snap = b * BT * static_cast<size_t>(Vt) + k0;
  copy_slab<true>(row_d, rs_d + snap, Vt);
  copy_slab<true>(row_n, rs_n + snap, Vt);
  copy_slab<true>(col_d, cs_d + snap, Vt);
  copy_slab<true>(col_n, cs_n + snap, Vt);
}

// Phase 2: panel tile blockIdx.x of placement blockIdx.z; blockIdx.y = 0
// for the row panel (the pivot rows), 1 for the column panel.
__global__ void __launch_bounds__(kThreads)
panel_kernel(float* __restrict__ D, float* __restrict__ N,
             float* __restrict__ rs_d, float* __restrict__ rs_n,
             float* __restrict__ cs_d, float* __restrict__ cs_n, int Vt,
             int k0) {
  const int p0 = blockIdx.x * BT;
  if (p0 == k0) return;               // the diagonal tile is phase 1's
  const bool is_row = blockIdx.y == 0;
  extern __shared__ float smem[];
  float* diag_d = smem;               // [k][x]: the diagonal snapshot
  float* diag_n = smem + BT * BT;
  float* own_d = smem + 2 * BT * BT;  // [k][x]: this tile's snapshot
  float* own_n = smem + 3 * BT * BT;
  const int ty = threadIdx.x / T;
  const int tx = threadIdx.x % T;
  const size_t b = blockIdx.z;
  const size_t vv = static_cast<size_t>(Vt) * Vt;
  const size_t snap = b * BT * static_cast<size_t>(Vt);
  // Row panel: rows k0.., columns p0..; left operand D[i][k] from the
  // diagonal column snapshot.  Column panel: rows p0.., columns k0..;
  // right operand D[k][j] from the diagonal row snapshot.
  const size_t tile = is_row ? b * vv + static_cast<size_t>(k0) * Vt + p0
                             : b * vv + static_cast<size_t>(p0) * Vt + k0;
  copy_slab<false>(diag_d, (is_row ? cs_d : rs_d) + snap + k0, Vt);
  copy_slab<false>(diag_n, (is_row ? cs_n : rs_n) + snap + k0, Vt);
  float d[kMicro][kMicro], n[kMicro][kMicro];
  load_tile(D + tile, Vt, ty, tx, d);
  load_tile(N + tile, Vt, ty, tx, n);

#pragma unroll
  for (int g = 0; g < kMicro; ++g) {
    for (int q = 0; q < T; ++q) {
      const int k = g * T + q;
      if (is_row && ty == q) {        // own row k is (ty = q, r = g)
#pragma unroll
        for (int c = 0; c < kMicro; ++c) {
          own_d[k * BT + tx + T * c] = d[g][c];
          own_n[k * BT + tx + T * c] = n[g][c];
        }
      }
      if (!is_row && tx == q) {       // own column k is (tx = q, c = g)
#pragma unroll
        for (int r = 0; r < kMicro; ++r) {
          own_d[k * BT + ty + T * r] = d[r][g];
          own_n[k * BT + ty + T * r] = n[r][g];
        }
      }
      __syncthreads();                // also orders the diagonal staging
#pragma unroll
      for (int r = 0; r < kMicro; ++r) {
        const int i = ty + T * r;
#pragma unroll
        for (int c = 0; c < kMicro; ++c) {
          const int j = tx + T * c;
          if (is_row) {
            if (i != k) {
              relax(d[r][c], n[r][c], diag_d[k * BT + i], diag_n[k * BT + i],
                    own_d[k * BT + j], own_n[k * BT + j]);
            }
          } else if (j != k) {
            relax(d[r][c], n[r][c], own_d[k * BT + i], own_n[k * BT + i],
                  diag_d[k * BT + j], diag_n[k * BT + j]);
          }
        }
      }
    }
  }
  store_tile(D + tile, Vt, ty, tx, d);
  store_tile(N + tile, Vt, ty, tx, n);
  copy_slab<true>(own_d, (is_row ? rs_d : cs_d) + snap + p0, Vt);
  copy_slab<true>(own_n, (is_row ? rs_n : cs_n) + snap + p0, Vt);
}

// Phase 3: outer tile (blockIdx.y, blockIdx.x) of placement blockIdx.z.
__global__ void __launch_bounds__(kThreads)
outer_kernel(float* __restrict__ D, float* __restrict__ N,
             float* __restrict__ rs_d, float* __restrict__ rs_n,
             float* __restrict__ cs_d, float* __restrict__ cs_n, int Vt,
             int k0) {
  const int i0 = blockIdx.y * BT;
  const int j0 = blockIdx.x * BT;
  if (i0 == k0 || j0 == k0) return;   // pivot rows and columns: phase 2's
  extern __shared__ float smem[];
  float* a_d = smem;                  // [k][i]: column-panel snapshot
  float* a_n = smem + BT * BT;
  float* b_d = smem + 2 * BT * BT;    // [k][j]: row-panel snapshot
  float* b_n = smem + 3 * BT * BT;
  const int ty = threadIdx.x / T;
  const int tx = threadIdx.x % T;
  const size_t b = blockIdx.z;
  const size_t snap = b * BT * static_cast<size_t>(Vt);
  copy_slab<false>(a_d, cs_d + snap + i0, Vt);
  copy_slab<false>(a_n, cs_n + snap + i0, Vt);
  copy_slab<false>(b_d, rs_d + snap + j0, Vt);
  copy_slab<false>(b_n, rs_n + snap + j0, Vt);
  const size_t tile = b * Vt * static_cast<size_t>(Vt) +
                      static_cast<size_t>(i0) * Vt + j0;
  float d[kMicro][kMicro], n[kMicro][kMicro];
  load_tile(D + tile, Vt, ty, tx, d);
  load_tile(N + tile, Vt, ty, tx, n);
  __syncthreads();

  for (int k = 0; k < BT; ++k) {
    float bd[kMicro], bn[kMicro];
#pragma unroll
    for (int c = 0; c < kMicro; ++c) {
      bd[c] = b_d[k * BT + tx + T * c];
      bn[c] = b_n[k * BT + tx + T * c];
    }
#pragma unroll
    for (int r = 0; r < kMicro; ++r) {
      const float ad = a_d[k * BT + ty + T * r];
      const float an = a_n[k * BT + ty + T * r];
#pragma unroll
      for (int c = 0; c < kMicro; ++c) relax(d[r][c], n[r][c], ad, an, bd[c], bn[c]);
    }
  }
  store_tile(D + tile, Vt, ty, tx, d);
  store_tile(N + tile, Vt, ty, tx, n);
}

int run(const float* W, float* D, float* N, float* rs_d, float* rs_n,
        float* cs_d, float* cs_n, int B, int V, int Vt, cudaStream_t stream) {
  // 4 BT x BT snapshot slabs (64 KB), over the 48 KB a launch gets unasked.
  constexpr size_t kSmem = 4 * BT * BT * sizeof(float);
  cudaError_t err;
  for (const void* fn : {reinterpret_cast<const void*>(diag_kernel),
                         reinterpret_cast<const void*>(panel_kernel),
                         reinterpret_cast<const void*>(outer_kernel)}) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t vv = static_cast<size_t>(Vt) * Vt;
  const unsigned init_blocks =
      static_cast<unsigned>((vv + 255) / 256 < 1024 ? (vv + 255) / 256 : 1024);
  init_kernel<<<dim3(init_blocks, B), 256, 0, stream>>>(W, D, N, V, Vt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = Vt / BT;
  for (int kk = 0; kk < nb; ++kk) {
    const int k0 = kk * BT;
    diag_kernel<<<B, kThreads, kSmem, stream>>>(D, N, rs_d, rs_n, cs_d, cs_n,
                                                Vt, k0);
    panel_kernel<<<dim3(nb, 2, B), kThreads, kSmem, stream>>>(
        D, N, rs_d, rs_n, cs_d, cs_n, Vt, k0);
    outer_kernel<<<dim3(nb, nb, B), kThreads, kSmem, stream>>>(
        D, N, rs_d, rs_n, cs_d, cs_n, Vt, k0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// Runs the blocked FW on `stream` (a cudaStream_t) of `device` and returns
// the first cudaGetLastError() that is not cudaSuccess, or 0.  W is a
// contiguous [B, V, V] float32 device buffer; D and N are [B, Vt, Vt] with
// Vt a multiple of 64 >= V, written in full (the real block is
// D[:, :V, :V]); rs_* and cs_* are [B, 64, Vt] scratch.
int fw_counts_tiled_f32(const float* W, float* D, float* N, float* rs_d,
                        float* rs_n, float* cs_d, float* cs_n, int B, int V,
                        int Vt, int device, void* stream) {
  if (B <= 0 || V <= 0) return 0;
  if (Vt % BT != 0 || Vt < V) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return run(W, D, N, rs_d, rs_n, cs_d, cs_n, B, V, Vt,
             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
