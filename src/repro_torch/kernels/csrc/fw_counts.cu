// Batched Floyd-Warshall with shortest-path counts, hand-written for sm_90a:
// one placement held on chip by a thread-block cluster.
//
// Replaces repro/kernels/minplus.py::fw_counts_pallas (kernel body
// _fw_counts_kernel), the PlaceIT scorer's hot spot.  For each placement b
// of W[B, V, V] (float32, zero diagonal, 1e9 = no edge) it computes the
// distances D and the shortest-path counts N, bit for bit equal to the plain
// version repro_torch/kernels/ref.py::fw_counts_ref:
//   N0 = 1 on finite off-diagonal edges, plus the identity;
//   at pivot k, row k and column k are masked out;
//   cand < D  -> D = cand, N = min(n_ik * n_kj, 1e30);
//   cand == D and cand < 1e8 -> N = min(N + min(n_ik * n_kj, 1e30), 1e30).
// Exactness: every float operation is one IEEE round-to-nearest op written
// with __fadd_rn / __fmul_rn, and the library is built with -fmad=false, so
// no multiply-add is contracted.  Cells that neither improve nor tie keep N
// unchanged, which equals the reference's N + 0.0 clipped at 1e30 because N
// is never negative and never above the clip.
//
// Bound on an H100 SXM.  One call does B * V * (V-1)^2 relaxations of 10
// float32 operations each as the reference writes them (add, mul, min, three
// compares, add, two selects, min), against 67 TFLOP/s outside the tensor
// cores (min-plus with counts has no tensor-core form), and moves 3 * B * V^2
// * 4 bytes (W read once, D and N written once) at 3.35 TB/s.  So it is
// bound by operations at the main path's shapes: about 24 us at B = 16,
// V = 216, and 0.26 ms at B = 16, V = 480.  A relaxation is at least 11
// single-issue instructions (fw_counts_tiled.cu), about 2.2x that bound.
//
// Design.  The TPU kernel keeps D and N of one placement in VMEM: 2 V^2 * 4
// bytes, 373 KB at V = 216 and 1.84 MB at V = 480, more than one SM holds.
// Hopper's counterpart is a cluster: C blocks (CTAs) on neighbouring SMs,
// each owning R = ceil(V / C) rows.  A thread (warp w, lane l) holds the
// cells (r0 + w + 16 rr, l + 32 c) of its CTA's rows in registers, at most
// 32 cells (64 registers of D and N), and relaxes them branch-free.  After
// pivot k the owner warp of row k + 1 writes it, through distributed
// shared memory (cluster.map_shared_rank), into a slot of every CTA, and
// the lane of column k + 1 writes its rows' entries into its CTA's column
// slot; one cluster barrier a pivot (barrier.cluster arrive.release /
// wait.acquire) makes them visible, and the slots alternate between two
// buffers, so pivot k + 1's writes never meet pivot k's reads.  Nothing
// else leaves the registers: W is read once and D and N written once.
// (Rows in shared memory, with every warp reading row k remotely, ran
// 1.0 ms at V = 216; PERF.md, section 6.)
//
// Cluster size.  cluster_size(V, B) below, measured at the scorer's
// B = 16: C = 1 up to V = 64, 4 up to 256, 16 up to 512.  kOnChipMaxV =
// 512 (16 columns of 32 by 2 rows of 16 a thread in 16 CTAs; 16 is
// Hopper's non-portable maximum cluster).
//
// Where it stands.  The cluster barrier and the row's trip through
// distributed shared memory cost 0.6 to 1.4 us a pivot, more as C grows,
// whatever the work: at the paper's sizes kernel 1 loses to the blocked
// kernel (0.56 against 0.36 ms at V = 216, B = 16; PERF.md, section 6),
// and the scorer's dispatch sends it only small V.
//
// Large V.  Above kOnChipMaxV the kernel keeps the L2-resident loop of the
// first port (fw_counts_l2_kernel): one block of 1024 threads a placement,
// D and N in device memory, row k and column k staged in shared memory, two
// barriers a pivot.  The path is chosen by V alone.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr float kInfCut = 1.0e8f;
constexpr float kCountClip = 1.0e30f;
constexpr int kThreads = 512;          // a CTA of the cluster kernel
constexpr int kL2Threads = 1024;       // a block of the L2 kernel
constexpr float kNoEdge = 1.0e9f;
constexpr int kOnChipMaxV = 512;       // 16 columns of 32 x 2 rows of 16
constexpr int kMaxCluster = 16;

// Columns of 32 per lane and rows of 16 per warp that the instances
// take: at most 32 cells (64 registers of D and N) a thread.
int chunks(int V) {
  const int c = (V + 31) / 32;
  return c <= 2 ? 2 : c <= 4 ? 4 : c <= 8 ? 8 : c <= 12 ? 12 : 16;
}

int row_groups(int V, int C) {
  const int r = ((V + C - 1) / C + 15) / 16;
  return r <= 1 ? 1 : r <= 2 ? 2 : r <= 4 ? 4 : r <= 8 ? 8 : 1 << 20;
}

// Whether C CTAs hold V in registers.
bool fits(int V, int C) {
  return V <= kOnChipMaxV && chunks(V) * row_groups(V, C) <= 32;
}

// The cluster size for V: the size measured fastest at the scorer's
// B = 16 on an NVIDIA H100 80GB HBM3 at 700 W (kernel_compare.py
// --clusters; ms at C = 1 / 2 / 4 / 8 / 16): V = 32: 0.0187 / 0.0345 /
// 0.0346 / 0.0372 / 0.0471; V = 64: 0.0472 / 0.0716 / 0.0663 / 0.0709 /
// 0.0907; V = 96: 0.179 / 0.158 / 0.136 / 0.134 / 0.323; V = 130 and 216
// (C >= 4 hold them): 0.338 / 0.483 / 0.644 and 0.558 / 0.800 / 1.046.
// Each barrier costs more as C grows, so the smallest C that holds V
// wins but below V = 128, where C = 4 spreads the pivots' work.  Above
// 256 only C = 16 holds V.  B is not used: the scorer's chunk is 16.
int cluster_size(int V, int B) {
  (void)B;
  const int C = V <= 64 ? 1 : V <= 256 ? 4 : 16;
  return fits(V, C) ? C : 0;
}

__global__ void __launch_bounds__(kL2Threads)
fw_counts_l2_kernel(const float* __restrict__ W, float* __restrict__ D,
                    float* __restrict__ N, int V) {
  extern __shared__ float smem[];
  float* row_d = smem;            // D[k, :]
  float* row_n = smem + V;        // N[k, :]
  float* col_d = smem + 2 * V;    // D[:, k]
  float* col_n = smem + 3 * V;    // N[:, k]

  const size_t vv = static_cast<size_t>(V) * V;
  const float* w = W + blockIdx.x * vv;
  float* d = D + blockIdx.x * vv;
  float* n = N + blockIdx.x * vv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int i = warp; i < V; i += n_warps) {
    for (int j = lane; j < V; j += 32) {
      const size_t ij = static_cast<size_t>(i) * V + j;
      const float x = w[ij];
      d[ij] = x;
      n[ij] = (i == j) ? 1.0f : (x < kInfCut ? 1.0f : 0.0f);
    }
  }
  __syncthreads();

  for (int k = 0; k < V; ++k) {
    for (int t = threadIdx.x; t < V; t += blockDim.x) {
      row_d[t] = d[static_cast<size_t>(k) * V + t];
      row_n[t] = n[static_cast<size_t>(k) * V + t];
      col_d[t] = d[static_cast<size_t>(t) * V + k];
      col_n[t] = n[static_cast<size_t>(t) * V + k];
    }
    __syncthreads();
    for (int i = warp; i < V; i += n_warps) {
      if (i == k) continue;
      const float d_ik = col_d[i];
      const float n_ik = col_n[i];
      float* d_row = d + static_cast<size_t>(i) * V;
      float* n_row = n + static_cast<size_t>(i) * V;
      for (int j = lane; j < V; j += 32) {
        if (j == k) continue;
        const float cand = __fadd_rn(d_ik, row_d[j]);
        const float d_ij = d_row[j];
        if (cand < d_ij) {
          d_row[j] = cand;
          n_row[j] = fminf(__fmul_rn(n_ik, row_n[j]), kCountClip);
        } else if (cand == d_ij && cand < kInfCut) {
          const float n_cand = fminf(__fmul_rn(n_ik, row_n[j]), kCountClip);
          n_row[j] = fminf(__fadd_rn(n_row[j], n_cand), kCountClip);
        }
      }
    }
    __syncthreads();
  }
}

// One pivot update of one cell, in the reference's order; `ok` = false
// (the pivot's row or column) leaves it as it is.  Branch-free: both
// outcomes are computed and selected (see fw_counts_tiled.cu).
__device__ __forceinline__ void relax(float& d, float& n, float a_d,
                                      float a_n, float b_d, float b_n,
                                      bool ok) {
  const float cand = __fadd_rn(a_d, b_d);
  const float n_cand = fminf(__fmul_rn(a_n, b_n), kCountClip);
  const float n_tie = fminf(__fadd_rn(n, n_cand), kCountClip);
  const bool lt = ok & (cand < d);
  const bool tie = ok & (cand == d) & (cand < kInfCut);
  n = lt ? n_cand : (tie ? n_tie : n);
  d = lt ? cand : d;
}

// x[i] for a runtime i < K, by selects (registers cannot be indexed).
template <int K>
__device__ __forceinline__ float pick(const float (&x)[K], int i) {
  float v = x[0];
#pragma unroll
  for (int q = 1; q < K; ++q) v = (q == i) ? x[q] : v;
  return v;
}

__device__ __forceinline__ void sync_placement(cg::cluster_group& cluster,
                                               int C) {
  if (C == 1) {
    __syncthreads();
  } else {
    cluster.sync();
  }
}

// One placement per cluster of C = gridDim.x / B CTAs; CTA `rank` owns rows
// r0 = rank * R .. r0 + R - 1 (fewer in the last).  Thread (warp w, lane l)
// holds the cells (r0 + w + 16 rr, l + 32 c), rr < RW, c < CC, in
// registers.  Shared memory holds row k of the placement ([2 slots][D, N]
// [32 CC]) and column k of the CTA's rows ([2 slots][D, N][16 RW]).
template <int RW, int CC>
__global__ void __launch_bounds__(kThreads, 1)
fw_counts_cluster_kernel(const float* __restrict__ W, float* __restrict__ D,
                         float* __restrict__ N, int V, int R) {
  constexpr int VC = 32 * CC;
  constexpr int RC = 16 * RW;
  __shared__ float rows[2][2][VC];
  __shared__ float cols[2][2][RC];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t b = blockIdx.x / C;
  const int r0 = rank * R;
  const int n_rows = max(0, min(R, V - r0));
  const size_t vv = static_cast<size_t>(V) * V;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float d[RW][CC], n[RW][CC];
  const float* w = W + b * vv;
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int li = warp + 16 * rr;
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      const int j = lane + 32 * c;
      if (li < n_rows && j < V) {
        const int i = r0 + li;
        const float x = w[static_cast<size_t>(i) * V + j];
        d[rr][c] = x;
        n[rr][c] = (i == j) ? 1.0f : (x < kInfCut ? 1.0f : 0.0f);
      } else {
        d[rr][c] = kNoEdge;
        n[rr][c] = 0.0f;
      }
    }
  }

  // Row k1 and column k1, as they stand, into slot s: the owner warp of
  // row k1 writes it into every CTA's slot; the lane of column k1 writes
  // its rows into this CTA's slot.
  auto publish = [&](int k1, int s) {
    const int owner = k1 / R;
    const int lr = k1 - r0;
    if (rank == owner && warp == lr % 16) {
      const int rr = lr / 16;
      float vd[CC], vn[CC];
#pragma unroll
      for (int c = 0; c < CC; ++c) {
        float xd[RW], xn[RW];
#pragma unroll
        for (int q = 0; q < RW; ++q) {
          xd[q] = d[q][c];
          xn[q] = n[q][c];
        }
        vd[c] = pick(xd, rr);
        vn[c] = pick(xn, rr);
      }
      for (int q = 0; q < C; ++q) {
        float* dst = C == 1 ? &rows[s][0][0]
                            : cluster.map_shared_rank(&rows[s][0][0], q);
#pragma unroll
        for (int c = 0; c < CC; ++c) {
          dst[lane + 32 * c] = vd[c];
          dst[VC + lane + 32 * c] = vn[c];
        }
      }
    }
    if (lane == k1 % 32) {
      const int c1 = k1 / 32;
#pragma unroll
      for (int rr = 0; rr < RW; ++rr) {
        cols[s][0][warp + 16 * rr] = pick(d[rr], c1);
        cols[s][1][warp + 16 * rr] = pick(n[rr], c1);
      }
    }
  };

  publish(0, 0);
  sync_placement(cluster, C);
  for (int k = 0; k < V; ++k) {
    const int s = k & 1;
    float bd[CC], bn[CC], ad[RW], an[RW];
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      bd[c] = rows[s][0][lane + 32 * c];
      bn[c] = rows[s][1][lane + 32 * c];
    }
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      ad[rr] = cols[s][0][warp + 16 * rr];
      an[rr] = cols[s][1][warp + 16 * rr];
    }
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const bool row_ok = r0 + warp + 16 * rr != k;
#pragma unroll
      for (int c = 0; c < CC; ++c)
        relax(d[rr][c], n[rr][c], ad[rr], an[rr], bd[c], bn[c],
              row_ok && lane + 32 * c != k);
    }
    // Slot s ^ 1 was last read at pivot k - 1, before the last barrier.
    if (k + 1 < V) publish(k + 1, s ^ 1);
    sync_placement(cluster, C);
  }

  float* dout = D + b * vv;
  float* nout = N + b * vv;
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int li = warp + 16 * rr;
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      const int j = lane + 32 * c;
      if (li < n_rows && j < V) {
        const size_t e = static_cast<size_t>(r0 + li) * V + j;
        dout[e] = d[rr][c];
        nout[e] = n[rr][c];
      }
    }
  }
}

template <int RW, int CC>
int launch_cluster(const float* W, float* D, float* N, int B, int V, int C,
                   cudaStream_t stream) {
  auto* fn = fw_counts_cluster_kernel<RW, CC>;
  const int R = (V + C - 1) / C;
  cudaError_t err;
  if (C > 8) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fn, W, D, N, V, R);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The instance for V in C CTAs: CC = columns of 32 per lane, RW = rows of
// 16 per warp, each rounded up to the sizes compiled.
template <int CC>
int launch_rows(const float* W, float* D, float* N, int B, int V, int C,
                int RW, cudaStream_t s) {
  if (RW <= 1) return launch_cluster<1, CC>(W, D, N, B, V, C, s);
  if (RW <= 2) return launch_cluster<2, CC>(W, D, N, B, V, C, s);
  if constexpr (CC <= 8) {
    if (RW <= 4) return launch_cluster<4, CC>(W, D, N, B, V, C, s);
  }
  if constexpr (CC <= 4) {
    if (RW <= 8) return launch_cluster<8, CC>(W, D, N, B, V, C, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Cluster size C (0: cluster_size(V, B)); the L2 path above kOnChipMaxV.
int run(const float* W, float* D, float* N, int B, int V, int cluster,
        int device, void* stream) {
  if (B <= 0 || V <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (V <= kOnChipMaxV) {
    const int C = cluster > 0 ? cluster : cluster_size(V, B);
    if (C > kMaxCluster || (C & (C - 1)) != 0 || !fits(V, C))
      return static_cast<int>(cudaErrorInvalidValue);
    const int RW = row_groups(V, C);
    switch (chunks(V)) {
      case 2: return launch_rows<2>(W, D, N, B, V, C, RW, s);
      case 4: return launch_rows<4>(W, D, N, B, V, C, RW, s);
      case 8: return launch_rows<8>(W, D, N, B, V, C, RW, s);
      case 12: return launch_rows<12>(W, D, N, B, V, C, RW, s);
      default: return launch_rows<16>(W, D, N, B, V, C, RW, s);
    }
  }
  if (cluster > 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 4 * static_cast<size_t>(V) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fw_counts_l2_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fw_counts_l2_kernel<<<B, kL2Threads, smem, s>>>(W, D, N, V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The cluster size the kernel takes for V at B placements (0: the
// L2-resident path, V > fw_counts_onchip_max_v()).
int fw_counts_cluster_size(int V, int B) {
  return V > kOnChipMaxV ? 0 : cluster_size(V, B);
}

int fw_counts_onchip_max_v() { return kOnChipMaxV; }

// Launches the kernel on `stream` (a cudaStream_t) of `device` and returns
// cudaGetLastError() as an int (0 on success).  W, D and N are contiguous
// [B, V, V] float32 device buffers; D and N are written in full.
int fw_counts_f32(const float* W, float* D, float* N, int B, int V,
                  int device, void* stream) {
  return run(W, D, N, B, V, 0, device, stream);
}

// For measuring and testing only: fw_counts_f32 at cluster size `cluster`,
// a power of two up to 16 whose slab holds V (the measurement behind
// cluster_size).
int fw_counts_cluster_f32(const float* W, float* D, float* N, int B, int V,
                          int cluster, int device, void* stream) {
  if (cluster <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return run(W, D, N, B, V, cluster, device, stream);
}

const char* reprotorch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
