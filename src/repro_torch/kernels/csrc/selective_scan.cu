// Mamba-1 selective scan, hand-written for sm_90a.
//
// Replaces repro/kernels/selective_scan.py::selective_scan_pallas
// (selective_scan.py:50, kernel body _sscan_kernel :26).  For x, dt
// [Bt, S, Di] (float32 or bfloat16 each), A [Di, N], B, C [Bt, S, N],
// D [Di] and h0 [Bt, Di, N] (all float32, contiguous) it computes, as
// repro_torch/kernels/ref.py::selective_scan_ref states it, in float32:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
//   y_t = sum_n h_t[n] * C_t[n] + D * x_t
// and writes y [Bt, S, Di] in x's dtype and h_final [Bt, Di, N] float32.
// N <= 16 (every published Mamba-1 model has N = 16).
//
// Bound on an H100 SXM: the special-function units.  Every (step, channel,
// state) needs one exp, and the SMs' SFUs issue 16 a clock each: at
// falcon-mamba-7b's prefill (S = 2048, Di = 8192, N = 16) that is 268 M
// exps, about 0.064 ms at 1.98 GHz, against about 0.040 ms for the bytes
// (x and y in bfloat16, dt in float32, each read or written once).  Every
// (step, state) also costs the schedulers about 9.5 instructions (this
// build's SASS), an issue floor of about 0.076 ms there.
//
// Design.  Every (channel, state) recurrence is walked serially from h0,
// one float32 fmaf a step, in every call; only the work that does not
// depend on h comes off that chain.
// - Lanes: each lane owns two states (n = q and q + 8, q = lane % 8) of one
//   channel, so a warp holds 4 channels and a block of 4 warps 16: at
//   falcon-mamba's Di = 8192 and B = 1 that is 512 blocks, about 16 warps
//   an SM in one wave (4 blocks an SM: at most 128 registers a thread).
//   States past N and channels past Di hold A = 0 with B = C = 0 staged,
//   so they stay 0 and add nothing to y.
// - exp as one MUFU: A is prescaled once by log2(e), and the step's exp is
//   ex2.approx.ftz of dt * (A log2 e): one FMUL and one MUFU.EX2.
// - Steps in groups of 8, unrolled: the exps and (dt x) B of a group are
//   independent of h, the chain h = fmaf(dA, h, (dt x) B) carries only the
//   FMA, and the products h C come after.  Lane q's partial for a step is
//   fmaf(h[q + 8], C[q + 8], h[q] C[q]).
// - y by a transpose-reduce: after 8 steps each lane holds 8 steps'
//   partials; three rounds of shuffle-adds across the channel's 8 lanes
//   (xor 4, 2, 1: 4 + 2 + 1 = 7 shuffles a lane) leave in lane q the sum of
//   step q of the group, ((L0 + L4) + (L2 + L6)) + ((L1 + L5) + (L3 + L7))
//   in lanes' partials L: under one shuffle a (step, state), none on the
//   chain.  The four groups of a chunk go through the rounds together, so
//   a round's latency is paid once a chunk.  Lane q then forms
//   y = fmaf(D, x, sum) for its step.
// - Staging: x, dt, B and C come a chunk of 32 steps at a time by 16-byte
//   cp.async (plain loads where Di % 8 or N != 16 breaks the alignment)
//   into a ring of three stages, two chunks ahead of the walk.  Once a
//   chunk has landed, the block rewrites it in float32 into step-major rows
//   ([channel or state][step], padded to 36 floats so the 8 lanes of a
//   channel read 8 different bank groups): dt, dt x, B and C, so that a
//   lane's operands for 4 steps are one 16-byte LDS each.  Two barriers a
//   chunk: one before the rewrite (the chunk has landed, the walk of the
//   previous chunk is over), one before the walk.
// - y goes through shared memory and is written a chunk at a time,
//   coalesced over the block's 16 channels.  The chunk after S's end is
//   zero-filled: dt = 0 gives dA = 1 and (dt x) B = 0, so those steps
//   leave h as it is and need no test in the walk.
// What holds it near 2x the issue floor (measured on an H100, PERF.md):
// shared-memory and shuffle traffic (each lane loads dt, dt x, B and C for
// every step, 12 bytes a (step, state)); the variants tried (1 or 4 states
// a lane, chunks of 16 or 64 steps) were no faster.
// Not taken: a chunked parallel scan over S, which would carry each chunk
// in as P h + L.  Its float32 rounding would depend on where a call's
// chunks fall, so a sequence split across two calls (h_final handed on as
// h0) would no longer equal one call, as chip_smoke.py requires bit for
// bit; and Bt * Di * N = 131 072 recurrences at B = 1 already fill the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

using mma_bf16::cp_async16;
using mma_bf16::cp_async_commit;
using mma_bf16::cp_async_wait;
using mma_bf16::exp2_approx;

constexpr int kMaxN = 16;
constexpr int kLanesPerCh = 8;                  // lane q: states q, q + 8
constexpr int kPerLane = kMaxN / kLanesPerCh;   // states a lane
constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;                   // blocks an SM
constexpr int kCh = kThreads / kLanesPerCh;     // 16 channels a block
constexpr int kSteps = 32;                      // steps a chunk
constexpr int kStages = 3;                      // ring stages
constexpr int kGroup = kLanesPerCh;             // steps a transpose-reduce
constexpr int kBatch = 4;                       // groups reduced together
constexpr int kLd = kSteps + 4;                 // step-major row, floats
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kSteps % (kGroup * kBatch) == 0, "reduce batches a chunk");
static_assert(kSteps * kCh % kThreads == 0, "rewrite items a thread");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename TX, typename TD>
struct Smem {
  // The ring: chunks as they come from device memory, [stage][step][col].
  alignas(16) TX x[kStages][kSteps][kCh];
  alignas(16) TD dt[kStages][kSteps][kCh];
  alignas(16) float b[kStages][kSteps][kMaxN];
  alignas(16) float c[kStages][kSteps][kMaxN];
  // The chunk being walked, step-major in float32.
  alignas(16) float dtT[kCh][kLd];
  alignas(16) float dtxT[kCh][kLd];
  alignas(16) float bT[kMaxN][kLd];
  alignas(16) float cT[kMaxN][kLd];
  alignas(16) TX y[kSteps][kCh];
};

// Copies the kSteps rows from step t0 of `src` (rows `ld` apart, columns
// col0 .. col0 + kCols) into a ring stage, 16 bytes a cp.async when `vec`,
// else by plain loads; what lies past `limit` columns or S steps is 0.
template <typename T, int kCols>
__device__ __forceinline__ void fill_rows(T (*dst)[kCols], const T* src,
                                          int t0, int S, int col0,
                                          int ld, int limit, bool vec) {
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);
    constexpr int kVecs = kSteps * kCols / kPer;
#pragma unroll
    for (int i = 0; i < (kVecs + kThreads - 1) / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (kVecs % kThreads == 0 || e < kVecs) {
        const int r = e / (kCols / kPer), col = (e % (kCols / kPer)) * kPer;
        const int t = t0 + r;
        const bool in = t < S && col0 + col < limit;
        cp_async16(&dst[r][col],
                   in ? src + static_cast<size_t>(t) * ld + col0 + col : src,
                   in);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kSteps * kCols / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / kCols, col = e % kCols;
      const int t = t0 + r;
      const bool in = t < S && col0 + col < limit;
      dst[r][col] = in ? src[static_cast<size_t>(t) * ld + col0 + col]
                       : T(0.f);
    }
  }
}

// The transpose-reduce of kBatch groups: p[g][s] is this lane's partial of
// step s of group g; leaves in p[g][0] the sum over the channel's kGroup
// lanes of step q (the lane in the channel) of group g.  Round o
// (kGroup / 2, ..., 2, 1) adds the partials of lanes o apart: a lane keeps
// the half of its steps whose bit o matches its own and sends the other
// half to its partner.  The groups' rounds go together, so the latency of
// a round's shuffles is paid once for kBatch groups.
__device__ __forceinline__ void reduce_groups(float (&p)[kBatch][kGroup],
                                              int q) {
#pragma unroll
  for (int o = kGroup / 2; o > 0; o /= 2) {
    const bool up = q & o;
#pragma unroll
    for (int g = 0; g < kBatch; ++g) {
#pragma unroll
      for (int i = 0; i < o; ++i) {
        const float send = up ? p[g][i] : p[g][i + o];
        const float keep = up ? p[g][i + o] : p[g][i];
        p[g][i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    }
  }
}

__device__ __forceinline__ void load4(float (&d)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

template <typename TX, typename TD>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
selective_scan_kernel(const TX* __restrict__ x, const TD* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ Dskip,
                      const float* __restrict__ h0, TX* __restrict__ y,
                      float* __restrict__ hf, float* __restrict__ hb, int S,
                      int Di, int N, bool vec_x, bool vec_bc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<TX, TD>& sm = *reinterpret_cast<Smem<TX, TD>*>(smem_raw);

  const int tid = threadIdx.x;
  const int cl = tid / kLanesPerCh;             // channel in the block
  const int q = tid % kLanesPerCh;
  const int c0 = blockIdx.x * kCh;
  const int c = c0 + cl;
  const size_t b = blockIdx.y;
  const TX* xb = x + b * S * Di;
  const TD* dtb = dt + b * S * Di;
  const float* Bb = Bm + b * S * N;
  const float* Cb = Cm + b * S * N;
  TX* yb = y + b * S * Di;

  // State j of the lane is n = q + kLanesPerCh j.
  const bool on = c < Di;
  const size_t hrow = (b * Di + c) * N;
  float Al[kPerLane], h[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int n = q + kLanesPerCh * j;
    Al[j] = on && n < N ? A[static_cast<size_t>(c) * N + n] * kLog2e : 0.f;
    h[j] = on && n < N ? h0[hrow + n] : 0.f;
  }
  const float Dc = on ? Dskip[c] : 0.f;

  auto fill = [&](int st, int k) {
    const int t0 = k * kSteps;
    fill_rows<TX, kCh>(sm.x[st], xb, t0, S, c0, Di, Di, vec_x);
    fill_rows<TD, kCh>(sm.dt[st], dtb, t0, S, c0, Di, Di, vec_x);
    fill_rows<float, kMaxN>(sm.b[st], Bb, t0, S, 0, N, N, vec_bc);
    fill_rows<float, kMaxN>(sm.c[st], Cb, t0, S, 0, N, N, vec_bc);
  };
  // Chunk k's outputs, a row of the block's channels a step.
  auto write_y = [&](int k) {
    const int t0 = k * kSteps;
    if (vec_x) {
      constexpr int kPer = 16 / sizeof(TX);
      constexpr int kVecs = kSteps * kCh / kPer;
#pragma unroll
      for (int i = 0; i < (kVecs + kThreads - 1) / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int r = e / (kCh / kPer), col = (e % (kCh / kPer)) * kPer;
        if ((kVecs % kThreads == 0 || e < kVecs) && t0 + r < S &&
            c0 + col < Di)
          *reinterpret_cast<uint4*>(
              yb + static_cast<size_t>(t0 + r) * Di + c0 + col) =
              *reinterpret_cast<const uint4*>(&sm.y[r][col]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kSteps * kCh / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int r = e / kCh, col = e % kCh;
        if (t0 + r < S && c0 + col < Di)
          yb[static_cast<size_t>(t0 + r) * Di + c0 + col] = sm.y[r][col];
      }
    }
  };

  const int K = (S + kSteps - 1) / kSteps;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < K) fill(k, k);
    cp_async_commit();
  }
  for (int k = 0; k < K; ++k) {
    const int st = k % kStages;
    if (hb != nullptr && on) {                  // the state entering chunk k
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int n = q + kLanesPerCh * j;
        if (n < N) hb[((b * K + k) * Di + c) * N + n] = h[j];
      }
    }
    cp_async_wait<kStages - 2>();               // chunk k has landed
    __syncthreads();   // ...for every thread; the walk of k - 1 is over
    if (k > 0) write_y(k - 1);
    if (k + kStages - 1 < K) fill((k + kStages - 1) % kStages,
                                  k + kStages - 1);
    cp_async_commit();
    // The chunk, step-major in float32: dt, dt x, B, C.
#pragma unroll
    for (int i = 0; i < kSteps * kCh / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kCh, col = e % kCh;
      const float d = to_float(sm.dt[st][r][col]);
      sm.dtT[col][r] = d;
      sm.dtxT[col][r] = d * to_float(sm.x[st][r][col]);
    }
#pragma unroll
    for (int i = 0; i < kSteps * kMaxN / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kMaxN, n = e % kMaxN;
      sm.bT[n][r] = sm.b[st][r][n];
      sm.cT[n][r] = sm.c[st][r][n];
    }
    __syncthreads();
#pragma unroll
    for (int g0 = 0; g0 < kSteps / kGroup; g0 += kBatch) {
      float p[kBatch][kGroup];
#pragma unroll
      for (int h4 = 0; h4 < kBatch * kGroup / 4; ++h4) {
        const int r = g0 * kGroup + 4 * h4;
        float d[4], u[4], e[kPerLane][4], bu[kPerLane][4], cc[kPerLane][4];
        load4(d, &sm.dtT[cl][r]);
        load4(u, &sm.dtxT[cl][r]);
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          load4(bu[j], &sm.bT[q + kLanesPerCh * j][r]);
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            e[j][s] = exp2_approx(d[s] * Al[j]);
            bu[j][s] = u[s] * bu[j][s];
          }
        }
#pragma unroll
        for (int j = 0; j < kPerLane; ++j)
          load4(cc[j], &sm.cT[q + kLanesPerCh * j][r]);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
#pragma unroll
          for (int j = 0; j < kPerLane; ++j)
            h[j] = fmaf(e[j][s], h[j], bu[j][s]);
          float acc = h[0] * cc[0][s];
#pragma unroll
          for (int j = 1; j < kPerLane; ++j) acc = fmaf(h[j], cc[j][s], acc);
          p[4 * h4 / kGroup][(4 * h4 + s) % kGroup] = acc;
        }
      }
      reduce_groups(p, q);
#pragma unroll
      for (int g = 0; g < kBatch; ++g) {
        const int r = (g0 + g) * kGroup + q;
        store(&sm.y[r][cl], fmaf(Dc, to_float(sm.x[st][r][cl]), p[g][0]));
      }
    }
  }
  __syncthreads();
  if (K > 0) write_y(K - 1);
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int n = q + kLanesPerCh * j;
    if (on && n < N) hf[hrow + n] = h[j];
  }
}

template <typename TX, typename TD>
cudaError_t launch(const void* x, const void* dt, const float* A,
                   const float* B, const float* C, const float* D,
                   const float* h0, void* y, float* hf, float* hb, int Bt,
                   int S, int Di, int N, cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec_x = Di % 8 == 0 && aligned(x) && aligned(dt) && aligned(y);
  const bool vec_bc = N == kMaxN && aligned(B) && aligned(C);
  constexpr int bytes = sizeof(Smem<TX, TD>);
  static bool sized = false;        // per instance, on the first launch
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        selective_scan_kernel<TX, TD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const dim3 grid((Di + kCh - 1) / kCh, Bt);
  selective_scan_kernel<TX, TD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const TX*>(x), static_cast<const TD*>(dt), A, B, C, D, h0,
      static_cast<TX*>(y), hf, hb, S, Di, N, vec_x, vec_bc);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch_dt(int dt_dtype, const void* x, const void* dt,
                      const float* A, const float* B, const float* C,
                      const float* D, const float* h0, void* y, float* hf,
                      float* hb, int Bt, int S, int Di, int N,
                      cudaStream_t stream) {
  switch (dt_dtype) {
    case 0: return launch<TX, float>(x, dt, A, B, C, D, h0, y, hf, hb, Bt,
                                     S, Di, N, stream);
    case 1: return launch<TX, __nv_bfloat16>(x, dt, A, B, C, D, h0, y, hf,
                                             hb, Bt, S, Di, N, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) of `device` and returns
// cudaGetLastError() as an int (0 on success; cudaErrorInvalidValue for a
// dtype code it has no instance for or N outside 1..16).  Dtype codes:
// 0 float32, 1 bfloat16, for x (and y) and for dt.  Every buffer is
// contiguous; y and hf are written in full, and so is hb [Bt, K, Di, N]
// (K = ceil(S / 32)) unless it is null: the state entering each chunk of
// kSteps steps (hb[:, 0] = h0), which the backward (selective_scan_bwd.cu)
// recomputes each chunk's states from.  The writes leave y and hf as they
// are without them.
int selective_scan_fwd(const void* x, const void* dt, const float* A,
                       const float* B, const float* C, const float* D,
                       const float* h0, void* y, float* hf, float* hb,
                       int Bt, int S, int Di, int N, int x_dtype,
                       int dt_dtype, int device, void* stream) {
  if (N < 1 || N > kMaxN) return cudaErrorInvalidValue;
  if (Bt <= 0 || Di <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0:
      err = launch_dt<float>(dt_dtype, x, dt, A, B, C, D, h0, y, hf, hb,
                             Bt, S, Di, N, s);
      break;
    case 1:
      err = launch_dt<__nv_bfloat16>(dt_dtype, x, dt, A, B, C, D, h0, y, hf,
                                     hb, Bt, S, Di, N, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
