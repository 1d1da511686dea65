// Backward of the Mamba-1 selective scan, hand-written for sm_90a.
//
// Replaces no TPU kernel: the JAX package differentiates its plain version
// (repro/kernels/ref.py::selective_scan_ref under jax.vjp).  This is the
// gradient of the port's forward kernel (selective_scan.cu, which replaces
// repro/kernels/selective_scan.py::selective_scan_pallas), as
// repro_torch/kernels/ref.py::selective_scan_bwd_ref states it.  From x, dt
// [Bt, S, Di] (float32 or bfloat16 each), A [Di, N], B, C [Bt, S, N], D
// [Di], the forward's chunk-boundary states hb [Bt, K, Di, N] (the state
// entering each kSteps-step chunk, K = ceil(S / kSteps), hb[:, 0] = h0),
// dy [Bt, S, Di] in x's dtype and dh_final [Bt, Di, N] (or null: zeros),
// with e_t = exp(dt_t A) and G_t = dy_t C_t + e_{t+1} G_{t+1} walked from
// t = S down (e_{S+1} G_{S+1} = dh_final), in float32:
//   dC_t = sum_d h_t dy_t            dB_t = sum_d G_t dt_t x_t
//   dx_t = D dy_t + dt_t sum_n G_t B_t
//   ddt_t = sum_n G_t (A e_t h_{t-1} + x_t B_t)
//   dA = sum_{b,t} G_t dt_t e_t h_{t-1}    dD = sum_{b,t} dy_t x_t
//   dh0 = e_1 G_1
// and writes dx in x's dtype, the rest in float32.
//
// Bound on an H100 SXM (launch/kernel_timing.py sscan_bwd_work): at
// falcon-mamba-7b's training shape (Bt = 2, S = 4096, Di = 8192, N = 16)
// the function needs 24.1 G float32 operations, 0.360 ms at 67 TFLOP/s;
// its 1.07 G exps take 0.257 ms on the special-function units and its
// bytes 0.282 ms.  What holds this kernel is issue: its loop over chunks
// issues 2 375 instructions a lane a 32-step trip, 37 a (step, channel,
// state), an issue floor of 1.19 ms at that shape (the bf16-x instance's
// SASS, launch/kernel_variants.py --set sscan_bwd and kernel_compare.py
// --sass).  Of them the sums over channels are 486 (0.33 ms when taken
// out) and the walk's second exp 60 (0.01 ms: the SFUs run beside the
// other pipes).  Loading 4 or 2 steps at a time from rows of steps, or
// summing dB and dC 4 steps at a time, needs more live registers than
// the 128 leave beside the chunk's states (66): they spill and run
// slower (PERF.md).
//
// Design.
// - Lanes as the forward's: 8 lanes a channel, each with two states (n = q
//   and q + 8); a warp holds 4 channels, a block of 16 warps 64 channels of
//   one batch row.  States past N and channels past Di get A = B = C = 0
//   and dy = 0, so their G stays 0 and they add nothing.
// - Chunks of kSteps = 32 steps (the forward's, so hb holds every chunk's
//   entering state), walked from the last to the first.  A chunk's states
//   are recomputed from hb with the forward's own arithmetic (exp2 of
//   dt (A log2 e), u = dt x, h = fmaf(e, h, u B)), so they are the
//   forward's bits, and kept in registers (33 x 2 a lane); the walk back
//   then carries G per state and takes e_t again (keeping e_t too would
//   take 64 more registers a lane, or 16-step chunks and twice the
//   states).  hb costs Bt K Di N 4 bytes (64 MiB at Bt = 1, S = 4096,
//   Di = 8192, N = 16): every state would cost 32 times that.
// - Sums over n (dx, ddt): the forward's transpose-reduce over a channel's
//   8 lanes, 8 steps at a time (7 shuffles a lane for 8 steps, twice).
//   Sums over d (dB, dC): a transpose-reduce over the warp's 4 channels
//   (3 shuffles a lane a step), the 16 warps then summed in order in shared
//   memory, one partial a block and (b, t, n) written to a scratch buffer
//   [Bt, ceil(Di / 64), S, 2 kMaxN] (as many bytes as a float32 [Bt, S,
//   Di / 2]); a second kernel sums the blocks' partials, and dA, dD (kept a
//   lane, a block row) over the batch, each in a fixed order.  No atomics:
//   two calls give the same bits.
// - Staging: a ring of two stages in shared memory.  While a chunk is
//   walked, the next one (x, dt, dy, B, C and its entering state) comes by
//   the bulk-copy engine: one thread issues six tensor-map boxes that
//   complete on an mbarrier, so no warp holds the next chunk in registers
//   or waits on its loads (operands whose rows are not 16-byte aligned, or
//   N < 16, take plain loads instead; selective_scan_bwd_tensor_maps()
//   says which the last launch took).  The block rewrites the landed
//   chunk into float32 rows before its walk.  One block an SM (at most 128
//   registers a thread, no stack); at Bt = 2, Di = 8192 that is 256
//   blocks.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

using mma_bf16::exp2_approx;

constexpr int kMaxN = 16;
constexpr int kLanesPerCh = 8;                  // lane q: states q, q + 8
constexpr int kPerLane = kMaxN / kLanesPerCh;   // states a lane
constexpr int kThreads = 512;
constexpr int kMinBlocks = 1;                   // blocks an SM
constexpr int kWarps = kThreads / 32;
constexpr int kCh = kThreads / kLanesPerCh;     // 64 channels a block
constexpr int kSteps = 32;                      // = selective_scan.cu's
constexpr int kGroup = kLanesPerCh;             // steps a transpose-reduce
constexpr int kLd = kCh + 4;                    // row of a step, floats
constexpr int kRed = 2 * kMaxN;                 // dB | dC a step
constexpr int kItems = kSteps * kCh / kThreads; // staged x a thread
constexpr float kLog2e = 1.4426950408889634f;
// Polls of an mbarrier before a wait gives up and traps (a fault in the
// staging fails the launch rather than hanging the card).
constexpr uint32_t kMaxPolls = 1u << 22;

static_assert(kSteps % kGroup == 0, "transpose-reduce groups a chunk");
static_assert(kSteps * kCh % kThreads == 0, "staged items a thread");
static_assert(kSteps * kRed % kThreads == 0, "block partials a thread");

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
  // The ring: the chunk walked and the next, as they come from device
  // memory (x, dt, dy [step][channel], B, C [step][state], the entering
  // state [channel][state]).
  alignas(128) TX xr[2][kSteps][kCh];
  alignas(128) TD dtr[2][kSteps][kCh];
  alignas(128) TX dyr[2][kSteps][kCh];
  alignas(128) float b[2][kSteps][kMaxN];
  alignas(128) float c[2][kSteps][kMaxN];
  alignas(128) float h0[2][kCh][kMaxN];
  // Completion of each ring stage's bulk copies.
  alignas(8) uint64_t staged[2];
  // The walked chunk's x, dt, dy in float32.
  alignas(16) float x[kSteps][kLd];
  alignas(16) float dt[kSteps][kLd];
  alignas(16) float dy[kSteps][kLd];
  alignas(16) float dx[kSteps][kLd];
  alignas(16) float ddt[kSteps][kLd];
  // Each warp's sums over its 4 channels: [warp][step][dB n | dC n].
  alignas(16) float red[kWarps][kSteps][kRed];
};

// Copies the kSteps rows from step t0 of `src` (rows `ld` apart, columns
// col0 .. col0 + kCols) into a ring stage by plain loads; what lies past
// `limit` columns or S steps is 0.
template <typename T, int kCols>
__device__ __forceinline__ void fill_rows(T (*dst)[kCols], const T* src,
                                          int t0, int S, int col0,
                                          int ld, int limit) {
  for (int e = threadIdx.x; e < kSteps * kCols; e += kThreads) {
    const int r = e / kCols, col = e % kCols;
    const int t = t0 + r;
    const bool in = t < S && col0 + col < limit;
    dst[r][col] = in ? src[static_cast<size_t>(t) * ld + col0 + col] : T(0.f);
  }
}

// The forward's transpose-reduce (selective_scan.cu) for two quantities:
// p[g][s] is this lane's partial of step s of quantity g; leaves in p[g][0]
// the sum over the channel's kGroup lanes of step q.
__device__ __forceinline__ void reduce_groups(float (&p)[2][kGroup], int q) {
#pragma unroll
  for (int o = kGroup / 2; o > 0; o /= 2) {
    const bool up = q & o;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
#pragma unroll
      for (int i = 0; i < o; ++i) {
        const float send = up ? p[g][i] : p[g][i + o];
        const float keep = up ? p[g][i + o] : p[g][i];
        p[g][i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    }
  }
}

// v holds this lane's (dB n = q, dB n = q + 8, dC n = q, dC n = q + 8);
// leaves in v[0] the sum of v[w] over the warp's 4 channels (the lanes 8
// and 16 apart), w = lane / 8 the lane's channel in the warp.
__device__ __forceinline__ void reduce_channels(float (&v)[4], int lane) {
  const bool up16 = lane & 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = up16 ? v[i] : v[i + 2];
    const float keep = up16 ? v[i + 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
  const bool up8 = lane & 8;
  const float send = up8 ? v[0] : v[1];
  const float keep = up8 ? v[1] : v[0];
  v[0] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
}

// Tensor maps of the operands for the bulk-copy engine: x, dt, dy
// [Bt, S, Di] with boxes of kSteps x kCh, B and C [Bt, S, 16] with boxes
// of kSteps x 16, the chunk states [Bt, K, Di, 16] with boxes of kCh x 16.
// Out-of-range elements load as zeros.
struct Maps {
  CUtensorMap x, dt, dy, b, c, h;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Waits until mbarrier `bar` has completed the phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (n == kMaxPolls) __trap();
  }
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// A box of tensor map `map` at coordinates (c0, c1, c2[, c3]) into shared
// memory at dst, completing on mbarrier `bar`.
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map,
                                          int c0, int c1, int c2,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_u32(dst)), "l"(map), "r"(c0), "r"(c1), "r"(c2),
         "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map,
                                          int c0, int c1, int c2, int c3,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
         "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <typename TX, typename TD>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sscan_bwd_kernel(const TX* __restrict__ x, const TD* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm,
                 const float* __restrict__ Dskip,
                 const float* __restrict__ hb, const TX* __restrict__ dy,
                 const float* __restrict__ dhf, TX* __restrict__ dx,
                 float* __restrict__ ddt, float* __restrict__ dh0,
                 float* __restrict__ part_bc, float* __restrict__ part_a,
                 float* __restrict__ part_d, int S, int Di, int N,
                 bool tma,
                 const __grid_constant__ Maps maps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<TX, TD>& sm = *reinterpret_cast<Smem<TX, TD>*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int cl = tid / kLanesPerCh;             // channel in the block
  const int q = tid % kLanesPerCh;
  const int c0 = blockIdx.x * kCh;
  const int c = c0 + cl;
  const size_t b = blockIdx.y;
  const int K = (S + kSteps - 1) / kSteps;
  const size_t rows = b * S;                    // first (b, t) row

  const bool on = c < Di;
  float Al[kPerLane], Ar[kPerLane], g[kPerLane], dA[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int n = q + kLanesPerCh * j;
    const bool in = on && n < N;
    Ar[j] = in ? A[static_cast<size_t>(c) * N + n] : 0.f;
    Al[j] = Ar[j] * kLog2e;
    g[j] = in && dhf != nullptr ? dhf[(b * Di + c) * N + n] : 0.f;
    dA[j] = 0.f;
  }
  const float Dc = on ? Dskip[c] : 0.f;
  float dD = 0.f;

  // Chunk k (in time) into ring stage st: six boxes by the bulk-copy
  // engine, issued by one thread, or plain loads.
  auto fill = [&](int st, int k) {
    const int t0 = k * kSteps;
    if (tma) {
      if (tid == 0) {
        constexpr uint32_t kBytes = sizeof(sm.xr[0]) + sizeof(sm.dtr[0]) +
                                    sizeof(sm.dyr[0]) + sizeof(sm.b[0]) +
                                    sizeof(sm.c[0]) + sizeof(sm.h0[0]);
        const int bi = static_cast<int>(b);
        fence_proxy_async();    // the last reads of the stage are over
        mbar_expect(&sm.staged[st], kBytes);
        tma_load3(&sm.xr[st][0][0], &maps.x, c0, t0, bi, &sm.staged[st]);
        tma_load3(&sm.dtr[st][0][0], &maps.dt, c0, t0, bi, &sm.staged[st]);
        tma_load3(&sm.dyr[st][0][0], &maps.dy, c0, t0, bi, &sm.staged[st]);
        tma_load3(&sm.b[st][0][0], &maps.b, 0, t0, bi, &sm.staged[st]);
        tma_load3(&sm.c[st][0][0], &maps.c, 0, t0, bi, &sm.staged[st]);
        tma_load4(&sm.h0[st][0][0], &maps.h, 0, c0, k, bi, &sm.staged[st]);
      }
      return;
    }
    fill_rows<TX, kCh>(sm.xr[st], x + rows * Di, t0, S, c0, Di, Di);
    fill_rows<TD, kCh>(sm.dtr[st], dt + rows * Di, t0, S, c0, Di, Di);
    fill_rows<TX, kCh>(sm.dyr[st], dy + rows * Di, t0, S, c0, Di, Di);
    fill_rows<float, kMaxN>(sm.b[st], Bm + rows * N, t0, S, 0, N, N);
    fill_rows<float, kMaxN>(sm.c[st], Cm + rows * N, t0, S, 0, N, N);
    const float* hk = hb + (b * K + k) * static_cast<size_t>(Di) * N;
    for (int e = tid; e < kCh * kMaxN; e += kThreads) {
      const int ch = e / kMaxN, n = e % kMaxN;
      sm.h0[st][ch][n] = c0 + ch < Di && n < N
                             ? hk[static_cast<size_t>(c0 + ch) * N + n]
                             : 0.f;
    }
  };

  if (tid == 0) {
    mbar_init(&sm.staged[0], 1);
    mbar_init(&sm.staged[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (K > 0) fill(0, K - 1);
  for (int k = K - 1; k >= 0; --k) {
    const int it = K - 1 - k, st = it & 1;    // the walk's count, its stage
    if (tma) mbar_wait(&sm.staged[st], (it >> 1) & 1);  // chunk k landed
    __syncthreads();   // ...for every thread; the last epilogue is over
    if (k > 0) fill(st ^ 1, k - 1);             // in flight over the walk
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int e = tid + i * kThreads;
      const int s = e / kCh, col = e % kCh;
      sm.x[s][col] = to_float(sm.xr[st][s][col]);
      sm.dt[s][col] = to_float(sm.dtr[st][s][col]);
      sm.dy[s][col] = to_float(sm.dyr[st][s][col]);
    }
    float hs[kSteps + 1][kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      hs[0][j] = sm.h0[st][cl][q + kLanesPerCh * j];
    __syncthreads();                            // the chunk is in float32

    // The chunk's states, as the forward computes them.
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const float d = sm.dt[s][cl];
      const float u = d * sm.x[s][cl];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const float e = exp2_approx(d * Al[j]);
        hs[s + 1][j] =
            fmaf(e, hs[s][j], u * sm.b[st][s][q + kLanesPerCh * j]);
      }
    }

    // The walk back.
#pragma unroll
    for (int g0 = kSteps / kGroup - 1; g0 >= 0; --g0) {
      float p[2][kGroup];                       // sums over n: dx, ddt
#pragma unroll
      for (int i = kGroup - 1; i >= 0; --i) {
        const int s = g0 * kGroup + i;
        const float d = sm.dt[s][cl], xv = sm.x[s][cl], dyv = sm.dy[s][cl];
        const float u = d * xv;
        float px = 0.f, pt = 0.f, v[4];
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          const int n = q + kLanesPerCh * j;
          const float bn = sm.b[st][s][n], cn = sm.c[st][s][n];
          const float e = exp2_approx(d * Al[j]);
          const float G = fmaf(dyv, cn, g[j]);
          const float eh = e * hs[s][j];
          px = fmaf(G, bn, px);
          pt = fmaf(G, fmaf(Ar[j], eh, xv * bn), pt);
          dA[j] = fmaf(G * d, eh, dA[j]);
          v[j] = G * u;
          v[kPerLane + j] = hs[s + 1][j] * dyv;
          g[j] = e * G;
        }
        dD = fmaf(dyv, xv, dD);
        p[0][i] = px;
        p[1][i] = pt;
        reduce_channels(v, lane);
        // Lane w * 8 + q (channel w of the warp) holds dB (w < 2) or dC
        // (w >= 2) of state q + 8 (w % 2): entry lane of [dB n | dC n].
        sm.red[warp][s][lane] = v[0];
      }
      reduce_groups(p, q);
      const int s = g0 * kGroup + q;
      sm.dx[s][cl] = fmaf(Dc, sm.dy[s][cl], sm.dt[s][cl] * p[0][0]);
      sm.ddt[s][cl] = p[1][0];
    }
    __syncthreads();                            // the chunk's sums are in

    const int t0 = k * kSteps;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int e = tid + i * kThreads;
      const int s = e / kCh, col = e % kCh;
      if (t0 + s < S && c0 + col < Di) {
        const size_t at = (rows + t0 + s) * Di + c0 + col;
        store(dx + at, sm.dx[s][col]);
        ddt[at] = sm.ddt[s][col];
      }
    }
#pragma unroll
    for (int i = 0; i < kSteps * kRed / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int s = e / kRed, r = e % kRed;
      float sum = sm.red[0][s][r];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum += sm.red[w][s][r];
      if (t0 + s < S)
        part_bc[((b * gridDim.x + blockIdx.x) * S + t0 + s) * kRed + r] =
            sum;
    }
    // The next conversion writes only what the walk read before the
    // barrier above, and the next walk writes what this pass read only
    // after the barrier that follows that conversion.
  }
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int n = q + kLanesPerCh * j;
    if (on && n < N) {
      dh0[(b * Di + c) * N + n] = g[j];
      part_a[(b * Di + c) * N + n] = dA[j];
    }
  }
  if (on && q == 0) part_d[b * Di + c] = dD;
}

// Sums the blocks' dB, dC partials of each (b, t, n), and dA and dD over
// the batch, in a fixed order.
__global__ void sscan_bwd_reduce_kernel(const float* __restrict__ part_bc,
                                        const float* __restrict__ part_a,
                                        const float* __restrict__ part_d,
                                        float* __restrict__ dB,
                                        float* __restrict__ dC,
                                        float* __restrict__ dA,
                                        float* __restrict__ dD, int Bt,
                                        int S, int Di, int N, int nblk) {
  const size_t n_bc = static_cast<size_t>(Bt) * S * kRed;
  const size_t n_a = static_cast<size_t>(Di) * N;
  const size_t total = n_bc + n_a + Di;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    if (i < n_bc) {
      const int r = i % kRed;
      const size_t bt = i / kRed;               // b * S + t
      const size_t bb = bt / S, t = bt % S;
      const int n = r % kMaxN;
      if (n >= N) continue;
      float sum = 0.f;
      for (int k = 0; k < nblk; ++k)
        sum += part_bc[((bb * nblk + k) * S + t) * kRed + r];
      (r < kMaxN ? dB : dC)[bt * N + n] = sum;
    } else if (i < n_bc + n_a) {
      const size_t j = i - n_bc;
      float sum = 0.f;
      for (int bb = 0; bb < Bt; ++bb) sum += part_a[bb * n_a + j];
      dA[j] = sum;
    } else {
      const size_t j = i - n_bc - n_a;
      float sum = 0.f;
      for (int bb = 0; bb < Bt; ++bb)
        sum += part_d[static_cast<size_t>(bb) * Di + j];
      dD[j] = sum;
    }
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// Whether the last launch staged its operands by tensor maps (1) or by
// plain loads (0; -1 before the first launch).
int staged_by_maps = -1;

// cuTensorMapEncodeTiled, or null where it cannot be had.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

template <typename T>
CUtensorMapDataType map_type() {
  return sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// A tiled tensor map of the contiguous tensor at `base` with `rank` dims
// (innermost first) and boxes of `box`; false where the encoder refuses.
template <typename T>
bool tile_map(CUtensorMap* m, const void* base, int rank,
              const cuuint64_t* dims, const cuuint32_t* box) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  cuuint64_t strides[4];
  cuuint64_t stride = sizeof(T);
  for (int i = 0; i + 1 < rank; ++i) {
    stride *= dims[i];
    strides[i] = stride;
  }
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(m, map_type<T>(), rank, const_cast<void*>(base), dims, strides,
            box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Sets the instance's shared memory (once).
template <typename TX, typename TD>
cudaError_t size_kernel() {
  static cudaError_t sized = cudaErrorNotReady;
  if (sized == cudaErrorNotReady)
    sized = cudaFuncSetAttribute(
        sscan_bwd_kernel<TX, TD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(Smem<TX, TD>)));
  return sized;
}

template <typename TX, typename TD>
cudaError_t launch(const void* x, const void* dt, const float* A,
                   const float* B, const float* C, const float* D,
                   const float* hb, const void* dy, const float* dhf,
                   void* dx, float* ddt, float* dh0, float* part_bc,
                   float* part_a, float* part_d, int Bt, int S, int Di,
                   int N, cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  constexpr int bytes = sizeof(Smem<TX, TD>);
  const cudaError_t err = size_kernel<TX, TD>();
  if (err != cudaSuccess) return err;
  // The bulk-copy engine wants every row 16-byte aligned and N = 16; other
  // operands take plain loads.  Operands that qualify are staged by tensor
  // maps or not launched.
  Maps maps{};
  const bool tma = Di % 8 == 0 && N == kMaxN && S > 0 && aligned(x) &&
                   aligned(dt) && aligned(dy) && aligned(B) && aligned(C) &&
                   aligned(hb);
  if (tma) {
    const cuuint64_t Bu = Bt, Su = S, Du = Di;
    const cuuint64_t rows[3] = {Du, Su, Bu}, bc[3] = {kMaxN, Su, Bu};
    const cuuint64_t hs[4] = {kMaxN, Du, (Su + kSteps - 1) / kSteps, Bu};
    const cuuint32_t box_rows[3] = {kCh, kSteps, 1};
    const cuuint32_t box_bc[3] = {kMaxN, kSteps, 1};
    const cuuint32_t box_h[4] = {kMaxN, kCh, 1, 1};
    if (!(tile_map<TX>(&maps.x, x, 3, rows, box_rows) &&
          tile_map<TD>(&maps.dt, dt, 3, rows, box_rows) &&
          tile_map<TX>(&maps.dy, dy, 3, rows, box_rows) &&
          tile_map<float>(&maps.b, B, 3, bc, box_bc) &&
          tile_map<float>(&maps.c, C, 3, bc, box_bc) &&
          tile_map<float>(&maps.h, hb, 4, hs, box_h)))
      return cudaErrorNotSupported;
  }
  staged_by_maps = tma;
  const dim3 grid((Di + kCh - 1) / kCh, Bt);
  sscan_bwd_kernel<TX, TD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const TX*>(x), static_cast<const TD*>(dt), A, B, C, D, hb,
      static_cast<const TX*>(dy), dhf, static_cast<TX*>(dx), ddt, dh0,
      part_bc, part_a, part_d, S, Di, N, tma, maps);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch_dt(int dt_dtype, const void* x, const void* dt,
                      const float* A, const float* B, const float* C,
                      const float* D, const float* hb, const void* dy,
                      const float* dhf, void* dx, float* ddt, float* dh0,
                      float* part_bc, float* part_a, float* part_d, int Bt,
                      int S, int Di, int N, cudaStream_t stream) {
  switch (dt_dtype) {
    case 0: return launch<TX, float>(x, dt, A, B, C, D, hb, dy, dhf, dx, ddt,
                                     dh0, part_bc, part_a, part_d, Bt, S, Di,
                                     N, stream);
    case 1: return launch<TX, __nv_bfloat16>(x, dt, A, B, C, D, hb, dy, dhf,
                                             dx, ddt, dh0, part_bc, part_a,
                                             part_d, Bt, S, Di, N, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Channels a block of the backward kernel: part_bc holds
// [Bt, ceil(Di / this), S, 2 * 16] floats.
int selective_scan_bwd_block_channels() { return kCh; }

// 1 if the last launch of the backward staged its operands by tensor maps,
// 0 if by plain loads (N < 16, or rows not 16-byte aligned).
int selective_scan_bwd_tensor_maps() { return staged_by_maps; }

// Launches the backward (its kernel, then the kernel that sums the
// partials) on `stream` (a cudaStream_t) of `device` and returns
// cudaGetLastError() as an int (0 on success; cudaErrorInvalidValue for a
// dtype code it has no instance for or N outside 1..16;
// cudaErrorNotSupported where operands that qualify for tensor maps
// cannot have them).  Dtype codes: 0
// float32, 1 bfloat16, for x (and dy, dx) and for dt.  Every buffer is
// contiguous; dhf may be null (zeros).  part_bc [Bt, ceil(Di / 64), S, 32],
// part_a [Bt, Di, N] and part_d [Bt, Di] are float32 scratch; dx, ddt,
// dA, dB, dC, dD and dh0 are written in full.
int selective_scan_bwd(const void* x, const void* dt, const float* A,
                       const float* B, const float* C, const float* D,
                       const float* hb, const void* dy, const float* dhf,
                       void* dx, float* ddt, float* dA, float* dB, float* dC,
                       float* dD, float* dh0, float* part_bc, float* part_a,
                       float* part_d, int Bt, int S, int Di, int N,
                       int x_dtype, int dt_dtype, int device, void* stream) {
  if (N < 1 || N > kMaxN) return cudaErrorInvalidValue;
  if (Bt <= 0 || Di <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0:
      err = launch_dt<float>(dt_dtype, x, dt, A, B, C, D, hb, dy, dhf, dx,
                             ddt, dh0, part_bc, part_a, part_d, Bt, S, Di, N,
                             s);
      break;
    case 1:
      err = launch_dt<__nv_bfloat16>(dt_dtype, x, dt, A, B, C, D, hb, dy,
                                     dhf, dx, ddt, dh0, part_bc, part_a,
                                     part_d, Bt, S, Di, N, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nblk = (Di + kCh - 1) / kCh;
  const size_t total = static_cast<size_t>(Bt) * S * kRed +
                       static_cast<size_t>(Di) * N + Di;
  const int threads = 256;
  const int blocks = static_cast<int>(
      std::min<size_t>((total + threads - 1) / threads, 132 * 16));
  sscan_bwd_reduce_kernel<<<blocks, threads, 0, s>>>(
      part_bc, part_a, part_d, dB, dC, dA, dD, Bt, S, Di, N, nblk);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
