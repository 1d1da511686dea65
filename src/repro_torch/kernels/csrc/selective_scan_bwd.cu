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
// Bound on an H100 SXM: the special-function units, as the forward's.
// Every (step, channel, state) needs e_t twice, once to recompute h and
// once on the walk back: at falcon-mamba-7b's training shape (Bt = 2,
// S = 4096, Di = 8192, N = 16) that is 2.1 G exps, about 0.51 ms at 16 a
// clock an SM and 1.98 GHz, against about 0.28 ms for the bytes (x, dt,
// dy read and dx, ddt written once; x, dy and dx in bfloat16, dt and ddt
// in float32).
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
//   then carries G per state and takes e_t again.  hb costs Bt K Di N 4
//   bytes (64 MiB at Bt = 1, S = 4096, Di = 8192, N = 16): every state
//   would cost 32 times that.
// - Sums over n (dx, ddt): the forward's transpose-reduce over a channel's
//   8 lanes, 8 steps at a time (7 shuffles a lane for 8 steps, twice).
//   Sums over d (dB, dC): a transpose-reduce over the warp's 4 channels
//   (3 shuffles a lane a step), the 16 warps then summed in order in shared
//   memory, one partial a block and (b, t, n) written to a scratch buffer
//   [Bt, ceil(Di / 64), S, 2 kMaxN] (as many bytes as a float32 [Bt, S,
//   Di / 2]); a second kernel sums the blocks' partials, and dA, dD (kept a
//   lane, a block row) over the batch, each in a fixed order.  No atomics:
//   two calls give the same bits.
// - Staging: the next chunk's x, dt, dy, B, C and boundary state are loaded
//   into registers before a chunk's walk and stored to shared memory after
//   it, so their latency hides behind the walk.  One block an SM (at most
//   128 registers a thread); at Bt = 2, Di = 8192 that is 256 blocks.
// A simple kernel first: no cp.async ring, and every lane reloads its
// operands from shared memory each step.
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
constexpr int kWarps = kThreads / 32;
constexpr int kCh = kThreads / kLanesPerCh;     // 64 channels a block
constexpr int kSteps = 32;                      // = selective_scan.cu's
constexpr int kGroup = kLanesPerCh;             // steps a transpose-reduce
constexpr int kLd = kCh + 4;                    // row of a step, floats
constexpr int kRed = 2 * kMaxN;                 // dB | dC a step
constexpr int kItems = kSteps * kCh / kThreads; // staged x a thread
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kSteps % kGroup == 0, "transpose-reduce groups a chunk");
static_assert(kSteps * kCh % kThreads == 0, "staged items a thread");
static_assert(kSteps * kMaxN == kThreads, "one B and one C a thread");
static_assert(kSteps * kRed % kThreads == 0, "block partials a thread");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Smem {
  alignas(16) float x[kSteps][kLd];
  alignas(16) float dt[kSteps][kLd];
  alignas(16) float dy[kSteps][kLd];
  alignas(16) float b[kSteps][kMaxN];
  alignas(16) float c[kSteps][kMaxN];
  alignas(16) float dx[kSteps][kLd];
  alignas(16) float ddt[kSteps][kLd];
  // Each warp's sums over its 4 channels: [warp][step][dB n | dC n].
  alignas(16) float red[kWarps][kSteps][kRed];
};

// The next chunk's operands, held in registers across a walk.
struct Staged {
  float x[kItems], dt[kItems], dy[kItems];
  float b, c;
  float h[kPerLane];
};

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

template <typename TX, typename TD>
__global__ void __launch_bounds__(kThreads, 1)
sscan_bwd_kernel(const TX* __restrict__ x, const TD* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm,
                 const float* __restrict__ Dskip,
                 const float* __restrict__ hb, const TX* __restrict__ dy,
                 const float* __restrict__ dhf, TX* __restrict__ dx,
                 float* __restrict__ ddt, float* __restrict__ dh0,
                 float* __restrict__ part_bc, float* __restrict__ part_a,
                 float* __restrict__ part_d, int S, int Di, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

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

  auto load = [&](int k, Staged& r) {
    const int t0 = k * kSteps;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int e = tid + i * kThreads;
      const int s = e / kCh, col = e % kCh;
      const bool in = t0 + s < S && c0 + col < Di;
      const size_t at = (rows + t0 + s) * Di + c0 + col;
      r.x[i] = in ? to_float(x[at]) : 0.f;
      r.dt[i] = in ? to_float(dt[at]) : 0.f;
      r.dy[i] = in ? to_float(dy[at]) : 0.f;
    }
    const int s = tid / kMaxN, n = tid % kMaxN;
    const bool in = t0 + s < S && n < N;
    r.b = in ? Bm[(rows + t0 + s) * N + n] : 0.f;
    r.c = in ? Cm[(rows + t0 + s) * N + n] : 0.f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int n2 = q + kLanesPerCh * j;
      r.h[j] = on && n2 < N
                   ? hb[((b * K + k) * Di + c) * N + n2] : 0.f;
    }
  };
  auto put = [&](const Staged& r) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int e = tid + i * kThreads;
      const int s = e / kCh, col = e % kCh;
      sm.x[s][col] = r.x[i];
      sm.dt[s][col] = r.dt[i];
      sm.dy[s][col] = r.dy[i];
    }
    sm.b[tid / kMaxN][tid % kMaxN] = r.b;
    sm.c[tid / kMaxN][tid % kMaxN] = r.c;
  };

  Staged st;
  if (K > 0) load(K - 1, st);
  for (int k = K - 1; k >= 0; --k) {
    put(st);
    float hs[kSteps + 1][kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) hs[0][j] = st.h[j];
    __syncthreads();                            // the chunk is staged
    if (k > 0) load(k - 1, st);                 // in flight over the walk

    // The chunk's states, as the forward computes them.
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const float d = sm.dt[s][cl];
      const float u = d * sm.x[s][cl];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const float e = exp2_approx(d * Al[j]);
        hs[s + 1][j] = fmaf(e, hs[s][j], u * sm.b[s][q + kLanesPerCh * j]);
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
          const float bn = sm.b[s][n], cn = sm.c[s][n];
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
    // The next put() writes only what the walk read before the barrier
    // above, and the next walk writes what this pass read only after the
    // barrier that follows that put().
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

template <typename TX, typename TD>
cudaError_t launch(const void* x, const void* dt, const float* A,
                   const float* B, const float* C, const float* D,
                   const float* hb, const void* dy, const float* dhf,
                   void* dx, float* ddt, float* dh0, float* part_bc,
                   float* part_a, float* part_d, int Bt, int S, int Di,
                   int N, cudaStream_t stream) {
  constexpr int bytes = sizeof(Smem);
  static bool sized = false;        // per instance, on the first launch
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        sscan_bwd_kernel<TX, TD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const dim3 grid((Di + kCh - 1) / kCh, Bt);
  sscan_bwd_kernel<TX, TD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const TX*>(x), static_cast<const TD*>(dt), A, B, C, D, hb,
      static_cast<const TX*>(dy), dhf, static_cast<TX*>(dx), ddt, dh0,
      part_bc, part_a, part_d, S, Di, N);
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

// Launches the backward (its kernel, then the kernel that sums the
// partials) on `stream` (a cudaStream_t) of `device` and returns
// cudaGetLastError() as an int (0 on success; cudaErrorInvalidValue for a
// dtype code it has no instance for or N outside 1..16).  Dtype codes: 0
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
