// Blocked Floyd-Warshall with shortest-path counts, hand-written for sm_90a:
// one persistent launch a call, phases 1 and 2 fused, lookahead.
//
// Replaces repro/kernels/minplus.py::fw_counts_tiled_pallas (minplus.py:305;
// kernel bodies _fw_diag_kernel :193, _fw_panel_kernel :222 and
// _fw_outer_kernel :276).  For W[B, V, V] (float32, zero diagonal, 1e9 = no
// edge) it computes the distances D and the shortest-path counts N, bit for
// bit equal to repro_torch/kernels/ref.py::fw_counts_ref (and to the plain
// blocked version fw_counts_tiled_ref, whose snapshot scheme it follows, and
// to fw_counts_tiled_sched_ref, the plain model of this kernel's work queue).
//
// The snapshot scheme.  V is padded to Vt, a multiple of the tile BT, with
// isolated nodes (zero diagonal, no edges), which no relaxation can use:
// every path through one costs at least 1e9, and a tie there fails the
// cand < 1e8 test.  For each pivot block m (pivots m*BT .. m*BT+BT-1), the
// diagonal tile (m, m) is relaxed over its BT pivots masking the pivot's row
// and column; a row-panel tile (m, p) takes its left operand D[i][k] from
// the diagonal tile's column k at pivot k's time and its right operand from
// its own row k (masking row k), a column-panel tile (p, m) the transpose;
// both panels record their row or column k at pivot k's time (the
// snapshots); then every outer tile (i, j), i != m != j, replays the BT
// pivots from the column-panel snapshot of row tile i and the row-panel
// snapshot of column tile j.  Every (cell, pivot) update thus sees the
// reference's operands in the reference's order.  The pivot row and column
// tiles are updated once a pivot block: N's tie accumulation is not
// idempotent.
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
// None of the ten operations fuses, and the 67 TFLOP/s count an FMA as two,
// so one relaxation is at least 11 single-issue instructions (PERF.md,
// section 6, from the SASS): about 2.2x the listed bound.
//
// Design: one persistent launch.  The grid is sized to the blocks that fit
// on the card at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and
// launched cooperatively, in one of two layouts: where a pivot block's A
// items (below) fit one to an SM, blocks of 512 threads, one an SM, so that
// an item on the critical path has an SM to itself; else blocks of 256
// threads, two an SM, so that one item's loads overlap the other's work.
// Each block takes work items in order from a queue (one atomic counter)
// until the queue is empty:
//   A(m, b, panel tile): a fused phase 1 + 2 item.  The block carries the
//     diagonal tile (m, m) of placement b in registers beside its own panel
//     tile and steps both pivot by pivot, with one barrier a pivot for both
//     (double-buffered shared-memory slots for row k and column k of the
//     diagonal; the panel's snapshot stays in shared memory and goes out
//     to device memory once, coalesced, at the end of the item).  Every
//     panel block of a pivot block recomputes the same diagonal tile;
//     the last of them in the queue (the column panel with the largest p)
//     stores it, once every A block of the pivot block has loaded it.
//     There are 2 (nb - 1) A items a placement and pivot block (one, the
//     diagonal alone, when nb = 1).  A thread holds 4 x 2 (512 threads) or
//     4 x 4 (256) cells of each tile, strided so that the owners of row k
//     and column k are known;
//   B(m, b, i, j): the outer tile (i, j) of pivot block m (phase 3).  Its
//     column-panel and row-panel snapshots (4 BT x BT floats, 64 KB) are
//     staged with 16-byte cp.async in two halves, so the second half arrives
//     while the first half's 32 pivots relax; each thread holds a 4 x 2
//     (or 4 x 4) block of the tile in registers and reads its operands as
//     float4 and float2 (float4).
// The queue order is, for m = 0 .. nb: A(m), then the rest of B(m - 1),
// then B(m)'s tiles in row or column m + 1 (lookahead: A(m + 1) needs just
// those); the rest of B(m - 1) puts its tiles in row or column m + 1 first.
// (Two other orders, each with a snapshot buffer a pivot block, were
// slower at homog256: by the pivot block that next needs a tile, 4.96 ms,
// since it defers each tile's updates into a serial chain; and with what
// A(m + 1) needs ahead of the rest of B(m - 2), 3.04 ms; PERF.md,
// section 6.)
// Items wait on counters with acquire loads and publish with release
// stores: a tile's version (the pivot blocks done on it; a panel's version
// also says that its snapshots are written), a placement's finished B
// items and its A items that have loaded the diagonal, each by pivot
// block.  B(m, i, j) waits for the two panels it reads, (i, m) and (m, j),
// and for its own tile.  Every wait is on items earlier in the queue,
// which blocks that are already running hold, so the queue cannot
// deadlock.  The snapshots have three buffers over m (A(m) waits until
// every B(m - 3) item of its placement is done).  D and N live in a padded
// scratch in device memory (L2) between items, read with ld.global.cg; a
// tile's first item reads W, its last writes the unpadded output.  The
// last block to leave zeroes the counters, so the scratch is reused by the
// next call on the stream with no host work.
// tests/test_torch_fw_schedule.py runs the same queue, waits and all, in
// plain PyTorch under adversarial block interleavings.
//
// Tile.  BT = 64, the pivot depth of the fused chain, which sets the
// critical path (nb chains of 64 barrier steps).
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kInfCut = 1.0e8f;
constexpr float kCountClip = 1.0e30f;
constexpr float kNoEdge = 1.0e9f;
constexpr int BT = 64;          // the tile: BT x BT cells per item
// The two layouts (template argument kThreads): 512 threads, one block an
// SM, where the critical path sets the pace; 256 threads, two blocks an
// SM, where the work does (threads_for picks).
// A items: thread (ty, tx), ty < 16, tx < kThreads / 16, holds the cells
// (ty + 16 r, tx + kAX c), r < 4, c < kAC, of each of its two tiles.
// B items: thread (ty, tx) holds rows 4 ty .. 4 ty + 3 and columns
// kAC tx .. kAC tx + kAC - 1 of the tile.
constexpr int kAY = 16;
constexpr int kAR = BT / kAY;
constexpr int kBR = 4;
template <int kThreads>
struct Layout {
  static constexpr int kAX = kThreads / kAY;
  static constexpr int kAC = BT / kAX;
};
// B items: 4 k-major BT x BT snapshot slabs.
constexpr int kSmemFloats = 4 * BT * BT;
constexpr size_t kSmem = kSmemFloats * sizeof(float);
// Per-placement counters, by pivot block: A items that have loaded the
// diagonal (nb), B items done (nb); then one version per tile (nb * nb).
// Counts are kept per pivot block because items of a later pivot block
// may finish (or load) before the last of an earlier one.  The snapshots
// have kBuffers buffers.
constexpr int kBuffers = 3;

// One pivot update of one cell, in the reference's order; `ok` = false
// (the pivot's row or column) leaves the cell as it is.  Branch-free: both
// outcomes are computed and selected, so the operand loads around it are
// not fenced into divergent regions (PERF.md, section 6).
__device__ __forceinline__ void relax(float& d, float& n, float a_d,
                                      float a_n, float b_d, float b_n,
                                      bool ok = true) {
  const float cand = __fadd_rn(a_d, b_d);
  const float n_cand = fminf(__fmul_rn(a_n, b_n), kCountClip);
  const float n_tie = fminf(__fadd_rn(n, n_cand), kCountClip);
  const bool lt = ok & (cand < d);
  const bool tie = ok & (cand == d) & (cand < kInfCut);
  n = lt ? n_cand : (tie ? n_tie : n);
  d = lt ? cand : d;
}

// The global nanosecond timer (for the optional trace).
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void add_release(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Thread 0 spins until *p >= target; the caller closes with a barrier.
// No wait of a correct queue lasts seconds: past 2^28 polls (over 17 s)
// the launch fails instead of hanging.
__device__ __forceinline__ void wait_geq(const int* p, int target) {
  if (threadIdx.x == 0) {
    unsigned polls = 0;
    while (ld_acquire(p) < target) {
      __nanosleep(64);
      if (++polls == (1u << 28)) __trap();
    }
  }
}

__device__ __forceinline__ void cp_async16(float* smem, const float* g) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(g) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// d and n of cell (i, j) before any pivot: W padded with isolated nodes;
// N0 = 1 on finite off-diagonal edges plus the identity.
__device__ __forceinline__ void init_cell(const float* w, int V, int i, int j,
                                          float& d, float& n) {
  if (i < V && j < V) {
    d = w[static_cast<size_t>(i) * V + j];
  } else {
    d = (i == j) ? 0.0f : kNoEdge;
  }
  n = (i == j) ? 1.0f : (d < kInfCut ? 1.0f : 0.0f);
}

// W floats from 16- or 8-byte aligned memory: shared (load_vec), or
// device memory through L2 only (load_cg, store_cg).
template <int W>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[W]) {
  if constexpr (W == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  }
}

template <int W>
__device__ __forceinline__ void load_cg(const float* p, float (&v)[W]) {
  if constexpr (W == 4) {
    const float4 x = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    const float2 x = __ldcg(reinterpret_cast<const float2*>(p));
    v[0] = x.x; v[1] = x.y;
  }
}

template <int W>
__device__ __forceinline__ void store_cg(float* p, const float (&v)[W]) {
  if constexpr (W == 4) {
    __stcg(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    __stcg(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  }
}

// The shapes of one call.
struct Shape {
  const float* W;  // [B, V, V]
  float* D_out;    // [B, V, V]
  float* N_out;
  float* D;        // [B, Vt, Vt] scratch
  float* N;
  float* snap;     // [kBuffers][4: rs_d, rs_n, cs_d, cs_n][B][BT][Vt]
  int* cnt;        // [B][2 nb + nb * nb], then head, exits
  int B, V, Vt, nb, nA, n_out, total;
  // Null, or (fw_counts_tiled_traced_f32) per item e, [e][kTraceCols]:
  // dequeued, waits met, done (global ns), block, then the item as
  // decoded: kind, m, b, i, j, keeps_diag.
  long long* trace;
};

constexpr int kTraceCols = 10;

__device__ __forceinline__ float* snap_at(const Shape& s, int buf, int arr,
                                          int b) {
  return s.snap + ((static_cast<size_t>(buf) * 4 + arr) * s.B + b) * BT *
                      static_cast<size_t>(s.Vt);
}

__device__ __forceinline__ int per_placement(int nb) {
  return 2 * nb + nb * nb;
}

__device__ __forceinline__ int* counters(const Shape& s, int b) {
  return s.cnt + static_cast<size_t>(b) * per_placement(s.nb);
}

__device__ __forceinline__ int* a_loaded(const Shape& s, int b, int m) {
  return counters(s, b) + m;
}

__device__ __forceinline__ int* b_done(const Shape& s, int b, int m) {
  return counters(s, b) + s.nb + m;
}


__device__ __forceinline__ int* version(const Shape& s, int b, int i, int j) {
  return counters(s, b) + 2 * s.nb + i * s.nb + j;
}

// x-th element of [0, nb) without the n values from a up.
__device__ __forceinline__ int skip(int x, int a, int n) {
  return x < a ? x : x + n;
}

struct Item {
  int e;     // the item's place in the queue
  int kind;  // 0: A (fused diagonal + panel), 1: B (outer tile)
  int m, b;
  int i, j;  // A: the panel tile (i == m: row panel; j == m: column
             // panel; i == j == m: the diagonal alone, nb = 1)
  bool keeps_diag;  // A: the item stores the diagonal tile
};

// Tile t (< 2 nb - 3) of B(m) in row or column m + 1.
__device__ __forceinline__ void lookahead_tile(int nb, int m, int t, int& i,
                                               int& j) {
  if (t < nb - 1) {
    i = m + 1;
    j = skip(t, m, 1);
  } else {
    i = skip(t - (nb - 1), m, 2);
    j = m + 1;
  }
}

// Tile t of the rest of B(m) (not in row or column m + 1), those in row or
// column m + 2 first.
__device__ __forceinline__ void rest_tile(int nb, int m, int t, int& i,
                                          int& j) {
  if (m + 1 >= nb) {  // no lookahead row: every tile but row/column m
    const int u = nb - 1;
    i = skip(t / u, m, 1);
    j = skip(t % u, m, 1);
    return;
  }
  const int u = nb - 2;  // rows and columns other than m, m + 1
  if (m + 2 >= nb) {
    i = skip(t / u, m, 2);
    j = skip(t % u, m, 2);
    return;
  }
  const int q = m + 2;
  if (t < u) {
    i = q;
    j = skip(t, m, 2);
  } else if (t < 2 * u - 1) {
    i = skip(t - u, m, 3);
    j = q;
  } else {
    const int x = t - (2 * u - 1);
    i = skip(x / (u - 1), m, 3);
    j = skip(x % (u - 1), m, 3);
  }
}

__device__ __forceinline__ int n_lookahead(int nb, int m) {
  return m + 1 < nb ? 2 * nb - 3 : 0;
}

__device__ __forceinline__ void a_item(const Shape& s, int m, int e,
                                       Item& it) {
  const int nb = s.nb;
  it.kind = 0;
  it.m = m;
  it.b = e % s.B;
  const int t = e / s.B;
  if (nb == 1) {
    it.i = it.j = 0;
  } else if (t < nb - 1) {
    it.i = m;
    it.j = skip(t, m, 1);
  } else {
    it.i = skip(t - (nb - 1), m, 1);
    it.j = m;
  }
  // The last A item of the placement in the queue (the column panel with
  // the largest p) stores the diagonal: the others are dequeued before it.
  it.keeps_diag = nb == 1 || (it.j == m && it.i == (m == nb - 1 ? nb - 2
                                                                : nb - 1));
}

// The queue: for m = 0 .. nb, A(m) (m < nb), the rest of B(m - 1) (m >= 1),
// B(m)'s lookahead tiles (m + 1 < nb); within a segment, item e is
// placement e % B of tile e / B.  Returns false past the end.
__device__ bool decode(const Shape& s, int e, Item& it) {
  const int B = s.B, nb = s.nb;
  for (int m = 0; m <= nb; ++m) {
    if (m < nb) {
      const int n = B * s.nA;
      if (e < n) {
        a_item(s, m, e, it);
        return true;
      }
      e -= n;
    }
    if (m >= 1) {
      const int n = B * (s.n_out - n_lookahead(nb, m - 1));
      if (e < n) {
        it.kind = 1;
        it.keeps_diag = false;
        it.m = m - 1;
        it.b = e % B;
        rest_tile(nb, m - 1, e / B, it.i, it.j);
        return true;
      }
      e -= n;
    }
    if (m + 1 < nb) {
      const int n = B * n_lookahead(nb, m);
      if (e < n) {
        it.kind = 1;
        it.keeps_diag = false;
        it.m = m;
        it.b = e % B;
        lookahead_tile(nb, m, e / B, it.i, it.j);
        return true;
      }
      e -= n;
    }
  }
  return false;
}

// The thread's cells of a tile in an A item: (ty + 16 r, tx + 32 c), so
// that the owners of row k (ty == k % 16, r = k / 16) and column k
// (tx == k % 32, c = k / 32) are known.
template <int kAX, int kAC>
__device__ void load_strided(const Shape& s, int b, int m, int ti, int tj,
                             int ty, int tx, float (&d)[kAR][kAC],
                             float (&n)[kAR][kAC]) {
  const int i0 = ti * BT, j0 = tj * BT;
  if (m == 0) {
    const float* w = s.W + static_cast<size_t>(b) * s.V * s.V;
#pragma unroll
    for (int r = 0; r < kAR; ++r)
#pragma unroll
      for (int c = 0; c < kAC; ++c)
        init_cell(w, s.V, i0 + ty + kAY * r, j0 + tx + kAX * c, d[r][c],
                  n[r][c]);
    return;
  }
  const size_t base = static_cast<size_t>(b) * s.Vt * s.Vt +
                      static_cast<size_t>(i0) * s.Vt + j0;
#pragma unroll
  for (int r = 0; r < kAR; ++r)
#pragma unroll
    for (int c = 0; c < kAC; ++c) {
      const size_t e = base + static_cast<size_t>(ty + kAY * r) * s.Vt + tx +
                       kAX * c;
      d[r][c] = __ldcg(s.D + e);
      n[r][c] = __ldcg(s.N + e);
    }
}

// Stores a tile: to the scratch, or to the output after the last pivot
// block.
__device__ __forceinline__ void store_cell(const Shape& s, int b, bool last,
                                           int i, int j, float d, float n) {
  if (last) {
    if (i < s.V && j < s.V) {
      const size_t e = (static_cast<size_t>(b) * s.V + i) * s.V + j;
      s.D_out[e] = d;
      s.N_out[e] = n;
    }
  } else {
    const size_t e = (static_cast<size_t>(b) * s.Vt + i) * s.Vt + j;
    __stcg(s.D + e, d);
    __stcg(s.N + e, n);
  }
}

template <int kAX, int kAC>
__device__ void store_strided(const Shape& s, int b, bool last, int ti,
                              int tj, int ty, int tx,
                              const float (&d)[kAR][kAC],
                              const float (&n)[kAR][kAC]) {
#pragma unroll
  for (int r = 0; r < kAR; ++r)
#pragma unroll
    for (int c = 0; c < kAC; ++c)
      store_cell(s, b, last, ti * BT + ty + kAY * r, tj * BT + tx + kAX * c,
                 d[r][c], n[r][c]);
}

// Fused phase 1 + 2: the diagonal tile (m, m) and the panel tile (i, j) of
// placement b, stepped pivot by pivot with one barrier a pivot.
template <int kThreads>
__device__ void run_a(const Shape& s, const Item& it, float* smem) {
  constexpr int kAX = Layout<kThreads>::kAX;
  constexpr int kAC = Layout<kThreads>::kAC;
  const int ty = threadIdx.x / kAX;
  const int tx = threadIdx.x % kAX;
  const int m = it.m, b = it.b;
  const bool panel = s.nb > 1;
  const bool is_row = it.i == m;      // row panel (m, p); else column (p, m)
  const int p = is_row ? it.j : it.i;
  const bool keeps_diag = it.keeps_diag;
  const bool last = m == s.nb - 1;

  // The diagonal and the panel tile have seen pivot blocks 0 .. m - 1; the
  // snapshot buffer m % 3 is free once B(m - 3) is done.
  if (m >= kBuffers) wait_geq(b_done(s, b, m - kBuffers), s.n_out);
  wait_geq(version(s, b, m, m), m);
  if (panel) wait_geq(version(s, b, it.i, it.j), m);
  __syncthreads();
  if (s.trace && threadIdx.x == 0)
    s.trace[static_cast<size_t>(kTraceCols) * it.e + 1] = global_ns();

  float dd[kAR][kAC], dn[kAR][kAC];
  float pd[kAR][kAC], pn[kAR][kAC];
  load_strided<kAX>(s, b, m, m, m, ty, tx, dd, dn);
  if (panel) load_strided<kAX>(s, b, m, it.i, it.j, ty, tx, pd, pn);
  __syncthreads();
  if (threadIdx.x == 0) add_release(a_loaded(s, b, m), 1);

  // Shared memory: slots [2][4][BT] for row k and column k of the
  // diagonal (D and N), double-buffered over k; the own tile's snapshot,
  // k-major [BT][BT] for D and for N (row k of a row panel, column k of a
  // column panel, at pivot k's time), copied out to device memory at the
  // end.
  float* own_snap_d = smem + BT * BT;
  float* own_snap_n = smem + 2 * BT * BT;
  // Pivot k = 16 g + q: row k is (ty == q, r == g), column k is
  // (tx == cq, c == cg) with cg = 16 g / kAX, cq = 16 g % kAX + q.
#pragma unroll
  for (int g = 0; g < kAR; ++g) {
    const int cg = kAY * g / kAX;
    for (int q = 0; q < kAY; ++q) {
      const int k = g * kAY + q;
      const int cq = kAY * g % kAX + q;
      float* sl = smem + (k & 1) * 4 * BT;
      float* drow_d = sl;
      float* drow_n = sl + BT;
      float* dcol_d = sl + 2 * BT;
      float* dcol_n = sl + 3 * BT;
      float* own_d = own_snap_d + k * BT;
      float* own_n = own_snap_n + k * BT;
      if (ty == q) {
#pragma unroll
        for (int c = 0; c < kAC; ++c) {
          drow_d[tx + kAX * c] = dd[g][c];
          drow_n[tx + kAX * c] = dn[g][c];
        }
      }
      if (tx == cq) {
#pragma unroll
        for (int r = 0; r < kAR; ++r) {
          dcol_d[ty + kAY * r] = dd[r][cg];
          dcol_n[ty + kAY * r] = dn[r][cg];
        }
      }
      if (panel && is_row && ty == q) {
#pragma unroll
        for (int c = 0; c < kAC; ++c) {
          own_d[tx + kAX * c] = pd[g][c];
          own_n[tx + kAX * c] = pn[g][c];
        }
      }
      if (panel && !is_row && tx == cq) {
#pragma unroll
        for (int r = 0; r < kAR; ++r) {
          own_d[ty + kAY * r] = pd[r][cg];
          own_n[ty + kAY * r] = pn[r][cg];
        }
      }
      __syncthreads();
      // Row k and column k of a tile are masked at pivot k.
      float ad[kAR], an[kAR], bd[kAC], bn[kAC];
#pragma unroll
      for (int r = 0; r < kAR; ++r) {
        ad[r] = dcol_d[ty + kAY * r];
        an[r] = dcol_n[ty + kAY * r];
      }
#pragma unroll
      for (int c = 0; c < kAC; ++c) {
        bd[c] = drow_d[tx + kAX * c];
        bn[c] = drow_n[tx + kAX * c];
      }
#pragma unroll
      for (int r = 0; r < kAR; ++r)
#pragma unroll
        for (int c = 0; c < kAC; ++c)
          relax(dd[r][c], dn[r][c], ad[r], an[r], bd[c], bn[c],
                (r != g || ty != q) && (c != cg || tx != cq));
      if (panel && is_row) {
        // Left operand: the diagonal's column k; right: own row k.
#pragma unroll
        for (int c = 0; c < kAC; ++c) {
          const float od = own_d[tx + kAX * c];
          const float on = own_n[tx + kAX * c];
#pragma unroll
          for (int r = 0; r < kAR; ++r)
            relax(pd[r][c], pn[r][c], ad[r], an[r], od, on,
                  r != g || ty != q);
        }
      } else if (panel) {
        // Left operand: own column k; right: the diagonal's row k.
#pragma unroll
        for (int r = 0; r < kAR; ++r) {
          const float od = own_d[ty + kAY * r];
          const float on = own_n[ty + kAY * r];
#pragma unroll
          for (int c = 0; c < kAC; ++c)
            relax(pd[r][c], pn[r][c], od, on, bd[c], bn[c],
                  c != cg || tx != cq);
        }
      }
    }
  }
  if (panel) {
    store_strided<kAX>(s, b, last, it.i, it.j, ty, tx, pd, pn);
    // The snapshot into buffer m % 3, row-panel or column-panel slab.
    const int buf = m % kBuffers;
    float* dst_d = snap_at(s, buf, is_row ? 0 : 2, b) + p * BT;
    float* dst_n = snap_at(s, buf, is_row ? 1 : 3, b) + p * BT;
    const size_t Vt = s.Vt;
    for (int e = threadIdx.x; e < BT * BT / 4; e += kThreads) {
      const int k = e / (BT / 4);
      const int x = 4 * (e % (BT / 4));
      __stcg(reinterpret_cast<float4*>(dst_d + k * Vt + x),
             *reinterpret_cast<const float4*>(own_snap_d + k * BT + x));
      __stcg(reinterpret_cast<float4*>(dst_n + k * Vt + x),
             *reinterpret_cast<const float4*>(own_snap_n + k * BT + x));
    }
  }
  if (keeps_diag) {
    // Every A item of this pivot block must have loaded the diagonal
    // before it changes.
    wait_geq(a_loaded(s, b, m), s.nA);
    __syncthreads();
    store_strided<kAX>(s, b, last, m, m, ty, tx, dd, dn);
  }
  __syncthreads();
  // The panel's version also says that its snapshots are written.
  if (threadIdx.x == 0) {
    __threadfence();
    if (panel) st_release(version(s, b, it.i, it.j), m + 1);
    if (keeps_diag) st_release(version(s, b, m, m), m + 1);
    if (s.trace)
      s.trace[static_cast<size_t>(kTraceCols) * it.e + 2] = global_ns();
  }
}

// Phase 3: the outer tile (i, j) of placement b over pivot block m.  Each
// thread holds rows 4 ty .. 4 ty + 3 and columns kBC tx .. kBC tx + kBC - 1.
template <int kThreads>
__device__ void run_b(const Shape& s, const Item& it, float* smem) {
  constexpr int kAX = Layout<kThreads>::kAX;
  constexpr int kBC = Layout<kThreads>::kAC;
  const int ty = threadIdx.x / kAX;
  const int tx = threadIdx.x % kAX;
  const int m = it.m, b = it.b;
  const bool last = m == s.nb - 1;
  // The column panel (i, m) and the row panel (m, j) have written their
  // snapshots; the tile has seen pivot blocks 0 .. m - 1.
  wait_geq(version(s, b, it.i, m), m + 1);
  wait_geq(version(s, b, m, it.j), m + 1);
  wait_geq(version(s, b, it.i, it.j), m);
  __syncthreads();
  if (s.trace && threadIdx.x == 0)
    s.trace[static_cast<size_t>(kTraceCols) * it.e + 1] = global_ns();

  // Snapshots, k-major [BT][BT]: column-panel (left operand, rows of tile
  // i) and row-panel (right operand, columns of tile j), in two halves
  // over k.
  float* a_d = smem;
  float* a_n = smem + BT * BT;
  float* b_d = smem + 2 * BT * BT;
  float* b_n = smem + 3 * BT * BT;
  const int buf = m % kBuffers;
  const float* src[4] = {snap_at(s, buf, 2, b) + it.i * BT,
                         snap_at(s, buf, 3, b) + it.i * BT,
                         snap_at(s, buf, 0, b) + it.j * BT,
                         snap_at(s, buf, 1, b) + it.j * BT};
  float* dst[4] = {a_d, a_n, b_d, b_n};
  const size_t Vt = s.Vt;
  // 16-byte chunks a thread and array in each half.
  constexpr int kChunks = BT * BT / 4 / 2 / kThreads;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int h = 0; h < kChunks; ++h) {
      const int e = threadIdx.x + kThreads * (kChunks * half + h);
      const int k = e / (BT / 4);
      const int x = 4 * (e % (BT / 4));
#pragma unroll
      for (int a = 0; a < 4; ++a) cp_async16(dst[a] + k * BT + x,
                                             src[a] + k * Vt + x);
    }
    cp_async_commit();
  }

  float d[kBR][kBC], n[kBR][kBC];
  const int i0 = it.i * BT + kBR * ty;
  const int j0 = it.j * BT + kBC * tx;
  if (m == 0) {
    const float* w = s.W + static_cast<size_t>(b) * s.V * s.V;
#pragma unroll
    for (int r = 0; r < kBR; ++r)
#pragma unroll
      for (int c = 0; c < kBC; ++c)
        init_cell(w, s.V, i0 + r, j0 + c, d[r][c], n[r][c]);
  } else {
#pragma unroll
    for (int r = 0; r < kBR; ++r) {
      const size_t e = (static_cast<size_t>(b) * Vt + i0 + r) * Vt + j0;
      load_cg(s.D + e, d[r]);
      load_cg(s.N + e, n[r]);
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (half == 0) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll 4
    for (int k = half * (BT / 2); k < (half + 1) * (BT / 2); ++k) {
      float ad[kBR], an[kBR], bd[kBC], bn[kBC];
      load_vec(a_d + k * BT + kBR * ty, ad);
      load_vec(a_n + k * BT + kBR * ty, an);
      load_vec(b_d + k * BT + kBC * tx, bd);
      load_vec(b_n + k * BT + kBC * tx, bn);
#pragma unroll
      for (int r = 0; r < kBR; ++r)
#pragma unroll
        for (int c = 0; c < kBC; ++c)
          relax(d[r][c], n[r][c], ad[r], an[r], bd[c], bn[c]);
    }
  }

  if (last) {
#pragma unroll
    for (int r = 0; r < kBR; ++r)
#pragma unroll
      for (int c = 0; c < kBC; ++c)
        store_cell(s, b, true, i0 + r, j0 + c, d[r][c], n[r][c]);
  } else {
#pragma unroll
    for (int r = 0; r < kBR; ++r) {
      const size_t e = (static_cast<size_t>(b) * Vt + i0 + r) * Vt + j0;
      store_cg(s.D + e, d[r]);
      store_cg(s.N + e, n[r]);
    }
  }
  __syncthreads();  // also: the staging is free for the next item
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(version(s, b, it.i, it.j), m + 1);
    add_release(b_done(s, b, m), 1);
    if (s.trace)
      s.trace[static_cast<size_t>(kTraceCols) * it.e + 2] = global_ns();
  }
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads, 512 / kThreads)
fw_tiled_kernel(Shape s) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_item;
  __shared__ int s_last;
  int* head = s.cnt + static_cast<size_t>(s.B) * per_placement(s.nb);
  for (;;) {
    if (threadIdx.x == 0) s_item = atomicAdd(head, 1);
    __syncthreads();
    const int e = s_item;
    __syncthreads();
    Item it;
    if (e >= s.total || !decode(s, e, it)) break;
    it.e = e;
    if (s.trace && threadIdx.x == 0) {
      long long* t = s.trace + static_cast<size_t>(kTraceCols) * e;
      t[0] = global_ns();
      t[3] = blockIdx.x;
      t[4] = it.kind;
      t[5] = it.m;
      t[6] = it.b;
      t[7] = it.i;
      t[8] = it.j;
      t[9] = it.keeps_diag;
    }
    if (it.kind == 0) {
      run_a<kThreads>(s, it, smem);
    } else {
      run_b<kThreads>(s, it, smem);
    }
  }
  // The last block out zeroes the counters for the next call.
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(head + 1, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (s_last) {
    __threadfence();
    const int n = s.B * per_placement(s.nb) + 2;
    for (int e = threadIdx.x; e < n; e += kThreads) s.cnt[e] = 0;
  }
}

// One cooperative launch of the kThreads layout, its grid the blocks that
// fit on the card at once (or the items, if fewer).
template <int kThreads>
int launch(Shape& s, int sms, cudaStream_t stream) {
  auto* fn = fw_tiled_kernel<kThreads>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = per_sm * sms < s.total ? per_sm * sms : s.total;
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  void* args[] = {&s};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fn), dim3(grid),
                                    dim3(kThreads), args, kSmem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The layout for B placements of nb tile rows on `sms` SMs.  A pivot
// block's A items one to an SM: the chain of fused items sets the pace, so
// each gets a whole SM (512 threads); more: the work does, and two blocks
// an SM (256 threads) overlap one item's loads with the other's
// relaxations (PERF.md, section 6).
int threads_for(int B, int nb, int sms) {
  const int nA = nb == 1 ? 1 : 2 * (nb - 1);
  return B * nA <= sms ? 512 : 256;
}

// Checks the shapes, fills the Shape and launches the layout for it.
int run(const float* W, float* D_out, float* N_out, float* D_scr,
        float* N_scr, float* snap, int* cnt, long long* trace, int B, int V,
        int Vt, int device, void* stream) {
  if (B <= 0 || V <= 0) return 0;
  if (Vt % BT != 0 || Vt < V) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Shape s;
  s.W = W;
  s.D_out = D_out;
  s.N_out = N_out;
  s.D = D_scr;
  s.N = N_scr;
  s.snap = snap;
  s.cnt = cnt;
  s.trace = trace;
  s.B = B;
  s.V = V;
  s.Vt = Vt;
  s.nb = Vt / BT;
  s.nA = s.nb == 1 ? 1 : 2 * (s.nb - 1);
  s.n_out = (s.nb - 1) * (s.nb - 1);
  s.total = B * s.nb * (s.nA + s.n_out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (threads_for(B, s.nb, sms) == 512) return launch<512>(s, sms, st);
  return launch<256>(s, sms, st);
}

}  // namespace

extern "C" {

// Runs the blocked FW on `stream` (a cudaStream_t) of `device` in one
// cooperative launch and returns its cudaError_t as an int (0 on success).
// W is a contiguous [B, V, V] float32 device buffer; D_out and N_out
// [B, V, V] are written in full.  Scratch, reusable across calls on one
// stream: D_scr and N_scr [B, Vt, Vt] float32 with Vt a multiple of 64
// >= V, snap [3, 4, B, 64, Vt] float32, and cnt, B * (2 nb + nb^2) + 2
// int32 (nb = Vt / 64) that are zero before the first call (each call
// leaves them zero).
int fw_counts_tiled_f32(const float* W, float* D_out, float* N_out,
                        float* D_scr, float* N_scr, float* snap, int* cnt,
                        int B, int V, int Vt, int device, void* stream) {
  return run(W, D_out, N_out, D_scr, N_scr, snap, cnt, nullptr, B, V, Vt,
             device, stream);
}

// The threads a block of fw_counts_tiled_f32's launch for B placements
// of V nodes on `device` (512 or 256; 0 if the device cannot be read).
int fw_counts_tiled_threads(int B, int V, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    return 0;
  return threads_for(B, (V + BT - 1) / BT, sms);
}

// For measuring and testing only: fw_counts_tiled_f32 that also writes,
// for each work item e, trace[e][0 .. 9] (int64): dequeued, waits met and
// done (global ns), the block, and the item as the kernel decoded it
// (kind 0 = A or 1 = B, m, b, i, j, whether it stores the diagonal).
// trace holds B * nb * (nA + (nb - 1)^2) rows, nA = 1 if nb == 1 else
// 2 (nb - 1).
int fw_counts_tiled_traced_f32(const float* W, float* D_out, float* N_out,
                               float* D_scr, float* N_scr, float* snap,
                               int* cnt, long long* trace, int B, int V,
                               int Vt, int device, void* stream) {
  if (trace == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return run(W, D_out, N_out, D_scr, N_scr, snap, cnt, trace, B, V, Vt,
             device, stream);
}

}  // extern "C"
