"""Build variants of the scan, min-plus and backward kernels and time them
against each other on one card, in one process.

    python3 src/repro_torch/launch/kernel_variants.py --set geometry \\
        [--set diagnostics] [--set minplus] [--set bwd] [--set sscan_bwd] \\
        [--out FILE]

A variant is a copy of a kernel source from ``src/repro_torch/kernels/csrc``
with some ``constexpr`` constants set to other values and, for the
diagnostics, some lines of code replaced (each replacement must match the
source once, so a stale variant fails to build rather than timing
something else).  Each is compiled by its own ``nvcc`` (the flags of
``kernels/build.py``, all started together) into a library of its own,
bound with the C signature of ``build.SIGNATURES``, and timed with
``kernel_timing.batched_ms`` (all variants of a kernel taking turns) at
the serve runs' prefill shapes: falcon-mamba-7b's selective scan (B = 1,
Di = 8192, N = 16, x in bfloat16, dt in float32) and recurrentgemma-9b's
RG-LRU (B = 1, D = 4096, bfloat16), S = 2048 and 512, operands from
``kernel_timing.scan_serve_operands`` as ``chip_smoke.py`` draws them.
Each output is checked against the plain version (``FULL_LIMIT`` on
outputs, 3e-5 on final states); the diagnostics take work out of the
kernel and are expected to fail it.  Min-plus variants are timed at
1536^3 (a homog256 placeit score graph, APSP's shape) and at 702^3 (hex127
baseline, ragged against every tile, so every slab takes the guarded
copies), and held bit for bit (NaN-aware) against ``ref.minplus_ref``.
Backward variants are timed at ``kernel_timing.BWD_TIMED`` (bfloat16,
causal, S = 2048: smollm-360m's heads at B = 8, qwen3-1.7b's at B = 1,
operands from ``kernel_compare.bwd_operands``) and held to ``BWD_LIMIT``
against ``ref.attention_bwd_ref``; ptxas's registers and spills of each
variant's tensor-core instances are kept in the output.  Selective-scan
backward variants are timed at ``kernel_timing.SCAN_TRAIN`` (falcon-mamba-
7b's training shape, operands from ``scan_train_operands``, the chunk
states from this checkout's forward kernel) and held to
``testing.SCAN_BWD_LIMITS["training"]`` against ``ref.
selective_scan_bwd_ref``, each gradient's share of the limit, ptxas's
registers, spills and stack and the instructions of one trip of its loop
over chunks (``kernel_timing.sscan_bwd_issues``) kept in the output.  A
variant that does not build is reported and left out of the timing.

Sets:

* ``geometry``: the kernels as built, and other lane layouts, block
  sizes, chunk lengths, ring depths and producer counts;
* ``diagnostics``: the kernels as built with one piece of work taken out
  (the exp, the transpose-reduce, the B / C or dt loads, the rewrite;
  RG-LRU's square root, its output writes, its walk), to see what each
  piece costs;
* ``minplus``: the min-plus kernel as built, other tile sizes, micro-tiles,
  k-groups, K-steps, stages and update order, and diagnostics: plain
  ``min`` for ``min.NaN``, the min replaced by an add (two FADD an update,
  the FMA pipe) or the add by a min (two FMNMX an update: FMNMX's own
  rate), the full slabs' 16-byte copies, the guarded 4-byte copies (every
  slab at 702^3) or the steady-state loop's barrier taken out;
* ``bwd``: the flash-attention backward as built, a two-stage ring, other
  register caps (blocks an SM), other tiles (the dk/dv kernel's query
  tiles, the dq kernel's key tiles), the dq kernel's fragments re-read
  instead of held, blocks of 8 warps; and diagnostics: the D pass and one
  of the two gradient kernels alone (what each costs);
* ``sscan_bwd``: the selective scan's backward as built, with blocks of 8
  warps (2 an SM), with plain loads in place of the tensor-map staging,
  with one piece of work taken out (the walk's second exp, the sums over
  channels, the 16 warps' partial pass) or the staging always of one chunk
  (its bytes from L2); and two redesigns of the walk's inner work, alone
  and together: the per-step operands (x, dt, dy, B, C) read from rows of
  steps, 4 steps (or 2) a 16-byte (8-byte) load, and the sums over a
  warp's channels for dB and dC taken 4 steps at a time (a transpose-
  reduce over steps, as dx and ddt have).

Needs a card and nvcc; prints a table and the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.launch import kernel_timing as kt  # noqa: E402

CSRC = Path(build.__file__).resolve().parent / "csrc"
OUT_DIR = build.BUILD_DIR.parent / "variants"
FULL_RTOL, FULL_ATOL, STATE_TOL = 2.0 ** -6, 1e-5, 3e-5
TIMED_S = (2048, 512)

SS, RG, MP = "selective_scan.cu", "rglru_scan.cu", "minplus.cu"
BW, SB = "flash_attention_bwd.cu", "selective_scan_bwd.cu"
# Code of the kernels as built, and what a diagnostic puts in its place.
_B_LOAD = "load4(bu[j], &sm.bT[q + kLanesPerCh * j][r]);"
_C_LOAD = "load4(cc[j], &sm.cT[q + kLanesPerCh * j][r]);"
_DT_LOAD = "load4(d, &sm.dtT[cl][r]);"
_DTX_LOAD = "load4(u, &sm.dtxT[cl][r]);"
_REWRITE = ("      sm.dtT[col][r] = d;\n"
            "      sm.dtxT[col][r] = d * to_float(sm.x[st][r][col]);")
_WALK_LOADS = ("          av[u] = sm.af[j][r + u][lane];\n"
               "          bv[u] = sm.bf[j][r + u][lane];")
_WALK_STEP = ("          h = fmaf(av[u], h, bv[u]);\n"
              "          sm.bf[j][r + u][lane] = h;")
_NO_WALK = [(_WALK_LOADS, "          av[u] = 0.5f + u;\n"
                          "          bv[u] = 0.25f * u;"),
            (_WALK_STEP, "          h += av[u] * bv[u];")]
_NO_COMPUTE = [("    compute(k % kStages, k, j);", "")]
_NO_WRITE = [("        if (c0 + col < D) from_floats(dst, hv);",
              "        if (c0 + col > 2 * D) from_floats(dst, hv);")]

_MP_UPDATE = "acc[r][c] = min_nan(acc[r][c], __fadd_rn(ar, b[c]));"
_MP_ORDER = """      for (int r = 0; r < G::TM; ++r) {
        const float ar = lane(a[r], u);
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[r][c] = min_nan(acc[r][c], __fadd_rn(ar, b[c]));
      }"""
_MP_MIN = '  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));'
_MP_COPY_A = "    cp_async<4>(st + sa + it * S::RA * G::SA, a[it] + ka);"
_MP_COPY_B = ("    cp_async<4>(st + sb + it * S::RB * G::BN,\n"
              "                b + static_cast<size_t>(it * S::RB) * N);")
_MP_GUARDED_A = "      cp_async<1>(dst, A + static_cast<size_t>(i) * K + ka);"
_MP_GUARDED_B = "      cp_async<1>(dst, B + static_cast<size_t>(k) * N + j);"
_MP_BARRIER = ("      cp_async_wait<G::STAGES - 2>();\n"
               "      __syncthreads();\n"
               "      load_full<G>(wr")

_BW_DKDV = "    dkdv<<<grid_kv, dkdv_threads, dkdv_smem, stream>>>(a);"
_BW_DQ = "  dq<<<grid_q, dq_threads, dq_smem, stream>>>(a);"
_BW_2_BLOCKS = "D >= 256 ? 1 : 2"
_BW_3_BLOCKS = "D >= 256 ? 1 : 3"

_SB_WALK_EXP = ("const float e = exp2_approx(d * Al[j]);\n"
                "          const float G")
_SB_PARTIALS = "for (int w = 1; w < kWarps; ++w) sum += sm.red[w][s][r];"


def _sb_step_loads(vec: int) -> list:
    """Replacements that make the selective-scan backward read its
    per-step operands ``vec`` steps a load: x, dt and dy rewritten into a
    row of steps a channel, B and C a row of steps a state (rows of 36
    floats, so the 4 channels of a warp hit distinct banks), the recompute
    and the walk taking ``vec`` steps from one 16-byte (vec = 4) or 8-byte
    (vec = 2) load each.  The arithmetic is the kernel's: the same bits."""
    return [
        ("// The forward's transpose-reduce (selective_scan.cu) for two "
         "quantities:",
         f"constexpr int kVec = {vec};                      // steps a load\n"
         "// V consecutive floats of a row (16-byte aligned for 4, 8-byte "
         "for 2)\n// in one load.\n"
         "template <int V>\n"
         "__device__ __forceinline__ void load_steps(float (&v)[V],\n"
         "                                           const float* p) {\n"
         "  if constexpr (V == 4) {\n"
         "    const float4 t = *reinterpret_cast<const float4*>(p);\n"
         "    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;\n"
         "  } else {\n"
         "    static_assert(V == 2, \"loads of 2 or 4 steps\");\n"
         "    const float2 t = *reinterpret_cast<const float2*>(p);\n"
         "    v[0] = t.x; v[1] = t.y;\n"
         "  }\n"
         "}\n\n"
         "// The forward's transpose-reduce (selective_scan.cu) for two "
         "quantities:"),
        ("  // The walked chunk's x, dt, dy in float32.\n"
         "  alignas(16) float x[kSteps][kLd];\n"
         "  alignas(16) float dt[kSteps][kLd];\n"
         "  alignas(16) float dy[kSteps][kLd];\n",
         "  // The walked chunk's x, dt, dy in float32, a row of steps a "
         "channel,\n  // and B, C a row of steps a state.\n"
         "  alignas(16) float x[kCh][kSteps + 4];\n"
         "  alignas(16) float dt[kCh][kSteps + 4];\n"
         "  alignas(16) float dy[kCh][kSteps + 4];\n"
         "  alignas(16) float bT[kMaxN][kSteps + 4];\n"
         "  alignas(16) float cT[kMaxN][kSteps + 4];\n"),
        ("      sm.x[s][col] = to_float(sm.xr[st][s][col]);\n"
         "      sm.dt[s][col] = to_float(sm.dtr[st][s][col]);\n"
         "      sm.dy[s][col] = to_float(sm.dyr[st][s][col]);\n"
         "    }\n",
         "      sm.x[col][s] = to_float(sm.xr[st][s][col]);\n"
         "      sm.dt[col][s] = to_float(sm.dtr[st][s][col]);\n"
         "      sm.dy[col][s] = to_float(sm.dyr[st][s][col]);\n"
         "    }\n"
         "    for (int e = tid; e < kSteps * kMaxN; e += kThreads) {\n"
         "      const int s = e / kMaxN, n = e % kMaxN;\n"
         "      sm.bT[n][s] = sm.b[st][s][n];\n"
         "      sm.cT[n][s] = sm.c[st][s][n];\n"
         "    }\n"),
        ("    for (int s = 0; s < kSteps; ++s) {\n"
         "      const float d = sm.dt[s][cl];\n"
         "      const float u = d * sm.x[s][cl];\n"
         "#pragma unroll\n"
         "      for (int j = 0; j < kPerLane; ++j) {\n"
         "        const float e = exp2_approx(d * Al[j]);\n"
         "        hs[s + 1][j] =\n"
         "            fmaf(e, hs[s][j], u * sm.b[st][s][q + kLanesPerCh * j]);"
         "\n      }\n    }\n",
         "    for (int s0 = 0; s0 < kSteps; s0 += kVec) {\n"
         "      float d4[kVec], x4[kVec], b4[kPerLane][kVec];\n"
         "      load_steps(d4, &sm.dt[cl][s0]);\n"
         "      load_steps(x4, &sm.x[cl][s0]);\n"
         "#pragma unroll\n"
         "      for (int j = 0; j < kPerLane; ++j)\n"
         "        load_steps(b4[j], &sm.bT[q + kLanesPerCh * j][s0]);\n"
         "#pragma unroll\n"
         "      for (int i = 0; i < kVec; ++i) {\n"
         "        const int s = s0 + i;\n"
         "        const float d = d4[i];\n"
         "        const float u = d * x4[i];\n"
         "#pragma unroll\n"
         "        for (int j = 0; j < kPerLane; ++j) {\n"
         "          const float e = exp2_approx(d * Al[j]);\n"
         "          hs[s + 1][j] = fmaf(e, hs[s][j], u * b4[j][i]);\n"
         "        }\n      }\n    }\n"),
        ("      for (int i = kGroup - 1; i >= 0; --i) {\n"
         "        const int s = g0 * kGroup + i;\n"
         "        const float d = sm.dt[s][cl], xv = sm.x[s][cl], "
         "dyv = sm.dy[s][cl];\n",
         "      float d4[kVec], x4[kVec], y4[kVec], b4[kPerLane][kVec],\n"
         "          c4[kPerLane][kVec];\n"
         "#pragma unroll\n"
         "      for (int i = kGroup - 1; i >= 0; --i) {\n"
         "        const int s = g0 * kGroup + i;\n"
         "        if (i % kVec == kVec - 1) {    // steps s - kVec + 1 .. s\n"
         "          const int s0 = s - (kVec - 1);\n"
         "          load_steps(d4, &sm.dt[cl][s0]);\n"
         "          load_steps(x4, &sm.x[cl][s0]);\n"
         "          load_steps(y4, &sm.dy[cl][s0]);\n"
         "#pragma unroll\n"
         "          for (int j = 0; j < kPerLane; ++j) {\n"
         "            load_steps(b4[j], &sm.bT[q + kLanesPerCh * j][s0]);\n"
         "            load_steps(c4[j], &sm.cT[q + kLanesPerCh * j][s0]);\n"
         "          }\n"
         "        }\n"
         "        const int r = i % kVec;\n"
         "        const float d = d4[r], xv = x4[r], dyv = y4[r];\n"),
        ("          const int n = q + kLanesPerCh * j;\n"
         "          const float bn = sm.b[st][s][n], cn = sm.c[st][s][n];\n",
         "          const float bn = b4[j][r], cn = c4[j][r];\n"),
        ("      sm.dx[s][cl] = fmaf(Dc, sm.dy[s][cl], sm.dt[s][cl] * "
         "p[0][0]);\n",
         "      sm.dx[s][cl] = fmaf(Dc, sm.dy[cl][s], sm.dt[cl][s] * "
         "p[0][0]);\n"),
    ]


# The selective-scan backward's sums over a warp's 4 channels for dB and
# dC taken 4 steps at a time: a lane keeps its 4 quantities of 4 steps,
# and two shuffle stages leave with lane w * 8 + q the 4 quantities of
# step w (the same additions in the same order: the same bits).
_SB_STEP_REDUCE = [
    ("// Tensor maps of the operands for the bulk-copy engine",
     "// q[k][m] holds quantity m (dB n = q, n = q + 8, dC n = q, n = q + 8)"
     "\n// of step k of 4; leaves in q[0][m] the sum of quantity m of step w"
     "\n// over the warp's 4 channels, w = lane / 8.\n"
     "__device__ __forceinline__ void reduce_steps(float (&q)[4][4], "
     "int lane) {\n"
     "  const bool up16 = lane & 16;\n"
     "#pragma unroll\n"
     "  for (int k = 0; k < 2; ++k) {\n"
     "#pragma unroll\n"
     "    for (int m = 0; m < 4; ++m) {\n"
     "      const float send = up16 ? q[k][m] : q[k + 2][m];\n"
     "      const float keep = up16 ? q[k + 2][m] : q[k][m];\n"
     "      q[k][m] = keep + __shfl_xor_sync(0xffffffffu, send, 16);\n"
     "    }\n"
     "  }\n"
     "  const bool up8 = lane & 8;\n"
     "#pragma unroll\n"
     "  for (int m = 0; m < 4; ++m) {\n"
     "    const float send = up8 ? q[0][m] : q[1][m];\n"
     "    const float keep = up8 ? q[1][m] : q[0][m];\n"
     "    q[0][m] = keep + __shfl_xor_sync(0xffffffffu, send, 8);\n"
     "  }\n"
     "}\n\n"
     "// Tensor maps of the operands for the bulk-copy engine"),
    ("    for (int g0 = kSteps / kGroup - 1; g0 >= 0; --g0) {\n",
     "    for (int g0 = kSteps / kGroup - 1; g0 >= 0; --g0) {\n"
     "      float vq[4][4];                           // dB, dC of 4 steps\n"),
    ("        reduce_channels(v, lane);\n"
     "        // Lane w * 8 + q (channel w of the warp) holds dB (w < 2) or dC"
     "\n        // (w >= 2) of state q + 8 (w % 2): entry lane of [dB n | dC n]."
     "\n        sm.red[warp][s][lane] = v[0];\n",
     "#pragma unroll\n"
     "        for (int m = 0; m < 4; ++m) vq[i % 4][m] = v[m];\n"
     "        if (i % 4 == 0) {                       // steps s .. s + 3\n"
     "          reduce_steps(vq, lane);\n"
     "#pragma unroll\n"
     "          for (int m = 0; m < 4; ++m)\n"
     "            sm.red[warp][s + lane / kLanesPerCh][m * kLanesPerCh + q] ="
     "\n                vq[0][m];\n"
     "        }\n"),
]

# name -> (source, constants, replacements)
SETS = {
    "geometry": {
        "sscan as built": (SS, {}, []),
        "sscan 16 lanes a channel": (SS, {"kLanesPerCh": 16,
                                          "kMinBlocks": 8, "kBatch": 2}, []),
        "sscan 16 lanes, 256 threads": (SS, {"kLanesPerCh": 16,
                                             "kThreads": 256, "kBatch": 2},
                                        []),
        "sscan 4 lanes a channel": (SS, {"kLanesPerCh": 4,
                                         "kMinBlocks": 2}, []),
        "sscan 256 threads": (SS, {"kThreads": 256, "kMinBlocks": 2}, []),
        "sscan 16-step chunks, 4 stages": (SS, {"kSteps": 16,
                                                "kStages": 4, "kBatch": 2},
                                           []),
        "sscan 64-step chunks, 2 stages": (SS, {"kSteps": 64,
                                                "kStages": 2}, []),
        "sscan 64-step chunks, 3 stages": (SS, {"kSteps": 64,
                                                "kStages": 3}, []),
        "sscan one group a reduce": (SS, {"kBatch": 1}, []),
        "rglru as built": (RG, {}, []),
        "rglru 4 producer warps": (RG, {"kProducers": 4}, []),
        "rglru 16 producers, 128-step chunks": (RG, {"kProducers": 16,
                                                     "kSteps": 128}, []),
        "rglru 3 stages": (RG, {"kStages": 3}, []),
        "rglru 10 stages": (RG, {"kStages": 10}, []),
        "rglru 128-step chunks": (RG, {"kSteps": 128}, []),
    },
    "diagnostics": {
        "sscan as built": (SS, {}, []),
        "sscan without the exp": (SS, {}, [(
            "e[j][s] = exp2_approx(d[s] * Al[j]);",
            "e[j][s] = d[s] * Al[j];")]),
        "sscan without the reduce": (SS, {}, [(
            "      reduce_groups(p, q);\n", "")]),
        "sscan without B, C loads": (SS, {}, [
            (_B_LOAD, "load4(bu[j], &sm.dtT[cl][r]);"),
            (_C_LOAD, "load4(cc[j], &sm.dtxT[cl][r]);")]),
        "sscan without dt, dt x loads": (SS, {}, [
            (_DT_LOAD, "load4(d, &sm.bT[q][r]);"),
            (_DTX_LOAD, "load4(u, &sm.cT[q][r]);")]),
        "sscan without the dt rewrite": (SS, {}, [(_REWRITE, "")]),
        "rglru as built": (RG, {}, []),
        "rglru without the sqrt": (RG, {}, [(
            "bv[v] = sqrtf(fmaxf(1.f - av[v] * av[v], 0.f)) * xv[v];",
            "bv[v] = av[v] * xv[v];")]),
        "rglru without the writes": (RG, {}, _NO_WRITE),
        "rglru without the walk": (RG, {}, _NO_WALK),
        "rglru stream: no compute, no walk": (RG, {},
                                              _NO_COMPUTE + _NO_WALK),
        "rglru stream, reads only": (RG, {},
                                     _NO_COMPUTE + _NO_WALK + _NO_WRITE),
    },
    "minplus": {
        "minplus as built": (MP, {}, []),
        "one k-group (192 threads, 2 blocks an SM)": (MP, {
            "kKG": 1, "kMinBlocks": 2}, []),
        "16-deep K-steps": (MP, {"kBK": 16}, []),
        "64-deep K-steps": (MP, {"kBK": 64}, []),
        "2 stages": (MP, {"kStages": 2}, []),
        "4 stages": (MP, {"kStages": 4}, []),
        "3 x 8 a thread, one k-group, 2 blocks": (MP, {
            "kTM": 3, "kKG": 1, "kMinBlocks": 2}, []),
        "64 x 64 tiles of 8 x 8, four k-groups": (MP, {
            "kBM": 64, "kBN": 64, "kTM": 8, "kKG": 4, "kBK": 64}, []),
        "128 x 128 tiles of 8 x 8, one k-group": (MP, {
            "kBM": 128, "kBN": 128, "kTM": 8, "kKG": 1}, []),
        "updates column-major": (MP, {}, [(_MP_ORDER, """\
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int r = 0; r < G::TM; ++r)
          acc[r][c] = min_nan(acc[r][c],
                              __fadd_rn(lane(a[r], u), b[c]));""")]),
        "plain min for min.NaN": (MP, {}, [(
            _MP_MIN, _MP_MIN.replace("min.NaN.f32", "min.f32"))]),
        "min replaced by an add": (MP, {}, [(
            _MP_UPDATE,
            "acc[r][c] = __fadd_rn(acc[r][c], __fadd_rn(ar, b[c]));")]),
        "add replaced by a min": (MP, {}, [(
            _MP_UPDATE,
            "acc[r][c] = min_nan(acc[r][c], min_nan(ar, b[c]));")]),
        "without the full-slab copies": (MP, {}, [
            (_MP_COPY_A, "    (void)a;"), (_MP_COPY_B, "    (void)b;")]),
        "without the guarded copies": (MP, {}, [
            (_MP_GUARDED_A, "      (void)i;"),
            (_MP_GUARDED_B, "      (void)j;")]),
        "without the steady loop's barrier": (MP, {}, [(
            _MP_BARRIER, _MP_BARRIER.replace("      __syncthreads();\n",
                                             ""))]),
    },
    "bwd": {
        "bwd as built": (BW, {}, []),
        "2 stages": (BW, {"kStages": 2}, []),
        "2 blocks an SM at d <= 64": (BW, {"kMinBlocks": _BW_2_BLOCKS}, []),
        "2 stages, 2 blocks an SM at d <= 64": (BW, {
            "kStages": 2, "kMinBlocks": _BW_2_BLOCKS}, []),
        "3 blocks an SM at d <= 128": (BW, {"kMinBlocks": _BW_3_BLOCKS}, []),
        "dk/dv query tiles of 32": (BW, {"kBQs": 32}, []),
        "dk/dv query tiles of 64": (BW, {"kBQs": 64}, []),
        "dq key tiles of 32": (BW, {"kBK": 32}, []),
        "dq key tiles of 64": (BW, {"kBK": 64}, []),
        "dq fragments re-read": (BW, {"kHoldQ": "false"}, []),
        "8 warps a block, 1 block an SM": (BW, {
            "kWarps": 8, "kMinBlocks": 1}, []),
        "D and dk/dv only": (BW, {}, [(_BW_DQ, "  (void)dq;")]),
        "D and dq only": (BW, {}, [(_BW_DKDV, "    (void)dkdv;")]),
    },
    "sscan_bwd": {
        "sscan_bwd as built": (SB, {}, []),
        "256 threads (32 channels), 2 blocks an SM": (SB, {
            "kThreads": 256, "kMinBlocks": 2}, []),
        "plain loads, no tensor maps": (SB, {}, [(
            "const bool tma = Di % 8 == 0 &&",
            "const bool tma = false && Di % 8 == 0 &&")]),
        "sscan_bwd without the walk's exp": (SB, {}, [(
            _SB_WALK_EXP, _SB_WALK_EXP.replace("exp2_approx(d * Al[j])",
                                               "fmaf(d, Al[j], 1.f)"))]),
        "sscan_bwd without reduce_channels": (SB, {}, [(
            "        reduce_channels(v, lane);\n", "")]),
        "sscan_bwd without the 16-warp partial pass": (SB, {}, [(
            _SB_PARTIALS, "")]),
        "staging one chunk over and over": (SB, {}, [(
            "    if (k > 0) fill(st ^ 1, k - 1);",
            "    if (k > 0) fill(st ^ 1, K - 1);")]),
        "16-byte loads of 4 steps": (SB, {}, _sb_step_loads(4)),
        "8-byte loads of 2 steps": (SB, {}, _sb_step_loads(2)),
        "dB, dC summed 4 steps at a time": (SB, {}, _SB_STEP_REDUCE),
        "16-byte loads and dB, dC 4 steps at a time": (
            SB, {}, _sb_step_loads(4) + _SB_STEP_REDUCE),
    },
}
# The entry point each source binds.
ENTRY = {SS: "selective_scan_fwd", RG: "rglru_scan_fwd", MP: "minplus_f32",
         BW: "flash_attention_bwd", SB: "selective_scan_bwd"}
# Min-plus timed shapes: (label, arch, config).
MINPLUS_TIMED = (("1536^3", "homog256", "placeit"),
                 ("702^3", "hex127", "baseline"))


def variant_source(src: str, consts: dict, replace: list) -> str:
    """The kernel source with ``consts`` set and ``replace`` applied;
    raises if a constant or a replaced text does not occur exactly once."""
    s = (CSRC / src).read_text()
    for k, v in consts.items():
        s, n = re.subn(rf"constexpr (\w+) {k} = [^;]+;",
                       rf"constexpr \g<1> {k} = {v};", s)
        if n != 1:
            raise ValueError(f"{src}: constant {k} found {n} times")
    for old, new in replace:
        if s.count(old) != 1:
            raise ValueError(f"{src}: {old!r} found {s.count(old)} times")
        s = s.replace(old, new)
    return s


def _slug(name: str) -> str:
    return re.sub(r"[^a-z0-9]+", "_", name.lower()).strip("_")


def build_variants(variants: dict) -> tuple[dict, dict]:
    """Compiles every variant side by side and prints ptxas's registers
    and spills of each; returns name -> ctypes library (with the entry
    point's signature set) of each variant that built, and name -> each
    backward variant's registers and spills per kernel (and the
    selective-scan backward's loop over chunks, or why it did not
    build)."""
    nvcc = build.find_nvcc()
    procs = {}
    for name, (src, consts, replace) in variants.items():
        d = OUT_DIR / _slug(name)
        d.mkdir(parents=True, exist_ok=True)
        for h in build.HEADERS:
            (d / h.name).write_text(h.read_text())
        (d / src).write_text(variant_source(src, consts, replace))
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs, usage = {}, {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            print(f"  {name:40s} did not build:\n{log[-4000:]}")
            usage[name] = {"build": log[-4000:]}
            continue
        regs = sorted({ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                       if "Used" in ln or ("spill" in ln
                                           and " 0 bytes spill" not in ln)})
        print(f"  {name:40s} {'; '.join(regs)[:150]}")
        if variants[name][0] in (BW, SB):
            usage[name] = kt.ptxas_usage(
                log, "mma_kernel" if variants[name][0] == BW else "sscan_bwd")
        path = OUT_DIR / _slug(name) / "lib.so"
        if variants[name][0] == SB:
            n, k = kt.sscan_bwd_issues(kt.sass_functions(kt.sass(path)))
            usage[name]["chunk loop"] = {"instructions": n, "MUFU": k}
            print(f"    loop over chunks: {n} instructions, {k} MUFU")
        lib = ctypes.CDLL(str(path))
        fns = [ENTRY[variants[name][0]]]
        if variants[name][0] == SB:
            fns.append("selective_scan_bwd_block_channels")
        for fn in fns:
            getattr(lib, fn).argtypes = build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs, usage


def _call(lib, kernel: str, args: list, dev):
    """One launch of a variant's entry point on the current stream."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    y = torch.empty_like(args[0])
    hf = torch.empty_like(args[-1])
    if kernel == SS:
        x, dt, A, B, C, D, h0 = args
        rc = lib.selective_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), h0.data_ptr(), y.data_ptr(),
            hf.data_ptr(), None, 1, x.shape[1], x.shape[2], A.shape[1],
            build.DTYPE_CODES["bfloat16"], build.DTYPE_CODES["float32"],
            dev.index, stream)
    else:
        x, a, h0 = args
        rc = lib.rglru_scan_fwd(
            x.data_ptr(), a.data_ptr(), h0.data_ptr(), y.data_ptr(),
            hf.data_ptr(), None, 1, x.shape[1], x.shape[2],
            build.DTYPE_CODES["bfloat16"], dev.index, stream)
    if rc != 0:
        raise RuntimeError(f"variant launch failed (cudaError {rc})")
    return y, hf


def _minplus_call(lib, W, dev):
    """One launch of a min-plus variant: W x W."""
    V = W.shape[-1]
    out = torch.empty_like(W)
    rc = lib.minplus_f32(W.data_ptr(), W.data_ptr(), None, out.data_ptr(),
                         V, V, V, dev.index,
                         torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"variant launch failed (cudaError {rc})")
    return out


def time_minplus_variants(names: list, libs: dict, dev) -> dict:
    """name -> {shape label: {"ms", "ok"}} at ``MINPLUS_TIMED``."""
    from repro_torch import testing
    res = {n: {} for n in names}
    for label, arch, cfg in MINPLUS_TIMED:
        W = torch.from_numpy(testing.score_graphs(arch, cfg, 1)[0]).to(dev)
        want = ref.minplus_ref(W, W)
        fns = {n: (lambda n=n: _minplus_call(libs[n], W, dev))
               for n in names}
        t, outs = kt.batched_ms(fns, 20, 5)
        for n in names:
            res[n][label] = {"ms": t[n],
                             "ok": testing.nan_equal(outs[n], want)}
    return res


def _bwd_call(lib, q, k, v, o, g, lse, dev):
    """One call of a backward variant's entry point (causal, the default
    scale), on the current stream: (dq, dk, dv)."""
    B, Sq, Hq, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    dsum = torch.empty(B, Hq, Sq, dtype=torch.float32, device=dev)
    rc = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        g.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *o.stride()[:3], *g.stride()[:3], B, Sq, Sk, Hq,
        Hkv, d, build.DTYPE_CODES["bfloat16"], d ** -0.5, 0.0, 1, -1,
        Sk - Sq, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"variant launch failed (cudaError {rc})")
    return dq, dk, dv


def time_bwd_variants(names: list, libs: dict, dev) -> dict:
    """name -> {shape label: {"ms", "ok"}} at ``kt.BWD_TIMED``."""
    from repro_torch.launch.kernel_compare import bwd_operands
    res = {n: {} for n in names}
    for arch, B in kt.BWD_TIMED:
        ops_ = bwd_operands(arch, B, dev)
        want = ref.attention_bwd_ref(*ops_)
        fns = {n: (lambda n=n: _bwd_call(libs[n], *ops_, dev))
               for n in names}
        t, outs = kt.batched_ms(fns, 5, 3)
        for n in names:
            res[n][f"{arch} B={B}"] = {
                "ms": t[n], "ok": kt.bwd_limit_share(outs[n], want) <= 1}
        del ops_, want, outs
        torch.cuda.empty_cache()
    return res


def _sscan_bwd_call(lib, ops_: list, dy, dhf, hb, dev) -> tuple:
    """One call of a selective-scan backward variant's entry point on the
    current stream, as ``selective_scan_bwd._launch`` makes it: (dx, ddt,
    dA, dB, dC, dD, dh0)."""
    from repro_torch.kernels.selective_scan_bwd import PARTIALS
    x, dt, A, B, C, D, _ = ops_
    Bt, S, Di = x.shape
    N = A.shape[1]
    f32 = torch.float32
    dx = torch.empty_like(x)
    ddt = torch.empty(Bt, S, Di, dtype=f32, device=dev)
    dA = torch.zeros(Di, N, dtype=f32, device=dev)
    dB = torch.zeros(Bt, S, N, dtype=f32, device=dev)
    dC = torch.zeros_like(dB)
    dD = torch.zeros(Di, dtype=f32, device=dev)
    dh0 = torch.empty(Bt, Di, N, dtype=f32, device=dev)
    nblk = -(-Di // lib.selective_scan_bwd_block_channels())
    part_bc = torch.empty(Bt, nblk, S, PARTIALS, dtype=f32, device=dev)
    part_a = torch.empty(Bt, Di, N, dtype=f32, device=dev)
    part_d = torch.empty(Bt, Di, dtype=f32, device=dev)
    rc = lib.selective_scan_bwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), hb.data_ptr(), dy.data_ptr(),
        dhf.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
        dB.data_ptr(), dC.data_ptr(), dD.data_ptr(), dh0.data_ptr(),
        part_bc.data_ptr(), part_a.data_ptr(), part_d.data_ptr(), Bt, S,
        Di, N, build.DTYPE_CODES[str(x.dtype)[6:]],
        build.DTYPE_CODES[str(dt.dtype)[6:]], dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"variant launch failed (cudaError {rc})")
    return dx, ddt, dA, dB, dC, dD, dh0


def time_sscan_bwd_variants(names: list, libs: dict, dev) -> dict:
    """name -> {"training": {"ms", "ok", "share"}} at
    ``kernel_timing.SCAN_TRAIN``'s selective scan (operands from
    ``scan_train_operands``, the chunk states from this checkout's forward
    kernel); "share" is the largest share of
    ``testing.SCAN_BWD_LIMITS["training"]`` each gradient uses against
    ``ref.selective_scan_bwd_ref``."""
    from repro_torch import testing
    from repro_torch.kernels import selective_scan as tss
    args, dy, dhf = kt.scan_train_operands("selective_scan", dev)
    ops_ = tss._on_card(*args)
    states = tss._launch(*ops_, states=True)[2]
    want = ref.selective_scan_bwd_ref(*args, dy, dhf)
    fns = {n: (lambda n=n: _sscan_bwd_call(libs[n], ops_, dy, dhf, states,
                                           dev)) for n in names}
    t, outs = kt.batched_ms(fns, 5, 3)
    res = {}
    for n in names:
        share = {g: testing.scan_bwd_share(a, b, "training")[1]
                 for g, a, b in zip(kt.SSCAN_GRADS, outs[n], want)}
        res[n] = {"training": {"ms": t[n], "share": share,
                               "ok": max(share.values()) <= 1}}
    return res


def time_variants(variants: dict, libs: dict, dev) -> dict:
    """name -> {"S=...": {"ms", "ok"}}; each kernel's variants take turns
    in every round of ``batched_ms``."""
    res = {name: {} for name in variants}
    sb_names = [n for n in variants if variants[n][0] == SB]
    if sb_names:
        res.update(time_sscan_bwd_variants(sb_names, libs, dev))
    mp_names = [n for n in variants if variants[n][0] == MP]
    if mp_names:
        res.update(time_minplus_variants(mp_names, libs, dev))
    bw_names = [n for n in variants if variants[n][0] == BW]
    if bw_names:
        res.update(time_bwd_variants(bw_names, libs, dev))
    for kernel in (SS, RG):
        names = [n for n in variants if variants[n][0] == kernel]
        if not names:
            continue
        for S in TIMED_S:
            args = kt.scan_serve_operands(
                "selective_scan" if kernel == SS else "rglru_scan", S, dev)
            plain = (ref.selective_scan_ref if kernel == SS
                     else ref.rglru_ref)
            yw, hw = plain(*args)
            fns = {n: (lambda n=n: _call(libs[n], kernel, args, dev))
                   for n in names}
            t, outs = kt.batched_ms(fns, 20, 5)
            for n in names:
                y, h = outs[n]
                ok = bool((((y.float() - yw.float()).abs()
                            <= FULL_ATOL + FULL_RTOL * yw.float().abs())
                           .all()) and torch.allclose(h, hw, rtol=STATE_TOL,
                                                      atol=STATE_TOL))
                res[n][f"S={S}"] = {"ms": t[n], "ok": ok}
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--set", action="append", choices=sorted(SETS),
                    required=True)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: kernel_variants.py runs on a card")
    dev = torch.device("cuda", 0)
    print(kt.card_line(), flush=True)
    results = {}
    for name in args.set:
        variants = SETS[name]
        print(f"== {name}: building {len(variants)} variants", flush=True)
        libs, usage = build_variants(variants)
        res = time_variants({v: variants[v] for v in libs}, libs, dev)
        for v, u in usage.items():
            res.setdefault(v, {})["ptxas"] = u
        for v, r in res.items():
            print(f"  {v:40s} " + "  ".join(
                f"{s} {x['ms']:.4f} ms{'' if x['ok'] else ' (fails)'}"
                for s, x in r.items() if s != "ptxas"), flush=True)
            for s, x in r.items():
                if "share" in x:
                    print("    share of the limit: " + ", ".join(
                        f"{g} {v:.3f}" for g, v in x["share"].items()))
            for kernel, u in r.get("ptxas", {}).items():
                print(f"    {kernel[-40:]}: {str(u)[:200]}")
        results[name] = res
    print(kt.card_line())
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
