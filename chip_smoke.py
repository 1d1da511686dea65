"""End-to-end smoke of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught; each header shows
the seconds since the start, so a phase's wall is the difference between
two headers):

1. device — the card's name, the device count and its power limit;
2. build  — every CUDA kernel from the sources in ``src/repro_torch`` (one
   nvcc per source, started together, then one link), with ptxas's
   registers and spills per kernel instance, and from this build's SASS
   (``cuobjdump -sass``) the hot loop of each FW and min-plus kernel
   instance: the instructions every warp issues a trip over the
   relaxations (or min-plus updates) in it (``kernel_timing.loop_issues``),
   and the scans' (``kernel_timing.SCAN_LOOPS``): the selective scan's
   over its (step, state) exps, RG-LRU's walker's over its steps and its
   producers' over their (step, channel) square roots;
3. parity — each kernel against its plain PyTorch version on the card.
   The FW and min-plus kernels bit for bit (``torch.equal``): the FW
   kernel on random, disconnected, count-clip and real homog32/homog64
   score graphs; the blocked FW kernel against the plain blocked FW, the
   plain FW and the FW kernel on graphs at the tile edges, disconnected
   graphs, the count-clip graph and score graphs of the four
   100+-chiplet families; the min-plus kernel (NaN-aware: NaN in the same
   places) on ragged shapes at its tile and K-step edges, on shapes that
   take the guarded copies, on sums above its 1e9 ceiling and on NaN,
   +-inf and negative operands, and with a fused C against
   ``ref.minplus_ref(A, B, C)``; APSP against the plain FW's distances on
   homog256 graphs.  The attention kernels to the
   JAX tests' tolerances (flash 2e-5, decode 3e-5 in float32, both 2e-2
   in bfloat16) on
   ``testing.attention_cases`` / ``decode_cases`` and on the edges of the
   kernels' tiles and splits (``attention_tile_cases`` /
   ``decode_split_cases``) in both dtypes, and at the serve shapes in
   bfloat16 to a limit scaled to the outputs (two bfloat16 ulps of each
   entry plus 1e-5, ``FULL_LIMIT``).
   The decode kernel's log-sum-exp (``return_lse``; slice 18) on the
   same cases in both dtypes: the output the same bits as without it, the
   lse -inf in the same rows as the plain version's and elsewhere within
   ``LSE_ATOL`` + ``LSE_RTOL`` |lse|; and the cache cut into 2 and 4
   pieces over its positions, each piece through the kernel with its
   local lengths, merged (``testing.decode_pieces``), within the decode
   cases' tolerances of the uncut call.
   The flash-attention backward kernel against ``ref.attention_bwd_ref``
   on ``testing.attention_cases`` (every option of the forward) and
   ``attention_tile_cases`` (the edges of its tiles) in both
   dtypes (2e-5 in float32, 2e-2 in bfloat16), two calls bit for bit,
   from the forward kernel's output and log-sum-exp (the lse within 1e-5
   of the plain version's, -inf in the same rows, and the output the
   same bits as the serving launch's without it).
   The scan kernels (selective scan, RG-LRU) on ``testing.scan_cases`` in
   both dtypes (3e-5 in float32, 2e-2 in bfloat16, final states 3e-5), and
   a sequence split across two calls bit for bit equal to one call.  The
   scans' backward kernels (``selective_scan_bwd``, ``rglru_scan_bwd``)
   against ``ref.selective_scan_bwd_ref`` / ``ref.rglru_bwd_ref`` on the
   same cases in both dtypes with a seeded dh_final (and without one where
   the case has h0), within ``testing.SCAN_BWD_LIMITS["cases"]``, two
   calls bit for bit.
   The batched score-graph builds of the device pipeline on the card
   (``testing.batched_build_parity``, 64 random placements each of homog64
   placeit, homog256 placeit and hex127 baseline through
   ``HomogGraphBatch``, of hetero32 and hetero64 placeit through
   ``HeteroBatch.geometry_batch`` + ``HeteroGraphBatch``) against the host
   ``score_graph``: every stacked array bit for bit, slot for slot, equal
   edge sets and ``connected``, no overflow, and the scorer's metrics and
   cost from the two builds bit-equal; each prints its batched build's
   wall time (and the host corner placement's);
4. timing — each kernel at the main path's shapes, its calls back to
   back between one pair of CUDA events behind a spin kernel, so that the
   host's enqueue is not counted (``kernel_timing.batched_ms``), beside
   its bound, the plain version and, for the FW and min-plus kernels, the
   single-issue instruction floor of the instance each call launches (the
   work times the build phase's instructions a relaxation or update, over
   128 lanes an SM at the top SM clock; printed here only); the FW kernel
   and the blocked FW
   kernel side by side at every (B, V) the scorer uses for the large
   families, at V = 216 and 480 and at V = 40 .. 702 on random graphs at
   B = 16 (the measurement behind ``ops.fw_takes_tiled``; each row names
   kernel 1's cluster size and the kernel the dispatch picks).  Every
   timed output is held bit for bit against the plain version's output
   on the same input, so the kernels are also checked at the main path's
   full shapes (min-plus at 1536^3, APSP at V = 1536).  Min-plus at 1536^3
   and at 702^3 (hex127, ragged against every tile) beside its
   instruction bound (2 M N K instructions, an FADD and an FMNMX an
   update, at 128 lanes a clock an SM; the 67 TFLOP/s figure printed
   beside it as out of reach), its issue floor at 1536^3 (the steady-state
   loop's instructions an update, its 16-byte staging included; 702^3
   stages every slab by guarded copies, which the count leaves out) and
   its tile-fill share (``minplus.tile_fill``: tiles, SMs, blocks resident
   an SM, tiles on the busiest SM).  The
   attention kernels at the serve runs' shapes in bfloat16, causal, 20
   launches an event pair: qwen3-1.7b's (flash: B = 1,
   Sq = Sk in {512, 2048}; decode: B = 8 over a 4096-token cache) and
   recurrentgemma-9b's (16 query heads on 1 KV head, head dim 256; flash
   with its 2048-token window at Sq = Sk in {2048, 3072}; decode: B = 8
   over its 2048-slot ring), decode at every length full and at lengths
   drawn from the seed, each beside its plain version, its bound and one
   PyTorch call that computes the same function
   (``scaled_dot_product_attention``, timed for comparison only; the port
   never calls it: ``is_causal=True`` where flash has no window, no mask
   where every decode row is full, else a boolean mask, which is also
   timed beside the first two), every output held to ``FULL_LIMIT``
   against the plain version.  The scan kernels at the serve runs'
   prefill shapes (B = 1, S in {512, 2048}; falcon-mamba-7b's Di = 8192,
   N = 16 with x in bfloat16 and dt in float32; recurrentgemma-9b's
   D = 4096 in bfloat16),
   beside the plain versions, their bounds and their issue floors (the
   build phase's instructions an item over 128 lanes an SM at the top SM
   clock; RG-LRU's walker, one warp a block, S steps at one instruction a
   clock; no PyTorch call computes a scan), outputs held to
   ``FULL_LIMIT`` and final states to 3e-5.  The flash-attention
   backward at the training shapes (bfloat16, causal, S = 2048:
   smollm-360m at B = 8, qwen3-1.7b at B = 1; recurrentgemma-9b at B = 1,
   S = 4096 with its 2048-token window, head dim 256) beside its bound (10
   B Hq d operations a seen (query, key) pair at the bf16 peak), the plain
   backward and the backward of ``scaled_dot_product_attention``
   (``is_causal=True``, a boolean mask where there is a window), outputs
   held to ``BWD_LIMIT`` (the largest share of it used printed) and to a
   second call's bits.  The scans' backward kernels at the training
   shapes (``kernel_timing.SCAN_TRAIN``: falcon-mamba-7b B = 2, S = 4096,
   Di = 8192, N = 16, x in bf16 and dt in float32; recurrentgemma-9b
   B = 1, S = 4096, D = 4096 in bf16), from the states the forward writes
   for them, beside their bounds (``kernel_timing.sscan_bwd_work`` /
   ``rglru_bwd_work``: operations and exps or square roots against bytes),
   the plain versions and no library call, held to
   ``SCAN_BWD_LIMITS["training"]`` (share printed) and repeatable; the
   forward with and without those states timed beside;
5. main path — each path driven through its entry points on the card,
   with every kernel's launch count and every plain version's call count
   set to 0 just before each run and read just after:
   - slice 1, the default backend "fw-tiled" (the size dispatch between
     the two FW kernels): the quickstart experiment (homog32 baseline, GA)
     and homog64 placeit (GA at paper defaults), through
     ``run_experiment`` and ``baseline_cost``; then the quickstart on
     backend "fw-cuda" (kernel 1 at every V); each run must launch the
     kernel its backend picks, and the runs both FW kernels;
   - slice 2, the default backend: homog256 placeit (V = 1536) and hex127
     baseline (V = 702), GA at the large families' defaults;
   - slice 9, the default backend: hetero32 placeit (V = 240) through the
     host GA at the paper's 30 / 6 / 6; hetero64 placeit (V = 480)
     through ga-batched at the paper's 20 / 5 / 5; homog256 placeit
     through ga-batched at ``LARGE_DEFAULTS``, two generations as slice
     2's host GA, the two walls and evaluations/s printed side by side
     (a record, not a claim); a short br-batched run on hetero32 placeit
     and sa-batched on homog64 placeit, so that every registered optimizer
     runs on the card; each must launch the blocked FW kernel, which its
     V takes, and no plain version;
   - ``ops.apsp`` on the homog256 winner's score graph (min-plus kernel);
   the homog32, homog256 and homog256 ga-batched winners are re-scored
   with the plain FW, and the APSP distances must equal the plain FW's;
   - slice 10, the multi-run paths (default backend, the blocked FW
     kernel): ``run_sweep`` over homog64 placeit (seeds 0 and 1 x br, ga
     at the paper's 50 / 8 / 8, plus a ga-batched and an sa-batched config
     on the same scorer, so host graph lists and device batches stack in
     one group), stacked and then unstacked: the records must be equal
     field for field (``best_sol``, the bits of ``best_cost``,
     ``n_evaluated``, ``n_generated``, the history's (n, cost) pairs),
     one stacked group, fewer scorer calls stacked; each mode prints its
     wall, evaluations/s, scorer calls and blocked-FW launches.  The
     Pareto sweep of ``examples/pareto_sweep.py`` (hetero32 placeit
     ga-batched, a 3 x 2 grid of lat / inv-thr weights): one scorer, one
     group, one evaluator, 6 candidates; the card's dominance mask must
     equal the host's and its float32 hypervolume the host float64
     recursion's within rel 1e-6; one grid point's solo
     ``run_experiment`` must equal its stacked record.  The trace run of
     ``examples/trace_optimize.py`` (homog32 placeit host GA, a proxy-only
     and a trace-lat config over one 5000-packet trace region in one
     ``run_sweep``): prints the host-simulated average packet latency of
     the 2D mesh and of both winners, and the trace winner's ``trace_*``
     metrics scored on the card must agree with the same placement scored
     on the CPU with the plain FW (rtol 1e-5, 1e-4 for ``trace_thr_*``,
     ``tests/test_torch_netsim.py``'s);
   - slice 11, the design service and the 3D families (default backend,
     the blocked FW kernel): one ``DesignEngine`` with four tenants at
     full width (homog64 placeit GA 50 / 8 / 8 over a ``lat`` {0.5, 2}
     grid with a 16-row population archive; homog64 placeit BR, seed 1,
     on the same scorer; hetero32 placeit ``ga-batched`` 30 / 6 / 6;
     stack3d64 placeit ``ga-batched`` 32 / 6 / 6 with a 16-row archive),
     then a second engine with ``shard=True``; both engines' records must
     equal the same configs' ``run_sweep(fold_repetitions=False)`` field
     for field, archives included; each prints its wall,
     ``score_calls``, ``stacked_rounds``, ``shard_devices`` and blocked-FW
     launches.  The batched 3D builds (64 random placements of each of
     the five families, ``testing.PIPELINE_ARCHS_3D``) against the host
     build bit for bit, then stack3d64 and gw3d64 placeit ``ga-batched``
     and stack3d64 placeit host GA through ``run_experiment`` (32 / 6 /
     6), each with its wall, evaluations/s and blocked-FW launches;
   - slice 12, training and the co-design bridge: ``launch.train`` on
     smollm-360m at full width (32 layers, d_model 960, 15 / 5 heads of
     64, d_ff 2560, vocab 49 152, bf16, remat; weights from seed 0), B =
     8, S = 2048, 20 steps of AdamW, a checkpoint every 10; SIGTERM at
     step 10 stops the first run (the loop checkpoints), a second run
     resumes from it to step 20.  The loss must fall; it prints the loss
     at the first and last step, the median step, tokens/s, the share of
     the bf16 peak that 6 N tokens a step gives and the peak memory; the
     flash kernel and its backward must launch, and no plain version
     (``attention_ref``, ``attention_bwd_ref``) be called.  Then one step
     at full width and depth 2 through the kernels against the same step
     through the plain versions (loss within 1e-3 relative, each gradient
     within 3e-2 of its norm).  ``bridge.codesign`` from
     ``examples/design_accelerator.py``'s synthetic decode signature (GA,
     120 evaluations) on the default backend: it prints the package, the
     weights, both costs and the FW kernel the package's V takes, which
     must launch;
   - slice 14, training the recurrent families at full width and cut
     depth through ``train.step`` and ``train.loop`` (bf16, remat,
     S = 4096, weights from seed 0, 12 steps of AdamW, a checkpoint at the
     last): falcon-mamba-7b at 8 of 64 layers, B = 2, and
     recurrentgemma-9b at 6 of 38 (two rec, rec, attention blocks), B = 1.
     The loss must fall; each prints its step time, tokens/s, 6 N tokens'
     share of the bf16 peak and peak memory; the scans' forward and
     backward kernels (and recurrentgemma's attention kernels) must
     launch, and no plain version be called.  Then one step of each at full
     width (falcon-mamba-7b depth 2, B = 2; recurrentgemma-9b depth 3,
     B = 1; S = 1024) through the kernels against the same step through
     the plain versions (``testing.plain_selective_scan``,
     ``plain_rglru_scan``, ``plain_attention``), to the limits of the
     smollm-360m step;
   - slice 16, the MoE and encoder-decoder families: seamless-m4t-medium
     at full width and depth through ``LM.prefill`` (8 requests in one
     prefill, 48-token prompts, 1024 frames of ``src_embeds`` from the
     seed) and greedy ``LM.decode_step`` with ``mem_len`` (64 tokens each:
     exactly 36 flash launches and 24 decode launches a tick, no plain
     call, the consistency check, a profile); ``train.step`` on
     moonshot-v1-16b-a3b (4 of 48 layers, B = 2) and seamless (full
     depth, B = 2, 4096 frames) at full width, S = 4096, 12 steps (the
     loss must fall, an MoE model's aux stay finite, both attention
     kernels launch, no plain call; a profiled step with the MoE block's
     pieces attributed); the kernel-against-plain steps of moonshot and
     seamless at depth 2 and grok-1-314b at full width and depth 1;
   - slice 23, the dense archs that no earlier slice ran on the card:
     ``train.step`` at full width, S = 4096, 12 steps, on llava-next-34b
     (4 of 60 layers, B = 1, 576 rows of ``patch_embeds`` from the seed in
     front of every sequence: 4672 rows), qwen2.5-3b (full depth, B = 1;
     QKV biases) and tinyllama-1.1b (full depth, B = 2), as slice 16's;
     their kernel-against-plain steps at depth 2 (llava with its prefix);
     each served through ``ServeEngine`` at full width and depth among the
     serve runs below (text-only requests, as the reference's engine
     takes), and then llava's patch-prefix path through ``LM.prefill`` (8
     rows of 576 patch rows and a 48-token prompt, sequence 624) and 64
     greedy ``LM.decode_step``s (lengths 624 + t): exactly one flash
     launch a layer and one decode launch a layer a tick, no plain call,
     the decode step against a re-prefill with the prefix in both;
   - slice 24, the long_500k cells (524 288 positions, B = 1, decode;
     the bounded-state archs): inside falcon-mamba-7b's and
     recurrentgemma-9b's serve runs below, on the same weights once the
     engine is freed, ``ServeEngine`` with one slot and ``cache_len``
     524 288, one prompt and 16 tokens; the prompt's length from
     ``LM.prefill``'s peak measured at 32 768 and 65 536 tokens and
     extrapolated (the whole cell less its 16 tokens if the card holds
     it, else the largest power of two that fits); one flash launch a
     layer for the prefill, one scan launch a recurrent layer, one decode
     launch a layer a tick, no plain call; the first tick against a
     re-prefill of (prompt + token 1) within 4 bf16 ulps (or, where that
     re-prefill would take more than a minute, the plain decode path on
     copies of the caches), and with the recurrent states zeroed (held
     for falcon-mamba-7b); prompt length, peak, prefill and decode
     tokens/s printed.  Before it, at the start, the card's RoPE table of
     every arch against the CPU's bit for bit, and the selective scan
     ([1, 524 288, 8192], N = 16), the RG-LRU scan ([1, 524 288, 4096])
     and flash attention (q [1, 524 288, 16, 256], window 2048) at the
     cell's length: one call against 4 calls handing on the state bit
     for bit, and the last 2048 steps (queries) against the plain
     versions;
   - slices 3 and 4, the LM serving paths, each model at full width
     (bfloat16, weights from a ``torch.Generator`` seeded 0 on the card)
     through ``ServeEngine`` (8 slots, cache 4096, no EOS; 16 requests of
     64 tokens, prompts drawn from seed 0), one model at a time:
     qwen3-1.7b (prompts 256-2048 tokens; 28 flash launches per prefill,
     28 decode launches per tick), falcon-mamba-7b (256-2048; 64
     selective-scan launches per prefill) and recurrentgemma-9b (256-3072,
     past its 2048-token window; 26 RG-LRU and 12 flash launches per
     prefill, 12 decode launches per tick), and from slice 16
     moonshot-v1-16b-a3b at its full 48 layers and grok-1-314b at 4 of
     its 64 (256-2048; one flash launch per layer a prefill, one decode
     launch per layer a tick, every expert read each tick, the bytes
     printed beside the tick), and from slice 23 qwen2.5-3b,
     tinyllama-1.1b and llava-next-34b (256-2048; QKV biases drawn from
     the seed, since the reference initialises them to zero); no plain
     call.  Each prints
     wall time, prefill and decode tokens/s, the median time to first
     token, ticks, launches and peak memory, then the decode step's logits
     for request 0's second token against a re-prefill of (prompt + first
     token).  For the recurrent models the same check with the prefill's
     recurrent states zeroed must fail, so that it holds the scans' final
     states' hand-off to the decode step; recurrentgemma-9b is held with
     its RG-LRU Lambda negated, where the states carry (as initialised
     they barely do); the MoE models on a dropless copy of their configs,
     the token's routing in the two paths printed layer by layer;
   - slice 17, model parallelism (``sharding_phase``): a one-rank NCCL
     group (a ``FileStore`` under ``build/``), a (1, 1) ``DeviceMesh``,
     and ``launch.train.sharded_training``'s DTensor step against the
     plain step from the same seed, in turns, equal bit for bit after
     every step (loss, gradient norm, every parameter): smollm-360m at
     full width and depth (``TRAIN_*``: B = 8, S = 2048, bf16, remat), 4
     steps, both attention kernels launched on the local shards and no
     plain call, each path's median step printed; falcon-mamba-7b and
     moonshot-v1-16b-a3b at full width and one layer, 2 steps each (the
     selective-scan kernels, the MoE block's per-row pieces and experts
     on the shards); ``compressed_psum`` over the group on a float32
     8192 x 8192 tensor, bit for bit ``dequantize_int8(quantize_int8(x))``,
     timed; ``launch.train --model-par 2`` on the one card failing on the
     reference's assertion.  More cards than one are not measured;
   - slice 18, the dry run and the roofline (``dryrun_phase``):
     ``python -m repro_torch.launch.dryrun`` on qwen3-1.7b train_4k and
     decode_32k (its cache split over positions) and moonshot
     prefill_32k (its experts split), (slice 19) falcon-mamba-7b and
     recurrentgemma-9b prefill_32k, and (slice 20) moonshot train_4k at
     8 of its 48 layers (its router's weight gradient a block of rows a
     model rank), on the card's fake tensors over 256 fake ranks, and
     (slice 21) on the multi-pod mesh, 512 fake ranks in two pods,
     moonshot and qwen3-1.7b train_4k at 2 layers and qwen3-1.7b
     decode_32k, each in a process of its own, all at once; each must be
     ok with FLOPs, bytes and collective bytes, and its roofline row at
     this card's rates is printed; each is held to the JAX package's
     compiled cell (``tests/data/dryrun_reference_single.json`` and
     ``dryrun_reference_multi.json``, written by
     ``tests/_torch_dryrun_reference.py``): FLOPs and argument bytes
     equal, wire bytes no more, a multi-pod cell's bytes that cross pods
     no more than the reference's exact recount, and the peak (arguments
     and temp) no more than ``DRYRUN_REF_PEAK`` times the reference's,
     each cell's counts printed beside the reference's; (slice 22) the
     multi-pod cells' wire bytes beside the port's own counts on the
     torch release that wrote ``tests/data/dryrun_port_multi.json``,
     moonshot's within ``DRYRUN_RELEASE_SLACK``; then (slice 20)
     ``DRYRUN_ORDER_CELL`` counted on fake cuda and fake CPU tensors in
     this process, after the sharding phase's NCCL steps: the counts
     must agree field for field; then the smollm-360m train step
     (``TRAIN_*``) counted on fake tensors and run for real: the product
     FLOPs by op equal to ``FlopCounterMode``'s, each kernel's counted
     calls equal to its launches, the predicted peak within
     ``DRYRUN_PEAK_RTOL`` of ``max_memory_allocated``, and the step no
     faster than the roofline's bound (the larger of its compute and
     memory terms);
6. profile — ``torch.profiler`` over one blocked FW call at homog256
   (device time by kernel) and one homog256 placeit run through the host
   GA and one through ga-batched (device busy share, the copies' time by
   direction), the design phase's unsharded engine (device busy share),
   and the Evaluator's 20 host norm samples alone; one train step of the
   full-width smollm-360m run (device busy share, device time by kernel
   group: the attention backward, the attention forward, cuBLAS
   products, the rest); for each
   served model, after its run, one prefill of 1024
   tokens and 2 decode ticks of the 8-slot pool (device busy share, time
   by kernel).

The second-to-last line is a JSON object listing the kernels; the last is
``{"ok": true, "device": {...}}``.  There is no CPU mode.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import testing  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.registry import (ARCHS, SHAPES,  # noqa: E402
                                          ShapeSpec, eligible_shapes)
from repro_torch.core import api  # noqa: E402
from repro_torch.core import bridge  # noqa: E402
from repro_torch.core import pareto  # noqa: E402
from repro_torch.core.api import (ExperimentConfig,  # noqa: E402
                                  baseline_cost, make_rep, run_experiment,
                                  run_sweep)
from repro_torch.core.baseline import MeshBaseline  # noqa: E402
from repro_torch.core.chiplets import resolve_arch  # noqa: E402
from repro_torch.core.placement_hetero import HeteroRep  # noqa: E402
from repro_torch.core.objective import (Objective, TermSpec,  # noqa: E402
                                        norms_vec)
from repro_torch.core.traces import TraceRegion, generate_trace  # noqa: E402
from repro_torch.core.proxies import (make_scorer,  # noqa: E402
                                      max_pair_elems, scorer_chunk)
from repro_torch.core.topology import stack_graphs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenStream  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as tfb  # noqa: E402
from repro_torch.kernels import fw_counts as fwc  # noqa: E402
from repro_torch.kernels import fw_counts_tiled as fwt  # noqa: E402
from repro_torch.kernels import minplus as mp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as plain  # noqa: E402
from repro_torch.kernels import rglru_scan as trg  # noqa: E402
from repro_torch.kernels import rglru_scan_bwd as trb  # noqa: E402
from repro_torch.kernels import selective_scan as tss  # noqa: E402
from repro_torch.kernels import selective_scan_bwd as tsb  # noqa: E402
from repro_torch.launch import kernel_timing as kt  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.layers import Attention, rope_freq  # noqa: E402
from repro_torch.models.model import LM, dec_plan  # noqa: E402
from repro_torch.models.rglru import RGLRU  # noqa: E402
from repro_torch.models.transformer import leaf_kinds  # noqa: E402
from repro_torch.models.tree import tree_map  # noqa: E402
from repro_torch.netsim import ChipletNet, NetSim, Workload  # noqa: E402
from repro_torch.serve.design import DesignEngine  # noqa: E402
from repro_torch.train.loop import LoopConfig  # noqa: E402
from repro_torch.train.loop import run as train_loop_run  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.step import build_train_step, init_state  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.serve.engine import (EngineConfig, Request,  # noqa: E402
                                      ServeEngine)

# H100 SXM published peaks (NVIDIA data sheet): float32 outside the tensor
# cores, bfloat16 on the dense tensor cores, and HBM3 bandwidth.
PEAK_F32_OPS = 67e12
PEAK_BF16_OPS = 989e12
PEAK_BYTES = 3.35e12
# add, mul, min, three compares, add, two selects, min
FW_OPS_PER_RELAXATION = 10
# (B = the scorer's chunk, arch, config): V = 216 and V = 480.
TIMED = ((16, "homog32", "baseline"), (16, "homog64", "placeit"))
# Random graphs at the scorer's B = 16 around the paper's sizes, to place
# the dispatch between the two FW kernels (``ops.fw_takes_tiled``).
TIMED_SMALL_V = (40, 64, 96, 112, 130, 160, 192, 300, 384, 552, 702)
KERNELS = {"fw_counts": fwc, "fw_counts_tiled": fwt, "minplus": mp,
           "flash_attention": tfa, "decode_attention": tda,
           "selective_scan": tss, "rglru_scan": trg,
           "flash_attention_bwd": tfb, "selective_scan_bwd": tsb,
           "rglru_scan_bwd": trb}
# Attention tolerances (the JAX kernel tests'), by kernel and dtype.
ATTN_TOL = {"flash_attention": {"float32": 2e-5, "bfloat16": 2e-2},
            "decode_attention": {"float32": 3e-5, "bfloat16": 2e-2}}
# The arch whose score graphs time min-plus and check APSP (V = 1536),
# and the one whose V = 702 is ragged against every min-plus tile.
APSP_ARCH = "homog256"
MINPLUS_RAGGED_ARCH = "hex127"

# The main path's runs.  Slice 1: the quickstart and homog64 placeit on
# the default backend (the size dispatch), and the quickstart once more on
# "fw-cuda" (kernel 1 at every V); slice 2: homog256 placeit and hex127
# baseline, GA at the large families' defaults.
# (``kernel_timing.RUNS``, which ``launch/kernel_compare.py --walls`` times
# too.)
QUICKSTART = kt.experiment_config(api, "quickstart")
QUICKSTART_KERNEL1 = dataclasses.replace(QUICKSTART, backend="fw-cuda")
HOMOG64 = kt.experiment_config(api, "homog64 placeit")
HOMOG256 = kt.experiment_config(api, "homog256 placeit")
HEX127 = kt.experiment_config(api, "hex127 baseline")
# Slice 9: the heterogeneous archs and the device-resident pipeline.
HETERO32 = kt.experiment_config(api, "hetero32 placeit")
HETERO64_BATCHED = kt.experiment_config(api, "hetero64 placeit ga-batched")
HOMOG256_BATCHED = kt.experiment_config(api, "homog256 placeit ga-batched")
BR_BATCHED = kt.experiment_config(api, "hetero32 placeit br-batched")
SA_BATCHED = kt.experiment_config(api, "homog64 placeit sa-batched")
# Random placements of each arch of ``testing.PIPELINE_ARCHS`` whose
# batched build the parity phase holds against the host build.
PIPELINE_N = 64
# Slice 10: the multi-run paths.  The sweep (``kernel_timing.SWEEP_RUNS``,
# which ``launch/sweep_walls.py`` times in turns): homog64 placeit, the
# paper's GA 50 / 8 / 8, br and ga at seeds 0 and 1 plus a ga-batched and
# an sa-batched config on the same scorer.
SWEEP = kt.sweep_configs(api)
# The Pareto sweep of examples/pareto_sweep.py: hetero32 placeit
# ga-batched, 6 scalarizations.
PARETO_BASE = ExperimentConfig(
    arch="hetero32", config="placeit", algorithms=("ga-batched",),
    budget=api.Budget(evals=60), norm_samples=16, chunk=8, seed=0,
    params={"ga-batched": dict(population=10, elitism=2, tournament=3)})
PARETO_GRID = pareto.ParetoGridSpec(term_weights={"lat": (0.5, 1.0, 2.0),
                                                  "inv-thr": (0.5, 2.0)})
# Relative tolerance of the card's float32 hypervolume against the host
# float64 recursion (tests/test_torch_pareto.py's).
HV_RTOL = 1e-6
# examples/trace_optimize.py: homog32 placeit, GA 400 evals, a proxy-only
# and a trace-lat config over one 5000-packet trace region.
TRACE_REGIONS = (TraceRegion(5000, 20000),)
_TRACE_BASE = dict(arch="homog32", config="placeit", algorithms=("ga",),
                   budget=api.Budget(evals=400), norm_samples=32, chunk=16,
                   seed=0)
# The trace metrics' tolerance on the card against the CPU
# (tests/test_torch_netsim.py's); trace_thr_* divides a difference of two
# float32 sums and takes THR_RTOL.
TRACE_RTOL, THR_RTOL = 1e-5, 1e-4
# Slice 11: the design service.  Four tenants at full width, budgets cut
# only: homog64 placeit GA at the paper's 50 / 8 / 8 over a lat {0.5, 2}
# grid with a 16-row archive; homog64 placeit BR, seed 1, on the same
# scorer (the two stack); hetero32 placeit ga-batched at the paper's
# 30 / 6 / 6; stack3d64 placeit ga-batched at ARCH3D_DEFAULTS' 32 / 6 / 6
# with a 16-row archive.
DESIGN_GRID = pareto.ParetoGridSpec(term_weights={"lat": (0.5, 2.0)})
DESIGN_TENANTS = (
    (ExperimentConfig(arch="homog64", config="placeit", algorithms=("ga",),
                      budget=api.Budget(evals=100), norm_samples=50,
                      archive_k=16), DESIGN_GRID),
    (ExperimentConfig(arch="homog64", config="placeit", algorithms=("br",),
                      budget=api.Budget(evals=96), norm_samples=50, seed=1),
     None),
    (ExperimentConfig(arch="hetero32", config="placeit",
                      algorithms=("ga-batched",), budget=api.Budget(evals=90),
                      norm_samples=30), None),
    (ExperimentConfig(arch="stack3d64", config="placeit",
                      algorithms=("ga-batched",), budget=api.Budget(evals=84),
                      norm_samples=32, archive_k=16), None))
# Slice 11: the 3D families.  Random placements of each family of
# ``testing.PIPELINE_ARCHS_3D`` built both ways, then three runs at
# ARCH3D_DEFAULTS (32 / 6 / 6, two generations each).
ARCH3D_N = 64
ARCH3D_RUNS = tuple(ExperimentConfig(
    arch=arch, config="placeit", algorithms=(algo,),
    budget=api.Budget(evals=evals), norm_samples=32)
    for arch, algo, evals in (("stack3d64", "ga-batched", 84),
                              ("gw3d64", "ga-batched", 84),
                              ("stack3d64", "ga", 64)))


# The script's start: each phase's header prints the seconds since, so
# that a phase's wall is the difference between two headers.
T0 = time.monotonic()


def phase(name: str) -> None:
    print(f"== [{time.monotonic() - T0:.1f} s] {name}", flush=True)


def device_phase() -> str:
    phase("device")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py runs only on a card")
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}, count {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(kt.card_line())
    # No float32 product on the path may run in TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def _kernel_name(line: str) -> str:
    """A kernel's name and template arguments from ptxas's mangled name:
    a length-prefixed identifier ending in _kernel, then ints (ILi4ELi8E)
    and a type (f, 13__nv_bfloat16)."""
    for m in re.finditer(r"(?=(\d+)([a-z_][a-z0-9_]*))", line):
        name = m.group(2)[:int(m.group(1))]
        if len(name) == int(m.group(1)) and name.endswith("_kernel"):
            rest = line[m.start(2) + len(name):]
            # ILi4ELi8E (min-plus: INS_8GeometryILi96E..EELi4E), then a
            # type (13__nv_bfloat16, f)
            t = re.match(r"I?((?:Li\d+E)*)(13__nv_bfloat16|f)?", rest)
            args = re.findall(r"Li(\d+)E", rest.split("EEv")[0]) + (
                [{"f": "f32", "13__nv_bfloat16": "bf16"}[t.group(2)]]
                if t.group(2) else [])
            return name + (f"<{', '.join(args)}>" if args else "")
    return line.split("'")[1] if "'" in line else line.strip()


def build_phase() -> dict:
    """Builds the library; returns its SASS by kernel function."""
    phase("build")
    t0 = time.monotonic()
    log = build.build(force=True)
    # ptxas's summary, one line per kernel: registers, barriers, spills.
    kernel = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = _kernel_name(line)
        elif "Used" in line and kernel is not None:
            print(f"  {kernel:34s} {line.split(':', 1)[1].strip()}")
        elif "spill" in line and " 0 bytes spill stores" not in line:
            print(f"  {line.strip()}")
    print(f"build: {build.LIB_PATH.name} ({len(build.SOURCES)} sources) in "
          f"{time.monotonic() - t0:.2f} s")
    funcs = kt.sass_functions(kt.sass(build.LIB_PATH))
    print("  hot loops in the SASS (cuobjdump -sass of this build; "
          "instructions every warp issues a trip / relaxations or updates "
          "in it):")
    for parts, op, needs in ((("fw_counts_cluster_kernel",), "FMUL", ()),
                             (("fw_tiled_kernel",), "FMUL", ()),
                             (("minplus_kernel",), "FADD",
                              kt.MINPLUS_LOOP_NEEDS)):
        for f in sorted(x for x in funcs if all(p in x for p in parts)):
            n, k = kt.loop_issues(funcs[f], op, needs=needs)
            print(f"    {_kernel_name(f):34s} {n:5d} / {k:3d} = "
                  f"{n / k:.4f}")
    print("  the scans' hot loops (instructions every warp issues a trip / "
          "(step, state) or (step, channel) items a lane in it):")
    for loop, (fn, op, without) in kt.SCAN_LOOPS.items():
        for f in sorted(x for x in funcs if fn in x):
            n, k = kt.loop_issues(funcs[f], op, without)
            print(f"    {_kernel_name(f) + ' ' + loop.split()[-1]:34s} "
                  f"{n:5d} / {k:3d} = {n / k:.4f}")
    return funcs


def fw_issues(funcs: dict, kernel: str, B: int, V: int, dev
              ) -> tuple[str, float] | None:
    """The instance of ``kernel`` ("fw_counts" or "tiled") that a call at
    (B, V) launches and its instructions a relaxation (``loop_issues``);
    None for kernel 1's L2 path, which has no on-chip instance."""
    lib = build.load()
    if kernel == "tiled":
        n = lib.fw_counts_tiled_threads(B, V, dev.index or 0)
        name = kt.find_function(funcs, f"fw_tiled_kernelILi{n}EE")
        label = f"fw_tiled_kernel<{n}>"
    else:
        C = lib.fw_counts_cluster_size(V, B)
        if C == 0:
            return None
        rw, cc = fwc.instance(V, C)
        name = kt.find_function(
            funcs, f"fw_counts_cluster_kernelILi{rw}ELi{cc}EE")
        label = f"fw_counts_cluster_kernel<{rw}, {cc}>"
    n, k = kt.loop_issues(funcs[name], "FMUL")
    return label, n / k


def _max_err(pairs) -> float:
    return max(float((a - b).abs().max()) if a.numel() else 0.0
               for a, b in pairs)


def _require_equal(what: str, name: str, got, want) -> float:
    """Max abs error of ``got`` against ``want``; exits unless equal."""
    err = _max_err(zip(got, want))
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise SystemExit(f"{what} differs on {name} (max abs err {err})")
    return err


def _require_nan_equal(what: str, name: str, got, want) -> float:
    """``_require_equal`` NaN-aware (``testing.nan_equal``: NaN in the same
    places, equal values elsewhere); the error over the entries that are
    not NaN in either."""
    for a, b in zip(got, want):
        if not testing.nan_equal(a, b):
            raise SystemExit(f"{what} differs on {name}")
    return _max_err((torch.where(torch.isnan(a) | torch.isnan(b),
                                 torch.zeros_like(a), a),
                     torch.where(torch.isnan(a) | torch.isnan(b),
                                 torch.zeros_like(b), b))
                    for a, b in zip(got, want))


def parity_phase(dev) -> dict:
    worst = dict.fromkeys(KERNELS, 0.0)
    phase("parity: fw_counts kernel vs plain version (bitwise)")
    for name, make in testing.kernel_cases().items():
        W = torch.from_numpy(make()).to(dev)
        got = ops.fw_counts(W)
        torch.cuda.synchronize()
        worst["fw_counts"] = max(worst["fw_counts"], _require_equal(
            "fw_counts vs plain", name, got, plain.fw_counts_ref(W)))
        print(f"  {name:34s} equal")

    phase("parity: fw_counts_tiled kernel vs plain blocked FW, plain FW "
          "and fw_counts (bitwise)")
    for name, make in testing.tiled_cases(fwt.BT).items():
        W = torch.from_numpy(make()).to(dev)
        got = fwt.fw_counts_tiled(W)
        torch.cuda.synchronize()
        err = max(
            _require_equal("tiled vs plain tiled", name, got,
                           plain.fw_counts_tiled_ref(W, fwt.BT)),
            _require_equal("tiled vs plain FW", name, got,
                           plain.fw_counts_ref(W)),
            _require_equal("tiled vs fw_counts", name, got, ops.fw_counts(W)))
        worst["fw_counts_tiled"] = max(worst["fw_counts_tiled"], err)
        print(f"  {name:34s} equal to all three")

    phase("parity: minplus kernel vs plain version (bitwise, NaN-aware; "
          "with a fused C), apsp vs plain FW distances")
    rng = np.random.default_rng(0)
    for name, make in testing.minplus_cases().items():
        A, B = (torch.from_numpy(x).to(dev) for x in make())
        want = plain.minplus_ref(A, B)
        got = ops.minplus(A, B)
        C = torch.from_numpy((30 * rng.random(want.shape) - 5).astype(
            np.float32)).to(dev)
        C[0, 0] = float("nan")
        fused = ops.minplus(A, B, C)
        torch.cuda.synchronize()
        worst["minplus"] = max(worst["minplus"], _require_nan_equal(
            "minplus vs plain", name, [got], [want]),
            _require_nan_equal("minplus with C vs plain", name, [fused],
                               [plain.minplus_ref(A, B, C)]))
        print(f"  minplus {name:44s} equal (and with a fused C)")
    for cfg in ("baseline", "placeit"):
        W = torch.from_numpy(testing.score_graphs(APSP_ARCH, cfg, 1)[0])
        W = W.to(dev)
        worst["minplus"] = max(worst["minplus"], _require_equal(
            "apsp vs plain FW distances", f"{APSP_ARCH} {cfg}",
            [ops.apsp(W)], [plain.fw_counts_ref(W)[0]]))
        print(f"  apsp {APSP_ARCH} {cfg} V={W.shape[-1]:<22d} equal to the "
              f"plain FW's distances")
    return worst


def _bound(ops_n: float, bytes_n: float,
           peak_ops: float = PEAK_F32_OPS) -> tuple[float, str]:
    ops_s, bytes_s = ops_n / peak_ops, bytes_n / PEAK_BYTES
    return (1e3 * max(ops_s, bytes_s),
            "operations" if ops_s >= bytes_s else "bytes")


def fw_bound_ms(B: int, V: int) -> tuple[float, str]:
    return _bound(FW_OPS_PER_RELAXATION * B * V * (V - 1) ** 2,
                  3 * B * V * V * 4)


def fw_floor_ms(B: int, V: int, issues: float, rate: float) -> float:
    """The issue floor of B * V * (V - 1)^2 relaxations at ``issues``
    instructions each."""
    return 1e3 * B * V * (V - 1) ** 2 * issues / rate


def minplus_floor_ms(M: int, K: int, N: int, issues: float,
                     rate: float) -> float:
    return 1e3 * M * N * K * issues / rate


def minplus_bound_ms(M: int, K: int, N: int, dev) -> tuple[float, str]:
    """The larger of the instruction bound (``kt.minplus_bound_ms`` at the
    card's SMs and top SM clock) and the bytes, A, B and out once."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ops_ms = kt.minplus_bound_ms(M, K, N, sms, kt.max_sm_clock_hz())
    bytes_ms = 1e3 * (M * K + K * N + M * N) * 4 / PEAK_BYTES
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def minplus_flop_ms(M: int, K: int, N: int) -> float:
    """2 M N K operations at the 67 TFLOP/s float32 peak: out of reach for
    min-plus, whose add and min cannot pair as an FFMA's do."""
    return 1e3 * 2 * M * N * K / PEAK_F32_OPS


def _scorer_batch(arch_name: str, config: str) -> int:
    """The scorer's placements per FW call for this arch (default chunk
    16 after the clamp)."""
    arch = resolve_arch(arch_name, config)
    rep = make_rep(arch, arch_name)
    g = rep.score_graph(rep.random(np.random.default_rng(0)))
    return scorer_chunk(max_pair_elems(rep.layout), g.W.shape[-1],
                        g.edges.shape[0], 16)


def timing_phase(dev, worst: dict, funcs: dict) -> dict:
    """Times the kernels; every timed output must equal the plain
    version's, and its error is folded into ``worst``.  Issue floors
    come from ``funcs``, the SASS of this run's build."""
    rate = kt.issue_rate(dev)
    phase(f"timing: fw_counts vs fw_counts_tiled (the dispatch measurement; "
          f"batched_ms; outputs bitwise vs the plain FW; issue floors of "
          f"the instances launched at {rate:.4g} instructions/s; '-': "
          f"kernel 1's L2 path)")
    lib = build.load()
    shapes = [(f"random V={V}", 16,
               lambda V=V: testing.random_graph(V, 3 * V, seed=V, batch=16))
              for V in TIMED_SMALL_V]
    shapes += [(f"{a} {c}", B, lambda a=a, c=c, B=B: testing.score_graphs(
        a, c, B)) for B, a, c in TIMED]
    for a in testing.LARGE_ARCHS:
        for c in ("baseline", "placeit"):
            B = _scorer_batch(a, c)
            shapes.append((f"{a} {c}", B, lambda a=a, c=c, B=B:
                           testing.score_graphs(a, c, B)))
    rows = {}
    print(f"  {'shape':22s} {'B':>3s} {'V':>5s} {'C':>3s} {'fw_counts':>11s} "
          f"{'tiled':>10s} {'plain':>10s} {'bound':>9s} {'floor 1':>9s} "
          f"{'floor t':>9s}  dispatch (ms)")
    for name, B, make in shapes:
        W = torch.from_numpy(make()).to(dev)
        V = W.shape[-1]
        # Kernel 1's L2 path (V above its on-chip limit) takes up to 0.7 s
        # a call at V = 1536: one launch an event pair there.
        n = 1 if V > fwc.ONCHIP_MAX_V else 20 if V <= 216 else 5
        t, out = kt.batched_ms({"fw_counts": lambda: ops.fw_counts(W),
                                "tiled": lambda: fwt.fw_counts_tiled(W)},
                               launches=n, rounds=3 if n == 1 else 5)
        p, want = kt.median_ms({"p": lambda: plain.fw_counts_ref(W)}, reps=2)
        for k in ("fw_counts", "tiled"):
            kernel = "fw_counts_tiled" if k == "tiled" else k
            worst[kernel] = max(worst[kernel], _require_equal(
                f"timed {kernel} vs plain FW", name, out[k], want["p"]))
        t["plain"] = p["p"]
        t["bound"], t["bound_by"] = fw_bound_ms(B, V)
        for k, key in (("fw_counts", "floor"), ("tiled", "tiled_floor")):
            inst = fw_issues(funcs, k, B, V, dev)
            t[key] = inst and fw_floor_ms(B, V, inst[1], rate)
            t[key + "_of"] = inst
        t["B"], t["V"] = B, V
        t["cluster"] = lib.fw_counts_cluster_size(V, B)
        picked = "tiled" if ops.fw_takes_tiled(V) else "fw_counts"
        faster = min(("fw_counts", "tiled"), key=lambda k: t[k])
        rows[name] = t
        floor1 = "-" if t["floor"] is None else f"{t['floor']:.4f}"
        print(f"  {name:22s} {B:3d} {V:5d} {t['cluster']:3d} "
              f"{t['fw_counts']:11.4f} {t['tiled']:10.4f} {t['plain']:10.3f} "
              f"{t['bound']:9.4f} {floor1:>9s} {t['tiled_floor']:9.4f}  "
              f"{picked}"
              f"{'' if picked == faster else ' (the slower here)'}; equal")

    phase(f"timing: minplus (M = N = K = V) on a {APSP_ARCH} placeit and a "
          f"{MINPLUS_RAGGED_ARCH} baseline score graph, and apsp on the "
          f"first (outputs bitwise vs the plain versions; the instruction "
          f"bound, 2 M N K instructions at {kt.LANES_PER_SM} lanes a clock "
          f"an SM; the issue floor of the 16-byte steady-state loop)")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_mp, k_mp = kt.minplus_issues(
        funcs[kt.find_function(funcs, "minplus_kernel")])
    Ws = {}
    for key, arch, cfg in (("minplus", APSP_ARCH, "placeit"),
                           ("minplus ragged", MINPLUS_RAGGED_ARCH,
                            "baseline")):
        W = torch.from_numpy(testing.score_graphs(arch, cfg, 1)[0]).to(dev)
        V = W.shape[-1]
        Ws[key] = W
        p = mp.tile_fill(V, V, sms)
        copies = "16-byte" if V % 4 == 0 else "guarded 4-byte"
        print(f"  {key} V={V}: {mp.TILE[0]} x {mp.TILE[1]} tiles, "
              f"{mp.THREADS} threads, {copies} copies: {p['tiles']} tiles "
              f"on {sms} SMs, {p['resident']} block resident an SM, at most "
              f"{p['most']} on one SM: fill share {p['share']:.4f}")
        if key == "minplus" and p["share"] < 0.9:
            raise SystemExit(f"minplus at {V}^3 fills {p['share']:.4f} of "
                             f"the SMs (< 0.9)")
        t, out = kt.batched_ms({"kernel": lambda: ops.minplus(W, W)},
                               launches=20, rounds=5)
        pl, want = kt.median_ms({"p": lambda: plain.minplus_ref(W, W)},
                                reps=3)
        worst["minplus"] = max(worst["minplus"], _require_equal(
            "timed minplus vs plain", f"{arch} {cfg} W x W",
            [out["kernel"]], [want["p"]]))
        t["plain"] = pl["p"]
        t["bound"], t["bound_by"] = minplus_bound_ms(V, V, V, dev)
        t["flop_ms"] = minplus_flop_ms(V, V, V)
        t["issues"] = n_mp / k_mp if V % 4 == 0 else None
        t["floor"] = (minplus_floor_ms(V, V, V, n_mp / k_mp, rate)
                      if V % 4 == 0 else None)
        t["share"], t["V"] = p["share"], V
        rows[key] = t
    W = Ws["minplus"]
    V = W.shape[-1]
    n = plain.apsp_squarings(V)
    a, out = kt.batched_ms({"kernel": lambda: ops.apsp(W)}, launches=3,
                           rounds=5)
    p, want = kt.median_ms({"p": lambda: plain.apsp_ref(W)}, reps=2)
    worst["minplus"] = max(worst["minplus"], _require_equal(
        "timed apsp vs plain", f"{APSP_ARCH} placeit", [out["kernel"]],
        [want["p"]]))
    a["plain"] = p["p"]
    a["bound"], a["bound_by"] = n * rows["minplus"]["bound"], "operations"
    a["flop_ms"] = n * rows["minplus"]["flop_ms"]
    a["floor"] = n * rows["minplus"]["floor"]
    a["issues"], a["share"], a["V"] = (rows["minplus"]["issues"],
                                       rows["minplus"]["share"], V)
    rows["apsp"] = a
    for k in ("minplus", "minplus ragged", "apsp"):
        r = rows[k]
        floor = ("not counted (guarded copies)" if r["floor"] is None else
                 f"{r['floor']:.4f} ms ({r['issues']:.4f} instructions an "
                 f"update)")
        print(f"  {k} V={r['V']}: kernel {r['kernel']:.4f} ms, instruction "
              f"bound {r['bound']:.4f} ms ({r['bound_by']}; "
              f"{r['bound'] / r['kernel']:.4f} of it), issue floor "
              f"{floor}, fill share {r['share']:.4f}; 67 TFLOP/s figure "
              f"{r['flop_ms']:.4f} ms (unreachable: it counts an FFMA as two "
              f"operations); plain version {r['plain']:.3f} ms; library "
              f"call: none; output equal to the plain version's")
    return rows

# -- attention (slice 3) ----------------------------------------------------

def _on_card(arrays, dev, dtype=torch.bfloat16):
    return [torch.from_numpy(a).to(dev).to(dtype) for a in arrays]


def _require_close(what: str, name: str, got, want, rtol: float,
                   atol: float | None = None) -> tuple[float, float]:
    """Max abs error of ``got`` against ``want`` and the largest share of
    the limit an entry uses; exits unless every entry is within
    ``atol + rtol * |want|`` (``atol`` defaults to ``rtol``)."""
    atol = rtol if atol is None else atol
    g, w = got.float(), want.float()
    if not g.numel():
        return 0.0, 0.0
    diff = (g - w).abs()
    share = float((diff / (atol + rtol * w.abs())).max())
    err = float(diff.max())
    if share > 1:
        raise SystemExit(f"{what} differs on {name} beyond {atol} + {rtol} "
                         f"|plain| (max abs err {err}, {share:.3g} of the "
                         f"limit)")
    return err, share


# The decode kernel's log-sum-exp against the plain version's: -inf at the
# same rows (a row that sees no position), else within LSE_ATOL + LSE_RTOL
# |lse| (float32 sums of the same logits in another order, and exp2/log2
# where the plain version takes exp/log).
LSE_ATOL, LSE_RTOL = 1e-4, 1e-5


def _require_lse(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs error of a kernel's lse against the plain one's; exits
    unless the -inf rows agree and the rest lie within the limit."""
    inf = torch.isneginf(want)
    if not torch.equal(torch.isneginf(got), inf):
        raise SystemExit(f"{what}: the lse's -inf rows differ")
    if bool(inf.all()):
        return 0.0
    return _require_close(what, "lse", got[~inf], want[~inf], LSE_RTOL,
                          LSE_ATOL)[0]


def decode_lse_phase(dev) -> None:
    """Slice 18: the decode kernel's lse against the plain version's, and
    a cache cut into 2 and 4 pieces over its positions, each piece through
    the kernel with its local lengths and the pieces merged
    (``testing.decode_pieces``), against the uncut call, within row 5's
    case tolerances (``ATTN_TOL``), in float32 and bfloat16, on the decode
    cases and the edges of the kernel's split."""
    cases = {**testing.decode_cases(), **testing.decode_split_cases()}
    phase(f"parity, slice 18: decode_attention's lse vs the plain lse "
          f"({LSE_ATOL:g} + {LSE_RTOL:g} |lse|) and the cache cut into 2 "
          f"and 4 pieces, merged, vs the uncut call (allclose "
          f"{ATTN_TOL['decode_attention']}), {len(cases)} cases x 2 dtypes")
    worst = {"lse": 0.0, "pieces": 0.0}
    for name, make in cases.items():
        *ops_np, lens_np, kw = make()
        for dt in (torch.float32, torch.bfloat16):
            q, kc, vc = (torch.from_numpy(a).to(dev, dt) for a in ops_np)
            lens = torch.from_numpy(lens_np).to(dev)
            out, lse = tda.decode_attention(q, kc, vc, lens, **kw,
                                            return_lse=True)
            if not torch.equal(out, tda.decode_attention(q, kc, vc, lens,
                                                         **kw)):
                raise SystemExit(f"decode {name}: the output changes when "
                                 f"the kernel writes its lse")
            _, want = plain.decode_attention_ref(q, kc, vc, lens, **kw,
                                                 return_lse=True)
            worst["lse"] = max(worst["lse"], _require_lse(
                f"decode lse {name} {dt}", lse, want))
            tol = ATTN_TOL["decode_attention"][str(dt)[6:]]
            for n in (2, 4):
                got = testing.decode_pieces(tda.decode_attention, q, kc, vc,
                                            lens, n, **kw)
                worst["pieces"] = max(worst["pieces"], _require_close(
                    f"decode {name} {dt} in {n} pieces, merged", name, got,
                    out, tol)[0])
    torch.cuda.synchronize()
    print(f"  every case within tolerance: lse max abs err "
          f"{worst['lse']:.3g}, pieces merged vs uncut max abs err "
          f"{worst['pieces']:.3g}")


def attention_parity_phase(dev, worst: dict) -> None:
    phase("parity: flash_attention and decode_attention kernels vs plain "
          "versions (allclose: flash 2e-5, decode 3e-5 in float32; 2e-2 in "
          "bfloat16), the JAX tests' cases and the edges of the kernels' "
          "tiles and splits")
    flash_cases = {**testing.attention_cases(),
                   **testing.attention_tile_cases()}
    decode_cases = {**testing.decode_cases(), **testing.decode_split_cases()}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        tol = ATTN_TOL["flash_attention"][dtype]
        for name, make in flash_cases.items():
            *qkv, kw = make()
            q, k, v = _on_card(qkv, dev, dt)
            err, _ = _require_close("flash_attention vs plain", name,
                                    tfa.flash_attention(q, k, v, **kw),
                                    plain.attention_ref(q, k, v, **kw), tol)
            worst["flash_attention"] = max(worst["flash_attention"], err)
        tol = ATTN_TOL["decode_attention"][dtype]
        for name, make in decode_cases.items():
            *arrays, lens, kw = make()
            q, kc, vc = _on_card(arrays, dev, dt)
            lens = torch.from_numpy(lens).to(dev)
            err, _ = _require_close(
                "decode_attention vs plain", name,
                tda.decode_attention(q, kc, vc, lens, **kw),
                plain.decode_attention_ref(q, kc, vc, lens, **kw), tol)
            worst["decode_attention"] = max(worst["decode_attention"], err)
        print(f"  {dtype}: {len(flash_cases)} flash and {len(decode_cases)} "
              f"decode cases within tolerance (worst so far: flash "
              f"{worst['flash_attention']:.3g}, decode "
              f"{worst['decode_attention']:.3g})")


# The limit at the serve runs' shapes, scaled to the outputs.  There an
# output row averages hundreds to thousands of V rows (decode at S = 4096:
# RMS about 0.026), so the cases' fixed 2e-2 would pass a kernel that
# drops a tail tile.  Kernel and plain version compute in float32 from the
# same bfloat16 inputs and round once to bfloat16, so an entry may differ
# by one bfloat16 ulp, at most 2^-7 of its size; the limit allows two
# ulps, plus 1e-5 for outputs near 0 (float32 sums of terms below 4
# differ by well under 1e-6).  Measured on the H100 at qwen3-1.7b's
# shapes: flash 1.95e-3 at S = 2048 (one ulp of an output in
# [0.25, 0.5)), decode 3.05e-5.
FULL_RTOL, FULL_ATOL = 2.0 ** -6, 1e-5
FULL_LIMIT = f"|kernel - plain| <= {FULL_ATOL:g} + {FULL_RTOL:g} |plain|"
# The attention shapes of the serve runs, in bfloat16: each model's heads,
# window and soft-cap from its config, flash at B = 1 (prefill takes one
# request at a time) at its prompt lengths, decode at the 8-slot pool over
# the cache as the model hands it over.  qwen3-1.7b: 16 query heads on 8
# KV heads, head dim 128, a 4096-token cache.  recurrentgemma-9b's local
# attention: 16 query heads on 1 KV head, head dim 256, a 2048-token
# window; its prompts reach 3072 tokens, and its decode cache is a
# 2048-slot ring that the model passes with lengths clamped to 2048 and no
# window (``layers.attn_decode``).  moonshot-v1-16b-a3b: 16 on 16 heads of
# 128.  grok-1-314b: 48 on 8 heads of 128 (six queries a KV head) with
# logits soft-capped at 30, which no scaled_dot_product_attention call
# computes (no library time).  seamless-m4t-medium (16 on 16 heads of 64,
# ``ENCDEC_SERVE``'s run): the encoder bidirectional over 1024 frames, the
# decoder's cross-attention from a 48-token prompt to that memory
# (bidirectional, Sq < Sk) and its causal self-attention over the prompt;
# decode over the cross caches with every length mem_len = 1024 and over
# the self caches (4096 slots) with the lengths of its 64 tokens.  Slice
# 23: llava-next-34b (56 query heads on 8 KV heads of 128, seven a KV
# head) at its patch-prefix sequences, 576 patch rows plus a 48-token
# prompt (624, no multiple of a 64-row tile) and plus 2048;
# tinyllama-1.1b (32 on 4 of 64) and qwen2.5-3b (16 on 2 of 128), eight
# a KV head, at their longest served prompt.
ATTN_TIMED = (
    ("qwen3-1.7b", ((512, 512, True), (2048, 2048, True))),
    ("recurrentgemma-9b", ((2048, 2048, True), (3072, 3072, True))),
    ("moonshot-v1-16b-a3b", ((256, 256, True), (2048, 2048, True))),
    ("grok-1-314b", ((256, 256, True), (2048, 2048, True))),
    ("seamless-m4t-medium", ((1024, 1024, False), (48, 1024, False),
                             (48, 48, True))),
    ("llava-next-34b", ((624, 624, True), (2624, 2624, True))),
    ("tinyllama-1.1b", ((2048, 2048, True),)),
    ("qwen2.5-3b", ((2048, 2048, True),)))
SERVE_ATTN = ", ".join(arch for arch, _ in ATTN_TIMED)


def attention_shapes(arch: str) -> tuple[dict, int | None, float | None]:
    """(heads, window, soft-cap) of an arch's attention layers."""
    cfg = get_config(arch)
    heads = dict(Hq=cfg.n_heads, Hkv=cfg.n_kv_heads, d=cfg.hd)
    return heads, cfg.window or None, cfg.softcap


def decode_runs(arch: str) -> list[tuple[str, int, np.ndarray]]:
    """(label, cache length, lengths [B]) of each timed decode call: the
    cache as the model hands it over, every row full and with lengths from
    the seed; for the encoder-decoder model its cross caches (every length
    ``mem_len``) and its self caches (its tokens' lengths)."""
    B = SERVE_ENGINE.n_slots
    rng = np.random.default_rng(0)
    if arch == ENCDEC_ARCH:
        P, Se, T = (ENCDEC_SERVE[k] for k in ("prompt", "frames", "tokens"))
        return [(f"cross, every length mem_len {Se}", Se, np.full(B, Se)),
                (f"self, lengths from the seed in [{P}, {P + T - 1}]",
                 SERVE_ENGINE.cache_len, rng.integers(P, P + T, size=B))]
    _, window, _ = attention_shapes(arch)
    cache = SERVE_ENGINE.cache_len
    cache = min(cache, window) if window else cache
    return [(f"every length {cache}", cache, np.full(B, cache)),
            ("lengths from the seed", cache,
             rng.integers(1, cache + 1, size=B))]


def flash_bound_ms(B, Sq, Sk, Hq, Hkv, d, causal=True, window=None,
                   itemsize=2):
    """Causal (Sq = Sk): query i attends min(i + 1, window) keys;
    bidirectional: every query every key.  A soft-cap's tanh per logit is
    left out (at d = 128 it is under 1 % of the operations)."""
    if causal:
        assert Sq == Sk, "the causal bound is for Sq = Sk"
        pairs = int(np.minimum(np.arange(1, Sq + 1), window or Sq).sum())
    else:
        pairs = Sq * Sk
    return _bound(4 * B * Hq * d * pairs,
                  itemsize * d * (2 * B * Sq * Hq + 2 * B * Sk * Hkv),
                  PEAK_BF16_OPS)


def decode_bound_ms(B, Hq, Hkv, d, lengths, itemsize=2):
    """Only the valid K and V rows are read, plus q and the output."""
    rows = int(lengths.sum())
    return _bound(4 * rows * Hq * d,
                  itemsize * d * (2 * rows * Hkv + 2 * B * Hq),
                  PEAK_BF16_OPS)


def _attn_row(t: dict, out: dict, what: str, bound: tuple) -> dict:
    """Holds a timed output to ``FULL_LIMIT`` and completes its row."""
    err, share = _require_close(f"timed {what} vs plain", what,
                                out["kernel"], out["plain"], FULL_RTOL,
                                FULL_ATOL)
    t["bound"], t["bound_by"] = bound
    t["max_abs_err"], t["limit_share"] = err, share
    t["max_abs_out"] = float(out["plain"].float().abs().max())
    return t


def _attn_line(t: dict) -> str:
    masked = (f" (with a mask {t['library_masked']:.4f} ms)"
              if "library_masked" in t else "")
    lib = ("no sdpa call (soft-cap)" if t["library"] is None
           else f"sdpa {t['library']:.4f} ms{masked}")
    return (f"kernel {t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, {lib}, "
            f"bound {t['bound']:.4f} ms ({t['bound_by']}), "
            f"{t['bound'] / t['kernel']:.4f} of bound; max abs err vs plain "
            f"{t['max_abs_err']:.3g} (max |out| {t['max_abs_out']:.3g}; "
            f"{t['limit_share']:.3f} of the limit)")


# Calls between one pair of CUDA events when timing the attention kernels.
ATTN_LAUNCHES = 20


def attention_timing_phase(dev, worst: dict) -> dict:
    """Times the attention kernels at the serve runs' shapes in bfloat16
    (``kernel_timing.batched_ms``); every timed output is held to
    ``FULL_LIMIT`` against the plain version's.  The yardstick
    (``library``) is the fastest ``scaled_dot_product_attention`` call
    that computes the same function: ``is_causal=True`` where causal flash
    has no window, no mask where flash is bidirectional or every decode
    row is full, else a boolean mask; the masked call is also timed beside
    the first two (``library_masked``).  None where the logits are
    soft-capped."""
    F = torch.nn.functional
    rows = {}
    for arch, flash_shapes in ATTN_TIMED:
        heads, window, softcap = attention_shapes(arch)
        phase(f"timing: flash_attention at {arch} prefill shapes (bf16, "
              f"window {window}, soft-cap {softcap}; outputs {FULL_LIMIT})")
        for Sq, Sk, causal in flash_shapes:
            shape = dict(B=1, Sq=Sq, Sk=Sk, **heads)
            kw = dict(causal=causal, window=window, softcap=softcap)
            q, k, v = _on_card(testing.attention_operands(**shape, seed=Sq),
                               dev)
            q_s, k_s, v_s = (x.transpose(1, 2) for x in (q, k, v))
            fns = {"kernel": lambda: tfa.flash_attention(q, k, v, **kw),
                   "plain": lambda: plain.attention_ref(q, k, v, **kw)}
            if softcap is None and not causal:
                fns["library"] = lambda: F.scaled_dot_product_attention(
                    q_s, k_s, v_s, enable_gqa=True)
            elif softcap is None:
                pos = torch.arange(Sq, device=dev)
                mask = pos[None] <= pos[:, None]
                if window:
                    mask &= pos[None] > pos[:, None] - window
                fns["library_masked"] = (
                    lambda: F.scaled_dot_product_attention(
                        q_s, k_s, v_s, attn_mask=mask, enable_gqa=True))
                if window is None:
                    fns["library"] = lambda: F.scaled_dot_product_attention(
                        q_s, k_s, v_s, is_causal=True, enable_gqa=True)
            t, out = kt.batched_ms(fns, launches=ATTN_LAUNCHES, rounds=5)
            if "library" not in t:
                t["library"] = t.pop("library_masked", None)
            label = (f"S={Sq}" if causal else
                     f"Sq={Sq} Sk={Sk} bidirectional")
            t = _attn_row(t, out, f"flash_attention {arch} {label}",
                          flash_bound_ms(**shape, causal=causal,
                                         window=window))
            worst["flash_attention"] = max(worst["flash_attention"],
                                           t["max_abs_err"])
            rows[f"flash {arch} {label}"] = t
            print(f"  B=1 Sq={Sq:5d} Sk={Sk:5d} causal={causal} {heads}: "
                  f"{_attn_line(t)}")

        B = SERVE_ENGINE.n_slots
        phase(f"timing: decode_attention at {arch}'s decode shapes (bf16, "
              f"B={B}, soft-cap {softcap}; outputs {FULL_LIMIT})")
        for label, cache, lens in decode_runs(arch):
            q, kc, vc, lens_np = testing.decode_operands(
                B, cache, **heads, lengths=lens, seed=1)
            q, kc, vc = _on_card((q, kc, vc), dev)
            lens = torch.from_numpy(lens_np).to(dev)
            mask = torch.arange(cache, device=dev)[None] < lens[:, None]
            q_s, k_s, v_s = (q[:, :, None], kc.transpose(1, 2),
                             vc.transpose(1, 2))
            fns = {
                "kernel": lambda: tda.decode_attention(q, kc, vc, lens,
                                                       softcap=softcap),
                "kernel_lse": lambda: tda.decode_attention(
                    q, kc, vc, lens, softcap=softcap, return_lse=True),
                "plain": lambda: plain.decode_attention_ref(
                    q, kc, vc, lens, softcap=softcap)}
            full = bool((lens_np == cache).all())
            if softcap is None:
                fns["library_masked"] = (
                    lambda: F.scaled_dot_product_attention(
                        q_s, k_s, v_s, attn_mask=mask[:, None, None],
                        enable_gqa=True))
            if softcap is None and full:
                fns["library"] = lambda: F.scaled_dot_product_attention(
                    q_s, k_s, v_s, enable_gqa=True)
            t, out = kt.batched_ms(fns, launches=ATTN_LAUNCHES, rounds=7)
            if "library" not in t:
                t["library"] = t.pop("library_masked", None)
            t = _attn_row(t, out, f"decode_attention {arch} {label}",
                          decode_bound_ms(B, **heads, lengths=lens_np))
            if not torch.equal(out["kernel_lse"][0], out["kernel"]):
                raise SystemExit(f"decode {arch} {label}: the output "
                                 f"changes when the kernel writes its lse")
            _, want_lse = plain.decode_attention_ref(
                q, kc, vc, lens, softcap=softcap, return_lse=True)
            _require_lse(f"timed decode {arch} {label}",
                         out["kernel_lse"][1], want_lse)
            worst["decode_attention"] = max(worst["decode_attention"],
                                            t["max_abs_err"])
            rows[f"decode {arch} {label}"] = t
            print(f"  B={B} S={cache} ({label}, {int(lens_np.sum())} valid "
                  f"rows): {_attn_line(t)}; with the lse written "
                  f"{t['kernel_lse']:.4f} ms")
    return rows


# -- the scans (slice 4) ----------------------------------------------------

# The scan kernels' tolerances on ``testing.scan_cases``: float32 the JAX
# tests' 3e-5 (fused multiply-adds, another order over the states);
# bfloat16 outputs 2e-2, as the attention cases (kernel and plain version
# sum in float32 and round once).  The float32 final states 3e-5 in both.
SCAN_TOL = {"float32": 3e-5, "bfloat16": 2e-2}
STATE_TOL = 3e-5
# The serve runs' prefill shapes at full width, B = 1: falcon-mamba-7b's
# d_inner 8192 with N = 16 (x and y in bfloat16, dt and the rest float32,
# as models/ssm.py hands them over) and recurrentgemma-9b's d_rnn 4096
# (x, a and h in bfloat16).
SCAN_TIMED_S = (512, 2048)
SSCAN_FULL = dict(Di=8192, N=16)
RGLRU_FULL = dict(D=4096)
# The SMs' special-function units issue 16 results a clock each (exp2,
# rsqrt); the scans need one such a step and state (exp) or channel
# (sqrt).
SFU_PER_CLOCK_PER_SM = 16


def sfu_rate(dev) -> float:
    """Special-function results a second: 16 a clock on each of the card's
    SMs at its highest SM clock, from nvidia-smi (the bound takes the
    fastest the units can run)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    clock_hz = float(smi.stdout.split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return SFU_PER_CLOCK_PER_SM * sms * clock_hz


def scan_bound_ms(flops: float, sfu_ops: float, bytes_n: float,
                  sfu_per_s: float) -> tuple[float, str]:
    """The larger of bytes over the memory rate, float32 operations over
    the float32 peak, and special-function operations over the SFUs'
    rate; both of the latter are "operations"."""
    ops_s = max(flops / PEAK_F32_OPS, sfu_ops / sfu_per_s)
    bytes_s = bytes_n / PEAK_BYTES
    return (1e3 * max(ops_s, bytes_s),
            "operations" if ops_s >= bytes_s else "bytes")


def sscan_bound_ms(B, S, Di, N, x_item, dt_item, sfu_per_s):
    """Per (step, channel): dt * x and D * x + the sum (3), and per state
    dt * A, dtx * B, the update's and the sum's multiply-adds (6 float
    operations) and one exp.  x, dt, A, B, C, D and h0 read once; y and
    h_final written once."""
    return scan_bound_ms(
        B * S * Di * (3 + 6 * N), B * S * Di * N,
        B * S * Di * (2 * x_item + dt_item) + 4 * (Di * N + 2 * B * S * N
                                                   + Di + 2 * B * Di * N),
        sfu_per_s)


def rglru_bound_ms(B, S, D, item, sfu_per_s):
    """Per (step, channel): a * a, 1 - that, the max, the product with x
    and the multiply-add (6 float operations) and one square root.  x and
    a read once, every h written once, h0 read and h_final written."""
    return scan_bound_ms(B * S * D * 6, B * S * D,
                         B * S * D * 3 * item + 2 * 4 * B * D, sfu_per_s)


# Each scan's wrapper and plain version.
SCAN_FNS = {"selective_scan": (ops.selective_scan, plain.selective_scan_ref),
            "rglru_scan": (ops.rglru_scan, plain.rglru_ref)}


def _scan_call(kernel: str, args):
    """(kernel output, plain output) of one scan on the same operands."""
    fn, ref_fn = SCAN_FNS[kernel]
    return fn(*args), ref_fn(*args)


def scan_parity_phase(dev, worst: dict) -> None:
    phase("parity: selective_scan and rglru_scan kernels vs plain versions "
          "(allclose: 3e-5 in float32, 2e-2 in bfloat16; final states 3e-5; "
          "a sequence split across two calls equals one call)")
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for name, make in testing.scan_cases().items():
            kernel = "selective_scan" if name.startswith("selective") else \
                "rglru_scan"
            args = [None if a is None else torch.from_numpy(a).to(dev)
                    for a in make()]
            args[0], args[1] = args[0].to(dt), args[1].to(dt)
            (y, h), (yw, hw) = _scan_call(kernel, args)
            err_y, _ = _require_close(f"{kernel} vs plain", name, y, yw,
                                      SCAN_TOL[dtype])
            err_h, _ = _require_close(f"{kernel} final state vs plain",
                                      name, h, hw, STATE_TOL)
            worst[kernel] = max(worst[kernel], err_y, err_h)
            if "S=130" in name:
                # The same sequence in two calls, the state carried over.
                cut = 45
                seq = (0, 1, 3, 4) if kernel == "selective_scan" else (0, 1)
                first = [a[:, :cut] if i in seq else a
                         for i, a in enumerate(args)]
                rest = [a[:, cut:] if i in seq else a
                        for i, a in enumerate(args)]
                (y1, h1), _ = _scan_call(kernel, first)
                rest[-1] = h1
                (y2, h2), _ = _scan_call(kernel, rest)
                _require_equal(f"{kernel} split in two calls vs one call",
                               name, [torch.cat([y1, y2], 1), h2], [y, h])
        print(f"  {dtype}: {len(testing.scan_cases())} cases within "
              f"tolerance, the two S = 130 sequences split at step 45 equal "
              f"to one call (worst so far: selective_scan "
              f"{worst['selective_scan']:.3g}, rglru_scan "
              f"{worst['rglru_scan']:.3g})")


def scan_timing_phase(dev, worst: dict, funcs: dict) -> dict:
    """Times the scan kernels at the serve runs' prefill shapes; every
    timed output is held to ``FULL_LIMIT``, the final state to
    ``STATE_TOL``, against the plain version's.  Issue floors come from
    ``funcs``, the SASS of this run's build (``kt.scan_issues``)."""
    sfu = sfu_rate(dev)
    issues = kt.scan_issues(funcs)
    rows = {}
    phase(f"timing: selective_scan and rglru_scan at the serve runs' prefill "
          f"shapes (outputs {FULL_LIMIT}, final states {STATE_TOL:g}; bound "
          f"with the SFUs at the card's max SM clock, {sfu:.4g} results/s)")
    for kernel in ("selective_scan", "rglru_scan"):
        for S in SCAN_TIMED_S:
            args = kt.scan_serve_operands(kernel, S, dev)
            fn, ref_fn = SCAN_FNS[kernel]
            t, out = kt.batched_ms({"kernel": lambda: fn(*args)},
                                   launches=20, rounds=5)
            p, want = kt.median_ms({"plain": lambda: ref_fn(*args)}, reps=3)
            t["plain"] = p["plain"]
            (y, h), (yw, hw) = out["kernel"], want["plain"]
            err, share = _require_close(f"timed {kernel} vs plain", f"S={S}",
                                        y, yw, FULL_RTOL, FULL_ATOL)
            err_h, _ = _require_close(f"timed {kernel} final state vs plain",
                                      f"S={S}", h, hw, STATE_TOL)
            worst[kernel] = max(worst[kernel], err, err_h)
            if kernel == "selective_scan":
                shape = f"B=1 S={S} Di={SSCAN_FULL['Di']} N={SSCAN_FULL['N']}"
                t["bound"], t["bound_by"] = sscan_bound_ms(
                    1, S, **SSCAN_FULL, x_item=2, dt_item=4, sfu_per_s=sfu)
                width = SSCAN_FULL["Di"]
            else:
                shape = f"B=1 S={S} D={RGLRU_FULL['D']}"
                t["bound"], t["bound_by"] = rglru_bound_ms(
                    1, S, **RGLRU_FULL, item=2, sfu_per_s=sfu)
                width = RGLRU_FULL["D"]
            floors = kt.scan_floors_ms(issues, 1, S, width, kernel, dev)
            t["floor"] = max(floors.values())
            floor_text = ", ".join(f"{k} {v:.4f} ms"
                                   for k, v in floors.items())
            t["max_abs_err"], t["limit_share"] = err, share
            t["max_abs_out"] = float(yw.float().abs().max())
            rows[f"{kernel} S={S}"] = t
            print(f"  {kernel} {shape}: kernel {t['kernel']:.4f} ms, plain "
                  f"{t['plain']:.3f} ms, library call: none, bound "
                  f"{t['bound']:.4f} ms ({t['bound_by']}), "
                  f"{t['bound'] / t['kernel']:.4f} of bound; issue floor "
                  f"{floor_text}; max abs err vs "
                  f"plain {err:.3g} (max |out| {t['max_abs_out']:.3g}; "
                  f"{share:.3f} of the limit), final state {err_h:.3g}")
    return rows


# -- the scans' backward (slice 14) ------------------------------------------

# Each backward's wrapper, plain version, forward module and the names of
# its gradients.
SCAN_BWD = {
    "selective_scan_bwd": (tsb.selective_scan_bwd,
                           plain.selective_scan_bwd_ref, tss,
                           ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")),
    "rglru_scan_bwd": (trb.rglru_scan_bwd, plain.rglru_bwd_ref, trg,
                       ("dx", "da", "dh0"))}


def _scan_bwd_check(kernel: str, name: str, got, want, which: str
                    ) -> tuple[float, float, dict]:
    """Max abs error and largest share of ``testing.SCAN_BWD_LIMITS``
    [which] over a backward's gradients, and each gradient's share; raises
    past the limit."""
    err = share = 0.0
    shares = {}
    for g, w, what in zip(got, want, SCAN_BWD[kernel][3]):
        e, sh = testing.scan_bwd_share(g, w, which)
        if not sh <= 1.0:
            raise SystemExit(f"{kernel} {what} vs plain on {name}: max abs "
                             f"err {e:.3g}, {sh:.3f} of "
                             f"{testing.scan_bwd_limit(which, g.dtype)}")
        err, share = max(err, e), max(share, sh)
        shares[what] = sh
    return err, share, shares


def scan_bwd_parity_phase(dev, worst: dict) -> None:
    phase(f"parity: selective_scan_bwd and rglru_scan_bwd kernels vs plain "
          f"versions (selective_scan_bwd_ref, rglru_bwd_ref) on every scan "
          f"case in both dtypes, with a seeded dh_final (and without one "
          f"where the case has h0): "
          f"{testing.scan_bwd_limit('cases', torch.float32)}, bfloat16 "
          f"gradients {testing.scan_bwd_limit('cases', torch.bfloat16)}; "
          f"two calls bit for bit")
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        share = 0.0
        for i, (name, make) in enumerate(testing.scan_cases().items()):
            kernel = ("selective_scan_bwd" if name.startswith("selective")
                      else "rglru_scan_bwd")
            fn, ref_fn, fwd, _ = SCAN_BWD[kernel]
            args = [None if a is None else torch.from_numpy(a).to(dev)
                    for a in make()]
            args[0], args[1] = args[0].to(dt), args[1].to(dt)
            rng = np.random.default_rng(i)
            dy = torch.from_numpy(rng.standard_normal(
                tuple(args[0].shape), dtype=np.float32)).to(dev).to(dt)
            state = tuple(args[0].shape[::2]) + (
                tuple(args[2].shape[1:]) if kernel == "selective_scan_bwd"
                else ())
            dhf = torch.from_numpy(rng.standard_normal(
                state, dtype=np.float32)).to(dev)
            states = fwd._launch(*fwd._on_card(*args), states=True)[2]
            for dh in (dhf, None) if args[-1] is not None else (dhf,):
                got = fn(*args, dy, dh, states=states)
                again = fn(*args, dy, dh, states=states)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise SystemExit(f"{kernel} is not repeatable on {name}")
                want = ref_fn(*args, dy, dh)
                e, sh, _ = _scan_bwd_check(kernel, name, got, want,
                                           "cases")
                worst[kernel] = max(worst[kernel], e)
                share = max(share, sh)
        print(f"  {dtype}: {len(testing.scan_cases())} cases within the "
              f"limit ({share:.3f} of it at most), repeatable (worst so "
              f"far: selective_scan_bwd {worst['selective_scan_bwd']:.3g}, "
              f"rglru_scan_bwd {worst['rglru_scan_bwd']:.3g})")


def scan_bwd_timing_phase(dev, worst: dict) -> dict:
    """Times the scans' backward kernels at the training shapes
    (``kernel_timing.SCAN_TRAIN``: falcon-mamba-7b's B = 2, recurrentgemma-
    9b's B = 1, S = 4096), from the states the forward kernel writes for
    them, beside their bounds and the plain versions; every timed output
    held to ``testing.SCAN_BWD_LIMITS["training"]`` and to one more call's,
    bit for bit, and the share of the limit each gradient uses printed.
    The forward with and without those states is timed in the same
    call."""
    sfu = sfu_rate(dev)
    rows = {}
    for kernel, fwd_name in (("selective_scan_bwd", "selective_scan"),
                             ("rglru_scan_bwd", "rglru_scan")):
        fn, ref_fn, fwd, _ = SCAN_BWD[kernel]
        shape = kt.SCAN_TRAIN[fwd_name]
        phase(f"timing: {kernel} at its training shape ({shape}, x in "
              f"bf16; {testing.scan_bwd_limit('training', torch.float32)}, "
              f"bfloat16 gradients "
              f"{testing.scan_bwd_limit('training', torch.bfloat16)})")
        args, dy, dhf = kt.scan_train_operands(fwd_name, dev)
        on_card = fwd._on_card(*args)
        t, out = kt.batched_ms({
            "forward": lambda: fwd._launch(*on_card),
            "forward with states": lambda: fwd._launch(*on_card,
                                                       states=True)},
            launches=5, rounds=3)
        states = out["forward with states"][2]
        tk, outk = kt.batched_ms({"kernel": lambda: fn(
            *args, dy, dhf, states=states)}, launches=5, rounds=3)
        t.update(tk)
        p, want = kt.median_ms({"plain": lambda: ref_fn(*args, dy, dhf)},
                               reps=1, warmup=0)
        t["plain"] = p["plain"]
        got = outk["kernel"]
        err, share, shares = _scan_bwd_check(
            kernel, "its training shape", got, want["plain"], "training")
        again = fn(*args, dy, dhf, states=states)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise SystemExit(f"{kernel} is not repeatable at its training "
                             f"shape")
        worst[kernel] = max(worst[kernel], err)
        if kernel == "selective_scan_bwd":
            work = kt.sscan_bwd_work(**shape, x_item=2, dt_item=4)
        else:
            work = kt.rglru_bwd_work(**shape, item=2)
        t["bound"], t["bound_by"] = scan_bound_ms(*work, sfu)
        t["library"] = None
        t["max_abs_err"], t["limit_share"] = err, share
        t["limit_shares"] = shares
        rows[kernel] = t
        print(f"  kernel {t['kernel']:.4f} ms, plain {t['plain']:.3f} ms, "
              f"library call: none, bound {t['bound']:.4f} ms "
              f"({t['bound_by']}: {work[0]:.4g} float operations, "
              f"{work[1]:.4g} special-function results, {work[2]:.4g} "
              f"bytes), {t['bound'] / t['kernel']:.4f} of bound; the "
              f"forward {t['forward']:.4f} ms, with the states "
              f"{t['forward with states']:.4f} ms; max abs err vs plain "
              f"{err:.3g} ({share:.3f} of the limit); repeatable")
        print("  share of the limit by gradient: " + ", ".join(
            f"{g} {v:.3f}" for g, v in shares.items()))
        del got, again, want, out, outk, states
        gc.collect()
        torch.cuda.empty_cache()
    return rows


# -- the LM serving paths (slices 3 and 4) ----------------------------------

SERVE_ENGINE = EngineConfig(n_slots=8, cache_len=4096, eos=-1)
SERVE_REQUESTS, SERVE_MAX_TOKENS = 16, 64
# Each serve run: the arch, its prompt lengths (drawn from seed 0) and its
# depth (None: the published depth).  recurrentgemma-9b's prompts reach
# 3072 tokens, past its 2048-token window, so its local-attention caches
# ring in prefill and in decode.  The MoE models (slice 16): moonshot at
# its full 48 layers (28.06 B parameters, 56.1 GB in bf16, and a 12.9 GB
# KV cache), grok-1 at 4 of its 64 (21.3 B parameters, 42.6 GB: the full
# model's 316 B parameters cannot fit on one card).  Slice 23: qwen2.5-3b
# (3.40 B parameters) and tinyllama-1.1b (1.10 B) at full depth, and
# llava-next-34b at its full 60 layers: 34.41 B parameters, 68.8 GB in
# bf16, and a 8.05 GB KV cache (8 KV heads x 128 x 2 x 2 B x 60 layers a
# token, 8 x 4096 tokens), so the card holds it with a few GiB to spare;
# its requests are text-only, as the reference's engine takes them, and
# its patch prefix runs after (``vlm_serve_phase``).
SERVE_RUNS = (
    ("qwen3-1.7b", (256, 2048), None),
    ("falcon-mamba-7b", (256, 2048), None),
    ("recurrentgemma-9b", (256, 3072), None),
    ("moonshot-v1-16b-a3b", (256, 2048), None),
    ("grok-1-314b", (256, 2048), 4),
    ("qwen2.5-3b", (256, 2048), None),
    ("tinyllama-1.1b", (256, 2048), None),
    ("llava-next-34b", (256, 2048), None),
)
# Request 0's decode-step logits against a re-prefill of (prompt + token
# 1), both in bfloat16 on the card, may differ by this many bfloat16 ulps
# of the largest logit.  The two paths round differently: another
# attention kernel or, for the recurrent layers, the plain one-token step
# against the scan kernel (and, in recurrentgemma's prefill, a and the
# gated input rounded to bfloat16 as the reference does), a few ulps after
# all layers.  qwen3-1.7b: logits up to 4.94, so 4 x 2^-5 = 0.125 (0.0869
# measured on an NVIDIA H100 80GB HBM3 at 700 W).  For a recurrent model
# the check must also fail a decode step whose recurrent states were
# zeroed (a hand-off that loses the prefill's final state).  An MoE model
# is checked on a dropless copy of its config (capacity factor E / K, so
# that every expert has a slot for every token): a prefill at capacity
# may drop the last token where the decode step (one slot an expert)
# never drops, which is the reference's semantics, not an error.  Where
# two experts tie for the token's K-th place within the two paths'
# rounding, the paths may choose differently, and the swap changes every
# later layer's input (``moe_consistency_check``): the decode step is run
# again with its routing pinned to the re-prefill's in at most MOE_PINS
# such layers, each swap one pair of experts whose margin and whose
# probabilities in the two paths lie within CONSISTENCY_ULPS bfloat16 ulps
# of the pair's probability, and those logits are held to
# CONSISTENCY_ULPS, the unpinned ones to MOE_UNPINNED_ULPS.
# moonshot-v1-16b-a3b's request 0 on an NVIDIA H100 80GB HBM3 at 700 W:
# 4 pins (layers 19, 25, 29 and 34, each within 3.6 ulps), unpinned
# 0.2246 at logits up to 4.62 (7.2 ulps; 0.0986 with one swap before
# the RoPE table was the reference's), pinned 0.0547.
CONSISTENCY_ULPS = 4
MOE_PINS = 4
MOE_UNPINNED_ULPS = 8
PROFILE_PREFILL = 1024
# Decode ticks under the profiler: two give the busy share and the
# kernels' split.  Each tick's events cost the host time to process after
# the profile (the headers put 55.6 s between moonshot-v1-16b-a3b's
# profile of 8 ticks and the next run); ``profile_calls`` prints it.
PROFILE_TICKS = 2


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 values (8 significant bits) at |x|."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def serve_phase(dev, arch: str, prompt: tuple,
                layers: int | None) -> tuple[dict, tuple]:
    """One serve run at full width (``layers`` deep, or the published
    depth), with the counts set to 0 just before it and read just after;
    returns the launch counts and (model, engine, prompt lengths) for the
    profile."""
    full = get_config(arch)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          n_layers=layers)
    phase(f"main path: {arch} at full width, {cfg.n_layers} of its "
          f"{full.n_layers} layers, through ServeEngine on the card")
    t0 = time.monotonic()
    model = LM(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    draw_qkv_biases(model, 1)
    torch.cuda.synchronize()
    n_params = model.param_count()
    print(f"  {cfg.name}: {n_params / 1e9:.4f} B parameters "
          f"({2 * n_params / 1e9:.2f} GB in bf16), {cfg.n_layers} layers "
          f"{cfg.layer_plan()}, d_model {cfg.d_model}, {cfg.dtype}, "
          f"initialised from torch.Generator seed 0 in "
          f"{time.monotonic() - t0:.2f} s; memory allocated "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    eng = ServeEngine(model, SERVE_ENGINE)
    # One short request first, so that the run below finds cuBLAS and the
    # allocator warm; then the engine's counters start from zero.
    eng.submit(Request(-1, np.arange(3, 35, dtype=np.int32), max_tokens=2))
    eng.run()
    eng.stats = dict.fromkeys(eng.stats, 0)
    rng = np.random.default_rng(0)
    lens = rng.integers(prompt[0], prompt[1] + 1, size=SERVE_REQUESTS)
    reqs = [Request(i, rng.integers(3, cfg.vocab, size=int(n)).astype(
        np.int32), max_tokens=SERVE_MAX_TOKENS) for i, n in enumerate(lens)]
    for r in reqs:
        eng.submit(r)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.monotonic()
    ticks = eng.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches, plain_calls = read_counts()
    st = eng.stats
    ttft = statistics.median(r.t_first - t0 for r in reqs)
    print(f"  {len(reqs)} requests, prompts {int(lens.min())}-"
          f"{int(lens.max())} tokens ({int(lens.sum())} in all), "
          f"{SERVE_MAX_TOKENS} tokens each; {SERVE_ENGINE.n_slots} slots, "
          f"cache {SERVE_ENGINE.cache_len}")
    print(f"  wall {wall:.3f} s, {ticks} ticks; prefill "
          f"{st['prefill_tokens']} tokens in {st['prefill_s']:.3f} s "
          f"({st['prefill_tokens'] / st['prefill_s']:.1f} tokens/s); decode "
          f"{st['decode_tokens']} tokens in {st['decode_s']:.3f} s "
          f"({st['decode_tokens'] / st['decode_s']:.1f} tokens/s, "
          f"{1e3 * st['decode_s'] / ticks:.2f} ms per tick); time to first "
          f"token median {ttft:.3f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB of "
          f"{torch.cuda.get_device_properties(dev).total_memory / 2**30:.2f}"
          )
    # Every prefill launches one flash call per attention layer (an MoE
    # layer has one) and one scan per recurrent layer; every tick one
    # decode call per attention layer (the recurrent layers' one-token
    # step is plain tensor code, as in the reference).
    n = leaf_kinds(cfg)
    n_attn = n["attn"] + n["lattn"] + n["moe"]
    expected = dict.fromkeys(KERNELS, 0)
    expected.update(flash_attention=n_attn * len(reqs),
                    decode_attention=n_attn * ticks,
                    selective_scan=n["mamba"] * len(reqs),
                    rglru_scan=n["rec"] * len(reqs))
    print("  launches: " + ", ".join(
        f"{k} {launches[k]} (expected {expected[k]})" for k in KERNELS
        if expected[k] or launches[k]) + f"; plain calls {plain_calls}")
    if not all(r.done and len(r.out_tokens) == SERVE_MAX_TOKENS
               for r in reqs):
        raise SystemExit(f"the {arch} serve run left requests unfinished")
    if not all(0 <= t < cfg.vocab_padded for r in reqs
               for t in r.out_tokens):
        raise SystemExit(f"the {arch} serve run emitted tokens out of range")
    if launches != expected or plain_calls != 0:
        raise SystemExit(f"the {arch} serve run did not go through its "
                         f"kernels alone")
    if n["moe"]:
        print_expert_bytes(cfg, 1e3 * st["decode_s"] / ticks)
    consistency_check(model, reqs[0], dev)
    return launches, (model, eng, lens)


# The QKV biases' draw (qwen2.5-3b): the reference initialises them to
# zero, which would leave their add unseen on the served and compared
# models; normals of this size move each projection's output by about
# half its own size (the projections' outputs are about unit normals).
QKV_BIAS_STD = 0.5


def draw_qkv_biases(model: LM, seed: int) -> None:
    """Fills every attention layer's ``bq``, ``bk`` and ``bv`` (a
    ``cfg.qkv_bias`` model's) with normals from ``seed`` times
    ``QKV_BIAS_STD``, in the model's dtype; other models are left as
    they are."""
    if not model.cfg.qkv_bias:
        return
    gen = torch.Generator(model.device).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, Attention):
            for b in (m.bq, m.bk, m.bv):
                b.data.copy_(QKV_BIAS_STD * torch.randn(
                    b.shape, generator=gen, device=model.device))


def print_expert_bytes(cfg, tick_ms: float) -> None:
    """A decode tick runs every expert of every MoE layer on its one slot
    (capacity 1, the reference's function), so it reads all their
    weights: printed beside that read's time at the HBM rate."""
    n = leaf_kinds(cfg)["moe"]
    nbytes = n * 3 * cfg.n_experts * cfg.d_model * cfg.d_ff * 2
    print(f"  decode reads every expert each tick: {n} MoE layers x 3 x "
          f"{cfg.n_experts} x {cfg.d_model} x {cfg.d_ff} bf16 = "
          f"{nbytes / 1e9:.2f} GB a tick, {1e3 * nbytes / PEAK_BYTES:.3f} "
          f"ms at {PEAK_BYTES / 1e12:.2f} TB/s, against {tick_ms:.2f} ms "
          f"a tick measured")


def _zero_states(tree: dict) -> None:
    """Zeroes every recurrent state (``h`` of a mamba or RG-LRU cache) in
    a group's cache tree."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _zero_states(v)
        elif k == "h":
            v.zero_()


def _negate_lambda(model: LM) -> None:
    """Lambda -> -Lambda in every RG-LRU block.  The reference's
    a = exp(-c softplus(Lambda) r), at its init (sigmoid(Lambda)^c in
    (0.9, 0.999)), lies below e^-16 for most r, so h barely carries; with
    -Lambda, a = sigmoid(Lambda)^(c r), the Griffin paper's decay."""
    for m in model.modules():
        if isinstance(m, RGLRU):
            m.rg_lambda.data.neg_()


def _decode_vs_reprefill(model: LM, ext, dev, extra: dict | None = None,
                         recurrent: bool = True,
                         capacity_factor: float | None = None,
                         keep: dict | None = None,
                         cache_len: int | None = None
                         ) -> tuple[float, float, float | None]:
    """For the last token of ``ext``: the largest re-prefill logit and the
    max abs error of the decode step's logits against it, from the
    prefill's caches as they are and (``recurrent``) with their recurrent
    states zeroed.  ``extra`` holds an encoder-decoder model's prefill
    ``src_embeds`` and decode ``mem_len``, or a VLM's ``patch_embeds``,
    which both prefills put in front of the tokens (the decode step's
    length counts them); ``capacity_factor`` is the prefills'
    (``LM.prefill``).  ``keep``, where given, receives the re-prefill's
    logits, the caches and the decode step's batch.  The caches are
    ``cache_len`` long (the serve runs' by default)."""
    extra = extra or {}
    pre_extra = {k: v for k, v in extra.items()
                 if k in ("src_embeds", "patch_embeds")}
    n_front = (extra["patch_embeds"].shape[1] if "patch_embeds" in extra
               else 0)
    L = cache_len or SERVE_ENGINE.cache_len
    pre, _ = model.prefill({"tokens": ext, **pre_extra}, L, capacity_factor)
    _, caches = model.prefill({"tokens": ext[:, :-1], **pre_extra}, L,
                              capacity_factor)
    runs = [caches]
    if recurrent:
        runs.append([tree_map(torch.clone, c) for c in caches])
        for c in runs[1]:
            _zero_states(c)
    batch = {"tokens": ext[:, -1:], "lengths": torch.tensor(
        [n_front + ext.shape[1] - 1], dtype=torch.int32, device=dev),
        **{k: v for k, v in extra.items() if k == "mem_len"}}
    errs = []
    for c in runs:
        dec = model.decode_step(batch, c)
        if not (torch.isfinite(dec).all() and torch.isfinite(pre).all()):
            raise SystemExit(f"non-finite logits in {model.cfg.name}")
        errs.append(float((dec - pre).abs().max()))
    if keep is not None:
        keep.update(pre=pre, caches=caches, batch=batch)
    return float(pre.abs().max()), errs[0], errs[1] if recurrent else None


def consistency_check(model: LM, r0, dev) -> None:
    """Request 0's second token: the decode step's logits against a
    re-prefill of (prompt + first token), within ``CONSISTENCY_ULPS``.  A
    recurrent model's check must also fail with the states zeroed; a
    griffin model is held with Lambda negated, where its states carry (as
    served, the zeroed reading is printed only)."""
    cfg = model.cfg
    n = leaf_kinds(cfg)
    recurrent = n["mamba"] + n["rec"] > 0
    ext = torch.as_tensor(np.concatenate([r0.prompt, r0.out_tokens[:1]])[
        None], dtype=torch.long, device=dev)
    if n["moe"]:
        moe_consistency_check(model, ext, dev)
        return
    for negated in (False, True) if n["rec"] else (False,):
        label = "with Lambda negated" if negated else "as served"
        held = negated or not n["rec"]
        if negated:
            _negate_lambda(model)
        top, err, err_lost = _decode_vs_reprefill(model, ext, dev,
                                                  recurrent=recurrent)
        if negated:
            _negate_lambda(model)
        tol = CONSISTENCY_ULPS * bf16_ulp(top)
        lost = (f"; states zeroed {err_lost:.4f}"
                + ("" if held else " (not held: they barely carry)")
                if recurrent else "")
        print(f"  consistency {label}, request 0 (prompt {len(r0.prompt)}): "
              f"decode-step logits vs re-prefill max abs err {err:.4f} "
              f"(logits up to {top:.2f}; tolerance {CONSISTENCY_ULPS} bf16 "
              f"ulps there, {tol:g}){lost}")
        if err > tol:
            raise SystemExit(f"the {cfg.name} decode step disagrees with a "
                             f"re-prefill ({label})")
        if recurrent and held and err_lost <= tol:
            raise SystemExit(f"the {cfg.name} consistency check does not see "
                             f"zeroed recurrent states ({label})")


def moe_consistency_check(model: LM, ext, dev) -> None:
    """The consistency check of an MoE model with dropless prefills
    (capacity factor E / K, ``LM.prefill``'s argument): the logits within
    ``CONSISTENCY_ULPS``.  Prints, for the last token, how far the two
    paths' router probabilities lie apart, in how many layers they chose
    the same experts, the smallest gap between its K-th and (K+1)-th
    router probability, and each layer where the paths chose differently.
    The routing is read by a forward hook on each MoE block, which routes
    the block's input again (the same function on the same input).

    Where two experts tie for the token's K-th place within the paths'
    rounding, the paths may choose differently (the reference's
    semantics), and a swap changes every later layer's input, so that
    later near-ties may swap too.  Then the unpinned logits are held to
    ``MOE_UNPINNED_ULPS``, and the pinned ones (``_pinned_decode``) to
    ``CONSISTENCY_ULPS``."""
    cfg = model.cfg
    seen = []

    def record(m, args, out):
        x = args[0]
        h = tmoe.rms_norm(x, m.norm, cfg.norm_eps)
        probs, _, eidx = tmoe.route(m, h, cfg)
        seen.append((eidx[0, -1].clone(), probs[0, -1].clone()))

    hooks = [m.register_forward_hook(record) for m in model.modules()
             if isinstance(m, tmoe.MoE)]
    keep: dict = {}
    try:
        top, err, _ = _decode_vs_reprefill(
            model, ext, dev, recurrent=False,
            capacity_factor=cfg.n_experts / cfg.top_k, keep=keep)
    finally:
        for hk in hooks:
            hk.remove()
    n = leaf_kinds(cfg)["moe"]
    if len(seen) != 3 * n:
        raise SystemExit(f"the {cfg.name} consistency check saw {len(seen)} "
                         f"MoE calls, not 3 x {n}")
    pre, dec = seen[:n], seen[2 * n:]
    K = cfg.top_k
    margins, deltas, flips = [], [], []
    for i, ((e_pre, p_pre), (e_dec, p_dec)) in enumerate(zip(pre, dec)):
        v = p_pre.sort(descending=True).values
        margins.append(float(v[K - 1] - v[K]))
        deltas.append(float((p_pre - p_dec).abs().max()))
        if not torch.equal(e_pre.sort().values, e_dec.sort().values):
            flips.append(i)
    tol = CONSISTENCY_ULPS * bf16_ulp(top)
    print(f"  consistency, dropless copy (capacity factor "
          f"{cfg.n_experts / cfg.top_k:g}), request 0 (prompt "
          f"{ext.shape[1] - 1}): the token's router probabilities in the "
          f"two paths differ by at most {max(deltas):.3g}; its chosen "
          f"experts equal in {n - len(flips)} of {n} layers (smallest "
          f"top-{K} margin {min(margins):.3g})" + "".join(
              f"; layer {i} swaps (top-{K} margin {margins[i]:.3g}, paths "
              f"{deltas[i]:.3g} apart)" for i in flips))
    print(f"  decode-step logits vs re-prefill max abs err {err:.4f} "
          f"(logits up to {top:.2f}; tolerance {CONSISTENCY_ULPS} bf16 ulps "
          f"there, {tol:g}" + (f"; unpinned {MOE_UNPINNED_ULPS}, "
                              f"{MOE_UNPINNED_ULPS * bf16_ulp(top):g})"
                              if flips else ")"))
    if flips:
        if err > MOE_UNPINNED_ULPS * bf16_ulp(top):
            raise SystemExit(f"the {cfg.name} decode step disagrees with a "
                             f"re-prefill beyond {MOE_UNPINNED_ULPS} ulps")
        err, pins = _pinned_decode(model, keep, pre)
        print(f"  with the decode step's routing pinned to the re-prefill's "
              f"in {len(pins)} of at most {MOE_PINS} layers, each swap a "
              f"near-tie given the pins before it ({'; '.join(pins)}): max "
              f"abs err {err:.4f}")
    if err > tol:
        raise SystemExit(f"the {cfg.name} decode step disagrees with a "
                         f"re-prefill")


def _near_tie(pre: tuple, got: tuple, i: int) -> tuple[str, bool]:
    """Layer ``i``'s swap between the re-prefill's routing ``pre`` and the
    decode step's ``got`` (each (experts, probabilities) of the token):
    its printout, and whether it is a near-tie, one pair of experts whose
    margin in the re-prefill and whose probabilities' differences between
    the paths all lie within ``CONSISTENCY_ULPS`` bfloat16 ulps of the
    re-prefill's probability of the expert it chose."""
    (e_pre, p_pre), (e_dec, p_dec) = pre, got
    out = sorted(set(e_pre.tolist()) - set(e_dec.tolist()))
    inn = sorted(set(e_dec.tolist()) - set(e_pre.tolist()))
    if len(out) != 1:
        return f"layer {i}: experts {out} for {inn}", False
    a, b = out[0], inn[0]
    ulp = bf16_ulp(float(p_pre[a]))
    margin = float(p_pre[a] - p_pre[b])
    da = float((p_pre[a] - p_dec[a]).abs())
    db = float((p_pre[b] - p_dec[b]).abs())
    worst = max(abs(margin), da, db)
    return (f"layer {i}: expert {b} for {a}, margin {margin:.3g}, the paths "
            f"{da:.3g} / {db:.3g} apart, {worst / ulp:.2f} bf16 ulps of "
            f"{float(p_pre[a]):.4g}"), worst <= CONSISTENCY_ULPS * ulp


def _pinned_decode(model: LM, keep: dict, pre: list) -> tuple[float, list]:
    """The decode step of ``keep``'s batch on its caches (``keep`` from
    ``_decode_vs_reprefill``: attention caches, whose new slot each step
    writes again) with the token's routing pinned to the re-prefill's
    (``pre``: each MoE layer's experts and probabilities) in the first
    layer where the two differ, read from the run with the pins before it,
    again until none differs.  Fails where a swap is no near-tie
    (``_near_tie``) or where more than ``MOE_PINS`` layers would be
    pinned.  Returns the pinned step's max abs error against the
    re-prefill's logits and each pinned swap's printout."""
    cfg = model.cfg
    raw = tmoe.route
    pins: dict = {}
    notes = []
    while True:
        got = []

        def route(p, h, c):
            probs, gates, eidx = raw(p, h, c)
            i = len(got)
            got.append((eidx[0, -1].clone(), probs[0, -1].clone()))
            if i in pins:
                e = pins[i]
                v = probs[0, -1, e]
                gates, eidx = gates.clone(), eidx.clone()
                gates[0, -1] = v / v.sum().clamp(min=1e-9)
                eidx[0, -1] = e
            return probs, gates, eidx

        tmoe.route = route
        try:
            logits = model.decode_step(keep["batch"], keep["caches"])
        finally:
            tmoe.route = raw
        swapped = [i for i, ((e_pre, _), (e_dec, _)) in
                   enumerate(zip(pre, got)) if i not in pins and not
                   torch.equal(e_pre.sort().values, e_dec.sort().values)]
        if not swapped:
            return float((logits - keep["pre"]).abs().max()), notes
        i = swapped[0]
        text, tie = _near_tie(pre[i], got[i], i)
        if not tie:
            raise SystemExit(f"the {cfg.name} decode step routes otherwise "
                             f"than a re-prefill beyond rounding ({text})")
        if len(pins) == MOE_PINS:
            raise SystemExit(f"the {cfg.name} decode step swaps near-ties in "
                             f"more than {MOE_PINS} layers ({text})")
        pins[i] = pre[i][0]
        notes.append(text)


def print_moe_shares(prof, total_ms: float, moe_layers: int) -> None:
    """Each MoE piece's ranges in a profile (``models.moe.RANGES``, forward
    passes only): the device time of the kernels launched in them and its
    share of the profile's device kernel time, and the ranges' span on the
    device's timeline (idle gaps included).  Exits if a model of
    ``moe_layers`` MoE layers left no range in its profile."""
    kernels, span = {}, {}
    for e in prof.key_averages():
        if e.key in tmoe.RANGES:
            to = (span if e.device_type == torch.autograd.DeviceType.CUDA
                  else kernels)
            to[e.key] = to.get(e.key, 0.0) + e.device_time_total / 1e3
    if not kernels:
        raise SystemExit(f"a profile of a model with {moe_layers} MoE layers "
                         f"holds no MoE range")
    print("  MoE block (forward ranges; kernel time): " + ", ".join(
        f"{name[4:]} {kernels.get(name, 0.0):.3f} ms "
        f"({100 * kernels.get(name, 0.0) / max(total_ms, 1e-9):.2f} %; span "
        f"{span.get(name, 0.0):.3f} ms)" for name in tmoe.RANGES))


def profile_calls(label: str, calls, moe_layers: int = 0) -> None:
    """torch.profiler over each (what, fn) of ``calls`` after one warm
    call: the wall, the device kernel time and busy share, an MoE model's
    pieces (``print_moe_shares``) and the largest kernels."""
    from torch.profiler import ProfilerActivity, profile
    for what, fn in calls:
        phase(f"profile: {label} {what}")
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        rows, total = _kernel_times(prof)
        print(f"  wall {1e3 * wall:.3f} ms under the profiler, device kernel "
              f"time {total:.3f} ms ({100 * total / 1e3 / wall:.2f} % busy); "
              f"the profile processed in "
              f"{time.monotonic() - t0 - wall:.2f} s")
        if moe_layers:
            print_moe_shares(prof, total, moe_layers)
        for name, ms, n in rows[:8]:
            print(f"  {ms:10.3f} ms {n:6d} x  {name[:90]}")


def serve_profile_phase(dev, state: tuple) -> None:
    """torch.profiler over one prefill of ``PROFILE_PREFILL`` tokens and
    over ``PROFILE_TICKS`` decode ticks of the full pool (lengths: the
    serve run's first 8 prompts)."""
    model, eng, lens = state
    cfg = model.cfg
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        3, cfg.vocab, size=(1, PROFILE_PREFILL)), dtype=torch.long,
        device=dev)
    batch = {"tokens": torch.as_tensor(np.random.default_rng(2).integers(
        3, cfg.vocab, size=(SERVE_ENGINE.n_slots, 1)), device=dev),
        "lengths": torch.as_tensor(lens[:SERVE_ENGINE.n_slots],
                                   dtype=torch.int32, device=dev)}
    profile_calls(cfg.name, (
        (f"one prefill of {PROFILE_PREFILL} tokens", lambda: model.prefill(
            {"tokens": toks}, SERVE_ENGINE.cache_len)),
        (f"{PROFILE_TICKS} decode ticks of the {SERVE_ENGINE.n_slots}-slot "
         f"pool", lambda: [model.decode_step(batch, eng.caches)
                           for _ in range(PROFILE_TICKS)])),
        leaf_kinds(cfg)["moe"])


# Slice 23: the VLM's patch-prefix path on the served model, once its
# engine (and the engine's caches) is freed, through LM.prefill and
# greedy LM.decode_step (the reference's ServeEngine takes no
# patch_embeds): B rows in one prefill, each the model's 576 patch rows
# (float32 normals from seed 0, in bf16) in front of a prompt of
# ``prompt`` tokens from seed 0, so that every sequence is 624 rows long,
# then ``steps`` decode steps at lengths 624 + t.
VLM_SERVE = dict(B=8, prompt=48, steps=64)


def vlm_serve_phase(dev, model: LM) -> dict:
    """The patch-prefix serve run (``VLM_SERVE``), with the counts set to
    0 just before it and read just after: exactly one flash launch a
    layer (the prefill) and one decode launch a layer a step, no plain
    call, tokens in range, and row 0's first decode step against a
    re-prefill of (prompt + its first token) with the patch rows in front
    of both, within ``CONSISTENCY_ULPS``.  Returns the launches."""
    cfg = model.cfg
    B, P, T = (VLM_SERVE[k] for k in ("B", "prompt", "steps"))
    Pf = cfg.n_frontend_tokens
    phase(f"main path, slice 23: {cfg.name}'s patch prefix at full width, "
          f"{cfg.n_layers} layers, through LM.prefill and LM.decode_step: "
          f"{B} rows in one prefill, each {Pf} patch rows and a {P}-token "
          f"prompt (sequence {Pf + P}), then {T} greedy decode steps")
    L = SERVE_ENGINE.cache_len
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        3, cfg.vocab, size=(B, P)), dtype=torch.long, device=dev)
    patches = torch.randn(B, Pf, cfg.d_model, device=dev,
                          generator=torch.Generator(dev).manual_seed(0)).to(
                              torch.bfloat16)

    def serve(steps: int) -> tuple:
        t0 = time.monotonic()
        logits, caches = model.prefill({"tokens": prompts,
                                        "patch_embeds": patches}, L)
        out = [logits.argmax(-1).tolist()]
        t1 = time.monotonic()
        lengths = torch.full((B,), Pf + P, dtype=torch.int32, device=dev)
        for _ in range(steps):
            tok = torch.as_tensor(out[-1], device=dev)[:, None]
            logits = model.decode_step({"tokens": tok, "lengths": lengths},
                                       caches)
            out.append(logits.argmax(-1).tolist())
            lengths += 1
        return np.array(out).T, t1 - t0, time.monotonic() - t1

    serve(1)                            # warm cuBLAS and the allocator
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    reset_counts()
    toks, pre_s, dec_s = serve(T)
    torch.cuda.synchronize()
    launches, plain_calls = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    n_attn = leaf_kinds(cfg)["attn"]
    expected = dict.fromkeys(KERNELS, 0)
    expected.update(flash_attention=n_attn, decode_attention=n_attn * T)
    print(f"  prefill {B * P} tokens behind {B * Pf} patch rows ({B * (Pf + P)}"
          f" rows) in {pre_s:.3f} s ({B * (Pf + P) / pre_s:.1f} rows/s); "
          f"decode {B * T} tokens in {dec_s:.3f} s ({B * T / dec_s:.1f} "
          f"tokens/s, {1e3 * dec_s / T:.2f} ms per step); peak device memory "
          f"{peak / 2**30:.2f} GiB of {total / 2**30:.2f}")
    print("  launches: " + ", ".join(
        f"{k} {launches[k]} (expected {expected[k]})" for k in KERNELS
        if expected[k] or launches[k]) + f"; plain calls {plain_calls}")
    if toks.shape != (B, T + 1) or not ((0 <= toks)
                                        & (toks < cfg.vocab_padded)).all():
        raise SystemExit(f"the {cfg.name} patch-prefix run emitted "
                         f"{toks.shape} tokens or tokens out of range")
    if launches != expected or plain_calls != 0:
        raise SystemExit(f"the {cfg.name} patch-prefix run did not go "
                         f"through its kernels alone")
    ext = torch.cat([prompts[:1], torch.as_tensor(toks[:1, :1],
                                                  device=dev)], dim=1)
    top, err, _ = _decode_vs_reprefill(
        model, ext, dev, {"patch_embeds": patches[:1]}, recurrent=False)
    tol = CONSISTENCY_ULPS * bf16_ulp(top)
    print(f"  consistency, row 0 ({Pf} patch rows, prompt {P}): decode-step "
          f"logits vs re-prefill max abs err {err:.4f} (logits up to "
          f"{top:.2f}; tolerance {CONSISTENCY_ULPS} bf16 ulps there, "
          f"{tol:g})")
    if err > tol:
        raise SystemExit(f"the {cfg.name} decode step after the patch "
                         f"prefix disagrees with a re-prefill")
    return launches


def serve_all_phase(dev) -> dict:
    """Each serve run, then its profile (and a VLM's patch-prefix run, or
    a bounded-state model's long_500k cell, on its model, the engine
    freed); each model is freed before the next one is built.  Returns the
    launches summed over the runs."""
    total = dict.fromkeys(KERNELS, 0)
    for arch, prompt, layers in SERVE_RUNS:
        launches, state = serve_phase(dev, arch, prompt, layers)
        serve_profile_phase(dev, state)
        model = state[0]
        del state
        gc.collect()
        torch.cuda.empty_cache()
        if model.cfg.frontend == "patch":
            for k, n in vlm_serve_phase(dev, model).items():
                launches[k] += n
        if arch in LONG_ARCHS and layers is None:
            for k, n in long_cell_phase(dev, model).items():
                launches[k] += n
        del model
        gc.collect()
        torch.cuda.empty_cache()
        for k, n in launches.items():
            total[k] += n
    return total


# -- slice 24: the long_500k cells ------------------------------------------

# The long_500k shape (``configs.registry.SHAPES``: 524 288 positions at
# B = 1, decode), which ``eligible_shapes`` gives the bounded-state archs
# alone: falcon-mamba-7b and recurrentgemma-9b.
LONG = SHAPES["long_500k"]
LONG_ARCHS = tuple(a for a in sorted(ARCHS)
                   if "long_500k" in eligible_shapes(a))
# The cell's serve run: one slot, ``cache_len`` the shape's length, one
# prompt and LONG_TOKENS tokens.  The engine retires a request whose length
# reaches cache_len - 1 (the reference's rule), so a prompt of cache_len -
# LONG_TOKENS is the longest that yields them all; its last tick decodes
# at position 524 286.  Its length comes from LM.prefill's peak measured
# at LONG_SIZING tokens and extrapolated (linear in the prompt): that
# prompt where the card holds it with LONG_HEADROOM to spare, else the
# largest power of two that fits.
LONG_TOKENS = 16
LONG_ENGINE = EngineConfig(n_slots=1, cache_len=LONG.seq_len, eos=-1)
LONG_SIZING = (32_768, 65_536)
LONG_HEADROOM = 4 * 2**30
# The decode at the cell's last positions (``long_decode_check``): two
# rows at these lengths on caches drawn from a seed, LONG_DECODE_STEPS
# steps, as tests/test_torch_long_decode.py decodes on the CPU.
LONG_DECODE_LENGTHS = (524_287, 524_280)
LONG_DECODE_STEPS = 4
# The kernels at the cell's sizes (``long_kernels_phase``): the last
# LONG_TAIL steps (queries) go through the plain versions, from the state
# the kernel hands on; the whole length in LONG_PIECES calls, each handed
# the last one's final state, equals one call bit for bit.
LONG_TAIL = 2048
LONG_PIECES = 4


def rope_table_phase(dev) -> None:
    """The card's RoPE table (``layers.rope_freq``) against the CPU's, and
    against numpy's float64 power of the float32 exponent rounded once,
    for each arch's (half, theta): every entry bit for bit."""
    phase("parity, slice 24: the RoPE frequency table of each arch on the "
          "card (layers.rope_freq: the exponent -i / half in float32, the "
          "power in float64, rounded once to float32) vs the CPU's and "
          "numpy's, bit for bit")
    pairs = sorted({(get_config(a).hd // 2, get_config(a).rope_theta)
                    for a in ARCHS})
    differ = 0
    for half, theta in pairs:
        card = rope_freq(half, theta, dev).cpu().numpy()
        cpu = rope_freq(half, theta, "cpu").numpy()
        e = -np.arange(half, dtype=np.float32) / np.float32(half)
        ref64 = (np.float64(theta) ** e.astype(np.float64)).astype(
            np.float32)
        n = int((card.view(np.uint32) != cpu.view(np.uint32)).sum()
                + (cpu.view(np.uint32) != ref64.view(np.uint32)).sum())
        differ += n
        print(f"  half {half}, theta {theta:g}: {n} of {half} entries "
              f"differ")
    print(f"  {len(pairs)} (half, theta) pairs of the {len(ARCHS)} archs: "
          f"{differ} entries differ")
    if differ:
        raise SystemExit("the card's RoPE table differs from the CPU's")


def _event_ms(fn):
    """(fn(), the device ms between two events around it)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def _long_scan(kernel: str, seq: tuple, args: list, worst: dict,
               bound: tuple) -> str:
    """One call of a scan over the whole length; the same in LONG_PIECES
    calls, each handed the last one's final state, bit for bit; and the
    last LONG_TAIL steps through the plain version from the state the
    kernel hands on there.  ``seq`` are the indices of the operands that
    run along the sequence; ``args`` end with h0 (None).  Returns the
    printout."""
    fn, ref_fn = SCAN_FNS[kernel]
    S = args[0].shape[1]

    def cut(lo, hi, h):
        return [a[:, lo:hi] if i in seq else a
                for i, a in enumerate(args[:-1])] + [h]

    (y, h), ms = _event_ms(lambda: fn(*args))
    edges = [S * i // LONG_PIECES for i in range(LONG_PIECES + 1)]
    hp, piece_ms = None, []
    for lo, hi in zip(edges, edges[1:]):
        h_in = hp
        (yp, hp), t = _event_ms(lambda: fn(*cut(lo, hi, h_in)))
        _require_equal(f"{kernel} in {LONG_PIECES} calls vs one call",
                       f"steps {lo}-{hi}", [yp], [y[:, lo:hi]])
        piece_ms.append(t)
        del yp
    _require_equal(f"{kernel} in {LONG_PIECES} calls vs one call",
                   "final state", [hp], [h])
    # The state entering the tail, from the state entering the last piece.
    y_mid, h_mid = fn(*cut(edges[-2], S - LONG_TAIL, h_in))
    del y_mid
    (yt, ht), plain_ms = _event_ms(
        lambda: ref_fn(*cut(S - LONG_TAIL, S, h_mid)))
    err_y, share = _require_close(f"{kernel} vs plain", "the last steps",
                                  y[:, S - LONG_TAIL:], yt, FULL_RTOL,
                                  FULL_ATOL)
    err_h, _ = _require_close(f"{kernel} final state vs plain",
                              "the last steps", h, ht, STATE_TOL)
    worst[kernel] = max(worst[kernel], err_y, err_h)
    return (f"one call {ms:.3f} ms (bound {bound[0]:.3f}, {bound[1]}); "
            f"{LONG_PIECES} calls "
            f"{' + '.join(f'{t:.3f}' for t in piece_ms)} ms, equal bit for "
            f"bit; the last {LONG_TAIL} steps vs the plain version "
            f"({plain_ms:.1f} ms) from the handed-on state: max abs err "
            f"{err_y:.3g} ({share:.3f} of {FULL_LIMIT}), final state "
            f"{err_h:.3g}")


def long_kernels_phase(dev, worst: dict) -> None:
    """The kernels of the long_500k cells at the cell's full length and
    width, on seeded inputs: the selective scan at falcon-mamba-7b's
    [1, 524 288, 8192] (N = 16; 2^32 elements), the RG-LRU scan at
    recurrentgemma-9b's [1, 524 288, 4096] and flash attention at its
    local attention's q [1, 524 288, 16, 256] (window 2048; the config's
    ``q_chunk`` is 0, so ``sdpa_train`` sends the whole length in one
    call).  Each call's ms; the plain versions take only the tails."""
    S = LONG.seq_len
    phase(f"parity, slice 24: the scans and flash attention at the "
          f"long_500k length ({S} steps, full width, seeded inputs): one "
          f"call vs {LONG_PIECES} calls handing on the state (bit for "
          f"bit), the last {LONG_TAIL} steps or queries vs the plain "
          f"version ({FULL_LIMIT}; states {STATE_TOL:g})")
    g = torch.Generator(device=dev).manual_seed(24)
    bf16 = torch.bfloat16
    fcfg, rcfg = get_config("falcon-mamba-7b"), get_config("recurrentgemma-9b")
    Di, N = fcfg.d_inner, fcfg.ssm_state
    # falcon-mamba's prefill hands the scan u in bf16, dt (a softplus) and
    # B, C in float32; A = -exp(A_log) at the S4D-real init.
    x = torch.randn(1, S, Di, generator=g, device=dev, dtype=bf16)
    dt = torch.randn(1, S, Di, generator=g, device=dev)
    dt.sub_(3.0).exp_().log1p_()
    A = -torch.arange(1, N + 1, dtype=torch.float32, device=dev).repeat(
        Di, 1)
    Bm = torch.randn(1, S, N, generator=g, device=dev)
    Cm = torch.randn(1, S, N, generator=g, device=dev)
    D = torch.ones(Di, device=dev)
    sfu = sfu_rate(dev)
    out = _long_scan("selective_scan", (0, 1, 3, 4),
                     [x, dt, A, Bm, Cm, D, None], worst,
                     sscan_bound_ms(1, S, Di, N, 2, 4, sfu))
    print(f"  selective_scan [1, {S}, {Di}], N = {N}: {out}")
    del x, dt, Bm, Cm
    torch.cuda.empty_cache()
    R = rcfg.d_rnn_
    # recurrentgemma's prefill hands the scan a and the gated input in
    # bf16; a in (0.5, 1).
    a = (torch.rand(1, S, R, generator=g, device=dev) * 0.5 + 0.4995).to(
        bf16)
    x = torch.randn(1, S, R, generator=g, device=dev, dtype=bf16)
    out = _long_scan("rglru_scan", (0, 1), [x, a, None], worst,
                     rglru_bound_ms(1, S, R, 2, sfu))
    print(f"  rglru_scan [1, {S}, {R}]: {out}")
    del x, a
    torch.cuda.empty_cache()
    H, Hkv, d, w = rcfg.n_heads, rcfg.n_kv_heads, rcfg.hd, rcfg.window
    q = torch.randn(1, S, H, d, generator=g, device=dev, dtype=bf16)
    k = torch.randn(1, S, Hkv, d, generator=g, device=dev, dtype=bf16)
    v = torch.randn(1, S, Hkv, d, generator=g, device=dev, dtype=bf16)
    o, ms = _event_ms(lambda: ops.flash_attention(q, k, v, causal=True,
                                                  window=w))
    checks = []
    for lo in (0, S - LONG_TAIL):
        want = plain.attention_ref(q[:, lo:lo + LONG_TAIL],
                                   k[:, max(lo - w, 0):lo + LONG_TAIL],
                                   v[:, max(lo - w, 0):lo + LONG_TAIL],
                                   causal=True, window=w)
        err, share = _require_close("flash_attention vs plain",
                                    f"queries {lo}-{lo + LONG_TAIL}",
                                    o[:, lo:lo + LONG_TAIL], want,
                                    FULL_RTOL, FULL_ATOL)
        worst["flash_attention"] = max(worst["flash_attention"], err)
        checks.append(f"queries {lo}-{lo + LONG_TAIL} max abs err "
                      f"{err:.3g} ({share:.3f} of the limit)")
    bound, by = flash_bound_ms(1, S, S, H, Hkv, d, window=w)
    print(f"  flash_attention q [1, {S}, {H}, {d}], k and v [1, {S}, "
          f"{Hkv}, {d}], causal, window {w}, in one call "
          f"(q_chunk {rcfg.q_chunk}): {ms:.3f} ms (bound {bound:.3f}, "
          f"{by}); vs the plain version: {'; '.join(checks)}")
    del q, k, v, o
    torch.cuda.empty_cache()


def _long_prompt(dev, model: LM, toks: np.ndarray) -> tuple[int, str]:
    """The prompt's length: LM.prefill's peak measured at LONG_SIZING
    tokens, extrapolated linearly, and the longest candidate that leaves
    LONG_HEADROOM of the card: the whole cell less its tokens, else the
    largest power of two.  Returns it and the sizing's printout."""
    held = torch.cuda.memory_allocated(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    peaks, rates = [], []
    for S in LONG_SIZING:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        batch = {"tokens": torch.as_tensor(toks[None, :S], dtype=torch.long,
                                           device=dev)}
        logits, caches = model.prefill(batch, LONG.seq_len)
        torch.cuda.synchronize()
        rates.append(S / (time.monotonic() - t0))
        peaks.append(torch.cuda.max_memory_allocated(dev) - held)
        del logits, caches, batch
    gc.collect()
    torch.cuda.empty_cache()
    slope = (peaks[1] - peaks[0]) / (LONG_SIZING[1] - LONG_SIZING[0])

    def need(S: int) -> float:
        return held + peaks[0] + slope * (S - LONG_SIZING[0])

    whole = LONG.seq_len - LONG_TOKENS
    cands = [whole] + [2 ** k for k in range(18, 15, -1)]
    fit = [S for S in cands if need(S) <= total - LONG_HEADROOM]
    if not fit:
        raise SystemExit(f"no long_500k prompt of {model.cfg.name} fits")
    S = fit[0]
    why = ("the whole cell less its tokens" if S == whole else
           f"the whole cell ({whole}) would need {need(whole) / 2**30:.2f} "
           f"GiB, so the largest power of two that fits")
    text = (f"  sizing: LM.prefill's peak above the weights "
            f"{peaks[0] / 2**30:.3f} / {peaks[1] / 2**30:.3f} GiB at "
            f"{LONG_SIZING[0]} / {LONG_SIZING[1]} tokens ({rates[0]:.0f} / "
            f"{rates[1]:.0f} tokens/s), {slope * 1024 / 2**20:.2f} MiB a "
            f"thousand tokens; weights {held / 2**30:.2f} GiB of "
            f"{total / 2**30:.2f}; predicted {need(S) / 2**30:.2f} GiB at "
            f"{S} tokens; prompt {S}: {why}")
    return S, text


def _plain_decode(model: LM, batch: dict, caches: list) -> torch.Tensor:
    """``model.decode_step`` with the decode attention through its plain
    version (``ref.decode_attention_ref``)."""
    raw = ops.decode_attention

    def plain_decode(q, k, v, lengths, **kw):
        return plain.decode_attention_ref(q, k, v, lengths, **kw)

    ops.decode_attention = plain_decode
    try:
        return model.decode_step(batch, caches)
    finally:
        ops.decode_attention = raw


def long_cell_phase(dev, model: LM) -> dict:
    """The long_500k cell of ``model`` (full width and depth, bf16, the
    weights of its serve run): ServeEngine with one slot and cache_len
    524 288, one prompt (``_long_prompt``) and LONG_TOKENS tokens, the
    counts set to 0 just before and read just after; the first tick held
    against a re-prefill of (prompt + token 1), and shown to fail with the
    recurrent states zeroed (a griffin model's, whose states barely carry
    as served, with Lambda negated, as ``consistency_check`` holds it);
    then, for a model with attention, ``long_decode_check``.  Returns the
    launch counts."""
    cfg = model.cfg
    n = leaf_kinds(cfg)
    n_attn = n["attn"] + n["lattn"] + n["moe"]
    phase(f"main path, slice 24: the long_500k cell of {cfg.name} "
          f"({LONG.seq_len} positions, B = 1, decode) at full width and "
          f"depth through ServeEngine (one slot, cache_len {LONG.seq_len}), "
          f"one prompt and {LONG_TOKENS} tokens")
    toks = np.random.default_rng(24).integers(
        3, cfg.vocab, size=LONG.seq_len).astype(np.int32)
    P, sizing = _long_prompt(dev, model, toks)
    print(sizing)
    if not n_attn:
        print(f"  {cfg.name} has no attention and no positional encoding: "
              f"its decode reads no position, so its state at {P} tokens "
              f"stands for the cell's at 524 287")
    eng = ServeEngine(model, LONG_ENGINE)
    req = Request(0, toks[:P], max_tokens=LONG_TOKENS)
    eng.submit(req)
    first: dict = {}
    raw = model.decode_step

    def recording(batch, caches):
        if not first:
            first["batch"] = {k: t.clone() for k, t in batch.items()}
            first["caches"] = [tree_map(torch.clone, c) for c in caches]
            first["logits"] = raw(batch, caches).clone()
            return first["logits"]
        return raw(batch, caches)

    model.decode_step = recording
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.monotonic()
    try:
        ticks = eng.run()
        torch.cuda.synchronize()
    finally:
        del model.decode_step
    wall = time.monotonic() - t0
    launches, plain_calls = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    st = eng.stats
    last = P + ticks - 1
    print(f"  prompt {P} tokens, {len(req.out_tokens)} tokens out, {ticks} "
          f"ticks (the last at position {last}, ring slot "
          f"{last % cfg.window if cfg.window else '-'}); wall {wall:.3f} s; "
          f"prefill {st['prefill_s']:.3f} s ({P / st['prefill_s']:.1f} "
          f"tokens/s); decode {st['decode_tokens']} tokens in "
          f"{st['decode_s']:.3f} s ({st['decode_tokens'] / st['decode_s']:.1f}"
          f" tokens/s, {1e3 * st['decode_s'] / ticks:.2f} ms a tick); peak "
          f"device memory {peak / 2**30:.2f} GiB of "
          f"{torch.cuda.get_device_properties(dev).total_memory / 2**30:.2f}")
    expected = dict.fromkeys(KERNELS, 0)
    expected.update(flash_attention=n_attn, decode_attention=n_attn * ticks,
                    selective_scan=n["mamba"], rglru_scan=n["rec"])
    print("  launches: " + ", ".join(
        f"{k} {launches[k]} (expected {expected[k]})" for k in KERNELS
        if expected[k] or launches[k]) + f"; plain calls {plain_calls}")
    if not (req.done and len(req.out_tokens) == LONG_TOKENS
            and all(0 <= t < cfg.vocab_padded for t in req.out_tokens)):
        raise SystemExit(f"the {cfg.name} long_500k cell did not emit its "
                         f"{LONG_TOKENS} tokens")
    if launches != expected or plain_calls != 0:
        raise SystemExit(f"the {cfg.name} long_500k cell did not go through "
                         f"its kernels alone")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # The first tick (the token after the prompt, at position P) against
    # a re-prefill of the prompt and token 1.
    ext = torch.as_tensor(np.concatenate([toks[:P], req.out_tokens[:1]])
                          [None], dtype=torch.long, device=dev)
    t0 = time.monotonic()
    want, caches = model.prefill({"tokens": ext}, LONG.seq_len)
    torch.cuda.synchronize()
    re_s = time.monotonic() - t0
    del caches
    got = first["logits"]
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise SystemExit(f"non-finite logits in the {cfg.name} long_500k "
                         f"cell")
    top = float(want.abs().max())
    err = float((got - want).abs().max())
    tol = CONSISTENCY_ULPS * bf16_ulp(top)
    lost = [tree_map(torch.clone, c) for c in first["caches"]]
    for c in lost:
        _zero_states(c)
    err_lost = float((model.decode_step(first["batch"], lost) - want)
                     .abs().max())
    held = not n["rec"]
    print(f"  the first tick vs a re-prefill of the prompt and token 1 "
          f"({re_s:.2f} s): max abs err {err:.4f} (logits up to {top:.2f}; "
          f"tolerance {CONSISTENCY_ULPS} bf16 ulps there, {tol:g}); states "
          f"zeroed {err_lost:.4f}"
          + ("" if held else " (not held: they barely carry)"))
    if err > tol:
        raise SystemExit(f"the {cfg.name} long_500k cell's first tick "
                         f"disagrees with a re-prefill")
    if held and err_lost <= tol:
        raise SystemExit(f"the {cfg.name} long_500k check does not see "
                         f"zeroed recurrent states")
    del first, lost, want, got
    gc.collect()
    torch.cuda.empty_cache()
    if n["rec"]:
        # As consistency_check holds a griffin model: Lambda negated, so
        # that the states carry over the prompt's 2^18 steps, the decode
        # step of (prompt + token 1) against its re-prefill, and with the
        # states zeroed it must fail.
        t0 = time.monotonic()
        _negate_lambda(model)
        try:
            top, err, err_lost = _decode_vs_reprefill(
                model, ext, dev, cache_len=LONG.seq_len)
        finally:
            _negate_lambda(model)
        tol = CONSISTENCY_ULPS * bf16_ulp(top)
        print(f"  with Lambda negated ({time.monotonic() - t0:.2f} s for "
              f"two prefills and the decode steps): the first tick vs a "
              f"re-prefill max abs err {err:.4f} (logits up to {top:.2f}; "
              f"tolerance {CONSISTENCY_ULPS} bf16 ulps there, {tol:g}); "
              f"states zeroed {err_lost:.4f}")
        if err > tol:
            raise SystemExit(f"the {cfg.name} long_500k cell's first tick "
                             f"disagrees with a re-prefill (Lambda negated)")
        if err_lost <= tol:
            raise SystemExit(f"the {cfg.name} long_500k check does not see "
                             f"zeroed recurrent states (Lambda negated)")
        gc.collect()
        torch.cuda.empty_cache()
    del ext
    if n_attn:
        long_decode_check(dev, model)
    return launches


def long_decode_check(dev, model: LM) -> None:
    """The decode at the long_500k cell's last positions, at full width
    and depth, as tests/test_torch_long_decode.py holds it against the
    reference on the CPU at reduced width: two rows at
    ``LONG_DECODE_LENGTHS`` on caches of ``cache_len`` 524 288 (a window
    model's attention caches are rings of its window) with every leaf
    drawn from a seed (normals of scale 0.5), then ``LONG_DECODE_STEPS``
    steps through the kernels against the same steps through the plain
    decode path (``_plain_decode``) on copies of the caches: each step's
    logits within ``CONSISTENCY_ULPS``, the next tokens the plain path's
    choice."""
    cfg = model.cfg
    lens = torch.tensor(LONG_DECODE_LENGTHS, dtype=torch.int32, device=dev)
    slots = ", ".join(str(n % cfg.window) if cfg.window else "-"
                      for n in LONG_DECODE_LENGTHS)
    g = torch.Generator(device=dev).manual_seed(34)
    caches = model.init_cache(len(LONG_DECODE_LENGTHS), LONG.seq_len)
    for c in caches:
        tree_map(lambda t: t.copy_(0.5 * torch.randn(
            t.shape, generator=g, device=dev)), c)
    twins = [tree_map(torch.clone, c) for c in caches]
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        3, cfg.vocab, size=(len(LONG_DECODE_LENGTHS), 1)), device=dev)
    errs, tops = [], []
    reset_counts()
    for _ in range(LONG_DECODE_STEPS):
        batch = {"tokens": toks, "lengths": lens}
        got = model.decode_step(batch, caches)
        want = _plain_decode(model, batch, twins)
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise SystemExit(f"non-finite logits in the {cfg.name} decode "
                             f"at the long_500k positions")
        tops.append(float(want.abs().max()))
        errs.append(float((got - want).abs().max()))
        toks = want.argmax(-1)[:, None]
        lens = lens + 1
    launches, plain_calls = read_counts()
    tols = [CONSISTENCY_ULPS * bf16_ulp(t) for t in tops]
    print(f"  decode at lengths {', '.join(map(str, LONG_DECODE_LENGTHS))} "
          f"(ring slots {slots}) on seeded caches, {LONG_DECODE_STEPS} steps "
          f"through the kernels ({launches['decode_attention']} decode "
          f"launches) vs the plain decode path ({plain_calls} plain calls): "
          f"max abs err a step " + ", ".join(
              f"{e:.4f} (logits up to {t:.2f}, tolerance {tol:g})"
              for e, t, tol in zip(errs, tops, tols))
          + f"; {CONSISTENCY_ULPS} bf16 ulps")
    if any(e > tol for e, tol in zip(errs, tols)):
        raise SystemExit(f"the {cfg.name} decode at the long_500k positions "
                         f"disagrees with the plain decode path")
    del caches, twins
    gc.collect()
    torch.cuda.empty_cache()


def reset_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0
    plain.calls.clear()


def read_counts() -> tuple[dict, int]:
    return ({k: mod.launches for k, mod in KERNELS.items()},
            sum(plain.calls.values()))


def _run(cfg: ExperimentConfig, dev) -> tuple:
    """One experiment and its baseline, with the counts reset before and
    read after.  Returns the record, the kernel launch counts and the
    wall seconds of ``run_experiment``."""
    reset_counts()
    t0 = time.monotonic()
    rec = run_experiment(cfg, device=dev)[0]     # returns host numpy
    wall = time.monotonic() - t0
    t1 = time.monotonic()
    base_cost, base = baseline_cost(cfg, device=dev)
    base_wall = time.monotonic() - t1
    launches, plain_calls = read_counts()
    res = rec.result
    n_scored = res.n_evaluated + cfg.norm_samples
    print(f"  {cfg.arch} {cfg.config} {cfg.algorithms[0]} ({cfg.backend}): "
          f"best cost "
          f"{res.best_cost:.4f} vs 2D mesh {base_cost:.4f}; run_experiment "
          f"{wall:.2f} s wall ({n_scored} placements scored incl. "
          f"{cfg.norm_samples} norm samples, {n_scored / wall:.1f} "
          f"evaluations/s; search alone {res.n_evaluated / rec.seconds:.1f} "
          f"evaluations/s); baseline_cost {base_wall:.2f} s; kernel "
          f"launches {launches}, plain calls {plain_calls}")
    print("  metric            placeit   2D-mesh   delta")
    for t in ("c2c", "c2m", "c2i", "m2i"):
        o, b = res.best_metrics[f"lat_{t}"], base[f"lat_{t}"]
        print(f"  lat_{t} [cyc]     {o:8.1f}  {b:8.1f}  {100*(o/b-1):+6.1f}%")
    for t in ("c2c", "c2m", "c2i", "m2i"):
        o, b = res.best_metrics[f"thr_{t}"], base[f"thr_{t}"]
        print(f"  thr_{t} [frac]    {o:8.3f}  {b:8.3f}  {100*(o/b-1):+6.1f}%")
    if plain_calls != 0:
        raise SystemExit(f"{cfg.arch} {cfg.config} called a plain version")
    costs = [res.best_cost, base_cost] + [c for _, _, c in res.history]
    if not all(np.isfinite(c) for c in costs):
        raise SystemExit(f"non-finite cost in {cfg.arch} {cfg.config}")
    if not (res.best_metrics["connected"] and base["connected"]):
        raise SystemExit(f"disconnected result in {cfg.arch} {cfg.config}")
    arch = resolve_arch(cfg.arch, cfg.config)
    kinds, counts = np.unique(res.best_sol[0][res.best_sol[0] >= 0],
                              return_counts=True)
    if tuple(counts) != arch.counts() or tuple(kinds) != (0, 1, 2):
        raise SystemExit(f"best placement holds {counts}, not "
                         f"{arch.counts()} chiplets")
    return rec, launches, wall


def _fw_kernel(cfg: ExperimentConfig) -> str:
    """The FW kernel a run's scorer launches: kernel 1 on "fw-cuda", else
    the one the size dispatch picks for the arch's V."""
    if cfg.backend == "fw-cuda":
        return "fw_counts"
    arch = resolve_arch(cfg.arch, cfg.config)
    rep = make_rep(arch, cfg.arch)
    V = rep.score_graph(rep.random(np.random.default_rng(0))).W.shape[-1]
    return "fw_counts_tiled" if ops.fw_takes_tiled(V) else "fw_counts"


def _winner_graph(cfg: ExperimentConfig, rec):
    arch = resolve_arch(cfg.arch, cfg.config)
    rep = make_rep(arch, cfg.arch, cfg.mutation_mode)
    return rep, rep.score_graph(rec.result.best_sol)


def _rescore_plain(cfg: ExperimentConfig, rec, dev) -> None:
    """The run's best placement re-scored with the plain FW version on the
    card must reproduce the run's metrics (rtol 1e-6: the kernels are
    bitwise, only the chunk's float32 reductions may differ)."""
    rep, g = _winner_graph(cfg, rec)
    scorer = make_scorer(rep.layout, fw_impl=ops.fw_impl_ref,
                         chunk=cfg.chunk, objective=cfg.objective,
                         device=dev)
    res = rec.result
    got = scorer(stack_graphs([g]), norms_vec(res.normalizers))
    for k, want in res.best_metrics.items():
        np.testing.assert_allclose(float(got[k][0]), want, rtol=1e-6,
                                   err_msg=k)
    print(f"  re-scored the {cfg.arch} winner with the plain version: "
          f"{len(res.best_metrics)} metrics agree (rtol 1e-6)")


def pipeline_parity_phase(dev) -> None:
    """The batched score-graph builds on the card against the host
    build (``testing.batched_build_parity``): every stacked array bit for
    bit, slot for slot, equal edge sets and ``connected``, no overflow,
    and the scorer's metrics and cost from the two builds bit-equal."""
    phase(f"parity: batched score-graph builds on the card vs the host "
          f"build ({PIPELINE_N} random placements an arch, bitwise; "
          f"metrics and cost from both builds bitwise)")
    for arch_name, config in testing.PIPELINE_ARCHS:
        try:
            out = testing.batched_build_parity(arch_name, config,
                                               PIPELINE_N, device=dev)
        except AssertionError as e:
            raise SystemExit(f"batched build parity failed: {e}") from e
        host = f", host geometry {out['geometry_s']:.3f} s" \
            if "geometry_s" in out else ""
        print(f"  {arch_name} {config}: equal; {out['connected']} of "
              f"{out['n']} connected, {out['links']:.1f} links a placement; "
              f"batched build {1e3 * out['build_s']:.2f} ms{host}")


def main_path_phase(dev) -> dict:
    total = dict.fromkeys(KERNELS, 0)

    def add(launches: dict) -> None:
        for k, n in launches.items():
            total[k] += n

    phase(f"main path, slice 1 (the default backend {QUICKSTART.backend}, "
          f"the size dispatch; then the quickstart on "
          f"{QUICKSTART_KERNEL1.backend}): run_experiment + baseline_cost "
          f"on the card")
    for cfg in (QUICKSTART, HOMOG64, QUICKSTART_KERNEL1):
        rec, launches, _ = _run(cfg, dev)
        add(launches)
        want = _fw_kernel(cfg)
        if launches[want] <= 0:
            raise SystemExit(f"{cfg.arch} on {cfg.backend} did not go "
                             f"through {want}")
        if cfg is QUICKSTART:
            _rescore_plain(cfg, rec, dev)

    phase("main path, slice 2 (the default backend): run_experiment + "
          "baseline_cost on the card")
    rec256, launches, wall256 = _run(HOMOG256, dev)
    add(launches)
    if launches[_fw_kernel(HOMOG256)] <= 0:
        raise SystemExit(f"{HOMOG256.arch} did not go through "
                         f"{_fw_kernel(HOMOG256)}")
    _, launches, _ = _run(HEX127, dev)
    add(launches)
    if launches[_fw_kernel(HEX127)] <= 0:
        raise SystemExit(f"{HEX127.arch} did not go through "
                         f"{_fw_kernel(HEX127)}")
    _rescore_plain(HOMOG256, rec256, dev)
    if total["fw_counts"] <= 0 or total["fw_counts_tiled"] <= 0:
        raise SystemExit("the PlaceIT runs did not launch both FW kernels")

    phase("main path, slice 9 (the default backend): the heterogeneous "
          "archs and the device-resident pipeline, run_experiment + "
          "baseline_cost on the card")
    for cfg in (HETERO32, HETERO64_BATCHED, HOMOG256_BATCHED, BR_BATCHED,
                SA_BATCHED):
        rec, launches, wall = _run(cfg, dev)
        add(launches)
        if launches[_fw_kernel(cfg)] <= 0:
            raise SystemExit(f"{cfg.arch} {cfg.algorithms[0]} did not go "
                             f"through {_fw_kernel(cfg)}")
        if cfg is HOMOG256_BATCHED:
            rec256b, wall256b = rec, wall
    print(f"  {HOMOG256.arch} {HOMOG256.config}, host GA against ga-batched "
          f"(the same GA, two generations each):")
    for name, cfg, rec, wall in (
            ("ga", HOMOG256, rec256, wall256),
            ("ga-batched", HOMOG256_BATCHED, rec256b, wall256b)):
        n = rec.result.n_evaluated + cfg.norm_samples
        print(f"    {name:10s} wall {wall:7.3f} s, {n} placements scored "
              f"({rec.result.n_evaluated} by the search), "
              f"{n / wall:7.1f} evaluations/s; search alone "
              f"{rec.result.n_evaluated / rec.seconds:7.1f} evaluations/s")
    _rescore_plain(HOMOG256_BATCHED, rec256b, dev)

    phase(f"main path: ops.apsp on the {HOMOG256.arch} winner's score "
          f"graph")
    _, g = _winner_graph(HOMOG256, rec256)
    W = torch.from_numpy(g.W).to(dev)
    reset_counts()
    D = ops.apsp(W)
    torch.cuda.synchronize()
    launches, plain_calls = read_counts()
    add(launches)
    print(f"  apsp V={W.shape[-1]}: kernel launches {launches}, plain calls "
          f"{plain_calls}")
    if launches["minplus"] <= 0 or plain_calls != 0:
        raise SystemExit("apsp did not go through the minplus kernel alone")
    if not torch.equal(D, plain.fw_counts_ref(W)[0]):
        raise SystemExit("apsp of the winner differs from the plain FW's "
                         "distances")
    print("  apsp distances equal the plain FW's")
    return total


def _records_equal(a, b, generated: bool = True) -> bool:
    """Two sweep records equal field for field: the placement, the bits of
    the cost, the counts and the history's (n, cost) pairs.  A
    run_experiment record's ``n_generated`` also counts its Evaluator's
    norm samples (a sweep record's counts its own run alone), so
    ``generated=False`` leaves it out."""
    ra, rb = a.result, b.result
    return ((a.algorithm, a.repetition) == (b.algorithm, b.repetition)
            and all(np.array_equal(x, y)
                    for x, y in zip(ra.best_sol, rb.best_sol))
            and np.float32(ra.best_cost).tobytes()
            == np.float32(rb.best_cost).tobytes()
            and ra.n_evaluated == rb.n_evaluated
            and (not generated or ra.n_generated == rb.n_generated)
            and [(n, c) for _, n, c in ra.history]
            == [(n, c) for _, n, c in rb.history])


def _sweep(configs, dev, **kw) -> tuple:
    """One run_sweep with the counts reset before and read after; no
    plain version may run.  Returns the result, the launches and the
    wall."""
    reset_counts()
    t0 = time.monotonic()
    res = run_sweep(configs, device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches, plain_calls = read_counts()
    if plain_calls != 0:
        raise SystemExit("a sweep called a plain version")
    return res, launches, wall


def sweep_phase(dev) -> dict:
    """Slice 10: run_sweep stacked and unstacked on homog64 placeit; the
    records must be equal field for field."""
    runs = ", ".join(f"{'+'.join(c.algorithms)} seed {c.seed}"
                     for c in SWEEP)
    phase(f"main path, slice 10: run_sweep on {SWEEP[0].arch} "
          f"{SWEEP[0].config}, {len(SWEEP)} configs ({runs}), stacked, then "
          f"unstacked")
    total = dict.fromkeys(KERNELS, 0)
    out = {}
    for mode, kw in (("stacked", {}), ("unstacked",
                                       {"stack_scoring": False})):
        res, launches, wall = _sweep(SWEEP, dev, **kw)
        for k, n in launches.items():
            total[k] += n
        st = res.stats
        n = st.n_evaluated
        print(f"  {mode:9s} wall {wall:7.3f} s, {n} placements scored by "
              f"the searches, {n / wall:7.1f} evaluations/s, score_calls "
              f"{st.score_calls}, stacked groups {st.stacked_groups}, "
              f"fw_counts_tiled launches {launches['fw_counts_tiled']}")
        if launches["fw_counts_tiled"] <= 0:
            raise SystemExit(f"the {mode} sweep did not launch the blocked "
                             f"FW kernel")
        out[mode] = res
    s, u = out["stacked"], out["unstacked"]
    if s.stats.stacked_groups != 1 or u.stats.stacked_groups != 0:
        raise SystemExit(f"stacked groups {s.stats.stacked_groups} / "
                         f"{u.stats.stacked_groups}, not 1 / 0")
    if s.stats.score_calls >= u.stats.score_calls:
        raise SystemExit("stacking did not cut the scorer calls")
    if len(s.records) != len(u.records) or not all(
            _records_equal(a, b) for a, b in zip(s.records, u.records)):
        raise SystemExit("stacked sweep records differ from unstacked")
    for r in s.records:
        if not (np.isfinite(r.result.best_cost)
                and r.result.best_metrics["connected"]):
            raise SystemExit(f"sweep {r.algorithm}: bad winner")
    print(f"  {len(s.records)} records equal field for field (best_sol, "
          f"best_cost bits, n_evaluated, n_generated, history)")
    return total


def pareto_phase(dev) -> dict:
    """Slice 10: examples/pareto_sweep.py's sweep on the card."""
    phase(f"main path, slice 10: run_pareto_sweep, {PARETO_BASE.arch} "
          f"{PARETO_BASE.config} {PARETO_BASE.algorithms[0]}, "
          f"{PARETO_GRID.n_points} scalarizations")
    api.clear_scorer_cache()
    reset_counts()
    t0 = time.monotonic()
    res = pareto.run_pareto_sweep(PARETO_BASE, PARETO_GRID, device=dev)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches, plain_calls = read_counts()
    (front,) = res.fronts
    st = res.stats
    print(f"  wall {wall:.3f} s; scorers built {st.scorers_built}, stacked "
          f"groups {st.stacked_groups}, evaluators {st.evaluators_built}, "
          f"score_calls {st.score_calls}; front {len(front.points)} of "
          f"{front.n_candidates} candidates, hypervolume "
          f"{front.hypervolume!r}; kernel launches {launches}, plain calls "
          f"{plain_calls}")
    if plain_calls != 0 or launches["fw_counts_tiled"] <= 0:
        raise SystemExit("the Pareto sweep did not go through the blocked "
                         "FW kernel alone")
    if (st.scorers_built, st.stacked_groups, st.evaluators_built,
            front.n_candidates) != (1, 1, 1, PARETO_GRID.n_points):
        raise SystemExit("the Pareto sweep did not share one scorer, one "
                         "group and one evaluator over every grid point")
    Y = np.asarray(front.matrix, np.float32)
    mask = pareto.nondominated_mask(Y, device=dev)
    if not np.array_equal(mask, pareto.nondominated_mask_host(Y)):
        raise SystemExit("the card's dominance mask differs from the host's")
    ref = np.asarray(front.ref_point)
    hv_host = pareto._hv_rec(np.minimum(Y[mask].astype(np.float64), ref),
                             ref)
    if not math.isclose(front.hypervolume, hv_host, rel_tol=HV_RTOL):
        raise SystemExit(f"hypervolume {front.hypervolume!r} on the card, "
                         f"{hv_host!r} on the host")
    print(f"  dominance mask equals the host's; hypervolume within rel "
          f"{HV_RTOL:g} of the host float64 recursion ({float(hv_host)!r})")
    for p in front.points:
        print(f"    {p.label:24s} terms {np.round(p.terms, 4)} cost(own) "
              f"{p.cost:.4f}")
    run = res.runs[2]
    solo = run_experiment(run.config, device=dev)
    if not all(_records_equal(a, b, generated=False)
               for a, b in zip(run.records, solo)):
        raise SystemExit("a grid point's solo run differs from its stacked "
                         "record")
    w = {t.name: t.weight for t in run.config.objective.terms}
    print(f"  grid point lat={w['lat']:g}|inv-thr={w['inv-thr']:g}: solo "
          f"run_experiment equals its stacked record bit for bit")
    return launches


def _host_latency(arch, rep, sol, trace) -> float:
    """The host event-driven oracle's average packet latency of a
    placement on the trace (pairs it cannot route are dropped)."""
    links, _ = rep.links_of(sol)
    net = ChipletNet.from_links(arch, rep.geometry(sol), links)
    ok = [p for p in trace if net.next_hop[p.src, p.dst] >= 0]
    return NetSim(net, arch).run(ok, mode="authentic").avg_latency


def trace_phase(dev) -> dict:
    """Slice 10: examples/trace_optimize.py on the card."""
    arch = resolve_arch(_TRACE_BASE["arch"], _TRACE_BASE["config"])
    rep = make_rep(arch, _TRACE_BASE["arch"])
    _, geo, links = MeshBaseline(arch).build()
    net = ChipletNet.from_links(arch, geo, links)
    trace = generate_trace(net, TRACE_REGIONS, seed=7)
    cycles = sum(r.n_cycles for r in TRACE_REGIONS)
    wl = Workload.from_trace(trace, arch.kinds(), cycles, name="parsec-like")
    guided = Objective().with_terms(TermSpec("trace-lat", weight=2.0))
    cfgs = [ExperimentConfig(**_TRACE_BASE),
            ExperimentConfig(**_TRACE_BASE, objective=guided, workload=wl)]
    phase(f"main path, slice 10: trace-guided search, {_TRACE_BASE['arch']} "
          f"{_TRACE_BASE['config']}, {len(trace)} packets over {cycles} "
          f"cycles, proxy-only and trace-lat GA in one run_sweep")
    res, launches, wall = _sweep(cfgs, dev)
    if launches["fw_counts_tiled"] <= 0:
        raise SystemExit("the trace sweep did not launch the blocked FW "
                         "kernel")
    t0 = time.monotonic()
    lat_mesh = NetSim(net, arch).run(trace).avg_latency
    recs = [run.records[0] for run in res.runs]
    lat_proxy, lat_guided = (_host_latency(arch, rep, r.result.best_sol,
                                           trace) for r in recs)
    sim_wall = time.monotonic() - t0
    print(f"  sweep wall {wall:.3f} s (proxy-only {recs[0].seconds:.3f} s, "
          f"trace-lat {recs[1].seconds:.3f} s), score_calls "
          f"{res.stats.score_calls}; host simulation {sim_wall:.3f} s; "
          f"kernel launches {launches}")
    gain = 100 * (1 - lat_guided / lat_proxy)
    print(f"  host-simulated average packet latency [cycles]: 2D mesh "
          f"{lat_mesh:.2f}, proxy-only winner {lat_proxy:.2f}, trace-lat "
          f"winner {lat_guided:.2f} ({gain:+.1f} % vs proxy)")
    if not all(np.isfinite(x) for x in (lat_mesh, lat_proxy, lat_guided)):
        raise SystemExit("non-finite simulated latency")
    # The trace winner's metrics, scored on the card in the run, against
    # the same placement scored on the CPU with the plain FW.
    best = recs[1].result
    cpu = make_scorer(rep.layout, fw_impl=ops.fw_impl_ref,
                      chunk=_TRACE_BASE["chunk"], objective=guided,
                      device="cpu")
    batch = stack_graphs([rep.score_graph(best.best_sol)])
    batch["_demand"] = wl.vec()[None]
    got = cpu(batch, norms_vec(best.normalizers))
    worst = 0.0
    for k, v in best.best_metrics.items():
        if not k.startswith("trace_"):
            continue
        want = float(got[k][0])
        rtol = THR_RTOL if k.startswith("trace_thr_") else TRACE_RTOL
        if not math.isclose(v, want, rel_tol=rtol, abs_tol=0.0):
            raise SystemExit(f"{k}: {v!r} on the card, {want!r} on the CPU")
        if want:
            worst = max(worst, abs(v - want) / abs(want))
    print(f"  the trace winner's trace_* metrics on the card agree with the "
          f"CPU's (plain FW): largest relative difference {worst:.3g}")
    return launches


def _archives_equal(a, b) -> bool:
    """Two ``OptResult.archive`` snapshots equal row for row, bit for
    bit (or both absent)."""
    if a is None or b is None:
        return a is None and b is None
    return all(np.array_equal(a[k], b[k]) for k in ("costs", "a", "b"))


def _design_requests() -> list:
    return [api.DesignRequest(config=c, pareto_grid=g, request_id=f"t{i}")
            for i, (c, g) in enumerate(DESIGN_TENANTS)]


def _design_run(reqs, dev, **kw) -> tuple:
    """One DesignEngine over ``reqs`` with the counts reset before and read
    after; no plain version may run.  Returns the engine, the responses,
    the launches and the wall."""
    reset_counts()
    t0 = time.monotonic()
    eng = DesignEngine(device=dev, **kw)
    rids = [eng.submit(r) for r in reqs]
    eng.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches, plain_calls = read_counts()
    if plain_calls != 0:
        raise SystemExit("the design engine called a plain version")
    resps = [eng.result(r) for r in rids]
    for r in resps:
        if r.status != "done":
            raise SystemExit(f"design request {r.request_id}: {r.status} "
                             f"({r.error})")
    return eng, resps, launches, wall


def design_phase(dev) -> dict:
    """Slice 11: the design service.  Four tenants through one
    ``DesignEngine``; every response equals its
    ``run_sweep(fold_repetitions=False)`` records bit for bit, and a second
    engine with ``shard=True`` equals the first."""
    names = "; ".join(f"{c.arch} {c.config} {c.algorithms[0]}"
                      + (f" x {g.n_points} grid points" if g else "")
                      + (f", archive {c.archive_k}" if c.archive_k else "")
                      for c, g in DESIGN_TENANTS)
    phase(f"main path, slice 11: DesignEngine, {len(DESIGN_TENANTS)} "
          f"tenants ({names}), unsharded, then shard=True")
    reqs = _design_requests()
    total = dict.fromkeys(KERNELS, 0)
    engines = []
    for kw in ({}, {"shard": True}):
        eng, resps, launches, wall = _design_run(reqs, dev, **kw)
        for k, n in launches.items():
            total[k] += n
        st = eng.stats
        n = st.rows_scored
        print(f"  {'shard=True' if kw else 'unsharded':10s} wall {wall:7.3f} "
              f"s, {n} placements scored in rounds, {n / wall:7.1f} "
              f"evaluations/s, score_calls {st.score_calls}, stacked_rounds "
              f"{st.stacked_rounds}, ticks {st.ticks}, evaluators "
              f"{st.evaluators_built}, shard_devices {st.shard_devices}, "
              f"fw_counts_tiled launches {launches['fw_counts_tiled']}")
        if launches["fw_counts_tiled"] <= 0:
            raise SystemExit("the design engine did not launch the blocked "
                             "FW kernel")
        if st.stacked_rounds <= 0:
            raise SystemExit("the design engine stacked no round")
        runs_s = sum(r.seconds for resp in resps for r in resp.records)
        print(f"    the runs' attributed seconds (their generators' resumes "
              f"and their shares of the scorer calls) {runs_s:.3f} s; the "
              f"rest of the wall, {wall - runs_s:.3f} s: admission (the "
              f"evaluators' norm samples), the Pareto fronts' re-scores, "
              f"the engine's bookkeeping")
        engines.append(resps)
    for resp in engines[0]:
        f = resp.front
        print(f"  {resp.request_id}: best cost {resp.best_cost:.4f}, "
              f"{len(resp.records)} records, {len(resp.updates)} updates, "
              f"front {'-' if f is None else len(f.points)} of "
              f"{'-' if f is None else f.n_candidates} candidates")
    # The same configs through run_sweep, unfolded: equal record for
    # record.  (An engine record keeps its evaluator's cumulative
    # n_generated, as the reference engine's does: that count is not
    # compared.)
    expanded = []
    for c, g in DESIGN_TENANTS:
        expanded += ([c] if g is None else
                     [dataclasses.replace(c, objective=o)
                      for _, o in g.points(c.objective)])
    sweep, launches, wall = _sweep(expanded, dev, fold_repetitions=False)
    print(f"  run_sweep(fold_repetitions=False) of the {len(expanded)} "
          f"expanded configs: wall {wall:.3f} s, score_calls "
          f"{sweep.stats.score_calls}, fw_counts_tiled launches "
          f"{launches['fw_counts_tiled']}")
    for k, n in launches.items():
        total[k] += n
    for resps in engines:
        recs = [r for resp in resps for r in resp.records]
        if len(recs) != len(sweep.records) or not all(
                _records_equal(a, b, generated=False)
                and _archives_equal(a.result.archive, b.result.archive)
                for a, b in zip(sweep.records, recs)):
            raise SystemExit("design engine records differ from run_sweep's")
    a0 = next(r for r in sweep.records if r.result.archive is not None)
    print(f"  {len(sweep.records)} records equal run_sweep's field for field "
          f"(best_sol, best_cost bits, n_evaluated, history, archive), "
          f"sharded and unsharded; archive of {a0.arch}: "
          f"{len(a0.result.archive['costs'])} rows, head "
          f"{a0.result.archive['costs'][0]:.4f}")
    return total


def arch3d_phase(dev) -> dict:
    """Slice 11: the 3D families.  The batched builds against the host
    build, then three runs through run_experiment on the card."""
    phase(f"parity: batched 3D score-graph builds on the card vs the host "
          f"build ({ARCH3D_N} random placements a family, bitwise; metrics "
          f"and cost from both builds bitwise)")
    for arch_name, config in testing.PIPELINE_ARCHS_3D:
        try:
            out = testing.batched_build_parity(arch_name, config, ARCH3D_N,
                                               device=dev)
        except AssertionError as e:
            raise SystemExit(f"3D build parity failed: {e}") from e
        print(f"  {arch_name} {config}: equal; {out['connected']} of "
              f"{out['n']} connected, {out['links']:.1f} links a placement; "
              f"batched build {1e3 * out['build_s']:.2f} ms")
    runs = ", ".join(f"{c.arch} {c.algorithms[0]}" for c in ARCH3D_RUNS)
    phase(f"main path, slice 11: the 3D families through run_experiment + "
          f"baseline_cost on the card ({runs}; placeit, 32 / 6 / 6)")
    total = dict.fromkeys(KERNELS, 0)
    for cfg in ARCH3D_RUNS:
        rec, launches, wall = _run(cfg, dev)
        for k, n in launches.items():
            total[k] += n
        n = rec.result.n_evaluated + cfg.norm_samples
        print(f"  {cfg.arch} {cfg.algorithms[0]}: wall {wall:.3f} s, {n} "
              f"placements scored, {n / wall:.1f} evaluations/s; "
              f"fw_counts_tiled launches {launches['fw_counts_tiled']}; "
              f"best placement {rec.result.best_sol[0].shape}")
        if launches["fw_counts_tiled"] <= 0:
            raise SystemExit(f"{cfg.arch} {cfg.algorithms[0]} did not launch "
                             f"the blocked FW kernel")
        if rec.result.best_sol[0].shape != (4, 4, 4):
            raise SystemExit(f"{cfg.arch}: placement "
                             f"{rec.result.best_sol[0].shape}")
    return total


def _kernel_times(prof) -> tuple[list, float]:
    """(name, device ms, calls) of each CUDA kernel in a profile, largest
    first, and their total in ms."""
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0 and e.key not in tmoe.RANGES]
    rows.sort(key=lambda r: -r[1])
    return rows, sum(r[1] for r in rows)


def profile_phase(dev) -> None:
    """torch.profiler over one blocked FW call at homog256 placeit (time
    by phase kernel), over one homog256 placeit run through the host GA
    and one through ga-batched (device busy share, every copy), over the
    design phase's unsharded engine, and over the Evaluator's norm-sample
    draw alone (the host-built graphs both runs still score).  Profiling
    adds host time, so the runs' walls here are longer than the main
    path's.  Exits if a profile records none of its kernels.  Runs before
    any profiled train step: after a profiled session of very many
    kernels (a train step), the profiler records no device activity in a
    short session that follows (``launch/profile_loss.py``)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    phase("profile: one fw_counts_tiled call at homog256 placeit")
    W = torch.from_numpy(testing.score_graphs(HOMOG256.arch, HOMOG256.config,
                                              1)).to(dev)
    fwt.fw_counts_tiled(W)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        fwt.fw_counts_tiled(W)
        torch.cuda.synchronize()
    rows, total = _kernel_times(prof)
    print(f"  device kernel time {total:.4f} ms in {len(rows)} kernels")
    for name, ms, n in rows[:8]:
        print(f"  {ms:10.4f} ms {n:5d} x  {name[:90]}")
    if [n for name, _, n in rows if "fw_tiled_kernel" in name] != [1]:
        raise SystemExit("the single-call profile did not record its one "
                         "fw_counts_tiled kernel")
    arch = resolve_arch(HOMOG256.arch, HOMOG256.config)
    rep = make_rep(arch, HOMOG256.arch)
    runs = [(f"one {cfg.arch} {cfg.config} {cfg.algorithms[0]} "
             f"run_experiment", lambda cfg=cfg: run_experiment(cfg, device=dev))
            for cfg in (HOMOG256, HOMOG256_BATCHED)]
    runs.append((f"the design engine's {len(DESIGN_TENANTS)} tenants, "
                 f"unsharded",
                 lambda: _design_run(_design_requests(), dev)))
    runs.append((f"the Evaluator's {HOMOG256.norm_samples} {HOMOG256.arch} "
                 f"norm samples alone",
                 lambda: api.make_evaluator(
                     rep, arch, rng=np.random.default_rng(HOMOG256.seed),
                     norm_samples=HOMOG256.norm_samples, device=dev)))
    for what, fn in runs:
        phase(f"profile: {what} (device busy share, copies)")
        with profile(activities=acts) as prof:
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        rows, total = _kernel_times(prof)
        if not rows:
            raise SystemExit(f"the profile of {what} recorded no kernel")
        print(f"  wall {wall:.3f} s under the profiler, device kernel time "
              f"{total / 1e3:.4f} s ({100 * total / 1e3 / wall:.2f} % busy)")
        for name, ms, n in rows[:10]:
            print(f"  {ms:10.3f} ms {n:6d} x  {name[:90]}")
        for name, ms, n in rows:
            if name.startswith("Memcpy"):
                print(f"  copies: {ms:10.3f} ms {n:6d} x  {name}")


# -- training (slice 12) ------------------------------------------------------

# The backward kernel's tolerances on ``testing.attention_cases`` (every
# option of the forward): float32 2e-5 (kernel and plain version sum in
# float32 in other orders; seen on the H100: under 1e-5 of the largest
# gradient), bfloat16 2e-2 as the forward's cases (one bfloat16 rounding of
# each gradient).  At the training shapes (bfloat16) the limit is scaled to
# the gradients: two bfloat16 ulps of an entry, plus 2^-8 of the largest
# gradient of the tensor for entries that a cancellation in dS = P (dP - D)
# leaves small (both sum dP - D in float32, in other orders).
BWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
BWD_RTOL, BWD_ATOL_SHARE = 2.0 ** -6, 2.0 ** -8
BWD_LIMIT = (f"|kernel - plain| <= {BWD_ATOL_SHARE:g} max|plain| + "
             f"{BWD_RTOL:g} |plain|")
# The forward's log-sum-exp against the plain version's (float32 sums of
# exps in other orders; the kernel's ex2.approx in bfloat16).
LSE_TOL = 1e-5
# The attention shapes of the training runs (bfloat16), (arch, B, S,
# causal): smollm-360m at the smoke's B = 8 (15 query heads on 5 KV heads
# of 64) and qwen3-1.7b at B = 1 (16 on 8 of 128), S = 2048;
# recurrentgemma-9b at its training run's B = 1, S = 4096 (16 on 1 of 256,
# its 2048-token window in force); moonshot-v1-16b-a3b's (16 on 16 of 128)
# and seamless-m4t-medium's (16 on 16 of 64: the decoder's causal self-
# attention, and the encoder's and the cross-attention's, 4096 frames
# both, bidirectional) at their training runs' B = 2, S = 4096.  Slice 23
# (``FAMILY_TRAIN``'s dense runs): llava-next-34b at B = 1 over its 576
# patch rows and 4096 tokens (S = 4672; 56 on 8 of 128), tinyllama-1.1b at
# B = 2 (32 on 4 of 64) and qwen2.5-3b at B = 1 (16 on 2 of 128), causal.
TRAIN_S = 2048
RTRAIN_S = 4096
VLM_PATCHES = get_config("llava-next-34b").n_frontend_tokens
BWD_TIMED = (("smollm-360m", 8, TRAIN_S, True),
             ("qwen3-1.7b", 1, TRAIN_S, True),
             ("recurrentgemma-9b", 1, RTRAIN_S, True),
             ("moonshot-v1-16b-a3b", 2, RTRAIN_S, True),
             ("seamless-m4t-medium", 2, RTRAIN_S, True),
             ("seamless-m4t-medium", 2, RTRAIN_S, False),
             ("llava-next-34b", 1, VLM_PATCHES + RTRAIN_S, True),
             ("tinyllama-1.1b", 2, RTRAIN_S, True),
             ("qwen2.5-3b", 1, RTRAIN_S, True))
# The full-width training run: smollm-360m (the reference launcher's
# default arch) at its published widths and depth, bfloat16, weights from
# seed 0, B = 8, S = 2048, remat, AdamW at lr 1e-3 (5 warm-up steps, then
# cosine), 20 steps, a checkpoint every 10; a SIGTERM at step 10 stops the
# first run (the loop checkpoints and exits), and a second run resumes
# from that checkpoint to step 20.
TRAIN_ARCH = "smollm-360m"
TRAIN_B = 8
TRAIN_STEPS = 20
TRAIN_CKPT_EVERY = 10
TRAIN_LR = 1e-3
TRAIN_CKPT_DIR = Path(__file__).resolve().parent / "build" / "smoke_ckpt"
# The kernel-against-plain step: the same model at depth 2, one batch.
# Loss within 1e-3 relative; each gradient within 3e-2 of its norm (L2):
# the attention outputs of kernel and plain version differ by one
# bfloat16 ulp in some entries, and the two steps' bfloat16 products then
# round apart.
COMPARE_LAYERS = 2
COMPARE_LOSS_RTOL = 1e-3
COMPARE_GRAD_RTOL = 3e-2
# The recurrent families' training runs (slice 14), at full width and cut
# depth: falcon-mamba-7b at 8 of its 64 layers, B = 2, and recurrentgemma-9b
# at 6 of its 38 (two rec, rec, attention blocks), B = 1; bfloat16, remat,
# S = RTRAIN_S (the reference's train_4k length), weights from seed 0,
# AdamW (5 warm-up steps, then cosine), RTRAIN_STEPS steps through
# train.step and train.loop (which writes a checkpoint at the last step).
# Depth is cut because AdamW's 12 bytes a parameter at full depth (84-108
# GB) exceed the card's 80 GB.  (arch, layers, B, learning rate):
# recurrentgemma-9b at 1e-4, because at 1e-3 its loss turns NaN from step
# 5: a gate saturates, a = exp(-c softplus(Lambda) r) rounds to 1 in
# bfloat16 (the model rounds it before the scan), and there the gradient
# of sqrt(1 - a^2) is NaN in the reference as in the port.  The run counts
# the a >= 1 that reach rglru_scan (``_saturation_probe``) and fails on
# any, so a learning rate that saturates shows as that, not as a NaN.
RTRAIN = (("falcon-mamba-7b", 8, 2, TRAIN_LR),
          ("recurrentgemma-9b", 6, 1, 1e-4))
RTRAIN_STEPS = 12
RTRAIN_CKPT_DIR = Path(__file__).resolve().parent / "build" / "smoke_rckpt"
# The kernels each run must launch: its scan's forward and backward, and
# recurrentgemma-9b's attention kernels.
RTRAIN_KERNELS = {
    "falcon-mamba-7b": ("selective_scan", "selective_scan_bwd"),
    "recurrentgemma-9b": ("rglru_scan", "rglru_scan_bwd", "flash_attention",
                          "flash_attention_bwd"),
    "moonshot-v1-16b-a3b": ("flash_attention", "flash_attention_bwd"),
    "seamless-m4t-medium": ("flash_attention", "flash_attention_bwd"),
    "grok-1-314b": ("flash_attention", "flash_attention_bwd"),
    "llava-next-34b": ("flash_attention", "flash_attention_bwd"),
    "qwen2.5-3b": ("flash_attention", "flash_attention_bwd"),
    "tinyllama-1.1b": ("flash_attention", "flash_attention_bwd")}
# Their kernel-against-plain steps: falcon-mamba-7b at depth 2, B = 2, and
# recurrentgemma-9b at depth 3 (one rec, rec, attention block), B = 1, at
# full width with S cut to RCOMPARE_S to bound the plain loops' time; the
# limits of COMPARE_*.
RCOMPARE = (("falcon-mamba-7b", 2, 2), ("recurrentgemma-9b", 3, 1))
RCOMPARE_S = 1024
# The bridge: examples/design_accelerator.py's synthetic decode signature.
BRIDGE_SIG = dict(arch="demo", shape="decode_32k", kind="decode", t_comp=0.2,
                  t_mem=2.0, t_coll=0.6, io_share=0.15)
BRIDGE_EVALS = 120
BRIDGE_NORM_SAMPLES = 24


def _bwd_check(name: str, got, want, tol: float | None
               ) -> tuple[float, float]:
    """Max abs error of (dq, dk, dv) against the plain version's and the
    largest share of the limit an entry uses; ``tol`` the cases' allclose,
    None the training shapes' ``BWD_LIMIT``."""
    err = share = 0.0
    for a, b, what in zip(got, want, ("dq", "dk", "dv")):
        if tol is None:
            atol = BWD_ATOL_SHARE * float(b.float().abs().max())
            e, sh = _require_close(f"flash_attention_bwd {what} vs plain",
                                   name, a, b, BWD_RTOL, atol)
        else:
            e, sh = _require_close(f"flash_attention_bwd {what} vs plain",
                                   name, a, b, tol)
        err, share = max(err, e), max(share, sh)
    return err, share


def _bwd_inputs(q, k, v, kw: dict, seed: int):
    """The kernel forward's output and lse (checked against the plain
    version's, and its output against the serving launch's bits) and a
    seeded output gradient."""
    out, lse = tfa._launch(q, k, v, kw.get("causal", True), kw.get("window"),
                           None, kw.get("softcap"), kw.get("pos_offset"),
                           with_lse=True)
    if not torch.equal(out, tfa._launch(q, k, v, kw.get("causal", True),
                                        kw.get("window"), None,
                                        kw.get("softcap"),
                                        kw.get("pos_offset"))):
        raise SystemExit("flash_attention's output moved with the lse")
    _, lse_p = plain.attention_ref(q, k, v, return_lse=True, **kw)
    fin = torch.isfinite(lse_p)
    if not torch.equal(fin, torch.isfinite(lse)):
        raise SystemExit("flash_attention lse: -inf rows differ")
    if fin.any():
        _require_close("flash_attention lse vs plain", str(kw), lse[fin],
                       lse_p[fin], LSE_TOL)
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.standard_normal(tuple(out.shape),
                                             dtype=np.float32))
    return out, lse, g.to(q.device).to(q.dtype)


def attention_bwd_parity_phase(dev, worst: dict) -> None:
    phase(f"parity: flash_attention_bwd kernel vs plain version "
          f"(attention_bwd_ref; allclose {BWD_TOL['float32']:g} in float32, "
          f"{BWD_TOL['bfloat16']:g} in bfloat16), every option of the "
          f"forward and the edges of the kernels' tiles; two calls bit for "
          f"bit; the forward's lse within {LSE_TOL:g} and its output "
          f"unchanged by it")
    cases = {**testing.attention_cases(), **testing.attention_tile_cases()}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for i, (name, make) in enumerate(cases.items()):
            *qkv, kw = make()
            q, k, v = _on_card(qkv, dev, dt)
            out, lse, g = _bwd_inputs(q, k, v, kw, seed=i)
            got = tfb.flash_attention_bwd(q, k, v, out, g, lse, **kw)
            again = tfb.flash_attention_bwd(q, k, v, out, g, lse, **kw)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise SystemExit(f"flash_attention_bwd is not repeatable "
                                 f"on {name}")
            want = plain.attention_bwd_ref(q, k, v, out, g, lse, **kw)
            worst["flash_attention_bwd"] = max(
                worst["flash_attention_bwd"],
                _bwd_check(name, got, want, BWD_TOL[dtype])[0])
        print(f"  {dtype}: {len(cases)} cases within "
              f"tolerance, repeatable (worst so far "
              f"{worst['flash_attention_bwd']:.3g})")


def flash_bwd_bound_ms(B, S, Hq, Hkv, d, window=None, itemsize=2,
                       causal=True):
    """Sq = Sk = S: 10 B Hq d operations a seen (query, key) pair (the
    logits, dP, dv, dk, dq products; causal, query i sees min(i + 1,
    window) keys, else all S) against reading q, k, v, o, dO and lse and
    writing dq, dk and dv once."""
    pairs = (int(np.minimum(np.arange(1, S + 1), window or S).sum())
             if causal else S * S)
    return _bound(10 * B * Hq * d * pairs,
                  itemsize * d * (4 * B * S * Hq + 4 * B * S * Hkv)
                  + 4 * B * Hq * S, PEAK_BF16_OPS)


def attention_bwd_timing_phase(dev, worst: dict) -> dict:
    """The backward kernel at the training shapes, beside its bound, the
    plain backward and the backward of ``scaled_dot_product_attention``
    (``is_causal=True``, or a boolean causal-window mask where the model
    has a window; timed for comparison only); every timed output held to
    ``BWD_LIMIT`` and to one more call's, bit for bit."""
    F = torch.nn.functional
    rows = {}
    for arch, B, S, causal in BWD_TIMED:
        cfg = get_config(arch)
        window = cfg.window or None
        kw = {} if window is None else {"window": window}
        if not causal:
            kw["causal"] = False
        shape = dict(B=B, Sq=S, Sk=S, Hq=cfg.n_heads, Hkv=cfg.n_kv_heads,
                     d=cfg.hd)
        how = "causal" if causal else "bidirectional"
        phase(f"timing: flash_attention_bwd at {arch}'s training shape "
              f"(bf16, {how}, window {window}, {shape}; outputs "
              f"{BWD_LIMIT})")
        q, k, v = _on_card(testing.attention_operands(**shape, seed=B), dev)
        out, lse, g = _bwd_inputs(q, k, v, kw, seed=B)
        q_s, k_s, v_s = (x.transpose(1, 2).detach().requires_grad_()
                         for x in (q, k, v))
        if window is None:
            o_s = F.scaled_dot_product_attention(
                q_s, k_s, v_s, is_causal=causal, enable_gqa=True)
        else:
            pos = torch.arange(S, device=dev)
            mask = (pos[None] <= pos[:, None]) & (
                pos[None] > pos[:, None] - window)
            o_s = F.scaled_dot_product_attention(
                q_s, k_s, v_s, attn_mask=mask, enable_gqa=True)
        g_s = g.transpose(1, 2)
        fns = {
            "kernel": lambda: tfb.flash_attention_bwd(q, k, v, out, g, lse,
                                                      **kw),
            "plain": lambda: plain.attention_bwd_ref(q, k, v, out, g, lse,
                                                     **kw),
            "library": lambda: torch.autograd.grad(
                o_s, (q_s, k_s, v_s), g_s, retain_graph=True)}
        t, outs = kt.batched_ms(fns, launches=5, rounds=3)
        err, share = _bwd_check(f"{arch} training shape", outs["kernel"],
                                outs["plain"], None)
        again = tfb.flash_attention_bwd(q, k, v, out, g, lse, **kw)
        if not all(torch.equal(a, b) for a, b in zip(again, outs["kernel"])):
            raise SystemExit(f"flash_attention_bwd is not repeatable at "
                             f"{arch}'s training shape")
        worst["flash_attention_bwd"] = max(worst["flash_attention_bwd"], err)
        t["bound"], t["bound_by"] = flash_bwd_bound_ms(**{
            k_: shape[k_] for k_ in ("B", "Hq", "Hkv", "d")}, S=S,
            window=window, causal=causal)
        t["max_abs_err"], t["limit_share"] = err, share
        rows[f"flash_bwd {arch}" + ("" if causal else " bidirectional")] = t
        print(f"  kernel {t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, "
              f"sdpa backward{' (mask)' if window else ''} "
              f"{t['library']:.4f} ms, bound {t['bound']:.4f} "
              f"ms ({t['bound_by']}), {t['bound'] / t['kernel']:.4f} of "
              f"bound; max abs err vs plain {err:.3g} ({share:.3f} of the "
              f"limit); repeatable")
        del q_s, k_s, v_s, o_s, outs
    return rows


def _smoke_log(lines: list, sigterm_at: int | None):
    """A log callback for ``launch.train.main``: prints and keeps each
    line; at ``[loop] step <sigterm_at>`` it sends this process SIGTERM
    (the loop then checkpoints and stops at the step's end)."""
    def log(line: str) -> None:
        print(f"  {line}", flush=True)
        lines.append(line)
        if sigterm_at is not None and line.startswith(
                f"[loop] step {sigterm_at} "):
            os.kill(os.getpid(), signal.SIGTERM)
    return log


def train_phase(dev) -> dict:
    """Slice 12's main path: ``launch.train`` on smollm-360m at full width
    (``TRAIN_*``), stopped by SIGTERM at step 10 and resumed to step 20.
    The loss must fall; both attention kernels must launch and no plain
    version be called."""
    cfg = get_config(TRAIN_ARCH)
    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_B), "--seq", str(TRAIN_S), "--lr", str(TRAIN_LR),
            "--ckpt-dir", str(TRAIN_CKPT_DIR), "--ckpt-every",
            str(TRAIN_CKPT_EVERY), "--log-every", "1"]
    phase(f"main path, slice 12: launch.train on {TRAIN_ARCH} at full width "
          f"({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} / "
          f"{cfg.n_kv_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, bf16, remat), B = {TRAIN_B}, S = {TRAIN_S}, "
          f"{TRAIN_STEPS} steps; SIGTERM at step {TRAIN_CKPT_EVERY}, then a "
          f"resume from its checkpoint")
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    lines: list = []
    t0 = time.monotonic()
    state, ls1 = launch_train.main(argv, log=_smoke_log(
        lines, TRAIN_CKPT_EVERY))
    n_params = sum(p.numel() for p in state["params"].values())
    del state
    gc.collect()
    t1 = time.monotonic()
    state, ls2 = launch_train.main(argv, log=_smoke_log(lines, None))
    t2 = time.monotonic()
    launches, _ = read_counts()
    calls = dict(plain.calls)
    peak = torch.cuda.max_memory_allocated(dev)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    hist = ls1.history + ls2.history
    if not (ls1.preempted and ls1.step == TRAIN_CKPT_EVERY):
        raise SystemExit(f"the first run did not stop at step "
                         f"{TRAIN_CKPT_EVERY} on SIGTERM ({ls1.step})")
    if f"[loop] resumed from step {TRAIN_CKPT_EVERY}" not in lines \
            or ls2.history[0][0] != TRAIN_CKPT_EVERY + 1:
        raise SystemExit("the second run did not resume from the "
                         "checkpoint")
    if [s for s, _, _ in hist] != list(range(1, TRAIN_STEPS + 1)):
        raise SystemExit(f"steps run: {[s for s, _, _ in hist]}")
    losses = [loss for _, loss, _ in hist]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"the training loss did not fall: {losses}")
    step_s = statistics.median(dt for _, _, dt in hist)
    tokens = TRAIN_B * TRAIN_S
    print(f"  {n_params} parameters; loss {losses[0]:.4f} (step 1) -> "
          f"{losses[-1]:.4f} (step {TRAIN_STEPS}); median step "
          f"{1e3 * step_s:.1f} ms, {tokens / step_s:.1f} tokens/s, "
          f"6 N tokens at {6 * n_params * tokens / step_s / 1e12:.2f} "
          f"TFLOP/s = {6 * n_params * tokens / step_s / PEAK_BF16_OPS:.4f} "
          f"of the bf16 peak; runs {t1 - t0:.1f} s and {t2 - t1:.1f} s "
          f"wall (checkpoints included); max_memory_allocated "
          f"{peak / 2**30:.2f} GiB")
    print(f"  kernel launches {launches}; plain calls {calls}")
    if launches["flash_attention"] <= 0 or \
            launches["flash_attention_bwd"] <= 0:
        raise SystemExit("training did not launch both attention kernels")
    if calls.get("attention_ref", 0) or calls.get("attention_bwd_ref", 0) \
            or sum(calls.values()):
        raise SystemExit(f"training called a plain version: {calls}")
    return launches


def _loss_and_grads(model: LM, batch: dict) -> tuple:
    loss, _ = model.loss_fn(batch)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def _step_disagreement(loss_k, loss_p, grads_k: dict, grads_p: dict
                       ) -> tuple[float, float, str]:
    """(relative loss difference, the worst gradient's difference over its
    norm, that gradient's name) of a step through the kernels against the
    same step through the plain versions."""
    rel_loss = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    worst, worst_name = 0.0, ""
    for name, gp in grads_p.items():
        gk = grads_k[name].float()
        gp = gp.float()
        rel = float((gk - gp).norm() / gp.norm().clamp(min=1e-30))
        if rel > worst:
            worst, worst_name = rel, name
    return rel_loss, worst, worst_name


def train_compare_phase(dev) -> None:
    """One training step's loss and gradients through the kernels against
    the same step through the plain versions (``testing.plain_attention``
    in ``ops.flash_attention``'s place), smollm-360m at full width and
    depth 2."""
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=COMPARE_LAYERS)
    phase(f"check: one training step of {TRAIN_ARCH} at full width, depth "
          f"{COMPARE_LAYERS}, B = {TRAIN_B}, S = {TRAIN_S}, through the "
          f"kernels vs through the plain versions (loss within "
          f"{COMPARE_LOSS_RTOL:g} relative, each gradient within "
          f"{COMPARE_GRAD_RTOL:g} of its norm)")
    model = LM(cfg, dev, torch.Generator(dev).manual_seed(0))
    model.requires_grad_(True)
    batch = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                   global_batch=TRAIN_B), device=dev
                        ).batch_at(0)
    reset_counts()
    loss_k, grads_k = _loss_and_grads(model, batch)
    launches, plain_calls = read_counts()
    flash = ops.flash_attention
    ops.flash_attention = testing.plain_attention
    try:
        loss_p, grads_p = _loss_and_grads(model, batch)
    finally:
        ops.flash_attention = flash
    torch.cuda.synchronize()
    if plain_calls or launches["flash_attention_bwd"] != COMPARE_LAYERS:
        raise SystemExit(f"the kernel step: launches {launches}, plain "
                         f"calls {plain_calls}")
    rel_loss, worst, worst_name = _step_disagreement(loss_k, loss_p,
                                                     grads_k, grads_p)
    print(f"  loss {float(loss_k):.6f} (kernels) vs {float(loss_p):.6f} "
          f"(plain): {rel_loss:.3g} relative; worst gradient {worst_name}: "
          f"{worst:.3g} of its norm; {len(grads_p)} gradients")
    if not rel_loss <= COMPARE_LOSS_RTOL or not worst <= COMPARE_GRAD_RTOL:
        raise SystemExit("the kernel step disagrees with the plain step")
    del model, grads_k, grads_p
    gc.collect()
    torch.cuda.empty_cache()


def _saturation_probe(scan, count: torch.Tensor):
    """``scan`` (``ops.rglru_scan``) adding to ``count``, on the card, the
    entries of a at 1 or above that reach it (remat's recomputes too)."""
    def probe(x, a, h0=None):
        count.add_((a >= 1).sum())
        return scan(x, a, h0)
    return probe


def train_report(dev, arch: str, n_params: int, B: int, hist: list,
                 note: str, extra: str = "") -> dict:
    """Prints a train run of ``RTRAIN_STEPS`` steps at S = ``RTRAIN_S``
    (``hist``: (loss, seconds) a step): the loss at its ends, the median
    step, tokens/s, 6 N tokens' share of the bf16 peak and the peak
    memory, then the launches.  The loss must be finite and fall, the
    run launch ``RTRAIN_KERNELS[arch]`` and call no plain version.
    Returns the launches."""
    launches, _ = read_counts()
    calls = dict(plain.calls)
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [loss for loss, _ in hist]
    step_s = statistics.median(dt for _, dt in hist)
    tokens = B * RTRAIN_S
    flops = 6 * n_params * tokens / step_s
    print(f"  {n_params} parameters; loss {losses[0]:.4f} (step 1) -> "
          f"{losses[-1]:.4f} (step {RTRAIN_STEPS}); median step "
          f"{1e3 * step_s:.1f} ms, {tokens / step_s:.1f} tokens/s, 6 N "
          f"tokens at {flops / 1e12:.2f} TFLOP/s = "
          f"{flops / PEAK_BF16_OPS:.4f} of the bf16 peak; {note}; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    print(f"  kernel launches {launches}; plain calls {calls}"
          + (f"; {extra}" if extra else ""))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"the {arch} training loss did not fall: {losses}")
    if not all(launches[k] > 0 for k in RTRAIN_KERNELS[arch]):
        raise SystemExit(f"training {arch} did not launch "
                         f"{RTRAIN_KERNELS[arch]}")
    if sum(calls.values()):
        raise SystemExit(f"training {arch} called a plain version: {calls}")
    return launches


def recurrent_train_phase(dev, arch: str, layers: int, B: int,
                          lr: float) -> dict:
    """Slice 14's main path: ``train.step`` and ``train.loop`` on ``arch``
    at full width and ``layers`` deep (``RTRAIN``).  The loss must fall;
    the run must launch ``RTRAIN_KERNELS[arch]``, call no plain version
    and give rglru_scan no saturated gate (a >= 1)."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    phase(f"main path, slice 14: train.step and train.loop on {arch} at "
          f"full width, {layers} of its {full.n_layers} layers "
          f"({cfg.layer_plan()}, d_model {cfg.d_model}, vocab {cfg.vocab}, "
          f"{cfg.dtype}, remat {cfg.remat}), B = {B}, S = {RTRAIN_S}, "
          f"{RTRAIN_STEPS} steps of AdamW at lr {lr:g}")
    shutil.rmtree(RTRAIN_CKPT_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = LM(cfg, dev, torch.Generator(dev).manual_seed(0))
    n_params = model.param_count()
    ocfg = OptConfig(lr=lr, total_steps=RTRAIN_STEPS, warmup_steps=5)
    step = build_train_step(model, ocfg)
    stream = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=RTRAIN_S,
                                    global_batch=B), device=dev)
    loop_cfg = LoopConfig(total_steps=RTRAIN_STEPS,
                          ckpt_dir=str(RTRAIN_CKPT_DIR),
                          ckpt_every=RTRAIN_STEPS, log_every=1)
    saturated = torch.zeros((), dtype=torch.int64, device=dev)
    keep = ops.rglru_scan
    ops.rglru_scan = _saturation_probe(keep, saturated)
    reset_counts()
    lines: list = []
    t0 = time.monotonic()
    try:
        # The fresh state goes straight to the loop (as launch.train passes
        # it): held here, its moments would stay alive beside every step's.
        state, ls = train_loop_run(loop_cfg, state=init_state(model, ocfg),
                                   train_step=step, stream=stream,
                                   log=_smoke_log(lines, None))
    finally:
        ops.rglru_scan = keep
    wall = time.monotonic() - t0
    if [s_ for s_, _, _ in ls.history] != list(range(1, RTRAIN_STEPS + 1)):
        raise SystemExit(f"steps run: {[s_ for s_, _, _ in ls.history]}")
    launches = train_report(
        dev, arch, n_params, B, [(loss, dt) for _, loss, dt in ls.history],
        f"run {wall:.1f} s wall (its last-step checkpoint included)",
        f"a >= 1 reaching rglru_scan: {int(saturated)}")
    if int(saturated):
        raise SystemExit(f"training {arch}: {int(saturated)} saturated "
                         f"gates (a >= 1, a NaN gradient) reached rglru_scan")
    print(f"  profile: one more train step (step {RTRAIN_STEPS + 1})")
    state = _profiled_step(step, state, stream.batch_at(RTRAIN_STEPS))
    del state, step, model, stream
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(RTRAIN_CKPT_DIR, ignore_errors=True)
    return launches


def compare_steps_phase(dev, runs) -> None:
    """One training step of each model of ``runs`` ((arch, depth, B): the
    recurrent families' ``RCOMPARE`` and slice 16's ``FAMILY_COMPARE``)
    at full width, S = ``RCOMPARE_S``, through the kernels against the
    same step through the plain versions (``testing.plain_selective_scan``,
    ``plain_rglru_scan`` and ``plain_attention`` in the wrappers'
    places)."""
    for arch, layers, B in runs:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        if cfg.family == "encdec":
            cfg = dataclasses.replace(cfg, n_enc_layers=layers)
        phase(f"check: one training step of {arch} at full width, depth "
              f"{layers} ({dec_plan(cfg)}), B = {B}, S = {RCOMPARE_S}"
              f"{prefix_note(cfg)}, through the kernels vs through the "
              f"plain versions (loss "
              f"within {COMPARE_LOSS_RTOL:g} relative, each gradient within "
              f"{COMPARE_GRAD_RTOL:g} of its norm)")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        model = LM(cfg, dev, torch.Generator(dev).manual_seed(0))
        draw_qkv_biases(model, 1)
        n_params = model.param_count()
        model.requires_grad_(True)
        batch = lm_batch(cfg, B, RCOMPARE_S, 0, dev)
        reset_counts()
        loss_k, grads_k = _loss_and_grads(model, batch)
        launches, plain_calls = read_counts()
        keep = (ops.flash_attention, ops.selective_scan, ops.rglru_scan)
        ops.flash_attention = testing.plain_attention
        ops.selective_scan = testing.plain_selective_scan
        ops.rglru_scan = testing.plain_rglru_scan
        try:
            loss_p, grads_p = _loss_and_grads(model, batch)
        finally:
            ops.flash_attention, ops.selective_scan, ops.rglru_scan = keep
        torch.cuda.synchronize()
        if plain_calls or not all(launches[k] > 0
                                  for k in RTRAIN_KERNELS[arch]):
            raise SystemExit(f"the kernel step: launches {launches}, plain "
                             f"calls {plain_calls}")
        rel_loss, worst, worst_name = _step_disagreement(loss_k, loss_p,
                                                         grads_k, grads_p)
        print(f"  {n_params} parameters; loss {float(loss_k):.6f} (kernels) "
              f"vs {float(loss_p):.6f} (plain): {rel_loss:.3g} relative; "
              f"worst gradient {worst_name}: {worst:.3g} of its norm; "
              f"{len(grads_p)} gradients; kernel launches "
              f"{ {k: launches[k] for k in RTRAIN_KERNELS[arch]} }; "
              f"max_memory_allocated "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        if not rel_loss <= COMPARE_LOSS_RTOL or \
                not worst <= COMPARE_GRAD_RTOL:
            raise SystemExit(f"the {arch} kernel step disagrees with the "
                             f"plain step")
        del model, grads_k, grads_p
        gc.collect()
        torch.cuda.empty_cache()


# -- the MoE and encoder-decoder families (slice 16) ------------------------

# The encoder-decoder serve run: seamless-m4t-medium at full width and
# depth (12 encoder and 12 decoder layers, 0.98 B parameters), bf16, seed
# 0, through LM.prefill then greedy LM.decode_step (the reference's
# ServeEngine takes no src_embeds or mem_len): 8 requests in one prefill,
# each a 48-token prompt and 1024 frames of src_embeds from the seed,
# 64 tokens each; every row attends its whole memory (mem_len 1024, as
# the prefill does).
ENCDEC_ARCH = "seamless-m4t-medium"
ENCDEC_SERVE = dict(B=8, prompt=48, frames=1024, tokens=64)
# The new families' training runs through train.step (bf16, remat, S =
# RTRAIN_S, the reference's train_4k length, weights from seed 0, AdamW, 5
# warm-up steps then cosine, RTRAIN_STEPS steps): (arch, depth or None, B,
# lr).  moonshot at 4 of its 48 layers (2.95 B parameters: 35 GB of
# parameters, gradients and float32 moments at 12 bytes a parameter, so
# full depth's 28 B cannot train on one card); seamless at full width and
# depth, its src_embeds 4096 frames from the seed.  No checkpoint is
# written (train.loop writes one at the last step: 29.5 GB for moonshot,
# which would outlast the run; slice 12's run covers the checkpoint path).
# Slice 23, the dense archs: llava-next-34b at 4 of its 60 layers, B = 1,
# each sequence its 576 patch rows from the seed and 4096 tokens (3.17 B
# parameters, 38 GB at 12 bytes a parameter: full depth's 413 GB cannot
# train on one card); qwen2.5-3b (3.40 B, 40.8 GB) at full depth, B = 1;
# tinyllama-1.1b (1.10 B, 13.2 GB) at full depth, B = 2.
FAMILY_TRAIN = (("moonshot-v1-16b-a3b", 4, 2, TRAIN_LR),
                (ENCDEC_ARCH, None, 2, TRAIN_LR),
                ("llava-next-34b", 4, 1, TRAIN_LR),
                ("qwen2.5-3b", None, 1, TRAIN_LR),
                ("tinyllama-1.1b", None, 2, TRAIN_LR))
# The kernel-against-plain steps at full width, B = 1, S = RCOMPARE_S:
# moonshot at depth 2, seamless with 2 encoder and 2 decoder layers, and
# grok-1 at depth 1 (6.53 B parameters: an AdamW step's 12 bytes a
# parameter is 78 GB before activations, so grok-1 trains on the card at
# no depth; its loss and gradients are checked instead); slice 23's dense
# archs at depth 2, llava's patch rows in front of its tokens.
FAMILY_COMPARE = (("moonshot-v1-16b-a3b", 2, 1), (ENCDEC_ARCH, 2, 1),
                  ("grok-1-314b", 1, 1), ("llava-next-34b", 2, 1),
                  ("qwen2.5-3b", 2, 1), ("tinyllama-1.1b", 2, 1))


def lm_batch(cfg, B: int, S: int, i: int, dev) -> dict:
    """Batch i of the synthetic token stream, with an encoder-decoder
    model's ``src_embeds`` (S frames, float32 normals from seed 1000 + i,
    in bf16) or a VLM's ``patch_embeds`` (its ``n_frontend_tokens`` rows,
    float32 normals from seed 2000 + i, in bf16)."""
    batch = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=S,
                                   global_batch=B), device=dev).batch_at(i)
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.randn(
            B, S, cfg.d_model, device=dev,
            generator=torch.Generator(dev).manual_seed(1000 + i)).to(
                torch.bfloat16)
    if cfg.frontend == "patch":
        batch["patch_embeds"] = torch.randn(
            B, cfg.n_frontend_tokens, cfg.d_model, device=dev,
            generator=torch.Generator(dev).manual_seed(2000 + i)).to(
                torch.bfloat16)
    return batch


def prefix_note(cfg) -> str:
    """A VLM's patch rows in front of each sequence, for a header."""
    n = cfg.n_frontend_tokens if cfg.frontend == "patch" else 0
    return f" (+ {n} patch rows in front: {n} + S rows)" if n else ""


def encdec_serve_phase(dev) -> tuple[dict, tuple]:
    """The encoder-decoder serve run (``ENCDEC_SERVE``), with the counts
    set to 0 just before it and read just after: one prefill (the encoder
    over every row's frames, the decoder over the prompts) and greedy
    decode steps, each tick's tokens copied to the host as a server
    streams them.  Exact launches: flash once per encoder, self- and
    cross-attention layer, decode twice per decoder layer a tick; no
    plain call; tokens in range; the consistency check.  Returns the
    launches and what the profile needs."""
    cfg = get_config(ENCDEC_ARCH)
    B, P, Se, T = (ENCDEC_SERVE[k] for k in ("B", "prompt", "frames",
                                             "tokens"))
    phase(f"main path, slice 16: {ENCDEC_ARCH} at full width and depth "
          f"({cfg.n_enc_layers} encoder and {cfg.n_layers} decoder layers) "
          f"through LM.prefill and LM.decode_step: {B} requests in one "
          f"prefill, prompts of {P} tokens, {Se} frames of src_embeds each, "
          f"{T} tokens each")
    t0 = time.monotonic()
    model = LM(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = model.param_count()
    print(f"  {n_params / 1e9:.4f} B parameters ({2 * n_params / 1e9:.2f} "
          f"GB in bf16), d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.hd}, vocab {cfg.vocab} (padded {cfg.vocab_padded}), "
          f"initialised in {time.monotonic() - t0:.2f} s")
    L = SERVE_ENGINE.cache_len
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        3, cfg.vocab, size=(B, P)), dtype=torch.long, device=dev)
    src = torch.randn(B, Se, cfg.d_model, device=dev,
                      generator=torch.Generator(dev).manual_seed(0)).to(
                          torch.bfloat16)
    mem_len = torch.full((B,), Se, dtype=torch.int32, device=dev)

    def serve(n_tokens: int) -> tuple:
        t0 = time.monotonic()
        logits, caches = model.prefill({"tokens": prompts,
                                        "src_embeds": src}, L)
        out = [logits.argmax(-1).tolist()]
        t1 = time.monotonic()
        lengths = torch.full((B,), P, dtype=torch.int32, device=dev)
        for _ in range(n_tokens - 1):
            tok = torch.as_tensor(out[-1], device=dev)[:, None]
            logits = model.decode_step({"tokens": tok, "lengths": lengths,
                                        "mem_len": mem_len}, caches)
            out.append(logits.argmax(-1).tolist())
            lengths += 1
        return np.array(out).T, caches, t1 - t0, time.monotonic() - t1

    serve(2)                            # warm cuBLAS and the allocator
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    reset_counts()
    toks, caches, pre_s, dec_s = serve(T)
    torch.cuda.synchronize()
    launches, plain_calls = read_counts()
    ticks = T - 1
    expected = dict.fromkeys(KERNELS, 0)
    expected.update(flash_attention=cfg.n_enc_layers + 2 * cfg.n_layers,
                    decode_attention=2 * cfg.n_layers * ticks)
    print(f"  prefill {B * P} tokens and {B * Se} frames in {pre_s:.3f} s "
          f"({B * P / pre_s:.1f} tokens/s); decode {B * ticks} tokens in "
          f"{dec_s:.3f} s ({B * ticks / dec_s:.1f} tokens/s, "
          f"{1e3 * dec_s / ticks:.2f} ms per tick); peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    print("  launches: " + ", ".join(
        f"{k} {launches[k]} (expected {expected[k]})" for k in KERNELS
        if expected[k] or launches[k]) + f"; plain calls {plain_calls}")
    if toks.shape != (B, T) or not ((0 <= toks)
                                    & (toks < cfg.vocab_padded)).all():
        raise SystemExit(f"the {ENCDEC_ARCH} serve run emitted "
                         f"{toks.shape} tokens or tokens out of range")
    if launches != expected or plain_calls != 0:
        raise SystemExit(f"the {ENCDEC_ARCH} serve run did not go through "
                         f"its kernels alone")
    # Request 0: its second token's decode-step logits against a
    # re-prefill of (prompt + first token) over the same frames.
    ext = torch.cat([prompts[:1], torch.as_tensor(
        toks[:1, :1], device=dev)], dim=1)
    top, err, _ = _decode_vs_reprefill(
        model, ext, dev, {"src_embeds": src[:1], "mem_len": mem_len[:1]},
        recurrent=False)
    tol = CONSISTENCY_ULPS * bf16_ulp(top)
    print(f"  consistency, request 0 (prompt {P}, {Se} frames): decode-step "
          f"logits vs re-prefill max abs err {err:.4f} (logits up to "
          f"{top:.2f}; tolerance {CONSISTENCY_ULPS} bf16 ulps there, "
          f"{tol:g})")
    if err > tol:
        raise SystemExit(f"the {ENCDEC_ARCH} decode step disagrees with a "
                         f"re-prefill")
    batch = {"tokens": torch.as_tensor(toks[:, -1:], device=dev),
             "lengths": torch.full((B,), P + T - 1, dtype=torch.int32,
                                   device=dev), "mem_len": mem_len}
    return launches, (model, {"tokens": prompts[:1], "src_embeds": src[:1]},
                      batch, caches)


def family_serve_phase(dev) -> dict:
    """The encoder-decoder serve run, then a profile of one prefill of
    request 0 (its encoder and decoder) and of 8 decode ticks of the
    batch."""
    launches, (model, one, batch, caches) = encdec_serve_phase(dev)
    profile_calls(ENCDEC_ARCH, (
        ("one prefill (1 request)", lambda: model.prefill(
            one, SERVE_ENGINE.cache_len)),
        (f"8 decode ticks of the {ENCDEC_SERVE['B']}-row batch",
         lambda: [model.decode_step(batch, caches) for _ in range(8)])))
    del model, one, batch, caches
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def family_train_phase(dev, arch: str, layers: int | None, B: int,
                       lr: float) -> dict:
    """Slice 16's training runs (``FAMILY_TRAIN``) through ``train.step``,
    each step timed on the host clock to a synchronisation.  The loss must
    fall and be finite, an MoE model's aux metric finite; the attention
    kernels must launch both ways and no plain version be called.  Then
    one profiled step."""
    full = get_config(arch)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          n_layers=layers)
    phase(f"main path: train.step on {arch} at full width, "
          f"{cfg.n_layers} of its {full.n_layers} layers"
          + (f" and {cfg.n_enc_layers} encoder layers"
             if cfg.family == "encdec" else "")
          + f" ({dec_plan(cfg)}, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab}, {cfg.dtype}, remat {cfg.remat}), B = {B}, S = "
          f"{RTRAIN_S}{prefix_note(cfg)}, {RTRAIN_STEPS} steps of AdamW at "
          f"lr {lr:g}; no checkpoint")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = LM(cfg, dev, torch.Generator(dev).manual_seed(0))
    n_params = model.param_count()
    ocfg = OptConfig(lr=lr, total_steps=RTRAIN_STEPS, warmup_steps=5)
    step = build_train_step(model, ocfg)
    state = init_state(model, ocfg)
    reset_counts()
    hist = []
    t_run = time.monotonic()
    for i in range(RTRAIN_STEPS):
        batch = lm_batch(cfg, B, RTRAIN_S, i, dev)
        t0 = time.monotonic()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        hist.append((float(met["loss"]), float(met["aux"]), dt))
        print(f"  step {i + 1} loss {hist[-1][0]:.4f} aux {hist[-1][1]:.4f} "
              f"dt {1e3 * dt:.0f}ms", flush=True)
    wall = time.monotonic() - t_run
    launches = train_report(
        dev, arch, n_params, B, [(loss, dt) for loss, _, dt in hist],
        f"run {wall:.1f} s wall"
        + ("; 6 N counts every expert, more than a step computes"
           if cfg.n_experts else ""))
    if cfg.n_experts and not all(np.isfinite(a) and a > 0
                                 for _, a, _ in hist):
        raise SystemExit(f"the {arch} aux metric: {[a for _, a, _ in hist]}")
    print(f"  profile: one more train step (step {RTRAIN_STEPS + 1})")
    state = _profiled_step(step, state, lm_batch(cfg, B, RTRAIN_S,
                                                 RTRAIN_STEPS, dev),
                           leaf_kinds(cfg)["moe"])
    del state, step, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# Device-kernel groups of the training profile, by name.
TRAIN_GROUPS = (("attention backward (flash_attention_bwd.cu)",
                 ("flash_bwd",)),
                ("attention forward (flash_attention.cu)",
                 ("flash_attention",)),
                ("selective-scan backward (selective_scan_bwd.cu)",
                 ("sscan_bwd",)),
                ("selective-scan forward (selective_scan.cu)",
                 ("selective_scan_kernel",)),
                ("RG-LRU backward (rglru_scan_bwd.cu)", ("rglru_bwd",)),
                ("RG-LRU forward (rglru_scan.cu)", ("rglru_scan_kernel",)),
                ("products (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma")))


def train_profile_phase(dev) -> None:
    """torch.profiler over one train step of the full-width run's model
    (after one warm step): device busy share and device time by kernel
    group (``TRAIN_GROUPS``) and by kernel."""
    cfg = get_config(TRAIN_ARCH)
    phase(f"profile: one train step of {TRAIN_ARCH} at full width (B = "
          f"{TRAIN_B}, S = {TRAIN_S}, remat; after one warm step)")
    model = LM(cfg, dev, torch.Generator(dev).manual_seed(0))
    ocfg = OptConfig(lr=TRAIN_LR, total_steps=TRAIN_STEPS, warmup_steps=5)
    state = init_state(model, ocfg)
    step = build_train_step(model, ocfg)
    stream = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                    global_batch=TRAIN_B), device=dev)
    state, _ = step(state, stream.batch_at(0))
    torch.cuda.synchronize()
    state = _profiled_step(step, state, stream.batch_at(1))
    del model, state, step
    gc.collect()
    torch.cuda.empty_cache()


def _profiled_step(step, state, batch, moe_layers: int = 0):
    """One train step under torch.profiler: prints the device busy share
    and device time by kernel group (``TRAIN_GROUPS``) and by kernel, and
    an MoE model's pieces; returns the new state."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    rows, total = _kernel_times(prof)
    print(f"  wall {1e3 * wall:.3f} ms under the profiler, device kernel "
          f"time {total:.3f} ms ({100 * total / 1e3 / wall:.2f} % busy); "
          f"loss {float(met['loss']):.4f}")
    if moe_layers:
        print_moe_shares(prof, total, moe_layers)
    groups = dict.fromkeys([g for g, _ in TRAIN_GROUPS] + ["other"], 0.0)
    for name, ms, _ in rows:
        g = next((g for g, keys in TRAIN_GROUPS
                  if any(k in name for k in keys)), "other")
        groups[g] += ms
    for g, ms in groups.items():
        print(f"  {ms:10.3f} ms ({100 * ms / total:5.1f} %)  {g}")
    for name, ms, n in rows[:10]:
        print(f"  {ms:10.3f} ms {n:6d} x  {name[:90]}")
    return state


# -- model parallelism (slice 17) --------------------------------------------
# The DTensor step on a (1, 1) mesh of one NCCL rank against the plain step
# from the same seed: smollm-360m at TRAIN_* for SHARD_STEPS steps, then
# (arch, layers, B) at full width, S = RTRAIN_S, SHARD_FAMILY_STEPS steps.
SHARD_STEPS = 4
SHARD_FAMILY = (("falcon-mamba-7b", 1, 2), ("moonshot-v1-16b-a3b", 1, 1))
SHARD_FAMILY_STEPS = 2
SHARD_KERNELS = {TRAIN_ARCH: ("flash_attention", "flash_attention_bwd"),
                 "falcon-mamba-7b": ("selective_scan", "selective_scan_bwd"),
                 "moonshot-v1-16b-a3b": ("flash_attention",
                                         "flash_attention_bwd")}
PSUM_SHAPE = (8192, 8192)
SHARD_DIR = Path(__file__).resolve().parent / "build" / "smoke_shard"


def _lockstep(arch: str, cfg, B: int, S: int, steps: int, mesh, dev
              ) -> dict:
    """``steps`` plain and DTensor steps in turns from one seed (each
    timed on the host clock to a synchronisation), held equal bit for bit
    after every step; the counts are set to 0 just before each DTensor
    step and read just after.  Returns the DTensor steps' launches."""
    ocfg = OptConfig(lr=TRAIN_LR, total_steps=TRAIN_STEPS, warmup_steps=5)
    gc.collect()
    torch.cuda.empty_cache()
    plain_model = LM(cfg, dev, torch.Generator(dev).manual_seed(0))
    plain_step = build_train_step(plain_model, ocfg)
    plain_state = init_state(plain_model, ocfg)
    model = LM(cfg, dev, torch.Generator(dev).manual_seed(0))
    state, step, _ = launch_train.sharded_training(model, ocfg, mesh)
    launches = dict.fromkeys(KERNELS, 0)
    calls = 0
    t_plain, t_dt = [], []
    for i in range(steps):
        batch = lm_batch(cfg, B, S, i, dev)
        t0 = time.monotonic()
        plain_state, mp_ = plain_step(plain_state, batch)
        torch.cuda.synchronize()
        t_plain.append(time.monotonic() - t0)
        reset_counts()
        t0 = time.monotonic()
        state, md = step(state, batch)
        torch.cuda.synchronize()
        t_dt.append(time.monotonic() - t0)
        n, c = read_counts()
        calls += c
        for k, v in n.items():
            launches[k] += v
        differ = [name for name, p in plain_state["params"].items()
                  if not torch.equal(p, state["params"][name].full_tensor())]
        same = (torch.equal(mp_["loss"], md["loss"])
                and torch.equal(mp_["grad_norm"], md["grad_norm"]))
        print(f"  step {i + 1}: loss {float(md['loss']):.6f} (DTensor) / "
              f"{float(mp_['loss']):.6f} (plain), grad_norm "
              f"{float(md['grad_norm']):.6f} / {float(mp_['grad_norm']):.6f}"
              f"; {len(plain_state['params']) - len(differ)} of "
              f"{len(plain_state['params'])} parameters equal; "
              f"{1e3 * t_dt[-1]:.1f} / {1e3 * t_plain[-1]:.1f} ms",
              flush=True)
        if not same or differ:
            raise SystemExit(f"{arch}: the DTensor step differs from the "
                             f"plain step at step {i + 1} (parameters "
                             f"{differ[:5]})")
    print(f"  {arch}: median of steps 2-{steps}: "
          f"{1e3 * statistics.median(t_dt[1:]):.1f} ms (DTensor, (1, 1) "
          f"mesh) vs {1e3 * statistics.median(t_plain[1:]):.1f} ms (plain); "
          f"step 1 {1e3 * t_dt[0]:.1f} / {1e3 * t_plain[0]:.1f} ms; "
          f"DTensor launches {launches}; plain calls {calls}")
    if calls or any(launches[k] <= 0 for k in SHARD_KERNELS[arch]):
        raise SystemExit(f"{arch}: the DTensor steps did not go through "
                         f"{SHARD_KERNELS[arch]} alone")
    del plain_state, state, plain_model, model, step, plain_step
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def sharding_phase(dev) -> dict:
    """Slice 17's main path: model parallelism's DTensor step on a (1, 1)
    mesh of one NCCL rank, bit for bit the plain step; compressed_psum;
    the launcher's divisibility assertion.  Returns the DTensor steps'
    launches."""
    phase("main path, slice 17: model parallelism on a (1, 1) DeviceMesh "
          "of one NCCL rank: the DTensor step against the plain step, bit "
          "for bit")
    t_phase = time.monotonic()
    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    SHARD_DIR.mkdir(parents=True)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(SHARD_DIR / "store"), 1), rank=0, world_size=1, device_id=dev)
    launches = dict.fromkeys(KERNELS, 0)
    try:
        mesh = make_host_mesh(1)
        cfg = get_config(TRAIN_ARCH)
        print(f"  {TRAIN_ARCH} at full width and depth ({cfg.n_layers} "
              f"layers, bf16, remat), B = {TRAIN_B}, S = {TRAIN_S}, "
              f"{SHARD_STEPS} steps", flush=True)
        runs = [(TRAIN_ARCH, cfg, TRAIN_B, TRAIN_S, SHARD_STEPS)]
        for arch, layers, B in SHARD_FAMILY:
            runs.append((arch, dataclasses.replace(get_config(arch),
                                                   n_layers=layers),
                         B, RTRAIN_S, SHARD_FAMILY_STEPS))
        for arch, cfg, B, S, steps in runs:
            if arch != TRAIN_ARCH:
                print(f"  {arch} at full width, {cfg.n_layers} layer, B = "
                      f"{B}, S = {S}, {steps} steps", flush=True)
            for k, n in _lockstep(arch, cfg, B, S, steps, mesh, dev
                                  ).items():
                launches[k] += n
        x = torch.randn(PSUM_SHAPE, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
        want = topt.dequantize_int8(*topt.quantize_int8(x), x.shape)
        got = topt.compressed_psum(x, "data", mesh=mesh)
        if not torch.equal(got, want):
            raise SystemExit("compressed_psum differs from "
                             "dequantize_int8(quantize_int8(x))")
        del want, got
        ms, _ = kt.batched_ms({
            "psum": lambda: topt.compressed_psum(x, "data", mesh=mesh),
            "local": lambda: topt.dequantize_int8(*topt.quantize_int8(x),
                                                  x.shape)}, 1, 10)
        print(f"  compressed_psum over the one-rank 'data' axis, float32 "
              f"{PSUM_SHAPE[0]} x {PSUM_SHAPE[1]}: bit for bit "
              f"dequantize_int8(quantize_int8(x)); {ms['psum']:.3f} ms a "
              f"call, of which the quantize-dequantize alone "
              f"{ms['local']:.3f} ms")
        del x
        try:
            launch_train.main(["--model-par", "2", "--steps", "1",
                               "--ckpt-dir", str(SHARD_DIR / "ckpt")],
                              log=lambda *_: None)
        except AssertionError:
            print("  launch.train --model-par 2 on one rank: the "
                  "reference's assertion (the model axis must divide the "
                  "ranks)")
        else:
            raise SystemExit("launch.train --model-par 2 ran on one rank")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(SHARD_DIR, ignore_errors=True)
    print(f"  sharding phase {time.monotonic() - t_phase:.1f} s")
    return launches


# Slice 18: the production dry run's cells on the card's fake tensors (a
# fake group of 256 ranks, rank 0's program): a train cell, a decode cell
# whose cache the rules split over its positions (qwen3-1.7b's 8 KV heads
# do not divide the model axis of 16), an MoE prefill with its experts
# split; slice 19 adds the SSM and hybrid prefills, whose counts torch
# 2.11 once took other layouts for; slice 20 the MoE train step, whose
# router's weight gradient each model rank computes a block of rows of
# (at 8 of its 48 layers: about 40 s to count, 4 min at full depth).
# (arch, shape, layers or None for the full depth), each in a process of
# its own, all at once.
DRYRUN_CELLS = (("qwen3-1.7b", "train_4k", None),
                ("qwen3-1.7b", "decode_32k", None),
                ("moonshot-v1-16b-a3b", "prefill_32k", None),
                ("falcon-mamba-7b", "prefill_32k", None),
                ("recurrentgemma-9b", "prefill_32k", None),
                ("moonshot-v1-16b-a3b", "train_4k", 8))
# Slice 21: multi-pod cells on the (2, 16, 16) mesh (512 fake ranks, pods
# of 256, the pod axis plain data parallelism): the MoE train step, whose
# router's weight gradient each rank computes whole there, and the dense
# train and decode steps; counted beside the single-pod ones, all at once.
DRYRUN_MULTI_CELLS = (("moonshot-v1-16b-a3b", "train_4k", 2),
                      ("qwen3-1.7b", "train_4k", 2),
                      ("qwen3-1.7b", "decode_32k", None))
# Counted on the card's fake tensors and on fake CPU tensors after the
# sharding phase's NCCL steps, the two must agree field for field:
# recurrentgemma-9b decode_32k cut to 3 layers and a window of 8 on a
# (1, 2) fake group (a position-split ring cache), the cell whose fake
# "cuda" count once depended on what the process ran before.
DRYRUN_ORDER_CELL = ("recurrentgemma-9b", ShapeSpec("decode_32k", 16, 2,
                                                    "decode"),
                     (1, 2), {"n_layers": 3, "window": 8})
DRYRUN_ORDER_FIELDS = ("flops_total", "bytes_accessed_total",
                       "convert_bytes_total", "collectives", "kernel_calls",
                       "memory_analysis")
# The JAX package's records of those cells, compiled on 256 host devices
# (the card has no JAX): ``tests/_torch_dryrun_reference.py``.
DRYRUN_REFERENCE = (Path(__file__).resolve().parent / "tests" / "data"
                    / "dryrun_reference_single.json")
# ... and of the multi-pod cells, on 512 host devices, with the bytes that
# cross pods recounted from the compiled groups
# (``cross_pod_exact_bytes_per_chip``).
DRYRUN_MULTI_REFERENCE = DRYRUN_REFERENCE.with_name(
    "dryrun_reference_multi.json")
# Slice 22: the port's own counts of the multi-pod cells on the torch
# release that wrote them (``PYTHONPATH=src python
# tests/_torch_dryrun_reference.py --port tests/data/dryrun_port_multi.json
# --mesh multi``, on the CPU without JAX): the card's
# release must count the same wire bytes a chip, within
# ``DRYRUN_RELEASE_SLACK``, the cells ``DRYRUN_RELEASE_CELLS`` (the MoE
# train step, whose AdamW moments DTensor once resharded by other
# collectives on other releases; the AdamW update now chooses its own).
DRYRUN_PORT_MULTI = DRYRUN_REFERENCE.with_name("dryrun_port_multi.json")
DRYRUN_RELEASE_CELLS = ("moonshot-v1-16b-a3b/train_4k/n_layers=2",)
# Bytes: torch 2.11 and 2.13 were seen to count every other dry-run cell's
# wire within this.
DRYRUN_RELEASE_SLACK = 8400
# A cell's counted peak (arguments and temp) against the reference's:
# seen 0.067 (qwen3-1.7b train) to 0.808 (falcon-mamba-7b prefill) here,
# on torch 2.13; the XLA CPU backend's temp is no card's, so the limit
# holds the port to the reference's footprint, not to a ratio of it.
DRYRUN_REF_PEAK = 1.0
DRYRUN_DIR = Path(__file__).resolve().parent / "build" / "smoke_dryrun"
DRYRUN_TIMEOUT = 600
# The dry run's predicted peak of the one-card train step against
# torch.cuda.max_memory_allocated above the memory held before the model
# was built: the count has no allocator rounding (512-byte blocks),
# cuBLAS workspace or autograd bookkeeping.  Seen 0.12 % to 0.54 % below
# the measured on the H100; the limit is about four times that.
DRYRUN_PEAK_RTOL = 0.02


def _dryrun_cells() -> list:
    """Runs ``launch.dryrun`` on ``DRYRUN_CELLS`` (the single-pod mesh)
    and ``DRYRUN_MULTI_CELLS`` (the multi-pod mesh), the card's fake
    tensors, one process a cell, all at once, and returns the artifacts;
    exits unless each is ok with FLOPs, bytes and collective bytes."""
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    cells = ([(a, s, n, "single") for a, s, n in DRYRUN_CELLS]
             + [(a, s, n, "multi") for a, s, n in DRYRUN_MULTI_CELLS])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--out", str(DRYRUN_DIR)]
        + (["--layers", str(layers)] if layers else []),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for arch, shape, layers, mesh in cells]
    try:
        outs = [p.communicate(timeout=DRYRUN_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = []
    for (arch, shape, layers, mesh), p, out in zip(cells, procs, outs):
        path = DRYRUN_DIR / (f"{arch}__{shape}__{mesh}"
                             + (f"__{layers}l" if layers else "") + ".json")
        rec = json.loads(path.read_text()) if path.exists() else {}
        if p.returncode or not rec.get("ok") or not (
                rec["flops_total"] > 0 and rec["bytes_accessed_total"] > 0
                and rec["collectives"]["wire_bytes_per_chip"] > 0):
            raise SystemExit(f"dry run {arch} {shape} {mesh}: exit "
                             f"{p.returncode}, {rec.get('error')}\n"
                             f"{out[-3000:]}")
        recs.append(rec)
    return recs


def _hold_to_reference(recs: list) -> None:
    """Each dry-run cell against the JAX package's compiled one
    (``DRYRUN_REFERENCE``, a multi-pod cell ``DRYRUN_MULTI_REFERENCE``):
    FLOPs and argument bytes equal, total wire bytes a chip no more, a
    multi-pod cell's bytes that cross pods no more than the reference's
    exact recount, and arguments + temp no more than ``DRYRUN_REF_PEAK``
    times the reference's; exits on any miss."""
    refs = {"single": json.loads(DRYRUN_REFERENCE.read_text())["cells"],
            "multi": json.loads(DRYRUN_MULTI_REFERENCE.read_text())["cells"]}
    misses = []
    for rec in recs:
        r = refs[rec["mesh"]][f"{rec['arch']}/{rec['shape']}" + (
            f"/n_layers={rec['layers']}" if rec.get("layers") else "")]
        name = f"{rec['arch']} {rec['shape']} {rec['mesh']}"
        mr, mp = r["memory_analysis"], rec["memory_analysis"]
        peak = mp["argument_size_in_bytes"] + mp["temp_size_in_bytes"]
        limit = DRYRUN_REF_PEAK * (mr["argument_size_in_bytes"]
                                   + mr["temp_size_in_bytes"])
        wire = rec["collectives"]["wire_bytes_per_chip"]
        rwire = r["collectives"]["wire_bytes_per_chip"]
        cross = rec["collectives"]["cross_pod_bytes_per_chip"]
        rcross = r["collectives"].get("cross_pod_exact_bytes_per_chip", 0.0)
        print(f"  {name} against the reference: "
              f"flops {rec['flops_total']:.6e} / {r['flops_total']:.6e}, "
              f"arguments {mp['argument_size_in_bytes']} / "
              f"{mr['argument_size_in_bytes']} B, wire {wire / 1e9:.4f} / "
              f"{rwire / 1e9:.4f} GB, cross-pod {cross / 1e9:.4f} / "
              f"{rcross / 1e9:.4f} GB (the reference's own rule "
              f"{r['collectives']['cross_pod_bytes_per_chip'] / 1e9:.4f}), "
              f"peak {peak / 1e9:.3f} GB against {limit / 1e9:.3f} GB")
        if rec["flops_total"] != r["flops_total"]:
            misses.append(f"{name} flops")
        if mp["argument_size_in_bytes"] != mr["argument_size_in_bytes"]:
            misses.append(f"{name} arguments")
        if wire > rwire:
            misses.append(f"{name} wire")
        if cross > rcross:
            misses.append(f"{name} cross-pod")
        if peak > limit:
            misses.append(f"{name} peak")
    if misses:
        raise SystemExit("the dry run differs from the JAX package's "
                         "compiled cells: " + ", ".join(misses))


def _hold_to_release(recs: list) -> None:
    """Each multi-pod cell's wire bytes a chip on this torch release
    beside the port's count on the release that wrote
    ``DRYRUN_PORT_MULTI``; exits where a cell of
    ``DRYRUN_RELEASE_CELLS`` differs by more than
    ``DRYRUN_RELEASE_SLACK`` bytes."""
    there = json.loads(DRYRUN_PORT_MULTI.read_text())
    misses = []
    for rec in recs:
        if rec["mesh"] != "multi":
            continue
        key = f"{rec['arch']}/{rec['shape']}" + (
            f"/n_layers={rec['layers']}" if rec.get("layers") else "")
        if key not in there:
            continue
        o = there[key]
        wire = rec["collectives"]["wire_bytes_per_chip"]
        owire = o["collectives"]["wire_bytes_per_chip"]
        cross = rec["collectives"]["cross_pod_bytes_per_chip"]
        ocross = o["collectives"]["cross_pod_bytes_per_chip"]
        print(f"  {key} multi on torch {torch.__version__}: wire {wire:.1f} "
              f"B, torch {o['torch']} {owire:.1f} B (differ "
              f"{wire - owire:+.1f}); cross-pod {cross:.1f} / {ocross:.1f} "
              f"B (differ {cross - ocross:+.1f})", flush=True)
        if key in DRYRUN_RELEASE_CELLS and \
                abs(wire - owire) > DRYRUN_RELEASE_SLACK:
            misses.append(key)
    if misses:
        raise SystemExit(f"the multi-pod wire bytes differ from torch "
                         f"{there[misses[0]]['torch']}'s by more than "
                         f"{DRYRUN_RELEASE_SLACK} B: {misses}")


def _order_check(dev) -> None:
    """``DRYRUN_ORDER_CELL`` counted on fake tensors of the card and of
    the CPU, in this process after the earlier phases (the sharding
    phase's NCCL steps among them); exits unless the counts agree."""
    from repro_torch.launch import dryrun

    arch, spec, dims, cut = DRYRUN_ORDER_CELL
    cfg = get_config(arch).reduced(**cut)
    t0 = time.monotonic()
    got = []
    try:
        for d in (dev, torch.device("cpu")):
            mesh = dryrun.fake_mesh("single", d.type, dims=dims)
            got.append(dryrun.count_cell(arch, spec, mesh, d, cfg=cfg,
                                         microbatches=1))
            dist.destroy_process_group()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    card, cpu = got
    differ = [k for k in DRYRUN_ORDER_FIELDS if card[k] != cpu[k]]
    print(f"  {arch} {spec.name} {dims}, cut {cut}, after the earlier "
          f"phases: bytes {card['bytes_accessed_total']:.0f} on fake "
          f"{dev.type}, {cpu['bytes_accessed_total']:.0f} on fake cpu; "
          f"differing fields {differ} ({time.monotonic() - t0:.1f} s)",
          flush=True)
    if differ:
        raise SystemExit(f"the dry run's fake cuda and fake cpu counts "
                         f"differ in {differ}")


def dryrun_phase(dev) -> dict:
    """Slice 18's main path: the dry run and the roofline.  The
    production cells through ``python -m repro_torch.launch.dryrun``
    (fake "cuda" tensors, 256 fake ranks), their roofline rows at this
    card's rates; then the smoke's smollm-360m train step (``TRAIN_*``:
    B = 8, S = 2048, bf16, remat, no mesh) counted on fake tensors and run
    for real: the per-op product FLOPs equal to ``FlopCounterMode``'s, the
    kernels' counted calls equal to their launches, the predicted peak
    within ``DRYRUN_PEAK_RTOL`` of the measured, and the measured step
    not below the roofline's bound, the larger of its compute and memory
    terms (so that bytes counted too many can fail it).  Returns the real
    step's launches."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.registry import make_inputs
    from repro_torch.launch import dryrun, roofline

    def names(cells):
        return ", ".join(f"{a} {s}" + (f" ({n} layers)" if n else "")
                         for a, s, n in cells)

    phase(f"main path, slice 18: the dry run ({names(DRYRUN_CELLS)}; single "
          f"pod, 256 fake ranks; slice 21: {names(DRYRUN_MULTI_CELLS)}; two "
          f"pods, 512 fake ranks; fake cuda tensors) and the roofline at "
          f"this card's rates")
    t_phase = time.monotonic()
    recs = _dryrun_cells()
    rows = [roofline.roofline_row(rec) for rec in recs]
    print("  " + roofline.format_table(rows).replace("\n", "\n  "))
    for rec, row in zip(recs, rows):
        print(f"  {rec['arch']} {rec['shape']} {rec['mesh']}: "
              f"{rec['seconds']} s to count; "
              f"card {rec['card']}; flops {rec['flops_total']:.4g}, bytes "
              f"{rec['bytes_accessed_total']:.4g} (converts "
              f"{rec['convert_bytes_total']:.4g}), wire "
              f"{rec['collectives']['wire_bytes_per_chip']:.4g} B in "
              f"{rec['n_collective_lines']} collectives; kernels "
              f"{rec['kernel_calls']}; terms compute "
              f"{row['t_compute_s']:.4g} s, memory {row['t_memory_s']:.4g} "
              f"s, collective {row['t_collective_s']:.4g} s; peak "
              f"{row['hbm_gb_per_chip']:.3f} GB, fits {row['fits_hbm']}")
    print(f"  dry run cells {time.monotonic() - t_phase:.1f} s", flush=True)
    _hold_to_reference(recs)
    _hold_to_release(recs)
    _order_check(dev)

    cfg = get_config(TRAIN_ARCH)
    opt = OptConfig(lr=TRAIN_LR)
    print(f"  {TRAIN_ARCH} train step, B = {TRAIN_B}, S = {TRAIN_S}, bf16, "
          f"remat, no mesh: counted on fake tensors, then run", flush=True)
    with dryrun.fake_execution():
        fmodel = LM(cfg, dev)
        fstate = init_state(fmodel, opt)
        fstep = build_train_step(fmodel, opt)
        fbatch = make_inputs(cfg, "train", TRAIN_B, TRAIN_S, dev)
        counted = dryrun.count(lambda: fstep(fstate, fbatch),
                               (fstate, fbatch))
    del fmodel, fstate, fstep, fbatch
    base = torch.cuda.memory_allocated(dev)
    model = LM(cfg, dev, torch.Generator(dev).manual_seed(0))
    state = init_state(model, opt)
    step = build_train_step(model, opt)
    batch = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                   global_batch=TRAIN_B), device=dev
                        ).batch_at(0)
    state, _ = step(state, batch)                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    with FlopCounterMode(display=False) as fc:
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    launches, calls = read_counts()
    peak = torch.cuda.max_memory_allocated(dev) - base
    real_flops = {str(k).split(".", 1)[-1]: v
                  for k, v in fc.get_flop_counts()["Global"].items()}
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_ms = 1e3 * statistics.median(times)
    kernels = set(counted["kernel_calls"])
    fake_flops = {k: v for k, v in counted["flops_by_op"].items()
                  if k not in kernels}
    mem = counted["memory_analysis"]
    predicted = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
                 + mem["output_size_in_bytes"] - mem["alias_size_in_bytes"])
    rates = bridge.device_rates(dev)
    t_comp = 1e3 * counted["flops_total"] / rates.peak_flops
    t_mem = 1e3 * counted["bytes_accessed_total"] / rates.hbm_bw
    print(f"  product FLOPs by op: counted {fake_flops}, FlopCounterMode "
          f"{real_flops}; kernel calls counted {counted['kernel_calls']}, "
          f"launched {launches}; plain calls {calls}")
    print(f"  peak: predicted {predicted / 2**30:.3f} GiB (arguments "
          f"{mem['argument_size_in_bytes'] / 2**30:.3f}, temp "
          f"{mem['temp_size_in_bytes'] / 2**30:.3f}), measured "
          f"{peak / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held "
          f"before: {predicted / peak - 1:+.4f}")
    flops, nbytes = counted["flops_total"], counted["bytes_accessed_total"]
    print(f"  step {step_ms:.1f} ms (median of 3; loss "
          f"{float(metrics['loss']):.4f}) vs the roofline's terms at this "
          f"card's rates: compute {t_comp:.2f} ms ({flops:.4g} FLOPs), "
          f"memory {t_mem:.2f} ms ({nbytes:.4g} bytes, converts "
          f"{counted['convert_bytes_total']:.4g}); the bound "
          f"{max(t_comp, t_mem):.2f} ms is {max(t_comp, t_mem) / step_ms:.3f} "
          f"of the step")
    if fake_flops != real_flops:
        raise SystemExit("the dry run's product FLOPs differ from "
                         "FlopCounterMode's over the real step")
    if calls or any(launches[k] != n
                    for k, n in counted["kernel_calls"].items()):
        raise SystemExit("the dry run's kernel calls differ from the "
                         "real step's launches")
    if abs(predicted / peak - 1) > DRYRUN_PEAK_RTOL:
        raise SystemExit(f"the predicted peak is not within "
                         f"{DRYRUN_PEAK_RTOL:g} of the measured")
    if step_ms < max(t_comp, t_mem):
        raise SystemExit("the measured step is below the roofline's bound")
    del model, state, step, batch, metrics
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  dry run phase {time.monotonic() - t_phase:.1f} s")
    return launches


def bridge_phase(dev) -> dict:
    """Slice 12: the co-design bridge on the card
    (``examples/design_accelerator.py``'s synthetic decode signature)."""
    sig = bridge.TrafficSignature(**BRIDGE_SIG)
    arch = bridge.tpu_like_package(sig)
    V = HeteroRep(arch).layout.Vp
    want = "fw_counts_tiled" if ops.fw_takes_tiled(V) else "fw_counts"
    phase(f"main path, slice 12: bridge.codesign on the card ({BRIDGE_SIG}; "
          f"GA, {BRIDGE_EVALS} evaluations, {BRIDGE_NORM_SAMPLES} norm "
          f"samples, the default backend; V = {V}, so {want})")
    rates = bridge.device_rates(dev)
    art = {"arch": "demo", "shape": "decode_32k", "flops_total": 1e12,
           "bytes_accessed_total": 1e10,
           "collectives": {"wire_bytes_per_chip": 1e8}}
    art_sig = bridge.signature_from_artifact(art)
    print(f"  this card's rates {rates}; a 1 TFLOP / 10 GB / 100 MB "
          f"artifact reads t_comp {art_sig.t_comp:.4g} s, t_mem "
          f"{art_sig.t_mem:.4g} s, t_coll {art_sig.t_coll:.4g} s")
    reset_counts()
    t0 = time.monotonic()
    out = bridge.codesign(sig, max_evals=BRIDGE_EVALS,
                          norm_samples=BRIDGE_NORM_SAMPLES, device=dev)
    wall = time.monotonic() - t0
    launches, plain_calls = read_counts()
    print(f"  package {out['package']}; weights {out['weights']}")
    print(f"  PlaceIT cost {out['placeit_cost']:.4f}, 2D-mesh cost "
          f"{out['baseline_cost']:.4f}, improvement "
          f"{100 * out['improvement']:.1f} %; {out['n_evaluated']} "
          f"evaluated in {wall:.2f} s; FW kernel {want} ({launches[want]} "
          f"launches; kernel launches {launches}, plain calls "
          f"{plain_calls})")
    if launches[want] <= 0 or plain_calls:
        raise SystemExit(f"codesign did not score through {want}")
    if out["n_evaluated"] != BRIDGE_EVALS or not (
            np.isfinite(out["placeit_cost"])
            and np.isfinite(out["baseline_cost"])):
        raise SystemExit(f"codesign: {out['n_evaluated']} evaluated, costs "
                         f"{out['placeit_cost']}, {out['baseline_cost']}")
    return launches


def main() -> None:
    name = device_phase()
    dev = torch.device("cuda", 0)
    funcs = build_phase()
    max_err = parity_phase(dev)
    attention_parity_phase(dev, max_err)
    decode_lse_phase(dev)
    attention_bwd_parity_phase(dev, max_err)
    scan_parity_phase(dev, max_err)
    rope_table_phase(dev)
    long_kernels_phase(dev, max_err)
    scan_bwd_parity_phase(dev, max_err)
    pipeline_parity_phase(dev)
    timing = timing_phase(dev, max_err, funcs)
    timing.update(attention_timing_phase(dev, max_err))
    timing.update(scan_timing_phase(dev, max_err, funcs))
    timing.update(attention_bwd_timing_phase(dev, max_err))
    timing.update(scan_bwd_timing_phase(dev, max_err))
    launches = main_path_phase(dev)
    profile_phase(dev)
    paths = [sweep_phase, pareto_phase, trace_phase, design_phase,
             arch3d_phase, train_phase]
    paths += [lambda d, r=r: recurrent_train_phase(d, *r) for r in RTRAIN]
    paths += [lambda d, r=r: family_train_phase(d, *r) for r in FAMILY_TRAIN]
    for path in paths + [bridge_phase, family_serve_phase, sharding_phase,
                         dryrun_phase]:
        for k, n in path(dev).items():
            launches[k] += n
    train_compare_phase(dev)
    compare_steps_phase(dev, RCOMPARE + FAMILY_COMPARE)
    train_profile_phase(dev)
    for k, n in serve_all_phase(dev).items():
        launches[k] += n
    t1 = timing["homog32 baseline"]        # the quickstart's shape, V = 216
    t2 = timing["homog256 placeit"]        # B = 1, V = 1536
    t3 = timing["minplus"]                 # 1536^3
    t4 = timing["flash qwen3-1.7b S=2048"]  # qwen3's longest prompt
    t5 = timing["decode qwen3-1.7b lengths from the seed"]
    t6 = timing["selective_scan S=2048"]   # the longest falcon-mamba prompt
    t7 = timing["rglru_scan S=2048"]
    t4b = timing[f"flash_bwd {BWD_TIMED[0][0]}"]   # the training run's
    t6b = timing["selective_scan_bwd"]     # falcon-mamba-7b's training shape
    t7b = timing["rglru_scan_bwd"]         # recurrentgemma-9b's
    bwd_err = max(t["max_abs_err"] for k, t in timing.items()
                  if k.startswith("flash_bwd "))
    full = {k: [t for key, t in timing.items() if key.startswith(pre)]
            for k, pre in (("flash_attention", "flash "),
                           ("decode_attention", "decode "),
                           ("selective_scan", "selective_scan S="),
                           ("rglru_scan", "rglru_scan S="))}

    def scan_bwd_parity(t: dict) -> str:
        return (f"cases {testing.scan_bwd_limit('cases', torch.float32)} "
                f"(bf16 gradients 2^-7 |plain|); training shape "
                f"{testing.scan_bwd_limit('training', torch.float32)}: max "
                f"abs err {t['max_abs_err']:.3g}, {t['limit_share']:.3f} of "
                f"the limit; bit for bit repeatable")

    def close(k: str, f32_tol: str, where: str) -> str:
        err = max(t["max_abs_err"] for t in full[k])
        share = max(t["limit_share"] for t in full[k])
        return (f"cases allclose rtol=atol={f32_tol} (f32), 2e-2 (bf16); "
                f"{where} shapes {FULL_LIMIT}: max abs err {err:.3g}, "
                f"{share:.3f} of the limit")
    rows = [
        ("fw_counts", "fw_counts.cu", "minplus.py:104", t1["fw_counts"], t1,
         "bitwise"),
        ("fw_counts_tiled", "fw_counts_tiled.cu", "minplus.py:305",
         t2["tiled"], t2, "bitwise"),
        ("minplus", "minplus.cu", "minplus.py:419", t3["kernel"], t3,
         "bitwise"),
        ("flash_attention", "flash_attention.cu", "flash_attention.py:92",
         t4["kernel"], t4, close("flash_attention", "2e-5", SERVE_ATTN)),
        ("decode_attention", "decode_attention.cu", "decode_attention.py:74",
         t5["kernel"], t5, close("decode_attention", "3e-5", SERVE_ATTN)),
        ("selective_scan", "selective_scan.cu", "selective_scan.py:50",
         t6["kernel"], t6, close("selective_scan", "3e-5",
                                 "falcon-mamba-7b prefill")),
        ("rglru_scan", "rglru_scan.cu", "rglru_scan.py:38", t7["kernel"], t7,
         close("rglru_scan", "3e-5", "recurrentgemma-9b prefill")),
        ("flash_attention_bwd", "flash_attention_bwd.cu",
         "flash_attention.py:92", t4b["kernel"], t4b,
         f"cases allclose rtol=atol=2e-5 (f32), 2e-2 (bf16); training "
         f"shapes {BWD_LIMIT}: max abs err {bwd_err:.3g}"),
        ("selective_scan_bwd", "selective_scan_bwd.cu",
         "selective_scan.py:50", t6b["kernel"], t6b, scan_bwd_parity(t6b)),
        ("rglru_scan_bwd", "rglru_scan_bwd.cu", "rglru_scan.py:38",
         t7b["kernel"], t7b, scan_bwd_parity(t7b))]
    print(kt.card_line())
    print(json.dumps({"kernels": [{
        "name": k, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{src}",
        "replaces": f"src/repro/kernels/{where}",
        "launches": launches[k], "max_abs_err": max_err[k], "ms": ms,
        "plain_ms": t["plain"], "bound_ms": t["bound"],
        "bound_by": t["bound_by"], "library_ms": t.get("library"),
        "parity": parity,
        **({"ms_with_lse": t["kernel_lse"]} if "kernel_lse" in t else {})}
        for k, src, where, ms, t, parity in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
