"""Time the kernels of several checkouts of this repository on one card,
in turns, with the same method.

    python3 src/repro_torch/launch/kernel_compare.py \\
        --trees PARENT . . PARENT [--walls] [--sass] [--clusters] \\
        [--trace] [--prefill] [--bwd] [--scan-bwd] [--out FILE]

Each tree (a directory holding ``src/repro_torch``; ``.`` is this
checkout) runs in a process of its own, in the order given, importing
that tree's package and building its kernels from its own sources.  The
method is this checkout's ``kernel_timing.py`` (loaded by path, so a tree
without it is timed the same way), the one ``chip_smoke.py`` uses.  Each
run times, with ``kernel_timing.batched_ms`` (launches back to back
between one pair of CUDA events, behind a spin kernel so that the host's
enqueue is not timed), every output held bit for bit (FW, min-plus) or to
``FULL_LIMIT`` (scans) against the plain version's:

* the FW kernels: ``fw_counts`` at homog32 baseline (B = 16, V = 216) and
  homog64 placeit (B = 16, V = 480), ``fw_counts_tiled`` at homog256
  placeit (B = 1, V = 1536) and homog100 baseline (B = 16, V = 552);
* ``minplus`` at 1536^3 (a homog256 placeit score graph) and at 702^3 (a
  hex127 baseline score graph, ragged against every tile), and ``apsp``
  at V = 1536 (the homog256 graph; ``ref.apsp_squarings`` products); and
  whether min-plus keeps NaN as the plain version does (``NAN_CASES``: a
  NaN in A, a NaN in B, -inf beside +inf; reported, not required, since
  a kernel that takes its mins with ``fminf`` drops NaN);
* ``selective_scan`` and ``rglru_scan`` at the serve runs' prefill shapes
  (B = 1, S = 2048 and 512);
* with ``--bwd``: the flash-attention backward (``flash_attention_bwd``)
  at ``chip_smoke.py``'s ``BWD_TIMED`` training shapes (bfloat16, causal,
  S = 2048: smollm-360m's heads at B = 8, qwen3-1.7b's at B = 1), each
  output held to ``BWD_LIMIT`` against the plain version's (the largest
  share of the limit used is recorded); with ``--sass`` also the
  registers and spills ptxas reports for each of the backward's kernel
  instances;
* with ``--scan-bwd``: the selective scan's backward
  (``selective_scan_bwd``) at falcon-mamba-7b's training shape
  (``kernel_timing.SCAN_TRAIN``, operands from ``scan_train_operands``),
  from the states the tree's forward kernel writes, every gradient held
  to ``testing.SCAN_BWD_LIMITS["training"]`` against the plain version
  (the largest share of the limit each gradient uses is recorded) and to
  a second call bit for bit; and the forward at that shape with and
  without those states; with ``--sass`` also the registers, spills and
  stack ptxas reports for each of the backward's kernel instances;
* with ``--walls``: the wall seconds of ``run_experiment`` for every run
  of ``kernel_timing.RUNS`` (as ``chip_smoke.py`` runs them; the first,
  the quickstart, also warms up); a tree that cannot run one (an arch or
  algorithm it lacks) records why;
* with ``--clusters``: kernel 1 at every cluster size it takes and the
  blocked kernel at V = 32 .. 512 (B = 16; trees with
  ``fw_counts.launch_at_cluster``), and the blocked kernel at B = 1 from
  V = 64 to 1536 (its critical path: nb fused chains);
* with ``--sass``: the library rebuilt, ptxas's registers and spills per
  kernel, a histogram of SASS mnemonics per FW, min-plus or scan kernel
  function and its hot loop (``kernel_timing.loop_issues``; the scans'
  loops as ``kernel_timing.SCAN_LOOPS`` names them, the selective scan
  backward's loop over chunks, ``kernel_timing.sscan_bwd_issues``, and
  from them the scans' issue floors at the timed shapes and the
  backward's at its training shape; the dump of ``cuobjdump -sass``
  written beside ``--out``);
* with ``--prefill``: one falcon-mamba-7b and one recurrentgemma-9b at
  full width in bfloat16 (weights from ``torch.Generator`` seed 0 on the
  card, one model at a time), each prefilling one prompt of 1024 and of
  2048 tokens (B = 1, a 4096-token cache): the median wall of three
  prefills ending in a synchronize, as tokens/s, and the device kernel
  time of one more under ``torch.profiler``;
* with ``--trace``: one ``fw_counts_tiled`` call at homog256 placeit and
  at homog100 baseline with the kernel's per-item trace
  (``fw_counts_tiled.launch_traced``): each work item's wait and run time
  (global ns), by kind, the blocks' busy share, and for each pivot block
  when its A items were dequeued, started and ended and when its phase-3
  items started and ended.

The card's name and power limit head the output; each run prints one JSON
line, and the parent process a table.  Needs a card; exits non-zero
without one.
"""
from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

FULL_RTOL, FULL_ATOL = 2.0 ** -6, 1e-5
# Min-plus operands [M, K] x [K, N] = [192, 64] x [64, 192] with NaN or
# -inf planted: (name, which, value).
NAN_CASES = (("nan in A", "A", float("nan")), ("nan in B", "B",
                                                float("nan")),
             ("-inf and +inf", "AB", float("-inf")))
# --prefill: the recurrent serve runs' models and the prompt lengths.
PREFILL_ARCHS = ("falcon-mamba-7b", "recurrentgemma-9b")
PREFILL_S = (1024, 2048)
PREFILL_CACHE = 4096


def _load_timing():
    """This checkout's ``kernel_timing.py``, loaded by path under its own
    name, so it does not import the ``repro_torch`` of the tree timed."""
    spec = importlib.util.spec_from_file_location(
        "_kernel_timing", Path(__file__).with_name("kernel_timing.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


kt = _load_timing()


def _equal(got, want, what: str) -> None:
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise SystemExit(f"{what}: kernel output differs from the plain "
                         f"version's")


def _close(got, want, what: str) -> None:
    g, w = got.float(), want.float()
    if ((g - w).abs() > FULL_ATOL + FULL_RTOL * w.abs()).any():
        raise SystemExit(f"{what}: kernel output beyond FULL_LIMIT")


def _sass(lib_path: Path, out: Path) -> dict:
    """Per FW, min-plus or scan kernel function of a built library: a
    histogram of its SASS mnemonics and its hot loops (instructions, ops:
    relaxations, updates, or the scans' (step, state) / (step, channel)
    items)."""
    text = kt.sass(lib_path)
    out.write_text(text)
    res = {}
    for f, instrs in kt.sass_functions(text).items():
        if not any(p in f for p in ("fw_", "minplus", "diag", "panel",
                                    "outer", "scan_kernel",
                                    "sscan_bwd_kernel")):
            continue
        hist = collections.Counter(mn for _, mn, _ in instrs)
        res[f] = {"mnemonics": dict(hist.most_common())}
        if "minplus" in f:
            res[f]["hot_loop"] = kt.minplus_issues(instrs)
            continue
        if "sscan_bwd_kernel" in f:
            loops = {"chunk_loop": (None, "MUFU", ())}
        elif "scan_kernel" in f:
            loops = {k: v for k, v in kt.SCAN_LOOPS.items() if v[0] in f}
        else:
            loops = {"hot_loop": (None, "FMUL", ())}
        for k, (_, op, without) in loops.items():
            try:
                res[f][k] = kt.loop_issues(instrs, op, without)
            except ValueError:
                res[f][k] = None
    return res


def _scan_floors(lib_path: Path, dev) -> dict:
    """The scans' issue floors (ms) at the timed shapes, and the
    selective scan's backward's at its training shape, from this build's
    SASS."""
    funcs = kt.sass_functions(kt.sass(lib_path))
    issues = kt.scan_issues(funcs)
    out = {}
    for S in (2048, 512):
        out[f"selective_scan S={S}"] = kt.scan_floors_ms(
            issues, 1, S, 8192, "selective_scan", dev)
        out[f"rglru_scan S={S}"] = kt.scan_floors_ms(
            issues, 1, S, 4096, "rglru_scan", dev)
    try:
        n, k = issues["selective_scan_bwd"] = kt.sscan_bwd_issues(funcs)
    except ValueError:              # a tree without the backward
        return {"issues": issues, "floors_ms": out}
    shape = kt.SCAN_TRAIN["selective_scan"]
    out["selective_scan_bwd " + " ".join(
        f"{a}={b}" for a, b in shape.items())] = kt.sscan_bwd_floor_ms(
            n, shape["B"], shape["S"], shape["Di"], dev)
    return {"issues": issues, "floors_ms": out}


def _minplus_nan(ops, plain, dev) -> dict:
    """Per ``NAN_CASES``: the NaN entries of the kernel's output and of the
    plain version's, and whether the two are equal NaN-aware."""
    import numpy as np
    res = {}
    for name, which, value in NAN_CASES:
        rng = np.random.default_rng(len(name))
        A = (10 * rng.random((192, 64))).astype(np.float32)
        B = (10 * rng.random((64, 192))).astype(np.float32)
        if which == "AB":              # -inf + inf is NaN
            A[rng.random(A.shape) < 0.25] = np.inf
            B[rng.random(B.shape) < 0.25] = np.inf
        for X in ((A,) if which == "A" else (B,) if which == "B"
                  else (A, B)):
            X[rng.integers(X.shape[0], size=3),
              rng.integers(X.shape[1], size=3)] = value
        A, B = torch.from_numpy(A).to(dev), torch.from_numpy(B).to(dev)
        got, want = ops.minplus(A, B), plain.minplus_ref(A, B)
        gn, wn = torch.isnan(got), torch.isnan(want)
        res[name] = {"kernel_nan": int(gn.sum()), "plain_nan": int(wn.sum()),
                     "nan_equal": bool(torch.equal(gn, wn) and torch.equal(
                         got[~gn], want[~wn]))}
    return res


def _prefill(dev) -> dict:
    """``--prefill``: per model and prompt length, the median wall (s)
    of three prefills, tokens/s from it, and the device kernel ms of one
    more prefill under torch.profiler."""
    import gc
    import statistics

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    res = {}
    for arch in PREFILL_ARCHS:
        cfg = get_config(arch)
        model = LM(cfg, dev, torch.Generator(device=dev).manual_seed(0))
        for S in PREFILL_S:
            toks = torch.as_tensor(np.random.default_rng(S).integers(
                3, cfg.vocab, size=(1, S)), dtype=torch.long, device=dev)
            fn = lambda: model.prefill({"tokens": toks}, PREFILL_CACHE)
            fn()
            torch.cuda.synchronize()
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            dev_ms = sum(
                e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
            wall = statistics.median(walls)
            res[f"{arch} S={S}"] = {"wall_s": wall, "tokens_per_s": S / wall,
                                    "device_ms": dev_ms}
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return res


def bwd_operands(arch: str, B: int, dev) -> tuple:
    """(q, k, v, out, dout, lse) at ``arch``'s attention heads, B x
    ``kt.BWD_S`` tokens, bfloat16, causal: q, k, v from
    ``testing.attention_operands`` (seed B), out and lse from the forward
    kernel, dout standard normals (numpy seed B), as ``chip_smoke.py``'s
    timing phase draws them."""
    import numpy as np

    from repro_torch import testing
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as tfa
    cfg = get_config(arch)
    q, k, v = (torch.from_numpy(x).to(dev).to(torch.bfloat16)
               for x in testing.attention_operands(
                   B, kt.BWD_S, kt.BWD_S, cfg.n_heads, cfg.n_kv_heads,
                   cfg.hd, seed=B))
    out, lse = tfa._launch(q, k, v, True, None, None, None, None,
                           with_lse=True)
    g = torch.from_numpy(np.random.default_rng(B).standard_normal(
        tuple(out.shape), dtype=np.float32)).to(dev).to(torch.bfloat16)
    return q, k, v, out, g, lse


def _bwd(dev, res: dict) -> None:
    """``--bwd``: the backward's ms at each ``kt.BWD_TIMED`` shape into
    ``res["ms"]``, and the largest share of ``BWD_LIMIT`` its outputs
    use into ``res["bwd_limit_share"]``; exits if one is beyond it."""
    from repro_torch.kernels import flash_attention_bwd as tfb
    from repro_torch.kernels import ref as plain
    res["bwd_limit_share"] = {}
    for arch, B in kt.BWD_TIMED:
        ops_ = bwd_operands(arch, B, dev)
        t, o = kt.batched_ms(
            {"k": lambda: tfb.flash_attention_bwd(*ops_)}, 5, 3)
        name = f"flash_bwd {arch} B={B} S={kt.BWD_S}"
        share = kt.bwd_limit_share(o["k"], plain.attention_bwd_ref(*ops_))
        if share > 1:
            raise SystemExit(f"{name}: beyond BWD_LIMIT ({share:.3f})")
        res["ms"][name] = t["k"]
        res["bwd_limit_share"][name] = share
        del ops_, o
        torch.cuda.empty_cache()


def _scan_bwd(dev, res: dict) -> None:
    """``--scan-bwd``: the selective scan's backward and its forward
    (with and without the states the backward reads) at its training
    shape into ``res["ms"]``, and the largest share of the training limit
    each gradient uses into ``res["scan_bwd_share"]``; exits if one is
    beyond it or a second call differs."""
    from repro_torch import testing
    from repro_torch.kernels import ref as plain
    from repro_torch.kernels import selective_scan as tss
    from repro_torch.kernels import selective_scan_bwd as tsb
    shape = kt.SCAN_TRAIN["selective_scan"]
    args, dy, dhf = kt.scan_train_operands("selective_scan", dev)
    ops_ = tss._on_card(*args)
    t, out = kt.batched_ms({
        "forward": lambda: tss._launch(*ops_),
        "forward with states": lambda: tss._launch(*ops_, states=True)},
        5, 3)
    states = out["forward with states"][2]
    tk, outk = kt.batched_ms({"k": lambda: tsb.selective_scan_bwd(
        *args, dy, dhf, states=states)}, 5, 3)
    name = "selective_scan_bwd " + " ".join(f"{k}={v}"
                                            for k, v in shape.items())
    want = plain.selective_scan_bwd_ref(*args, dy, dhf)
    share = {g: testing.scan_bwd_share(a, b, "training")[1]
             for g, a, b in zip(kt.SSCAN_GRADS, outk["k"], want)}
    if not max(share.values()) <= 1:
        raise SystemExit(f"{name}: beyond the training limit ({share})")
    again = tsb.selective_scan_bwd(*args, dy, dhf, states=states)
    if not all(torch.equal(a, b) for a, b in zip(outk["k"], again)):
        raise SystemExit(f"{name}: two calls differ")
    res["ms"][name] = tk["k"]
    res["ms"]["selective_scan forward at that shape"] = t["forward"]
    res["ms"]["selective_scan forward with states"] = t[
        "forward with states"]
    res["scan_bwd_share"] = share
    del out, outk, states, want, again
    torch.cuda.empty_cache()


def _trace_stats(tr, nb: int) -> dict:
    """Per-kind wait and run times (us) of a traced call, the blocks' busy
    share, and per pivot block [A dequeued, first A start, last A start,
    last A end, first B start, last B end] (us from the first dequeue);
    items by the kind and pivot block the kernel decoded."""
    import numpy as np
    t = (tr[:, :3] - tr[:, 0].min()) / 1e3
    kind = np.where(tr[:, 4] == 0, "A", "B")
    m = tr[:, 5]
    out = {"total_us": float(t[:, 2].max()),
           "blocks": int(len(set(tr[:, 3].tolist())))}
    out["busy_share"] = float((t[:, 2] - t[:, 1]).sum()
                              / (out["blocks"] * out["total_us"]))
    for k in ("A", "B"):
        sel = kind == k
        wait, run = t[sel, 1] - t[sel, 0], t[sel, 2] - t[sel, 1]
        out[k] = {"items": int(sel.sum()),
                  "run_us_median": float(np.median(run)),
                  "wait_us_median": float(np.median(wait)),
                  "run_us_sum": float(run.sum()),
                  "wait_us_sum": float(wait.sum())}
    out["per_pivot_block_us"] = [
        [round(float(x), 1) for x in (
            t[(kind == "A") & (m == p), 0].min(),
            t[(kind == "A") & (m == p), 1].min(),
            t[(kind == "A") & (m == p), 1].max(),
            t[(kind == "A") & (m == p), 2].max(),
            t[(kind == "B") & (m == p), 1].min()
            if ((kind == "B") & (m == p)).any() else float("nan"),
            t[(kind == "B") & (m == p), 2].max()
            if ((kind == "B") & (m == p)).any() else float("nan"))]
        for p in range(nb)]
    return out


def run_one(tree: Path, walls: bool, sass: bool, clusters: bool,
            trace: bool, prefill: bool, bwd: bool, scan_bwd: bool,
            out: Path | None) -> dict:
    sys.path.insert(0, str(tree / "src"))
    from repro_torch import testing
    from repro_torch.core import api
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import fw_counts as fwc
    from repro_torch.kernels import fw_counts_tiled as fwt
    from repro_torch.kernels import ref as plain

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda", 0)
    t0 = time.monotonic()
    log = build.build(force=sass)
    res = {"tree": str(tree), "build_s": time.monotonic() - t0, "ms": {}}
    if sass:
        res["ptxas"] = [ln.strip() for ln in log.splitlines()
                        if "Compiling entry" in ln or "Used" in ln
                        or "spill" in ln]
        if bwd:
            res["bwd_ptxas"] = kt.ptxas_usage(log, "flash_bwd")
        if scan_bwd:
            res["scan_bwd_ptxas"] = kt.ptxas_usage(log, "sscan_bwd")

    def fw_row(name, fn, W, launches, rounds):
        t, o = kt.batched_ms({"k": lambda: fn(W)}, launches, rounds)
        _equal(o["k"], plain.fw_counts_ref(W), name)
        res["ms"][name] = t["k"]

    for arch, cfg, B in (("homog32", "baseline", 16),
                         ("homog64", "placeit", 16)):
        W = torch.from_numpy(testing.score_graphs(arch, cfg, B)).to(dev)
        fw_row(f"fw_counts {arch} {cfg} B={B} V={W.shape[-1]}",
               ops.fw_counts, W, 10, 5)
    for arch, cfg, B in (("homog256", "placeit", 1),
                         ("homog100", "baseline", 16)):
        W = torch.from_numpy(testing.score_graphs(arch, cfg, B)).to(dev)
        fw_row(f"fw_counts_tiled {arch} {cfg} B={B} V={W.shape[-1]}",
               ops.fw_counts_tiled, W, 10, 5)
    for arch, cfg in (("homog256", "placeit"), ("hex127", "baseline")):
        W = torch.from_numpy(testing.score_graphs(arch, cfg, 1)[0]).to(dev)
        t, o = kt.batched_ms({"k": lambda: ops.minplus(W, W)}, 20, 5)
        _equal([o["k"]], [plain.minplus_ref(W, W)], f"minplus {arch}")
        res["ms"][f"minplus {W.shape[-1]}^3"] = t["k"]
    W = torch.from_numpy(testing.score_graphs("homog256", "placeit",
                                              1)[0]).to(dev)
    t, o = kt.batched_ms({"k": lambda: ops.apsp(W)}, 3, 5)
    _equal([o["k"]], [plain.fw_counts_ref(W)[0]], "apsp")
    res["ms"][f"apsp V={W.shape[-1]}"] = t["k"]
    res["minplus_nan"] = _minplus_nan(ops, plain, dev)

    g = torch.Generator(device=dev)
    for S in (2048, 512):
        g.manual_seed(S)
        x = torch.randn(1, S, 8192, generator=g, device=dev).to(
            torch.bfloat16)
        dt = 1e-3 + 0.099 * torch.rand(1, S, 8192, generator=g, device=dev)
        A = -torch.arange(1, 17, dtype=torch.float32, device=dev).expand(
            8192, 16).contiguous()
        Bm = torch.randn(1, S, 16, generator=g, device=dev)
        Cm = torch.randn(1, S, 16, generator=g, device=dev)
        args = [x, dt, A, Bm, Cm, torch.ones(8192, device=dev),
                torch.zeros(1, 8192, 16, device=dev)]
        t, o = kt.batched_ms({"k": lambda: ops.selective_scan(*args)},
                             20, 5)
        _close(o["k"][0], plain.selective_scan_ref(*args)[0],
               "selective_scan")
        res["ms"][f"selective_scan S={S}"] = t["k"]
        xr = torch.randn(1, S, 4096, generator=g, device=dev).to(
            torch.bfloat16)
        a = (0.5 + 0.5 * torch.rand(1, S, 4096, generator=g,
                                    device=dev)).to(torch.bfloat16)
        args = [xr, a, torch.zeros(1, 4096, device=dev)]
        t, o = kt.batched_ms({"k": lambda: ops.rglru_scan(*args)}, 20, 5)
        _close(o["k"][0], plain.rglru_ref(*args)[0], "rglru_scan")
        res["ms"][f"rglru_scan S={S}"] = t["k"]

    if trace and hasattr(fwt, "launch_traced"):
        res["trace"] = {}
        for arch, cfg, B in (("homog256", "placeit", 1),
                             ("homog100", "baseline", 16)):
            W = torch.from_numpy(testing.score_graphs(arch, cfg, B)).to(dev)
            V = W.shape[-1]
            fwt.fw_counts_tiled(W)
            D, N, tr = fwt.launch_traced(W)
            _equal((D, N), plain.fw_counts_ref(W), f"traced {arch}")
            res["trace"][f"{arch} {cfg} B={B}"] = _trace_stats(
                tr.cpu().numpy(), -(-V // fwt.BT))

    if clusters and hasattr(fwc, "launch_at_cluster"):
        res["clusters"] = {}
        for V in (32, 40, 48, 56, 64, 80, 96, 112, 130, 160, 216, 300, 384,
                  480, 512):
            W = torch.from_numpy(testing.random_graph(V, 3 * V, seed=V,
                                                      batch=16)).to(dev)
            want = plain.fw_counts_ref(W)
            fns = {C: (lambda C=C: fwc.launch_at_cluster(W, C))
                   for C in fwc.CLUSTER_SIZES if fwc.cluster_fits(V, C)}
            t, o = kt.batched_ms(fns, 10, 5)
            for C in fns:
                _equal(o[C], want, f"fw_counts V={V} cluster {C}")
            t["tiled"] = kt.batched_ms(
                {"k": lambda: ops.fw_counts_tiled(W)}, 10, 5)[0]["k"]
            res["clusters"][V] = t
        res["chain"] = {}
        for V in (64, 128, 256, 512, 1024, 1536):
            W = torch.from_numpy(testing.random_graph(V, 3 * V, seed=V)).to(
                dev)
            t, o = kt.batched_ms({"k": lambda: ops.fw_counts_tiled(W)},
                                 10, 5)
            _equal(o["k"], plain.fw_counts_ref(W), f"tiled V={V}")
            res["chain"][V] = t["k"]

    if walls:
        res["walls"] = {}
        for name in kt.RUNS:
            try:
                cfg = kt.experiment_config(api, name)
                t1 = time.monotonic()
                rec = api.run_experiment(cfg, device=dev)[0]
            except (KeyError, NotImplementedError) as e:
                res["walls"][name] = {"skipped": str(e)}
                continue
            torch.cuda.synchronize()
            res["walls"][name] = {"s": time.monotonic() - t1,
                                  "backend": cfg.backend,
                                  "n_evaluated": rec.result.n_evaluated,
                                  "best_cost": float(rec.result.best_cost)}
    if bwd:
        _bwd(dev, res)
    if scan_bwd:
        _scan_bwd(dev, res)
    if prefill:
        res["prefill"] = _prefill(dev)
    if sass:
        dst = (out or Path("kernel_compare.json")).with_name(
            f"sass_{tree.name}.txt")
        res["sass_file"] = str(dst)
        dst.parent.mkdir(parents=True, exist_ok=True)
        res["sass"] = _sass(build.LIB_PATH, dst)
        try:
            res["scan_floors"] = _scan_floors(build.LIB_PATH, dev)
        except ValueError:          # a tree whose scans lack these loops
            res["scan_floors"] = None
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--walls", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--clusters", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--prefill", action="store_true")
    ap.add_argument("--bwd", action="store_true")
    ap.add_argument("--scan-bwd", action="store_true")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    flags = [f for f in ("--walls", "--sass", "--clusters", "--trace",
                         "--prefill", "--bwd", "--scan-bwd")
             if getattr(args, f[2:].replace("-", "_"))]
    if args.out:
        args.out = args.out.resolve()
    if args.one:
        res = run_one(Path(args.one).resolve(), args.walls, args.sass,
                      args.clusters, args.trace, args.prefill, args.bwd,
                      args.scan_bwd, args.out)
        print("RESULT " + json.dumps(res))
        return
    print(kt.card_line(), flush=True)
    results = []
    for tree in args.trees:
        t0 = time.monotonic()
        cmd = [sys.executable, str(Path(__file__).resolve()), "--one",
               str(Path(tree).resolve()),
               *flags] + (["--out", str(args.out)] if args.out else [])
        p = subprocess.run(cmd, capture_output=True, text=True,
                           cwd=Path(tree).resolve())
        lines = [ln for ln in p.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if p.returncode != 0 or not lines:
            sys.stderr.write(p.stdout[-4000:] + p.stderr[-8000:])
            raise SystemExit(f"the run of {tree} failed ({p.returncode})")
        res = json.loads(lines[-1][len("RESULT "):])
        res["run_s"] = time.monotonic() - t0
        results.append(res)
        print(json.dumps(res), flush=True)
    names = list(results[0]["ms"])
    print(f"{'kernel (ms)':44s} " + " ".join(
        f"{r['tree'][-14:]:>14s}" for r in results))
    for k in names:
        print(f"{k:44s} " + " ".join(
            f"{r['ms'].get(k, float('nan')):14.4f}" for r in results))
    for k in results[0]["minplus_nan"]:
        print(f"{'minplus NaN kernel/plain, equal: ' + k:44s} " + " ".join(
            f"{x['kernel_nan']:>5d}/{x['plain_nan']:<5d} "
            f"{'yes' if x['nan_equal'] else 'no':>3s}"
            for x in (r["minplus_nan"][k] for r in results)))
    if "scan_bwd_share" in results[0]:
        for g in results[0]["scan_bwd_share"]:
            print(f"{'selective_scan_bwd share of limit ' + g:44s} " +
                  " ".join(f"{r['scan_bwd_share'][g]:14.4f}"
                           for r in results))
    if "walls" in results[0]:
        for k in results[0]["walls"]:
            print(f"{'wall s ' + k:44s} " + " ".join(
                f"{r['walls'][k].get('s', float('nan')):14.3f}"
                for r in results))
    if "prefill" in results[0]:
        for k in results[0]["prefill"]:
            for col, fmt in (("tokens_per_s", "14.1f"),
                             ("device_ms", "14.3f")):
                print(f"{'prefill ' + k + ' ' + col:44s} " + " ".join(
                    f"{r['prefill'][k][col]:{fmt}}" for r in results))
    print(kt.card_line())
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
