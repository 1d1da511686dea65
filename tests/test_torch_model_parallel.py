"""Model parallelism in the port (``launch.train --model-par``): the
DTensor train step on two gloo ranks against the plain step, on the CPU.

One spawn of two ranks (``tests/_torch_dist.py``) runs, for reduced
float32 configs of each family (2 layers; recurrentgemma-9b's 3-layer
super-block, whose one KV head leaves K and V replicated while the query
heads split):

- on meshes (1, 2) (tensor parallel: heads, d_ff, channels, the
  vocabulary and the experts split) and (2, 1) (the batch split, the
  parameters and AdamW state FSDP-split over ``data``): smollm-360m,
  moonshot-v1-16b-a3b (8 experts: expert-parallel at tp = 2),
  falcon-mamba-7b, recurrentgemma-9b and seamless-m4t-medium; and
  moonshot with 3 experts at (1, 2) (tensor-parallel inside the experts),
  and smollm-360m at (1, 2) with ``compress_int8``, 8-bit AdamW states and
  two microbatches; and, in a spawn of four ranks beside it, moonshot at
  (2, 2), where the router's weight gradient is computed a block of rows
  a model rank, summed over "data" and swapped to the rank whose shard it
  is, as the compiled reference splits it (the test also asserts that
  this split ran there, and nowhere else); and, in a spawn of eight
  ranks, smollm-360m and moonshot at (2, 2, 2) on ("pod", "data",
  "model"), the AdamW state split over ("pod", "data") and the
  parameters over "data", as the dry run's multi-pod cells (the test also
  asserts that the update moved those leaves to the state's layout by
  hand there, and nowhere else, and that every state leaf stays where
  the shardings say).  Against the single-process plain step from the same
  state: the loss of a batch to rtol 1e-5 and every gradient within 1e-5
  of its largest entry (seen: about 1e-6; the shards sum in other
  orders); two train steps' losses and gradient norms to rtol 1e-5
  (8-bit states: 1e-4, a moment an ulp apart may cross a code boundary),
  and every parameter within 2 lr of the plain one after them (Adam's
  first steps move a parameter by about lr times the sign of a gradient,
  and a gradient near zero may differ in sign between the two sums);
  every parameter laid out as the rules say.
- On a (1, 1) mesh of one rank, for each family: the DTensor step equal
  to the plain step bit for bit (losses, gradient norms, parameters).
- ``launch.train.main(["--smoke", "--model-par", "2", ...])`` on both
  ranks: its losses match the single-process launcher's to rtol 1e-5.
- An elastic restore: a state saved from (1, 2) restored onto (2, 1)
  (each leaf on the given placements) and onto no mesh, bit for bit.

The eight ranks also move tensors between a parameter's layout and its
AdamW state's by hand (``partition.state_plan``), on (2, 2, 2) and (2, 4,
1) meshes, even and uneven splits, against DTensor's own shards.

Also, in one process: which KV heads the attention wrappers hand a rank
whose query heads are split (``kernels.on_shards._pair_kv``), for head
counts the two ranks do not reach.
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import on_shards
from repro_torch.launch import train as launch_train
from repro_torch.train.optimizer import OptConfig

from _torch_dist import (model_parallel_rank, pod_rank, run_ranks,
                         start_ranks)
from _torch_threads import one_torch_thread  # noqa: F401

LR = 1e-3
OPT = OptConfig(lr=LR, warmup_steps=1, total_steps=10)
OPT8 = dataclasses.replace(OPT, compress_int8=True, state_int8=True)

FAMILIES = {
    "smollm-360m": get_config("smollm-360m").reduced(n_layers=2),
    "moonshot-v1-16b-a3b": get_config("moonshot-v1-16b-a3b").reduced(
        n_layers=2),
    "falcon-mamba-7b": get_config("falcon-mamba-7b").reduced(n_layers=2),
    "recurrentgemma-9b": get_config("recurrentgemma-9b").reduced(
        n_layers=3),
    "seamless-m4t-medium": get_config("seamless-m4t-medium").reduced(
        n_layers=2, n_enc_layers=2),
}
CASES = [(f"{arch} {shape}", cfg, shape, OPT, 1)
         for arch, cfg in FAMILIES.items() for shape in ((1, 2), (2, 1))]
CASES += [
    ("moonshot-v1-16b-a3b 3 experts (1, 2)", dataclasses.replace(
        FAMILIES["moonshot-v1-16b-a3b"], n_experts=3), (1, 2), OPT, 1),
    ("smollm-360m int8 (1, 2)", FAMILIES["smollm-360m"], (1, 2), OPT8, 2),
    # Four ranks: the router's rows FSDP-split over "data" and whole over
    # "model", so each model rank computes a block of its weight gradient
    # (``partition._row_block_plan``), as the compiled reference does.
    ("moonshot-v1-16b-a3b (2, 2)", FAMILIES["moonshot-v1-16b-a3b"], (2, 2),
     OPT, 1),
]
# Eight ranks on a ("pod", "data", "model") mesh, as the dry run's
# multi-pod cells lay it out: the batch over ("pod", "data"), the
# parameters FSDP-split over "data" alone and the AdamW state over ("pod",
# "data"), so that the update moves each split leaf to the state's layout
# and back by hand (``partition.state_plan``); a dense model and the MoE
# one, whose experts' moments DTensor once resharded by other collectives
# on other torch releases.
CASES += [
    ("smollm-360m (2, 2, 2)", FAMILIES["smollm-360m"], (2, 2, 2), OPT, 1),
    ("moonshot-v1-16b-a3b (2, 2, 2)", FAMILIES["moonshot-v1-16b-a3b"],
     (2, 2, 2), OPT, 1),
    # Two microbatches: each one's gradients stay partial sums over the
    # pods through the backward and the accumulation, reduced once a step
    # where the update moves them to the state's layout.
    ("smollm-360m (2, 2, 2) 2 microbatches", FAMILIES["smollm-360m"],
     (2, 2, 2), OPT, 2),
]
# The cases whose weight gradients are split into row blocks.
ROW_BLOCKS = {"moonshot-v1-16b-a3b (2, 2)"}
# The cases whose AdamW state splits over a mesh dim more than the
# parameters (moved by hand in the update).
POD = {"smollm-360m (2, 2, 2)", "moonshot-v1-16b-a3b (2, 2, 2)",
       "smollm-360m (2, 2, 2) 2 microbatches"}
# The moves by hand on their own, on eight ranks: (mesh, tensor shape,
# the parameter's spec, the state's), even and uneven splits; on (2, 4,
# 1) the state's pod-major chunks are no permutation of the parameter's
# pod-split ones where the dim does not divide (9 and 5 rows: pieces of
# other lengths, some empty).
DP, DS = ("data", ("pod", "data"))
LAYOUTS = [((2, 2, 2), (8, 6), (DP, "model"), (DS, "model")),
           ((2, 2, 2), (6, 12), ("model", DP), ("model", DS)),
           ((2, 2, 2), (9, 4), (DP, None), (DS, None)),
           ((2, 2, 2), (3, 10, 7), (None, DP, "model"),
            (None, DS, "model")),
           ((2, 4, 1), (16, 2), (DP, None), (DS, None)),
           ((2, 4, 1), (9, 3), (DP, None), (DS, None)),
           ((2, 4, 1), (2, 5), ("model", DP), ("model", DS))]
LAUNCH = ["--smoke", "--device", "cpu", "--steps", "3", "--batch", "4",
          "--seq", "32", "--log-every", "1"]


def _cases(world: int) -> list:
    return [c for c in CASES if math.prod(c[2]) == world]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The four-rank cases, started at once to run beside the two-rank
    spawn: the function that waits for them."""
    return start_ranks(model_parallel_rank, 4,
                       tmp_path_factory.mktemp("model_parallel_4"),
                       _cases(4), [], None)


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory, four_ranks):
    """The eight-rank cases and moves, started beside the others."""
    return start_ranks(pod_rank, 8,
                       tmp_path_factory.mktemp("model_parallel_8"),
                       _cases(8), LAYOUTS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, four_ranks, eight_ranks):
    tmp = tmp_path_factory.mktemp("model_parallel")
    one = [(arch, cfg, OPT) for arch, cfg in FAMILIES.items()]
    outs = run_ranks(model_parallel_rank, 2, tmp, _cases(2), one,
                     LAUNCH + ["--model-par", "2"])
    return outs


@pytest.fixture(scope="module")
def runs4(four_ranks, runs):
    return four_ranks()


@pytest.fixture(scope="module")
def runs8(eight_ranks, runs4):
    return eight_ranks()


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_sharded_step_matches_plain_step(runs, runs4, runs8, case):
    ranks = {4: runs4, 8: runs8}.get(
        math.prod(dict((c[0], c[2]) for c in CASES)[case]), runs)
    r = ranks[0]["cases"][case]
    rtol = 1e-4 if "int8" in case else 1e-5
    a, b = r["loss"]
    assert b == pytest.approx(a, rel=1e-5)
    assert r["grad_err"] <= 1e-5
    for (a, b), (na, nb) in zip(r["losses"], r["norms"]):
        assert b == pytest.approx(a, rel=rtol)
        assert nb == pytest.approx(na, rel=rtol)
    assert r["param_err"] <= 2 * LR
    assert r["placements"] == r["shardings"]
    assert (r["row_block_grads"] > 0) == (case in ROW_BLOCKS)
    assert (r["state_moves"] > 0) == (case in POD)
    assert r["opt_misplaced"] == []
    for out in ranks[1:]:
        assert out["cases"][case]["losses"] == r["losses"]


@pytest.mark.parametrize("i", range(len(LAYOUTS)),
                         ids=[f"{d} {s} {p}" for d, s, p, _ in LAYOUTS])
def test_state_layout_moves_by_hand(runs8, i):
    """On every rank the plan is made, the move to the state's layout
    gives DTensor's shard of it, and the move back the parameter's."""
    for out in runs8:
        assert out["layouts"][i] == {"plan": True, "to_state": True,
                                     "to_param": True}


def test_tensor_parallel_splits_the_model(runs):
    """The rules split what they say (placements on (data, model)): the
    query projection's rows over data (FSDP) and its columns over model;
    the experts over model (8 of them: expert-parallel) or their d_ff (3);
    the scan's channels."""
    cases = runs[0]["cases"]
    assert cases["smollm-360m (1, 2)"]["placements"][
        "groups.0.0.attn.wq"] == ("S(0)", "S(1)")
    moe = "groups.0.0.moe.we1"
    assert cases["moonshot-v1-16b-a3b (1, 2)"]["placements"][moe] == (
        "S(1)", "S(0)")
    assert cases["moonshot-v1-16b-a3b 3 experts (1, 2)"]["placements"][
        moe] == ("S(1)", "S(2)")
    assert cases["falcon-mamba-7b (1, 2)"]["placements"][
        "groups.0.0.mamba.A_log"] == ("R", "S(0)")


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_one_rank_mesh_is_bitwise_the_plain_step(runs, arch):
    for out in runs:
        r = out["one"][arch]
        assert r["bitwise"], (arch, r["losses"], r["param_err"])


def test_launcher_model_par_2_matches_one_process(runs, tmp_path):
    _, ls = launch_train.main(LAUNCH + ["--ckpt-dir", str(tmp_path)],
                              log=lambda *_: None)
    want = [loss for _, loss, _ in ls.history]
    assert len(want) == 3
    for out in runs:
        assert out["launcher"] == pytest.approx(want, rel=1e-5)


def test_elastic_restore_across_meshes(runs):
    for out in runs:
        e = out["elastic"]
        assert e["n"] > 0
        assert e["onto_21"] and e["misplaced"] == []
        assert e["onto_none"] and e["plain"]


@pytest.mark.parametrize("H,Hkv,n,kv_split", [
    (4, 1, 2, False), (8, 2, 4, False), (8, 2, 2, True), (6, 3, 2, False),
    (12, 4, 3, False), (16, 4, 8, False), (8, 8, 4, True), (6, 2, 4, False)])
def test_pair_kv_gives_each_query_head_its_kv_head(H, Hkv, n, kv_split):
    """Split H query heads over n ranks (torch.chunk's split), the KV heads
    with them or whole: each local query head j, grouped by the kernel as
    j // (Hl / Hkv_local), must meet global KV head h // (H / Hkv)."""
    g = H // Hkv
    k = torch.arange(Hkv).float().reshape(1, 1, Hkv, 1).expand(1, 2, Hkv, 1)
    q_chunks = torch.arange(H).chunk(n)
    kv_chunks = torch.arange(Hkv).chunk(n)
    for r, qc in enumerate(q_chunks):
        Hl, off = len(qc), int(qc[0])
        kl, ko = ((k[:, :, kv_chunks[r]], int(kv_chunks[r][0])) if kv_split
                  else (k, 0))
        kp, vp = on_shards._pair_kv(kl, kl, H, Hkv, off, Hl, ko)
        assert Hl % kp.shape[2] == 0
        per = Hl // kp.shape[2]
        for j in range(Hl):
            assert int(kp[0, 0, j // per, 0]) == (off + j) // g
        assert vp.shape == kp.shape
