"""The dry run's pieces on the card: the decode kernel's log-sum-exp and
the merge of a cache cut over its positions, and fake "cuda" counts.

- ``decode_attention(..., return_lse=True)`` on every decode case and
  split edge, float32 and bfloat16: the output bit for bit the call's
  without the lse; the lse -inf at the same rows as the plain version's
  and elsewhere within 1e-4 + 1e-5 |lse| of it (float32 sums of the same
  logits in another order; exp2 and log2 in the kernel).
- The cache cut into 2 and 4 pieces, each piece through the kernel with
  its local lengths (``testing.decode_pieces``, as the ranks of a
  position-split cache run it), merged, against the uncut call: the
  decode cases' tolerances (3e-5 float32, 2e-2 bfloat16).
- Cells of the dry run on fake "cuda" tensors count what the same cells
  count on fake "cpu" tensors: FLOPs, bytes, collectives (DTensor's
  all-to-all among them), kernel calls and memory, on a fake group of 2
  ranks; and a cell counts the same with DTensor's caches cold (a new
  fake group) and warm (counted again on it): on torch 2.11 the first
  count once took the RG-LRU gates' ``softplus`` decomposition on meta
  tensors, which DTensor runs once a layout, for the device's program.

Skips without a card; run it on the H100 with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_dryrun_gpu.py
"""
import pytest
import torch
import torch.distributed as dist

from repro_torch import testing
from repro_torch.configs import get_config
from repro_torch.configs.registry import ShapeSpec
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ref
from repro_torch.launch import dryrun

pytestmark = pytest.mark.gpu

LSE_ATOL, LSE_RTOL = 1e-4, 1e-5
TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}
CASES = {**testing.decode_cases(), **testing.decode_split_cases()}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _operands(name, dtype, dev):
    *ops_np, lens_np, kw = CASES[name]()
    q, kc, vc = (torch.from_numpy(a).to(dev, dtype) for a in ops_np)
    return q, kc, vc, torch.from_numpy(lens_np).to(dev), kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("name", list(CASES))
def test_decode_lse_matches_plain(name, dtype, dev):
    q, kc, vc, lens, kw = _operands(name, dtype, dev)
    out, lse = tda.decode_attention(q, kc, vc, lens, **kw, return_lse=True)
    assert torch.equal(out, tda.decode_attention(q, kc, vc, lens, **kw))
    _, want = ref.decode_attention_ref(q, kc, vc, lens, **kw,
                                       return_lse=True)
    inf = torch.isneginf(want)
    assert torch.equal(torch.isneginf(lse), inf)
    assert torch.equal(inf, (lens == 0)[:, None].expand_as(inf))
    torch.testing.assert_close(lse[~inf], want[~inf], rtol=LSE_RTOL,
                               atol=LSE_ATOL)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("name", list(CASES))
def test_decode_pieces_merge_to_the_uncut_call(name, dtype, n, dev):
    q, kc, vc, lens, kw = _operands(name, dtype, dev)
    want = tda.decode_attention(q, kc, vc, lens, **kw)
    launches = tda.launches
    got = testing.decode_pieces(tda.decode_attention, q, kc, vc, lens, n,
                                **kw)
    S = kc.shape[1]
    assert tda.launches - launches == len(range(0, S, -(-S // n)))
    torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])


# (arch, shape, mesh, reduced-config overrides): a position-split decode
# cache, moonshot's experts and FSDP over "data", and smollm-360m's
# sequence parallelism, whose splits DTensor moves by all-to-all.
CELLS = (("recurrentgemma-9b", ShapeSpec("decode_32k", 16, 2, "decode"),
          (1, 2), dict(window=8, n_layers=3)),
         ("moonshot-v1-16b-a3b", ShapeSpec("train_4k", 16, 4, "train"),
          (2, 1), {}),
         ("smollm-360m", ShapeSpec("train_4k", 16, 4, "train"), (1, 2), {}))


def test_fake_cuda_counts_do_not_depend_on_what_ran_before(dev):
    arch, spec, dims, kw = CELLS[0]
    cfg = get_config(arch).reduced(**{"n_layers": 2, **kw})
    if dist.is_initialized():
        dist.destroy_process_group()
    try:
        mesh = dryrun.fake_mesh("single", dev.type, dims=dims)
        cold, warm = (dryrun.count_cell(arch, spec, mesh, dev, cfg=cfg,
                                        microbatches=1) for _ in range(2))
    finally:
        dist.destroy_process_group()
    for key in ("flops_total", "bytes_accessed_total",
                "convert_bytes_total", "collectives", "kernel_calls",
                "memory_analysis", "flops_by_op"):
        assert warm[key] == cold[key], key


def test_fake_cuda_counts_equal_fake_cpu(dev):
    got = {"cuda": [], "cpu": []}
    try:
        for arch, spec, dims, kw in CELLS:
            cfg = get_config(arch).reduced(**{"n_layers": 2, **kw})
            for device in (dev, torch.device("cpu")):
                mesh = dryrun.fake_mesh("single", device.type, dims=dims)
                got[device.type].append(dryrun.count_cell(
                    arch, spec, mesh, device, cfg=cfg, microbatches=1))
                dist.destroy_process_group()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    for a, b in zip(got["cuda"], got["cpu"]):
        for key in ("flops_total", "bytes_accessed_total",
                    "convert_bytes_total", "collectives", "kernel_calls",
                    "memory_analysis"):
            assert a[key] == b[key], key
        assert a["flops_total"] > 0
    assert got["cuda"][2]["collectives"]["ops"]["all-to-all"]["count"] > 0

