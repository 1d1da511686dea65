"""Model parallelism's DTensor step on the card, on a (1, 1) mesh of one
NCCL rank (a ``FileStore`` under the test's temporary directory).

For a reduced bfloat16 config of each family (smollm-360m, moonshot-v1-
16b-a3b, falcon-mamba-7b, recurrentgemma-9b, seamless-m4t-medium; remat
on), ``launch.train.sharded_training``'s step against the plain step from
the same seed, two steps in turns: losses, gradient norms and every
parameter equal bit for bit after each; the DTensor steps launch the
family's kernels (forward and backward) on the local shards and call no
plain version.

Skips without a card; run it on the H100 with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_model_parallel_gpu.py
"""
import dataclasses

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_attention_bwd as tfb
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru_scan as trg
from repro_torch.kernels import rglru_scan_bwd as trb
from repro_torch.kernels import selective_scan as tss
from repro_torch.kernels import selective_scan_bwd as tsb
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import sharded_training
from repro_torch.models.model import LM
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import build_train_step, init_state

pytestmark = pytest.mark.gpu

ATTN = (tfa, tfb)
FAMILIES = {
    "smollm-360m": (2, ATTN),
    "moonshot-v1-16b-a3b": (2, ATTN),
    "falcon-mamba-7b": (2, (tss, tsb)),
    "recurrentgemma-9b": (3, (trg, trb) + ATTN),
    "seamless-m4t-medium": (2, ATTN),
}


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda", 0)
    store = tmp_path_factory.mktemp("nccl") / "store"
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1, device_id=dev)
    try:
        yield make_host_mesh(1)
    finally:
        dist.destroy_process_group()


def _batch(cfg, i, dev):
    batch = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=128,
                                   global_batch=2), device=dev).batch_at(i)
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.randn(
            2, 96, cfg.d_model, device=dev,
            generator=torch.Generator(dev).manual_seed(i)).to(torch.bfloat16)
    return batch


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_one_rank_dtensor_step_is_the_plain_step(mesh, arch):
    layers, mods = FAMILIES[arch]
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config(arch).reduced(n_layers=layers),
                              dtype="bfloat16", remat=True)
    ocfg = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    plain = LM(cfg, dev, torch.Generator(dev).manual_seed(0))
    s1, st1 = init_state(plain, ocfg), build_train_step(plain, ocfg)
    s2, st2, _ = sharded_training(
        LM(cfg, dev, torch.Generator(dev).manual_seed(0)), ocfg, mesh)
    for i in range(2):
        batch = _batch(cfg, i, dev)
        s1, m1 = st1(s1, batch)
        for m in mods:
            m.launches = 0
        tref.calls.clear()
        s2, m2 = st2(s2, batch)
        torch.cuda.synchronize()
        assert all(m.launches > 0 for m in mods), [m.launches for m in mods]
        assert sum(tref.calls.values()) == 0, dict(tref.calls)
        assert torch.equal(m1["loss"], m2["loss"])
        assert torch.equal(m1["grad_norm"], m2["grad_norm"])
        for name, p in s1["params"].items():
            assert torch.equal(p, s2["params"][name].full_tensor()), name
