"""The attention kernels and the LM serving path on the card.

The flash-attention kernel on every case of
``repro_torch.testing.attention_cases`` and ``attention_tile_cases`` (the
edges of the bfloat16 kernel's tiles) and the flash-decode kernel on
every case of ``testing.decode_cases`` and ``decode_split_cases`` (the
edges of its split over S), in float32 and bfloat16, against their plain
versions on the card, with one launch counted per call and the JAX tests'
tolerances (flash 2e-5, decode 3e-5 in float32; 2e-2 in bfloat16).  At
the serve runs' shapes both kernels give bitwise equal outputs from two
launches and make no host sync (``torch.cuda.set_sync_debug_mode``).
The three kernels (flash forward, its backward
and decode) at the query and KV heads of the dense archs that slice 23
runs on the card (llava-next-34b 56 on 8 of 128, qwen2.5-3b 16 on 2 of
128, tinyllama-1.1b 32 on 4 of 64), at llava's patch-prefix sequence of
624 rows and over a decode batch of mixed lengths, to the same limits.
Then a reduced qwen3-1.7b prefill and three decode steps on
the card against the same model on the CPU (float32: rtol = atol = 2e-4,
the CPU parity tests' tolerance; the card sums in other orders), going
through the kernels only.  Skips without a card; run it on the H100 with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_attention_gpu.py
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch import testing
from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_attention_bwd as tfb
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models.model import LM

pytestmark = pytest.mark.gpu

ATTN = testing.attention_cases()
DECODE = testing.decode_cases()
TILE = testing.attention_tile_cases()
SPLIT = testing.decode_split_cases()
DTYPES = ("float32", "bfloat16")
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DECODE_TOL = {"float32": 3e-5, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    # The plain versions' float32 products must not run in TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _on(x, dtype, dev):
    return torch.from_numpy(x).to(dev).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(ATTN))
def test_flash_kernel_matches_plain(cuda, name, dtype):
    _check_flash(cuda, ATTN[name], name, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(TILE))
def test_flash_kernel_tile_edges(cuda, name, dtype):
    _check_flash(cuda, TILE[name], name, dtype)


def _check_flash(cuda, make, name, dtype):
    q, k, v, kw = make()
    q, k, v = (_on(x, dtype, cuda) for x in (q, k, v))
    launches = tfa.launches
    got = tfa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tfa.launches == launches + 1
    want = tref.attention_ref(q, k, v, **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = FLASH_TOL[dtype]
    assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                    rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(DECODE))
def test_decode_kernel_matches_plain(cuda, name, dtype):
    _check_decode(cuda, DECODE[name], name, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(SPLIT))
def test_decode_kernel_split_edges(cuda, name, dtype):
    _check_decode(cuda, SPLIT[name], name, dtype)


def _check_decode(cuda, make, name, dtype):
    q, kc, vc, lens, kw = make()
    q, kc, vc = (_on(x, dtype, cuda) for x in (q, kc, vc))
    lens = torch.from_numpy(lens).to(cuda)
    launches = tda.launches
    got = tda.decode_attention(q, kc, vc, lens, **kw)
    torch.cuda.synchronize()
    assert tda.launches == launches + 1
    want = tref.decode_attention_ref(q, kc, vc, lens, **kw)
    tol = DECODE_TOL[dtype]
    assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                    rtol=tol, atol=tol, err_msg=name)


def test_flash_kernel_reads_strided_queries(cuda):
    q, k, v, kw = ATTN["B=1 Sq=16 Sk=100 Hq=4 Hkv=2 d=32 causal=True "
                       "pos_offset=40"]()
    q, k, v = (torch.from_numpy(x).to(cuda) for x in (q, k, v))
    wide = torch.cat([torch.zeros_like(q), q], 2)[:, :, 4:]
    assert not wide.is_contiguous()
    assert torch.equal(ops.flash_attention(wide, k, v, **kw),
                       ops.flash_attention(q, k, v, **kw))


def test_flash_kernel_refuses_misaligned_bf16_rows(cuda):
    q, k, v, kw = ATTN["B=2 Sq=24 Sk=24 Hq=4 Hkv=2 d=32 causal=True"]()
    q, k, v = (torch.from_numpy(x).to(cuda).bfloat16() for x in (q, k, v))
    # Every row starts 2 bytes past a 16-byte boundary.
    wide = torch.zeros(2, 24, 4 * 32 + 1, dtype=torch.bfloat16, device=cuda)
    odd = wide[..., 1:].unflatten(-1, (4, 32))
    odd.copy_(q)
    with pytest.raises(ValueError):
        ops.flash_attention(odd, k, v, **kw)


# The serve runs' attention shapes (chip_smoke.py's timing phase): flash
# at B = 1, Sq = Sk = 2048, causal; decode at B = 8 with seeded lengths.
SERVE = {
    "flash qwen3-1.7b": ("flash", dict(B=1, Sq=2048, Sk=2048, Hq=16, Hkv=8,
                                       d=128), None),
    "flash recurrentgemma-9b": ("flash", dict(B=1, Sq=2048, Sk=2048, Hq=16,
                                              Hkv=1, d=256), 2048),
    "decode qwen3-1.7b": ("decode", dict(S=4096, Hq=16, Hkv=8, d=128), None),
    "decode recurrentgemma-9b": ("decode", dict(S=2048, Hq=16, Hkv=1,
                                                d=256), None),
}


def _serve_call(cuda, which):
    """A call of one kernel at a serve shape in bfloat16, inputs on the
    card and the library loaded (the first call may allocate)."""
    kind, shape, window = SERVE[which]
    if kind == "flash":
        q, k, v = (_on(x, "bfloat16", cuda)
                   for x in testing.attention_operands(**shape, seed=1))
        fn = lambda: ops.flash_attention(q, k, v, window=window)  # noqa: E731
    else:
        lens = np.random.default_rng(0).integers(1, shape["S"] + 1, size=8)
        q, kc, vc, lens = testing.decode_operands(8, **shape, lengths=lens,
                                                  seed=1)
        q, kc, vc = (_on(x, "bfloat16", cuda) for x in (q, kc, vc))
        lens = torch.from_numpy(lens).to(cuda)
        fn = lambda: ops.decode_attention(q, kc, vc, lens)  # noqa: E731
    fn()
    torch.cuda.synchronize()
    return fn


@pytest.mark.parametrize("which", list(SERVE))
def test_attention_kernels_are_bitwise_deterministic(cuda, which):
    fn = _serve_call(cuda, which)
    first, second = fn(), fn()
    assert torch.equal(first, second)


@pytest.mark.parametrize("which", list(SERVE))
def test_attention_kernels_make_no_host_sync(cuda, which):
    fn = _serve_call(cuda, which)
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


# Slice 23's dense archs: their (Hq, Hkv, d) from the configs; flash and
# its backward at B = 1 over 576 patch rows and a 48-token prompt (624,
# no multiple of a 64-row tile), decode at B = 4 over a 1024-slot cache
# with mixed lengths.  The backward is held to its cases' limits, which
# are the forward's (tests/test_torch_train_gpu.py).
DENSE_ARCHS = ("llava-next-34b", "qwen2.5-3b", "tinyllama-1.1b")
DENSE_S = 624
DENSE_LENS = (624, 1, 333, 1024)


def _dense(arch):
    cfg = get_config(arch)
    return dict(Hq=cfg.n_heads, Hkv=cfg.n_kv_heads, d=cfg.hd)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_flash_kernel_at_dense_arch_heads(cuda, arch, dtype):
    ops_ = testing.attention_operands(1, DENSE_S, DENSE_S, **_dense(arch),
                                      seed=23)
    _check_flash(cuda, lambda: (*ops_, {}), arch, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_flash_backward_kernel_at_dense_arch_heads(cuda, arch, dtype):
    q, k, v = (_on(x, dtype, cuda) for x in testing.attention_operands(
        1, DENSE_S, DENSE_S, **_dense(arch), seed=23))
    out, lse = tfa._launch(q, k, v, True, None, None, None, None,
                           with_lse=True)
    g = _on(np.random.default_rng(24).standard_normal(
        q.shape, dtype=np.float32), dtype, cuda)
    launches = tfb.launches
    got = tfb.flash_attention_bwd(q, k, v, out, g, lse)
    torch.cuda.synchronize()
    assert tfb.launches == launches + 1
    want = tref.attention_bwd_ref(q, k, v, out, g, lse)
    tol = FLASH_TOL[dtype]
    for a, b, what in zip(got, want, ("dq", "dk", "dv")):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(),
                        rtol=tol, atol=tol, err_msg=f"{arch} {what}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_decode_kernel_at_dense_arch_heads(cuda, arch, dtype):
    ops_ = testing.decode_operands(len(DENSE_LENS), max(DENSE_LENS),
                                   **_dense(arch), lengths=DENSE_LENS,
                                   seed=23)
    _check_decode(cuda, lambda: (*ops_, {}), arch, dtype)


def test_decode_kernel_refuses_misaligned_cache(cuda):
    q = torch.zeros(1, 4, 32, device=cuda)
    kc = torch.zeros(1 * 8 * 2 * 32 + 1, device=cuda)[1:].view(1, 8, 2, 32)
    with pytest.raises(ValueError):
        ops.decode_attention(q, kc, kc, torch.ones(1, dtype=torch.int32,
                                                   device=cuda))


def test_reduced_model_on_card_matches_cpu(cuda):
    cfg = get_config("qwen3-1.7b").reduced(n_layers=2)
    cpu = LM(cfg, "cpu", torch.Generator().manual_seed(0))
    card = LM(cfg, cuda)
    card.load_state_dict(cpu.state_dict())
    toks = np.random.default_rng(0).integers(3, cfg.vocab, size=(2, 12))
    batches = {d: {"tokens": torch.as_tensor(toks).long().to(d)}
               for d in ("cpu", cuda)}
    flash, decode = tfa.launches, tda.launches
    tref.calls.clear()
    (lc, cc), (lg, cg) = (m.prefill(batches[d], 32)
                          for d, m in (("cpu", cpu), (cuda, card)))
    assert_allclose(lg.cpu().numpy(), lc.numpy(), rtol=2e-4, atol=2e-4)
    lens = np.array([12, 9], np.int32)
    nxt = lc.argmax(-1)[:, None]
    for _ in range(3):
        step = {d: {"tokens": nxt.to(d),
                    "lengths": torch.as_tensor(lens).to(d)}
                for d in ("cpu", cuda)}
        lc = cpu.decode_step(step["cpu"], cc)
        lg = card.decode_step(step[cuda], cg)
        assert_allclose(lg.cpu().numpy(), lc.numpy(), rtol=2e-4, atol=2e-4)
        nxt = lc.argmax(-1)[:, None]
        lens = lens + 1
    assert tfa.launches - flash == cfg.n_layers
    assert tda.launches - decode == 3 * cfg.n_layers
    # The CPU model took the plain versions, the card's none.
    assert tref.calls["attention_ref"] == cfg.n_layers
    assert tref.calls["decode_attention_ref"] == 3 * cfg.n_layers
