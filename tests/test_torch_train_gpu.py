"""The flash-attention backward kernel and LM training on the card.

- The backward kernel (``kernels/flash_attention_bwd.py``) against
  ``ref.attention_bwd_ref`` on every case of
  ``repro_torch.testing.attention_cases`` and ``attention_tile_cases``,
  in float32 (2e-5) and bfloat16 (2e-2), from the forward kernel's output
  and log-sum-exp; one launch counted per call; two calls bit for bit.
- The backward kernel at each of ``chip_smoke.py``'s ``BWD_TIMED``
  training shapes (smollm-360m's and qwen3-1.7b's heads, bf16, causal,
  S = 2048) cut to B = 1: within ``BWD_LIMIT`` of the plain version and
  bit for bit equal to a second call.
- The bf16 backward's 16-byte row rule: a ``dout`` whose rows are not
  16-byte aligned (an odd base pointer, a padded row stride) is copied and
  gives the same bits as an aligned one; such a q, k, v or o raises.
- The forward kernel's log-sum-exp within 1e-5 of the plain version's,
  -inf in the same rows, and its output the serving launch's bits.
- The autograd Function on the card: kernel forward and kernel backward,
  no plain call.
- A training step of a reduced smollm-360m (float32) on the card through
  the kernels against the same step through the plain versions
  (``testing.plain_attention`` in ``ops.flash_attention``'s place): loss
  to 1e-5 relative, each gradient to 1e-4 of its largest entry; the same
  for reduced falcon-mamba-7b (2 layers) and recurrentgemma-9b (3 layers,
  S past its window), with ``testing.plain_selective_scan`` and
  ``plain_rglru_scan`` in the scans' places as well.
- The same step for reduced grok-1-314b and moonshot-v1-16b-a3b (MoE)
  and seamless-m4t-medium (encoder, decoder and cross-attention over a
  memory shorter than the decoder's sequence).
- The MoE block makes no host sync (``torch.cuda.set_sync_debug_mode``)
  at a training shape, its backward included, and at decode.
- Decode attention, which has no backward, raises on operands that
  require a gradient under grad mode and runs under ``torch.no_grad``;
  the two scans launch their forward and backward kernels under grad.

Skips without a card; run it on the H100 with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch import testing
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_attention_bwd as tfb
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru_scan as trg
from repro_torch.kernels import rglru_scan_bwd as trb
from repro_torch.kernels import selective_scan as tss
from repro_torch.kernels import selective_scan_bwd as tsb
from repro_torch.models import moe as tmoe
from repro_torch.models.model import LM

pytestmark = pytest.mark.gpu

CASES = {**testing.attention_cases(), **testing.attention_tile_cases()}
DTYPES = ("float32", "bfloat16")
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LSE_TOL = 1e-5
# chip_smoke.py's BWD_TIMED (cut to B = 1), TRAIN_S and BWD_LIMIT.
BWD_ARCHS = ("smollm-360m", "qwen3-1.7b")
TRAIN_S = 2048
BWD_RTOL, BWD_ATOL_SHARE = 2.0 ** -6, 2.0 ** -8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(name, dtype, dev):
    q, k, v, kw = CASES[name]()
    q, k, v = (torch.from_numpy(x).to(dev).to(getattr(torch, dtype))
               for x in (q, k, v))
    g = np.random.default_rng(5).standard_normal(q.shape, dtype=np.float32)
    return q, k, v, torch.from_numpy(g).to(dev).to(q.dtype), kw


def _forward(q, k, v, kw):
    return tfa._launch(q, k, v, kw.get("causal", True), kw.get("window"),
                       None, kw.get("softcap"), kw.get("pos_offset"),
                       with_lse=True)


def _close(a, b, tol, what):
    a, b = a.float().cpu().numpy(), b.float().cpu().numpy()
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(CASES))
def test_backward_kernel_matches_plain(cuda, name, dtype):
    q, k, v, g, kw = _case(name, dtype, cuda)
    out, lse = _forward(q, k, v, kw)
    before = tfb.launches
    got = tfb.flash_attention_bwd(q, k, v, out, g, lse, **kw)
    torch.cuda.synchronize()
    assert tfb.launches == before + 1
    again = tfb.flash_attention_bwd(q, k, v, out, g, lse, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = tref.attention_bwd_ref(q, k, v, out, g, lse, **kw)
    for a, b, what in zip(got, want, ("dq", "dk", "dv")):
        assert a.dtype == b.dtype and a.shape == b.shape
        _close(a, b, TOL[dtype], what)


@pytest.mark.parametrize("arch", BWD_ARCHS)
def test_backward_kernel_at_training_shape(cuda, arch):
    cfg = get_config(arch)
    q, k, v = (torch.from_numpy(x).to(cuda).to(torch.bfloat16)
               for x in testing.attention_operands(
                   1, TRAIN_S, TRAIN_S, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                   seed=1))
    out, lse = _forward(q, k, v, {})
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        q.shape, dtype=np.float32)).to(cuda).to(torch.bfloat16)
    got = tfb.flash_attention_bwd(q, k, v, out, g, lse)
    again = tfb.flash_attention_bwd(q, k, v, out, g, lse)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = tref.attention_bwd_ref(q, k, v, out, g, lse)
    for a, b, what in zip(got, want, ("dq", "dk", "dv")):
        a, b = a.float(), b.float()
        limit = BWD_ATOL_SHARE * b.abs().max() + BWD_RTOL * b.abs()
        share = float(((a - b).abs() / limit).max())
        assert share <= 1.0, f"{what}: {share:.3f} of BWD_LIMIT"


def _misaligned(x, how):
    """A copy of ``x`` whose rows do not start on 16 bytes: "offset", its
    base pointer 2 bytes past an allocation; "stride", rows of d + 1."""
    if how == "offset":
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        y = buf[1:].view(x.shape)
    else:
        y = torch.empty(*x.shape[:-1], x.shape[-1] + 1, dtype=x.dtype,
                        device=x.device)[..., :x.shape[-1]]
    y.copy_(x)
    assert not tfa.rows_16_byte_aligned(y)
    return y


@pytest.mark.parametrize("how", ("offset", "stride"))
def test_backward_16_byte_rows(cuda, how):
    name = next(n for n in CASES if n.startswith("B=2 Sq=191"))
    q, k, v, g, kw = _case(name, "bfloat16", cuda)
    out, lse = _forward(q, k, v, kw)
    want = tfb.flash_attention_bwd(q, k, v, out, g, lse, **kw)
    got = tfb.flash_attention_bwd(q, k, v, out, _misaligned(g, how), lse,
                                  **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    ops_ = {"q": q, "k": k, "v": v, "o": out}
    for key in ops_:
        bad = {**ops_, key: _misaligned(ops_[key], how)}
        with pytest.raises(ValueError, match="16-byte"):
            tfb.flash_attention_bwd(bad["q"], bad["k"], bad["v"], bad["o"],
                                    g, lse, **kw)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(testing.attention_cases()))
def test_forward_lse_matches_plain(cuda, name, dtype):
    q, k, v, _, kw = _case(name, dtype, cuda)
    out, lse = _forward(q, k, v, kw)
    assert torch.equal(out, tfa._launch(q, k, v, kw.get("causal", True),
                                        kw.get("window"), None,
                                        kw.get("softcap"),
                                        kw.get("pos_offset")))
    _, want = tref.attention_ref(q, k, v, return_lse=True, **kw)
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(lse))
    _close(lse[fin], want[fin], LSE_TOL, "lse")


def test_autograd_function_launches_both_kernels(cuda):
    q, k, v, g, kw = _case(next(iter(CASES)), "bfloat16", cuda)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    tref.calls.clear()
    fwd, bwd = tfa.launches, tfb.launches
    out = ops.flash_attention(q, k, v, **kw)
    got = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    assert (tfa.launches, tfb.launches) == (fwd + 1, bwd + 1)
    assert sum(tref.calls.values()) == 0
    assert all(x.dtype == torch.bfloat16 for x in got)


def _loss_and_grads(model, batch):
    loss, _ = model.loss_fn(batch)
    params = dict(model.named_parameters())
    return loss.detach(), dict(zip(params, torch.autograd.grad(
        loss, list(params.values()))))


def test_train_step_kernels_match_plain(cuda):
    cfg = get_config("smollm-360m").reduced(n_layers=2)
    model = LM(cfg, cuda, torch.Generator(cuda).manual_seed(0))
    model.requires_grad_(True)
    batch = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=200,
                                   global_batch=2), device=cuda).batch_at(0)
    tref.calls.clear()
    loss_k, grads_k = _loss_and_grads(model, batch)
    assert sum(tref.calls.values()) == 0
    flash = ops.flash_attention
    ops.flash_attention = testing.plain_attention
    try:
        loss_p, grads_p = _loss_and_grads(model, batch)
    finally:
        ops.flash_attention = flash
    assert abs(float(loss_k) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
    for name, gp in grads_p.items():
        gk = grads_k[name]
        atol = 1e-4 * float(gp.abs().max())
        assert float((gk - gp).abs().max()) <= atol, name


# The recurrent models' steps: reduced (float32) at the depth and length
# of tests/test_torch_train.py's reference check.
RECURRENT = {"falcon-mamba-7b": (2, 200), "recurrentgemma-9b": (3, 200)}


@pytest.mark.parametrize("arch", list(RECURRENT))
def test_recurrent_train_step_kernels_match_plain(cuda, arch):
    layers, S = RECURRENT[arch]
    cfg = get_config(arch).reduced(n_layers=layers)
    assert cfg.window == 0 or S > cfg.window
    model = LM(cfg, cuda, torch.Generator(cuda).manual_seed(0))
    model.requires_grad_(True)
    batch = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=S,
                                   global_batch=2), device=cuda).batch_at(0)
    tref.calls.clear()
    launches = (tss.launches, tsb.launches, trg.launches, trb.launches)
    loss_k, grads_k = _loss_and_grads(model, batch)
    torch.cuda.synchronize()
    assert sum(tref.calls.values()) == 0
    moved = [n - m for n, m in zip(
        (tss.launches, tsb.launches, trg.launches, trb.launches), launches)]
    assert all(moved[:2]) if arch == "falcon-mamba-7b" else all(moved[2:])
    keep = (ops.flash_attention, ops.selective_scan, ops.rglru_scan)
    ops.flash_attention = testing.plain_attention
    ops.selective_scan = testing.plain_selective_scan
    ops.rglru_scan = testing.plain_rglru_scan
    try:
        loss_p, grads_p = _loss_and_grads(model, batch)
    finally:
        ops.flash_attention, ops.selective_scan, ops.rglru_scan = keep
    assert abs(float(loss_k) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
    for name, gp in grads_p.items():
        gk = grads_k[name]
        atol = 1e-4 * float(gp.abs().max())
        assert float((gk - gp).abs().max()) <= atol, name


# The MoE and encoder-decoder families' steps: reduced (float32), depth 2,
# seamless with a 150-frame memory (its cross-attention Sq > Sk).
NEW_FAMILIES = ("grok-1-314b", "moonshot-v1-16b-a3b", "seamless-m4t-medium")


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_new_family_train_step_kernels_match_plain(cuda, arch):
    cfg = get_config(arch).reduced(n_layers=2)
    model = LM(cfg, cuda, torch.Generator(cuda).manual_seed(0))
    model.requires_grad_(True)
    batch = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=200,
                                   global_batch=2), device=cuda).batch_at(0)
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.randn(
            2, 150, cfg.d_model, device=cuda,
            generator=torch.Generator(cuda).manual_seed(1))
    tref.calls.clear()
    fwd, bwd = tfa.launches, tfb.launches
    loss_k, grads_k = _loss_and_grads(model, batch)
    torch.cuda.synchronize()
    assert sum(tref.calls.values()) == 0
    # One forward and one backward launch a self-attention layer, and for
    # seamless a cross-attention and an encoder layer more.
    n = cfg.n_layers * (2 if cfg.family == "encdec" else 1) \
        + cfg.n_enc_layers
    assert tfb.launches - bwd == n
    assert tfa.launches - fwd >= n
    flash = ops.flash_attention
    ops.flash_attention = testing.plain_attention
    try:
        loss_p, grads_p = _loss_and_grads(model, batch)
    finally:
        ops.flash_attention = flash
    assert abs(float(loss_k) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
    for name, gp in grads_p.items():
        gk = grads_k[name]
        atol = 1e-4 * float(gp.abs().max())
        assert float((gk - gp).abs().max()) <= atol, name


@pytest.mark.parametrize("S", (200, 1))
def test_moe_block_makes_no_host_sync(cuda, S):
    """The MoE block of reduced moonshot-v1-16b-a3b with 6 of 16 experts
    a token, at a training shape (S = 200: forward and backward) and at
    decode (S = 1, no grad): no host sync."""
    cfg = get_config("moonshot-v1-16b-a3b").reduced(n_experts=16, top_k=6)
    p = tmoe.MoE(cfg, cuda, torch.Generator(cuda).manual_seed(0))
    x = torch.randn(2, S, cfg.d_model, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1))

    def call():
        if S == 1:
            with torch.no_grad():
                return p(x, cfg)
        xg = x.clone().requires_grad_()
        y, aux = p(xg, cfg)
        (y.sum() + aux).backward()
        return y, aux

    call()                          # cuBLAS and the allocator warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_kernels_without_backward_refuse_grad(cuda):
    *arrays, lens, kw = next(iter(testing.decode_cases().values()))()
    q, kc, vc = (torch.from_numpy(a).to(cuda) for a in arrays)
    lens = torch.from_numpy(lens).to(cuda)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        ops.decode_attention(q.requires_grad_(), kc, vc, lens, **kw)
    with torch.no_grad():
        ops.decode_attention(q, kc, vc, lens, **kw)
    # The scans have their backward kernels: under grad both launch.
    for prefix, fn, fwd, bwd in (("selective", ops.selective_scan, tss, tsb),
                                 ("rglru", ops.rglru_scan, trg, trb)):
        name = next(n for n in testing.scan_cases() if n.startswith(prefix))
        args = [None if a is None else torch.from_numpy(a).to(cuda)
                for a in testing.scan_cases()[name]()]
        args[1].requires_grad_()
        n_fwd, n_bwd = fwd.launches, bwd.launches
        y, _ = fn(*args)
        y.sum().backward()
        torch.cuda.synchronize()
        assert (fwd.launches, bwd.launches) == (n_fwd + 1, n_bwd + 1)
        with torch.no_grad():
            fn(*args)
