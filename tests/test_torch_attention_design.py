"""The arithmetic of the attention kernels' designs, on the CPU.

- ``ref.decode_attention_split_ref`` (the decode kernel's split over S and
  its merge in split order, in plain PyTorch) against
  ``ref.decode_attention_ref`` and against the reference's
  ``repro.kernels.ref.decode_attention_ref`` (under ``jax.jit``, arrays
  passed as numpy), in float32, for several split counts, within the decode
  kernel's float32 tolerance of 3e-5.
- ``decode_attention.decode_splits``, the split count the wrapper takes
  from the shapes alone, at the serve runs' shapes and within its bounds.
- The rounding model behind the bfloat16 flash kernel's P V: at a
  qwen3-1.7b-shaped causal head (S = 2048, d = 128, numpy standard normals
  rounded to bfloat16), an online softmax over 64-key tiles whose P is
  rounded to bfloat16 before P V leaves entries outside ``chip_smoke.py``'s
  ``FULL_LIMIT`` (two bfloat16 ulps of the plain version's output plus
  1e-5), and P split into bf16 hi + lo stays within half of it.
- The bfloat16 wrappers' 16-byte row rule (``check_16_byte_rows``).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.kernels import ref as jref
from repro_torch import testing
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref

from _torch_threads import one_torch_thread  # noqa: F401

DECODE_TOL = 3e-5
# chip_smoke.py's FULL_LIMIT: |kernel - plain| <= 1e-5 + 2^-6 |plain|.
FULL_RTOL, FULL_ATOL = 2.0 ** -6, 1e-5

# Every decode case, at split counts that do and do not divide S.
SPLIT_CASES = {**testing.decode_cases(), **testing.decode_split_cases()}


@functools.lru_cache(maxsize=None)
def _jax_decode(window, softcap):
    return jax.jit(functools.partial(jref.decode_attention_ref,
                                     window=window, softcap=softcap))


@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_ref_matches_unsplit_and_reference(name):
    q, kc, vc, lens, kw = SPLIT_CASES[name]()
    args = [torch.from_numpy(x) for x in (q, kc, vc, lens)]
    want = tref.decode_attention_ref(*args, **kw)
    ref_jax = np.asarray(_jax_decode(kw.get("window"), kw.get("softcap"))(
        *(jnp.asarray(x) for x in (q, kc, vc, lens))))
    assert_allclose(want.numpy(), ref_jax, rtol=DECODE_TOL, atol=DECODE_TOL)
    S = kc.shape[1]
    n_kernel, _ = tda.decode_splits(S, kc.shape[0], kc.shape[2])
    for n in sorted({1, 2, 3, 7, n_kernel, min(S, 64)}):
        got = tref.decode_attention_split_ref(*args, n_split=n, **kw)
        assert got.dtype == want.dtype and got.shape == want.shape
        err = f"{name} n_split={n}"
        assert_allclose(got.numpy(), want.numpy(), rtol=DECODE_TOL,
                        atol=DECODE_TOL, err_msg=err)
        assert_allclose(got.numpy(), ref_jax, rtol=DECODE_TOL,
                        atol=DECODE_TOL, err_msg=err)
        # A row that sees nothing gives zeros, in every split.
        empty = lens == 0
        assert not got[torch.from_numpy(empty)].any()


def test_split_ref_counts_its_calls():
    q, kc, vc, lens, kw = testing.decode_cases()[
        "S=40 Hq=8 Hkv=2 d=32 lengths=[0, 1, 17, 40]"]()
    before = tref.calls["decode_attention_split_ref"]
    tref.decode_attention_split_ref(
        *(torch.from_numpy(x) for x in (q, kc, vc, lens)), n_split=4, **kw)
    assert tref.calls["decode_attention_split_ref"] == before + 1


@pytest.mark.parametrize("S, B, Hkv, want", [
    (4096, 8, 8, (8, 512)),      # qwen3-1.7b's decode: 512 blocks
    (2048, 8, 1, (8, 256)),      # recurrentgemma-9b's ring: 64 blocks
    (4096, 1, 8, (16, 256)),
    (45, 3, 1, (1, 64)),         # shorter than two chunks: no split
])
def test_decode_splits_at_serve_shapes(S, B, Hkv, want):
    assert tda.decode_splits(S, B, Hkv) == want


def test_decode_splits_bounds():
    for S in (0, 1, 63, 64, 65, 127, 128, 129, 300, 1000, 2048, 4096,
              32768):
        for B in (1, 2, 3, 8, 64):
            for Hkv in (1, 2, 8, 16):
                n, chunk = tda.decode_splits(S, B, Hkv)
                assert 1 <= n <= tda.MAX_SPLITS
                assert chunk % 64 == 0 and chunk >= 64
                # The chunks cover S, and the last one is not empty.
                assert n * chunk >= S and (n - 1) * chunk < max(S, 1)
                # Enough blocks, unless the chunks would get too short.
                if B * Hkv * n < 2 * tda.SMS and n < tda.MAX_SPLITS:
                    assert S < 2 * n * tda.MIN_CHUNK


def test_split_cases_cross_the_chunk_edges():
    seen, most = set(), 0
    for name, make in testing.decode_split_cases().items():
        q, kc, vc, lens, kw = make()
        B, S, Hkv = kc.shape[:3]
        n, chunk = tda.decode_splits(S, B, Hkv)
        most = max(most, n)
        assert n > 1 or S <= tda.MIN_CHUNK, name
        for x in map(int, lens):
            if x in (0, 1, S):
                seen.add("S" if x == S else x)
            if 1 < x < S and x % chunk in (chunk - 1, 0, 1):
                seen.add(("chunk edge", {chunk - 1: -1, 0: 0, 1: 1}[
                    x % chunk]))
    assert seen == {0, 1, "S", ("chunk edge", -1), ("chunk edge", 0),
                    ("chunk edge", 1)}
    assert most == tda.MAX_SPLITS


def _online_pv(logits, v, mode: str):
    """Attention of one head as the bfloat16 flash kernel computes it:
    an online softmax over 64-key tiles (float32 logits, running max and
    sum), with P V taking P in bfloat16 (``"bf16"``), as hi + lo bfloat16
    parts (``"hilo"``) or in float32 (``"f32"``), sums in float32; the
    output rounded to bfloat16."""
    S = logits.shape[0]
    m = torch.full((S, 1), -math.inf)
    l = torch.zeros(S, 1)
    o = torch.zeros(S, v.shape[1])
    vf = v.float()
    for k0 in range(0, logits.shape[1], 64):
        x = logits[:, k0:k0 + 64]
        m_new = torch.maximum(m, x.amax(1, keepdim=True))
        m_use = torch.where(m_new.isfinite(), m_new, 0.0)
        alpha = torch.exp(m - m_use)
        p = torch.exp(x - m_use)
        l = l * alpha + p.sum(1, keepdim=True)
        m = m_new
        if mode == "f32":
            pv = p @ vf[k0:k0 + 64]
        else:
            hi = p.bfloat16().float()
            pv = hi @ vf[k0:k0 + 64]
            if mode == "hilo":
                pv = pv + (p - hi).bfloat16().float() @ vf[k0:k0 + 64]
        o = o * alpha + pv
    return (o / l).bfloat16()


def test_pv_rounding_needs_the_hi_lo_split():
    S, d = 2048, 128
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((S, d), dtype=np.float32))
               .bfloat16() for _ in range(3))
    want = tref.attention_ref(q[None, :, None], k[None, :, None],
                              v[None, :, None])[0, :, 0].float()
    logits = (q.float() @ k.float().T) * d ** -0.5
    logits = logits.masked_fill(
        torch.ones(S, S, dtype=torch.bool).triu(1), -math.inf)
    limit = FULL_ATOL + FULL_RTOL * want.abs()
    share = {mode: ((_online_pv(logits, v, mode).float() - want).abs()
                    / limit) for mode in ("bf16", "hilo", "f32")}
    # P in bfloat16: entries well past the limit.
    assert float(share["bf16"].max()) > 10
    assert float((share["bf16"] > 1).float().mean()) > 0.01
    # P as hi + lo: within half of the limit, as float32 P is.
    assert float(share["hilo"].max()) < 0.5
    assert float(share["f32"].max()) < 0.5


def test_bf16_row_rule():
    x = torch.zeros(2, 24, 4, 32, dtype=torch.bfloat16)
    tfa.check_16_byte_rows("flash_attention", "q", x)
    # An axis of length 1 may have any stride.
    tfa.check_16_byte_rows("flash_attention", "q", x[:1, :, :1])
    wide = torch.zeros(2, 24, 4 * 32 + 8, dtype=torch.bfloat16)
    tfa.check_16_byte_rows("flash_attention", "q",
                           wide[..., 8:].unflatten(-1, (4, 32)))
    with pytest.raises(ValueError):
        # Rows 2 bytes past a 16-byte boundary.
        odd = torch.zeros(2, 24, 4 * 32 + 1, dtype=torch.bfloat16)
        tfa.check_16_byte_rows("flash_attention", "q",
                               odd[..., 1:].unflatten(-1, (4, 32)))
    with pytest.raises(ValueError):
        # A sequence stride of 136 values (272 bytes) but heads 34 apart.
        odd = torch.zeros(2, 24, 4 * 34, dtype=torch.bfloat16)
        tfa.check_16_byte_rows("flash_attention", "q",
                               odd.unflatten(-1, (4, 34))[..., :32])
