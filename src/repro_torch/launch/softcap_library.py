"""grok-1-314b's soft-capped attention: the port's kernels against the one
PyTorch call that computes the same function, ``flex_attention`` with a
tanh ``score_mod``, compiled as its documentation says
(``torch.compile(flex_attention)``).

    python -m repro_torch.launch.softcap_library [--out FILE]

On the card (a CUDA device is required): prefill, the flash kernel
(``ops.flash_attention``) at grok-1's serve shapes (B = 1, S = 256 and
2048, 48 query heads on 8 KV heads of 128, causal, logits capped at 30),
and decode, the decode kernel (``ops.decode_attention``) over its
8-slot, 4096-position cache with every length full and with lengths
from a seed (the smoke's ``decode_runs``).  Each call timed by
``kernel_timing.batched_ms`` (20 launches an event pair, the median of 5
rounds, the two callables in turns), each output held to the plain
version (``ref.attention_ref``, ``ref.decode_attention_ref``): the
kernels' within 1e-5 + 2^-6 |plain| (two bf16 ulps, ``chip_smoke.py``'s
limit at the serve shapes), flex_attention's within rtol = atol = 2e-2
(the attention kernel tests' bf16 tolerance: it rounds P to bf16 before
P V, which the kernels split into two bf16 parts).  Prints one line a
shape, the card's name and power limit, and the results as one JSON
object.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..configs import get_config
from ..kernels import ops
from ..kernels import ref as plain
from . import kernel_timing as kt

ARCH = "grok-1-314b"
PREFILL_S = (256, 2048)
DECODE_B, DECODE_CACHE = 8, 4096
LAUNCHES, ROUNDS = 20, 5
KERNEL_TOL = (2.0 ** -6, 1e-5)           # (rtol, atol)
LIBRARY_TOL = (2e-2, 2e-2)


def _close(what: str, got: torch.Tensor, want: torch.Tensor,
           tol: tuple) -> float:
    """The largest share of the limit an entry uses (exits past 1)."""
    rtol, atol = tol
    g, w = got.float(), want.float()
    share = float(((g - w).abs() / (atol + rtol * w.abs())).max())
    if share > 1:
        raise SystemExit(f"softcap_library: {what} differs from the plain "
                         f"version ({share:.3g} of atol {atol:g} + rtol "
                         f"{rtol:g} |plain|)")
    return share


def _flex():
    from torch.nn.attention.flex_attention import flex_attention
    return torch.compile(flex_attention, dynamic=False)


def prefill_case(flex, S: int, dev, g) -> dict:
    cfg = get_config(ARCH)
    H, Hkv, d, cap = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.softcap
    q = torch.randn(1, S, H, d, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(1, S, Hkv, d, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(1, S, Hkv, d, generator=g, device=dev).to(torch.bfloat16)
    from torch.nn.attention.flex_attention import create_block_mask

    qt, kt_, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def score(s, b, h, qi, ki):
        return cap * torch.tanh(s / cap)

    def causal(b, h, qi, ki):
        return qi >= ki

    # The causal mask as a block mask, so that flex_attention skips the
    # blocks above the diagonal, as the kernel does.
    mask = create_block_mask(causal, None, None, S, S, device=dev)
    fns = {"kernel": lambda: ops.flash_attention(q, k, v, causal=True,
                                                 softcap=cap),
           "library": lambda: flex(qt, kt_, vt, score_mod=score,
                                   block_mask=mask, enable_gqa=True)}
    times, outs = kt.batched_ms(fns, LAUNCHES, ROUNDS)
    want = plain.attention_ref(q, k, v, causal=True, softcap=cap)
    return {"what": f"flash B=1 S={S}", "kernel_ms": times["kernel"],
            "library_ms": times["library"],
            "kernel_share": _close(f"the flash kernel at S={S}",
                                   outs["kernel"], want, KERNEL_TOL),
            "library_share": _close(f"flex_attention at S={S}",
                                    outs["library"].transpose(1, 2), want,
                                    LIBRARY_TOL)}


def decode_case(flex, label: str, lengths: np.ndarray, dev, g) -> dict:
    from torch.nn.attention.flex_attention import create_block_mask

    cfg = get_config(ARCH)
    H, Hkv, d, cap = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.softcap
    B, S = DECODE_B, DECODE_CACHE
    q = torch.randn(B, H, d, generator=g, device=dev).to(torch.bfloat16)
    kc = torch.randn(B, S, Hkv, d, generator=g, device=dev).to(
        torch.bfloat16)
    vc = torch.randn(B, S, Hkv, d, generator=g, device=dev).to(
        torch.bfloat16)
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    qt = q[:, :, None].contiguous()
    kt_, vt = (t.transpose(1, 2).contiguous() for t in (kc, vc))

    def score(s, b, h, qi, ki):
        return cap * torch.tanh(s / cap)

    def seen(b, h, qi, ki):
        return ki < lens[b]

    mask = create_block_mask(seen, B, None, 1, S, device=dev)
    fns = {"kernel": lambda: ops.decode_attention(q, kc, vc, lens,
                                                  softcap=cap),
           "library": lambda: flex(qt, kt_, vt, score_mod=score,
                                   block_mask=mask, enable_gqa=True)}
    times, outs = kt.batched_ms(fns, LAUNCHES, ROUNDS)
    want = plain.decode_attention_ref(q, kc, vc, lens, softcap=cap)
    return {"what": f"decode B={B} cache {S}, {label}",
            "kernel_ms": times["kernel"], "library_ms": times["library"],
            "kernel_share": _close(f"the decode kernel, {label}",
                                   outs["kernel"], want, KERNEL_TOL),
            "library_share": _close(f"flex_attention, {label}",
                                    outs["library"][:, :, 0], want,
                                    LIBRARY_TOL)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the JSON here too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("softcap_library times the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    flex = _flex()
    rows = [prefill_case(flex, S, dev, g) for S in PREFILL_S]
    rng = np.random.default_rng(0)
    for label, lengths in (
            (f"every length {DECODE_CACHE}", np.full(DECODE_B, DECODE_CACHE)),
            ("lengths from the seed",
             rng.integers(1, DECODE_CACHE + 1, size=DECODE_B))):
        rows.append(decode_case(flex, label, lengths, dev, g))
    for r in rows:
        print(f"{r['what']}: kernel {r['kernel_ms']:.4f} ms, flex_attention "
              f"(compiled) {r['library_ms']:.4f} ms; shares of the limit "
              f"{r['kernel_share']:.3f} / {r['library_share']:.3f}")
    out = {"card": kt.card_line(), "torch": torch.__version__, "rows": rows}
    print(out["card"])
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
