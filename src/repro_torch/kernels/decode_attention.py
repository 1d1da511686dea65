"""Launch the CUDA flash-decode kernel (``csrc/decode_attention.cu``).

:func:`decode_attention` is the wrapper: it checks its inputs, then on
CUDA tensors launches the kernel on the current stream (raising if the
build or the launch fails; there is no fallback), and on CPU tensors calls
the plain version ``ref.decode_attention_ref``.  The kernel takes q and
the caches contiguous and 16-byte aligned (each layer's slice of the
model's stacked cache is), so the wrapper never copies a cache.
"""
from __future__ import annotations

import torch

from . import build, ref
from .flash_attention import check_attention_inputs

# Launches of the kernel (not of the plain version).
launches = 0


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     scale: float | None = None, window: int | None = None,
                     softcap: float | None = None) -> torch.Tensor:
    """One-token GQA attention: q [B, Hq, d], caches [B, S, Hkv, d],
    lengths [B] (the valid prefix of each row) -> [B, Hq, d] in q's dtype;
    see ``ref.decode_attention_ref``."""
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"decode_attention takes q [B, Hq, d] and caches "
                         f"[B, S, Hkv, d], got {tuple(q.shape)} and "
                         f"{tuple(k_cache.shape)}")
    B, Hq, d = q.shape
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != B
            or k_cache.shape[3] != d):
        raise ValueError(f"decode_attention: caches {tuple(k_cache.shape)} "
                         f"and {tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    Hkv = k_cache.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"decode_attention: {Hq} query heads do not group "
                         f"over {Hkv} KV heads")
    if not isinstance(lengths, torch.Tensor) or lengths.shape != (B,):
        raise ValueError(f"decode_attention takes lengths as a [{B}] "
                         f"tensor")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"decode_attention: softcap must be > 0, got "
                         f"{softcap}")
    ops_ = {"q": q, "k_cache": k_cache, "v_cache": v_cache}
    check_attention_inputs("decode_attention", ops_, d)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, lengths,
                                        scale=scale, window=window,
                                        softcap=softcap)
    for key, x in ops_.items():
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"decode_attention takes contiguous, 16-byte "
                             f"aligned operands on the card ({key})")
    if lengths.device != q.device or lengths.dtype != torch.int32:
        raise ValueError("decode_attention takes int32 lengths on q's "
                         "device")
    return _launch(q, k_cache, v_cache, lengths.contiguous(), scale, window,
                   softcap)


def _launch(q, k_cache, v_cache, lengths, scale, window, softcap):
    global launches
    B, Hq, d = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    if out.numel():
        lib = build.load()
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.decode_attention_fwd(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, S, Hq, Hkv, d,
            build.DTYPE_CODES[str(q.dtype)[6:]],
            d ** -0.5 if scale is None else scale,
            0.0 if softcap is None else softcap,
            -1 if window is None else window, q.device.index, stream)
        build.check_rc(lib, rc, "decode_attention")
        launches += 1
    return out
