"""Launch the CUDA flash-decode kernel (``csrc/decode_attention.cu``).

:func:`decode_attention` is the wrapper: it checks its inputs, then on
CUDA tensors launches the kernel on the current stream (raising if the
build or the launch fails; there is no fallback), and on CPU tensors calls
the plain version ``ref.decode_attention_ref``.  The kernel takes q and
the caches contiguous and 16-byte aligned (each layer's slice of the
model's stacked cache is), so the wrapper never copies a cache.

The kernel splits the cache over S (flash-decoding): :func:`decode_splits`
picks the number of splits from the shapes alone, so the host never reads
the lengths; the wrapper allocates the split partials' scratch with
``torch.empty`` and keeps one zeroed ticket buffer a stream, which the
kernel leaves zeroed after every launch.  ``ref.decode_attention_split_ref``
is the same split and merge in plain PyTorch.  Asked for it, the kernel
also writes each row's log-sum-exp from the merged partials: with it the
outputs of a cache cut into pieces (over ranks, ``on_shards``) merge into
the uncut call's.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from . import build, custom_ops, on_shards, ref
from .flash_attention import check_attention_inputs

# Launches of the kernel (not of the plain version).
launches = 0

# The splits: enough blocks to fill the 132 streaming multiprocessors of an
# H100 SXM about twice over, chunks of at least MIN_CHUNK positions (four
# 16-position tiles for each of the bfloat16 kernel's 4 warps, so that its
# cp.async ring has tiles to overlap and a block's partial, g x d float32
# values, stays small beside the K and V rows it reads), and at most
# MAX_SPLITS (the kernel's kMaxSplits) partials to merge.
SMS = 132
MIN_CHUNK = 256
MAX_SPLITS = 64

# Per (device, stream): the int32 tickets the split merge counts on (zero
# between launches; launches on one stream never overlap).
_tickets: dict = {}


def decode_splits(S: int, B: int, Hkv: int) -> tuple[int, int]:
    """(n_split, chunk) for a cache of S positions, B rows and Hkv KV
    heads: the smallest power of two n with ``B * Hkv * n >= 2 * SMS``,
    held to ``S / n >= MIN_CHUNK`` and ``n <= MAX_SPLITS``; the chunk is
    ``ceil(S / n)`` rounded up to 64 positions (a tile for each warp), and
    n is then the number of chunks that cover S.  From the shapes only,
    never the lengths."""
    n = 1
    while (B * Hkv * n < 2 * SMS and 2 * n * MIN_CHUNK <= S
           and 2 * n <= MAX_SPLITS):
        n *= 2
    chunk = -(-max(S, 1) // n)
    chunk = -(-chunk // 64) * 64
    return -(-max(S, 1) // chunk), chunk


def _ticket_buffer(device: torch.device, stream: int,
                   n: int) -> torch.Tensor:
    """At least n zeroed int32 tickets for launches on ``stream`` of
    ``device``, allocated once (and again, larger, when a launch needs
    more)."""
    buf = _tickets.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[(device, stream)] = buf
    return buf


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     scale: float | None = None, window: int | None = None,
                     softcap: float | None = None,
                     return_lse: bool = False):
    """One-token GQA attention: q [B, Hq, d], caches [B, S, Hkv, d],
    lengths [B] (the valid prefix of each row) -> [B, Hq, d] in q's dtype;
    see ``ref.decode_attention_ref``.  With ``return_lse`` also each
    row's log-sum-exp [B, Hq] (float32, -inf for a row of length 0),
    which the kernel writes beside the output: what merges the outputs
    of a cache cut over its positions (``on_shards``).  DTensor operands
    run on each rank's shards (``on_shards``); fake tensors go to the
    custom op (``custom_ops``), which the dry run counts."""
    if isinstance(q, DTensor):
        if return_lse:
            raise ValueError("decode_attention returns no lse for DTensor "
                             "operands (the ranks' are merged)")
        return on_shards.decode_attention(decode_attention, q, k_cache,
                                          v_cache, lengths, scale, window,
                                          softcap)
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
    if custom_ops.is_fake(q):
        out, lse = custom_ops.decode_attention(q, k_cache, v_cache, lengths,
                                               scale, window, softcap,
                                               return_lse)
        return (out, lse) if return_lse else out
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, lengths,
                                        scale=scale, window=window,
                                        softcap=softcap,
                                        return_lse=return_lse)
    build.refuse_grad("decode_attention", *ops_.values())
    for key, x in ops_.items():
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"decode_attention takes contiguous, 16-byte "
                             f"aligned operands on the card ({key})")
    if lengths.device != q.device or lengths.dtype != torch.int32:
        raise ValueError("decode_attention takes int32 lengths on q's "
                         "device")
    out, lse = _launch(q, k_cache, v_cache, lengths.contiguous(), scale,
                       window, softcap, return_lse)
    return (out, lse) if return_lse else out


def _launch(q, k_cache, v_cache, lengths, scale, window, softcap,
            with_lse: bool = False):
    """The output, and the log-sum-exp [B, Hq] (float32) with
    ``with_lse``, else None."""
    global launches
    B, Hq, d = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty(B, Hq, dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel():
        lib = build.load()
        stream = torch.cuda.current_stream(q.device).cuda_stream
        n_split, chunk = decode_splits(S, B, Hkv)
        part = torch.empty(B * Hq * n_split * (d + 2) if n_split > 1 else 0,
                           dtype=torch.float32, device=q.device)
        tickets = _ticket_buffer(q.device, stream,
                                 B * Hkv * -(-(Hq // Hkv) // 8))
        rc = lib.decode_attention_fwd(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), part.data_ptr(),
            tickets.data_ptr(), B, S, Hq, Hkv, d,
            build.DTYPE_CODES[str(q.dtype)[6:]],
            d ** -0.5 if scale is None else scale,
            0.0 if softcap is None else softcap,
            -1 if window is None else window, n_split, chunk,
            q.device.index, stream)
        build.check_rc(lib, rc, "decode_attention")
        launches += 1
    return out, lse
