"""The LM kernels as custom ops, for counting on fake tensors.

The dry run (``launch.dryrun``) executes a step on fake tensors
(``torch._subclasses.fake_tensor.FakeTensor``: shapes, dtypes and devices,
no data) and counts what it runs (``launch.op_cost``).  A kernel wrapper
given a fake tensor calls the custom op here (``torch.ops.repro_torch.*``)
instead of launching its kernel or running its plain version: the op's
fake implementation makes outputs of the kernel's shapes, dtypes and
extra buffers (the log-sum-exp, the scans' saved states), so the step's
memory is the kernel's, and its flop formula
(``torch.utils.flop_counter.register_flop_formula``) is what
``repro.launch.hlo_cost.analyze_hlo`` counts for the reference's plain
version of the same function, so that totals compare across the two
packages:

- attention: the two products of the plain version over the full
  Sq x Sk (causal or not), 4 B Hq Sq Sk d; its backward (``jax.vjp``
  of the plain version) 8 B Hq Sq Sk d;
- decode attention: 4 B Hq S d over the whole cache, whatever the
  lengths;
- the selective scan: the per-step product h . C, 2 Bt S Di N; its
  backward dC's product, 2 Bt S Di N;
- the RG-LRU scan and its backward: 0 (the plain version has no product,
  only elementwise work).

The wrappers send only fake tensors here: real CPU tensors go to the
plain versions and real CUDA tensors to the kernels.  An op given real
CPU tensors runs its body, the plain version with the kernel's extra
outputs (zeros where the plain version has none), so that a test can
count on real ranks the program a fake run counts.
Registration needs neither a card nor a compiler.
"""
from __future__ import annotations

import math

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

# The op names, in the order of the kernel table (PERF.md section 6).
OPS = ("flash_attention", "flash_attention_bwd", "decode_attention",
       "selective_scan", "selective_scan_bwd", "rglru_scan",
       "rglru_scan_bwd")


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor (shapes without data): the kernel
    wrappers call their custom ops for such operands."""
    return isinstance(t, FakeTensor)


def _cpu_only(t, name: str) -> None:
    if t.device.type != "cpu":
        raise RuntimeError(f"repro_torch::{name} runs real tensors on the "
                           f"CPU only; on the card call its wrapper")


def _fresh(outs):
    """The body's outputs contiguous, each in a storage of its own, as the
    kernel's are (a view of a plain version's temporary would keep the
    temporary alive, and autograd copies a gradient laid out otherwise)."""
    return type(outs)(
        t if t._base is None and t.is_contiguous()
        else t.clone(memory_format=torch.contiguous_format) for t in outs)


# -- attention ---------------------------------------------------------------

@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, window: int | None, scale: float | None,
                    softcap: float | None, pos_offset: int | None,
                    with_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse); lse is empty unless ``with_lse``."""
    from . import ref

    _cpu_only(q, "flash_attention")
    out, lse = ref.attention_ref(q, k, v, causal=causal, window=window,
                                 scale=scale, softcap=softcap,
                                 pos_offset=pos_offset, return_lse=True)
    return _fresh((out, lse if with_lse else lse.new_empty(0)))


@flash_attention.register_fake
def _(q, k, v, causal, window, scale, softcap, pos_offset, with_lse):
    B, Sq, Hq, _ = q.shape
    lse = q.new_empty((B, Hq, Sq) if with_lse else (0,),
                      dtype=torch.float32)
    return torch.empty_like(q, memory_format=torch.contiguous_format), lse


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs):
    B, Sq, Hq, d = q_shape
    return 4 * B * Hq * Sq * k_shape[1] * d


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, causal: bool, window: int | None,
                        scale: float | None, softcap: float | None,
                        pos_offset: int | None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    from . import ref

    _cpu_only(q, "flash_attention_bwd")
    return _fresh(ref.attention_bwd_ref(q, k, v, o, dout, lse, causal=causal,
                                        window=window, scale=scale,
                                        softcap=softcap,
                                        pos_offset=pos_offset))


@flash_attention_bwd.register_fake
def _(q, k, v, o, dout, lse, causal, window, scale, softcap, pos_offset):
    # The kernel's D = rowsum(dO o O) scratch is freed with the call.
    return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
            torch.empty(k.shape, dtype=k.dtype, device=q.device),
            torch.empty(v.shape, dtype=v.dtype, device=q.device))


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _(q_shape, k_shape, *args, out_shape=None, **kwargs):
    B, Sq, Hq, d = q_shape
    return 8 * B * Hq * Sq * k_shape[1] * d


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor,
                     scale: float | None, window: int | None,
                     softcap: float | None, with_lse: bool
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse); lse is empty unless ``with_lse``."""
    from . import ref

    _cpu_only(q, "decode_attention")
    out, lse = ref.decode_attention_ref(q, k_cache, v_cache, lengths,
                                        scale=scale, window=window,
                                        softcap=softcap, return_lse=True)
    return _fresh((out, lse if with_lse else lse.new_empty(0)))


@decode_attention.register_fake
def _(q, k_cache, v_cache, lengths, scale, window, softcap, with_lse):
    B, Hq, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((B, Hq) if with_lse else (0,), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def _(q_shape, k_shape, *args, out_shape=None, **kwargs):
    B, Hq, d = q_shape
    return 4 * B * Hq * k_shape[1] * d


# -- the scans ---------------------------------------------------------------

@torch.library.custom_op("repro_torch::selective_scan", mutates_args=())
def selective_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                   h0: torch.Tensor | None, states: bool
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, h_final, the state entering each chunk); the last is empty
    unless ``states``."""
    from . import ref

    _cpu_only(x, "selective_scan")
    # The plain version keeps no states: zeros of the kernel's shape.
    y, hf = ref.selective_scan_ref(x, dt, A, B, C, D, h0)
    return _fresh((y, hf, (x.new_zeros(_chunk_states(x, A),
                                       dtype=torch.float32)
                           if states else hf.new_empty(0))))


def _chunk_states(x, A) -> tuple:
    from .selective_scan import CHUNK

    Bt, S, Di = x.shape
    return (Bt, math.ceil(S / CHUNK), Di, A.shape[1])


@selective_scan.register_fake
def _(x, dt, A, B, C, D, h0, states):
    Bt, S, Di = x.shape
    N = A.shape[1]
    f32 = dict(dtype=torch.float32, device=x.device)
    hb = torch.empty(_chunk_states(x, A) if states else (0,), **f32)
    return (torch.empty(x.shape, dtype=x.dtype, device=x.device),
            torch.empty(Bt, Di, N, **f32), hb)


@register_flop_formula(torch.ops.repro_torch.selective_scan)
def _(x_shape, dt_shape, A_shape, *args, out_shape=None, **kwargs):
    Bt, S, Di = x_shape
    return 2 * Bt * S * Di * A_shape[1]


@torch.library.custom_op("repro_torch::selective_scan_bwd", mutates_args=())
def selective_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                       h0: torch.Tensor | None, dy: torch.Tensor,
                       dh_final: torch.Tensor | None,
                       states: torch.Tensor | None) -> list[torch.Tensor]:
    from . import ref

    _cpu_only(x, "selective_scan_bwd")
    grads = ref.selective_scan_bwd_ref(x, dt, A, B, C, D, h0, dy, dh_final)
    return _fresh(list(grads))


@selective_scan_bwd.register_fake
def _(x, dt, A, B, C, D, h0, dy, dh_final, states):
    Bt, S, Di = x.shape
    N = A.shape[1]
    f32 = dict(dtype=torch.float32, device=x.device)
    return [torch.empty(x.shape, dtype=x.dtype, device=x.device),
            torch.empty(Bt, S, Di, **f32), torch.empty(Di, N, **f32),
            torch.empty(Bt, S, N, **f32), torch.empty(Bt, S, N, **f32),
            torch.empty(Di, **f32), torch.empty(Bt, Di, N, **f32)]


@register_flop_formula(torch.ops.repro_torch.selective_scan_bwd)
def _(x_shape, dt_shape, A_shape, *args, out_shape=None, **kwargs):
    Bt, S, Di = x_shape
    return 2 * Bt * S * Di * A_shape[1]


@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=())
def rglru_scan(x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor | None,
               states: bool
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(every h, h_final, every h in float32); the last is empty unless
    ``states`` (and x's own dtype is not float32)."""
    from . import ref

    _cpu_only(x, "rglru_scan")
    # The plain version keeps no states: zeros of the kernel's shape.
    y, hf = ref.rglru_ref(x, a, h0)
    return _fresh((y, hf, (torch.zeros(x.shape, dtype=torch.float32)
                           if states and x.dtype != torch.float32
                           else hf.new_empty(0))))


@rglru_scan.register_fake
def _(x, a, h0, states):
    B, S, D = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    h32 = (torch.empty(B, S, D, **f32)
           if states and x.dtype != torch.float32 else torch.empty(0, **f32))
    return (torch.empty(x.shape, dtype=x.dtype, device=x.device),
            torch.empty(B, D, **f32), h32)


@register_flop_formula(torch.ops.repro_torch.rglru_scan)
def _(*args, out_shape=None, **kwargs):
    return 0


@torch.library.custom_op("repro_torch::rglru_scan_bwd", mutates_args=())
def rglru_scan_bwd(x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor | None,
                   dy: torch.Tensor, dh_final: torch.Tensor | None,
                   states: torch.Tensor | None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    from . import ref

    _cpu_only(x, "rglru_scan_bwd")
    return _fresh(ref.rglru_bwd_ref(x, a, h0, dy, dh_final))


@rglru_scan_bwd.register_fake
def _(x, a, h0, dy, dh_final, states):
    B, S, D = x.shape
    return (torch.empty(x.shape, dtype=x.dtype, device=x.device),
            torch.empty(a.shape, dtype=a.dtype, device=x.device),
            torch.empty(B, D, dtype=torch.float32, device=x.device))


@register_flop_formula(torch.ops.repro_torch.rglru_scan_bwd)
def _(*args, out_shape=None, **kwargs):
    return 0


def optional(t: torch.Tensor):
    """A custom op's optional output: None where it is empty."""
    return None if t.numel() == 0 else t
