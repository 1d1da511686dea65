"""Launch the CUDA selective-scan kernel (``csrc/selective_scan.cu``).

:func:`selective_scan` is the wrapper: it checks its inputs, then on CUDA
tensors launches the kernel on the current stream (raising if the build or
the launch fails; there is no fallback), and on CPU tensors calls the plain
version ``ref.selective_scan_ref``.  The kernel walks the whole sequence in
one launch; ``h0`` and the returned final state let a caller split a
sequence across calls.  Where autograd records the call (grad mode on and
an operand requiring a gradient) the wrapper goes through
:class:`SelectiveScan`, whose backward is ``selective_scan_bwd``'s kernel
(the plain ``ref.selective_scan_bwd_ref`` on CPU tensors).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from . import build, custom_ops, on_shards, ref
from . import selective_scan_bwd as bwd

# The largest state size N the kernel holds in registers (8 lanes a
# channel, 2 states each); every published Mamba-1 model has N = 16.
MAX_STATE = 16
# The kernel's geometry (csrc/selective_scan.cu): channels a block, and
# steps a chunk (a stage of its shared-memory ring).
BLOCK_CHANNELS = 16
CHUNK = 32

# Launches of the kernel (not of the plain version).
launches = 0


def check_scan_inputs(name: str, tensors: dict, shapes: dict,
                      model_dtype: tuple = ()) -> None:
    """Refuse what the scan kernels do not take: operands other than
    tensors, of other shapes than ``shapes`` gives, on more than one device
    or on a device other than cuda or cpu; the ``model_dtype`` operands in
    float32 or bfloat16, the others in float32."""
    first = next(iter(tensors.values()))
    for key, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} takes torch.Tensors, got "
                            f"{type(t).__name__} for {key}")
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {shapes[key]}")
        allowed = ((torch.float32, torch.bfloat16) if key in model_dtype
                   else (torch.float32,))
        if t.dtype not in allowed:
            raise TypeError(f"{name} takes {key} in "
                            f"{' or '.join(str(d)[6:] for d in allowed)}, "
                            f"got {t.dtype}")
        if t.device != first.device:
            raise ValueError(f"{name} takes operands on one device, got "
                             f"{t.device} for {key} and {first.device}")
    if first.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, got {first.device}")


def selective_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                   h0: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1 selective scan: x, dt [Bt, S, Di] (float32 or bfloat16),
    A [Di, N], B and C [Bt, S, N], D [Di], h0 [Bt, Di, N] (float32; zeros
    by default) -> (y [Bt, S, Di] in x's dtype, h_final [Bt, Di, N]
    float32); see ``ref.selective_scan_ref``.  DTensor operands run on
    each rank's shards (``on_shards``); fake tensors go to the custom op
    (``custom_ops``), which the dry run counts."""
    if isinstance(x, DTensor):
        return on_shards.selective_scan(selective_scan, x, dt, A, B, C, D,
                                        h0)
    if not isinstance(x, torch.Tensor) or x.dim() != 3:
        raise ValueError("selective_scan takes x [Bt, S, Di]")
    if not isinstance(A, torch.Tensor) or A.dim() != 2:
        raise ValueError("selective_scan takes A [Di, N]")
    Bt, S, Di = x.shape
    N = A.shape[1]
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"selective_scan takes a state size N in 1.."
                         f"{MAX_STATE}, got {N}")
    ops_ = {"x": x, "dt": dt, "A": A, "B": B, "C": C, "D": D}
    shapes = {"x": (Bt, S, Di), "dt": (Bt, S, Di), "A": (Di, N),
              "B": (Bt, S, N), "C": (Bt, S, N), "D": (Di,),
              "h0": (Bt, Di, N)}
    if h0 is not None:
        ops_["h0"] = h0
    check_scan_inputs("selective_scan", ops_, shapes, ("x", "dt"))
    if build.needs_grad(x, dt, A, B, C, D, h0):
        return SelectiveScan.apply(x, dt, A, B, C, D, h0)
    if custom_ops.is_fake(x):
        return custom_ops.selective_scan(x, dt, A, B, C, D, h0, False)[:2]
    if x.device.type == "cpu":
        return ref.selective_scan_ref(x, dt, A, B, C, D, h0)
    return _launch(*_on_card(x, dt, A, B, C, D, h0))[:2]


def _on_card(x, dt, A, B, C, D, h0):
    """The operands contiguous, h0 zeros when None."""
    if h0 is None:
        h0 = torch.zeros(x.shape[0], x.shape[2], A.shape[1],
                         dtype=torch.float32, device=x.device)
    return [t.contiguous() for t in (x, dt, A, B, C, D, h0)]


def _launch(x, dt, A, B, C, D, h0, states: bool = False):
    """(y, h_final, the state entering each ``CHUNK``-step chunk
    [Bt, ceil(S / CHUNK), Di, N] float32 with ``states``, else None)."""
    global launches
    Bt, S, Di = x.shape
    N = A.shape[1]
    y = torch.empty_like(x)
    hf = torch.empty_like(h0)
    hb = (torch.empty(Bt, -(-S // CHUNK), Di, N, dtype=torch.float32,
                      device=x.device) if states else None)
    if Bt and Di:
        lib = build.load()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.selective_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), h0.data_ptr(), y.data_ptr(),
            hf.data_ptr(), None if hb is None else hb.data_ptr(), Bt, S,
            Di, N, build.DTYPE_CODES[str(x.dtype)[6:]],
            build.DTYPE_CODES[str(dt.dtype)[6:]], x.device.index, stream)
        build.check_rc(lib, rc, "selective_scan")
        launches += 1
    return y, hf, hb


class SelectiveScan(torch.autograd.Function):
    """The selective scan with its gradient: on CUDA tensors the forward
    kernel (writing the state entering each chunk) and the backward kernel
    (``selective_scan_bwd``), on CPU tensors ``ref.selective_scan_ref``
    and ``ref.selective_scan_bwd_ref``.  Either output's gradient may be
    absent (zeros); dh0 is returned when h0 was given."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, h0):
        ctx.set_materialize_grads(False)
        ctx.has_h0 = h0 is not None
        if custom_ops.is_fake(x):
            y, hf, hb = custom_ops.selective_scan(x, dt, A, B, C, D, h0, True)
            ctx.save_for_backward(x, dt, A, B, C, D, h0, hb)
        elif x.device.type == "cpu":
            y, hf = ref.selective_scan_ref(x, dt, A, B, C, D, h0)
            ctx.save_for_backward(x, dt, A, B, C, D, h0, None)
        else:
            ops_ = _on_card(x, dt, A, B, C, D, h0)
            y, hf, hb = _launch(*ops_, states=True)
            ctx.save_for_backward(*ops_[:6], None, hb)
        return y, hf

    @staticmethod
    def backward(ctx, dy, dhf):
        x, dt, A, B, C, D, h0, hb = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = bwd.selective_scan_bwd(x, dt, A, B, C, D, h0, dy, dhf,
                                       states=hb)
        return (*grads[:6], grads[6] if ctx.has_h0 else None)
