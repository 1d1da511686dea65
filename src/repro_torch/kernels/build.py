"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled for ``sm_90a`` by its own ``nvcc`` process, all
started together, and one more ``nvcc`` links the objects into one shared
library with a plain C interface,
``build/repro_torch/libreprotorch_kernels.so`` under the repository root.
That happens at first use (and again whenever a source is newer than the
library); the library is bound with ``ctypes``.  Nothing is built or
loaded at import time, so the package imports on a machine without a card
or a compiler.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "fw_counts.cu", _CSRC / "fw_counts_tiled.cu",
           _CSRC / "minplus.cu", _CSRC / "flash_attention.cu",
           _CSRC / "decode_attention.cu", _CSRC / "selective_scan.cu",
           _CSRC / "rglru_scan.cu", _CSRC / "flash_attention_bwd.cu",
           _CSRC / "selective_scan_bwd.cu", _CSRC / "rglru_scan_bwd.cu")
# Headers the sources include (a change rebuilds the library).
HEADERS = (_CSRC / "mma_bf16.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_PATH = BUILD_DIR / "libreprotorch_kernels.so"
# -fmad=false: no multiply-add contraction, so every float op of the FW
# and min-plus kernels rounds like the plain version's.  The attention and
# scan kernels ask for their multiply-adds explicitly (fmaf), which the
# flag leaves alone.  Never --use_fast_math (FMA and flush-to-zero).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC")

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# The C entry points: argument types (pointers and the stream as void*).
# Each returns cudaGetLastError() as an int.
SIGNATURES = {
    # W, D, N, B, V, device, stream
    "fw_counts_f32": [_P, _P, _P, _I, _I, _I, _P],
    # W, D, N, B, V, cluster size, device, stream (measuring only)
    "fw_counts_cluster_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    # V, B -> the cluster size kernel 1 takes (0: its L2-resident path)
    "fw_counts_cluster_size": [_I, _I],
    # -> the largest V kernel 1 holds on chip
    "fw_counts_onchip_max_v": [],
    # W, D, N, scratch D, scratch N, snapshots, counters, B, V, padded V,
    # device, stream
    "fw_counts_tiled_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # B, V, device -> the threads a block of the blocked kernel's launch
    "fw_counts_tiled_threads": [_I, _I, _I],
    # fw_counts_tiled_f32 with a per-item trace after the counters
    # (measuring only)
    "fw_counts_tiled_traced_f32": [_P, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _P],
    # A, B, C (or null: no fused min), out, M, N, K, device, stream
    "minplus_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # q, k, v, out, lse (or null), element strides (batch, seq, head) of
    # q, k and v, B, Sq, Sk, Hq, Hkv, d, dtype code, scale, softcap,
    # causal, window, pos_offset, device, stream
    "flash_attention_fwd": [*[_P] * 5, *[_L] * 9, _I, _I, _I, _I, _I,
                            _I, _I, _F, _F, _I, _I, _I, _I, _P],
    # q, k, v, o, dO, lse, D scratch, dq, dk, dv, element strides (batch,
    # seq, head) of q, k, v, o and dO, B, Sq, Sk, Hq, Hkv, d, dtype code,
    # scale, softcap, causal, window, pos_offset, device, stream
    "flash_attention_bwd": [*[_P] * 10, *[_L] * 15, _I, _I, _I, _I, _I,
                            _I, _I, _F, _F, _I, _I, _I, _I, _P],
    # q, k cache, v cache, lengths, out, lse (or null), split scratch,
    # tickets, B, S, Hq, Hkv, d, dtype code, scale, softcap, window,
    # n_split, chunk, device, stream
    "decode_attention_fwd": [*[_P] * 8, _I, _I, _I, _I, _I, _I,
                             _F, _F, _I, _I, _I, _I, _P],
    # x, dt, A, B, C, D, h0, y, h_final, chunk-boundary states (or null),
    # Bt, S, Di, N, x dtype code, dt dtype code, device, stream
    "selective_scan_fwd": [*[_P] * 10, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, dt, A, B, C, D, boundary states, dy, dh_final (or null), dx, ddt,
    # dA, dB, dC, dD, dh0, three scratch buffers, Bt, S, Di, N, x dtype
    # code, dt dtype code, device, stream
    "selective_scan_bwd": [*[_P] * 19, _I, _I, _I, _I, _I, _I, _I, _P],
    # -> the backward kernel's channels a block
    "selective_scan_bwd_block_channels": [],
    # -> 1 if the backward's last launch staged by tensor maps, 0 if not
    "selective_scan_bwd_tensor_maps": [],
    # x, a, h0, y, h_final, every h in float32 (or null), B, S, D, dtype
    # code, device, stream
    "rglru_scan_fwd": [*[_P] * 6, _I, _I, _I, _I, _I, _P],
    # x, a, dy, every h in float32, h0, dh_final (or null), dx, da, dh0, B,
    # S, D, dtype code, device, stream
    "rglru_scan_bwd": [*[_P] * 9, _I, _I, _I, _I, _I, _P],
}

# The dtype codes the attention and scan entry points take.
DTYPE_CODES = {"float32": 0, "bfloat16": 1}

_lib = None
_lib_lock = threading.Lock()


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels cannot be built")
    return nvcc


def build_commands(out: Path = LIB_PATH, nvcc: str = "nvcc"
                   ) -> tuple[list[list[str]], list[str]]:
    """The nvcc command lines that build the kernel library into ``out``:
    one compile per source (run side by side) and the link."""
    objs = [out.with_name(f"{out.stem}.{s.stem}.o") for s in SOURCES]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                for s, o in zip(SOURCES, objs)]
    link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(out),
            *map(str, objs)]
    return compiles, link


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    newest = max(s.stat().st_mtime for s in SOURCES + HEADERS)
    return LIB_PATH.stat().st_mtime < newest


def _run_all(cmds: list[list[str]]) -> str:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {p.returncode}: "
                               f"{' '.join(c)}\n{o}")
    return "".join(outs)


def build(force: bool = False) -> str:
    """Compile the library if it is missing or older than its sources.
    Returns nvcc's output (register and shared-memory use per kernel), or
    "" when the library was up to date; raises if nvcc fails."""
    if not force and not _stale():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f"{LIB_PATH.stem}.{os.getpid()}.tmp.so")
    compiles, link = build_commands(tmp, find_nvcc())
    try:
        log = _run_all(compiles) + _run_all([link])
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for c in compiles:
            Path(c[c.index("-o") + 1]).unlink(missing_ok=True)
    os.replace(tmp, LIB_PATH)
    return log


def load() -> ctypes.CDLL:
    """The built library with every entry point's signature set."""
    global _lib
    with _lib_lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(LIB_PATH))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.reprotorch_error_string.argtypes = [ctypes.c_int]
            lib.reprotorch_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def needs_grad(*tensors) -> bool:
    """Whether autograd would record a call on these operands: grad mode
    is on and one of them requires a gradient."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse_grad(what: str, *tensors) -> None:
    """Raise where a kernel without a backward would be launched on
    operands that autograd tracks: its raw-pointer launch returns tensors
    with no ``grad_fn``, so the gradients upstream of it would silently be
    zero.  Call under ``torch.no_grad()``, or detach the operands."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{what} has no backward kernel: it does not run on operands "
            f"that require a gradient while grad mode is on (use "
            f"torch.no_grad(), or detach them)")


def check_rc(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = lib.reprotorch_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} "
                           f"(cudaError {rc})")
