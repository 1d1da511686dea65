"""Build, bind and launch the CUDA FW-with-counts kernel
(``csrc/fw_counts.cu``).

The kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, ``build/repro_torch/libreprotorch_kernels.so``
under the repository root, at its first use (and again whenever a source is
newer than the library), and bound with ``ctypes``.  Nothing is built or
loaded at import time, so the module imports on a machine without a card.

:func:`fw_counts` is the wrapper: it checks its input, then on a CUDA
tensor launches the kernel on the current stream (raising if the build or
the launch fails; there is no fallback), and on a CPU tensor calls the
plain version ``ref.fw_counts_ref``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from . import ref

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "fw_counts.cu",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_PATH = BUILD_DIR / "libreprotorch_kernels.so"
# -fmad=false: no multiply-add contraction, so every float op rounds like
# the plain version's.  Never --use_fast_math (FMA and flush-to-zero).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")
# Shared memory holds row k and column k of D and N: 16 * V bytes, within
# the 232,448 bytes a block may have.
MAX_V = 232448 // 16

# Launches of the kernel (not of the plain version), so a run can show that
# its main path went through the kernel.
launches = 0

_lib = None
_lib_lock = threading.Lock()


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels cannot be built")
    return nvcc


def build_command(out: Path = LIB_PATH, nvcc: str = "nvcc") -> list[str]:
    """The nvcc command line that builds the kernel library into ``out``."""
    return [nvcc, *NVCC_FLAGS, "-o", str(out), *(str(s) for s in SOURCES)]


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    newest = max(s.stat().st_mtime for s in SOURCES)
    return LIB_PATH.stat().st_mtime < newest


def build(force: bool = False) -> str:
    """Compile the library if it is missing or older than its sources.
    Returns nvcc's output (register and shared-memory use per kernel), or
    "" when the library was up to date; raises if nvcc fails."""
    if not force and not _stale():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f"{LIB_PATH.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(build_command(tmp, find_nvcc()),
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return proc.stdout + proc.stderr


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(LIB_PATH))
            lib.fw_counts_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.fw_counts_f32.restype = ctypes.c_int
            lib.reprotorch_error_string.argtypes = [ctypes.c_int]
            lib.reprotorch_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check(W) -> None:
    if not isinstance(W, torch.Tensor):
        raise TypeError(f"fw_counts takes a torch.Tensor, got "
                        f"{type(W).__name__}")
    if W.dtype != torch.float32:
        raise TypeError(f"fw_counts takes float32, got {W.dtype}")
    if W.dim() not in (2, 3) or W.shape[-1] != W.shape[-2]:
        raise ValueError(f"fw_counts takes [V, V] or [B, V, V], got "
                         f"{tuple(W.shape)}")
    if not W.is_contiguous():
        raise ValueError("fw_counts takes a contiguous tensor")
    if W.shape[-1] > MAX_V:
        raise ValueError(f"fw_counts takes V <= {MAX_V}, got {W.shape[-1]}")


def fw_counts(W: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Floyd-Warshall distances + path counts: [(B,) V, V] -> (D, N)."""
    _check(W)
    if W.device.type == "cpu":
        return ref.fw_counts_ref(W)
    if W.device.type != "cuda":
        raise ValueError(f"fw_counts runs on cuda or cpu, got {W.device}")
    return _launch(W)


def _launch(W: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    squeeze = W.dim() == 2
    W3 = W.unsqueeze(0) if squeeze else W
    B, V, _ = W3.shape
    D = torch.empty_like(W3)
    N = torch.empty_like(W3)
    if B and V:
        lib = _load()
        stream = torch.cuda.current_stream(W.device).cuda_stream
        rc = lib.fw_counts_f32(W3.data_ptr(), D.data_ptr(), N.data_ptr(),
                               B, V, W.device.index, stream)
        if rc != 0:
            msg = lib.reprotorch_error_string(rc).decode()
            raise RuntimeError(f"fw_counts kernel launch failed: {msg} "
                               f"(cudaError {rc})")
        launches += 1
    if squeeze:
        D, N = D[0], N[0]
    return D, N
