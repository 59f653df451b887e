"""FIMD IP on Hopper — port of ``repro.kernels.fimd.fimd``.

The TPU kernel (``_fimd_kernel``) is the paper's Fisher-Information-Matrix
Diagonal IP: ``[B, P] -> [P]``, the sum over B of squared gradients in f32.
Here it is ``csrc/fimd.cu``, CUDA C++ for ``sm_90a``, a shared library with
a plain C interface (``kernels/build.py``) bound with ctypes: one thread per
four columns, the whole reduction in registers, memory-bound (it reads g
once and writes [P] once); the source says what the design does about it.

CUDA C++ rather than Triton keeps one route, one build and one binding for
all the port's kernels; a reduction this plain gains nothing from Triton's
block model.

``LAUNCHES`` counts launches of the kernel and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build as _build

F32 = torch.float32

_ENTRY = {F32: "ficabu_fimd_f32", torch.bfloat16: "ficabu_fimd_bf16"}

LAUNCHES = 0  # kernel launches since the last reset
_LIB: Optional[ctypes.CDLL] = None


def fimd_ref(g: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``[B, P] -> [P]`` f32, the sum over B of
    g² with g widened to f32 first."""
    gf = g.to(F32)
    return (gf * gf).sum(0)


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("fimd")
        for name in _ENTRY.values():
            _build.bind(lib, name, [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_longlong, ctypes.c_longlong,
                                    ctypes.c_void_p])
        _LIB = lib
    return _LIB


def fimd_cuda(g: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on a contiguous CUDA tensor g [B, P] (f32 or bf16);
    returns [P] f32. Launches on the current stream and does not
    synchronise."""
    global LAUNCHES
    dev = g.device
    if dev.type != "cuda":
        raise ValueError(f"fimd_cuda takes a CUDA tensor, got g on {dev}")
    if g.dtype not in _ENTRY or g.ndim != 2 or not g.is_contiguous():
        raise ValueError(f"the fimd kernel takes a contiguous [B, P] f32 or "
                         f"bf16 tensor, got {g.dtype} {tuple(g.shape)} "
                         f"(contiguous={g.is_contiguous()})")
    B, P = g.shape
    out = torch.empty(P, dtype=F32, device=dev)
    if P:
        with torch.cuda.device(dev):
            err = getattr(_lib(), _ENTRY[g.dtype])(
                g.data_ptr(), out.data_ptr(), B, P,
                torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"fimd kernel launch failed: cudaError {err}")
        LAUNCHES += 1
    return out
