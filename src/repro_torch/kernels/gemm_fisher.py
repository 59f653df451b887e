"""Backward GEMM with the Fisher epilogue on Hopper — port of
``repro.kernels.gemm_fisher.gemm_fisher``.

The TPU kernel (``_gemm_fisher_kernel``) computes a layer's weight gradient
``dW = Aᵀ·G`` (A [N, M] the layer input, G [N, K] its output cotangent,
f32 accumulation) and squares it into the Fisher tile while the tile is
still on chip: ``(dW, dW²)``. Here it is ``csrc/gemm_fisher.cu``, CUDA C++
for ``sm_90a``, a shared library with a plain C interface
(``kernels/build.py``) bound with ctypes: a tiled SIMT SGEMM with f32 FMAs
(not TF32, which misses the rtol 1e-4 contract), each block one 64 × 64 dW
tile over the whole reduction, dW and dW² written from the same registers.

``LAUNCHES`` counts launches of the kernel and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build as _build

F32 = torch.float32

_ENTRY = {F32: "ficabu_gemm_fisher_f32",
          torch.bfloat16: "ficabu_gemm_fisher_bf16"}
_TILE = 64
_MAX_GRID_Y = 65535

LAUNCHES = 0  # kernel launches since the last reset
_LIB: Optional[ctypes.CDLL] = None


def gemm_fisher_ref(a: torch.Tensor, g: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: ``dW = einsum("nm,nk->mk")`` of the f32
    operands and its square, both [M, K] f32."""
    dw = torch.einsum("nm,nk->mk", a.to(F32), g.to(F32))
    return dw, dw * dw


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("gemm_fisher")
        for name in _ENTRY.values():
            _build.bind(lib, name, [ctypes.c_void_p] * 4 + [
                ctypes.c_longlong] * 3 + [ctypes.c_void_p])
        _LIB = lib
    return _LIB


def gemm_fisher_cuda(a: torch.Tensor, g: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on contiguous CUDA tensors a [N, M] and g [N, K]
    of one dtype, f32 or bf16; returns (dw, fish) [M, K] f32. Launches on
    the current stream and does not synchronise."""
    global LAUNCHES
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"gemm_fisher_cuda takes CUDA tensors, got a on {dev}")
    for name, t in (("a", a), ("g", g)):
        if t.device != dev or t.dtype not in _ENTRY or t.dtype != a.dtype \
                or t.ndim != 2 or not t.is_contiguous():
            raise ValueError(
                f"gemm_fisher kernel operand {name} must be a contiguous 2-D "
                f"f32 or bf16 tensor on {dev} of a's dtype {a.dtype}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    N, M = a.shape
    K = g.shape[1]
    if g.shape[0] != N or -(-M // _TILE) > _MAX_GRID_Y:
        raise ValueError(f"gemm_fisher kernel takes a [N, M] and g [N, K] "
                         f"with M <= {_TILE * _MAX_GRID_Y}, got a "
                         f"{tuple(a.shape)}, g {tuple(g.shape)}")
    dw = torch.empty(M, K, dtype=F32, device=dev)
    fish = torch.empty(M, K, dtype=F32, device=dev)
    if M and K:
        with torch.cuda.device(dev):
            err = getattr(_lib(), _ENTRY[a.dtype])(
                a.data_ptr(), g.data_ptr(), dw.data_ptr(), fish.data_ptr(),
                N, M, K, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"gemm_fisher kernel launch failed: "
                               f"cudaError {err}")
        LAUNCHES += 1
    return dw, fish

