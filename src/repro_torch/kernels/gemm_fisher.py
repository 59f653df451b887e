"""Backward GEMM with the Fisher epilogue on Hopper — port of
``repro.kernels.gemm_fisher.gemm_fisher``.

The TPU kernel (``_gemm_fisher_kernel``) computes a layer's weight gradient
``dW = Aᵀ·G`` (A [N, M] the layer input, G [N, K] its output cotangent,
f32 accumulation) and squares it into the Fisher tile while the tile is
still on chip: ``(dW, dW²)``. Here it is ``csrc/gemm_fisher.cu``, CUDA C++
for ``sm_90a``, a shared library with a plain C interface
(``kernels/build.py``) bound with ctypes: 64 × 64 dW tiles on the tensor
cores (``mma.sync`` TF32; 3×TF32 for f32 operands, which keeps the rtol
1e-4 contract that one TF32 pass misses), fed by ``cp.async``, with the
reduction over N split into slices (``split_plan``) where the dW tiles
alone would leave the card idle. With more than one slice the partials go
to a workspace and a second kernel sums them in slice order, so the result
is the same bits on every run.

``LAUNCHES`` counts wrapper calls that launched the kernel (one per call,
whether the call runs one pass or two) and nothing else.
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
# rows of N per shared-memory slab of the kernel; every slice of a split
# but the last is a multiple of it
SLAB = 32
# dW-tile blocks a split aims for (two per SM of a 132-SM H100); a split
# makes at most ceil(N / SPLIT_MIN_ROWS) slices. Constants, not read from
# the card, so that a result does not depend on the card it ran on.
SPLIT_TARGET = 264
SPLIT_MIN_ROWS = 256

LAUNCHES = 0  # wrapper calls that launched, since the last reset
_LIB: Optional[ctypes.CDLL] = None


def gemm_fisher_ref(a: torch.Tensor, g: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: ``dW = einsum("nm,nk->mk")`` of the f32
    operands and its square, both [M, K] f32."""
    dw = torch.einsum("nm,nk->mk", a.to(F32), g.to(F32))
    return dw, dw * dw


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


def split_plan(N: int, M: int, K: int, slab: int = SLAB) -> Tuple[int, int]:
    """(S, rows): the reduction over N cut into S slices of ``rows`` rows
    (the last one shorter), a pure function of the shape. S grows until the
    ⌈M/64⌉·⌈K/64⌉ dW tiles times S reach ``SPLIT_TARGET`` blocks, and
    stays at most ⌈N / SPLIT_MIN_ROWS⌉; ``rows`` is a multiple of ``slab``.
    S = 1 (rows = N) where the tiles alone fill the card."""
    tiles = _cdiv(M, _TILE) * _cdiv(K, _TILE)
    S = min(_cdiv(SPLIT_TARGET, max(tiles, 1)), _cdiv(N, SPLIT_MIN_ROWS))
    if S <= 1:
        return 1, max(N, 0)
    rows = _cdiv(_cdiv(N, S), slab) * slab
    return _cdiv(N, rows), rows


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("gemm_fisher")
        for name in _ENTRY.values():
            _build.bind(lib, name, [ctypes.c_void_p] * 5 + [
                ctypes.c_longlong] * 5 + [ctypes.c_void_p])
        _LIB = lib
    return _LIB


def check_operands(a: torch.Tensor, g: torch.Tensor) -> Tuple[int, int, int]:
    """(N, M, K) of operands the kernel takes: a [N, M] and g [N, K],
    contiguous, of one dtype (f32 or bf16) on a's device, M within the
    grid; raises ValueError otherwise."""
    dev = a.device
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
    if g.shape[0] != N or _cdiv(M, _TILE) > _MAX_GRID_Y:
        raise ValueError(f"gemm_fisher kernel takes a [N, M] and g [N, K] "
                         f"with M <= {_TILE * _MAX_GRID_Y}, got a "
                         f"{tuple(a.shape)}, g {tuple(g.shape)}")
    return N, M, K


def gemm_fisher_cuda(a: torch.Tensor, g: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on contiguous CUDA tensors a [N, M] and g [N, K]
    of one dtype, f32 or bf16; returns (dw, fish) [M, K] f32. Launches on
    the current stream and does not synchronise."""
    global LAUNCHES
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"gemm_fisher_cuda takes CUDA tensors, got a on {dev}")
    N, M, K = check_operands(a, g)
    dw = torch.empty(M, K, dtype=F32, device=dev)
    fish = torch.empty(M, K, dtype=F32, device=dev)
    if M and K:
        S, rows = split_plan(N, M, K)
        ws = torch.empty(S, M, K, dtype=F32, device=dev) if S > 1 else None
        with torch.cuda.device(dev):
            err = getattr(_lib(), _ENTRY[a.dtype])(
                a.data_ptr(), g.data_ptr(), dw.data_ptr(), fish.data_ptr(),
                None if ws is None else ws.data_ptr(), N, M, K, rows, S,
                torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"gemm_fisher kernel launch failed: "
                               f"cudaError {err}")
        LAUNCHES += 1
    return dw, fish

