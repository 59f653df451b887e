"""INT8 backward GEMM with the Fisher epilogue on Hopper — port of
``repro.kernels.gemm_fisher_int8.gemm_fisher_int8``.

The TPU kernel (``_gemm_fisher_int8_kernel``) contracts int8 codes of a
layer's input and output cotangent with an exact int32 accumulator and
rescales the tile once in the epilogue:
``dw = f32(acc) · (sa[m]·sg[k])``, ``fish = dw²``. Here it is
``csrc/gemm_fisher_int8.cu``, CUDA C++ for ``sm_90a``, a shared library
with a plain C interface (``kernels/build.py``) bound with ctypes: 64 × 64
dW tiles on the int8 tensor cores (``mma.sync`` s8 × s8 → s32, exact), fed
by ``cp.async``, the reduction over N split into slices as
``gemm_fisher.split_plan`` says (slabs of 64 rows) and the int32 partials
summed by a second kernel; bit-exact against its plain version.

The plain version needs the exact integer sum, and PyTorch has no int32
matrix product on the card; it sums in float64 instead, which is exact
here: every partial sum is an integer of magnitude at most 128²·N < 2⁵³,
and an exact integer rounds to f32 the same way from f64 as from int32.

``LAUNCHES`` counts wrapper calls that launched the kernel (one per call,
whether the call runs one pass or two) and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build as _build
from .gemm_fisher import split_plan

F32 = torch.float32

_ENTRY = "ficabu_gemm_fisher_int8"
_TILE = 64
_MAX_GRID_Y = 65535
SLAB = 64   # rows of N per shared-memory slab of the kernel
# the int32 accumulator holds 128² · N exactly up to this N
MAX_N = (2 ** 31 - 1) // (128 * 128)

LAUNCHES = 0  # wrapper calls that launched, since the last reset
_LIB: Optional[ctypes.CDLL] = None


def gemm_fisher_int8_ref(a_q: torch.Tensor, g_q: torch.Tensor,
                         sa: torch.Tensor, sg: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: the exact integer ``a_qᵀ·g_q`` (summed in
    float64), rounded to f32 and rescaled by the f32 product
    ``sa[m]·sg[k]``; returns (dw, dw²) [M, K] f32."""
    acc = torch.einsum("nm,nk->mk", a_q.to(torch.float64),
                       g_q.to(torch.float64))
    sc = sa.to(F32)[:, None] * sg.to(F32)[None, :]
    dw = acc.to(F32) * sc
    return dw, dw * dw


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("gemm_fisher_int8")
        _build.bind(lib, _ENTRY, [ctypes.c_void_p] * 7 + [
            ctypes.c_longlong] * 5 + [ctypes.c_void_p])
        _LIB = lib
    return _LIB


def check_operands(a_q: torch.Tensor, g_q: torch.Tensor, sa: torch.Tensor,
                   sg: torch.Tensor) -> Tuple[int, int, int]:
    """(N, M, K) of operands the kernel takes: contiguous a_q [N, M] and
    g_q [N, K] int8, sa [M] and sg [K] f32, all on a_q's device, N within
    the exact int32 range and M within the grid; raises ValueError
    otherwise."""
    dev = a_q.device
    if a_q.ndim != 2 or g_q.ndim != 2 or a_q.shape[0] != g_q.shape[0]:
        raise ValueError(f"gemm_fisher_int8 kernel takes a_q [N, M] and g_q "
                         f"[N, K], got {tuple(a_q.shape)}, "
                         f"{tuple(g_q.shape)}")
    N, M = a_q.shape
    K = g_q.shape[1]
    for name, t, dt, shape in (("a_q", a_q, torch.int8, (N, M)),
                               ("g_q", g_q, torch.int8, (N, K)),
                               ("sa", sa, F32, (M,)), ("sg", sg, F32, (K,))):
        if t.device != dev or t.dtype != dt or not t.is_contiguous() \
                or tuple(t.shape) != shape:
            raise ValueError(
                f"gemm_fisher_int8 kernel operand {name} must be a contiguous "
                f"{dt} tensor of shape {shape} on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    if N > MAX_N or -(-M // _TILE) > _MAX_GRID_Y:
        raise ValueError(f"gemm_fisher_int8 kernel takes N <= {MAX_N} (its "
                         f"int32 accumulator is exact up to there) and M <= "
                         f"{_TILE * _MAX_GRID_Y}, got N={N}, M={M}")
    return N, M, K


def gemm_fisher_int8_cuda(a_q: torch.Tensor, g_q: torch.Tensor,
                          sa: torch.Tensor, sg: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on contiguous CUDA tensors a_q [N, M] and g_q
    [N, K] int8, sa [M] and sg [K] f32; returns (dw, fish) [M, K] f32.
    Launches on the current stream and does not synchronise."""
    global LAUNCHES
    dev = a_q.device
    if dev.type != "cuda":
        raise ValueError(f"gemm_fisher_int8_cuda takes CUDA tensors, got a_q "
                         f"on {dev}")
    N, M, K = check_operands(a_q, g_q, sa, sg)
    dw = torch.empty(M, K, dtype=F32, device=dev)
    fish = torch.empty(M, K, dtype=F32, device=dev)
    if M and K:
        S, rows = split_plan(N, M, K, SLAB)
        ws = torch.empty(S, M, K, dtype=torch.int32, device=dev) \
            if S > 1 else None
        with torch.cuda.device(dev):
            err = getattr(_lib(), _ENTRY)(
                a_q.data_ptr(), g_q.data_ptr(), sa.data_ptr(), sg.data_ptr(),
                dw.data_ptr(), fish.data_ptr(),
                None if ws is None else ws.data_ptr(), N, M, K, rows, S,
                torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"gemm_fisher_int8 kernel launch failed: "
                               f"cudaError {err}")
        LAUNCHES += 1
    return dw, fish
