"""Dampening IP on Hopper — port of ``repro.kernels.dampen.dampen``,
``dampen_int8`` and ``dampen_int8_rowscale``.

The TPU kernels (``_dampen_kernel``, ``_dampen_int8_kernel``,
``_dampen_int8_rowscale_kernel``) are one fused elementwise pass of SSD
Eqs. (3)+(4): select ``i_f > alpha * i_g``,
``beta = min(lam * i_g / max(i_f, 1e-30), 1)``, multiply — on float
weights, or on int8 weight codes with ``round`` (half to even) and a clip
to ±127 (the ``precision="int8"`` path); the rowscale variant first
dequantises a quant-domain forget Fisher, ``i_f = i_fq * fs[row]``. Here
all three are ``csrc/dampen.cu``, CUDA C++ for ``sm_90a``, one shared
library with a plain C interface (``kernels/build.py``) bound with ctypes.
The float and int8 kernels also write the selection mask from the same
pass; the rowscale kernel returns the codes only, as the reference's
wrapper does. They are bound by device memory (17 bytes per element for
f32 theta, 13 for bf16, 11 for int8 codes, 10 for rowscale); the source
says what the design does about that.

Why CUDA C++ and not Triton: the kernel must agree with ``dampen_ref`` bit
for bit, and Triton lowers an f32 ``/`` to the approximate
``div.full.f32``; nvcc's divide is correctly rounded as long as the build
never uses ``--use_fast_math`` (``build.NVCC_FLAGS`` does not).

``LAUNCHES`` counts launches of the float kernel, ``INT8_LAUNCHES`` those
of the int8 one and ``ROWSCALE_LAUNCHES`` those of the rowscale one, and
nothing else, so a run shows which kernel an edit took.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.optim.compression import int8_codes

from . import build as _build

F32 = torch.float32

_ENTRY = {F32: "ficabu_dampen_f32", torch.bfloat16: "ficabu_dampen_bf16"}
_ENTRY_INT8 = "ficabu_dampen_int8"
_ENTRY_ROWSCALE = "ficabu_dampen_int8_rowscale"

LAUNCHES = 0           # float-kernel launches since the last reset
INT8_LAUNCHES = 0      # int8-kernel launches since the last reset
ROWSCALE_LAUNCHES = 0  # rowscale-kernel launches since the last reset
BUILD_LOG = ""  # nvcc's output (register use, spills) when this process built
_LIB: Optional[ctypes.CDLL] = None


def dampen_ref(theta: torch.Tensor, i_f: torch.Tensor, i_g: torch.Tensor,
               alpha: float, lam: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: Eqs. (3)+(4) in f32, output in theta's
    dtype, plus the selection mask. ``alpha``/``lam`` must already be
    rounded to f32 (``kernels.ops.dampen`` does it), so the product
    ``alpha * i_g`` is the correctly rounded f32 product either way."""
    sel, beta = _select_beta(i_f, i_g, alpha, lam)
    th32 = theta.to(F32)
    out = torch.where(sel, th32 * beta, th32)
    return out.to(theta.dtype), sel


def dampen_int8_ref(theta_q: torch.Tensor, i_f: torch.Tensor,
                    i_g: torch.Tensor, alpha: float, lam: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the int8 kernel: Eqs. (3)+(4) on int8
    weight codes, ``round`` half to even, clipped to ±127, NaN -> code 0
    (as XLA converts). Returns (codes', mask); ``alpha``/``lam`` as in
    ``dampen_ref``."""
    sel, beta = _select_beta(i_f, i_g, alpha, lam)
    th32 = theta_q.to(F32)
    return int8_codes(torch.where(sel, torch.round(th32 * beta), th32)), sel


def _select_beta(i_f, i_g, alpha, lam):
    i_f32 = i_f.to(F32)
    i_g32 = i_g.to(F32)
    sel = i_f32 > alpha * i_g32
    # clamp_min/clamp_max propagate NaN, as jnp.maximum/jnp.minimum do
    beta = (lam * i_g32 / i_f32.clamp_min(1e-30)).clamp_max(1.0)
    return sel, beta


def dampen_int8_rowscale_ref(theta_q: torch.Tensor, i_fq: torch.Tensor,
                             f_scale: torch.Tensor, i_g: torch.Tensor,
                             alpha: float, lam: float) -> torch.Tensor:
    """The plain PyTorch version of the rowscale kernel: the forget Fisher
    ``i_fq`` [R, C] (any real dtype, taken as f32) times its per-row f32
    scale ``f_scale`` [R], then the int8 rule of ``dampen_int8_ref``.
    Returns the codes only, as the reference's wrapper does."""
    i_f = i_fq.to(F32) * f_scale.to(F32)[:, None]
    return dampen_int8_ref(theta_q, i_f, i_g, alpha, lam)[0]


def build() -> Path:
    """Compile ``csrc/dampen.cu`` for sm_90a if this exact source and flag
    set has not been built yet; returns the shared library's path."""
    global BUILD_LOG
    so = _build.build("dampen")
    BUILD_LOG = _build.BUILD_LOG.get("dampen", BUILD_LOG)
    return so


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        build()
        lib = _build.load("dampen")
        for name in (*_ENTRY.values(), _ENTRY_INT8):
            _build.bind(lib, name, [ctypes.c_void_p] * 5 + [
                ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
                ctypes.c_void_p])
        _build.bind(lib, _ENTRY_ROWSCALE, [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float,
            ctypes.c_float, ctypes.c_void_p])
        _LIB = lib
    return _LIB


def dampen_cuda(theta: torch.Tensor, i_f: torch.Tensor, i_g: torch.Tensor,
                alpha: float, lam: float,
                out: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the float kernel on CUDA tensors of any shape; returns
    (theta', mask). ``out`` may be ``theta`` itself (an in-place edit).
    Launches on the current stream and does not synchronise."""
    global LAUNCHES
    if theta.dtype not in _ENTRY:
        raise ValueError(f"the dampen kernel takes f32 or bf16 theta, got "
                         f"{theta.dtype}")
    res = _launch(_ENTRY[theta.dtype], "dampen", theta, i_f, i_g, alpha,
                  lam, out)
    if theta.numel():
        LAUNCHES += 1
    return res


def dampen_int8_cuda(theta_q: torch.Tensor, i_f: torch.Tensor,
                     i_g: torch.Tensor, alpha: float, lam: float,
                     out: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the int8 kernel on CUDA tensors of any shape; returns
    (codes', mask). ``out`` may be ``theta_q`` itself (an in-place edit).
    Launches on the current stream and does not synchronise."""
    global INT8_LAUNCHES
    if theta_q.dtype != torch.int8:
        raise ValueError(f"the dampen_int8 kernel takes int8 codes, got "
                         f"{theta_q.dtype}")
    res = _launch(_ENTRY_INT8, "dampen_int8", theta_q, i_f, i_g, alpha, lam,
                  out)
    if theta_q.numel():
        INT8_LAUNCHES += 1
    return res


def _launch(entry: str, what: str, theta, i_f, i_g, alpha, lam, out):
    """Check the operands, allocate ``out`` (unless given) and the mask,
    and launch ``entry`` unless the tensors are empty."""
    dev = theta.device
    if dev.type != "cuda":
        raise ValueError(f"{what}_cuda takes CUDA tensors, got theta on {dev}")
    if out is None:
        out = torch.empty_like(theta, memory_format=torch.contiguous_format)
    for name, t, dt in (("i_f", i_f, F32), ("i_g", i_g, F32),
                        ("theta", theta, theta.dtype), ("out", out, theta.dtype)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous() \
                or t.shape != theta.shape:
            raise ValueError(
                f"{what} kernel operand {name} must be a contiguous {dt} "
                f"tensor of shape {tuple(theta.shape)} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    mask = torch.empty(theta.shape, dtype=torch.uint8, device=dev)
    n = theta.numel()
    if n:
        fn = getattr(_lib(), entry)
        with torch.cuda.device(dev):
            err = fn(theta.data_ptr(), i_f.data_ptr(), i_g.data_ptr(),
                     out.data_ptr(), mask.data_ptr(), n, alpha, lam,
                     torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")
    return out, mask.view(torch.bool)


def dampen_int8_rowscale_cuda(theta_q: torch.Tensor, i_fq: torch.Tensor,
                              f_scale: torch.Tensor, i_g: torch.Tensor,
                              alpha: float, lam: float) -> torch.Tensor:
    """Launch the rowscale kernel on contiguous CUDA tensors: theta_q
    [R, C] int8, i_fq [R, C] f32, f_scale [R] f32, i_g [R, C] f32; returns
    the codes [R, C] int8 in a new tensor. Launches on the current stream
    and does not synchronise."""
    global ROWSCALE_LAUNCHES
    dev = theta_q.device
    if dev.type != "cuda":
        raise ValueError(f"dampen_int8_rowscale_cuda takes CUDA tensors, got "
                         f"theta_q on {dev}")
    if theta_q.dtype != torch.int8 or theta_q.ndim != 2:
        raise ValueError(f"the dampen_int8_rowscale kernel takes [R, C] int8 "
                         f"codes, got {theta_q.dtype} {tuple(theta_q.shape)}")
    R, C = theta_q.shape
    for name, t, dt, shape in (
            ("theta_q", theta_q, torch.int8, (R, C)),
            ("i_fq", i_fq, F32, (R, C)), ("f_scale", f_scale, F32, (R,)),
            ("i_g", i_g, F32, (R, C))):
        if t.device != dev or t.dtype != dt or not t.is_contiguous() \
                or tuple(t.shape) != shape:
            raise ValueError(
                f"dampen_int8_rowscale kernel operand {name} must be a "
                f"contiguous {dt} tensor of shape {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    out = torch.empty_like(theta_q)
    if theta_q.numel():
        fn = getattr(_lib(), _ENTRY_ROWSCALE)
        with torch.cuda.device(dev):
            err = fn(theta_q.data_ptr(), i_fq.data_ptr(), f_scale.data_ptr(),
                     i_g.data_ptr(), out.data_ptr(), R * C, C, alpha, lam,
                     torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"dampen_int8_rowscale kernel launch failed: "
                               f"cudaError {err}")
        ROWSCALE_LAUNCHES += 1
    return out
