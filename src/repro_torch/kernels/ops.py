"""Public wrappers around the Hopper kernels: any shape in, the device
decides the path.

A tensor on the CPU goes to the kernel's plain PyTorch version; a tensor on
the card goes to the kernel, or the wrapper raises — there is no fallback.
No TPU (8, 1024) padding: the CUDA kernel takes a flat array of any length.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import dampen as _dampen


def _check_elementwise(name, theta, i_f, i_g):
    if i_f.shape != theta.shape or i_g.shape != theta.shape:
        raise ValueError(
            f"{name} is elementwise: Fisher operands must match theta's "
            f"shape {tuple(theta.shape)}, got i_f={tuple(i_f.shape)}, "
            f"i_g={tuple(i_g.shape)}")


def f32(x: float) -> float:
    """Round a Python number to the nearest f32, once (the reference forms
    ``alpha * S(l)`` as a double and rounds it to f32 when it builds the
    kernel's scalar block)."""
    return float(np.float32(x))


def dampen(theta: torch.Tensor, i_f: torch.Tensor, i_g: torch.Tensor,
           alpha, lam, *, out: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD Eq. (3)+(4) via the fused dampening kernel. Any shape; theta f32
    or bf16. Returns (theta', selected_mask) matching core.ssd.dampen_array.
    ``out`` receives theta' (pass ``theta`` itself for an in-place edit)."""
    _check_elementwise("dampen", theta, i_f, i_g)
    alpha, lam = f32(alpha), f32(lam)
    if theta.device.type == "cpu":
        new, mask = _dampen.dampen_ref(theta, i_f, i_g, alpha, lam)
        if out is not None:
            new = out.copy_(new)
        return new, mask
    if theta.device.type == "cuda":
        return _dampen.dampen_cuda(theta.contiguous(),
                                   i_f.to(torch.float32).contiguous(),
                                   i_g.to(torch.float32).contiguous(),
                                   alpha, lam, out=out)
    raise ValueError(f"dampen runs on 'cpu' (plain version) or 'cuda' (the "
                     f"kernel), got a tensor on {theta.device}")


def dampen_int8(theta_q: torch.Tensor, i_f: torch.Tensor, i_g: torch.Tensor,
                alpha, lam, *, out: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD Eq. (3)+(4) on int8 weight codes via the int8 dampening kernel
    (dequant-free: ``round(theta_q * beta)`` stays on the same grid). Any
    shape. Returns (codes', selected_mask) matching
    ``core.ssd.dampen_q8_array`` — the mask comes from the kernel's own
    pass, where the reference's wrapper returns codes only and
    ``dampen_q8_tree`` recomputes the mask. ``out`` receives the codes
    (pass ``theta_q`` itself for an in-place edit)."""
    if theta_q.dtype != torch.int8:
        raise ValueError(
            f"dampen_int8 edits int8 weight codes in place (use dampen for "
            f"float weights), got theta_q dtype {theta_q.dtype}")
    _check_elementwise("dampen_int8", theta_q, i_f, i_g)
    alpha, lam = f32(alpha), f32(lam)
    if theta_q.device.type == "cpu":
        new, mask = _dampen.dampen_int8_ref(theta_q, i_f, i_g, alpha, lam)
        if out is not None:
            new = out.copy_(new)
        return new, mask
    if theta_q.device.type == "cuda":
        return _dampen.dampen_int8_cuda(theta_q.contiguous(),
                                        i_f.to(torch.float32).contiguous(),
                                        i_g.to(torch.float32).contiguous(),
                                        alpha, lam, out=out)
    raise ValueError(f"dampen_int8 runs on 'cpu' (plain version) or 'cuda' "
                     f"(the kernel), got a tensor on {theta_q.device}")
