"""Public wrappers around the Hopper kernels: any shape in, the device
decides the path. Port of ``repro.kernels.ops``, with the reference's
signatures, returned shapes and dtypes, and ValueError checks.

A tensor on the CPU goes to the kernel's plain PyTorch version; a tensor on
the card goes to the kernel, or the wrapper raises — there is no fallback.
No TPU (8, 1024) padding: every CUDA kernel masks its own ragged edges.

The dampen wrappers also take DTensors (``repro_torch.dist``): a DTensor
theta goes through the same kernel on its local shard, each Fisher operand
cut to the same shard (a DTensor with theta's placements, or a whole
tensor), and the results come back as DTensors with theta's placements.
The rule is elementwise, so a shard's result is the matching slice of the
whole one; ``dampen_int8_rowscale``'s per-row scale table is cut with the
rows. A group's count is over the whole leaves, each element once.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.dist import execute as _dx

from . import dampen as _dampen
from . import fimd as _fimd
from . import gemm_fisher as _gf
from . import gemm_fisher_int8 as _gf8
from .dampen import check_elementwise as _check_elementwise

F32 = torch.float32


def _path(name: str, t: torch.Tensor) -> str:
    """'cpu' (the plain version) or 'cuda' (the kernel), by the device of
    the wrapper's first operand; anything else raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on 'cpu' (plain version) or 'cuda' "
                         f"(the kernel), got a tensor on {t.device}")
    return t.device.type


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
    if _dx.is_dtensor(theta):
        return _dx.local_call(dampen, theta, i_f, i_g, alpha, lam,
                              out=_local_out(out, theta))
    _check_elementwise("dampen", theta, i_f, i_g)
    alpha, lam = f32(alpha), f32(lam)
    if _path("dampen", theta) == "cpu":
        new, mask = _dampen.dampen_ref(theta, i_f, i_g, alpha, lam)
        if out is not None:
            new = out.copy_(new)
        return new, mask
    # (the wrapper converts what the kernel cannot take as it is)
    return _dampen.dampen_cuda(theta, i_f, i_g, alpha, lam, out=out)


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
    if _dx.is_dtensor(theta_q):
        return _dx.local_call(dampen_int8, theta_q, i_f, i_g, alpha, lam,
                              out=_local_out(out, theta_q))
    _dampen.check_int8_codes(theta_q)
    _check_elementwise("dampen_int8", theta_q, i_f, i_g)
    alpha, lam = f32(alpha), f32(lam)
    if _path("dampen_int8", theta_q) == "cpu":
        new, mask = _dampen.dampen_int8_ref(theta_q, i_f, i_g, alpha, lam)
        if out is not None:
            new = out.copy_(new)
        return new, mask
    return _dampen.dampen_int8_cuda(theta_q, i_f, i_g, alpha, lam, out=out)


def dampen_group(thetas: Sequence[torch.Tensor],
                 i_fs: Sequence[torch.Tensor], i_gs: Sequence[torch.Tensor],
                 alpha, lam, *, outs: Optional[Sequence[torch.Tensor]] = None
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                            torch.Tensor]:
    """``dampen`` over a table of leaves (a layer, or a tree), in one kernel
    launch per 64 leaves on the card; theta f32 or bf16, one dtype for the
    table. Returns (thetas', masks, count): per leaf what ``dampen``
    returns, and the number of selected elements over all leaves as an
    int64 scalar on the leaves' device, from the kernel's own pass.
    ``outs[i]`` receives theta'[i] (pass ``thetas`` for an in-place edit).
    Every operand lies on the first theta's device."""
    return _group("dampen", _dampen.dampen_group_ref,
                  _dampen.dampen_group_cuda, thetas, i_fs, i_gs, alpha, lam,
                  outs)


def dampen_int8_group(thetas_q: Sequence[torch.Tensor],
                      i_fs: Sequence[torch.Tensor],
                      i_gs: Sequence[torch.Tensor], alpha, lam, *,
                      outs: Optional[Sequence[torch.Tensor]] = None
                      ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                                 torch.Tensor]:
    """``dampen_int8`` over a table of leaves of int8 codes, in one kernel
    launch per 64 leaves on the card. Returns (codes', masks, count) as
    ``dampen_group`` does."""
    return _group("dampen_int8", _dampen.dampen_int8_group_ref,
                  _dampen.dampen_int8_group_cuda, thetas_q, i_fs, i_gs,
                  alpha, lam, outs)


def _local_out(out, theta):
    return None if out is None else _dx.local_of(out, theta)


def _group_dtensor(name, plain_fn, cuda_fn, thetas, i_fs, i_gs, alpha, lam,
                   outs):
    """``_group`` on DTensor thetas: one table of the local shards, the
    results rewrapped, the count summed over the mesh."""
    if not all(_dx.is_dtensor(t) for t in thetas):
        raise ValueError(f"{name}_group takes a table of DTensors or of "
                         f"tensors, not both")
    dm = thetas[0].device_mesh
    if any(t.device_mesh != dm for t in thetas):
        raise ValueError(f"{name}_group takes one mesh per table")
    loc = [t.to_local() for t in thetas]
    new, masks, count = _group(
        name, plain_fn, cuda_fn, loc,
        [_dx.local_of(f, t) for f, t in zip(i_fs, thetas)],
        [_dx.local_of(g, t) for g, t in zip(i_gs, thetas)], alpha, lam,
        None if outs is None else [_dx.local_of(o, t)
                                   for o, t in zip(outs, thetas)])
    pls = [tuple(t.placements) for t in thetas]
    count = _dx.selection_count(masks, pls, dm, local_count=count)
    return ([_dx.wrap(n, dm, pl, t) for n, pl, t in zip(new, pls, thetas)],
            [_dx.wrap(m, dm, pl, t) for m, pl, t in zip(masks, pls, thetas)],
            count)


def _group(name, plain_fn, cuda_fn, thetas, i_fs, i_gs, alpha, lam, outs):
    """The path by the first theta's device. On the card the kernel's
    wrapper checks each leaf, once (the host's time per leaf is the
    sweep's bound); on the CPU the same checks run here, and every operand
    must lie on the CPU too, so that no card tensor takes the plain
    version."""
    if len(thetas) and _dx.is_dtensor(thetas[0]):
        return _group_dtensor(name, plain_fn, cuda_fn, thetas, i_fs, i_gs,
                              alpha, lam, outs)
    alpha, lam = f32(alpha), f32(lam)
    if len(thetas) and _path(name, thetas[0]) == "cuda":
        return cuda_fn(thetas, i_fs, i_gs, alpha, lam, outs=outs)
    _dampen.check_lengths(f"{name}_group", thetas, i_fs, i_gs, outs)
    for i, (theta, i_f, i_g) in enumerate(zip(thetas, i_fs, i_gs)):
        if name == "dampen_int8":
            _dampen.check_int8_codes(theta)
        _check_elementwise(name, theta, i_f, i_g)
        for t in (theta, i_f, i_g, *(() if outs is None else (outs[i],))):
            if t.device.type != "cpu":
                raise ValueError(
                    f"{name}_group takes every operand on the first theta's "
                    f"device, cpu, got leaf {i} with a tensor on {t.device}")
    new, masks, count = plain_fn(thetas, i_fs, i_gs, alpha, lam)
    if outs is not None:
        new = [o.copy_(n) for o, n in zip(outs, new)]
    return new, masks, count


def fimd(g: torch.Tensor) -> torch.Tensor:
    """Sum of squared gradients over axis 0 via the FIMD kernel.
    g: [B, ...] (f32 or bf16; other float types are taken as f32) ->
    [...] f32."""
    B, shape = g.shape[0], g.shape[1:]
    flat = g.reshape(B, -1)
    if _path("fimd", g) == "cpu":
        return _fimd.fimd_ref(flat).reshape(shape)
    if flat.dtype not in (F32, torch.bfloat16):
        flat = flat.to(F32)
    return _fimd.fimd_cuda(flat.contiguous()).reshape(shape)


def dampen_int8_rowscale(theta_q: torch.Tensor, i_fq: torch.Tensor,
                         f_scale: torch.Tensor, i_g: torch.Tensor,
                         alpha, lam) -> torch.Tensor:
    """Dequant-free dampening with a quant-domain forget-Fisher: ``i_fq``
    [R, C] plus its per-row f32 scale table ``f_scale`` [R] are dequantised
    in-register inside the kernel (``i_f = f32(i_fq) * f_scale[r]``, one
    correctly rounded product). theta_q: [R, C] int8 -> [R, C] int8, the
    codes only, as the reference returns them."""
    if _dx.is_dtensor(theta_q):
        from torch.distributed.tensor import Replicate, Shard
        # the scale table follows the rows: cut it where theta's dim 0 is
        rows = tuple(Shard(0) if p == Shard(0) else Replicate()
                     for p in theta_q.placements)
        dm = theta_q.device_mesh
        out = dampen_int8_rowscale(
            theta_q.to_local(), _dx.local_of(i_fq, theta_q),
            _dx.local_slice(_dx.gather(f_scale), dm, rows),
            _dx.local_of(i_g, theta_q), alpha, lam)
        return _dx.wrap(out, dm, theta_q.placements, theta_q)
    if theta_q.ndim != 2:
        raise ValueError(
            f"dampen_int8_rowscale takes a [R, C] per-channel weight (rows "
            f"are output channels), got shape {tuple(theta_q.shape)}")
    if theta_q.dtype != torch.int8:
        raise ValueError(
            f"dampen_int8_rowscale edits int8 weight codes in place, got "
            f"theta_q dtype {theta_q.dtype}")
    R, C = theta_q.shape
    _check_elementwise("dampen_int8_rowscale", theta_q, i_fq, i_g)
    if tuple(f_scale.shape) != (R,):
        raise ValueError(
            f"dampen_int8_rowscale f_scale is the per-row Fisher scale "
            f"table [R]={R,}, got {tuple(f_scale.shape)}")
    alpha, lam = f32(alpha), f32(lam)
    if _path("dampen_int8_rowscale", theta_q) == "cpu":
        return _dampen.dampen_int8_rowscale_ref(theta_q, i_fq, f_scale, i_g,
                                                alpha, lam)
    return _dampen.dampen_int8_rowscale_cuda(
        theta_q.contiguous(), i_fq.to(F32).contiguous(),
        f_scale.to(F32).contiguous(), i_g.to(F32).contiguous(), alpha, lam)


def gemm_fisher(a: torch.Tensor, g: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dW = a^T @ g and dW^2, fused. a: [N, M], g: [N, K] (f32 or bf16;
    mixed or other float types are taken as f32) -> (dw, fish) [M, K]
    f32."""
    if a.ndim != 2 or g.ndim != 2 or a.shape[0] != g.shape[0]:
        raise ValueError(
            f"gemm_fisher contracts [N, M] against [N, K] over a shared "
            f"reduction dim, got a={tuple(a.shape)}, g={tuple(g.shape)}")
    if _path("gemm_fisher", a) == "cpu":
        return _gf.gemm_fisher_ref(a, g)
    if a.dtype != g.dtype or a.dtype not in (F32, torch.bfloat16):
        a, g = a.to(F32), g.to(F32)
    return _gf.gemm_fisher_cuda(a.contiguous(), g.contiguous())


def gemm_fisher_int8(a_q: torch.Tensor, g_q: torch.Tensor,
                     sa: torch.Tensor, sg: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """INT8 dW = a_q^T @ g_q (exact int32 accumulate) rescaled per channel
    in the epilogue, plus dW^2. a_q: [N, M] int8, g_q: [N, K] int8,
    sa: [M] f32, sg: [K] f32 -> (dw, fish) [M, K] f32."""
    if a_q.ndim != 2 or g_q.ndim != 2 or a_q.shape[0] != g_q.shape[0]:
        raise ValueError(
            f"gemm_fisher_int8 contracts [N, M] against [N, K] over a "
            f"shared reduction dim, got a_q={tuple(a_q.shape)}, "
            f"g_q={tuple(g_q.shape)}")
    if a_q.dtype != torch.int8 or g_q.dtype != torch.int8:
        raise ValueError(
            f"gemm_fisher_int8 takes int8 operands (quantize with "
            f"optim.compression.q8_quantize first), got a_q={a_q.dtype}, "
            f"g_q={g_q.dtype}")
    M, K = a_q.shape[1], g_q.shape[1]
    if tuple(sa.shape) != (M,) or tuple(sg.shape) != (K,):
        raise ValueError(
            f"gemm_fisher_int8 scale tables must be 1-D per-channel vectors "
            f"sa [M]={M,} and sg [K]={K,}, got sa={tuple(sa.shape)}, "
            f"sg={tuple(sg.shape)}")
    if _path("gemm_fisher_int8", a_q) == "cpu":
        return _gf8.gemm_fisher_int8_ref(a_q, g_q, sa, sg)
    return _gf8.gemm_fisher_int8_cuda(
        a_q.contiguous(), g_q.contiguous(), sa.to(F32).contiguous(),
        sg.to(F32).contiguous())
