"""Quantisation and gradient compression (port of
``repro.optim.compression``).

Two concerns share this module because they share one rounding rule.

**Int8 weight calibration.** One calibration rule, symmetric max-abs
int8: ``scale = max|x| * f32(1/127)`` clamped to ``Q8_MIN_SCALE``, codes
``round(x / scale)`` (half to even) clipped to ±127. The engine's
``precision="int8"`` path (DESIGN.md §12) quantises parameter trees with
these helpers. ``INT8_SWEEP_RTOL`` is the declared tolerance of that path
against the fp32 path, per layer.

**The grouping is the reference's, not PyTorch's per-output-channel
habit.** The reference keeps the first ``lead_axes`` axes of each leaf in
ITS layout and maxes over the rest. Its conv weights are HWIO, so a 3×3
conv keeps the kernel-row axis and gets three scales; a dense [d_in, d_out]
weight gets one scale per input row; a 1-D leaf one scale per tensor; a
stacked sLSTM recurrent weight [n_periods, H, dh, dh] one per period
(``lead_axes=1``) or per period and head (2). The port keeps conv weights in
OIHW, so on a conv weight the reference's axes (H, W, I, O) are the port's
axes (2, 3, 1, 0), and those are the ones kept. The tree functions tell conv
weights by path (``repro_torch.bridge.is_conv_weight``); a bare tensor has
no path, and ``conv`` says what it is. Tables keep their reduced axes
(keepdims), so a reference conv table of shape (3, 1, 1, 1) is the port's
(1, 1, 3, 1) and the bridge's transpose maps one onto the other: tables
compare by path like weights.

**Gradient compression with error feedback** (the train launcher's
``--compress``): ``Int8Codec`` (per-block symmetric int8, block 256) and
``TopKCodec`` (magnitude top-k, k a fraction). ``apply(grads, ef)`` returns
what crosses the wire, decompressed (``sent``, in the gradient's dtype),
and the new residual ``ef`` (f32), with ``sent + ef == g + ef_prev`` up to
one rounding. Both walk each leaf in the REFERENCE layout (a conv weight
as HWIO), so blocks and top-k ties fall on the reference's elements.

``Int8Codec`` computes what the reference's JITTED train step computes,
which is not what its eager ``apply`` computes: inside the jit XLA turns
``max|x| / 127.0`` into ``max|x| * f32(1/127)`` (one ulp apart in about
half the blocks, which moves every code of the block and flips those at
the .5 marks) and fuses the residual ``tot - q * scale`` into one
multiply-add, rounded once. The port multiplies by the f32 reciprocal and
forms the residual in f64, where it is exact, then rounds it to f32 once.
``TopKCodec`` has no such difference. Its kept set is the first k indices
of a STABLE descending sort of ``|tot|``: at equal magnitudes the lower
index wins, as ``lax.top_k`` documents.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import _HWIO_TO_OIHW, _OIHW_TO_HWIO, is_conv_weight
from repro_torch.models.module import (flatten_with_paths, map_with_paths,
                                       tree_map, tree_unflatten)

F32 = torch.float32
Params = Any

# Scale-table clamp: an all-zero channel still gets a valid (positive) scale.
Q8_MIN_SCALE = 1e-12

# The declared tolerance of the int8 unlearning path: for every layer, the
# relative L2 error of the int8-swept parameters against the fp32-swept ones
# must satisfy  ||p8 - p32|| / ||p32|| <= INT8_SWEEP_RTOL.
INT8_SWEEP_RTOL = 0.10

# 1/127 rounded to f32 once: the reference multiplies by this constant
# rather than dividing by 127, and so does the port
_RECIP_127 = float(np.float32(1.0 / 127.0))

# a conv weight's reference axes (H, W, I, O), in the port's OIHW numbering
_HWIO_AXES = (2, 3, 1, 0)


def int8_codes(v: torch.Tensor) -> torch.Tensor:
    """Integer-valued f32 -> int8 codes, saturating at ±127, NaN -> 0.

    XLA's float -> int8 convert maps NaN to 0; a plain ``.to(torch.int8)``
    of NaN is undefined behaviour, so the NaN case is written out."""
    return torch.where(torch.isnan(v), 0.0, v.clamp(-127.0, 127.0)
                       ).to(torch.int8)


def q8_scales(x: torch.Tensor, *, lead_axes: int = 1,
              min_scale: float = Q8_MIN_SCALE,
              conv: Optional[bool] = None) -> torch.Tensor:
    """Symmetric int8 scale table for ``x``, grouped as the reference groups.

    |x| is maxed over every axis past the first ``min(lead_axes, ndim-1)``
    axes of the REFERENCE layout (keepdims, so the table broadcasts against
    ``x``), multiplied by f32(1/127) and clamped to ``min_scale``. NaN
    propagates, as ``jnp.max``/``jnp.maximum`` let it. ``conv`` says whether
    ``x`` is an OIHW conv weight; None takes a 4-D tensor for one (pass
    False for a stacked sLSTM recurrent weight)."""
    if not isinstance(lead_axes, int) or lead_axes < 0:
        raise ValueError(
            f"q8_scales lead_axes must be an int >= 0 (the number of "
            f"leading axes the scale table keeps), got {lead_axes!r}")
    keep = min(lead_axes, max(x.ndim - 1, 0))
    if conv is None:
        conv = x.ndim == 4
    kept = (_HWIO_AXES if conv else tuple(range(x.ndim)))[:keep]
    red = tuple(a for a in range(x.ndim) if a not in kept)
    ax = x.to(F32).abs()
    m = ax.amax(dim=red, keepdim=True) if red else ax
    return (m * _RECIP_127).clamp_min(float(np.float32(min_scale)))


def q8_quantize(x: torch.Tensor, *, lead_axes: int = 1,
                min_scale: float = Q8_MIN_SCALE,
                conv: Optional[bool] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes int8, scales f32): symmetric round-to-nearest-even onto the
    grid; zero maps to zero exactly. ``conv`` as in ``q8_scales``."""
    s = q8_scales(x, lead_axes=lead_axes, min_scale=min_scale, conv=conv)
    return int8_codes(torch.round(x.to(F32) / s)), s


def q8_dequantize(q: torch.Tensor, s: torch.Tensor,
                  dtype=F32) -> torch.Tensor:
    return (q.to(F32) * s).to(dtype)


def q8_fakequant(x: torch.Tensor, *, lead_axes: int = 1,
                 min_scale: float = Q8_MIN_SCALE,
                 conv: Optional[bool] = None) -> torch.Tensor:
    """Quantise -> dequantise round trip in ``x.dtype``: the weights the
    int8 deployment actually executes. ``conv`` as in ``q8_scales``."""
    q, s = q8_quantize(x, lead_axes=lead_axes, min_scale=min_scale,
                       conv=conv)
    return q8_dequantize(q, s, x.dtype)


def q8_quantize_tree(tree: Params, *, lead_axes: int = 1,
                     min_scale: float = Q8_MIN_SCALE
                     ) -> Tuple[Params, Params]:
    """Quantise every leaf, conv weights told by path; returns (codes tree,
    scale-table tree)."""
    pairs = [q8_quantize(x, lead_axes=lead_axes, min_scale=min_scale,
                         conv=is_conv_weight(path, x.ndim))
             for path, x in flatten_with_paths(tree)]
    return (tree_unflatten(tree, [p[0] for p in pairs]),
            tree_unflatten(tree, [p[1] for p in pairs]))


def q8_dequantize_tree(q_tree: Params, s_tree: Params,
                       like: Optional[Params] = None) -> Params:
    """Dequantise a (codes, scales) tree pair; ``like`` (a tree of tensors)
    restores per-leaf dtypes, else f32."""
    if like is None:
        return tree_map(q8_dequantize, q_tree, s_tree)
    return tree_map(lambda q, s, x: q8_dequantize(q, s, x.dtype),
                    q_tree, s_tree, like)


def q8_fakequant_tree(tree: Params, *, lead_axes: int = 1,
                      min_scale: float = Q8_MIN_SCALE) -> Params:
    return map_with_paths(
        lambda path, x: q8_fakequant(x, lead_axes=lead_axes,
                                     min_scale=min_scale,
                                     conv=is_conv_weight(path, x.ndim)),
        tree)


# ---------------------------------------------------------------------------
# Gradient compression with error feedback (the train launcher's codec)
# ---------------------------------------------------------------------------
def _ef_init(params_like: Params) -> Params:
    return tree_map(lambda x: torch.zeros(x.shape, dtype=F32,
                                          device=x.device), params_like)


def _apply_leafwise(one, grads: Params, ef: Params) -> Tuple[Params, Params]:
    """``one(tot)`` on each leaf's ``g.f32 + e`` in the reference layout
    (a conv weight as HWIO) -> (sent, residual), returned in the port's
    layout: (sent trees in the gradients' dtypes, f32 residual tree)."""
    efs = dict(flatten_with_paths(ef))
    sent, res = [], []
    for path, g in flatten_with_paths(grads):
        tot = g.to(F32) + efs[path]
        conv = is_conv_weight(path, tot.ndim)
        s, r = one(tot.permute(_OIHW_TO_HWIO) if conv else tot)
        if conv:
            s, r = s.permute(_HWIO_TO_OIHW), r.permute(_HWIO_TO_OIHW)
        sent.append(s.contiguous().to(g.dtype))
        res.append(r.contiguous())
    return tree_unflatten(grads, sent), tree_unflatten(grads, res)


@dataclasses.dataclass(frozen=True)
class Int8Codec:
    block: int = 256

    def init_state(self, params_like: Params) -> Params:
        return _ef_init(params_like)

    def _blocks(self, g: torch.Tensor):
        """(blocks [nb, block] f32 zero-padded, scales [nb, 1], codes)."""
        flat = g.to(F32).reshape(-1)
        pad = (-flat.numel()) % self.block
        flat = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, self.block)
        scale = (flat.abs().amax(dim=1, keepdim=True) * _RECIP_127
                 ).clamp_min(float(np.float32(1e-12)))
        return flat, scale, int8_codes(torch.round(flat / scale))

    def _roundtrip(self, g: torch.Tensor) -> torch.Tensor:
        """Quantise -> dequantise ``g`` (f32 out), blocks taken in ``g``'s
        own element order."""
        return self._split(g)[0]

    def _split(self, tot: torch.Tensor):
        """(dequantised ``tot``, residual ``tot - dequantised``)."""
        flat, scale, q = self._blocks(tot)
        n = tot.numel()
        sent = (q.to(F32) * scale).reshape(-1)[:n].reshape(tot.shape)
        # tot - q * scale rounded once, as the jitted reference's fused
        # multiply-add: exact in f64 (q has 8 bits, scale 24)
        res = (flat.double() - q.double() * scale.double()).to(F32)
        return sent, res.reshape(-1)[:n].reshape(tot.shape)

    def apply(self, grads: Params, ef: Params) -> Tuple[Params, Params]:
        return _apply_leafwise(self._split, grads, ef)

    def wire_bytes(self, n_elements: int) -> int:
        n_blocks = -(-n_elements // self.block)
        return n_elements + 4 * n_blocks     # int8 payload + f32 scales


@dataclasses.dataclass(frozen=True)
class TopKCodec:
    frac: float = 0.01

    def init_state(self, params_like: Params) -> Params:
        return _ef_init(params_like)

    def _split(self, tot: torch.Tensor):
        flat = tot.reshape(-1)
        k = max(1, int(flat.numel() * self.frac))
        # a stable descending sort: ties to the lower index, as lax.top_k
        idx = torch.sort(flat.abs(), descending=True, stable=True)[1][:k]
        kept = torch.zeros_like(flat)
        kept[idx] = flat[idx]
        kept = kept.reshape(tot.shape)
        return kept, tot - kept

    def apply(self, grads: Params, ef: Params) -> Tuple[Params, Params]:
        return _apply_leafwise(self._split, grads, ef)

    def wire_bytes(self, n_elements: int) -> int:
        k = max(1, int(n_elements * self.frac))
        return k * (4 + 4)                    # f32 value + int32 index
