"""Int8 weight calibration — port of the q8 half of
``repro.optim.compression``.

One calibration rule, symmetric max-abs int8: ``scale = max|x| * f32(1/127)``
clamped to ``Q8_MIN_SCALE``, codes ``round(x / scale)`` (half to even)
clipped to ±127. The engine's ``precision="int8"`` path (DESIGN.md §12)
quantises parameter trees with these helpers. ``INT8_SWEEP_RTOL`` is the
declared tolerance of that path against the fp32 path, per layer.

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

``Int8Codec``/``TopKCodec`` (gradient compression for data-parallel
training) come with the training slice.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import is_conv_weight
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
