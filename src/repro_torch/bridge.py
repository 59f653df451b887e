"""Bridge between the JAX package's parameter trees and the port's.

The JAX package's trees arrive as nested dicts of numpy arrays (for
example ``jax.tree_util.tree_map(np.asarray, params)``); this module never
imports JAX. The keys are the same on both sides. The one layout change is
the conv weights: HWIO ([kh, kw, cin, cout]) in the reference, OIHW
([cout, cin, kh, kw]) in the port. ``is_conv_weight`` tells them by path,
and ``optim.compression`` groups its int8 scales by the same rule. Every
other leaf keeps the reference's layout: dense weights [d_in, d_out], the
ViT's 3-D ``patch/cls`` [1, 1, D] and ``patch/pos`` [1, T, D], and an LM's
``period_stack`` leaves, stacked [n_periods, ...] — among them the 4-D
stacks [n_periods, H, dh, dh] of the sLSTM's block-diagonal recurrent
weights.

Leaves are matched BY PATH ('blocks/0/conv1'): ``jax.tree_util`` sorts dict
keys while a dict built in code keeps insertion order, so positions in two
leaf lists are not a match.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.module import flatten_with_paths, map_with_paths

_HWIO_TO_OIHW = (3, 2, 0, 1)
_OIHW_TO_HWIO = (2, 3, 1, 0)


def is_conv_weight(path: str, ndim: int) -> bool:
    """Whether the leaf at ``path`` ('a/b/c') of ``ndim`` axes is a vision
    model's conv weight (HWIO in the reference, OIHW in the port). By path:
    a 4-D leaf is one unless it lies under an LM's ``period_stack``, whose
    4-D leaves are stacks of a block's 3-D leaves (the sLSTM's [H, dh, dh]
    recurrent weights). A layer's own subtree (the engine's view) holds no
    stacked leaf, so there a 4-D leaf is a conv weight too."""
    return ndim == 4 and "period_stack" not in path.split("/")


def params_to_torch(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """A reference tree of numpy arrays -> the port's tree of tensors on
    ``device`` (raises without a card unless device="cpu")."""
    dev = resolve_device(device)

    def one(path, x):
        a = np.asarray(x)
        if is_conv_weight(path, a.ndim):
            a = a.transpose(_HWIO_TO_OIHW)
        if a.dtype.name == "bfloat16":
            # numpy knows bf16 only through an extension type: cross as the
            # 16-bit pattern
            return torch.tensor(a.view(np.int16), device=dev).view(
                torch.bfloat16)
        return torch.tensor(a, device=dev)  # a contiguous copy

    return map_with_paths(one, tree)


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's tree of tensors -> the reference's layout, as numpy."""
    def one(path, t):
        a = t.detach().cpu().numpy()
        return np.ascontiguousarray(a.transpose(_OIHW_TO_HWIO)) \
            if is_conv_weight(path, a.ndim) else a

    return map_with_paths(one, tree)


def paths(tree) -> Dict[str, Any]:
    """{'a/b/c': leaf} — compare two trees leaf by leaf through this."""
    return dict(flatten_with_paths(tree))
