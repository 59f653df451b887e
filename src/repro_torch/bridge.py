"""Bridge between the JAX package's parameter trees and the port's.

The JAX package's trees arrive as nested dicts of numpy arrays (for
example ``jax.tree_util.tree_map(np.asarray, params)``); this module never
imports JAX. The keys are the same on both sides. The one layout change is
the conv weights: HWIO ([kh, kw, cin, cout]) in the reference, OIHW
([cout, cin, kh, kw]) in the port, so every 4-D leaf is transposed. Dense
weights keep the reference's [d_in, d_out] layout. The ViT has no 4-D
leaf: its 3-D ``patch/cls`` [1, 1, D] and ``patch/pos`` [1, T, D] cross
unchanged. Nor has the dense LM: its ``period_stack`` leaves are stacked
[n_periods, ...] norm scales (2-D) and dense weights (3-D,
[n_periods, d_in, d_out]), and they cross unchanged too. (An MoE expert
stack [n_periods, experts, d, f] would be 4-D: the rule must then go by
path, not by rank.)

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


def params_to_torch(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """A reference tree of numpy arrays -> the port's tree of tensors on
    ``device`` (raises without a card unless device="cpu")."""
    dev = resolve_device(device)

    def one(_path, x):
        a = np.asarray(x)
        if a.ndim == 4:
            a = a.transpose(_HWIO_TO_OIHW)
        return torch.tensor(a, device=dev)  # a contiguous copy

    return map_with_paths(one, tree)


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's tree of tensors -> the reference's layout, as numpy."""
    def one(_path, t):
        a = t.detach().cpu().numpy()
        return np.ascontiguousarray(a.transpose(_OIHW_TO_HWIO)) \
            if a.ndim == 4 else a

    return map_with_paths(one, tree)


def paths(tree) -> Dict[str, Any]:
    """{'a/b/c': leaf} — compare two trees leaf by leaf through this."""
    return dict(flatten_with_paths(tree))
