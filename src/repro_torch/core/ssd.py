"""Selective Synaptic Dampening (SSD) — the retraining-free baseline FiCABU
builds on (Foster et al., AAAI'24), Eqs. (3)-(4):

    select:  I_Df,i > alpha * I_D,i
    dampen:  theta_i <- beta * theta_i,  beta = min(lambda * I_D,i / I_Df,i, 1)

``dampen_tree`` is the one-shot edit over a whole parameter tree;
``dampen_array`` is the per-tensor primitive that the hand-written kernel
(``repro_torch.kernels.dampen``) implements for the card, one launch over
all the tree's leaves. ``dampen_q8_tree`` and ``dampen_q8_array`` are the
same edit on int8 weight codes, the ``precision="int8"`` path, with its own
kernel. ``dampen_tree_counted`` is either of them plus the kernel's count of
selected elements, for the fused step.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.dist import execute as _dx
from repro_torch.kernels import ops as kops
from repro_torch.kernels.dampen import dampen_int8_ref, dampen_ref
from repro_torch.models.module import tree_leaves, tree_unflatten

from .fisher import diag_fisher

Params = Any


def dampen_array(theta: torch.Tensor, i_f: torch.Tensor, i_g: torch.Tensor,
                 alpha: float, lam: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eqs. (3)+(4) on one tensor in plain PyTorch, on any device.
    Returns (new_theta, selected_mask)."""
    if _dx.is_dtensor(theta):
        return _dx.local_call(dampen_array, theta, i_f, i_g, alpha, lam)
    return dampen_ref(theta, i_f, i_g, kops.f32(alpha), kops.f32(lam))


def dampen_tree(params: Params, fisher_f: Params, fisher_g: Params,
                alpha: float, lam: float, use_kernel: bool = False, *,
                in_place: bool = False) -> Tuple[Params, Params]:
    """Apply SSD dampening to every leaf (leaves matched by key). Returns
    (params', selection masks). ``use_kernel`` dampens all leaves in one
    ``kernels.ops.dampen_group`` call (one CUDA launch for tensors on the
    card); ``in_place`` writes theta' into the caller's tensors."""
    return dampen_tree_counted("fp32", params, fisher_f, fisher_g, alpha,
                               lam, use_kernel, in_place=in_place)[:2]


def dampen_q8_array(theta_q: torch.Tensor, i_f: torch.Tensor,
                    i_g: torch.Tensor, alpha: float, lam: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eqs. (3)+(4) applied directly to int8 weight CODES, in plain
    PyTorch (dequant-free: beta <= 1, so theta_q' = round(beta * theta_q)
    stays on the same grid and the scale table remains valid). Returns
    (new_q, selected_mask)."""
    if _dx.is_dtensor(theta_q):
        return _dx.local_call(dampen_q8_array, theta_q, i_f, i_g, alpha, lam)
    return dampen_int8_ref(theta_q, i_f, i_g, kops.f32(alpha), kops.f32(lam))


def dampen_q8_tree(q_params: Params, fisher_f: Params, fisher_g: Params,
                   alpha: float, lam: float, use_kernel: bool = False, *,
                   in_place: bool = False) -> Tuple[Params, Params]:
    """SSD dampening over a tree of int8 weight codes (the engine's
    precision="int8" edit representation). Returns (codes', masks).
    ``use_kernel`` dampens all leaves in one ``kernels.ops.dampen_int8_group``
    call; ``in_place`` writes the codes into the given tensors."""
    return dampen_tree_counted("int8", q_params, fisher_f, fisher_g, alpha,
                               lam, use_kernel, in_place=in_place)[:2]


# per precision: the name in errors, the kernel over a table of leaves, and
# the plain per-leaf version
_EDITS = {"fp32": ("dampen_tree", kops.dampen_group, dampen_array),
          "int8": ("dampen_q8_tree", kops.dampen_int8_group, dampen_q8_array)}


def dampen_tree_counted(precision: str, params: Params, fisher_f: Params,
                        fisher_g: Params, alpha: float, lam: float,
                        use_kernel: bool = False, *, in_place: bool = False,
                        specs: Optional[List] = None
                        ) -> Tuple[Params, Params, Optional[torch.Tensor]]:
    """``dampen_tree`` (precision "fp32") or ``dampen_q8_tree`` ("int8"),
    plus the number of selected elements: (params', masks, n_selected).
    With ``use_kernel`` the leaves go through the group kernel, one call per
    dtype among them (the kernel takes one dtype per table: a bf16 layer's
    f32 leaf, the RG-LRU's ``log_lambda``, goes in a call of its own), and
    ``n_selected`` is the sum of their int64 counts from the same passes;
    the plain path dampens leaf by leaf and returns ``n_selected`` None (sum
    the masks). Either way the leaves come back in the tree's order.

    Inside a sharded request (``repro_torch.dist.execute``) each rank
    dampens its shards of the leaves — laid out by ``specs`` (one spec per
    leaf, tree order) or by the parameter rule on this subtree — and the
    whole edited leaves, the masks as DTensors and the count over the mesh
    come back."""
    run = _dx.current()
    if run is not None:
        return run.dampen_tree(dampen_tree_counted, precision, params,
                               fisher_f, fisher_g, alpha, lam, use_kernel,
                               in_place=in_place, specs=specs)
    name, group_fn, plain_fn = _EDITS[precision]
    flat_p = tree_leaves(params)
    flat_f = tree_leaves(fisher_f)
    flat_g = tree_leaves(fisher_g)
    if not len(flat_p) == len(flat_f) == len(flat_g):
        raise ValueError(
            f"{name} needs Fisher trees shaped like the parameters, got "
            f"{len(flat_p)} parameter leaves, {len(flat_f)} forget-Fisher "
            f"and {len(flat_g)} global-Fisher leaves")
    if use_kernel:
        new, masks = [None] * len(flat_p), [None] * len(flat_p)
        count = None
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, t in enumerate(flat_p):
            by_dtype.setdefault(t.dtype, []).append(i)
        for idx in list(by_dtype.values()) or [[]]:
            part = [flat_p[i] for i in idx]
            got_p, got_m, n = group_fn(part, [flat_f[i] for i in idx],
                                       [flat_g[i] for i in idx], alpha, lam,
                                       outs=part if in_place else None)
            for i, t, m in zip(idx, got_p, got_m):
                new[i], masks[i] = t, m
            count = n if count is None else count + n
    else:
        outs = [plain_fn(t, f, g, alpha, lam)
                for t, f, g in zip(flat_p, flat_f, flat_g)]
        new = [t.copy_(o[0]) if in_place else o[0]
               for t, o in zip(flat_p, outs)]
        masks = [o[1] for o in outs]
        count = None
    return (tree_unflatten(params, new), tree_unflatten(params, masks),
            count)


def selection_fraction(masks: Params) -> float:
    flat = tree_leaves(masks)
    tot = sum(m.numel() for m in flat)
    sel = sum(int(m.sum()) for m in flat)
    return sel / max(tot, 1)


def ssd_unlearn(loss_fn: Callable, params: Params, forget_batch: Any,
                fisher_global: Params, alpha: float, lam: float,
                chunk_size: int = 8, use_kernel: bool = False, *,
                device="cuda") -> Tuple[Params, Dict]:
    """Vanilla SSD: one Fisher pass on the forget batch + one-shot dampening
    of ALL parameters (no early stop, layer-agnostic hyperparameters)."""
    fisher_f = diag_fisher(loss_fn, params, forget_batch, chunk_size,
                           device=device)
    new, masks = dampen_tree(params, fisher_f, fisher_global, alpha, lam,
                             use_kernel=use_kernel)
    stats = {"selected_fraction": selection_fraction(masks)}
    return new, stats
