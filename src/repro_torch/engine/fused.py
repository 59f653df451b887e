"""Fused per-layer unlearning step — one cached step per layer shape.

Port of ``repro.engine.fused``. The reference lowers the whole per-layer
step as ONE jitted XLA program; PyTorch runs eagerly, so here a "program"
is the step closure ``build_fused_step`` returns, cached by the engine
under the same key (``repro_torch.engine.programs``). Per layer it runs:

  * the per-chunk vjp on the layer's original weights (``torch.autograd``),
  * the Fisher square-accumulate over chunks (f32),
  * SSD/Balanced dampening, through the hand-written CUDA kernel
    (``repro_torch.kernels.dampen``) when ``use_kernel`` is set — on float
    weights, or on int8 weight codes for ``precision="int8"`` — in one
    launch over the layer's leaves, which also counts the selection.

(alpha, lambda) arrive as f32-rounded Python floats, per call, so Balanced
Dampening's per-layer S(l)-scaled values never rebuild a step. The
split-edit variant (vjp reference apart from the edit target) is the int8
step's signature and, in fp32, the coalesced ``forget_many``'s.

``TRACE_LOG`` is the reference's retrace log: where the reference appends
a tag each time a program body is TRACED, the port appends the same tag
each time a builder runs (a step, a checkpoint runner, the fake-quant
entry step or a scanned sweep program), so tests pin "no warm rebuild" on
the same list.
"""
from __future__ import annotations

from typing import Any, Callable, Hashable, List, Optional, Tuple

import torch

from repro_torch.core.cau import _restore_excluded
from repro_torch.core.ssd import dampen_tree_counted
from repro_torch.dist.execute import reduce_fisher_
from repro_torch.models.module import tree_leaves, tree_map, tree_unflatten

F32 = torch.float32
Params = Any

# Appended (a tag string) every time a step, runner or sweep program is
# BUILT; tests count entries here to prove the step cache removes rebuilds.
TRACE_LOG: List[str] = []


def _note_trace(tag: str) -> None:
    TRACE_LOG.append(tag)


def shape_signature(tree: Params) -> Hashable:
    """Hashable (structure, leaf shapes/dtypes) key for a tree of tensors.
    Dict keys are taken in sorted order, so two trees with equal keys and
    leaves have equal signatures whatever order their dicts were built in."""
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, shape_signature(tree[k]))
                                 for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple(shape_signature(v)
                                              for v in tree)
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))
    return repr(tree)


def grad_fisher_chunks(apply_fn: Callable[[Params, torch.Tensor],
                                          torch.Tensor],
                       layer_p: Params, acts_c: torch.Tensor,
                       cot_c: torch.Tensor, *, with_act_grad: bool = True
                       ) -> Tuple[Params, Optional[torch.Tensor]]:
    """The per-layer vjp + Fisher square-accumulate over chunked
    activations/cotangents [nc, cs, ...], one chunk after another.

    ``apply_fn(layer_p, act) -> out`` is the layer forward with any context
    already bound. Returns ``(fisher_layer, act_cotangents)``: the Fisher is
    the sum over chunks of squared gradients, accumulated in chunk order,
    divided by nc (with nc == 1 the square itself, as the reference's
    straight-line path); ``act_cotangents`` is [nc, cs, ...], or None when
    ``with_act_grad`` is False. In a sharded request whose batch is split
    over ranks, the chunks are this rank's: the sums are all-reduced over
    the batch ranks and divided by the global chunk count.
    """
    nc = acts_c.shape[0]
    fish = None
    g_acts = torch.empty_like(acts_c) if with_act_grad else None
    with torch.enable_grad():
        for i in range(nc):
            lp = tree_map(lambda t: t.detach().requires_grad_(True), layer_p)
            leaves = tree_leaves(lp)
            a = acts_c[i].detach().requires_grad_(with_act_grad)
            inputs = leaves + [a] if with_act_grad else leaves
            grads = torch.autograd.grad(apply_fn(lp, a), inputs,
                                        grad_outputs=cot_c[i])
            if with_act_grad:
                g_acts[i] = grads[-1]
                grads = grads[:-1]
            if fish is None:
                fish = [g.to(F32) * g.to(F32) for g in grads]
            else:
                for f, g in zip(fish, grads):
                    f.addcmul_(g.to(F32), g.to(F32))
    nc = reduce_fisher_(fish, nc)
    if nc > 1:
        fish = [f.div_(nc) for f in fish]
    return tree_unflatten(layer_p, fish), g_acts


def build_fused_step(apply_fn: Callable[[Params, Params, torch.Tensor],
                                        torch.Tensor],
                     *,
                     with_act_grad: bool = True,
                     use_kernel: bool = False,
                     exclude: Optional[Callable[[str], bool]] = None,
                     donate: bool = False,
                     split_edit: bool = False,
                     precision: str = "fp32",
                     tag: str = "fused"):
    """Build the fused per-layer step.

    ``apply_fn(ctx, layer_p, act) -> out`` is the layer forward; ``ctx`` is
    whatever context the adapter needs beyond the layer's own params (None
    for self-contained layers). Returns

        step(ctx, layer_p, fisher_g, acts_c, cot_c, scalars)
            -> (new_layer, act_cotangents, n_selected)

    where ``acts_c``/``cot_c`` are chunked [nc, cs, ...] activations and
    upstream cotangents, ``scalars = (alpha, lam)`` (f32-rounded floats),
    and ``layer_p`` serves as vjp reference AND edit target (the sweep
    touches each layer once per request, so its current params still equal
    the originals). ``n_selected`` is a device scalar.

    ``split_edit=True`` builds the split signature

        step(ctx, ref_layer, edit_layer, fisher_g, acts_c, cot_c, scalars)
            -> (new_edit_layer, act_cotangents, n_selected)

    where the vjp/Fisher run on ``ref_layer`` and dampening edits
    ``edit_layer`` (select and beta depend only on the Fisher pair).

    ``precision="int8"`` always takes the split signature: the vjp/Fisher
    run on ``ref_layer``, the fake-quantised reference weights (the weights
    the int8 deployment executes), MATERIALISED by the caller; the edit runs
    dequant-free on the int8 codes ``edit_layer`` via ``dampen_q8_tree``
    (the scales do not change under beta <= 1, so they never enter the
    step), and ``exclude`` restores the pre-edit codes.

    ``donate=True`` writes the edit into the edit target's own tensors
    (after the vjp has read them) unless ``exclude`` must restore some of
    them; otherwise the step allocates new ones and the caller's tensors
    stay untouched. ``tag`` goes to ``TRACE_LOG`` once, here.
    """
    if precision not in ("fp32", "int8"):
        raise ValueError(
            f"build_fused_step precision must be 'fp32' or 'int8', got "
            f"{precision!r}")
    in_place = donate and exclude is None
    _note_trace(tag)

    def body(ctx, ref_layer, edit_layer, fisher_g, acts_c, cot_c, scalars):
        alpha, lam = scalars
        fish, g_acts = grad_fisher_chunks(
            lambda lp, aa: apply_fn(ctx, lp, aa), ref_layer, acts_c, cot_c,
            with_act_grad=with_act_grad)
        with torch.no_grad():
            new_layer, masks, n_sel = dampen_tree_counted(
                precision, edit_layer, fish, fisher_g, alpha, lam,
                use_kernel, in_place=in_place)
            if exclude is not None:
                # exclusion blocks edits; for int8, quantisation is a
                # deployment property of every leaf, so the pre-edit codes
                # come back
                new_layer = _restore_excluded(exclude, new_layer, edit_layer)
            if n_sel is None:
                # the plain path: the masks' sum (the kernel counts in its
                # own pass); either way before the restore, as the
                # reference's _n_sel
                n_sel = sum(m.sum() for m in tree_leaves(masks))
        return new_layer, g_acts, n_sel

    if split_edit or precision == "int8":
        return body

    def step(ctx, layer_p, fisher_g, acts_c, cot_c, scalars):
        return body(ctx, layer_p, layer_p, fisher_g, acts_c, cot_c, scalars)

    return step
