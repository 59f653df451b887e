"""Whole-sweep program — port of ``repro.engine.sweep``, the scanned
back-end-first sweep.

The layerwise engine (``UnlearnSession.forget``) reads the device on the
host once per layer (the selection count) and once per halt checkpoint
(the forget accuracy it branches on). For shape-uniform layer stacks (ViT)
the whole sweep runs instead as ONE cached program that makes no host sync
between its start and the single read of its outputs:

  * the forget-batch forward (activation collection) and the logit
    cotangents run inside the program;
  * the back-to-front walk — vjp + Fisher square-accumulate + dampen per
    layer, the cotangent threaded between layers — is a host loop over
    per-layer trees (where the reference stacks them for ``lax.scan``),
    blocks in CONTIGUOUS same-kind segments from ``SweepPlan.type_ids``,
    each applying its kind's representative closure;
  * halt checkpoints are evaluated ON THE DEVICE: a set's ``active`` flag
    is a device bool, ``active & (a_forget <= tau32)`` drops it, and every
    later edit and cotangent of that set is masked with
    ``torch.where(active, new, old)`` — the walk goes on over EVERY layer
    up to the sweep's limit, as the reference's scan does. ``stop_l``, the
    per-layer selection counts and the forget-accuracy trace stay device
    tensors, read once by the caller;
  * on a mesh (a sharded request, ``repro_torch.dist.execute``) the
    middle blocks' dampening is laid out as the reference lays out its
    ``[L, ...]`` stacks, by ``stacked_param_pspecs`` (``_constrain_stack``);
    the halting accuracy is reduced over the batch ranks;
  * K coalesced forget sets ride the same program, one after another
    (where the reference ``vmap``s them): each set's vjp/Fisher runs
    against the drain-point snapshot, and its dampening composes onto the
    shared carried layer in set order, masked by its own ``active`` flag —
    the split-edit semantics of ``forget_many``.

Every per-set, per-layer computation is the layerwise engine's own
(``grad_fisher_chunks``, ``dampen_tree_counted``, the checkpoint forward
through the already-edited suffix), so the program's results equal the
layerwise driver's bit for bit (tests/test_torch_sweep.py). Heterogeneous
stacks (ResNet's per-stage shapes) are detected by ``plan_scanned_sweep``
returning None and the session falls back to the layerwise driver, which
stays the oracle.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Hashable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.cau import (ModelAdapter, _chunk, _logit_cotangents,
                                  _restore_excluded)
from repro_torch.core.ssd import dampen_tree_counted
from repro_torch.dist.execute import global_acc
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.optim.compression import (q8_dequantize_tree,
                                           q8_fakequant_tree,
                                           q8_quantize_tree)

from .fused import _note_trace, grad_fisher_chunks, shape_signature

F32 = torch.float32
I32 = torch.int32
Params = Any


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """Static structure of a scannable stack: the distinct middle-layer
    kinds (in first-seen order), one representative depth per kind (its
    apply-closure serves every layer of that kind), and each middle layer's
    kind index, front-to-back (``type_ids[j - 1]`` for depth ``j``)."""
    n_layers: int
    kinds: Tuple[Hashable, ...]
    rep_depths: Tuple[int, ...]
    type_ids: Tuple[int, ...]

    @property
    def cache_fields(self) -> Hashable:
        return (self.n_layers, self.kinds, self.type_ids)


def plan_scanned_sweep(adapter: ModelAdapter, params: Params,
                       inputs: Any) -> Optional[SweepPlan]:
    """Decide whether the scanned program can serve this (adapter, params,
    inputs) — None means "use the layerwise driver".

    Eligible when the middle layers (depths 1..L-2) are SHAPE-uniform:
    equal param subtree signatures, equal block input/output activation
    shapes (the head input included, so one cotangent shape threads the
    walk), and self-contained (``layer_ctx`` returns None — the head may
    still carry a context). Activation shapes come from the adapter's
    forward on ``meta``-device copies of the parameters and the input —
    no compute spent on an ineligible model.
    """
    L = adapter.n_layers
    if L < 3:
        return None
    if adapter.layer_key is None or adapter.layer_ctx is None:
        return None
    for j in range(0, L - 1):
        if adapter.layer_ctx(params, j) is not None:
            return None
    sig0 = shape_signature(adapter.get_layer(params, 1))
    for j in range(2, L - 1):
        if shape_signature(adapter.get_layer(params, j)) != sig0:
            return None
    try:
        meta = lambda t: torch.empty_like(t, device="meta")  # noqa: E731
        with torch.no_grad():
            _, acts = adapter.forward_collect(tree_map(meta, params),
                                              tree_map(meta, inputs))
    except Exception:
        return None
    ref = acts[1]
    if not all(a.shape == ref.shape and a.dtype == ref.dtype
               for a in acts[1:L]):
        return None
    kinds: list = []
    reps: list = []
    type_ids: list = []
    for j in range(1, L - 1):
        k = adapter.layer_key(j)
        if k not in kinds:
            kinds.append(k)
            reps.append(j)
        type_ids.append(kinds.index(k))
    return SweepPlan(n_layers=L, kinds=tuple(kinds), rep_depths=tuple(reps),
                     type_ids=tuple(type_ids))


def effective_tau32(tau: float) -> np.float32:
    """The f32 threshold that makes the on-device halt test ``a <= tau32``
    EXACTLY equivalent to the layerwise host test ``float(a) <= tau`` (f64):
    the largest f32 value that is <= tau."""
    t = np.float32(tau)
    if float(t) > float(tau):
        t = np.nextafter(t, np.float32(-np.inf))
    return t


def build_sweep_program(adapter: ModelAdapter, plan: SweepPlan, *,
                        n_sets: int,
                        cps: Tuple[int, ...],
                        limit: int,
                        chunk_size: int,
                        use_kernel: bool,
                        mesh=None,
                        mesh_sharding: str = "tp",
                        precision: str = "fp32",
                        quant_min_scale: float = 1e-12,
                        tag: str = "sweep") -> Callable:
    """Build the whole-sweep program. Returns

        prog(ref_tree, edit_tree, fisher, inputs_k, labels_k, scalars, tau)
            -> (new_edit_tree, stop_l [K] i32, n_sel [K, limit] i64,
                acc_trace [K, limit] f32)

    all outputs on the labels' device, none read on the host.
    ``ref_tree`` is the vjp/Fisher snapshot (``edit_tree`` itself for a
    single request), ``inputs_k``/``labels_k`` are length-K tuples of
    per-set tensors (all sets shape-equal), ``scalars`` is the host's
    ``[limit, 2]`` f32 table of S(l)-scaled ``(alpha, lam)`` rows and
    ``tau`` the f32 halt threshold from ``effective_tau32`` — operands, so
    changing them never rebuilds the program. ``cps`` (paper-l checkpoint
    set), ``limit`` (bounded sweep depth) and ``chunk_size`` are static and
    part of the session's cache key. ``acc_trace`` rows hold NaN at
    non-checkpoint layers; entries past a set's ``stop_l`` are scratch the
    host discards. Every edit is out of place: a halted set's dampening is
    computed and refused by the mask, so it must never have written its
    target.

    ``precision="int8"`` is the quantised program family: ``ref_tree``
    must arrive ALREADY fake-quantised (materialised by the session's
    cached fake-quant step, never re-quantised here); the forward collect
    and the vjp/Fisher run on it, the carried edit state is each layer's
    int8 codes quantised from the PRISTINE ``edit_tree`` layer (per layer,
    which equals the reference's ``lead_axes=2`` over the stack), dampening
    edits the codes, and checkpoints run on the dequantised codes. The
    returned tree is the dequantised deployment state (every layer
    fake-quantised, edited or not).

    ``mesh`` / ``mesh_sharding`` (the session's, part of its cache key)
    lay the middle blocks' dampening out by ``stacked_param_pspecs`` in a
    sharded request; without a run on this thread they change nothing.
    """
    if precision not in ("fp32", "int8"):
        raise ValueError(
            f"build_sweep_program precision must be 'fp32' or 'int8', got "
            f"{precision!r}")
    _note_trace(tag)
    int8 = precision == "int8"
    L = plan.n_layers
    K = n_sets
    cs = chunk_size
    cps_set = frozenset(cps)
    n_scan = max(0, min(limit, L - 1) - 1)   # paper l = 2 .. min(limit, L-1)
    exclude = adapter.exclude

    def apply_branch(rep_j: int):
        def br(lp, a, _j=rep_j):
            return adapter.apply_layer(None, _j, lp, a)
        return br

    branches = tuple(apply_branch(j) for j in plan.rep_depths)

    # the walk back-to-front in contiguous same-kind segments:
    # (kind, [paper l ...])
    segs: list = []
    for l in range(2, 2 + n_scan):
        t = plan.type_ids[L - l - 1]
        if segs and segs[-1][0] == t:
            segs[-1][1].append(l)
        else:
            segs.append((t, [l]))

    stack_specs: dict = {}

    def _constrain_stack(layer):
        """The layout of a middle block in a sharded request: its spec
        leaves in the ``[L-2, ...]`` stack (``stacked_param_pspecs``, the
        stack dim replicated), the stack dim dropped. None off a mesh."""
        if mesh is None:
            return None
        sig = shape_signature(layer)
        if sig not in stack_specs:
            from repro_torch.dist import sharding as shd
            stack = tree_map(lambda t: torch.empty(
                (L - 2,) + tuple(t.shape), dtype=t.dtype, device="meta"),
                layer)
            stack_specs[sig] = [shd.P(*sp[1:]) for sp in shd.spec_leaves(
                shd.stacked_param_pspecs(stack, mesh, mode=mesh_sharding))]
        return stack_specs[sig]

    def _dampen_compose(cur, fish_k, fish_g, sc, active, specs=None):
        """Split-edit composition: each set's dampening (selection from ITS
        snapshot Fisher) applies to the shared carried layer, in set order,
        masked by that set's halting flag; each count is taken before the
        exclusion restore. Returns (layer', [K] counts)."""
        n_sel_k = []
        for k in range(K):
            new_layer, masks, n_sel = dampen_tree_counted(
                precision, cur, fish_k[k], fish_g, sc[0], sc[1], use_kernel,
                specs=specs)
            if n_sel is None:
                n_sel = sum(m.sum() for m in tree_leaves(masks))
            n_sel_k.append(n_sel)
            if exclude is not None:
                new_layer = _restore_excluded(exclude, new_layer, cur)
            ak = active[k]
            cur = tree_map(lambda n, o: torch.where(ak, n, o), new_layer, cur)
        return cur, torch.stack(n_sel_k)

    def sweep(ref_tree, edit_tree, fisher, inputs_k, labels_k, scalars, tau):
        dev = labels_k[0].device
        tau = float(tau)
        with torch.no_grad():
            # ---- forward collect + cotangents, per set -------------------
            acts_k, cot = [], []
            for inp, lbl in zip(inputs_k, labels_k):
                logits, acts = adapter.forward_collect(ref_tree, inp)
                cot.append(_logit_cotangents(adapter.loss,
                                             _chunk(logits, cs),
                                             _chunk(lbl, cs)))
                acts_k.append(acts)

            active = torch.ones((K,), dtype=torch.bool, device=dev)
            stop_l = torch.full((K,), min(L, limit), dtype=I32, device=dev)
            n_sel_rows = []
            acc_rows = []
            nan_row = torch.full((K,), float("nan"), dtype=F32, device=dev)
            # the deployable layers: the edit in fp32, its dequantised
            # codes in int8 — checkpoints and the output tree read them
            deploy = {}

            def halt_check(l, a_f):
                nonlocal active, stop_l
                halted = active & (a_f <= tau)
                stop_l = torch.where(halted, l, stop_l)
                active = active & ~halted
                acc_rows.append(a_f)

            def layer_edit(j, fn, sc, with_act_grad, stacked=False):
                """vjp + Fisher per set on the snapshot layer, then the
                masked composition onto the carried layer; returns the
                per-set input cotangents."""
                ref_layer = adapter.get_layer(ref_tree, j)
                pristine = adapter.get_layer(edit_tree, j)
                if int8:
                    cur, scales = q8_quantize_tree(pristine,
                                                   min_scale=quant_min_scale)
                else:
                    cur = pristine
                fish_k, g_k = [], []
                for k in range(K):
                    f, g = grad_fisher_chunks(
                        fn, ref_layer, _chunk(acts_k[k][j], cs), cot[k],
                        with_act_grad=with_act_grad)
                    fish_k.append(f)
                    g_k.append(g)
                cur, n_sel = _dampen_compose(
                    cur, fish_k, adapter.get_layer(fisher, j), sc, active,
                    _constrain_stack(cur) if stacked else None)
                deploy[j] = (q8_dequantize_tree(cur, scales, like=pristine)
                             if int8 else cur)
                n_sel_rows.append(n_sel)
                return g_k

            def sc_row(l):
                return (float(scalars[l - 1][0]), float(scalars[l - 1][1]))

            # ---- l = 1: the head ------------------------------------------
            ctx_head = adapter.layer_ctx(ref_tree, L - 1)
            ctx_head_cp = None
            if adapter.layer_ctx(edit_tree, L - 1) is not None:
                # checkpoints read the EDIT tree's context (the weights that
                # would be deployed: fake-quantised in int8)
                ctx_head_cp = adapter.layer_ctx(
                    q8_fakequant_tree(edit_tree, min_scale=quant_min_scale)
                    if int8 else edit_tree, L - 1)

            def head(x):
                return adapter.apply_layer(ctx_head_cp, L - 1, deploy[L - 1],
                                           x)

            cot = layer_edit(
                L - 1, lambda lp, aa: adapter.apply_layer(ctx_head, L - 1,
                                                          lp, aa),
                sc_row(1), True)
            if 1 in cps_set:
                halt_check(1, torch.stack([
                    global_acc(adapter.acc(head(acts_k[k][L - 1]),
                                           labels_k[k]), labels_k[k])
                    for k in range(K)]))
            else:
                acc_rows.append(nan_row)

            # ---- l = 2 .. min(limit, L-1): the blocks, per segment -------
            for t, seg_ls in segs:
                for l in seg_ls:
                    j = L - l
                    act = active
                    g_k = layer_edit(j, branches[t], sc_row(l), True,
                                     stacked=True)
                    cot = [torch.where(act[k], g_k[k], cot[k])
                           for k in range(K)]
                    if l in cps_set:
                        # partial inference from block j: its position is
                        # known here, so blocks j..L-2 run directly
                        def suffix_acc(k, _j=j):
                            x = acts_k[k][_j]
                            for jj in range(_j, L - 1):
                                x = branches[plan.type_ids[jj - 1]](
                                    deploy[jj], x)
                            return global_acc(adapter.acc(head(x),
                                                          labels_k[k]),
                                              labels_k[k])
                        halt_check(l, torch.stack(
                            [suffix_acc(k) for k in range(K)]))
                    else:
                        acc_rows.append(nan_row)

            # ---- l = L: the front layer (patch embedding / stem) ---------
            if limit >= L:
                layer_edit(0, lambda lp, aa: adapter.apply_layer(None, 0, lp,
                                                                 aa),
                           sc_row(L), False)

            new_tree = edit_tree
            for j in range(L):
                if j in deploy:
                    layer = deploy[j]
                elif int8:
                    # never swept, still deployed quantised
                    layer = q8_fakequant_tree(adapter.get_layer(edit_tree, j),
                                              min_scale=quant_min_scale)
                else:
                    continue
                new_tree = adapter.set_layer(new_tree, j, layer)

            if limit >= L:
                if L in cps_set:
                    # final checkpoint: the full-tree forward, contexts from
                    # the edited tree, as the layerwise depth-0 runner
                    def full_acc(k):
                        x = acts_k[k][0]
                        for jj in range(L):
                            x = adapter.apply_layer(
                                new_tree, jj,
                                adapter.get_layer(new_tree, jj), x)
                        return global_acc(adapter.acc(x, labels_k[k]),
                                          labels_k[k])
                    halt_check(L, torch.stack([full_acc(k)
                                               for k in range(K)]))
                else:
                    acc_rows.append(nan_row)

            return (new_tree, stop_l, torch.stack(n_sel_rows, dim=1),
                    torch.stack(acc_rows, dim=1))

    return sweep


def sweep_cache_key(plan: SweepPlan, adapter: ModelAdapter, *,
                    n_sets: int, params: Params, fisher: Params,
                    sets: Sequence[Tuple[Any, Any]],
                    cps: Tuple[int, ...], limit: int,
                    chunk_size: int, use_kernel: bool,
                    precision: str = "fp32",
                    quant_min_scale: float = 1e-12) -> Hashable:
    """The session-cache key for a sweep program: every static quantity the
    builder bakes in. ``(alpha, lam, tau)`` and the Fisher VALUES are call
    operands, so hyperparameter changes and Fisher refreshes reuse the
    cached program. ``precision`` separates the int8 program family from
    fp32 (the session ALSO counts them under distinct build/hit stats);
    ``quant_min_scale`` is baked into the quantisation closures."""
    return ("sweep", precision, float(quant_min_scale), n_sets,
            plan.cache_fields,
            shape_signature(params), shape_signature(fisher),
            shape_signature(tuple(sets)), cps, limit, chunk_size,
            use_kernel, adapter.exclude is not None)
