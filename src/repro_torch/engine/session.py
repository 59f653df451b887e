"""UnlearnSession — the warm unlearning engine (port of
``repro.engine.session``, the layerwise path, fp32 and int8).

Holds the adapter, the global Fisher importance, and a cross-request step
cache, so a serving process builds each step ONCE:

  * fused per-layer steps are cached by (layer kind, shape signature): all
    layers sharing a block shape within one sweep reuse one step, and the
    2nd..Nth forget request builds nothing;
  * checkpoint partial inference is ONE cached runner with the start depth
    j as an operand when the layer activations are shape-uniform (ViT):
    blocks j..L-2, then the head, for every j >= 1 (the reference's
    traced-depth program); models whose activations change shape (ResNet)
    and depth j = 0 take one cached runner per start depth, as in the
    reference;
  * the int8 path (``precision="int8"``) adds its own step family
    ("gfused8") and the whole-tree fake-quant entry step ("quant"), with
    their own build/hit counters.

The host drives the layer loop / checkpoint decisions / early stop exactly
as the RISC-V core drives the paper's processor. (The coalesced
``forget_many``, the scanned sweep and telemetry come with later slices.)
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Hashable, List, Tuple

import numpy as np
import torch

from repro_torch.core.cau import (ModelAdapter, UnlearnConfig, _chunk,
                                  _layer_param_counts, _logit_cotangents)
from repro_torch.core.metrics import MacCounter
from repro_torch.core.schedule import checkpoint_set, sigmoid_profile
from repro_torch.kernels.ops import f32
from repro_torch.optim.compression import (q8_dequantize_tree,
                                           q8_fakequant_tree,
                                           q8_quantize_tree)

from .fused import build_fused_step, shape_signature
from .programs import ProgramCache

Params = Any


class UnlearnSession:
    """Unlearning engine bound to (adapter, fisher_global).

    ``donate=True`` lets each fused step write the edited layer into the
    caller's tensors (the in-place edit path); the default ``False`` is
    safe when callers keep references to the pre-edit parameter tree.

    This is the ENGINE layer: call sites should drive it through the
    ``repro_torch.api.Unlearner`` facade, which owns the Fisher lifecycle
    and the session's warmth across requests.
    """

    def __init__(self, adapter: ModelAdapter, fisher_global: Params,
                 *, donate: bool = False):
        self.adapter = adapter
        self.fisher_global = fisher_global
        self.donate = donate
        self.programs = ProgramCache()
        self._ns: Hashable = (adapter.name, adapter.n_layers, donate)
        self.stats: Dict[str, int] = {
            "requests": 0,
            "fused_compiles": 0, "fused_hits": 0,
            "partial_compiles": 0, "partial_hits": 0,
            "quant_compiles": 0, "quant_hits": 0,
        }

    # -- step cache ---------------------------------------------------------
    def _cached(self, family: str, key: Hashable,
                builder: Callable[[], Callable]) -> Callable:
        """Fetch/build through the step cache, crediting this session's
        per-family counters."""
        prog, compiled = self.programs.get_or_build((self._ns,) + key,
                                                    builder)
        self.stats[f"{family}_compiles" if compiled
                   else f"{family}_hits"] += 1
        return prog

    def _layer_key(self, j: int) -> Hashable:
        lk = self.adapter.layer_key
        return ("j", j) if lk is None else lk(j)

    def _layer_ctx(self, params: Params, j: int) -> Params:
        """Context the layer forward needs beyond its own params. Adapters
        that are self-contained per layer return None; the default (no
        hook) passes the full tree, which is always correct."""
        lc = self.adapter.layer_ctx
        return params if lc is None else lc(params, j)

    def fused_program(self, j: int, ctx, layer_p, acts_c, cot_c,
                      cfg: UnlearnConfig, *, split_edit: bool = False
                      ) -> Callable:
        """The fused per-layer step for depth j, from cache when the layer's
        kind + shapes were seen before (this request or any earlier one).

        ``split_edit`` selects the split signature (vjp/Fisher on one
        layer, the edit on another); the int8 path always takes it. The
        edit target shares the reference's shape signature, so the key only
        differs in the kind prefix."""
        with_act = j > 0
        kind = ("gfused" if split_edit else "fused") + (
            "8" if cfg.precision == "int8" else "")
        key = (kind, self._layer_key(j), shape_signature(ctx),
               shape_signature(layer_p), shape_signature(acts_c),
               shape_signature(cot_c), with_act, cfg.use_kernel,
               self.adapter.exclude is not None)
        adapter = self.adapter

        def builder():
            def apply_fn(c, lp, a, _j=j):
                return adapter.apply_layer(c, _j, lp, a)

            # a split step's edit target is not the caller's layer
            # (int8: codes the session made for this step), so it never
            # donates
            return build_fused_step(
                apply_fn, with_act_grad=with_act, use_kernel=cfg.use_kernel,
                exclude=adapter.exclude,
                donate=False if split_edit else self.donate,
                split_edit=split_edit, precision=cfg.precision)

        return self._cached("fused", key, builder)

    def _fakequant_program(self, tree: Params, min_scale: float) -> Callable:
        """Whole-tree fake-quant as ONE cached step: the int8 drive loop's
        entry step."""
        key = ("quant", shape_signature(tree), float(min_scale))

        def builder():
            def run(t, _ms=float(min_scale)):
                with torch.no_grad():
                    return q8_fakequant_tree(t, min_scale=_ms)

            return run

        return self._cached("quant", key, builder)

    # -- checkpoint partial inference ---------------------------------------
    def _uniform_suffix(self, acts: List[torch.Tensor]) -> bool:
        """True when every block input (depths 1..L-2) and the head input
        share shape+dtype, so one runner with the depth as an operand
        covers every checkpoint at j >= 1."""
        L = self.adapter.n_layers
        if L < 3:
            return False
        ref = acts[1]
        return all(a.shape == ref.shape and a.dtype == ref.dtype
                   for a in acts[1:L])

    def _runner(self, key: Hashable) -> Callable:
        """The checkpoint runner cached under ``key``: ``run(prm, a, lbl,
        j)`` pushes the activation ``a`` at depth j through layers j..L-1
        and returns the accuracy on ``lbl``."""
        adapter = self.adapter
        L = adapter.n_layers

        def builder():
            def run(prm, a, lbl, j):
                with torch.no_grad():
                    x = a
                    for jj in range(j, L):
                        x = adapter.apply_layer(prm, jj,
                                                adapter.get_layer(prm, jj), x)
                    return adapter.acc(x, lbl)

            return run

        return self._cached("partial", key, builder)

    def _suffix_program(self, params, act, labels) -> Callable:
        """ONE runner for every depth j >= 1 (blocks j..L-2, then the head),
        the depth an operand: the reference's traced-depth program."""
        return self._runner(("suffix", shape_signature(params),
                             shape_signature(act), shape_signature(labels)))

    def _perj_program(self, j: int, params, act, labels) -> Callable:
        """The runner of depth j alone."""
        return self._runner(("partial", j, shape_signature(params),
                             shape_signature(act), shape_signature(labels)))

    def partial_acc(self, j: int, params, act, labels,
                    uniform: bool) -> torch.Tensor:
        """Forget accuracy by partial inference: the cached activation at
        depth j pushed through the already-edited suffix j..L-1 — by the
        one depth-operand runner when the activations are shape-uniform
        and j >= 1, else by the runner of depth j.

        Returns the DEVICE scalar; the drive loop reads it on the host
        exactly once, where it branches on it."""
        prog = (self._suffix_program(params, act, labels)
                if uniform and j >= 1
                else self._perj_program(j, params, act, labels))
        return prog(params, act, labels, j)

    def _family_counters(self) -> Tuple[int, int]:
        """(builds, cache hits) summed over the request-serving families:
        fused per-layer steps, checkpoint runners and the fake-quant entry
        step."""
        s = self.stats
        return (s["fused_compiles"] + s["partial_compiles"]
                + s["quant_compiles"],
                s["fused_hits"] + s["partial_hits"] + s["quant_hits"])

    # -- the drive loop -----------------------------------------------------
    def forget(self, params: Params, inputs: Any, labels: torch.Tensor,
               cfg: UnlearnConfig) -> Tuple[Params, Dict]:
        """One forget request: Algorithm 1 (+ optional Balanced Dampening),
        the host driving the per-layer loop. Returns (params', stats).

        With ``donate`` off the caller's tensors are left untouched: every
        edited layer is a new tensor and the returned tree shares only the
        layers the sweep did not reach.

        ``precision="int8"``: the working tree is the fake-quantised
        ``fq(params)``, made once; every forward and checkpoint runs on it.
        Each layer's edit codes are quantised ONCE from the PRISTINE layer,
        outside the step (q8 is not idempotent to the last bit, so the fq
        tree is never quantised again), and dequantised after it. The
        returned tree is the deployment state: every leaf lies on its q8
        grid, edited or not, and none is the caller's tensor."""
        adapter = self.adapter
        self.stats["requests"] += 1
        comp0, hits0 = self._family_counters()

        L = adapter.n_layers
        int8 = cfg.precision == "int8"
        pristine = params
        if int8:
            params = self._fakequant_program(
                params, cfg.quant_min_scale)(params)
        cps = (set(checkpoint_set(L, cfg.checkpoint_every))
               if 0 < cfg.checkpoint_every <= L else set())
        S = (sigmoid_profile(L, cfg.b_r, cfg.c_m) if cfg.balanced
             else np.ones(L))

        prm_counts = _layer_param_counts(adapter, params)
        macs = MacCounter(adapter.layer_fwd_macs, prm_counts,
                          batch=int(labels.shape[0]))

        with torch.no_grad():
            logits, acts = adapter.forward_collect(params, inputs)
        macs.add_forward_all()
        uniform = self._uniform_suffix(acts)

        cs = cfg.chunk_size
        labels_c = _chunk(labels, cs)
        cot = _logit_cotangents(adapter.loss, _chunk(logits, cs), labels_c)

        stats: Dict[str, Any] = {
            "stopped_at_l": L, "checkpoints_hit": [], "selected_per_layer": {},
            "forget_acc_trace": [], "profile_S": S.tolist(),
        }
        sweep_limit = cfg.max_layers or L

        for l in range(1, min(L, sweep_limit) + 1):  # paper index, back->front
            j = L - l
            layer_p = adapter.get_layer(params, j)  # untouched == original
            ctx = self._layer_ctx(params, j)
            acts_c = _chunk(acts[j], cs)
            s = float(S[l - 1])
            # the reference's arithmetic: a Python-double product rounded
            # to f32 once
            scalars = (f32(cfg.alpha * s), f32(cfg.lam * s))
            fg_layer = adapter.get_layer(self.fisher_global, j)

            if int8:
                # vjp/Fisher on the materialised fq layer; the edit on codes
                # quantised from the PRISTINE layer
                edit_q, edit_s = q8_quantize_tree(
                    adapter.get_layer(pristine, j),
                    min_scale=cfg.quant_min_scale)
                step = self.fused_program(j, ctx, layer_p, acts_c, cot, cfg,
                                          split_edit=True)
                new_q, g_acts, n_sel = step(ctx, layer_p, edit_q, fg_layer,
                                            acts_c, cot, scalars)
                new_layer = q8_dequantize_tree(new_q, edit_s, like=layer_p)
            else:
                step = self.fused_program(j, ctx, layer_p, acts_c, cot, cfg)
                new_layer, g_acts, n_sel = step(ctx, layer_p, fg_layer,
                                                acts_c, cot, scalars)
            macs.add_backward_layer(j)
            macs.add_fisher_layer(j)
            macs.add_dampen_layer(j)

            params = adapter.set_layer(params, j, new_layer)
            stats["selected_per_layer"][l] = int(n_sel)
            cot = g_acts if j > 0 else None

            if l in cps:
                # the checkpoint's single host sync
                a_forget = float(self.partial_acc(j, params, acts[j], labels,
                                                  uniform))
                macs.add_partial_inference(j, L)
                stats["checkpoints_hit"].append(l)
                stats["forget_acc_trace"].append((l, a_forget))
                if a_forget <= cfg.tau:
                    stats["stopped_at_l"] = l
                    break
        else:
            stats["stopped_at_l"] = min(L, sweep_limit)

        stats["macs"] = macs.total
        stats["macs_ssd"] = MacCounter.ssd_total(adapter.layer_fwd_macs,
                                                 prm_counts, macs.batch)
        stats["macs_vs_ssd_pct"] = 100.0 * macs.total / max(stats["macs_ssd"], 1)
        comp1, hits1 = self._family_counters()
        stats["engine"] = {
            "compiles": comp1 - comp0,
            "cache_hits": hits1 - hits0,
            "uniform_suffix": uniform,
            "sweep_mode": "layerwise",
            "precision": cfg.precision,
        }
        return params, stats
