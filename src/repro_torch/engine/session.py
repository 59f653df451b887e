"""UnlearnSession — the warm unlearning engine (port of
``repro.engine.session``, fp32 and int8).

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
    their own build/hit counters;
  * ``sweep_mode="scanned"`` runs the whole sweep as ONE cached program
    with on-device halting (``repro_torch.engine.sweep``; "sweep" and
    "int8_sweep" families) where the stack is shape-uniform, for one
    request or a coalesced group (``forget_many``);
  * the streamed-Fisher refresh steps (``repro_torch.engine.fisher_stream``)
    live in the same cache ("refresh" family, its own counters).

A request whose parameters are DTensors (the facade's ``shard``) runs as
``repro_torch.dist.execute`` describes: the trees gathered, this rank's
batch rows, the Fisher and the halting accuracy reduced over the batch
ranks, dampening on local shards, the result stored with the caller's
placements.

``forget_many`` is the fault-injection shell of the fleet's failure model
(``repro_torch.robust.faults``: the ``nan_batch`` and ``fisher_corrupt``
sites, keyed by ``fault_scope``).

In the layerwise loop the host drives the layer walk / checkpoint decisions
/ early stop exactly as the RISC-V core drives the paper's processor. Every
request emits one ``engine.sweep`` telemetry event, and the step cache one
``program.compile`` or ``program.hit`` per lookup (``repro_torch.obs``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cau import (ModelAdapter, UnlearnConfig, _chunk,
                                  _layer_param_counts, _logit_cotangents)
from repro_torch.core.metrics import MacCounter
from repro_torch.core.schedule import checkpoint_set, sigmoid_profile
from repro_torch.dist import execute as _dx
from repro_torch.kernels.ops import f32
from repro_torch.models.module import tree_map
from repro_torch.obs import telemetry as _t
from repro_torch.optim.compression import (q8_dequantize_tree,
                                           q8_fakequant_tree,
                                           q8_quantize_tree)
from repro_torch.robust import faults as _faults

from .fused import _note_trace, build_fused_step, shape_signature
from .programs import ProgramCache
from .sweep import (build_sweep_program, effective_tau32, plan_scanned_sweep,
                    sweep_cache_key)

Params = Any


class UnlearnSession:
    """Unlearning engine bound to (adapter, fisher_global).

    ``donate=True`` lets each fused step write the edited layer into the
    caller's tensors (the in-place edit path); the default ``False`` is
    safe when callers keep references to the pre-edit parameter tree.

    This is the ENGINE layer: call sites should drive it through the
    ``repro_torch.api.Unlearner`` facade, which owns the Fisher lifecycle
    and the session's warmth across requests.

    ``programs=`` shares a process-level ``ProgramCache`` between
    sessions: keys are namespaced by the adapter FAMILY (name + depth) and
    the donation regime, so sharing never crosses families.
    """

    def __init__(self, adapter: ModelAdapter, fisher_global: Params,
                 *, donate: bool = False,
                 programs: Optional[ProgramCache] = None):
        if adapter.sweep_refusal is not None:
            raise ValueError(f"no unlearning session for adapter "
                             f"{adapter.name!r}: {adapter.sweep_refusal}")
        self.adapter = adapter
        self.fisher_global = fisher_global
        self.donate = donate
        # the mesh and layout rule of sharded requests (set by the facade's
        # shard(); None = single device)
        self.mesh = None
        self.mesh_sharding: str = "tp"
        # the gathered copy of a sharded Fisher: (the DTensor tree, whole)
        self._fisher_whole: Optional[Tuple[Params, Params]] = None
        self.programs = programs if programs is not None else ProgramCache()
        self.programs.sessions += 1
        self._ns: Hashable = (adapter.name, adapter.n_layers, donate)
        # which installed FaultSpecs hit this session (the facade sets its
        # name; None keys them by the adapter family)
        self.fault_scope: Optional[str] = None
        self.stats: Dict[str, int] = {
            "requests": 0, "group_sweeps": 0,
            "fused_compiles": 0, "fused_hits": 0,
            "partial_compiles": 0, "partial_hits": 0,
            "refresh_compiles": 0, "refresh_hits": 0,
            "sweep_compiles": 0, "sweep_hits": 0, "sweep_launches": 0,
            # the int8 program family keeps its own counters so a silent
            # fp32 fallback is visible
            "int8_sweep_compiles": 0, "int8_sweep_hits": 0,
            "int8_sweep_launches": 0,
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

    @property
    def _refresh(self) -> Dict[Hashable, Callable]:
        """This session's live refresh-family entries; keys are the
        stream-level keys, namespace stripped."""
        return {k[1:]: v for k, v in self.programs._progs.items()
                if k[0] == self._ns and len(k) > 1 and k[1] == "refresh"}

    def _layer_key(self, j: int) -> Hashable:
        lk = self.adapter.layer_key
        return ("j", j) if lk is None else lk(j)

    def _emit_sweep(self, engine: Dict, stops: List[int]) -> None:
        """One ``engine.sweep`` telemetry event per sweep — the halt depths
        are the paper's context-adaptivity signal, the build/hit deltas the
        warmth signal."""
        _t.emit("engine.sweep", adapter=str(self.adapter.name),
                sets=len(stops), stopped_at_l=list(stops),
                sweep_mode=engine["sweep_mode"],
                precision=engine["precision"],
                compiles=engine["compiles"],
                cache_hits=engine["cache_hits"])

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

            # split steps never donate: in a coalesced drain the first
            # set's edit target IS the snapshot later sets still read
            return build_fused_step(
                apply_fn, with_act_grad=with_act, use_kernel=cfg.use_kernel,
                exclude=adapter.exclude,
                donate=False if split_edit else self.donate,
                split_edit=split_edit, precision=cfg.precision,
                tag=f"{kind}:{self._layer_key(j)}")

        return self._cached("fused", key, builder)

    def sweep_program(self, key: Hashable, builder: Callable[[], Callable],
                      *, family: str = "sweep") -> Callable:
        """The scanned whole-sweep family (``repro_torch.engine.sweep``):
        one program per (set count, stack structure, shape signature,
        halting schedule). ``(alpha, lam, tau)`` and the Fisher values are
        call operands, so a warm process reuses one program per drain shape.
        ``family`` selects the build/hit counter pair — "sweep" (fp32) or
        "int8_sweep"."""
        return self._cached(family, key, builder)

    def _fakequant_program(self, tree: Params, min_scale: float) -> Callable:
        """Whole-tree fake-quant as ONE cached step: the int8 drive loop's
        entry step."""
        key = ("quant", shape_signature(tree), float(min_scale))

        def builder():
            _note_trace("quant")

            def run(t, _ms=float(min_scale)):
                with torch.no_grad():
                    return q8_fakequant_tree(t, min_scale=_ms)

            return run

        return self._cached("quant", key, builder)

    def refresh_program(self, key: Hashable, builder: Callable[[], Callable]
                        ) -> Callable:
        """The streamed-Fisher refresh family
        (``repro_torch.engine.fisher_stream``): hosted next to the fused /
        checkpoint families so ONE warm session owns every step a serving
        process reuses."""
        return self._cached("refresh", key, builder)

    def evict_refresh_programs(self, token) -> int:
        """Drop every refresh step keyed to ``token`` (a FisherStream's
        ``cache_token``): re-arming a facade's refresh replaces the stream,
        and the dead stream's steps must not accumulate. Scoped to THIS
        session's namespace — a fleet tenant never evicts a sibling's."""
        ns = self._ns
        return self.programs.evict_where(
            lambda k: (k[0] == ns and len(k) > 2 and k[1] == "refresh"
                       and k[2] is token))

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

    def _runner(self, key: Hashable, tag: str) -> Callable:
        """The checkpoint runner cached under ``key``: ``run(prm, a, lbl,
        j)`` pushes the activation ``a`` at depth j through layers j..L-1
        and returns the accuracy on ``lbl``."""
        adapter = self.adapter
        L = adapter.n_layers

        def builder():
            _note_trace(tag)

            def run(prm, a, lbl, j):
                with torch.no_grad():
                    x = a
                    for jj in range(j, L):
                        x = adapter.apply_layer(prm, jj,
                                                adapter.get_layer(prm, jj), x)
                    return _dx.global_acc(adapter.acc(x, lbl), lbl)

            return run

        return self._cached("partial", key, builder)

    def _suffix_program(self, params, act, labels) -> Callable:
        """ONE runner for every depth j >= 1 (blocks j..L-2, then the head),
        the depth an operand: the reference's traced-depth program."""
        return self._runner(("suffix", shape_signature(params),
                             shape_signature(act), shape_signature(labels)),
                            "suffix")

    def _perj_program(self, j: int, params, act, labels) -> Callable:
        """The runner of depth j alone."""
        return self._runner(("partial", j, shape_signature(params),
                             shape_signature(act), shape_signature(labels)),
                            f"partial:{j}")

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

    # -- the scanned whole-sweep program (repro_torch.engine.sweep) ---------
    def _family_counters(self) -> Tuple[int, int]:
        """(builds, cache hits) summed over the request-serving families:
        fused per-layer steps, checkpoint runners, the fp32 and int8 scanned
        whole-sweep families, and the fake-quant entry step."""
        s = self.stats
        return (s["fused_compiles"] + s["partial_compiles"]
                + s["sweep_compiles"] + s["int8_sweep_compiles"]
                + s["quant_compiles"],
                s["fused_hits"] + s["partial_hits"] + s["sweep_hits"]
                + s["int8_sweep_hits"] + s["quant_hits"])

    def _try_scanned(self, params: Params,
                     forget_sets: List[Tuple[Any, torch.Tensor]],
                     cfg: UnlearnConfig,
                     reference: Optional[Params] = None
                     ) -> Optional[Tuple[Params, List[Dict]]]:
        """Run the whole back-end-first sweep as ONE cached program when
        the layer stack is scannable; None means "fall back to the layerwise
        driver" (heterogeneous stacks like ResNet, adapters without a
        compact layer_ctx, or a ragged drain group). Per-set halting, MAC
        accounting and the checkpoint trace are reconstructed on the host
        from the program's outputs — read once, after the program."""
        adapter = self.adapter
        K = len(forget_sets)
        sig0 = shape_signature(forget_sets[0])
        if any(shape_signature(s) != sig0 for s in forget_sets[1:]):
            return None  # ragged group: per-set shapes must agree
        pk = (self._ns, "plan", shape_signature(params), sig0)
        plan = self.programs.plan_or_build(
            pk, lambda: plan_scanned_sweep(adapter, params,
                                           forget_sets[0][0]))
        if plan is None:
            return None

        L = adapter.n_layers
        cps = (tuple(checkpoint_set(L, cfg.checkpoint_every))
               if 0 < cfg.checkpoint_every <= L else ())
        limit = min(L, cfg.max_layers or L)
        S = (sigmoid_profile(L, cfg.b_r, cfg.c_m) if cfg.balanced
             else np.ones(L))
        # the same host arithmetic as the layerwise loop: a Python-double
        # product rounded to f32, one (alpha, lam) row per paper layer
        scal = np.empty((limit, 2), np.float32)
        for l in range(1, limit + 1):
            s = float(S[l - 1])
            scal[l - 1, 0] = cfg.alpha * s
            scal[l - 1, 1] = cfg.lam * s

        int8 = cfg.precision == "int8"
        family = "int8_sweep" if int8 else "sweep"
        key = sweep_cache_key(
            plan, adapter, n_sets=K, params=params,
            fisher=self.fisher_global, sets=forget_sets, cps=cps,
            limit=limit, chunk_size=cfg.chunk_size,
            use_kernel=cfg.use_kernel, precision=cfg.precision,
            quant_min_scale=cfg.quant_min_scale
        ) + (self.mesh, self.mesh_sharding)
        prog = self.sweep_program(key, lambda: build_sweep_program(
            adapter, plan, n_sets=K, cps=cps, limit=limit,
            chunk_size=cfg.chunk_size, use_kernel=cfg.use_kernel,
            mesh=self.mesh, mesh_sharding=self.mesh_sharding,
            precision=cfg.precision, quant_min_scale=cfg.quant_min_scale,
            tag=f"sweep{'8' if int8 else ''}:K{K}"), family=family)

        ref_tree = params if reference is None else reference
        if int8:
            # the program's int8 contract: the reference arrives already
            # fake-quantised, materialised by the cached fake-quant step
            ref_tree = self._fakequant_program(
                ref_tree, cfg.quant_min_scale)(ref_tree)
        inputs_k = tuple(s[0] for s in forget_sets)
        labels_k = tuple(s[1] for s in forget_sets)
        new_params, stop, n_sel, acc = prog(
            ref_tree, params, self.fisher_global, inputs_k, labels_k,
            scal, effective_tau32(cfg.tau))
        self.stats["sweep_launches"] += 1
        if int8:
            self.stats["int8_sweep_launches"] += 1
        # ONE host read for the whole drain: the halting, selection and
        # trace outputs of every set, packed (exactly) into one f64 table
        host = torch.cat([stop[:, None].double(), n_sel.double(),
                          acc.double()], dim=1).cpu().numpy()
        stop = host[:, 0]
        n_sel = host[:, 1:1 + limit]
        acc = host[:, 1 + limit:]

        prm_counts = _layer_param_counts(adapter, ref_tree)
        stats_k: List[Dict] = []
        for k in range(K):
            sl = int(stop[k])
            hit = [c for c in cps if c <= sl]
            macs = MacCounter(adapter.layer_fwd_macs, prm_counts,
                              batch=_dx.global_rows(labels_k[k]))
            macs.add_forward_all()
            for l in range(1, sl + 1):
                j = L - l
                macs.add_backward_layer(j)
                macs.add_fisher_layer(j)
                macs.add_dampen_layer(j)
            for c in hit:
                macs.add_partial_inference(L - c, L)
            st: Dict[str, Any] = {
                "stopped_at_l": sl,
                "checkpoints_hit": hit,
                "selected_per_layer": {l: int(n_sel[k, l - 1])
                                       for l in range(1, sl + 1)},
                "forget_acc_trace": [(c, float(acc[k, c - 1])) for c in hit],
                "profile_S": S.tolist(),
                "macs": macs.total,
                "macs_ssd": MacCounter.ssd_total(adapter.layer_fwd_macs,
                                                 prm_counts, macs.batch),
            }
            st["macs_vs_ssd_pct"] = 100.0 * st["macs"] / max(st["macs_ssd"], 1)
            stats_k.append(st)
        return new_params, stats_k

    # -- sharded requests (repro_torch.dist.execute) -------------------------
    def _whole_fisher(self) -> Params:
        """The installed Fisher as whole tensors: gathered once per
        installed tree."""
        tree = self.fisher_global
        if _dx.first_dtensor(tree) is None:
            return tree
        if self._fisher_whole is None or self._fisher_whole[0] is not tree:
            self._fisher_whole = (tree, _dx.gather_tree(tree))
        return self._fisher_whole[1]

    def _sharded(self, run: "_dx.ShardedRun", params: Params,
                 forget_sets: List[Tuple[Any, torch.Tensor]],
                 reference: Optional[Params], cfg: UnlearnConfig, body):
        """``body(whole_params, local_sets, whole_reference)`` inside the
        sharded run, on the gathered trees and this rank's rows; returns
        its result with the parameter tree stored like ``params``."""
        whole = _dx.gather_tree(params)
        sets = [run.local_rows(s) for s in forget_sets]
        for _, lbl in sets:
            run.check_chunks(int(lbl.shape[0]), cfg.chunk_size)
        ref = None if reference is None else _dx.gather_tree(reference)
        installed = self.fisher_global
        self.fisher_global = self._whole_fisher()
        try:
            with run.active():
                out = body(whole, sets, ref)
        finally:
            self.fisher_global = installed
        return (run.shard_like(out[0], params, whole),) + tuple(out[1:])

    # -- the drive loop -----------------------------------------------------
    def forget(self, params: Params, inputs: Any, labels: torch.Tensor,
               cfg: UnlearnConfig) -> Tuple[Params, Dict]:
        """One forget request (sharded when ``params`` holds DTensors)."""
        run = _dx.ShardedRun.for_request(params, (inputs, labels),
                                         mode=self.mesh_sharding)
        if run is None:
            return self._forget(params, inputs, labels, cfg)
        return self._sharded(
            run, params, [(inputs, labels)], None, cfg,
            lambda p, sets, _: self._forget(p, sets[0][0], sets[0][1], cfg))

    def _forget(self, params: Params, inputs: Any, labels: torch.Tensor,
                cfg: UnlearnConfig) -> Tuple[Params, Dict]:
        """One forget request: Algorithm 1 (+ optional Balanced Dampening).
        Returns (params', stats).

        ``cfg.sweep_mode == "scanned"`` routes through the whole-sweep
        program (``repro_torch.engine.sweep``) when the layer stack is
        scannable; otherwise (and for ``"layerwise"``) the host drives the
        per-layer loop below, which stays the bit-exactness oracle.

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
        launch0 = self.stats["sweep_launches"]

        if cfg.sweep_mode == "scanned":
            res = self._try_scanned(params, [(inputs, labels)], cfg)
            if res is not None:
                new_params, stats_k = res
                comp1, hits1 = self._family_counters()
                st = stats_k[0]
                st["engine"] = {
                    "compiles": comp1 - comp0, "cache_hits": hits1 - hits0,
                    "uniform_suffix": True, "sweep_mode": "scanned",
                    "precision": cfg.precision,
                    "sweep_launches": self.stats["sweep_launches"] - launch0,
                }
                self._emit_sweep(st["engine"], [st["stopped_at_l"]])
                return new_params, st

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
                          batch=_dx.global_rows(labels))

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
        self._emit_sweep(stats["engine"], [stats["stopped_at_l"]])
        return params, stats

    # -- coalesced multi-set sweep ------------------------------------------
    def forget_many(self, params: Params,
                    forget_sets: List[Tuple[Any, torch.Tensor]],
                    cfg: UnlearnConfig, *,
                    reference: Optional[Params] = None
                    ) -> Tuple[Params, List[Dict], Dict]:
        """Fault-injection shell around the group sweep (DESIGN.md §16).

        ``fault_scope`` (set by the facade to the tenant name; defaults to
        the adapter family) keys which installed ``FaultSpec``s hit this
        session. Both sites corrupt the CANDIDATE tree only — the caller's
        guard discards it and the live weights never see the damage:

        * ``nan_batch``      a non-finite dampening scale (lam = NaN), the
                             numeric shape of a poisoned forget batch: every
                             selected weight goes NaN (finite guard);
        * ``fisher_corrupt`` the retain Fisher scaled to ~0, so selection
                             grabs everything and beta ~= 0 zeroes it
                             (edit-magnitude guard). Restored in a finally:
                             the session's Fisher survives the injection.
        """
        run = _dx.ShardedRun.for_request(params, forget_sets,
                                         mode=self.mesh_sharding)
        if run is not None:
            return self._sharded(
                run, params, forget_sets, reference, cfg,
                lambda p, sets, ref: self._forget_many_shell(
                    p, sets, cfg, reference=ref))
        return self._forget_many_shell(params, forget_sets, cfg,
                                       reference=reference)

    def _forget_many_shell(self, params: Params,
                           forget_sets: List[Tuple[Any, torch.Tensor]],
                           cfg: UnlearnConfig, *,
                           reference: Optional[Params] = None
                           ) -> Tuple[Params, List[Dict], Dict]:
        scope = self.fault_scope or self.adapter.name
        if _faults.fire("nan_batch", scope):
            # alpha=0 widens selection to every weight with forget signal:
            # the NaN scale lands however conservative the deployment's own
            # alpha made the selection mask
            cfg = dataclasses.replace(cfg, lam=float("nan"), alpha=0.0)
        prev_fisher = None
        if _faults.fire("fisher_corrupt", scope):
            prev_fisher = self.fisher_global
            self.fisher_global = tree_map(lambda x: x * 1e-12, prev_fisher)
        try:
            return self._forget_many_impl(params, forget_sets, cfg,
                                          reference=reference)
        finally:
            if prev_fisher is not None:
                self.fisher_global = prev_fisher

    def _forget_many_impl(self, params: Params,
                          forget_sets: List[Tuple[Any, torch.Tensor]],
                          cfg: UnlearnConfig, *,
                          reference: Optional[Params] = None
                          ) -> Tuple[Params, List[Dict], Dict]:
        """One back-to-front sweep serving a GROUP of forget sets.

        ``forget_sets`` is a list of (inputs, labels) pairs — e.g. every
        forget request due at a serving drain point. The layer stack is
        walked ONCE: at each layer every still-active set runs the
        split-edit fused step (vjp/Fisher against the drain-point snapshot
        ``reference``, dampening composed onto the group-edited layer), so
        K coalesced requests pay one layer walk and one set of cached steps.

        Per-set halting accounting is preserved: each set keeps its own
        cotangent stream, MAC counter, checkpoint trace and ``stopped_at_l``
        — checkpoints are evaluated against the composed suffix (the weights
        that would actually be deployed), and a set that reaches tau stops
        contributing edits to more frontal layers while the others continue.

        ``reference`` (default: ``params`` at entry) is the statistics
        snapshot. ``cfg.sweep_mode == "scanned"`` runs the group as ONE
        program where the stack is scannable and the sets' shapes agree.

        Returns (params', [stats per set], group_stats).
        """
        adapter = self.adapter
        K = len(forget_sets)
        if K < 1:
            raise ValueError("forget_many needs at least one (inputs, "
                             "labels) forget set; skip the drain instead of "
                             "passing an empty group")
        ref_tree = params if reference is None else reference
        self.stats["requests"] += K
        self.stats["group_sweeps"] += 1
        comp0, hits0 = self._family_counters()
        launch0 = self.stats["sweep_launches"]

        if cfg.sweep_mode == "scanned":
            res = self._try_scanned(params, forget_sets, cfg,
                                    reference=reference)
            if res is not None:
                new_params, stats_k = res
                comp1, hits1 = self._family_counters()
                group_stats = {
                    "sets": K, "sweeps": 1,
                    "stopped_at_l": [st["stopped_at_l"] for st in stats_k],
                    "macs": sum(st["macs"] for st in stats_k),
                    "engine": {
                        "compiles": comp1 - comp0,
                        "cache_hits": hits1 - hits0,
                        "uniform_suffix": True,
                        "sweep_mode": "scanned",
                        "precision": cfg.precision,
                        "sweep_launches":
                            self.stats["sweep_launches"] - launch0,
                    },
                }
                self._emit_sweep(group_stats["engine"],
                                 group_stats["stopped_at_l"])
                return new_params, stats_k, group_stats

        L = adapter.n_layers
        cps = (set(checkpoint_set(L, cfg.checkpoint_every))
               if 0 < cfg.checkpoint_every <= L else set())
        S = (sigmoid_profile(L, cfg.b_r, cfg.c_m) if cfg.balanced
             else np.ones(L))
        int8 = cfg.precision == "int8"
        if int8:
            # the fq snapshot is the deployed reference every set backprops
            # through; edit codes come from the PRISTINE edit tree, quantised
            # once per layer, composed across the K sets in the q domain,
            # and dequantised once into the fq working tree
            fqp = self._fakequant_program(ref_tree, cfg.quant_min_scale)
            ref_run = fqp(ref_tree)
            pristine_edit = params
            params = ref_run if reference is None else fqp(params)
        else:
            ref_run = ref_tree
        prm_counts = _layer_param_counts(adapter, ref_tree)
        cs = cfg.chunk_size

        acts_k: List[List[torch.Tensor]] = []
        cot_k: List[Any] = []
        labels_k: List[torch.Tensor] = []
        macs_k: List[MacCounter] = []
        stats_k: List[Dict] = []
        for inputs, labels in forget_sets:
            with torch.no_grad():
                logits, acts = adapter.forward_collect(ref_run, inputs)
            macs = MacCounter(adapter.layer_fwd_macs, prm_counts,
                              batch=_dx.global_rows(labels))
            macs.add_forward_all()
            cot_k.append(_logit_cotangents(adapter.loss, _chunk(logits, cs),
                                           _chunk(labels, cs)))
            acts_k.append(acts)
            labels_k.append(labels)
            macs_k.append(macs)
            stats_k.append({
                "stopped_at_l": L, "checkpoints_hit": [],
                "selected_per_layer": {}, "forget_acc_trace": [],
                "profile_S": S.tolist(),
            })
        uniform = self._uniform_suffix(acts_k[0])

        active = [True] * K
        sweep_limit = cfg.max_layers or L

        for l in range(1, min(L, sweep_limit) + 1):  # paper index, back->front
            j = L - l
            ref_layer = adapter.get_layer(ref_run, j)   # snapshot == original
            ctx = self._layer_ctx(ref_run, j)
            if int8:
                cur, cur_s = q8_quantize_tree(
                    adapter.get_layer(pristine_edit, j),
                    min_scale=cfg.quant_min_scale)
            else:
                cur = adapter.get_layer(params, j)
            s = float(S[l - 1])
            scalars = (f32(cfg.alpha * s), f32(cfg.lam * s))
            fg_layer = adapter.get_layer(self.fisher_global, j)

            for k in range(K):
                if not active[k]:
                    continue
                acts_c = _chunk(acts_k[k][j], cs)
                step = self.fused_program(j, ctx, ref_layer, acts_c,
                                          cot_k[k], cfg, split_edit=True)
                cur, g_acts, n_sel = step(ctx, ref_layer, cur, fg_layer,
                                          acts_c, cot_k[k], scalars)
                macs_k[k].add_backward_layer(j)
                macs_k[k].add_fisher_layer(j)
                macs_k[k].add_dampen_layer(j)
                stats_k[k]["selected_per_layer"][l] = int(n_sel)
                cot_k[k] = g_acts if j > 0 else None

            if int8:
                # beta <= 1 keeps the scale table valid across all K edits
                cur = q8_dequantize_tree(
                    cur, cur_s, like=adapter.get_layer(pristine_edit, j))
            params = adapter.set_layer(params, j, cur)

            if l in cps:
                for k in range(K):
                    if not active[k]:
                        continue
                    a_forget = float(self.partial_acc(j, params, acts_k[k][j],
                                                      labels_k[k], uniform))
                    macs_k[k].add_partial_inference(j, L)
                    stats_k[k]["checkpoints_hit"].append(l)
                    stats_k[k]["forget_acc_trace"].append((l, a_forget))
                    if a_forget <= cfg.tau:
                        stats_k[k]["stopped_at_l"] = l
                        active[k] = False
                if not any(active):
                    break
        else:
            for k in range(K):
                if active[k]:
                    stats_k[k]["stopped_at_l"] = min(L, sweep_limit)

        for k in range(K):
            st = stats_k[k]
            st["macs"] = macs_k[k].total
            st["macs_ssd"] = MacCounter.ssd_total(adapter.layer_fwd_macs,
                                                  prm_counts, macs_k[k].batch)
            st["macs_vs_ssd_pct"] = 100.0 * st["macs"] / max(st["macs_ssd"], 1)
        comp1, hits1 = self._family_counters()
        group_stats = {
            "sets": K, "sweeps": 1,
            "stopped_at_l": [st["stopped_at_l"] for st in stats_k],
            "macs": sum(st["macs"] for st in stats_k),
            "engine": {
                "compiles": comp1 - comp0,
                "cache_hits": hits1 - hits0,
                "uniform_suffix": uniform,
                "sweep_mode": "layerwise",
                "precision": cfg.precision,
            },
        }
        self._emit_sweep(group_stats["engine"], group_stats["stopped_at_l"])
        return params, stats_k, group_stats
