"""Context-Adaptive Unlearning (Algorithm 1) + Balanced Dampening (Eq. 5/6).

Control structure mirrors the FiCABU processor: the HOST plays the RISC-V
Rocket core (layer loop, checkpoint decisions, early stop), while each
per-layer step — backward GEMMs, Fisher square-accumulate (FIMD IP),
select/beta/multiply (Dampening IP) — runs as the engine's fused step
(``repro_torch.engine``). ``context_adaptive_unlearn_legacy`` keeps the
three-steps-per-layer loop as the engine's numerical oracle.

Key properties implemented exactly as in the paper:
  * one initial forward pass on the forget batch, caching the INPUT activation
    of every layer (``acts[j]``);
  * layers are processed back-to-front (paper index l=1 == head);
  * Fisher importance comes from a single backward sweep with the ORIGINAL
    weights;
  * at checkpoints, forget accuracy is evaluated by PARTIAL inference — the
    cached activation at the current layer is pushed through the already-
    edited suffix only (front layers are untouched, so the cache is valid);
  * if forget accuracy <= tau, the remaining front-end layers are skipped.

MACs are accounted on the host exactly as the paper normalises them
(checkpoint overhead included).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.module import (flatten_with_paths, map_with_paths,
                                      tree_leaves, tree_map, tree_unflatten)

from .metrics import MacCounter
from .schedule import checkpoint_set, sigmoid_profile
from .ssd import dampen_tree

F32 = torch.float32

Params = Any

SWEEP_MODES = ("layerwise", "scanned")
PRECISIONS = ("fp32", "int8")


@dataclasses.dataclass
class ModelAdapter:
    """Uniform per-layer view of a model for the CAU driver.

    Depth index j runs FRONT (0: stem/embedding) to BACK (n_layers-1: head);
    the paper's back-to-front index is l = n_layers - j.
    """
    name: str
    n_layers: int
    # forward_collect(params, inputs) -> (logits, [acts_0 .. acts_{L-1}])
    forward_collect: Callable[[Params, Any],
                              Tuple[torch.Tensor, List[torch.Tensor]]]
    # apply_layer(params, j, layer_p, act) -> next activation (logits for j=L-1)
    apply_layer: Callable[[Params, int, Params, torch.Tensor], torch.Tensor]
    get_layer: Callable[[Params, int], Params]
    set_layer: Callable[[Params, int, Params], Params]
    loss: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (logits, labels)
    acc: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    layer_fwd_macs: Sequence[int]                           # per-sample fwd MACs
    int_input_layer0: bool = False                          # token-id inputs
    exclude: Optional[Callable[[str], bool]] = None         # param paths to skip
    # --- engine hooks: step-cache sharing across layers ---
    # layer_key(j) -> hashable kind; layers with equal kind AND equal shapes
    # compute the same function of (ctx, layer_p, act), so one cached fused
    # step serves all of them. None: every depth is its own kind.
    layer_key: Optional[Callable[[int], Any]] = None
    # layer_ctx(params, j) -> context apply_layer needs beyond the layer's
    # own params (None when the layer is self-contained). When the hook
    # itself is None the engine passes the FULL params tree.
    layer_ctx: Optional[Callable[[Any, int], Any]] = None
    # the device the adapter's model lives on (the facade checks it)
    device: Optional[torch.device] = None
    # why the engine's layer sweep cannot serve this model (None: it can);
    # an engine session on such an adapter raises a ValueError with it
    sweep_refusal: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class UnlearnConfig:
    alpha: float = 10.0
    lam: float = 1.0
    tau: float = 0.05                 # target (random-guess) forget accuracy
    checkpoint_every: int = 4         # paper: every 4 convs (RN) / 3 blocks (ViT)
    balanced: bool = False            # Balanced Dampening on/off
    b_r: float = 10.0
    c_m: Optional[float] = None       # None -> midpoint (or supply from SSD stats)
    chunk_size: int = 8               # Fisher gradient chunking
    use_kernel: bool = False          # hand-written CUDA dampening kernel
    max_layers: Optional[int] = None  # optionally bound the sweep
    # "layerwise": the host drives the per-layer loop (the oracle path);
    # "scanned": the whole back-end-first sweep as ONE cached program with
    # on-device halting (repro_torch.engine.sweep) when the layer stack is
    # shape-uniform — heterogeneous stacks fall back automatically.
    sweep_mode: str = "layerwise"
    # "fp32" (the default) or "int8": int8 weight codes with f32 scale
    # tables, dampening on the codes, halting on the fake-quantised
    # weights (DESIGN.md §12); within optim.compression.INT8_SWEEP_RTOL of
    # the fp32 path per layer
    precision: str = "fp32"
    # the q8 scale-table clamp (QuantSpec.min_scale)
    quant_min_scale: float = 1e-12

    def __post_init__(self):
        if self.sweep_mode not in SWEEP_MODES:
            raise ValueError(
                f"UnlearnConfig.sweep_mode must be 'layerwise' or "
                f"'scanned', got {self.sweep_mode!r} — a mistyped mode "
                f"would silently run the layerwise loop")
        if self.precision not in PRECISIONS:
            raise ValueError(
                f"UnlearnConfig.precision must be 'fp32' or 'int8', got "
                f"{self.precision!r} — a mistyped precision would silently "
                f"run the fp32 path")
        if not (isinstance(self.quant_min_scale, float)
                and math.isfinite(self.quant_min_scale)
                and self.quant_min_scale > 0.0):
            raise ValueError(
                f"UnlearnConfig.quant_min_scale must be a finite float > 0 "
                f"(the int8 scale-table clamp), got {self.quant_min_scale!r}")


def _layer_param_counts(adapter: ModelAdapter, params: Params) -> List[int]:
    return [sum(x.numel() for x in tree_leaves(adapter.get_layer(params, j)))
            for j in range(adapter.n_layers)]


def _chunk(x, cs):
    return tree_map(
        lambda a: a.reshape(a.shape[0] // cs, cs, *a.shape[1:]), x)


def _logit_cotangents(loss: Callable, logits_c: torch.Tensor,
                      labels_c: torch.Tensor) -> torch.Tensor:
    """Per-chunk dL/dlogits for the chunk-mean loss. [nc, cs, ...]."""
    with torch.enable_grad():
        return torch.func.vmap(torch.func.grad(loss))(logits_c.detach(),
                                                      labels_c)


def _sweep_layer(apply_fn: Callable, layer_p: Params, acts_c: torch.Tensor,
                 cot_c: torch.Tensor, with_act_grad: bool
                 ) -> Tuple[Params, Optional[torch.Tensor]]:
    """Backward through one layer for every chunk, one chunk after another
    (memory stays O(|layer|)): the vjp on ``layer_p``, the Fisher as the
    f32 sum of squared gradients from zeros, divided by the chunk count.
    Each square is accumulated by one fused multiply-add (``addcmul``),
    rounded once, as XLA compiles the reference's scan body. Returns
    (fisher_layer, cotangents for the previous layer, or None when
    ``with_act_grad`` is False)."""
    nc = acts_c.shape[0]
    fish = [torch.zeros(x.shape, dtype=F32, device=x.device)
            for x in tree_leaves(layer_p)]
    g_acts = [] if with_act_grad else None
    with torch.enable_grad():
        for i in range(nc):
            lp = tree_map(lambda t: t.detach().requires_grad_(True), layer_p)
            a = acts_c[i].detach().requires_grad_(with_act_grad)
            inputs = tree_leaves(lp) + ([a] if with_act_grad else [])
            grads = torch.autograd.grad(apply_fn(lp, a), inputs,
                                        grad_outputs=cot_c[i])
            if with_act_grad:
                g_acts.append(grads[-1])
                grads = grads[:-1]
            fish = [torch.addcmul(f, g.to(F32), g.to(F32))
                    for f, g in zip(fish, grads)]
    fish = [f / nc for f in fish]
    return (tree_unflatten(layer_p, fish),
            torch.stack(g_acts) if with_act_grad else None)


def _restore_excluded(exclude: Callable[[str], bool], new: Params,
                      old: Params) -> Params:
    """Undo dampening on excluded parameter paths (e.g. MoE routers)."""
    olds = dict(flatten_with_paths(old))
    return map_with_paths(
        lambda path, leaf: olds[path] if exclude(path) else leaf, new)


def context_adaptive_unlearn(
        adapter: ModelAdapter, params: Params, fisher_global: Params,
        inputs: Any, labels: torch.Tensor, cfg: UnlearnConfig,
        session=None) -> Tuple[Params, Dict]:
    """Algorithm 1 (+ optional Balanced Dampening). Returns (params', stats).

    Routes through the ``repro_torch.api.Unlearner`` facade over the engine
    (``repro_torch.engine.UnlearnSession``). Pass a warm ``session`` to
    reuse its cached steps across requests; otherwise an ephemeral one is
    created.
    """
    from repro_torch.api import Unlearner  # deferred: api imports cau
    unl = Unlearner(adapter, fisher_global, session=session,
                    device=adapter.device or "cuda")
    new_params, stats = unl.forget((inputs, labels), params=params, cfg=cfg)
    stats.pop("mode", None)  # this entry point predates modes
    return new_params, stats


def context_adaptive_unlearn_legacy(
        adapter: ModelAdapter, params: Params, fisher_global: Params,
        inputs: Any, labels: torch.Tensor, cfg: UnlearnConfig,
) -> Tuple[Params, Dict]:
    """The pre-engine loop: THREE steps per layer (the per-chunk vjp
    sweep, the Fisher square-accumulate inside it, then ``dampen_tree``)
    plus one partial-inference pass per checkpoint depth, in plain
    PyTorch with no step cache: everything is rebuilt on every call. Kept
    as the bit-exactness oracle for the engine
    (tests/test_torch_legacy.py) — do not use in serving paths. It runs
    the fp32 layerwise algorithm whatever ``cfg.precision`` and
    ``cfg.sweep_mode`` say, as the reference's does."""
    L = adapter.n_layers
    cps = (set(checkpoint_set(L, cfg.checkpoint_every))
           if 0 < cfg.checkpoint_every <= L else set())
    S = (sigmoid_profile(L, cfg.b_r, cfg.c_m) if cfg.balanced
         else np.ones(L))

    prm_counts = _layer_param_counts(adapter, params)
    macs = MacCounter(adapter.layer_fwd_macs, prm_counts,
                      batch=int(tree_leaves(labels)[0].shape[0]))

    # Step 0: one forward pass, cache per-layer input activations.
    with torch.no_grad():
        logits, acts = adapter.forward_collect(params, inputs)
    macs.add_forward_all()

    cs = cfg.chunk_size
    labels_c = _chunk(labels, cs)
    cot = _logit_cotangents(adapter.loss, _chunk(logits, cs), labels_c)

    stats: Dict[str, Any] = {
        "stopped_at_l": L, "checkpoints_hit": [], "selected_per_layer": {},
        "forget_acc_trace": [], "profile_S": S.tolist(),
    }
    orig = params
    sweep_limit = cfg.max_layers or L

    def partial_inference(j: int, prm: Params) -> torch.Tensor:
        """Forward cached act[j] through edited layers j..L-1 -> forget
        accuracy."""
        with torch.no_grad():
            x = acts[j]
            for jj in range(j, L):
                x = adapter.apply_layer(prm, jj, adapter.get_layer(prm, jj),
                                        x)
            return adapter.acc(x, labels)

    for l in range(1, min(L, sweep_limit) + 1):   # paper index, back-to-front
        j = L - l
        layer_p = adapter.get_layer(orig, j)       # ORIGINAL weights for vjp

        with_act = j > 0  # no activation cotangent needed past the front layer
        apply_fn = (lambda lp, a, _j=j: adapter.apply_layer(orig, _j, lp, a))
        acts_c = _chunk(acts[j], cs)
        fish, g_acts = _sweep_layer(apply_fn, layer_p, acts_c, cot, with_act)
        macs.add_backward_layer(j)
        macs.add_fisher_layer(j)

        # --- Dampening (SSD rule, optionally depth-scaled) ---
        s = float(S[l - 1])
        fg_layer = adapter.get_layer(fisher_global, j)
        with torch.no_grad():
            new_layer, masks = dampen_tree(adapter.get_layer(params, j), fish,
                                           fg_layer, cfg.alpha * s,
                                           cfg.lam * s,
                                           use_kernel=cfg.use_kernel)
        if adapter.exclude is not None:
            new_layer = _restore_excluded(adapter.exclude, new_layer,
                                          adapter.get_layer(params, j))
        params = adapter.set_layer(params, j, new_layer)
        macs.add_dampen_layer(j)
        stats["selected_per_layer"][l] = int(
            sum(int(m.sum()) for m in tree_leaves(masks)))

        cot = g_acts  # cotangent for the next (more frontal) layer

        # --- Checkpoint: partial inference with cached activations ---
        if l in cps:
            a_forget = float(partial_inference(j, params))
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
    return params, stats
