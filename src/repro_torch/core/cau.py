"""Context-Adaptive Unlearning (Algorithm 1) + Balanced Dampening (Eq. 5/6).

Control structure mirrors the FiCABU processor: the HOST plays the RISC-V
Rocket core (layer loop, checkpoint decisions, early stop), while each
per-layer step — backward GEMMs, Fisher square-accumulate (FIMD IP),
select/beta/multiply (Dampening IP) — runs as the engine's fused step
(``repro_torch.engine``).

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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.models.module import (flatten_with_paths, map_with_paths,
                                      tree_leaves, tree_map)

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
