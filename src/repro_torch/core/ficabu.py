"""FiCABU top-level API — DEPRECATED kwarg shims over ``repro_torch.api``
(port of ``repro.core.ficabu``).

The public entry points live in ``repro_torch.api``:

    from repro_torch.api import Unlearner, UnlearnSpec, ForgetRequest
    unl = Unlearner(adapter, fisher_global, UnlearnSpec.for_mode("ficabu"))
    params, stats = unl.forget(ForgetRequest(inputs, labels), params=params)

``unlearn`` / ``unlearn_group`` below keep the historical loose-kwargs
signatures: each emits a ``DeprecationWarning``, builds the equivalent
``UnlearnSpec``, and routes through the facade on the adapter's device —
producing the same parameters and stats as the facade.

Modes:

  "ssd"     vanilla SSD via the layer sweep (no early stop, uniform (alpha,
            lambda)) — the paper's baseline, MAC-normalised to 100%.
  "cau"     Context-Adaptive Unlearning only (paper §III-A, Table I).
  "bd"      Balanced Dampening only (paper §III-B, Table II).
  "ficabu"  CAU + BD — the full method (paper §IV-B, Table IV).
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Optional, Tuple

import torch

from .cau import ModelAdapter, UnlearnConfig

Params = Any

MODES = ("ssd", "cau", "bd", "ficabu")


def _deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"repro_torch.core.ficabu.{old} is deprecated; use {new} "
        "(repro_torch.api). This shim routes through the facade and stays "
        "bit-identical.", DeprecationWarning, stacklevel=3)


def _spec(mode, alpha, lam, tau, checkpoint_every, b_r, c_m, chunk_size,
          use_kernel):
    from repro_torch.api import UnlearnSpec
    return UnlearnSpec.for_mode(
        mode, alpha=alpha, lam=lam, tau=tau,
        checkpoint_every=checkpoint_every, b_r=b_r, c_m=c_m,
        chunk_size=chunk_size, use_kernel=use_kernel)


def _mode_config(mode: str, alpha, lam, tau, checkpoint_every, b_r, c_m,
                 chunk_size, use_kernel) -> UnlearnConfig:
    """DEPRECATED shim: the mode -> engine-config mapping lives in
    ``UnlearnSpec.to_config()``."""
    _deprecated("_mode_config", "UnlearnSpec.for_mode(mode, ...).to_config()")
    return _spec(mode, alpha, lam, tau, checkpoint_every, b_r, c_m,
                 chunk_size, use_kernel).to_config()


def _facade(adapter, fisher_global, spec, session):
    from repro_torch.api import Unlearner
    return Unlearner(adapter, fisher_global, spec, session=session,
                     device=adapter.device or "cuda")


def unlearn(adapter: ModelAdapter, params: Params, fisher_global: Params,
            inputs: Any, labels: torch.Tensor, *, mode: str = "ficabu",
            alpha: float = 10.0, lam: float = 1.0, tau: float = 0.05,
            checkpoint_every: int = 4, b_r: float = 10.0,
            c_m: Optional[float] = None, chunk_size: int = 8,
            use_kernel: bool = False, session=None) -> Tuple[Params, Dict]:
    """DEPRECATED shim for ``Unlearner.forget``.

    ``session``: a warm ``repro_torch.engine.UnlearnSession`` to reuse its
    cached steps across forget requests; None builds an ephemeral one."""
    _deprecated("unlearn", "Unlearner.forget")
    from repro_torch.api import ForgetRequest
    unl = _facade(adapter, fisher_global,
                  _spec(mode, alpha, lam, tau, checkpoint_every, b_r, c_m,
                        chunk_size, use_kernel), session)
    return unl.forget(ForgetRequest(inputs, labels), params=params)


def unlearn_group(adapter: ModelAdapter, params: Params, fisher_global: Params,
                  forget_sets, *, mode: str = "ficabu",
                  alpha: float = 10.0, lam: float = 1.0, tau: float = 0.05,
                  checkpoint_every: int = 4, b_r: float = 10.0,
                  c_m: Optional[float] = None, chunk_size: int = 8,
                  use_kernel: bool = False, session=None, reference=None
                  ) -> Tuple[Params, list, Dict]:
    """DEPRECATED shim for ``Unlearner.forget_group``: one coalesced
    back-end-first sweep over a GROUP of (inputs, labels) forget sets (a
    serving drain). Returns (params', [stats per set], group_stats)."""
    _deprecated("unlearn_group", "Unlearner.forget_group")
    unl = _facade(adapter, fisher_global,
                  _spec(mode, alpha, lam, tau, checkpoint_every, b_r, c_m,
                        chunk_size, use_kernel), session)
    return unl.forget_group(list(forget_sets), params=params,
                            reference=reference)


def auto_midpoint(ssd_stats: Dict) -> float:
    """Derive c_m from a baseline-SSD run's layer-wise selection counts
    (paper §III-B step (i)-(ii))."""
    from .schedule import midpoint_from_selection
    if not isinstance(ssd_stats, dict) or "selected_per_layer" not in ssd_stats:
        have = sorted(ssd_stats) if isinstance(ssd_stats, dict) else \
            type(ssd_stats).__name__
        raise ValueError(
            "auto_midpoint needs the stats dict of a completed SSD sweep "
            "(must contain 'selected_per_layer', as returned by "
            f"Unlearner.forget with mode='ssd'); got {have}")
    sel = ssd_stats["selected_per_layer"]
    counts = [sel.get(l, 0) for l in sorted(sel)]
    return midpoint_from_selection(counts)
