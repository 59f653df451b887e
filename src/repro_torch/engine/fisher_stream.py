"""Streamed global-Fisher refresh — the incremental I_D maintainer (port of
``repro.engine.fisher_stream``).

SSD computes the global importance I_D once after training and never
revisits it. A long-lived serving process invalidates that assumption:
every forget drain EDITS the served weights, so the stored I_D gradually
describes parameters that no longer exist and the dampening ratio I_Df/I_D
drifts (DESIGN.md §10). ``FisherStream`` keeps I_D alive instead:

  * the state is a running ``(total, count, decay)`` triple — ``total`` is an
    exponential moving average of per-microbatch diagonal Fishers, ``count``
    the number of folded microbatches, ``decay`` the EMA retention;
  * ``fold_into(total, params, batch)`` folds ONE retain-data microbatch
    evaluated at the *current* (post-edit) weights into the EMA. The whole
    update — per-chunk grads, square-accumulate, EMA blend — is ONE cached
    step (``build_refresh_step``), built once per shape signature and hosted
    in the session's step cache exactly like the fused unlearn step.
    ``decay`` is an operand, so policy changes never rebuild it;
  * ``RefreshPolicy`` decides WHEN the serving loop should pay for a refresh
    between drains: every N drains, or earlier when the edited-parameter
    mass crosses a staleness threshold, with a per-refresh microbatch budget.

EMA semantics, in f32 with the decay rounded to f32 once (the reference's
f32 operand):

    total' = decay * total + (1 - decay) * fisher_tree(params, batch)

  decay = 0   reproduces the one-shot Fisher of the batch (full replace);
  decay = 1   leaves I_D bit-identical (refresh disabled);
  0 < d < 1   an elementwise convex combination.

No donation by default: ``donate=True`` writes the EMA into the ``total``
tensors in place (the stream owns that buffer: the facade's first fold of a
refresh runs on a protected copy of the installed I_D).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Hashable, Optional

import numpy as np
import torch

from repro_torch.core.fisher import fisher_tree
from repro_torch.dist import execute as _dx
from repro_torch.models.module import tree_leaves, tree_map

from .fused import _note_trace, shape_signature

F32 = torch.float32
Params = Any


def _f32(x: float) -> float:
    return float(np.float32(x))


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RefreshPolicy:
    """When (and how hard) to refresh I_D between serving drains.

    ``every_drains``        refresh after every N-th drain (the cadence
                            trigger); 0 disables the cadence, leaving only
                            the staleness trigger.
    ``staleness_threshold`` refresh as soon as the fraction of parameters
                            edited since the last refresh reaches this value
                            (0 disables the staleness trigger).
    ``max_batches``         retain microbatches folded per refresh — the
                            budget a drain point is allowed to spend.
    ``decay``               EMA retention (see module docstring).
    """
    every_drains: int = 1
    staleness_threshold: float = 0.0
    max_batches: int = 1
    decay: float = 0.9

    def __post_init__(self):
        if not isinstance(self.every_drains, int) \
                or isinstance(self.every_drains, bool) \
                or self.every_drains < 0:
            raise ValueError(
                f"RefreshPolicy.every_drains must be an int >= 0 (0 leaves "
                f"only the staleness trigger), got {self.every_drains!r}")
        if not isinstance(self.staleness_threshold, (int, float)) \
                or isinstance(self.staleness_threshold, bool) \
                or not 0.0 <= float(self.staleness_threshold) <= 1.0:
            raise ValueError(
                f"RefreshPolicy.staleness_threshold must be a fraction in "
                f"[0, 1] of edited parameters, got "
                f"{self.staleness_threshold!r}")
        if not isinstance(self.max_batches, int) \
                or isinstance(self.max_batches, bool) or self.max_batches < 1:
            raise ValueError(
                f"RefreshPolicy.max_batches must be an int >= 1 (the "
                f"per-refresh microbatch budget), got {self.max_batches!r}")
        if not isinstance(self.decay, (int, float)) \
                or isinstance(self.decay, bool) \
                or not 0.0 <= float(self.decay) <= 1.0:
            raise ValueError(
                f"RefreshPolicy.decay must be an EMA retention in [0, 1], "
                f"got {self.decay!r}")
        if self.every_drains == 0 and self.staleness_threshold == 0.0:
            raise ValueError(
                "RefreshPolicy with every_drains=0 AND "
                "staleness_threshold=0 would never trigger — enable at "
                "least one of the two")

    def due(self, drains_since_refresh: int, edited_fraction: float) -> bool:
        """Should the serving loop refresh now?"""
        if drains_since_refresh <= 0:
            return False
        if self.every_drains and drains_since_refresh >= self.every_drains:
            return True
        return bool(self.staleness_threshold
                    and edited_fraction >= self.staleness_threshold)


# ---------------------------------------------------------------------------
# the cached refresh step
# ---------------------------------------------------------------------------
def build_refresh_step(loss_fn: Callable[[Params, Any], torch.Tensor],
                       chunk_size: int, *, donate: Optional[bool] = None,
                       tag: str = "refresh") -> Callable:
    """One step: the diag-Fisher of ``batch`` at ``params`` folded into the
    EMA ``total``.

        step(total, params, batch, decay) -> new_total

    ``decay`` is a call operand (policy changes never rebuild the step),
    rounded to f32 once; ``1 - decay`` is formed in f32, as the reference's
    traced f32 arithmetic does. ``donate`` (None means no) writes the new
    EMA into ``total``'s tensors.

    Layout follows the data: DTensor ``params`` run the Fisher as a sharded
    request does (``repro_torch.dist.execute``: whole weights, this rank's
    batch rows, the partial sums reduced over the batch ranks), and the
    Fisher takes ``total``'s placements, so a sharded EMA comes out."""
    _note_trace(tag)

    def fisher(params, batch):
        run = _dx.ShardedRun.for_request(params, batch)
        if run is None:
            return fisher_tree(loss_fn, params, batch, chunk_size)
        with run.active():
            return fisher_tree(loss_fn, _dx.gather_tree(params),
                               run.local_rows(batch), chunk_size)

    def step(total, params, batch, decay):
        d = np.float32(decay)
        a, b = float(d), float(np.float32(1.0) - d)
        with torch.no_grad():
            fish = tree_map(
                lambda f, t: (_dx.place(f, t.device_mesh, t.placements)
                              if _dx.is_dtensor(t) else f),
                fisher(params, batch), total)
            if donate:
                return tree_map(lambda t, f: t.mul_(a).add_(f * b),
                                total, fish)
            return tree_map(lambda t, f: t.to(F32) * a + f * b, total, fish)

    return step


# ---------------------------------------------------------------------------
# the maintainer
# ---------------------------------------------------------------------------
class FisherStream:
    """Incremental global-Fisher maintainer.

    ``programs`` is the host of the cached refresh steps — normally the warm
    ``UnlearnSession`` (its ``refresh_program`` cache + stats), so the
    refresh family lives next to the fused/checkpoint families. Standalone
    use may omit it; the stream then keeps a private cache with the same
    keying.
    """

    def __init__(self, loss_fn: Callable, fisher0: Params, *,
                 decay: float = 0.9, chunk_size: int = 8,
                 donate: Optional[bool] = None, programs=None):
        if fisher0 is None:
            raise ValueError(
                "FisherStream needs the current global Fisher tree as its "
                "EMA seed — compute one first (diag_fisher_streaming or "
                "Unlearner.ensure_fisher)")
        if not isinstance(chunk_size, int) or isinstance(chunk_size, bool) \
                or chunk_size < 1:
            raise ValueError(f"FisherStream chunk_size must be an int >= 1, "
                             f"got {chunk_size!r}")
        if not 0.0 <= float(decay) <= 1.0:
            raise ValueError(f"FisherStream decay must be in [0, 1], "
                             f"got {decay!r}")
        self._loss_fn = loss_fn
        self.total: Params = fisher0
        self.count: int = 0
        self.decay: float = float(decay)
        self.chunk_size = chunk_size
        self.donate = donate
        self._programs = programs
        self._local: Dict[Hashable, Callable] = {}
        self.stats: Dict[str, int] = {"refresh_compiles": 0,
                                      "refresh_hits": 0}
        self._anchor_sig: Optional[Hashable] = None
        # distinguishes this stream's steps inside a shared (session) cache:
        # the keys hold the token itself, so it cannot be reused while any
        # entry is alive (unlike id(self)), and a re-armed facade can evict
        # exactly this stream's family (UnlearnSession.evict_refresh_programs)
        self.cache_token: object = object()

    # -- state --------------------------------------------------------------
    @property
    def state(self):
        """The running ``(total, count, decay)`` triple."""
        return self.total, self.count, self.decay

    def commit(self, new_total: Params, n_batches: int = 1) -> None:
        """Adopt a folded EMA (called by the facade AFTER the
        structure-locked ``set_fisher`` accepted it, so a rejected refresh
        never moves the stream state)."""
        self.total = new_total
        self.count += n_batches

    @property
    def donates(self) -> bool:
        """Whether this stream's step consumes (writes into) its ``total``
        input."""
        return bool(self.donate)

    def protect_live_input(self, total: Params) -> Params:
        """A copy of a total the CALLER does not own (the facade's installed
        I_D) when the step donates, so that the fold never writes into the
        live tree; the tree itself when it does not."""
        if not self.donates:
            return total
        return tree_map(torch.clone, total)

    # -- steps --------------------------------------------------------------
    def _program(self, total, params, batch) -> Callable:
        key = ("refresh", self.cache_token, self.chunk_size,
               shape_signature(total), shape_signature(params),
               shape_signature(batch))

        def builder():
            return build_refresh_step(self._loss_fn, self.chunk_size,
                                      donate=self.donate)

        if self._programs is not None:
            return self._programs.refresh_program(key, builder)
        prog = self._local.get(key)
        if prog is None:
            prog = builder()
            self._local[key] = prog
            self.stats["refresh_compiles"] += 1
        else:
            self.stats["refresh_hits"] += 1
        return prog

    # -- folding ------------------------------------------------------------
    def fold_into(self, total: Params, params: Params, batch: Any,
                  decay: Optional[float] = None) -> Params:
        """PURE fold (unless the step donates): one microbatch of Fisher at
        ``params`` blended into ``total``. Returns the new EMA tree without
        touching the stream state (``commit`` once the caller accepted it).

        The params tree is structure-locked to the first fold: a params tree
        whose keys/leaf shapes changed would hand ``set_fisher`` a
        structurally different Fisher. Refuse it here, before any compute."""
        sig = shape_signature(params)
        if self._anchor_sig is None:
            self._anchor_sig = sig
        elif sig != self._anchor_sig:
            raise ValueError(
                "refresh params tree is structurally different from the one "
                "this FisherStream anchored on (treedef/leaf shapes/dtypes "
                "changed — e.g. a frozen layer was dropped): its gradients "
                "would produce a Fisher the structure-locked set_fisher "
                "must reject. Build a new Unlearner/FisherStream for the "
                "new model structure.")
        d = self.decay if decay is None else float(decay)
        prog = self._program(total, params, batch)
        return prog(total, params, batch, d)

    def blend(self, total: Params, fresh: Params,
              decay: Optional[float] = None) -> Params:
        """One EMA blend WITHOUT a Fisher computation:
        ``decay * total + (1 - decay) * fresh``, both factors Python
        doubles rounded to f32 once (the reference's weakly typed
        scalars). The facade folds a refresh's budgeted microbatches into
        an equal-weight running mean first and applies the policy decay
        ONCE per refresh through this."""
        d = self.decay if decay is None else float(decay)
        a, b = _f32(d), _f32(1.0 - d)
        with torch.no_grad():
            return tree_map(lambda t, f: t.to(F32) * a + f.to(F32) * b,
                            total, fresh)

    def fold(self, params: Params, batch: Any,
             decay: Optional[float] = None) -> Params:
        """Fold one microbatch into the stream's own state and return the
        new total (standalone use; the facade path goes fold_into ->
        set_fisher -> commit). A donating step runs on a protected copy."""
        new_total = self.fold_into(self.protect_live_input(self.total),
                                   params, batch, decay)
        self.commit(new_total)
        return new_total


# ---------------------------------------------------------------------------
# staleness metric
# ---------------------------------------------------------------------------
def tree_rel_err(tree: Params, reference: Params) -> float:
    """Global relative L2 error  ||tree - ref|| / ||ref||  over all leaves —
    the staleness metric: how far a stored I_D sits from a from-scratch
    recompute at the current weights. Leaves may be tensors on any device
    (a host snapshot against a device tree included) or numpy arrays; each
    leaf's sums are f32 on the reference's device, accumulated in Python
    doubles, as the reference does."""
    la = tree_leaves(tree)
    lb = tree_leaves(reference)
    if len(la) != len(lb):
        raise ValueError(
            f"tree_rel_err got trees with {len(la)} vs {len(lb)} leaves — "
            "a truncated comparison would understate the staleness error; "
            "compare structurally matching Fisher trees")
    num = 0.0
    den = 0.0
    with torch.no_grad():
        for a, b in zip(la, lb):
            b = torch.as_tensor(b).to(F32)
            a = torch.as_tensor(a).to(device=b.device, dtype=F32)
            num += float(torch.sum((a - b) ** 2))
            den += float(torch.sum(b ** 2))
    return (num / den) ** 0.5 if den > 0 else float("inf")
