"""``Unlearner`` — the one facade every unlearning call site drives (port of
``repro.api.facade``).

Owns the three long-lived pieces of the FiCABU service:

  * the ``ModelAdapter`` (the per-layer view of the served model),
  * the global Fisher importance I_D and its lifecycle (computed once per
    served model, structure-locked thereafter — a refresh with a
    structurally different tree is a ``ValueError``, never a silent clobber),
  * ONE warm ``repro_torch.engine.UnlearnSession`` whose step cache
    persists across every forget request.

The facade is bound to one device (``device=``, default ``"cuda"``; it
raises without a card). Requests are ``ForgetRequest``s (or bare
``(inputs, labels)`` pairs of numpy arrays or tensors, moved to the
device), served one at a time (``forget``) or as one coalesced sweep
(``forget_group``); configuration is an ``UnlearnSpec``. (Streamed Fisher
refresh and mesh placement come with later slices.)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.cau import ModelAdapter, UnlearnConfig
from repro_torch.core.fisher import diag_fisher
from repro_torch.device import resolve_device
from repro_torch.engine import UnlearnSession, shape_signature

from .specs import UnlearnSpec

Params = Any


@dataclasses.dataclass(frozen=True)
class ForgetRequest:
    """One forget set: the model inputs and the labels whose mapping must be
    destroyed.  ``tag`` is free-form audit metadata (domain id, ticket id)
    carried into the returned stats."""
    inputs: Any
    labels: Any
    tag: Optional[Any] = None


def _coerce_request(req) -> ForgetRequest:
    if isinstance(req, ForgetRequest):
        return req
    if isinstance(req, (tuple, list)) and len(req) == 2:
        return ForgetRequest(inputs=req[0], labels=req[1])
    raise ValueError(
        "a forget request must be a ForgetRequest or an (inputs, labels) "
        f"pair, got {type(req).__name__}")


class Unlearner:
    """The unlearning service facade: ``forget`` / ``forget_group``, both
    configured by one ``UnlearnSpec``.

    >>> unl = Unlearner(adapter, fisher_global,
    ...                 UnlearnSpec.for_mode("ficabu"), device="cuda")
    >>> params, stats = unl.forget(ForgetRequest(fx, fy), params=params)

    ``session=`` adopts an existing warm ``UnlearnSession`` (its cached
    steps survive); otherwise the facade builds one lazily on the first
    request. A Fisher tree whose structure differs from the installed one
    is rejected — refresh values, never shape.
    """

    def __init__(self, adapter: ModelAdapter,
                 fisher_global: Optional[Params] = None,
                 spec: Optional[UnlearnSpec] = None, *,
                 session: Optional[UnlearnSession] = None,
                 device="cuda"):
        if not isinstance(adapter, ModelAdapter):
            raise ValueError(
                f"Unlearner needs a repro_torch.core.ModelAdapter (see "
                f"repro_torch.core.adapters), got {type(adapter).__name__}")
        self.device = resolve_device(device)
        if adapter.device is not None and adapter.device != self.device:
            raise ValueError(
                f"adapter {adapter.name!r} was built for {adapter.device}, "
                f"but this Unlearner runs on {self.device}; build both for "
                f"the same device")
        spec = UnlearnSpec() if spec is None else spec
        if not isinstance(spec, UnlearnSpec):
            raise ValueError(
                f"spec must be an UnlearnSpec (see repro_torch.api), "
                f"got {type(spec).__name__}")
        self.adapter = adapter
        self.spec = spec
        self._fisher: Optional[Params] = None
        self._session: Optional[UnlearnSession] = None
        if session is not None:
            if session.adapter is not adapter:
                raise ValueError(
                    "the supplied UnlearnSession is bound to adapter "
                    f"{session.adapter.name!r}, not {adapter.name!r}; a warm "
                    "session's steps are adapter-specific — build a new "
                    "Unlearner for the other model")
            self._session = session
            self._fisher = session.fisher_global
        if fisher_global is not None:
            self.set_fisher(fisher_global)

    # -- Fisher lifecycle ---------------------------------------------------
    @property
    def fisher_global(self) -> Optional[Params]:
        return self._fisher

    def set_fisher(self, tree: Params) -> "Unlearner":
        """Install / refresh the global Fisher importance I_D.

        Values may be refreshed at any time; STRUCTURE may not: a tree whose
        keys / leaf shapes / dtypes differ from the installed one raises
        ``ValueError`` instead of silently clobbering the session state."""
        if tree is None:
            raise ValueError("set_fisher needs a Fisher tree; to compute "
                             "one, use ensure_fisher(loss_fn, params, batch)")
        anchor = self._fisher
        if anchor is not None \
                and shape_signature(tree) != shape_signature(anchor):
            raise ValueError(
                f"refusing to replace the global Fisher armed for model "
                f"{self.adapter.name!r} with a structurally different tree "
                "(keys/leaf shapes/dtypes changed) — the warm session's "
                "steps are specialized to the current structure, and a "
                "mismatched tree usually means this is another model's "
                "Fisher. Refresh Fisher VALUES with the same structure, or "
                "build a new Unlearner for the new model.")
        self._fisher = tree
        if self._session is not None:
            self._session.fisher_global = tree
        return self

    def ensure_fisher(self, loss_fn, params: Params, batch,
                      chunk_size: Optional[int] = None) -> Params:
        """Compute the global Fisher ONCE (diagonal, over ``batch``) if this
        facade does not hold one yet; later calls are no-ops returning the
        stored tree (the once-per-served-model lifecycle)."""
        if self._fisher is None:
            cs = self.spec.exec.chunk_size if chunk_size is None else chunk_size
            self.set_fisher(diag_fisher(loss_fn, params, batch,
                                        chunk_size=cs, device=self.device))
        return self._fisher

    # -- session ------------------------------------------------------------
    @property
    def session(self) -> Optional[UnlearnSession]:
        """The warm engine session (None until the first request)."""
        return self._session

    @property
    def stats(self) -> Dict[str, int]:
        """Engine step-cache counters (empty dict before the first
        request)."""
        return dict(self._session.stats) if self._session else {}

    def _ensure_session(self) -> UnlearnSession:
        if self._session is None:
            if self._fisher is None:
                raise ValueError(
                    "no global Fisher importance installed — pass "
                    "fisher_global to Unlearner(...), call set_fisher(tree), "
                    "or ensure_fisher(loss_fn, params, batch) first")
            # the facade's donate=None means NO donation: in-place editing
            # of the caller's tensors is strictly opt-in (donate=True)
            self._session = UnlearnSession(
                self.adapter, self._fisher,
                donate=bool(self.spec.exec.donate))
        return self._session

    def with_spec(self, spec: UnlearnSpec) -> "Unlearner":
        """A sibling facade over the SAME adapter, Fisher and warm session,
        with a different request configuration — e.g. one deployment
        running "ssd" (baseline) and "ficabu" requests against one step
        cache. The session's ``donate`` setting stays as first
        configured."""
        sess = self._session
        if sess is None and self._fisher is not None:
            sess = self._ensure_session()
        return Unlearner(self.adapter, self._fisher, spec, session=sess,
                         device=self.device)

    # -- the API ------------------------------------------------------------
    def forget(self, request, *, params: Params,
               cfg: Optional[UnlearnConfig] = None
               ) -> Tuple[Params, Dict]:
        """Serve one forget request through the warm engine.  Returns
        ``(params', stats)``; ``cfg`` overrides the spec-derived engine
        config.

        Unless the spec sets ``ExecSpec(donate=True)``, the caller's
        parameter tensors are left untouched: edited layers come back as
        new tensors. With ``donate=True`` the edit is written into them."""
        req = _coerce_request(request)
        sess = self._ensure_session()
        cfg = self.spec.to_config() if cfg is None else cfg
        inputs = torch.as_tensor(req.inputs, device=self.device)
        labels = torch.as_tensor(req.labels, device=self.device)
        new_params, stats = sess.forget(params, inputs, labels, cfg)
        stats["mode"] = self.spec.mode
        if req.tag is not None:
            stats["tag"] = req.tag
        return new_params, stats

    def forget_group(self, requests: Sequence, *, params: Params,
                     reference: Optional[Params] = None,
                     cfg: Optional[UnlearnConfig] = None
                     ) -> Tuple[Params, List[Dict], Dict]:
        """Serve a GROUP of forget requests as ONE coalesced back-end-first
        sweep (a serving drain). Returns ``(params', [stats per request],
        group_stats)``; per-request halting/MAC accounting is preserved.
        ``reference`` (default: ``params``) is the snapshot every set's
        vjp and Fisher run on. A group never donates: the caller's tensors
        are left untouched."""
        reqs = [_coerce_request(r) for r in requests]
        if not reqs:
            raise ValueError("forget_group needs at least one forget "
                             "request; an empty drain should be skipped by "
                             "the caller")
        sess = self._ensure_session()
        cfg = self.spec.to_config() if cfg is None else cfg
        sets = [(torch.as_tensor(r.inputs, device=self.device),
                 torch.as_tensor(r.labels, device=self.device))
                for r in reqs]
        new_params, stats_k, group_stats = sess.forget_many(
            params, sets, cfg, reference=reference)
        for r, st in zip(reqs, stats_k):
            st["mode"] = self.spec.mode
            if r.tag is not None:
                st["tag"] = r.tag
        group_stats["mode"] = self.spec.mode
        return new_params, stats_k, group_stats
