"""``Unlearner`` — the one facade every unlearning call site drives (port of
``repro.api.facade``).

Owns the three long-lived pieces of the FiCABU service:

  * the ``ModelAdapter`` (the per-layer view of the served model),
  * the global Fisher importance I_D and its lifecycle (computed once per
    served model, structure-locked thereafter — a refresh with a
    structurally different tree is a ``ValueError``, never a silent clobber),
  * ONE warm ``repro_torch.engine.UnlearnSession`` whose step cache
    persists across every forget request and coalesced drain,
  * the streamed refresh of I_D between drains (``enable_fisher_refresh``,
    ``refresh_if_due``; ``repro_torch.engine.fisher_stream``).

The facade is bound to one device (``device=``, default ``"cuda"``; it
raises without a card). Requests are ``ForgetRequest``s (or bare
``(inputs, labels)`` pairs of numpy arrays or tensors, moved to the
device), served one at a time (``forget``) or as one coalesced sweep
(``forget_group``); configuration is an ``UnlearnSpec``.

``shard(mesh)`` binds a device mesh (``repro_torch.launch.mesh``): from
then on parameters, the Fisher and forget batches are stored as DTensors
laid out by ``ExecSpec.param_pspecs`` / ``batch_pspec``, and every request
runs as ``repro_torch.dist.execute`` describes (layer products gathered,
the batch split over the data axes, dampening on local shards).
``enable_compilation_cache`` points the kernel build directory, the port's
persistent compilation cache, at a directory.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.cau import ModelAdapter, UnlearnConfig
from repro_torch.core.fisher import diag_fisher
from repro_torch.device import resolve_device
from repro_torch.dist import execute as _dx
from repro_torch.engine import (FisherStream, ProgramCache, RefreshPolicy,
                                UnlearnSession, shape_signature)
from repro_torch.kernels import build as _kbuild
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.obs import telemetry as _t

from .specs import RefreshSpec, UnlearnSpec

Params = Any


@dataclasses.dataclass(frozen=True)
class ForgetRequest:
    """One forget set: the model inputs and the labels whose mapping must be
    destroyed.  ``tag`` is free-form audit metadata (domain id, ticket id)
    carried into the returned stats."""
    inputs: Any
    labels: Any
    tag: Optional[Any] = None


def enable_compilation_cache(cache_dir: str) -> int:
    """Make ``cache_dir`` (created if missing) the kernel build directory:
    the port compiles nothing but its nvcc libraries, so a library is the
    cache's entry. Returns the number of entries already on disk — a cold
    process start with a warm cache should then add ZERO new entries (the
    serve.py ``--check`` gate asserts exactly that). Idempotent for the
    same dir; the cache is PROCESS-global, so pointing it somewhere else
    after it was configured raises instead of silently repointing every
    facade's cache."""
    _kbuild.set_cache_dir(cache_dir)
    return compilation_cache_entries(cache_dir)


def compilation_cache_entries(cache_dir: str) -> int:
    """Number of finished libraries currently in ``cache_dir``."""
    return _kbuild.cache_entries(os.fspath(cache_dir))


def _coerce_request(req) -> ForgetRequest:
    if isinstance(req, ForgetRequest):
        return req
    if isinstance(req, (tuple, list)) and len(req) == 2:
        return ForgetRequest(inputs=req[0], labels=req[1])
    raise ValueError(
        "a forget request must be a ForgetRequest or an (inputs, labels) "
        f"pair, got {type(req).__name__}")


class Unlearner:
    """The unlearning service facade: ``forget`` / ``forget_group`` /
    ``shard``, all configured by one ``UnlearnSpec``.

    >>> unl = Unlearner(adapter, fisher_global,
    ...                 UnlearnSpec.for_mode("ficabu"), device="cuda")
    >>> params, stats = unl.forget(ForgetRequest(fx, fy), params=params)

    ``session=`` adopts an existing warm ``UnlearnSession`` (its cached
    steps survive); otherwise the facade builds one lazily on the first
    request. A Fisher tree whose structure differs from the installed one
    is rejected — refresh values, never shape.

    ``programs=`` injects a process-level ``repro_torch.engine.ProgramCache``
    into the facade's session — the fleet hands every tenant the same cache
    so same-family tenants build each step family once. ``name=`` labels
    this facade (the fleet's tenant name) in diagnostics, error messages
    and fault-injection scoping; it defaults to the adapter's model name.
    """

    def __init__(self, adapter: ModelAdapter,
                 fisher_global: Optional[Params] = None,
                 spec: Optional[UnlearnSpec] = None, *,
                 session: Optional[UnlearnSession] = None,
                 programs: Optional[ProgramCache] = None,
                 name: Optional[str] = None,
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
        if programs is not None and not isinstance(programs, ProgramCache):
            raise ValueError(
                f"programs must be a repro_torch.engine.ProgramCache (the "
                f"process-level step store a fleet shares across tenants), "
                f"got {type(programs).__name__}")
        self.adapter = adapter
        self.spec = spec
        self.name: str = adapter.name if name is None else str(name)
        self._programs = programs
        self.mesh = None
        self._fisher: Optional[Params] = None
        self._session: Optional[UnlearnSession] = None
        # streamed-Fisher refresh state (enable_fisher_refresh)
        self._stream: Optional[FisherStream] = None
        self._refresh_policy: Optional[RefreshPolicy] = None
        self._refresh_batches: List[Any] = []
        self._refresh_cursor = 0
        self._drains_since_refresh = 0
        self._edited_since_refresh = 0
        self._param_count = 0
        self.refresh_log: List[Dict] = []
        if session is not None:
            if session.adapter is not adapter:
                raise ValueError(
                    "the supplied UnlearnSession is bound to adapter "
                    f"{session.adapter.name!r}, not {adapter.name!r}; a warm "
                    "session's steps are adapter-specific — build a new "
                    "Unlearner for the other model")
            if programs is not None and session.programs is not programs:
                raise ValueError(
                    "session= and programs= disagree: the supplied warm "
                    "session already holds its own step cache — adopt the "
                    "session without programs=, or build a fresh Unlearner "
                    "around the shared cache")
            self._session = session
            self._fisher = session.fisher_global
        if fisher_global is not None:
            self.set_fisher(fisher_global)
        if spec.exec.cache_dir is not None:
            enable_compilation_cache(spec.exec.cache_dir)

    def _owner_desc(self) -> str:
        """Who this facade's Fisher/session belong to, for error messages:
        the tenant name when the facade is fleet-labelled, always the
        model."""
        if self.name != self.adapter.name:
            return f"tenant {self.name!r} (model {self.adapter.name!r})"
        return f"model {self.adapter.name!r}"

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
                f"refusing to replace the global Fisher armed for "
                f"{self._owner_desc()} with a structurally different tree "
                "(keys/leaf shapes/dtypes changed) — the warm session's "
                "steps are specialized to the current structure, and a "
                "mismatched tree usually means this is another "
                "tenant's/model's Fisher. Refresh Fisher VALUES with the "
                "same structure, or build a new Unlearner for the new "
                "model.")
        if self.mesh is not None:
            tree = self.place_params(tree)  # same layout rule as params
        self._fisher = tree
        if self._session is not None:
            self._session.fisher_global = tree
        if self._stream is not None:
            # the next streamed fold must start from the installed tree,
            # manual value refreshes included
            self._stream.total = tree
        return self

    def ensure_fisher(self, loss_fn, params: Params, batch,
                      chunk_size: Optional[int] = None) -> Params:
        """Compute the global Fisher ONCE (diagonal, over ``batch``) if this
        facade does not hold one yet; later calls are no-ops returning the
        stored tree (the once-per-served-model lifecycle)."""
        if self._fisher is None:
            cs = self.spec.exec.chunk_size if chunk_size is None else chunk_size
            with _t.span("fisher_global"):
                self.set_fisher(diag_fisher(loss_fn, params, batch,
                                            chunk_size=cs,
                                            device=self.device))
        return self._fisher

    # -- streamed Fisher refresh (DESIGN.md §10) ----------------------------
    @property
    def fisher_stream(self) -> Optional[FisherStream]:
        """The streamed-refresh maintainer (None until
        ``enable_fisher_refresh``)."""
        return self._stream

    def enable_fisher_refresh(self, policy, batches: Sequence,
                              loss_fn, *, chunk_size: Optional[int] = None
                              ) -> "Unlearner":
        """Arm the streamed global-Fisher refresh: between drains, fold
        retain microbatches (evaluated at the CURRENT, post-edit weights)
        into an EMA of I_D and install the result through the
        structure-locked ``set_fisher``.

        ``policy`` is a ``RefreshSpec``/``RefreshPolicy`` (or None to take
        ``spec.refresh``); ``batches`` the retain microbatches the refresh
        cycles through (moved to the device here, once); ``loss_fn(params,
        batch) -> scalar`` the same mean NLL the one-shot Fisher used. The
        refresh step lives in the warm session's step cache next to the
        fused families (``session.stats`` refresh_compiles/refresh_hits).
        The serving loop then calls ``refresh_if_due(params)`` after every
        drain."""
        if policy is None:
            policy = self.spec.refresh
        if isinstance(policy, RefreshSpec):
            policy = policy.to_policy()
        if not isinstance(policy, RefreshPolicy):
            raise ValueError(
                "enable_fisher_refresh needs a RefreshSpec/RefreshPolicy "
                "(or spec.refresh set when passing None), got "
                f"{type(policy).__name__}")
        if self._fisher is None:
            raise ValueError(
                "no global Fisher importance installed to refresh — call "
                "ensure_fisher(loss_fn, params, batch) or set_fisher(tree) "
                "before enable_fisher_refresh")
        batches = list(batches)
        if not batches:
            raise ValueError(
                "enable_fisher_refresh needs at least one retain microbatch "
                "to fold (an empty refresh would silently keep I_D stale)")
        for i, b in enumerate(batches):
            leaves = tree_leaves(b)
            if not leaves or int(leaves[0].shape[0]) < 1:
                raise ValueError(
                    f"refresh microbatch {i} has no samples (leading "
                    f"dimension is 0) — an upstream slice exhausted it; a "
                    f"zero-sample Fisher would be all-NaN and poison I_D")
        cs = self.spec.exec.chunk_size if chunk_size is None else chunk_size
        sess = self._ensure_session()
        if self._stream is not None:
            # re-arming: the dead stream's steps must not linger in the
            # session cache (its cache_token differs, so they could never be
            # reused for the new stream)
            sess.evict_refresh_programs(self._stream.cache_token)
        # the facade's donate=None means NO donation
        self._stream = FisherStream(
            loss_fn, self._fisher, decay=policy.decay, chunk_size=cs,
            donate=bool(self.spec.exec.donate), programs=sess)
        self._refresh_policy = policy
        self._refresh_batches = [
            tree_map(lambda x: torch.as_tensor(x, device=self.device), b)
            for b in batches]
        self._refresh_cursor = 0
        self._drains_since_refresh = 0
        self._edited_since_refresh = 0
        self._param_count = sum(x.numel() for x in tree_leaves(self._fisher))
        return self

    def _note_drain(self, stats_list: Sequence[Dict]) -> None:
        """Account one drain toward the refresh policy triggers."""
        if self._stream is None:
            return
        self._drains_since_refresh += 1
        for st in stats_list:
            self._edited_since_refresh += sum(
                int(n) for n in st.get("selected_per_layer", {}).values())

    @property
    def edited_fraction(self) -> float:
        """Fraction of parameters edited since the last refresh (the
        staleness-trigger input)."""
        if not self._param_count:
            return 0.0
        return min(1.0, self._edited_since_refresh / self._param_count)

    def refresh_if_due(self, params: Params) -> Optional[Dict]:
        """Run a refresh when the policy says so; the serving loop calls
        this between drains. Returns the refresh accounting entry, or None
        when nothing was due (or refresh is not enabled)."""
        if self._stream is None or self._refresh_policy is None:
            return None
        if not self._refresh_policy.due(self._drains_since_refresh,
                                        self.edited_fraction):
            return None
        return self.refresh_now(params)

    def refresh_now(self, params: Params,
                    max_batches: Optional[int] = None) -> Dict:
        """Fold up to ``max_batches`` retain microbatches (policy budget by
        default) at the CURRENT weights — equal-weighted within the refresh
        — into the EMA and install it through the structure-locked
        ``set_fisher``. The stream state only moves after ``set_fisher``
        accepted the tree — a rejected refresh leaves both I_D and the EMA
        untouched."""
        if self._stream is None:
            raise ValueError("streamed refresh is not enabled — call "
                             "enable_fisher_refresh(policy, batches, "
                             "loss_fn) first")
        k = (self._refresh_policy.max_batches if max_batches is None
             else int(max_batches))
        if k < 1:
            raise ValueError(f"refresh_now max_batches must be >= 1, "
                             f"got {max_batches!r}")
        sess = self._ensure_session()
        comp0, hits0 = (sess.stats["refresh_compiles"],
                        sess.stats["refresh_hits"])
        if self.mesh is not None:
            params = self.place_params(params)
        # the budgeted microbatches enter with EQUAL weight: a running mean
        # (per-fold decay i/(i+1); the first fold's decay 0 discards the
        # seed, a protected copy of the installed tree when the step
        # donates), then the policy decay ONCE against the INSTALLED tree
        fresh_mean = self._stream.protect_live_input(self._fisher)
        folded = 0
        for _ in range(k):
            batch = self._refresh_batches[
                self._refresh_cursor % len(self._refresh_batches)]
            self._refresh_cursor += 1
            batch = self.place_batch(batch)
            fresh_mean = self._stream.fold_into(
                fresh_mean, params, batch, decay=folded / (folded + 1))
            folded += 1
        new_total = self._stream.blend(self._fisher, fresh_mean)
        self.set_fisher(new_total)      # structure-locked; may raise
        self._stream.commit(self._fisher, folded)
        # staleness at the refresh DECISION, captured before the trigger
        # counters reset
        drains_stale = self._drains_since_refresh
        edited_stale = self.edited_fraction
        self._drains_since_refresh = 0
        self._edited_since_refresh = 0
        entry = {
            "batches": folded,
            "ema_count": self._stream.count,
            "decay": self._stream.decay,
            "engine": {
                "refresh_compiles": sess.stats["refresh_compiles"] - comp0,
                "refresh_hits": sess.stats["refresh_hits"] - hits0,
            },
        }
        self.refresh_log.append(entry)
        _t.emit("fisher.refresh", name=self.name, batches=folded,
                ema_count=self._stream.count,
                drains_since_refresh=drains_stale,
                edited_fraction=round(edited_stale, 6),
                compiles=entry["engine"]["refresh_compiles"],
                hits=entry["engine"]["refresh_hits"])
        return entry

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
                donate=bool(self.spec.exec.donate), programs=self._programs)
            # fault-injection scoping: tenant-named facades key FaultSpecs
            # by tenant, not by adapter family
            self._session.fault_scope = self.name
        # the scanned program lays its per-layer stack out by the
        # dist.sharding rules: hand the session the mesh + layout mode
        if self.mesh is not None:
            self._session.mesh = self.mesh
            self._session.mesh_sharding = self.spec.exec.sharding
        return self._session

    def with_spec(self, spec: UnlearnSpec) -> "Unlearner":
        """A sibling facade over the SAME adapter, Fisher, warm session and
        mesh, with a different request configuration — e.g. one deployment
        running "ssd" (baseline) and "ficabu" requests against one step
        cache. The session's ``donate`` setting stays as first
        configured. The streamed-refresh stream is NOT shared — exactly one
        facade should own the I_D write path."""
        sess = self._session
        if sess is None and self._fisher is not None:
            sess = self._ensure_session()
        sib = Unlearner(self.adapter, self._fisher, spec, session=sess,
                        programs=None if sess is not None else self._programs,
                        name=self.name, device=self.device)
        if self.mesh is not None:
            sib.shard(self.mesh)
        return sib

    # -- mesh execution -----------------------------------------------------
    def shard(self, mesh) -> "Unlearner":
        """Bind a device mesh (``repro_torch.launch.mesh.Mesh``): from here
        on every request's parameters and forget batches are stored as
        DTensors laid out by ``ExecSpec.param_pspecs`` / ``batch_pspec``
        before the sweep, and the stored Fisher is placed immediately. A
        sharded request returns its parameters as DTensors with the same
        placements (``repro_torch.dist.execute`` says how it computes)."""
        if mesh is None:
            raise ValueError("shard(mesh) needs a repro_torch.launch.mesh."
                             "Mesh; to drop mesh placement build a new "
                             "Unlearner")
        axes = self.spec.exec.mesh_axes
        if axes is not None:
            missing = [a for a in axes if a not in mesh.shape]
            if missing:
                raise ValueError(
                    f"ExecSpec.mesh_axes {axes} not all present on the mesh "
                    f"(axes {tuple(mesh.shape)}): missing {missing}")
        if mesh.device_type != self.device.type:
            raise ValueError(
                f"this Unlearner runs on {self.device}, but the mesh spans "
                f"{mesh.device_type!r} devices; build both for one device")
        self.mesh = mesh
        if self._session is not None:
            self._session.mesh = mesh
            self._session.mesh_sharding = self.spec.exec.sharding
        if self._fisher is not None:
            self.set_fisher(self._fisher)  # re-place on the new mesh
        return self

    def _place(self, x: torch.Tensor, spec) -> torch.Tensor:
        from repro_torch.dist.sharding import placements
        dm = self.mesh.device_mesh
        pl = placements(spec, self.mesh)
        if _dx.is_dtensor(x) and x.device_mesh == dm \
                and tuple(x.placements) == pl:
            return x
        return _dx.place(torch.as_tensor(x, device=self.device), dm, pl)

    def place_params(self, params: Params) -> Params:
        """Store a parameter tree as DTensors by this facade's layout rule
        (no-op without a mesh)."""
        if self.mesh is None:
            return params
        specs = self.spec.exec.param_pspecs(params, self.mesh)
        return tree_map(self._place, params, specs)

    def place_batch(self, batch):
        """Store a [B, ...] batch tree as DTensors with the DP layout (no-op
        without a mesh)."""
        if self.mesh is None:
            return batch

        def one(x):
            x = torch.as_tensor(x, device=self.device)
            ps = self.spec.exec.batch_pspec(self.mesh, int(x.shape[0]),
                                            x.ndim)
            return self._place(x, ps)

        return tree_map(one, batch)

    # -- the API ------------------------------------------------------------
    def forget(self, request, *, params: Params,
               cfg: Optional[UnlearnConfig] = None
               ) -> Tuple[Params, Dict]:
        """Serve one forget request through the warm engine.  Returns
        ``(params', stats)``; ``cfg`` overrides the spec-derived engine
        config.

        Unless the spec sets ``ExecSpec(donate=True)``, the caller's
        parameter tensors are left untouched: edited layers come back as
        new tensors. With ``donate=True`` the edit is written into them.
        Inside ``telemetry.capture(spans=True)`` the request is a
        ``forget`` span."""
        with _t.span("forget"):
            req = _coerce_request(request)
            sess = self._ensure_session()
            cfg = self.spec.to_config() if cfg is None else cfg
            inputs = torch.as_tensor(req.inputs, device=self.device)
            labels = torch.as_tensor(req.labels, device=self.device)
            if self.mesh is not None:
                params = self.place_params(params)
                inputs, labels = self.place_batch((inputs, labels))
            new_params, stats = sess.forget(params, inputs, labels, cfg)
            stats["mode"] = self.spec.mode
            if req.tag is not None:
                stats["tag"] = req.tag
            self._note_drain([stats])
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
        are left untouched. Inside ``telemetry.capture(spans=True)`` the
        group is a ``forget`` span."""
        with _t.span("forget"):
            reqs = [_coerce_request(r) for r in requests]
            if not reqs:
                raise ValueError("forget_group needs at least one forget "
                                 "request; an empty drain should be skipped "
                                 "by the caller")
            sess = self._ensure_session()
            cfg = self.spec.to_config() if cfg is None else cfg
            sets = [(torch.as_tensor(r.inputs, device=self.device),
                     torch.as_tensor(r.labels, device=self.device))
                    for r in reqs]
            if self.mesh is not None:
                params = self.place_params(params)
                if reference is not None:
                    reference = self.place_params(reference)
                sets = [self.place_batch(st) for st in sets]
            new_params, stats_k, group_stats = sess.forget_many(
                params, sets, cfg, reference=reference)
            for r, st in zip(reqs, stats_k):
                st["mode"] = self.spec.mode
                if r.tag is not None:
                    st["tag"] = r.tag
            group_stats["mode"] = self.spec.mode
            self._note_drain(stats_k)
            return new_params, stats_k, group_stats
