"""The ``Fleet`` facade: N tenants, ONE scheduler, ONE step cache (port of
``repro.fleet.fleet``).

Each tenant is a served model (config + weights + synthetic domain data)
with its own ``Unlearner`` facade, forget queue, audit logs and tenant-
scoped Fisher.  The fleet owns exactly one ``ProgramCache`` — injected into
every tenant's engine session — so same-family tenants (equal architecture
⇒ equal layer kinds + shapes) build each engine step ONCE for all of them,
and one ``DrainScheduler`` that multiplexes the forget queues across drain
points (fair-share or deadline ordering, coalescing within a tenant).

The per-tenant drain mechanics (coalescing due requests into one
back-end-first sweep, pad-never-trim CHUNK alignment, drain-width
equalization for the scanned program, streamed Fisher refresh, the guard,
audit logging) live in ``TenantRuntime``; the single-tenant
``repro_torch.launch.serve.ForgetService`` is a thin adapter over a
one-tenant fleet.

What sharing does and does not share: cached steps close over only the
adapter's pure apply-closures; every piece of tenant state (params,
Fisher, forget batches) enters as an operand.  Step keys are namespaced by
``(adapter.name, n_layers, donate)``, so distinct families can never
collide, and sharing steps NEVER shares weights.

Every tenant lives on one device (``device=``, default ``"cuda"``; it
raises without a card). ``checkpoint`` / ``recover`` write and read the
reference's checkpoint format (``repro_torch.ckpt``) and replay the
per-tenant WAL.
"""
from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.api import ForgetRequest, Unlearner, UnlearnSpec
from repro_torch.core import adapters
from repro_torch.core import fisher as fisher_mod
from repro_torch.data.synthetic import lm_split_forget_retain
from repro_torch.device import resolve_device
from repro_torch.engine import ProgramCache, tree_rel_err
from repro_torch.models import lm as LM
from repro_torch.models.module import tree_map
from repro_torch.obs import telemetry as _t
from repro_torch.obs.telemetry import wall_time
from repro_torch.robust import faults as _faults
from repro_torch.robust.guards import GuardSpec
from repro_torch.robust.wal import ForgetWAL

from .scheduler import DrainGroup, DrainScheduler
from .specs import FleetSpec, TenantSpec


def _finite_batch(batch_idx) -> bool:
    """True when ``batch_idx`` is a real point on the virtual clock (the
    shutdown flush drains at float('inf'), where retry backoff has no
    meaning — exhausted work dead-letters instead of looping forever)."""
    if isinstance(batch_idx, bool):
        return False
    if isinstance(batch_idx, int):
        return True
    return isinstance(batch_idx, float) and math.isfinite(batch_idx)


class TenantRuntime:
    """One tenant's engine room: weights, data, warm ``Unlearner``, logs.

    ``run_due`` is the drain body: coalesce the due domains into ONE engine
    sweep over the unioned forget sets and return the edited weights.  The
    facade's session (and with it every cached step, hosted in the
    fleet's shared cache) persists across drains.
    """

    def __init__(self, name: str, cfg, tokens, domains, seq_len: int,
                 spec: UnlearnSpec, *, programs: Optional[ProgramCache] = None,
                 weight: float = 1.0, tag: Optional[str] = None,
                 arch: Optional[str] = None, seed: int = 0,
                 coalesce: bool = True, max_forget_samples: int = 8,
                 guard: Optional[GuardSpec] = None, device="cuda"):
        self.name = name
        self.device = resolve_device(device)
        self.arch = arch
        self.seed = seed
        self.weight = weight
        self.tag = tag if tag is not None else f"serve:{name}"
        self.cfg = cfg
        self.tokens = tokens
        self.domains = domains
        self.seq_len = seq_len
        self.spec = spec
        self.chunk = spec.exec.chunk_size
        self.coalesce = coalesce
        self.max_forget_samples = max_forget_samples
        self.adapter = adapters.lm_adapter(cfg, seq_len - 1,
                                           device=self.device)
        self.unlearner: Optional[Unlearner] = None
        self._programs = programs
        self.params = None               # installed by the fleet / adapter
        # -- double-buffered publication state (DESIGN.md §15) --
        # ``params`` is the LIVE tree decode reads; a shadow sweep edits a
        # functional copy and the result waits in ``_staged`` until
        # ``publish_staged`` swaps the pointer between decode steps.
        # ``_shadow_chain`` threads successive shadow sweeps: drain k+1
        # starts from drain k's OUTPUT even before k is published, so the
        # published content is deterministic regardless of publish timing.
        self.params_version = 0
        self._staged = None
        self._shadow_chain = None
        # -- guarded-drain / durability state (DESIGN.md §16) --
        # ``guard`` validates every candidate tree BEFORE it can reach the
        # live pointer; a violation discards the candidate and reports
        # index-based blame via ``last_violation`` so the fleet can retry
        # or dead-letter exactly the unapplied requests.
        self.guard = guard
        self.wal: Optional[ForgetWAL] = None   # set by Fleet.add_tenant
        self.applied_requests = 0
        self.aborts = 0
        self.abort_log: List[Dict] = []
        self.last_violation: Optional[Dict] = None
        # payload bookkeeping for staged-but-unpublished sweeps: each entry
        # is {"payloads": [...], "batch": ...} and is booked as applied
        # only when publish_staged lands the tree
        self._staged_meta: List[Dict] = []
        self.log: List[Dict] = []        # one entry per domain request
        self.group_log: List[Dict] = []  # one entry per coalesced sweep
        self.refresh_log: List[Dict] = []  # one entry per Fisher refresh
        self.sweeps = 0
        self.groups = 0
        self.stale_fisher = None   # host copy of the one-shot I_D
        self.retain_batches: List = []

    def _loss_fn(self, p, b):
        return LM.lm_loss(p, self.cfg, b[0], b[1], aux_weight=0.0)

    def _warm(self, params) -> Unlearner:
        if self.unlearner is None:
            self.unlearner = Unlearner(self.adapter, spec=self.spec,
                                       programs=self._programs,
                                       name=self.name, device=self.device)
            if self.spec.refresh is not None:
                # with refresh armed, the one-shot I_D, the refresh folds
                # AND the --check reference recompute all use the SAME
                # retain stream: the staleness oracle then isolates what
                # the refresh claims to fix — I_D drifting off the EDITED
                # weights — instead of being satisfied by mere data shift
                # (an EMA pulled onto different data looks "closer" even
                # if a regression folded at the stale weights)
                rest = self.tokens[32:]
                step = max(len(rest) // 2, 1)
                self.retain_batches = [
                    (rb[:, :-1], rb[:, 1:])
                    for rb in (rest[:step], rest[step:step * 2]) if len(rb)]
                self.unlearner.set_fisher(fisher_mod.diag_fisher_streaming(
                    self._loss_fn, params, self.retain_batches,
                    chunk_size=self.spec.exec.chunk_size,
                    device=self.device))
                self.unlearner.enable_fisher_refresh(
                    None, self.retain_batches, self._loss_fn)
                # host copy of the pre-refresh I_D for the staleness oracle
                # (the live tree is replaced by refreshes); on the host, as
                # the reference keeps it, not in device memory
                self.stale_fisher = tree_map(
                    lambda t: t.detach().to("cpu", copy=True),
                    self.unlearner.fisher_global)
            else:
                sample = self.tokens[:32]
                self.unlearner.ensure_fisher(
                    self._loss_fn, params, (sample[:, :-1], sample[:, 1:]))
        return self.unlearner

    def maybe_refresh(self, params, batch_idx) -> bool:
        """Streamed I_D refresh between drains (policy-scheduled)."""
        if self.unlearner is None or self.unlearner.fisher_stream is None:
            return False
        t0 = wall_time()
        entry = self.unlearner.refresh_if_due(params)
        if entry is None:
            return False
        entry = dict(entry, batch=batch_idx,
                     latency_s=round(wall_time() - t0, 3))
        self.refresh_log.append(entry)
        _t.log(self.tag,
               f"fisher refresh {len(self.refresh_log) - 1}: "
               f"folded {entry['batches']} retain microbatch(es) at the "
               f"edited weights (ema_count={entry['ema_count']}, "
               f"compiles={entry['engine']['refresh_compiles']}, "
               f"hits={entry['engine']['refresh_hits']})")
        return True

    def staleness_report(self, params) -> Optional[Dict]:
        """The --check oracle: is the refreshed I_D closer than the stale
        one-shot snapshot to a from-scratch recompute at the CURRENT
        (edited) weights?"""
        if self.stale_fisher is None or not self.refresh_log:
            return None
        recompute = fisher_mod.diag_fisher_streaming(
            self._loss_fn, params, self.retain_batches,
            chunk_size=self.spec.exec.chunk_size, device=self.device)
        stale = tree_rel_err(self.stale_fisher, recompute)
        refreshed = tree_rel_err(self.unlearner.fisher_global, recompute)
        return {"stale_rel_err": stale, "refreshed_rel_err": refreshed,
                "improved": refreshed < stale}

    @staticmethod
    def _wrap_pad(fb, extra: int):
        """The pad-never-trim policy: grow ``fb`` by ``extra`` wrap-repeated
        samples (used for CHUNK alignment and drain-width equalization —
        one idiom, one place)."""
        if not extra:
            return fb
        reps = np.concatenate([fb] * (extra // len(fb) + 1))[:extra]
        return np.concatenate([fb, reps])

    def _forget_batch(self, domain: int):
        """Forget samples for one domain, PADDED (never trimmed) to a chunk
        multiple — trimming could silently drop a whole domain's samples
        when fewer than chunk_size exist. Returns (batch | None, n_padded)."""
        splits = lm_split_forget_retain(self.tokens, self.domains, domain)
        fb = splits["forget"][:self.max_forget_samples]
        if len(fb) == 0:
            return None, 0
        pad = (-len(fb)) % self.chunk
        return self._wrap_pad(fb, pad), pad

    def run_due(self, params, due_domains, batch_idx):
        """Coalesce ``due_domains`` into one sweep at ``batch_idx``;
        returns (params, ran_any).  With ``coalesce=False`` (the sequential
        baseline, ``ServeSpec.coalesce``) each due request drains as its
        own single-domain sweep instead.

        Guarded-drain contract: when a ``GuardSpec`` rejects the candidate
        tree the sweep's edits are DISCARDED (the input ``params`` is
        returned untouched) and ``self.last_violation`` carries the blame
        plus index lists RELATIVE to ``due_domains``: ``applied_idx``
        (edits that ARE in the returned tree — the committed prefix under
        the sequential baseline, always [] for a coalesced abort),
        ``handled_idx`` (terminally resolved without an edit — no-sample
        skips) and ``requeue_idx`` (requests the caller must retry or
        dead-letter).  ``last_violation`` is None after a clean run.
        """
        due_domains = list(due_domains)
        self.last_violation = None
        if not self.coalesce and len(due_domains) > 1:
            ran_any = False
            applied_idx: List[int] = []
            handled_idx: List[int] = []
            for i, dom in enumerate(due_domains):
                params, ran = self.run_due(params, [dom], batch_idx)
                viol = self.last_violation
                if viol is not None:
                    # re-base the sub-sweep's indices onto this call's list:
                    # the prefix already committed in place, the untouched
                    # tail rides along to the retry
                    self.last_violation = dict(
                        viol,
                        applied_idx=applied_idx,
                        handled_idx=handled_idx
                        + [i + j for j in viol["handled_idx"]],
                        requeue_idx=[i + j for j in viol["requeue_idx"]]
                        + list(range(i + 1, len(due_domains))))
                    # the sub-sweep logged its LOCAL indices; the audit
                    # trail must blame relative to this call's list
                    self.abort_log[-1] = dict(
                        self.last_violation,
                        batch=self.abort_log[-1]["batch"])
                    return params, ran_any
                (applied_idx if ran else handled_idx).append(i)
                ran_any = ran_any or ran
            return params, ran_any
        group: List[Dict] = []
        # audit entries are BUFFERED until the sweep commits: a guard abort
        # must not leave log traces claiming requests were merged into a
        # group that never landed
        audit: List[Dict] = []
        handled_idx = []
        seen = set()
        n_merged = 0
        for i, dom in enumerate(due_domains):
            if dom in seen:
                # same-domain duplicates union trivially, but every submitted
                # deletion request must leave an audit-log trace
                audit.append({"domain": dom, "batch": batch_idx,
                              "merged_into_group": None})
                n_merged += 1
                continue
            fb, pad = self._forget_batch(dom)
            if fb is None:
                audit.append({"domain": dom, "batch": batch_idx,
                              "skipped": "no forget samples"})
                handled_idx.append(i)
                _t.log(self.tag, f"forget request for domain {dom} "
                       "skipped: no samples in that domain")
                continue
            if pad:
                _t.log(self.tag, f"forget batch for domain {dom} padded "
                       f"by {pad} repeated samples to a multiple of "
                       f"{self.chunk}")
            seen.add(dom)
            group.append({"domain": dom, "fb": fb, "padded": pad})
        if not group:
            self.log.extend(audit)
            return params, False
        if _faults.fire("worker_exc", self.name):
            raise RuntimeError(
                f"injected shadow-sweep worker exception "
                f"(tenant {self.name}, batch {batch_idx})")
        # equalize set sizes within the drain (same wrap-repeat policy as
        # the CHUNK padding): the scanned megaprogram stacks the group's
        # forget sets, so a small domain must not force the whole drain
        # onto the layerwise fallback path.  The layerwise driver handles
        # ragged groups natively — don't perturb its statistics.
        widest = max(len(g["fb"]) for g in group)
        if self.spec.exec.sweep_mode == "scanned":
            for g in group:
                extra = widest - len(g["fb"])
                if extra:
                    g["fb"] = self._wrap_pad(g["fb"], extra)
                    g["padded"] += extra
                    _t.log(self.tag, f"forget batch for domain "
                           f"{g['domain']} padded by {extra} repeated "
                           f"samples to the drain's widest set ({widest})")

        unl = self._warm(params)
        t0 = wall_time()
        new_params, stats_k, gstats = unl.forget_group(
            [ForgetRequest(g["fb"][:, :-1], g["fb"][:, 1:], tag=g["domain"])
             for g in group],
            params=params)
        latency = round(wall_time() - t0, 3)
        viol = self._check_guard(params, new_params)
        if viol is not None:
            # discard the candidate tree: the caller's (live) tree is
            # returned untouched.  Skip entries flush (those requests are
            # terminally resolved either way); merge traces do not (their
            # group never landed).
            self.log.extend(a for a in audit if "skipped" in a)
            self.aborts += 1
            self.last_violation = dict(
                viol, applied_idx=[], handled_idx=list(handled_idx),
                requeue_idx=[i for i in range(len(due_domains))
                             if i not in set(handled_idx)])
            self.abort_log.append(dict(self.last_violation, batch=batch_idx))
            _t.log(self.tag, f"guard {viol['guard']!r} rejected the "
                   f"coalesced sweep at batch {batch_idx} — candidate tree "
                   f"discarded, live weights keep serving")
            return params, False
        params = new_params
        self.sweeps += gstats["sweeps"]
        self.groups += 1
        gi = self.groups - 1
        for a in audit:
            if "merged_into_group" in a:
                a["merged_into_group"] = gi
        self.log.extend(audit)
        self.group_log.append({
            "group": gi, "batch": batch_idx,
            "domains": [g["domain"] for g in group],
            "requests": len(group) + n_merged,
            # the drain's program signature: set count + per-set batch.
            # Compiled programs are keyed by it, so the --check recompile
            # gate flags warm drains of a SEEN signature only — the first
            # drain of a new group size/width legitimately compiles.
            "sweep_sig": [len(group), widest],
            "sweeps": gstats["sweeps"], "latency_s": latency,
            "engine": gstats["engine"],
        })
        for g, st in zip(group, stats_k):
            self.log.append({
                "domain": g["domain"], "batch": batch_idx, "group": gi,
                "latency_s": latency, "padded": g["padded"],
                "stopped_at_l": st["stopped_at_l"],
                "macs_vs_ssd_pct": st["macs_vs_ssd_pct"],
                "engine": gstats["engine"],
            })
        _t.log(self.tag, f"coalesced sweep {gi}: unlearned domains "
               f"{[g['domain'] for g in group]} in place "
               f"(sweeps={gstats['sweeps']}, "
               f"stop_l={[st['stopped_at_l'] for st in stats_k]}, "
               f"compiles={gstats['engine']['compiles']}, "
               f"hits={gstats['engine']['cache_hits']})")
        # streamed I_D refresh between drains: fold retain microbatches at
        # the freshly edited weights when the RefreshSpec policy says so
        self.maybe_refresh(params, batch_idx)
        return params, True

    # -- guarded drains (DESIGN.md §16) --------------------------------------
    def _retain_probe(self, tree) -> float:
        """Token accuracy of a candidate tree on a small retain slice —
        the ``GuardSpec.retain_floor`` probe (deterministic: always the
        first 8 retain sequences; its one host read is the accuracy)."""
        rb = torch.as_tensor(np.asarray(self.tokens[:8]), device=self.device)
        with torch.no_grad():
            logits, _ = self.adapter.forward_collect(tree, rb[:, :-1])
            return float(self.adapter.acc(logits, rb[:, 1:]))

    def _check_guard(self, reference, edited) -> Optional[Dict]:
        """Validate a candidate tree against this tenant's GuardSpec.
        Returns the violation dict (guard kind + blame detail) or None."""
        if self.guard is None:
            return None
        probe = (self._retain_probe
                 if self.guard.retain_floor is not None else None)
        return self.guard.check(reference, edited, probe=probe)

    def book_applied(self, payloads, *, batch=None) -> None:
        """Account ``payloads`` as durably applied at the CURRENT
        ``params_version``: bumps the applied counter and marks the
        matching WAL accepts applied (one durable rewrite)."""
        payloads = list(payloads)
        if not payloads:
            return
        self.applied_requests += len(payloads)
        if self.wal is not None:
            ids = self.wal.match_unapplied(payloads)
            self.wal.mark_applied(ids, params_version=self.params_version,
                                  batch=batch)

    def install_recovered(self, params, fisher, version: int) -> None:
        """Install a checkpoint-restored tree (``Fleet.recover``): resets
        all shadow/staged state and rebuilds the facade around the
        restored Fisher (or clears it for lazy recompute)."""
        self.params = params
        self.params_version = int(version)
        self._staged = None
        self._shadow_chain = None
        self._staged_meta = []
        self.last_violation = None
        if fisher is not None:
            self.unlearner = Unlearner(self.adapter, spec=self.spec,
                                       programs=self._programs,
                                       name=self.name, device=self.device)
            self.unlearner.set_fisher(fisher)
        else:
            self.unlearner = None

    # -- double-buffered publication (DESIGN.md §15) -------------------------
    def run_due_shadow(self, due_domains, batch_idx):
        """Drain body against the SHADOW tree: the live ``params`` pointer
        is never touched.  Returns ``(tree, ran)`` — the caller decides
        when to stage/publish the result (the serving engine publishes at
        a deterministic step deadline).

        The sweep itself is functional (``run_due`` returns a new tree),
        so "shadow" costs nothing beyond not assigning ``self.params``:
        bit-exactness vs the in-place path is asserted by
        tests/test_stream.py.
        """
        base = self._shadow_chain if self._shadow_chain is not None \
            else self.params
        tree, ran = self.run_due(base, list(due_domains), batch_idx)
        if ran:
            self._shadow_chain = tree
        return tree, ran

    def stage(self, tree, *, payloads=None, batch=None) -> None:
        """Park a shadow-sweep result for the next ``publish_staged``.
        When ``payloads`` is given they are booked as applied only WHEN
        the staged tree actually publishes — a discarded stage never
        marks WAL entries applied."""
        self._staged = tree
        if payloads is not None:
            self._staged_meta.append({"payloads": list(payloads),
                                      "batch": batch})

    def discard_shadow(self) -> None:
        """Drop unpublished shadow state — the next shadow sweep starts
        from the live tree again (bench warmup hygiene)."""
        self._staged = None
        self._shadow_chain = None
        self._staged_meta = []

    def publish_staged(self, step=None) -> bool:
        """Atomically swap the staged tree into ``params``.

        A pointer assignment is atomic under the GIL, and the serving
        engine only calls this BETWEEN decode steps — so a decode step
        observes either the old tree or the new one, never a mix.
        Returns True when a publication happened.
        """
        if self._staged is None:
            return False
        self.params = self._staged
        self._staged = None
        self.params_version += 1
        staged_meta, self._staged_meta = self._staged_meta, []
        for m in staged_meta:
            self.book_applied(m["payloads"], batch=m["batch"])
        _t.emit("params.publish", tenant=self.name, step=step,
                version=self.params_version)
        _t.log(self.tag, f"published params v{self.params_version}"
               + (f" at step {step}" if step is not None else ""))
        return True


class Fleet:
    """N tenant runtimes + ONE scheduler + ONE shared program cache."""

    def __init__(self, *, scheduling: str = "fair",
                 max_groups_per_drain: int = 0,
                 max_queue_per_tenant: int = 0,
                 admission: str = "defer",
                 programs: Optional[ProgramCache] = None,
                 spec: Optional[FleetSpec] = None):
        if programs is not None and not isinstance(programs, ProgramCache):
            raise ValueError(
                f"Fleet programs= must be a repro_torch.engine.ProgramCache, "
                f"got {type(programs).__name__}")
        self.spec = spec
        self.programs = programs if programs is not None else ProgramCache()
        self.scheduler = DrainScheduler(scheduling,
                                        max_groups=max_groups_per_drain,
                                        max_queue=max_queue_per_tenant,
                                        admission=admission)
        self.tenants: Dict[str, TenantRuntime] = {}
        self.drain_log: List[Dict] = []  # one entry per (tenant, drain)

    @classmethod
    def from_spec(cls, fspec: FleetSpec, build_tenant, *,
                  device="cuda") -> "Fleet":
        """Build a fleet from its spec. ``build_tenant(tspec)`` returns a
        mapping with keys ``cfg``, ``tokens``, ``domains``, ``seq_len``,
        ``params`` — the launcher owns model/data construction, the fleet
        owns engines and scheduling. Every tenant lives on ``device``."""
        if not isinstance(fspec, FleetSpec):
            raise ValueError(f"Fleet.from_spec expects a FleetSpec, "
                             f"got {type(fspec).__name__}")
        fleet = cls(scheduling=fspec.scheduling,
                    max_groups_per_drain=fspec.max_groups_per_drain,
                    max_queue_per_tenant=fspec.max_queue_per_tenant,
                    admission=fspec.admission,
                    spec=fspec)
        for t in fspec.tenants:
            built = build_tenant(t)
            missing = {"cfg", "tokens", "domains", "seq_len", "params"} \
                - set(built)
            if missing:
                raise ValueError(
                    f"build_tenant({t.name!r}) must return cfg/tokens/"
                    f"domains/seq_len/params; missing {sorted(missing)}")
            fleet.add_tenant(t, built["cfg"], built["tokens"],
                             built["domains"], built["seq_len"],
                             params=built["params"],
                             spec=fspec.tenant_unlearn_spec(t.name),
                             coalesce=fspec.serve.coalesce,
                             max_forget_samples=fspec.serve
                             .max_forget_samples, device=device)
        return fleet

    def add_tenant(self, tspec, cfg, tokens, domains, seq_len: int, *,
                   params=None, spec: Optional[UnlearnSpec] = None,
                   weight: Optional[float] = None,
                   tag: Optional[str] = None, coalesce: bool = True,
                   max_forget_samples: int = 8,
                   device="cuda") -> TenantRuntime:
        """Register one tenant on ``device``. ``tspec`` is a TenantSpec or a
        bare name."""
        if isinstance(tspec, TenantSpec):
            name, arch, seed = tspec.name, tspec.arch, tspec.seed
            if weight is None:
                weight = tspec.weight
            if spec is None:
                spec = tspec.spec
        else:
            name, arch, seed = str(tspec), None, 0
        if name in self.tenants:
            raise ValueError(f"tenant {name!r} is already in this fleet")
        if spec is None:
            raise ValueError(
                f"tenant {name!r} needs an UnlearnSpec — pass spec= or use "
                "Fleet.from_spec, which derives it from the fleet's "
                "ServeSpec")
        # guard precedence: a tenant-specific ExecSpec.guard wins; else the
        # fleet-wide FleetSpec.guard applies to every tenant
        guard = spec.exec.guard
        if guard is None and self.spec is not None:
            guard = self.spec.guard
        rt = TenantRuntime(name, cfg, tokens, domains, seq_len, spec,
                           programs=self.programs,
                           weight=1.0 if weight is None else weight,
                           tag=tag, arch=arch, seed=seed,
                           coalesce=coalesce,
                           max_forget_samples=max_forget_samples,
                           guard=guard, device=device)
        rt.params = params
        if self.spec is not None and self.spec.wal_dir:
            rt.wal = ForgetWAL(self.spec.wal_dir, name)
        self.tenants[name] = rt
        self.scheduler.register(name, rt.weight)
        return rt

    def tenant(self, name: str) -> TenantRuntime:
        if name not in self.tenants:
            raise ValueError(f"no tenant {name!r} in this fleet; have "
                             f"{sorted(self.tenants)}")
        return self.tenants[name]

    def submit(self, tenant: str, domain: int, due_batch: int,
               *, now: Optional[int] = None) -> bool:
        """Enqueue one forget request; returns False when admission
        control rejected it (``admission="reject"`` on a full queue).
        Admitted requests are durably WAL-accepted BEFORE they can drain
        (rejected ones never enter the WAL)."""
        rt = self.tenant(tenant)  # actionable unknown-tenant error
        ok = self.scheduler.submit(tenant, int(domain), due_batch, now=now)
        if ok and rt.wal is not None:
            rt.wal.append_accept(int(domain), due_batch, submitted=now)
        return ok

    def drain(self, batch_idx, *, publish: str = "immediate") -> List[Dict]:
        """Run every drain group the scheduler selects at ``batch_idx``.

        Each group is one tenant's coalesced due requests → one engine
        sweep over that tenant's weights.  Returns the new drain-log
        entries (also appended to ``self.drain_log``).

        ``publish`` mirrors ``ServeSpec.publish``: ``"immediate"`` installs
        each sweep's result in place (the legacy path — bit-identical);
        ``"step"`` runs the sweep against the tenant's shadow tree and
        STAGES the result — the live ``params`` is untouched until the
        caller invokes ``TenantRuntime.publish_staged`` between decode
        steps (the serving engine's deterministic step deadline).
        """
        if publish not in ("immediate", "step"):
            raise ValueError(f"Fleet.drain publish must be 'immediate' or "
                             f"'step', got {publish!r}")
        entries: List[Dict] = []
        finite = _finite_batch(batch_idx)
        batch = int(batch_idx) if finite else None
        for g in self.scheduler.due_groups(batch_idx):
            rt = self.tenants[g.tenant]
            _faults.fire("kill_mid_drain", g.tenant)  # SIGKILLs on a hit
            if finite and _faults.fire("deadline_miss", g.tenant):
                # injected publication-deadline miss: nothing ran — the
                # whole group requeues one batch out WITHOUT burning a
                # retry (a miss is a scheduling fault, not a bad edit)
                self.scheduler.requeue(
                    g.tenant, list(g.payloads), due_batch=batch + 1,
                    submitted=list(g.submitted) if g.submitted else None,
                    retries=g.retries, reason="deadline_miss")
                _t.emit("drain.miss", tenant=g.tenant, batch=batch,
                        payloads=list(g.payloads), due_batch=g.due_batch)
                entry = {"tenant": g.tenant, "batch": batch_idx,
                         "payloads": list(g.payloads), "ran": False,
                         "missed": True, "group": None}
                self.drain_log.append(entry)
                entries.append(entry)
                continue
            groups_before = rt.groups
            t0 = wall_time()
            tree = None
            try:
                if publish == "step":
                    tree, ran = rt.run_due_shadow(list(g.payloads),
                                                  batch_idx)
                    violation = rt.last_violation
                    if violation is None and ran:
                        rt.stage(tree, payloads=list(g.payloads),
                                 batch=batch)
                else:
                    rt.params, ran = rt.run_due(rt.params, list(g.payloads),
                                                batch_idx)
                    violation = rt.last_violation
                    # an in-place drain advances the live tree past any
                    # shadow chain — reset so a later shadow sweep starts
                    # from it
                    rt._shadow_chain = None
            except Exception as e:
                # a crashed sweep is an abort, not a fleet crash: the live
                # tree was never touched (sweeps are functional), so it
                # keeps serving while the group retries or dead-letters
                ran = False
                violation = {"guard": "exception", "detail": repr(e),
                             "applied_idx": [], "handled_idx": [],
                             "requeue_idx": list(range(len(g.payloads)))}
            aborted = None
            if violation is not None:
                action = self._abort(g, rt, violation, batch_idx, publish,
                                     tree=tree)
                aborted = {"guard": violation["guard"], "action": action}
            elif publish == "immediate":
                if ran:
                    # the in-place path versions the live tree per drain so
                    # WAL apply marks order against checkpoints correctly
                    rt.params_version += 1
                rt.book_applied(list(g.payloads), batch=batch)
            elif not ran:
                # step mode, nothing swept (every request skipped): nothing
                # will ever publish for them — terminally resolved now
                rt.book_applied(list(g.payloads), batch=batch)
            entry = {"tenant": g.tenant, "batch": batch_idx,
                     "payloads": list(g.payloads), "ran": ran,
                     "aborted": aborted,
                     "group": rt.group_log[-1]
                     if ran and rt.groups > groups_before else None}
            self.drain_log.append(entry)
            entries.append(entry)
            glog = entry["group"]
            _t.emit("drain.group", tenant=g.tenant, batch=batch_idx,
                    n_requests=len(g.payloads), ages=list(g.ages),
                    due_batch=g.due_batch, ran=ran,
                    sweeps=glog["sweeps"] if glog else 0,
                    stop_l=[st.get("stopped_at_l") for st in rt.log
                            if st.get("group") == rt.groups - 1]
                    if glog else [],
                    latency_s=round(wall_time() - t0, 3))
        return entries

    def _abort(self, g: DrainGroup, rt: TenantRuntime, violation: Dict,
               batch_idx, publish: str, tree=None) -> str:
        """Guarded-drain failure path (DESIGN.md §16): the live tree keeps
        serving; the committed/handled prefix is booked; the rest retries
        with deterministic backoff or dead-letters when the budget is
        spent.  Returns the action taken for the unapplied requests."""
        if violation["guard"] == "exception":
            # guard violations were already counted inside run_due
            rt.aborts += 1
            rt.abort_log.append(dict(violation, batch=batch_idx))
        payloads = list(g.payloads)
        subs = list(g.submitted) if g.submitted else [None] * len(payloads)
        applied_pl = [payloads[i] for i in violation["applied_idx"]]
        handled_pl = [payloads[i] for i in violation["handled_idx"]]
        requeue_idx = violation["requeue_idx"]
        requeue_pl = [payloads[i] for i in requeue_idx]
        req_subs = [subs[i] for i in requeue_idx]
        finite = _finite_batch(batch_idx)
        batch = int(batch_idx) if finite else None
        if publish == "immediate":
            if applied_pl:
                rt.params_version += 1
            rt.book_applied(applied_pl + handled_pl, batch=batch)
        else:
            if tree is not None and applied_pl:
                # the sequential baseline's committed prefix rides the
                # shadow chain — stage it so it publishes (and books) at
                # the normal step deadline
                rt.stage(tree, payloads=applied_pl, batch=batch)
            rt.book_applied(handled_pl, batch=batch)
        retries = g.retries
        budget = rt.guard.max_retries if rt.guard is not None else 0
        backoff = rt.guard.backoff_batches if rt.guard is not None else 1
        action = "none"
        if requeue_pl and retries < budget and finite:
            self.scheduler.requeue(
                g.tenant, requeue_pl,
                due_batch=batch + backoff * (retries + 1),
                submitted=req_subs if g.submitted else None,
                retries=retries + 1, reason=violation["guard"])
            action = "requeue"
        elif requeue_pl:
            # budget spent (or the shutdown flush, where backoff has no
            # meaning): terminal parking with full accounting
            reason = f"retries_exhausted:{violation['guard']}"
            self.scheduler.dead_letter(
                g.tenant, requeue_pl, reason=reason,
                submitted=req_subs if g.submitted else None, batch=batch)
            if rt.wal is not None:
                rt.wal.mark_dead(rt.wal.match_unapplied(requeue_pl),
                                 reason=reason, batch=batch)
            action = "dead_letter"
        _t.emit("drain.abort", tenant=g.tenant, batch=batch,
                payloads=requeue_pl, guard=violation["guard"],
                leaf=violation.get("leaf"), detail=violation.get("detail"),
                retries=retries, action=action)
        _t.log(rt.tag, f"drain aborted ({violation['guard']}): live tree "
               f"keeps serving; {len(requeue_pl)} request(s) -> {action}")
        return action

    def refresh_if_due(self, batch_idx) -> List[str]:
        """Policy-scheduled Fisher refreshes outside drain points."""
        refreshed = []
        for name, rt in self.tenants.items():
            if rt.params is not None and rt.maybe_refresh(rt.params,
                                                          batch_idx):
                refreshed.append(name)
        return refreshed

    # -- durability: checkpoint + crash recovery (DESIGN.md §16) ------------
    def checkpoint(self, ckpt_dir: str) -> Dict[str, str]:
        """Write one complete checkpoint step per tenant under
        ``<ckpt_dir>/<tenant>/`` — params plus (when warmed) the tenant's
        Fisher, keyed by ``params_version`` so WAL apply marks order
        against it.  Returns the step dir per tenant."""
        from repro_torch.ckpt import checkpoint as ckpt
        out: Dict[str, str] = {}
        for name, rt in self.tenants.items():
            if rt.params is None:
                continue
            tree = {"params": rt.params}
            has_fisher = (rt.unlearner is not None
                          and rt.unlearner.fisher_global is not None)
            if has_fisher:
                tree["fisher"] = rt.unlearner.fisher_global
            out[name] = ckpt.save(
                os.path.join(ckpt_dir, name), rt.params_version, tree,
                extra_meta={"params_version": rt.params_version,
                            "has_fisher": has_fisher})
        return out

    def recover(self, ckpt_dir: str) -> Dict[str, Dict]:
        """Crash recovery: per tenant, restore the newest COMPLETE
        checkpoint (incomplete step dirs — shard without META — are
        skipped by ``latest_step``) onto the tenant's device, then
        deterministically replay the WAL entries the restored version has
        not absorbed: never-applied accepts plus applies stamped with a
        params_version NEWER than the checkpoint.  Dead entries never
        replay.  A run killed between a WAL accept and its publication
        recovers bit for bit to the uninterrupted run's weights."""
        from repro_torch.ckpt import checkpoint as ckpt
        report: Dict[str, Dict] = {}
        for name, rt in self.tenants.items():
            if rt.spec.refresh is not None:
                raise ValueError(
                    f"Fleet.recover: tenant {name!r} has a RefreshSpec — "
                    "streamed-refresh EMA state is not checkpointed, so "
                    "replay would diverge; recovery supports refresh=None")
            tdir = os.path.join(ckpt_dir, name)
            step = ckpt.latest_step(tdir)
            version = 0
            if step is not None:
                with open(os.path.join(tdir, f"step_{step:08d}",
                                       "META.json")) as f:
                    head = json.load(f)
                like = {"params": rt.params}
                if head.get("has_fisher"):
                    # Fisher leaves mirror the param tree at f32 (the
                    # streaming estimator's dtype) — build the like-tree
                    # explicitly so restore can't cast it to a param dtype
                    like["fisher"] = tree_map(
                        lambda t: torch.empty(t.shape, dtype=torch.float32,
                                              device="meta"), rt.params)
                tree, meta = ckpt.restore(tdir, step, like,
                                          device=rt.device)
                version = int(meta["params_version"])
                rt.install_recovered(tree["params"], tree.get("fisher"),
                                     version)
            else:
                rt.install_recovered(rt.params, None, 0)
            replayed: List[int] = []
            if rt.wal is not None:
                recs = rt.wal.unapplied(up_to_version=version)
                by_batch: Dict[int, List[Dict]] = {}
                for r in recs:
                    by_batch.setdefault(r["due_batch"], []).append(r)
                # replay in the scheduler's order: due batch ascending,
                # WAL id (= admission order) within a batch
                for due in sorted(by_batch):
                    batch_recs = by_batch[due]
                    payloads = [r["payload"] for r in batch_recs]
                    params, ran = rt.run_due(rt.params, payloads, due)
                    if rt.last_violation is not None:
                        raise RuntimeError(
                            f"Fleet.recover: replaying tenant {name!r} WAL "
                            f"ids {[r['id'] for r in batch_recs]} hit guard "
                            f"{rt.last_violation['guard']!r} — the WAL "
                            "records a drain that no longer re-applies")
                    rt.params = params
                    if ran:
                        rt.params_version += 1
                    rt.applied_requests += len(payloads)
                    rt.wal.mark_applied([r["id"] for r in batch_recs],
                                        params_version=rt.params_version,
                                        batch=due)
                    replayed.extend(r["id"] for r in batch_recs)
            report[name] = {"restored_step": step,
                            "restored_version": version,
                            "replayed": replayed}
            _t.emit("fleet.recover", tenant=name, restored_step=step,
                    restored_version=version, replayed=replayed)
        return report

    def accounting(self) -> Dict[str, Dict[str, int]]:
        """Per-tenant conservation check: every ADMITTED request is
        exactly one of applied / pending / staged / dead (``ok`` asserts
        the invariant; rejects are accounted separately by the
        scheduler)."""
        out: Dict[str, Dict[str, int]] = {}
        for name, rt in self.tenants.items():
            submitted = self.scheduler.submits.get(name, 0)
            pending = self.scheduler.pending(name)
            dead = self.scheduler.dead(name)
            staged = sum(len(m["payloads"]) for m in rt._staged_meta)
            out[name] = {
                "submitted": submitted, "applied": rt.applied_requests,
                "pending": pending, "staged": staged, "dead": dead,
                "ok": submitted == (rt.applied_requests + pending
                                    + staged + dead)}
        return out

    # -- introspection ------------------------------------------------------
    def family_program_counts(self) -> Dict[Tuple, int]:
        """Cached-step count per namespace (adapter.name, n_layers, donate)
        — the unit of cross-tenant sharing.  Every cached step was built
        exactly once, so this IS the per-family build count."""
        counts: Dict[Tuple, int] = {}
        for k in self.programs.keys():
            ns = k[0]
            counts[ns] = counts.get(ns, 0) + 1
        return counts

    def stats(self) -> Dict[str, Any]:
        return {
            "tenants": {
                name: {"arch": rt.arch, "groups": rt.groups,
                       "sweeps": rt.sweeps,
                       "requests": len(rt.log),
                       "applied": rt.applied_requests,
                       "aborts": rt.aborts,
                       "refreshes": len(rt.refresh_log),
                       "wal": rt.wal.accounting()
                       if rt.wal is not None else None,
                       "engine": dict(rt.unlearner.stats)
                       if rt.unlearner is not None else {}}
                for name, rt in self.tenants.items()},
            "program_cache": self.programs.stats(),
            "families": {"/".join(map(str, ns)): n
                         for ns, n in self.family_program_counts().items()},
            "scheduler": self.scheduler.snapshot(),
            "accounting": self.accounting(),
        }
