"""DrainScheduler — ONE cross-tenant multiplexer over N forget queues (port
of ``repro.fleet.scheduler``: the same decisions, counters and events).

Every tenant submits forget requests tagged with the serving batch index at
which they fall due (the context-adaptive deadline from the paper's serving
loop).  At each drain point the scheduler coalesces each tenant's due
requests into ONE drain group (the engine's ``forget_many`` path turns a
group into a single back-end-first sweep), then orders the groups across
tenants and — when ``max_groups`` caps how many groups one drain point may
run — decides who drains now and who stays queued.

Two ordering policies:

``deadline``  earliest due batch first (FIFO across tenants on ties).
              Simple, but a bursty tenant that keeps the oldest deadlines
              monopolizes every drain point.
``fair``      weighted fair-share via virtual time: each tenant carries
              ``served_work / weight``; the tenant with the LEAST virtual
              time drains first, and draining k requests advances it by
              ``k / weight``.  Under burst load a backlogged tenant's
              virtual time grows as it is served, so light tenants
              interleave instead of starving — the classic start-time
              fair-queueing argument, discretized to drain points.

ADMISSION CONTROL (backpressure): when the forget queue outruns drain
throughput, unbounded growth is the failure mode a serving process cannot
afford.  ``max_queue`` bounds each tenant's pending ENTRY count; on
overflow the declared ``admission`` policy decides:

``defer``   (default) the overflow request is still admitted, folded into
            the tenant's OLDEST pending entry: the entry keeps its original
            (oldest) deadline and submission time, so the merged work AGES
            rather than starves — under ``deadline`` the old due batch
            outranks fresh traffic, under ``fair`` the untouched virtual
            time does the same.  No request is ever dropped; the queue
            never exceeds the bound.
``reject``  the request is refused outright (``submit`` returns False) and
            a structured ``queue.reject`` telemetry event carries the
            accounting — the caller surfaces the rejection to the client.

Deferral past a drain point (the ``max_groups`` budget) likewise only ever
ages work: deferred entries keep their deadlines and virtual time, so both
policies pick them up at the next drain — asserted by
tests/test_scheduler_backpressure.py.

The scheduler is pure bookkeeping: no tensors, no model state, no
wall-clock reads.  The ``Fleet`` facade owns the engines and feeds selected groups
to them; every queue transition is mirrored onto the process telemetry
stream (``repro_torch.obs.telemetry``) when a capture is active.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs import telemetry as _t

POLICIES = ("fair", "deadline")
ADMISSION_POLICIES = ("defer", "reject")


@dataclasses.dataclass(frozen=True)
class _Pending:
    due_batch: int
    seq: int                    # global admission order — deterministic tie-break
    payloads: Tuple[Any, ...]   # >1 when overflow requests were folded in
    submitted: Optional[int] = None   # batch index at submission (queue age)
    retries: int = 0            # guarded-drain retry attempts so far


@dataclasses.dataclass(frozen=True)
class DrainGroup:
    """One tenant's coalesced work for one drain point."""
    tenant: str
    payloads: Tuple[Any, ...]
    due_batch: int    # earliest deadline in the group
    ages: Tuple[Optional[int], ...] = ()   # per-request queue age at drain
    # per-request submission batch (None when untracked) — a guard-aborted
    # group is requeued with these so retried work keeps AGING instead of
    # looking freshly submitted
    submitted: Tuple[Optional[int], ...] = ()
    retries: int = 0  # max retry count folded into this group

    def __len__(self) -> int:
        return len(self.payloads)


class DrainScheduler:
    def __init__(self, policy: str = "fair", *, max_groups: int = 0,
                 max_queue: int = 0, admission: str = "defer"):
        if policy not in POLICIES:
            raise ValueError(f"DrainScheduler policy must be one of "
                             f"{POLICIES}, got {policy!r}")
        if not isinstance(max_groups, int) or isinstance(max_groups, bool) \
                or max_groups < 0:
            raise ValueError(f"DrainScheduler max_groups must be an int >= 0"
                             f" (0 = no cap), got {max_groups!r}")
        if not isinstance(max_queue, int) or isinstance(max_queue, bool) \
                or max_queue < 0:
            raise ValueError(f"DrainScheduler max_queue must be an int >= 0 "
                             f"(0 = unbounded; N bounds each tenant's "
                             f"pending entries), got {max_queue!r}")
        if admission not in ADMISSION_POLICIES:
            raise ValueError(f"DrainScheduler admission must be one of "
                             f"{ADMISSION_POLICIES}, got {admission!r}")
        self.policy = policy
        self.max_groups = max_groups
        self.max_queue = max_queue
        self.admission = admission
        self._queues: Dict[str, List[_Pending]] = {}
        self._weights: Dict[str, float] = {}
        self._vtime: Dict[str, float] = {}
        self._seq = 0
        self.deferrals = 0   # groups that were due but pushed past a drain
        self.deferred_by: Dict[str, int] = {}
        self.rejects: Dict[str, int] = {}   # admission="reject" refusals
        self.merges: Dict[str, int] = {}    # admission="defer" aging folds
        self.submits: Dict[str, int] = {}   # ADMITTED requests (enq + merge)
        self.requeues: Dict[str, int] = {}  # guard-abort retry re-entries
        self._dead: Dict[str, List[Dict[str, Any]]] = {}  # dead-letter queues

    # -- tenant registry ----------------------------------------------------
    def register(self, tenant: str, weight: float = 1.0) -> None:
        if not isinstance(tenant, str) or not tenant:
            raise ValueError(f"tenant name must be a non-empty string, "
                             f"got {tenant!r}")
        if tenant in self._queues:
            raise ValueError(f"tenant {tenant!r} is already registered "
                             f"with this scheduler")
        if not (isinstance(weight, (int, float))
                and not isinstance(weight, bool) and weight > 0):
            raise ValueError(f"tenant {tenant!r} weight must be > 0, "
                             f"got {weight!r}")
        self._queues[tenant] = []
        self._weights[tenant] = float(weight)
        self.deferred_by[tenant] = 0
        self.rejects[tenant] = 0
        self.merges[tenant] = 0
        self.submits[tenant] = 0
        self.requeues[tenant] = 0
        self._dead[tenant] = []
        # a newcomer starts at the floor of live virtual times so it cannot
        # claim an unbounded "catch-up" backlog against long-running tenants
        self._vtime[tenant] = min(self._vtime.values(), default=0.0)

    def tenants(self) -> Tuple[str, ...]:
        return tuple(self._queues)

    # -- queue --------------------------------------------------------------
    def submit(self, tenant: str, payload: Any, due_batch: int,
               *, now: Optional[int] = None) -> bool:
        """Enqueue one forget request; returns True when admitted.

        ``now`` is the submission batch index on the virtual clock (None
        when the caller doesn't track one) — it feeds the queue-age
        telemetry and SLO accounting.  Under a full bounded queue the
        admission policy decides: ``defer`` folds the request into the
        oldest pending entry (admitted, aged), ``reject`` refuses it
        (returns False, emits a structured ``queue.reject`` event).
        """
        if tenant not in self._queues:
            raise ValueError(f"unknown tenant {tenant!r}; registered: "
                             f"{sorted(self._queues)}")
        if not isinstance(due_batch, int) or isinstance(due_batch, bool):
            raise ValueError(f"due_batch must be an int batch index, "
                             f"got {due_batch!r}")
        if now is not None and (not isinstance(now, int)
                                or isinstance(now, bool) or now < 0):
            raise ValueError(f"submit now= must be None or an int batch "
                             f"index >= 0, got {now!r}")
        q = self._queues[tenant]
        if self.max_queue and len(q) >= self.max_queue:
            if self.admission == "reject":
                self.rejects[tenant] += 1
                _t.emit("queue.reject", tenant=tenant, payload=payload,
                        due_batch=due_batch, depth=len(q), submitted=now)
                return False
            # defer-with-aging: fold into the OLDEST entry — the merged
            # request inherits that entry's due batch and submission time,
            # so backpressure makes work OLDER, never invisible
            idx = min(range(len(q)), key=lambda i: q[i].seq)
            old = q[idx]
            q[idx] = _Pending(
                due_batch=min(old.due_batch, due_batch), seq=old.seq,
                payloads=old.payloads + (payload,),
                submitted=old.submitted if old.submitted is not None
                else now)
            self.merges[tenant] += 1
            self.submits[tenant] += 1
            self._seq += 1
            _t.emit("queue.merge", tenant=tenant, payload=payload,
                    due_batch=due_batch, merged_due=q[idx].due_batch,
                    depth=len(q), submitted=now)
            return True
        q.append(_Pending(due_batch, self._seq, (payload,), now))
        self.submits[tenant] += 1
        self._seq += 1
        _t.emit("queue.enqueue", tenant=tenant, payload=payload,
                due_batch=due_batch, depth=len(q), submitted=now)
        return True

    def requeue(self, tenant: str, payloads, due_batch: int, *,
                submitted=None, retries: int = 1,
                reason: str = "guard") -> None:
        """Re-enter a guard-aborted drain group for retry at ``due_batch``.

        Deliberately BYPASSES admission control and the submit counter:
        the requests were already admitted (and counted) once, so a full
        queue must not reject or re-count them — the accounting invariant
        ``submitted == applied + pending + dead`` depends on it.  Each
        payload keeps its original submission batch (``submitted``) so a
        retried request keeps aging; under both policies aged work
        outranks fresh traffic rather than starving behind it.
        """
        if tenant not in self._queues:
            raise ValueError(f"unknown tenant {tenant!r}; registered: "
                             f"{sorted(self._queues)}")
        payloads = tuple(payloads)
        if not payloads:
            raise ValueError("requeue needs at least one payload — an "
                             "empty retry group is a caller bug")
        if not isinstance(due_batch, int) or isinstance(due_batch, bool):
            raise ValueError(f"requeue due_batch must be an int batch "
                             f"index, got {due_batch!r}")
        if not isinstance(retries, int) or isinstance(retries, bool) \
                or retries < 0:
            raise ValueError(f"requeue retries must be an int >= 0 (the "
                             f"attempt count carried forward; 0 when a "
                             f"deadline miss requeues without burning a "
                             f"retry), got {retries!r}")
        submitted = (tuple(submitted) if submitted is not None
                     else (None,) * len(payloads))
        if len(submitted) != len(payloads):
            raise ValueError(
                f"requeue submitted= must align with payloads "
                f"({len(submitted)} vs {len(payloads)})")
        # one entry per original submission time: age bookkeeping survives
        # the retry round-trip exactly
        for sub in sorted({s for s in submitted},
                          key=lambda s: (s is None, s)):
            pl = tuple(p for p, s in zip(payloads, submitted) if s == sub)
            self._queues[tenant].append(
                _Pending(due_batch, self._seq, pl, sub, retries))
            self._seq += 1
        self.requeues[tenant] += 1
        _t.emit("queue.requeue", tenant=tenant, n=len(payloads),
                due_batch=due_batch, retries=retries, reason=reason,
                depth=len(self._queues[tenant]))

    def dead_letter(self, tenant: str, payloads, *, reason: str,
                    submitted=None, batch=None) -> None:
        """Terminal parking for retries-exhausted requests: full
        accounting, no silent loss — ``submitted == applied + pending +
        dead`` counts these in ``dead``."""
        if tenant not in self._queues:
            raise ValueError(f"unknown tenant {tenant!r}; registered: "
                             f"{sorted(self._queues)}")
        payloads = list(payloads)
        if not payloads:
            raise ValueError("dead_letter needs at least one payload")
        self._dead[tenant].append({
            "payloads": payloads, "reason": str(reason),
            "submitted": list(submitted) if submitted is not None else None,
            "batch": batch})
        _t.emit("queue.dead_letter", tenant=tenant, n=len(payloads),
                payloads=payloads, reason=str(reason), batch=batch)

    def dead(self, tenant: Optional[str] = None) -> int:
        """Dead-lettered REQUEST count (per tenant or fleet-wide)."""
        if tenant is not None:
            return sum(len(e["payloads"])
                       for e in self._dead.get(tenant, ()))
        return sum(len(e["payloads"])
                   for q in self._dead.values() for e in q)

    def dead_entries(self, tenant: str) -> List[Dict[str, Any]]:
        """Read-only view of one tenant's dead-letter queue."""
        return [dict(e) for e in self._dead.get(tenant, ())]

    def pending(self, tenant: Optional[str] = None) -> int:
        """Queued REQUEST count (folded entries count every payload)."""
        if tenant is not None:
            return sum(len(p.payloads) for p in self._queues.get(tenant, ()))
        return sum(len(p.payloads)
                   for q in self._queues.values() for p in q)

    def queue_depth(self, tenant: str) -> int:
        """Pending ENTRY count — the quantity ``max_queue`` bounds."""
        return len(self._queues.get(tenant, ()))

    def next_due(self) -> Optional[int]:
        dues = [p.due_batch for q in self._queues.values() for p in q]
        return min(dues) if dues else None

    def pending_entries(self, tenant: str) -> List[Dict[str, Any]]:
        """Public read-only view of one tenant's queue, in admission order.

        Each queued REQUEST becomes one dict (folded defer-with-aging
        entries are expanded, so the list length matches ``pending``):
        ``{"payload", "due_batch", "submitted"}``.  This is the sanctioned
        way to inspect queue contents — ``_queues`` is private.
        """
        entries: List[Dict[str, Any]] = []
        for p in sorted(self._queues.get(tenant, ()), key=lambda p: p.seq):
            for x in p.payloads:
                entries.append({"payload": x, "due_batch": p.due_batch,
                                "submitted": p.submitted})
        return entries

    def oldest_age(self, tenant: str, batch_idx: int) -> Optional[int]:
        """Age (in batches) of the tenant's oldest tracked submission.

        Clamped at 0: a request submitted with ``now > batch_idx`` (clock
        skew between the submitting caller and the drain point) would
        otherwise report a NEGATIVE age and corrupt downstream SLO
        accounting.  Skew is surfaced as a ``queue.age_skew`` event rather
        than propagated.
        """
        subs = [p.submitted for p in self._queues.get(tenant, ())
                if p.submitted is not None]
        if not subs:
            return None
        raw = batch_idx - min(subs)
        if raw < 0:
            _t.emit("queue.age_skew", tenant=tenant, batch_idx=batch_idx,
                    submitted=min(subs), raw_age=raw)
        return max(raw, 0)

    # -- the drain decision -------------------------------------------------
    def due_groups(self, batch_idx) -> List[DrainGroup]:
        """Pop and return the drain groups to run at ``batch_idx``.

        Coalesces each tenant's due requests (due_batch <= batch_idx) into
        one group, orders groups by the scheduling policy, and enforces the
        ``max_groups`` budget — deferred tenants keep their requests queued
        (their deadlines only get older, so they outrank fresh work at the
        next drain under ``deadline``, and their untouched virtual time
        does the same under ``fair``).
        """
        candidates: List[Tuple[str, List[_Pending]]] = []
        for tenant, q in self._queues.items():
            due = [p for p in q if p.due_batch <= batch_idx]
            if due:
                candidates.append((tenant, due))
        if not candidates:
            return []

        if self.policy == "deadline":
            candidates.sort(key=lambda c: (min(p.due_batch for p in c[1]),
                                           min(p.seq for p in c[1])))
        else:  # fair: least virtual time first
            candidates.sort(key=lambda c: (self._vtime[c[0]],
                                           min(p.due_batch for p in c[1]),
                                           min(p.seq for p in c[1])))

        if self.max_groups > 0 and len(candidates) > self.max_groups:
            deferred = candidates[self.max_groups:]
            self.deferrals += len(deferred)
            for tenant, due in deferred:
                self.deferred_by[tenant] += 1
                _t.emit("queue.defer", tenant=tenant,
                        pending=sum(len(p.payloads) for p in due),
                        oldest_due=min(p.due_batch for p in due))
            candidates = candidates[:self.max_groups]

        finite = isinstance(batch_idx, int) and not isinstance(batch_idx,
                                                               bool) \
            or (isinstance(batch_idx, float) and math.isfinite(batch_idx))
        groups: List[DrainGroup] = []
        for tenant, due in candidates:
            taken = set(id(p) for p in due)
            self._queues[tenant] = [p for p in self._queues[tenant]
                                    if id(p) not in taken]
            due.sort(key=lambda p: p.seq)
            payloads: List[Any] = []
            ages: List[Optional[int]] = []
            submitted: List[Optional[int]] = []
            for p in due:
                age = (int(batch_idx) - p.submitted
                       if finite and p.submitted is not None else None)
                if age is not None and age < 0:
                    # clock skew: submitted "in the future" relative to the
                    # drain point — clamp so SLO math never sees a negative
                    _t.emit("queue.age_skew", tenant=tenant,
                            batch_idx=int(batch_idx),
                            submitted=p.submitted, raw_age=age)
                    age = 0
                for x in p.payloads:
                    payloads.append(x)
                    ages.append(age)
                    submitted.append(p.submitted)
            self._vtime[tenant] += len(payloads) / self._weights[tenant]
            groups.append(DrainGroup(
                tenant=tenant,
                payloads=tuple(payloads),
                due_batch=min(p.due_batch for p in due),
                ages=tuple(ages),
                submitted=tuple(submitted),
                retries=max(p.retries for p in due)))
        return groups

    def snapshot(self) -> Dict[str, Any]:
        return {"policy": self.policy, "max_groups": self.max_groups,
                "max_queue": self.max_queue, "admission": self.admission,
                "deferrals": self.deferrals,
                "deferred_by": dict(self.deferred_by),
                "rejects": dict(self.rejects),
                "merges": dict(self.merges),
                "submits": dict(self.submits),
                "requeues": dict(self.requeues),
                "dead": {t: self.dead(t) for t in self._queues},
                "pending": {t: self.pending(t) for t in self._queues},
                "queue_depth": {t: len(q)
                                for t, q in self._queues.items()},
                "vtime": dict(self._vtime)}
