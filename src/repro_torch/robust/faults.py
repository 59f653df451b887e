"""Seeded fault injection: deterministic chaos for the unlearning fleet
(port of ``repro.robust.faults``, the same sites and occurrence rules).

A ``FaultSpec`` names ONE injection site plus an occurrence window; a
``FaultInjector`` holds a set of specs and is consulted from the
instrumented sites via the process-wide ``fire(site, tenant)`` hook
(mirroring ``repro_torch.obs.telemetry``'s install/emitter pattern — a no-op
when nothing is installed, so production code pays one ``None`` check).

Determinism: occurrence counters, not clocks.  Each spec counts the
calls that match its ``site``/``tenant`` filter and fires on occurrences
``[at, at + count)``, so two runs of the same seeded scenario inject at
identical points and the load harness's event fingerprint stays
run-to-run identical under chaos.

Injection sites (each documented with its detection point in
DESIGN.md §16):

  * ``nan_batch``      — NaN poisons the forget-batch dampening
                         (engine/session.py, at ``forget_many`` entry);
  * ``fisher_corrupt`` — a corrupted global-Fisher tree feeds the sweep
                         (engine/session.py, same hook);
  * ``worker_exc``     — the shadow-sweep worker raises mid-drain
                         (fleet/fleet.py, ``TenantRuntime.run_due``);
  * ``deadline_miss``  — a publication misses its deterministic deadline
                         (fleet/fleet.py drain loop);
  * ``ckpt_crash``     — the checkpoint writer dies between the shard
                         write and the META.json commit point
                         (ckpt/checkpoint.py);
  * ``kill_mid_drain`` — the PROCESS is SIGKILLed at the top of a drain,
                         after WAL accept but before publication (the
                         crash-recovery proof; fleet/fleet.py).
"""
from __future__ import annotations

import dataclasses
import os
import signal
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs import telemetry as _t

SITES = ("nan_batch", "fisher_corrupt", "worker_exc", "deadline_miss",
         "ckpt_crash", "kill_mid_drain")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault: fire at matching occurrences
    ``[at, at + count)`` of ``site`` (optionally scoped to one tenant)."""
    site: str
    tenant: Optional[str] = None
    at: int = 0
    count: int = 1

    def __post_init__(self):
        _require(self.site in SITES,
                 f"FaultSpec.site must be one of {SITES}, got {self.site!r}")
        _require(self.tenant is None or isinstance(self.tenant, str),
                 f"FaultSpec.tenant must be a str or None, "
                 f"got {self.tenant!r}")
        for name, lo in (("at", 0), ("count", 1)):
            v = getattr(self, name)
            _require(isinstance(v, int) and not isinstance(v, bool)
                     and v >= lo,
                     f"FaultSpec.{name} must be an int >= {lo}, got {v!r}")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultSpec":
        _require(isinstance(d, dict),
                 f"FaultSpec.from_dict needs a dict, got {type(d).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        _require(not unknown,
                 f"FaultSpec.from_dict got unknown field(s) "
                 f"{sorted(unknown)}; known: {sorted(known)}")
        return cls(**d)


class FaultInjector:
    """Occurrence-counting injector over a frozen set of ``FaultSpec``s.

    ``fire(site, tenant)`` is called from the instrumented sites; it
    advances every matching spec's counter and reports whether any spec's
    window covers this occurrence.  Fired injections emit a
    ``fault.inject`` telemetry event and are recorded on ``self.fired``
    for test assertions.  ``kill_mid_drain`` does not return: it SIGKILLs
    the process (no cleanup handlers — that is the point)."""

    def __init__(self, specs=()):
        coerced = []
        for s in specs:
            if isinstance(s, dict):
                s = FaultSpec.from_dict(s)
            _require(isinstance(s, FaultSpec),
                     f"FaultInjector specs must be FaultSpec/dict, "
                     f"got {type(s).__name__}")
            coerced.append(s)
        self.specs: Tuple[FaultSpec, ...] = tuple(coerced)
        self._hits = [0] * len(self.specs)
        self.fired: List[Dict[str, Any]] = []

    def fire(self, site: str, tenant: Optional[str] = None) -> bool:
        _require(site in SITES,
                 f"FaultInjector.fire: unknown site {site!r} "
                 f"(known: {SITES})")
        hit = False
        for i, s in enumerate(self.specs):
            if s.site != site:
                continue
            if s.tenant is not None and s.tenant != tenant:
                continue
            occ = self._hits[i]
            self._hits[i] = occ + 1
            if s.at <= occ < s.at + s.count:
                hit = True
                self.fired.append({"site": site, "tenant": tenant,
                                   "occurrence": occ})
        if hit:
            _t.emit("fault.inject", site=site, tenant=tenant)
            if site == "kill_mid_drain":
                # the crash-recovery proof: die with no goodbye — durable
                # state is whatever the WAL/checkpoint already fsynced
                os.kill(os.getpid(), signal.SIGKILL)
        return hit


# -- process-wide hook (same shape as telemetry.install/emitter) ----------
_injector: Optional[FaultInjector] = None


def install(inj: Optional[FaultInjector]) -> Optional[FaultInjector]:
    """Install the process-wide injector; returns the previous one so
    callers can restore it (the load harness installs per run)."""
    global _injector
    _require(inj is None or isinstance(inj, FaultInjector),
             f"faults.install needs a FaultInjector or None, "
             f"got {type(inj).__name__}")
    prev, _injector = _injector, inj
    return prev


def injector() -> Optional[FaultInjector]:
    return _injector


def fire(site: str, tenant: Optional[str] = None) -> bool:
    """Consult the installed injector (False when none installed)."""
    if _injector is None:
        return False
    return _injector.fire(site, tenant)
