"""Fleet specs — the declarative vocabulary of a multi-tenant deployment
(port of ``repro.fleet.specs``: the same fields, validation and JSON).

A FiCABU serving process hosts N *tenants*: each a served model family +
its own adapter weights, unlearning configuration (``UnlearnSpec``), forget
queue, and tenant-scoped Fisher state.  ``TenantSpec`` declares one tenant,
``FleetSpec`` the whole deployment (tenants + the shared ``ServeSpec`` +
the drain-scheduling policy).  Both are frozen dataclasses with JSON
round-trip (``to_json``/``from_json``) and ``ValueError`` validation with
actionable messages — the same discipline as ``repro_torch.api.specs`` —
so a fleet file is a complete, auditable description of what the process
serves. Archs are checked against ``repro_torch.configs``. The
compilation-cache directory is not ported yet (ROADMAP Queue 1, "The
persistent compilation cache"):
``ServeSpec.cache_dir`` and ``ExecSpec.cache_dir`` accept None only, so
the reference's per-tenant cache-dir conflict cannot arise here.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, Optional, Tuple

from repro_torch.api.specs import ServeSpec, UnlearnSpec, _require
from repro_torch.robust.guards import GuardSpec

SCHEDULING_POLICIES = ("fair", "deadline")
ADMISSION_POLICIES = ("defer", "reject")


def _known_arch(arch: str) -> None:
    from repro_torch import configs
    names = tuple(configs.all_archs())
    _require(arch in names,
             f"TenantSpec.arch {arch!r} is not a known architecture; "
             f"pick one of {names} (repro_torch.configs)")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One served tenant: identity + model family + unlearning config.

    ``name``    unique tenant id within the fleet (queue/routing key, and
                the label every diagnostic and error message carries).
    ``arch``    model family — a ``repro_torch.configs`` architecture key.
                Tenants sharing an arch are SAME-FAMILY: their adapters
                have identical layer-kind+shape signatures, so the fleet's
                shared program cache compiles each engine program once for
                all of them.
    ``seed``    per-tenant adapter-weight / synthetic-data seed (distinct
                seeds = distinct weights even within a family — sharing
                compiled programs never shares parameters).
    ``weight``  fair-share weight for the drain scheduler (2.0 drains twice
                as often as 1.0 under contention).
    ``spec``    the tenant's ``UnlearnSpec`` (None: derive from the fleet's
                ``ServeSpec`` at build time) — per-tenant precision
                (fp32/int8), dampening and halting all live here.
    """
    name: str
    arch: str = "gemma3-1b"
    seed: int = 0
    weight: float = 1.0
    spec: Optional[UnlearnSpec] = None

    def __post_init__(self):
        _require(isinstance(self.name, str) and self.name,
                 f"TenantSpec.name must be a non-empty string, "
                 f"got {self.name!r}")
        _require(isinstance(self.arch, str) and self.arch,
                 f"TenantSpec.arch must be a non-empty repro_torch.configs "
                 f"key, "
                 f"got {self.arch!r}")
        _known_arch(self.arch)
        _require(isinstance(self.seed, int)
                 and not isinstance(self.seed, bool) and self.seed >= 0,
                 f"TenantSpec.seed must be an int >= 0, got {self.seed!r}")
        _require(isinstance(self.weight, (int, float))
                 and not isinstance(self.weight, bool)
                 and math.isfinite(self.weight) and self.weight > 0,
                 f"TenantSpec.weight must be a finite number > 0 (the "
                 f"fair-share drain weight), got {self.weight!r}")
        if isinstance(self.spec, dict):
            object.__setattr__(self, "spec",
                               UnlearnSpec.from_dict(self.spec))
        _require(self.spec is None or isinstance(self.spec, UnlearnSpec),
                 f"TenantSpec.spec must be None (derive from the fleet's "
                 f"ServeSpec), an UnlearnSpec, or a mapping of its fields, "
                 f"got {type(self.spec).__name__}")

    # -- JSON round trip ----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name, "arch": self.arch,
                             "seed": self.seed, "weight": self.weight}
        d["spec"] = None if self.spec is None else self.spec.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Any) -> "TenantSpec":
        _require(isinstance(d, dict),
                 f"TenantSpec.from_dict expects a mapping, "
                 f"got {type(d).__name__}")
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        _require(not unknown,
                 f"unknown TenantSpec field(s) {sorted(unknown)}; expected "
                 f"a subset of {sorted(fields)}")
        kw = dict(d)
        if isinstance(kw.get("spec"), dict):
            kw["spec"] = UnlearnSpec.from_dict(kw["spec"])
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """The whole multi-tenant deployment: tenants + serving config + the
    drain-scheduling policy.

    ``scheduling``  cross-tenant drain ordering — ``"fair"`` (weighted
                    fair-share by served work; a bursty tenant cannot
                    starve the others) or ``"deadline"`` (oldest due batch
                    first, FIFO across tenants).
    ``max_groups_per_drain``  at most this many tenant drain groups run per
                    drain point (0 = every due tenant drains); deferred
                    tenants stay queued — this is what makes the
                    scheduling policy bite under burst load.
    ``max_queue_per_tenant``  admission control: bound on each tenant's
                    pending forget-queue entries (0 = unbounded).  The
                    bound is what keeps a serving process's memory and
                    queue age finite under overload.
    ``admission``   what happens to a submit that would overflow the bound:
                    ``"defer"`` folds it into the tenant's oldest pending
                    entry (admitted, ages with it — never starves),
                    ``"reject"`` refuses it with a structured telemetry
                    event (the caller surfaces the refusal).
    ``guard``       fleet-wide default drain guard (``repro_torch.robust.
                    GuardSpec``): every tenant whose own spec does not set
                    ``exec.guard`` validates its drained tree against this
                    one before any publication/commit.  None = unguarded
                    (the historical behaviour).
    ``wal_dir``     root directory of the per-tenant durable forget-request
                    WALs (``<wal_dir>/<tenant>/forget_wal.jsonl``): every
                    accepted request is journaled before it can drain
                    (replay after a crash: ``Fleet.recover``).  None = no
                    durability (the historical behaviour).
    """
    tenants: Tuple[TenantSpec, ...] = ()
    serve: ServeSpec = ServeSpec()
    scheduling: str = "fair"
    max_groups_per_drain: int = 0
    max_queue_per_tenant: int = 0
    admission: str = "defer"
    guard: Optional[GuardSpec] = None
    wal_dir: Optional[str] = None

    def __post_init__(self):
        tenants = self.tenants
        _require(isinstance(tenants, (tuple, list)) and len(tenants) >= 1,
                 "FleetSpec.tenants must be a non-empty sequence of "
                 "TenantSpec (a fleet with no tenants serves nothing)")
        coerced = []
        for i, t in enumerate(tenants):
            if isinstance(t, dict):
                t = TenantSpec.from_dict(t)
            _require(isinstance(t, TenantSpec),
                     f"FleetSpec.tenants[{i}] must be a TenantSpec (or a "
                     f"mapping of its fields), got {type(t).__name__}")
            coerced.append(t)
        object.__setattr__(self, "tenants", tuple(coerced))
        names = [t.name for t in self.tenants]
        dupes = sorted({n for n in names if names.count(n) > 1})
        _require(not dupes,
                 f"FleetSpec tenant names must be unique (they key queues "
                 f"and routing); duplicated: {dupes}")
        if isinstance(self.serve, dict):
            object.__setattr__(self, "serve",
                               ServeSpec.from_dict(self.serve))
        _require(isinstance(self.serve, ServeSpec),
                 f"FleetSpec.serve must be a ServeSpec (or a mapping of its "
                 f"fields), got {type(self.serve).__name__}")
        _require(self.scheduling in SCHEDULING_POLICIES,
                 f"FleetSpec.scheduling must be one of "
                 f"{SCHEDULING_POLICIES}, got {self.scheduling!r}")
        _require(isinstance(self.max_groups_per_drain, int)
                 and not isinstance(self.max_groups_per_drain, bool)
                 and self.max_groups_per_drain >= 0,
                 f"FleetSpec.max_groups_per_drain must be an int >= 0 "
                 f"(0 = drain every due tenant), "
                 f"got {self.max_groups_per_drain!r}")
        _require(isinstance(self.max_queue_per_tenant, int)
                 and not isinstance(self.max_queue_per_tenant, bool)
                 and self.max_queue_per_tenant >= 0,
                 f"FleetSpec.max_queue_per_tenant must be an int >= 0 "
                 f"(0 = unbounded queue), "
                 f"got {self.max_queue_per_tenant!r}")
        _require(self.admission in ADMISSION_POLICIES,
                 f"FleetSpec.admission must be one of {ADMISSION_POLICIES},"
                 f" got {self.admission!r}")
        if isinstance(self.guard, dict):
            object.__setattr__(self, "guard", GuardSpec.from_dict(self.guard))
        _require(self.guard is None or isinstance(self.guard, GuardSpec),
                 f"FleetSpec.guard must be None or a "
                 f"repro_torch.robust.GuardSpec (or a mapping of its fields), "
                 f"got {type(self.guard).__name__}")
        _require(self.wal_dir is None
                 or (isinstance(self.wal_dir, str) and self.wal_dir),
                 f"FleetSpec.wal_dir must be None or a non-empty path, "
                 f"got {self.wal_dir!r}")

    def tenant(self, name: str) -> TenantSpec:
        for t in self.tenants:
            if t.name == name:
                return t
        raise ValueError(f"no tenant {name!r} in this fleet; declared: "
                         f"{[t.name for t in self.tenants]}")

    def tenant_unlearn_spec(self, name: str) -> UnlearnSpec:
        """The tenant's effective ``UnlearnSpec``: its own if declared,
        otherwise derived from the fleet's ``ServeSpec``."""
        t = self.tenant(name)
        return t.spec if t.spec is not None else self.serve.to_unlearn_spec()

    # -- JSON round trip ----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {"tenants": [t.to_dict() for t in self.tenants],
                "serve": self.serve.to_dict(),
                "scheduling": self.scheduling,
                "max_groups_per_drain": self.max_groups_per_drain,
                "max_queue_per_tenant": self.max_queue_per_tenant,
                "admission": self.admission,
                "guard": None if self.guard is None else self.guard.to_dict(),
                "wal_dir": self.wal_dir}

    @classmethod
    def from_dict(cls, d: Any) -> "FleetSpec":
        _require(isinstance(d, dict),
                 f"FleetSpec.from_dict expects a mapping, "
                 f"got {type(d).__name__}")
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        _require(not unknown,
                 f"unknown FleetSpec field(s) {sorted(unknown)}; expected "
                 f"a subset of {sorted(fields)}")
        kw = dict(d)
        if "tenants" in kw:
            _require(isinstance(kw["tenants"], (list, tuple)),
                     f"FleetSpec.tenants must be a sequence, "
                     f"got {type(kw['tenants']).__name__}")
            kw["tenants"] = tuple(
                t if isinstance(t, TenantSpec) else TenantSpec.from_dict(t)
                for t in kw["tenants"])
        if isinstance(kw.get("serve"), dict):
            kw["serve"] = ServeSpec.from_dict(kw["serve"])
        if isinstance(kw.get("guard"), dict):
            kw["guard"] = GuardSpec.from_dict(kw["guard"])
        return cls(**kw)

    def to_json(self, **json_kw) -> str:
        return json.dumps(self.to_dict(), **json_kw)

    @classmethod
    def from_json(cls, s: str) -> "FleetSpec":
        try:
            d = json.loads(s)
        except json.JSONDecodeError as e:
            raise ValueError(f"FleetSpec.from_json: not valid JSON: {e}") \
                from e
        return cls.from_dict(d)

    @classmethod
    def from_file(cls, path: str) -> "FleetSpec":
        try:
            with open(path) as f:
                s = f.read()
        except OSError as e:
            raise ValueError(f"FleetSpec.from_file: cannot read {path!r}: "
                             f"{e}") from e
        return cls.from_json(s)
