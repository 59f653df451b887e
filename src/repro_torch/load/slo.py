"""Declarative SLO specs for the unlearning serving stack (port of
``repro.load.slo``).

An SLO objective is a bound on a metric the harness summary (or the report
tool's event aggregation) already computes; ``SLOSpec.evaluate`` turns a
summary dict into per-objective PASS/FAIL rows plus an overall attainment
fraction — the number the load bench gates in CI.  Unset objectives
(``None``) simply don't participate, so one spec type covers smoke gates
and production-shaped deployments alike.

All targets except ``forget_p99_s`` are expressed over the VIRTUAL clock
(batches/ticks) and are therefore deterministic; ``forget_p99_s`` bounds a
wall-clock latency percentile and is the one machine-dependent objective —
leave it None in seeded determinism tests.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, List, Optional

from repro_torch.api.specs import _require


def _opt_num(name: str, v, lo: float = 0.0) -> None:
    _require(v is None or (isinstance(v, (int, float))
                           and not isinstance(v, bool)
                           and math.isfinite(v) and v >= lo),
             f"SLOSpec.{name} must be None or a finite number >= {lo}, "
             f"got {v!r}")


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Service-level objectives for a fleet under erasure load.

    ``max_queue_age_p99``    p99 of per-request forget-queue age at drain
                             (virtual batches between submission and the
                             drain that served it).
    ``max_queue_depth``      the per-tenant pending-queue depth may never
                             exceed this (the bounded-queue contract).
    ``min_drain_throughput`` drained forget requests per virtual tick,
                             fleet-wide (the drain floor).
    ``max_reject_fraction``  rejected / submitted forget requests (only
                             meaningful under ``admission="reject"``).
    ``max_steady_compiles``  program compiles after the warmup phase (0 =
                             the zero-warm-compile pin under load).
    ``forget_p99_s``         wall-clock p99 of drain latency (machine
                             dependent; None for deterministic gates).
    ``max_dead_letter_fraction``  dead-lettered / submitted forget
                             requests (the guarded-drain terminal-failure
                             budget; 0 pins "no request permanently
                             fails" in non-chaos runs).
    """
    max_queue_age_p99: Optional[float] = None
    max_queue_depth: Optional[int] = None
    min_drain_throughput: Optional[float] = None
    max_reject_fraction: Optional[float] = None
    max_steady_compiles: Optional[int] = None
    forget_p99_s: Optional[float] = None
    max_dead_letter_fraction: Optional[float] = None

    def __post_init__(self):
        _opt_num("max_queue_age_p99", self.max_queue_age_p99)
        _require(self.max_queue_depth is None
                 or (isinstance(self.max_queue_depth, int)
                     and not isinstance(self.max_queue_depth, bool)
                     and self.max_queue_depth >= 1),
                 f"SLOSpec.max_queue_depth must be None or an int >= 1, "
                 f"got {self.max_queue_depth!r}")
        _opt_num("min_drain_throughput", self.min_drain_throughput)
        _require(self.max_reject_fraction is None
                 or (isinstance(self.max_reject_fraction, (int, float))
                     and not isinstance(self.max_reject_fraction, bool)
                     and 0 <= float(self.max_reject_fraction) <= 1),
                 f"SLOSpec.max_reject_fraction must be None or in [0, 1], "
                 f"got {self.max_reject_fraction!r}")
        _require(self.max_steady_compiles is None
                 or (isinstance(self.max_steady_compiles, int)
                     and not isinstance(self.max_steady_compiles, bool)
                     and self.max_steady_compiles >= 0),
                 f"SLOSpec.max_steady_compiles must be None or an int >= 0, "
                 f"got {self.max_steady_compiles!r}")
        _opt_num("forget_p99_s", self.forget_p99_s)
        _require(self.max_dead_letter_fraction is None
                 or (isinstance(self.max_dead_letter_fraction, (int, float))
                     and not isinstance(self.max_dead_letter_fraction, bool)
                     and 0 <= float(self.max_dead_letter_fraction) <= 1),
                 f"SLOSpec.max_dead_letter_fraction must be None or in "
                 f"[0, 1], got {self.max_dead_letter_fraction!r}")

    # -- JSON round trip ----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Any) -> "SLOSpec":
        _require(isinstance(d, dict),
                 f"SLOSpec.from_dict expects a mapping, "
                 f"got {type(d).__name__}")
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        _require(not unknown,
                 f"unknown SLOSpec field(s) {sorted(unknown)}; expected a "
                 f"subset of {sorted(fields)}")
        return cls(**d)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "SLOSpec":
        try:
            d = json.loads(s)
        except json.JSONDecodeError as e:
            raise ValueError(f"SLOSpec.from_json: not valid JSON: {e}") \
                from e
        return cls.from_dict(d)

    # -- evaluation ---------------------------------------------------------
    def evaluate(self, summary: Dict[str, Any]) -> Dict[str, Any]:
        """Score a harness/report summary against the declared objectives.

        ``summary`` is the dict ``LoadHarness.run`` (or
        ``repro_torch.obs.report.summarize``) produces; objectives read the
        fleet-wide rollup keys.  Returns ``{"objectives": [...],
        "attained": fraction, "ok": bool}`` — an unset objective is not an
        objective, and a metric the summary lacks FAILS its objective
        (silent absence must not look like attainment).
        """
        fleet = summary.get("fleet", summary)
        rows: List[Dict[str, Any]] = []

        def bound(name: str, target, actual, *, upper: bool = True):
            if target is None:
                return
            ok = (actual is not None
                  and (actual <= target if upper else actual >= target))
            rows.append({"objective": name, "target": target,
                         "actual": actual, "ok": bool(ok)})

        ages = fleet.get("queue_age", {})
        bound("queue_age_p99 <= max", self.max_queue_age_p99,
              ages.get("p99"))
        bound("queue_depth_max <= max", self.max_queue_depth,
              fleet.get("queue_depth_max"))
        bound("drain_throughput >= min", self.min_drain_throughput,
              fleet.get("drain_throughput"), upper=False)
        submitted = fleet.get("submitted")
        rejected = fleet.get("rejected")
        frac = (rejected / submitted
                if submitted and rejected is not None else
                (0.0 if rejected == 0 else None))
        bound("reject_fraction <= max", self.max_reject_fraction, frac)
        bound("steady_state_compiles <= max", self.max_steady_compiles,
              fleet.get("steady_state_compiles"))
        lat = fleet.get("drain_latency_s", {})
        bound("forget_p99_s <= max", self.forget_p99_s, lat.get("p99"))
        dead = fleet.get("dead_letters")
        dfrac = (dead / submitted
                 if submitted and dead is not None else
                 (0.0 if dead == 0 else None))
        bound("dead_letter_fraction <= max", self.max_dead_letter_fraction,
              dfrac)

        attained = (sum(1 for r in rows if r["ok"]) / len(rows)
                    if rows else 1.0)
        return {"objectives": rows, "attained": attained,
                "ok": all(r["ok"] for r in rows)}
