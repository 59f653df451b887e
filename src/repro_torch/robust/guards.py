"""Drain guards: validate an edited tree BEFORE it can be published (port
of ``repro.robust.guards``: the same checks, order and verdicts).

A ``GuardSpec`` is the fleet's failure model for numeric faults: a drain
produces a candidate tree (in place or on the shadow), the guard checks it
against the tree the drain started from, and only a passing candidate may
be committed / staged for publication.  A failing candidate is discarded —
the live tree keeps serving — and the drain's requests go back through the
``DrainScheduler`` with a deterministic retry budget and virtual-clock
backoff (``repro_torch.fleet.Fleet`` owns that loop; this module only decides
pass/fail).

Checks, in evaluation order (first violation wins):

  * ``finite``            — every leaf all-finite (NaN/Inf in a forget
                            batch or a corrupted Fisher leaf lands here);
  * ``max_layer_rel_edit`` — per-leaf relative Frobenius edit magnitude
                            ``||new - ref|| / max(||ref||, eps)`` bounded
                            (a near-zeroed layer from a degenerate
                            selection mask lands here);
  * ``retain_floor``      — retain-probe accuracy of the edited tree must
                            stay at or above the floor (catastrophic
                            forgetting of retained behaviour lands here).
                            Needs a ``probe`` callback — the tenant
                            runtime supplies one scoring a held-out
                            retain batch.

All thresholds are frozen spec state (JSON round-trip like the rest of
``repro_torch.api``): two runs of the same scenario make identical
publish/abort decisions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.models.module import flatten_with_paths

GUARD_KINDS = ("finite", "edit_magnitude", "retain_floor")
_REL_EPS = 1e-12


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _leaf_f32(leaf) -> np.ndarray:
    # one host round-trip per leaf; f32 covers every served dtype (bf16 /
    # int8-fake-quant trees upcast losslessly for the norm/finite checks)
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to(device="cpu", dtype=torch.float32).numpy()
    return np.asarray(leaf, dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class GuardSpec:
    """Frozen pre-publication validation + retry policy for drains.

    ``max_retries`` and ``backoff_batches`` live here (not on the
    scheduler) because the retry budget is part of the tenant's declared
    failure contract: attempt k is requeued ``backoff_batches * k``
    batches out (linear virtual-clock backoff), and after ``max_retries``
    failed retries the requests land in the scheduler's per-tenant
    dead-letter queue.
    """
    finite: bool = True
    max_layer_rel_edit: Optional[float] = None
    retain_floor: Optional[float] = None
    max_retries: int = 1
    backoff_batches: int = 1

    def __post_init__(self):
        _require(isinstance(self.finite, bool),
                 f"GuardSpec.finite must be a bool, got {self.finite!r}")
        for name in ("max_layer_rel_edit", "retain_floor"):
            v = getattr(self, name)
            if v is None:
                continue
            _require(isinstance(v, (int, float)) and not isinstance(v, bool)
                     and v == v and float(v) > 0,
                     f"GuardSpec.{name} must be a positive finite number "
                     f"or None, got {v!r}")
            object.__setattr__(self, name, float(v))
        _require(isinstance(self.max_retries, int)
                 and not isinstance(self.max_retries, bool)
                 and self.max_retries >= 0,
                 f"GuardSpec.max_retries must be an int >= 0, "
                 f"got {self.max_retries!r}")
        _require(isinstance(self.backoff_batches, int)
                 and not isinstance(self.backoff_batches, bool)
                 and self.backoff_batches >= 1,
                 f"GuardSpec.backoff_batches must be an int >= 1, "
                 f"got {self.backoff_batches!r}")
        _require(self.finite or self.max_layer_rel_edit is not None
                 or self.retain_floor is not None,
                 "GuardSpec with every check disabled guards nothing — "
                 "enable finite, max_layer_rel_edit, or retain_floor")

    # -- serialization (same posture as repro.api.specs) -------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GuardSpec":
        _require(isinstance(d, dict),
                 f"GuardSpec.from_dict needs a dict, got {type(d).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        _require(not unknown,
                 f"GuardSpec.from_dict got unknown field(s) "
                 f"{sorted(unknown)}; known: {sorted(known)}")
        return cls(**d)

    # -- the check ---------------------------------------------------------
    def check(self, reference, edited, *,
              probe: Optional[Callable[[Any], float]] = None
              ) -> Optional[Dict[str, Any]]:
        """Validate ``edited`` against the ``reference`` it was drained
        from.  Returns ``None`` on pass, else the FIRST violation as a
        structured dict (``guard`` + failing ``leaf``/values) ready for
        the ``drain.abort`` telemetry event."""
        ref = dict(flatten_with_paths(reference))
        for path, leaf in flatten_with_paths(edited):
            a = _leaf_f32(leaf)
            if self.finite and not bool(np.isfinite(a).all()):
                bad = int(a.size - np.isfinite(a).sum())
                return {"guard": "finite", "leaf": path,
                        "nonfinite": bad, "size": int(a.size)}
            if self.max_layer_rel_edit is not None:
                r = _leaf_f32(ref[path]) if path in ref else None
                _require(r is not None,
                         f"GuardSpec.check: edited tree has leaf {path!r} "
                         "absent from the reference tree — guard compares "
                         "like against like")
                rel = float(np.linalg.norm(a - r)
                            / max(float(np.linalg.norm(r)), _REL_EPS))
                if rel > self.max_layer_rel_edit:
                    return {"guard": "edit_magnitude", "leaf": path,
                            "rel_edit": rel,
                            "bound": self.max_layer_rel_edit}
        if self.retain_floor is not None:
            _require(probe is not None,
                     "GuardSpec.retain_floor is set but no retain probe "
                     "was supplied — the tenant runtime must pass "
                     "probe=<callable scoring retain accuracy>")
            acc = float(probe(edited))
            if not (acc == acc) or acc < self.retain_floor:
                return {"guard": "retain_floor", "retain_acc": acc,
                        "floor": self.retain_floor}
        return None
