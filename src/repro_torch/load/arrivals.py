"""Seeded arrival processes over the virtual clock (port of
``repro.load.arrivals``; numpy, the same streams as the reference).

Regulation-driven erasure traffic is a deadline-bearing request STREAM, not
a single drain: requests arrive in bursts (a breach notice fans out),
follow diurnal cycles (users act in their waking hours), or hum along as a
Poisson background.  ``ArrivalSpec`` declares one such process; ``build()``
returns a stateful sampler whose ``counts(t)`` yields the number of
arrivals in virtual tick ``t``.

Determinism contract: the sampler owns a ``numpy`` PCG64 generator seeded
from the spec, draws exactly ONE variate per tick, and never reads the wall
clock — two samplers built from equal specs produce identical traces, which
is what makes the load bench's event-stream fingerprint reproducible.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np

from repro_torch.api.specs import _require

ARRIVAL_KINDS = ("poisson", "bursty", "diurnal")


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """One arrival process.

    ``kind``    "poisson" (constant mean rate), "bursty" (on/off modulated:
                rate*burst_factor during the duty fraction of each period,
                a compensating low rate otherwise, so the long-run mean
                stays ≈ rate), or "diurnal" (sinusoidal modulation with the
                given amplitude and period).
    ``rate``    mean arrivals per virtual tick.
    ``seed``    PCG64 seed for the Poisson draws.
    ``burst_factor``/``duty``/``period``/``amplitude``  modulation shape
                (ignored where not applicable).
    """
    kind: str = "poisson"
    rate: float = 1.0
    seed: int = 0
    burst_factor: float = 8.0
    duty: float = 0.25
    period: int = 16
    amplitude: float = 0.8

    def __post_init__(self):
        _require(self.kind in ARRIVAL_KINDS,
                 f"ArrivalSpec.kind must be one of {ARRIVAL_KINDS}, "
                 f"got {self.kind!r}")
        _require(isinstance(self.rate, (int, float))
                 and not isinstance(self.rate, bool)
                 and math.isfinite(self.rate) and self.rate >= 0,
                 f"ArrivalSpec.rate must be a finite number >= 0 (mean "
                 f"arrivals per tick), got {self.rate!r}")
        _require(isinstance(self.seed, int)
                 and not isinstance(self.seed, bool) and self.seed >= 0,
                 f"ArrivalSpec.seed must be an int >= 0, got {self.seed!r}")
        _require(isinstance(self.burst_factor, (int, float))
                 and not isinstance(self.burst_factor, bool)
                 and self.burst_factor >= 1,
                 f"ArrivalSpec.burst_factor must be >= 1 (on-phase rate "
                 f"multiplier), got {self.burst_factor!r}")
        _require(isinstance(self.duty, (int, float))
                 and not isinstance(self.duty, bool)
                 and 0 < float(self.duty) < 1,
                 f"ArrivalSpec.duty must be in (0, 1) (fraction of each "
                 f"period spent bursting), got {self.duty!r}")
        _require(isinstance(self.period, int)
                 and not isinstance(self.period, bool) and self.period >= 2,
                 f"ArrivalSpec.period must be an int >= 2 ticks, "
                 f"got {self.period!r}")
        _require(isinstance(self.amplitude, (int, float))
                 and not isinstance(self.amplitude, bool)
                 and 0 <= float(self.amplitude) <= 1,
                 f"ArrivalSpec.amplitude must be in [0, 1], "
                 f"got {self.amplitude!r}")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Any) -> "ArrivalSpec":
        _require(isinstance(d, dict),
                 f"ArrivalSpec.from_dict expects a mapping, "
                 f"got {type(d).__name__}")
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        _require(not unknown,
                 f"unknown ArrivalSpec field(s) {sorted(unknown)}; expected "
                 f"a subset of {sorted(fields)}")
        return cls(**d)

    def build(self) -> "ArrivalProcess":
        return ArrivalProcess(self)


class ArrivalProcess:
    """Stateful sampler for one ``ArrivalSpec`` (one Poisson draw per
    tick against the spec's modulated rate)."""

    def __init__(self, spec: ArrivalSpec):
        if not isinstance(spec, ArrivalSpec):
            raise ValueError(f"ArrivalProcess needs an ArrivalSpec, "
                             f"got {type(spec).__name__}")
        self.spec = spec
        self._rng = np.random.Generator(np.random.PCG64(spec.seed))

    def rate_at(self, t: int) -> float:
        """The (deterministic) instantaneous mean rate at tick ``t``."""
        s = self.spec
        if s.kind == "poisson":
            return s.rate
        if s.kind == "bursty":
            on = (t % s.period) < s.duty * s.period
            if on:
                return s.rate * s.burst_factor
            # compensate the off phase so the long-run mean stays ~ rate
            # (clipped at 0 when the burst already exceeds the budget)
            off = (1.0 - s.duty * s.burst_factor) / (1.0 - s.duty)
            return s.rate * max(0.0, off)
        # diurnal: sinusoid over the period, never negative
        phase = 2.0 * math.pi * (t % s.period) / s.period
        return s.rate * max(0.0, 1.0 + s.amplitude * math.sin(phase))

    def counts(self, t: int) -> int:
        """Number of arrivals in tick ``t`` — exactly one variate per call,
        so the trace is a pure function of (seed, call sequence)."""
        return int(self._rng.poisson(self.rate_at(t)))
