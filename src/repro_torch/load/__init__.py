"""Synthetic load harness (port of ``repro.load``): seeded arrival
processes over a virtual clock driving the multi-tenant fleet, with
declarative SLO specs (DESIGN.md §14).

    from repro_torch.load import (ArrivalSpec, LoadScenario, LoadHarness,
                                  SLOSpec)

Everything here is deterministic by construction — no wall-clock reads,
all randomness threaded through seeded numpy generators (the reference's
streams, draw for draw) — so two runs of the same scenario produce
identical telemetry streams modulo wall-clock latency fields.
"""
from .arrivals import ARRIVAL_KINDS, ArrivalProcess, ArrivalSpec  # noqa: F401
from .harness import (LoadHarness, LoadScenario,  # noqa: F401
                      build_lm_tenant)
from .slo import SLOSpec  # noqa: F401
