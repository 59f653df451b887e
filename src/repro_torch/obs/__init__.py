"""Observability: structured telemetry stream + streaming metrics + the SLO
report renderer (port of ``repro.obs``; pure Python, the port's own copy).

    from repro_torch.obs import telemetry

    with telemetry.capture(path="events.jsonl") as t:
        ... serve forget requests ...
    print(telemetry.fingerprint(t.events))

``telemetry`` is the process-wide structured event emitter (JSONL
time-series on a monotonic virtual clock) the engine session and the
program cache hook into; ``metrics`` holds counters/gauges and the
streaming P² quantile sketch; ``report`` renders a captured event stream
into a markdown SLO report.
"""
from .metrics import (Counter, Gauge, MetricsRegistry,  # noqa: F401
                      P2Quantile, Summary)
from .report import render, summarize  # noqa: F401
from .telemetry import (NONDETERMINISTIC_KEYS, Telemetry,  # noqa: F401
                        VirtualClock, canonical_events, capture, emit,
                        emitter, fingerprint, install, log, read_jsonl,
                        wall_time)
