"""Load-and-observability example on the PyTorch/CUDA port: seeded
synthetic traffic against a two-tenant fleet, end to end
(``repro_torch.load`` + ``repro_torch.obs``).

The walkthrough builds a bounded-queue fleet, drives a bursty forget /
diurnal generate scenario over the VIRTUAL clock, and renders the captured
telemetry stream into the markdown SLO report. Three things to notice in
the output:

  * ADMISSION CONTROL — the burst overruns ``max_queue_per_tenant``, so
    overflow submits fold into the oldest pending entry (``queue.merge``
    events): the queue depth stays bounded while no request is dropped,
    and the merged work AGES (visible in the queue-age percentiles);
  * DETERMINISM — a second run of the same scenario produces an identical
    event stream modulo wall-clock latency fields (the sha256
    fingerprints printed at the end match);
  * ZERO STEADY-STATE COMPILES — every engine program is built during the
    warmup ticks; under steady load the shared cache only replays.

The same fleet, scenario and SLOs as ``examples/load_fleet_smoke.py``.

    PYTHONPATH=src python examples/torch_load_fleet_smoke.py               # card
    PYTHONPATH=src python examples/torch_load_fleet_smoke.py --device cpu  # host
"""
import argparse
import os
import tempfile

from repro_torch.fleet import Fleet, FleetSpec, TenantSpec
from repro_torch.load import ArrivalSpec, LoadHarness, LoadScenario, SLOSpec
from repro_torch.load.harness import build_lm_tenant
from repro_torch.obs import render, telemetry

FLEET = FleetSpec(
    tenants=(
        TenantSpec("acme", arch="gemma3-1b", seed=0),
        TenantSpec("globex", arch="gemma3-1b", seed=1, weight=2.0),
    ),
    scheduling="fair",
    max_groups_per_drain=1,       # force cross-tenant deferrals
    max_queue_per_tenant=2,       # force defer-with-aging folds
    admission="defer",
)

SCENARIO = LoadScenario(
    ticks=8, warmup_ticks=4, deadline_slack=1,
    forget=ArrivalSpec(kind="bursty", rate=0.8, burst_factor=5.0,
                       duty=0.25, period=4, seed=3),
    generate=ArrivalSpec(kind="diurnal", rate=1.0, period=8, seed=5),
    domains=3, seed=11)

SLO = SLOSpec(max_queue_age_p99=6.0, max_queue_depth=2,
              min_drain_throughput=0.25, max_reject_fraction=0.0,
              max_steady_compiles=0)


def run(device="cuda", *, build_tenant=None) -> dict:
    """The scenario twice on fresh fleets on ``device`` (the harness runs
    under deterministic algorithms on the card), the first run's events
    kept as JSONL. ``build_tenant(tspec)`` makes a tenant's model and data
    (default: ``build_lm_tenant`` from the tenant's seed). Returns both
    runs' results, the SLO evaluation and the report."""
    if build_tenant is None:
        def build_tenant(t):
            return build_lm_tenant(t, prompt_len=SCENARIO.prompt_len,
                                   gen_len=SCENARIO.gen_len, device=device)

    def run_once(events_path=None):
        fleet = Fleet.from_spec(FLEET, build_tenant, device=device)
        tel = telemetry.Telemetry(path=events_path,
                                  clock=telemetry.VirtualClock(), keep=True)
        try:
            return LoadHarness(fleet, SCENARIO).run(tel)
        finally:
            tel.close()

    with tempfile.TemporaryDirectory() as tmp:
        res = run_once(os.path.join(tmp, "events.jsonl"))
        replay = run_once()
    evaluation = SLO.evaluate(res)
    return {"res": res, "replay": replay, "evaluation": evaluation,
            "report": render(res, evaluation,
                             title="Load smoke SLO report")}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    out = run(ap.parse_args().device)
    res, replay, evaluation = out["res"], out["replay"], out["evaluation"]
    print()
    print(out["report"])

    fleet_sum = res["fleet"]
    print(f"submitted={fleet_sum['submitted']} "
          f"merged={fleet_sum['merged']} (defer-with-aging folds) "
          f"deferrals={fleet_sum['deferrals']} "
          f"drained={fleet_sum['drained_requests']}")
    print(f"queue_depth_max={fleet_sum['queue_depth_max']} "
          f"(bound {FLEET.max_queue_per_tenant}) "
          f"queue_age_p99={fleet_sum['queue_age']['p99']:.2f} batches")
    print(f"compiles={fleet_sum['compiles']} "
          f"hits={fleet_sum['program_hits']} "
          f"steady_state_compiles={fleet_sum['steady_state_compiles']}")
    print(f"fingerprint run1={res['fingerprint'][:16]}... "
          f"run2={replay['fingerprint'][:16]}...")

    if not evaluation["ok"]:
        raise SystemExit("SLO FAILED")
    if res["fingerprint"] != replay["fingerprint"]:
        raise SystemExit("determinism FAILED: event streams differ")
    if fleet_sum["queue_depth_max"] > FLEET.max_queue_per_tenant:
        raise SystemExit("bounded-queue invariant FAILED")
    print("load smoke ok: SLOs met, deterministic, queues bounded")
