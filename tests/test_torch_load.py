"""The load harness of the port (``repro_torch.load``) and the report
CLI's ``--slo`` against the JAX package's:

  * the arrival processes: every kind's per-tick counts and rates equal the
    reference's over 64 ticks (the same numpy PCG64 streams);
  * ``SLOSpec.evaluate`` equal on summaries that pass, fail, lack a metric
    or set no objective; the validation messages of ``ArrivalSpec``,
    ``LoadScenario`` and ``SLOSpec`` equal, and the JSON round trips;
  * ``LoadHarness`` over a fleet of the real scheduler without a model (the
    reference's stub), in both packages: equal fingerprints, the summary
    equal to the scheduler's accounting, reject admission accounted;
  * ``LoadHarness`` on a two-tenant gemma3-1b-smoke fleet (the reference's
    weights, bridged) with drains through the engine: the canonical event
    stream (wall-clock fields stripped) EQUAL to the reference's, event for
    event — no float field differs on these weights — and the fleet's
    accounting equal to the scheduler's;
  * ``report --slo`` on the harness's JSONL stream: the markdown and the
    exit code equal the reference CLI's, for an SLO met and one missed.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import load as jload  # noqa: E402
from repro.fleet import DrainScheduler as JScheduler  # noqa: E402
from repro.fleet import Fleet as JFleet  # noqa: E402
from repro.fleet import FleetSpec as JFleetSpec  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro.obs import telemetry as jtel  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch import load  # noqa: E402
from repro_torch.fleet import DrainScheduler, Fleet, FleetSpec  # noqa: E402
from repro_torch.obs import report  # noqa: E402
from repro_torch.obs import telemetry as tel  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def _error(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


# -- arrivals -----------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(kind="poisson", rate=0.5, seed=0),
    dict(kind="poisson", rate=3.0, seed=11),
    dict(kind="bursty", rate=1.0, seed=3, period=4, burst_factor=6.0),
    dict(kind="bursty", rate=2.0, seed=5, duty=0.5, burst_factor=1.5),
    dict(kind="diurnal", rate=2.0, seed=2, period=8, amplitude=0.5)],
    ids=["poisson", "poisson-hot", "bursty", "bursty-mild", "diurnal"])
def test_arrival_counts_equal(kw):
    a, b = load.ArrivalSpec(**kw).build(), jload.ArrivalSpec(**kw).build()
    assert [a.counts(t) for t in range(64)] == [b.counts(t)
                                                for t in range(64)]
    assert [a.rate_at(t) for t in range(64)] == [b.rate_at(t)
                                                 for t in range(64)]


# -- specs --------------------------------------------------------------------
SUMMARIES = [
    {"fleet": {"queue_age": {"p99": 4.0}, "queue_depth_max": 2,
               "drain_throughput": 1.5, "submitted": 10, "rejected": 1,
               "steady_state_compiles": 0, "dead_letters": 0,
               "drain_latency_s": {"p99": 0.2}}},
    {"fleet": {"queue_age": {"p99": 9.0}, "queue_depth_max": 5,
               "drain_throughput": 0.2, "submitted": 10, "rejected": 6,
               "steady_state_compiles": 3, "dead_letters": 2,
               "drain_latency_s": {"p99": 9.0}}},
    {"fleet": {"queue_age": {}, "queue_depth_max": 2}},
    {"queue_age": {"p99": 1.0}, "submitted": 0, "rejected": 0,
     "dead_letters": 0},
]
SLOS = [dict(max_queue_age_p99=5.0, max_queue_depth=2,
             min_drain_throughput=1.0),
        dict(max_reject_fraction=0.5, max_steady_compiles=0,
             forget_p99_s=1.0, max_dead_letter_fraction=0.0),
        dict()]


@pytest.mark.parametrize("si", range(len(SLOS)))
def test_slo_evaluation_equal(si):
    ours, theirs = load.SLOSpec(**SLOS[si]), jload.SLOSpec(**SLOS[si])
    assert ours.to_json() == theirs.to_json()
    assert load.SLOSpec.from_json(ours.to_json()) == ours
    for summary in SUMMARIES:
        assert ours.evaluate(summary) == theirs.evaluate(summary)


BAD = [
    ("arrival", dict(kind="weibull")), ("arrival", dict(rate=-1.0)),
    ("arrival", dict(rate=float("nan"))), ("arrival", dict(seed=-1)),
    ("arrival", dict(burst_factor=0.5)), ("arrival", dict(duty=1.0)),
    ("arrival", dict(period=1)), ("arrival", dict(amplitude=2.0)),
    ("arrival", dict(nope=1)),
    ("scenario", dict(ticks=0)), ("scenario", dict(warmup_ticks=-1)),
    ("scenario", dict(domains=0)), ("scenario", dict(seed=True)),
    ("scenario", dict(forget="lots")), ("scenario", dict(serve_generate=1)),
    ("scenario", dict(faults="x")), ("scenario", dict(faults=[3])),
    ("scenario", dict(nope=1)),
    ("slo", dict(max_queue_depth=0)), ("slo", dict(max_reject_fraction=1.5)),
    ("slo", dict(max_steady_compiles=-1)), ("slo", dict(forget_p99_s=-1.0)),
    ("slo", dict(max_dead_letter_fraction=2)), ("slo", dict(nope=1)),
]


@pytest.mark.parametrize("what,kw", BAD,
                         ids=[f"{w}-{sorted(k)[0]}" for w, k in BAD])
def test_validation_messages_equal(what, kw):
    ours = {"arrival": load.ArrivalSpec, "scenario": load.LoadScenario,
            "slo": load.SLOSpec}[what]
    theirs = {"arrival": jload.ArrivalSpec, "scenario": jload.LoadScenario,
              "slo": jload.SLOSpec}[what]
    assert _error(lambda: ours.from_dict(kw)) == \
        _error(lambda: theirs.from_dict(kw))


def test_scenario_round_trip_equal():
    sc = dict(ticks=8, warmup_ticks=2, forget={"kind": "bursty", "rate": 1.0},
              faults=[{"site": "nan_batch", "tenant": "a", "count": 1}])
    ours, theirs = load.LoadScenario.from_dict(sc), \
        jload.LoadScenario.from_dict(sc)
    assert ours.to_json() == theirs.to_json()
    assert load.LoadScenario.from_json(ours.to_json()) == ours


# -- the harness over the real scheduler, no model ----------------------------
class _StubFleet:
    """The Fleet surface LoadHarness drives, minus a model: the REAL
    scheduler and telemetry of one package."""

    def __init__(self, sched_cls, t, names=("a", "b"), **sched_kw):
        self.t = t
        self.scheduler = sched_cls("fair", **sched_kw)
        self.tenants = {}
        for n in names:
            self.scheduler.register(n)
            self.tenants[n] = object()

    def submit(self, tenant, payload, due_batch, *, now=None):
        return self.scheduler.submit(tenant, payload, due_batch, now=now)

    def drain(self, batch_idx):
        groups = self.scheduler.due_groups(batch_idx)
        for g in groups:
            self.t.emit("drain.group", tenant=g.tenant,
                        n_requests=len(g.payloads), ages=list(g.ages),
                        due_batch=g.due_batch, latency_s=0.0)
        return groups


def _sc(mod, **kw):
    base = dict(ticks=12, warmup_ticks=2, deadline_slack=1,
                forget=mod.ArrivalSpec(kind="bursty", rate=1.0, seed=3,
                                       period=4, burst_factor=6.0),
                generate=mod.ArrivalSpec(kind="poisson", rate=0.5, seed=5),
                domains=3, seed=7)
    base.update(kw)
    return mod.LoadScenario(**base)


@pytest.mark.parametrize("admission,rate", [("defer", 1.0), ("reject", 4.0)])
def test_stub_harness_equal(admission, rate):
    kw = dict(max_queue=2 if admission == "defer" else 1,
              admission=admission, max_groups=1)
    ours = load.LoadHarness(_StubFleet(DrainScheduler, tel, **kw), _sc(
        load, forget=load.ArrivalSpec(kind="bursty", rate=rate, seed=3,
                                      period=4, burst_factor=6.0))).run()
    theirs = jload.LoadHarness(_StubFleet(JScheduler, jtel, **kw), _sc(
        jload, forget=jload.ArrivalSpec(kind="bursty", rate=rate, seed=3,
                                        period=4, burst_factor=6.0))).run()
    assert ours["fingerprint"] == theirs["fingerprint"]
    assert ours["event_counts"] == theirs["event_counts"]
    for k in ("fleet", "scheduler", "admitted", "rejected_submits",
              "final_tick"):
        assert ours[k] == theirs[k], k
    fleet, snap = ours["fleet"], ours["scheduler"]
    assert fleet["drained_requests"] == ours["admitted"] > 0
    assert all(v == 0 for v in snap["pending"].values())
    if admission == "reject":
        assert ours["rejected_submits"] == fleet["rejected"] \
            == sum(snap["rejects"].values()) \
            == ours["event_counts"]["queue.reject"] > 0
    else:
        assert fleet["submitted"] == ours["admitted"]
        assert fleet["merged"] == sum(snap["merges"].values()) > 0


def test_harness_validation_equal():
    for ours, theirs in (
            (lambda: load.LoadHarness(_StubFleet(DrainScheduler, tel),
                                      "fast"),
             lambda: jload.LoadHarness(_StubFleet(JScheduler, jtel),
                                       "fast")),
            (lambda: load.LoadHarness(_StubFleet(DrainScheduler, tel,
                                                 names=()), _sc(load)),
             lambda: jload.LoadHarness(_StubFleet(JScheduler, jtel,
                                                  names=()), _sc(jload)))):
        assert _error(ours) == _error(theirs)


# -- the harness on a model fleet ---------------------------------------------
FLEET = {"tenants": [{"name": "a", "arch": "gemma3-1b", "seed": 0},
                     {"name": "b", "arch": "gemma3-1b", "seed": 1}],
         "serve": {"chunk_size": 4}}
SCENARIO = dict(ticks=8, forget={"kind": "poisson", "rate": 0.5},
                serve_generate=False, domains=3, seed=0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same scenario on each package's fleet, the port's on the
    reference's weights (bridged); the port's stream kept as JSONL."""
    d = tmp_path_factory.mktemp("load")

    def tbuild(t):
        b = jload.build_lm_tenant(t)
        return dict(b, cfg=configs.get(t.arch).smoke,
                    params=bridge.params_to_torch(jax.tree_util.tree_map(
                        np.asarray, b["params"]), device="cpu"))

    jfleet = JFleet.from_spec(JFleetSpec.from_dict(FLEET),
                              jload.build_lm_tenant)
    fleet = Fleet.from_spec(FleetSpec.from_dict(FLEET), tbuild,
                            device="cpu")
    path = str(d / "events.jsonl")
    t = tel.Telemetry(path=path, clock=tel.VirtualClock())
    try:
        ours = load.LoadHarness(fleet, load.LoadScenario.from_dict(
            SCENARIO)).run(t)
        events = list(t.events)
    finally:
        t.close()
    with jtel.capture(clock=jtel.VirtualClock()) as jt:
        theirs = jload.LoadHarness(jfleet, jload.LoadScenario.from_dict(
            SCENARIO)).run(jt)
    return ours, theirs, fleet, path, events, list(jt.events), d


def test_model_harness_matches_reference(runs):
    ours, theirs, fleet, _, events, jevents, _ = runs
    assert tel.canonical_events(events) == jtel.canonical_events(jevents)
    assert ours["fingerprint"] == theirs["fingerprint"]
    assert ours["event_counts"] == theirs["event_counts"]
    assert ours["event_counts"]["drain.group"] > 0
    for k in ("admitted", "rejected_submits", "final_tick", "scheduler",
              "accounting"):
        assert ours[k] == theirs[k], k
    assert all(a["ok"] for a in ours["accounting"].values())
    assert ours["fleet"]["drained_requests"] == ours["admitted"] \
        == sum(fleet.scheduler.submits.values())
    assert sum(rt.applied_requests for rt in fleet.tenants.values()) \
        == ours["admitted"]


@pytest.mark.parametrize("depth", [1, 8], ids=["missed", "met"])
def test_report_slo_equal(runs, depth):
    _, _, _, path, _, _, d = runs
    slo = d / f"slo{depth}.json"
    slo.write_text(load.SLOSpec(max_queue_depth=depth,
                                max_dead_letter_fraction=0.0).to_json())
    outs = []
    for mod, name in ((report, "port"), (jreport, "ref")):
        out = d / f"{name}{depth}.md"
        rc = mod.main([path, "-o", str(out), "--slo", str(slo),
                       "--warmup-t", "2"])
        outs.append((rc, out.read_text()))
    assert outs[0] == outs[1]
    assert outs[0][0] == (0 if depth == 8 else 1)
    assert "## SLO attainment" in outs[0][1]
    assert json.loads(slo.read_text())["max_queue_depth"] == depth
