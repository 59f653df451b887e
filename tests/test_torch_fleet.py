"""The multi-tenant fleet in the port (``repro_torch.fleet``) against the JAX
package's (``repro.fleet``), on the reference's tiny fleet LM ("fleet-t":
2 blocks, d_model 32, vocab 64) with each tenant's weights carried across by
``bridge``:

  * specs: ``TenantSpec`` / ``FleetSpec`` / ``ServeSpec`` JSON crosses the
    packages both ways, the same validation messages; ``cache_dir`` and
    ``mesh_axes`` (ported since the distribution slice) are accepted and
    cross the packages;
  * ``DrainScheduler``: identical ``due_groups``, ``snapshot``, queue views
    and telemetry events over one scripted run (fair and deadline, the
    group budget, defer and reject admission, requeue, dead-letter);
  * a two-tenant same-family fleet (scanned, a streamed refresh after every
    drain): the drain log, each tenant's group / request / refresh logs and
    the build and hit counts EQUAL the reference's (the second tenant's
    first drain builds nothing), the served trees and Fishers within the
    LM files' tolerances; a solo replay of one tenant on a fresh cache is
    bit-identical in the port and builds what the fleet built for it;
  * guarded drains: ``nan_batch`` (retry, then dead-letter), a corrupted
    Fisher (edit magnitude), a worker exception and a deadline miss give
    the reference's abort logs, actions, dead letters and accounting, the
    live tree untouched.

Every port run here is under ``torch.use_deterministic_algorithms``: on the
CPU the embedding's gradient accumulates in a varying order otherwise, and
the solo replay is held bit for bit.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.api import RefreshSpec as JRefreshSpec  # noqa: E402
from repro.api import ServeSpec as JServeSpec  # noqa: E402
from repro.api import UnlearnSpec as JSpec  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.fleet import DrainScheduler as JScheduler  # noqa: E402
from repro.fleet import Fleet as JFleet  # noqa: E402
from repro.fleet import FleetSpec as JFleetSpec  # noqa: E402
from repro.fleet import TenantSpec as JTenantSpec  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.obs import telemetry as jtel  # noqa: E402
from repro.robust import faults as jfaults  # noqa: E402
from repro.robust import GuardSpec as JGuardSpec  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import (ExecSpec, RefreshSpec, ServeSpec,  # noqa: E402
                             UnlearnSpec)
from repro_torch.engine import ProgramCache  # noqa: E402
from repro_torch.fleet import (DrainScheduler, Fleet, FleetSpec,  # noqa: E402
                               TenantSpec)
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.obs import telemetry as tel  # noqa: E402
from repro_torch.robust import GuardSpec, faults  # noqa: E402

torch.set_num_threads(2)
TINY = dict(name="fleet-t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
            d_ff=64, vocab=64)
SEQ = 16


@pytest.fixture(autouse=True, scope="module")
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def _spec(mod, refresh_cls=None, **kw):
    base = dict(alpha=8.0, lam=1.0, tau=0.6, checkpoint_every=2,
                chunk_size=4, sweep_mode="scanned")
    if refresh_cls is not None:
        base["refresh"] = refresh_cls(every_drains=1, max_batches=2,
                                      decay=0.5)
    base.update(kw)
    return mod.for_mode("ficabu", **base)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------
def test_specs_json_cross_packages_both_ways():
    guard = {"finite": True, "max_layer_rel_edit": 0.5,
             "retain_floor": None, "max_retries": 2, "backoff_batches": 1}
    f = FleetSpec(
        tenants=(TenantSpec("a", spec=_spec(UnlearnSpec, RefreshSpec,
                                            guard=GuardSpec(**guard))),
                 TenantSpec("b", arch="yi-6b", seed=1, weight=2.0)),
        serve=ServeSpec(chunk_size=2, refresh_every=1, precision="int8",
                        guard=GuardSpec(max_retries=3)),
        scheduling="deadline", max_groups_per_drain=1,
        max_queue_per_tenant=4, admission="reject", wal_dir="/tmp/w")
    text = f.to_json()
    jf = JFleetSpec.from_json(text)
    assert jf.to_json() == text
    assert FleetSpec.from_json(jf.to_json()) == f
    jt = JFleetSpec(tenants=(JTenantSpec("x", spec=_spec(
        JSpec, JRefreshSpec, guard=JGuardSpec(**guard))),))
    assert FleetSpec.from_json(jt.to_json()).to_json() == jt.to_json()
    js = JServeSpec(publish="step", max_batch=4, admit_chunk=2)
    assert ServeSpec.from_json(js.to_json()).to_json() == js.to_json()
    low, jlow = (ServeSpec(refresh_every=2, guard=GuardSpec()).
                 to_unlearn_spec(),
                 JServeSpec(refresh_every=2, guard=JGuardSpec()).
                 to_unlearn_spec())
    assert low.to_json() == jlow.to_json()
    assert f.tenant_unlearn_spec("b") == f.serve.to_unlearn_spec()


BAD = [
    ("serve", {"chunk_size": 0}), ("serve", {"coalesce": 1}),
    ("serve", {"refresh_every": -1}), ("serve", {"sweep_mode": "x"}),
    ("serve", {"precision": "fp16"}), ("serve", {"publish": "later"}),
    ("serve", {"max_forget_samples": 0}), ("serve", {"max_batch": 0}),
    ("serve", {"admit_chunk": 9}), ("serve", {"publish_lag": 0}),
    ("serve", {"cache_dir": ""}), ("serve", {"bogus": 1}),
    ("tenant", {"name": ""}), ("tenant", {"name": "a", "arch": "nope"}),
    ("tenant", {"name": "a", "seed": -1}),
    ("tenant", {"name": "a", "weight": 0.0}),
    ("tenant", {"name": "a", "bogus": 1}),
    ("fleet", {"tenants": []}),
    ("fleet", {"tenants": [{"name": "a"}, {"name": "a"}]}),
    ("fleet", {"tenants": [{"name": "a"}], "scheduling": "lifo"}),
    ("fleet", {"tenants": [{"name": "a"}], "max_groups_per_drain": -1}),
    ("fleet", {"tenants": [{"name": "a"}], "max_queue_per_tenant": -2}),
    ("fleet", {"tenants": [{"name": "a"}], "admission": "drop"}),
    ("fleet", {"tenants": [{"name": "a"}], "wal_dir": ""}),
]


@pytest.mark.parametrize("what,kw", BAD, ids=[f"{w}-{k}" for w, k in BAD])
def test_spec_validation_equal(what, kw):
    ours = {"serve": ServeSpec, "tenant": TenantSpec, "fleet": FleetSpec}
    theirs = {"serve": JServeSpec, "tenant": JTenantSpec,
              "fleet": JFleetSpec}
    got = _error(lambda: ours[what].from_dict(kw))
    want = _error(lambda: theirs[what].from_dict(kw))
    if "pick one of" in want:
        # the registries list the same archs, in import order
        (g, gnames), (w, wnames) = (m.split("pick one of ")
                                    for m in (got, want))
        assert g == w and sorted(eval(gnames.split(" (")[0])) == \
            sorted(eval(wnames.split(" (")[0]))
        return
    assert got == want


def test_not_ported_yet_raises():
    """What this test once saw refused is ported: the cache dir and the
    mesh axes are accepted, and the JSON crosses the packages."""
    s = ServeSpec(cache_dir="/tmp/c")
    assert JServeSpec.from_json(s.to_json()).to_json() == s.to_json()
    assert ExecSpec(cache_dir="/tmp/c").cache_dir == "/tmp/c"
    u = UnlearnSpec.for_mode("ficabu", cache_dir="/tmp/c",
                             mesh_axes=["data"])
    assert u.exec.mesh_axes == ("data",)
    assert JSpec.from_json(u.to_json()).to_json() == u.to_json()
    assert UnlearnSpec.from_json(u.to_json()) == u
    msg = _error(lambda: ExecSpec(mesh_axes=("data", "")))
    assert "non-empty tuple of axis names" in msg, msg


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------
def _scripted(sched_cls, policy, **kw):
    s = sched_cls(policy, **kw)
    out = []
    for t, w in (("a", 1.0), ("b", 2.0), ("c", 1.0)):
        s.register(t, w)
    for t, p, due, now in (("a", 1, 1, 0), ("a", 2, 1, 0), ("b", 3, 1, 0),
                           ("c", 4, 2, 1), ("a", 5, 3, 1), ("b", 6, 1, 1),
                           ("b", 7, 2, 1), ("c", 8, 1, 2), ("a", 9, 2, 3)):
        out.append(("submit", s.submit(t, p, due, now=now)))
    out.append(("entries", [s.pending_entries(t) for t in "abc"]))
    out.append(("ages", [s.oldest_age(t, 1) for t in "abc"], s.next_due()))
    for idx in (1, 2):
        out.append(("due", idx, [dataclasses.asdict(g)
                                 for g in s.due_groups(idx)]))
        out.append(("snap", s.snapshot()))
    s.requeue("a", [1, 2], due_batch=4, submitted=[0, 1], retries=1)
    s.requeue("c", [4], due_batch=3, retries=0, reason="deadline_miss")
    s.dead_letter("b", [3], reason="retries_exhausted:finite",
                  submitted=[0], batch=2)
    for idx in (3, 4, float("inf")):
        out.append(("due", idx, [dataclasses.asdict(g)
                                 for g in s.due_groups(idx)]))
    out.append(("end", s.snapshot(), s.dead(), s.dead_entries("b"),
                s.pending(), [s.queue_depth(t) for t in "abc"]))
    return out


def _events(events):
    return [{k: v for k, v in e.items() if k not in ("seq", "t")}
            for e in events]


@pytest.mark.parametrize("policy,kw", [
    ("fair", {}), ("deadline", {}), ("fair", {"max_groups": 1}),
    ("deadline", {"max_groups": 2}),
    ("fair", {"max_queue": 2, "admission": "defer"}),
    ("deadline", {"max_queue": 2, "admission": "reject"})],
    ids=["fair", "deadline", "fair-budget", "deadline-budget", "defer",
         "reject"])
def test_scheduler_scripted_run_equal(policy, kw):
    with tel.capture() as cap, jtel.capture() as jcap:
        got = _scripted(DrainScheduler, policy, **kw)
        want = _scripted(JScheduler, policy, **kw)
    assert got == want
    assert _events(cap.events) == _events(jcap.events) and cap.events
    for fn in (lambda S: S("lifo"), lambda S: S("fair", max_groups=-1),
               lambda S: S("fair", max_queue=True),
               lambda S: S("fair", admission="x")):
        assert _error(lambda: fn(DrainScheduler)) == \
            _error(lambda: fn(JScheduler))


# ---------------------------------------------------------------------------
# fleets against the reference
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def data():
    jcfg, tcfg = JLM.LMConfig(**TINY), LM.LMConfig(**TINY)
    out = {"jcfg": jcfg, "tcfg": tcfg}
    for seed in (0, 1):
        toks, doms = jsyn.make_lm_domains(jsyn.LMDataConfig(
            vocab=64, n_domains=4, seq_len=SEQ, n_per_domain=16, seed=seed))
        jp = JLM.init_lm(jax.random.PRNGKey(seed), jcfg)
        tp = bridge.params_to_torch(jax.tree_util.tree_map(np.asarray, jp),
                                    device="cpu")
        out[seed] = (toks, doms, jp, tp)
    return out


def _pair(data, tenants, *, guard=None, refresh=False, programs=(None, None),
          wal_dirs=None, coalesce=True):
    """The same fleet on both sides: ``tenants`` maps a name to its seed;
    ``programs`` the two sides' step caches (fresh ones by default);
    ``wal_dirs`` the two sides' WAL roots (none by default)."""
    specs = (None, None)
    if wal_dirs is not None:
        specs = tuple(F(tenants=tuple(T(n) for n in tenants), wal_dir=d)
                      for F, T, d in ((FleetSpec, TenantSpec, wal_dirs[0]),
                                      (JFleetSpec, JTenantSpec,
                                       wal_dirs[1])))
    fleet = Fleet(programs=programs[0], spec=specs[0])
    jfleet = JFleet(programs=programs[1], spec=specs[1])
    for name, seed in tenants.items():
        toks, doms, jp, tp = data[seed]
        fleet.add_tenant(name, data["tcfg"], toks, doms, SEQ, params=tp,
                         spec=_spec(UnlearnSpec, RefreshSpec if refresh
                                    else None, guard=guard),
                         coalesce=coalesce, device="cpu")
        jfleet.add_tenant(name, data["jcfg"], toks, doms, SEQ, params=jp,
                          spec=_spec(JSpec, JRefreshSpec if refresh else None,
                                     guard=None if guard is None
                                     else JGuardSpec(**guard.to_dict())),
                          coalesce=coalesce)
    return fleet, jfleet


def _strip(entries):
    return [{k: v for k, v in e.items() if k != "latency_s"}
            for e in entries]


def _drain_view(entries):
    out = []
    for e in entries:
        e = dict(e)
        if e.get("group") is not None:
            e["group"] = _strip([e["group"]])[0]
        out.append(e)
    return out


def tree_close(got, want, rtol=1e-4, atol=1e-6, share=0.995,
               rtol_all=1e-2, share_all=0.999):
    a = bridge.paths(bridge.params_to_numpy(got))
    b = bridge.paths(jax.tree_util.tree_map(np.asarray, want))
    assert sorted(a) == sorted(b)
    for k in a:
        x = np.asarray(a[k], np.float64)
        y = np.asarray(b[k], np.float64)
        assert np.isfinite(x).all(), k
        d = np.abs(x - y)
        assert (d <= atol + rtol * np.abs(y)).mean() >= share, k
        assert (d <= atol + rtol_all * np.abs(y)).mean() >= share_all, k


def _bits_equal(a, b):
    a, b = bridge.paths(a), bridge.paths(b)
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


SUBMITS = (("a", 1, 1), ("a", 2, 1), ("b", 3, 1), ("a", 3, 2), ("b", 1, 2),
           ("b", 2, 2), ("a", 1, 5))


@pytest.fixture(scope="module")
def two_tenants(data):
    fleet, jfleet = _pair(data, {"a": 0, "b": 1}, refresh=True)
    logs, jlogs = [], []
    for f, log in ((fleet, logs), (jfleet, jlogs)):
        for t, d, due in SUBMITS:
            assert f.submit(t, d, due_batch=due)
        for idx in (1, 2, 3, float("inf")):
            log.append(f.drain(idx))
    return fleet, jfleet, logs, jlogs


def test_two_tenant_fleet_matches_reference(two_tenants):
    fleet, jfleet, logs, jlogs = two_tenants
    assert [_drain_view(e) for e in logs] == [_drain_view(e) for e in jlogs]
    for name in ("a", "b"):
        rt, jrt = fleet.tenant(name), jfleet.tenant(name)
        assert _strip(rt.group_log) == _strip(jrt.group_log) and rt.groups
        assert _strip(rt.log) == _strip(jrt.log)
        assert _strip(rt.refresh_log) == _strip(jrt.refresh_log)
        assert rt.sweeps == jrt.sweeps and rt.params_version == \
            jrt.params_version
        assert rt.unlearner.stats == jrt.unlearner.stats
        tree_close(rt.params, jrt.params)
        tree_close(rt.unlearner.fisher_global, jrt.unlearner.fisher_global,
                   rtol_all=2e-3)
    # the same family: b's first drain built nothing
    first_b = next(e for log in logs for e in log
                   if e["tenant"] == "b" and e["ran"])
    assert first_b["group"]["sweep_sig"] == [1, 8]
    assert fleet.programs.stats() == jfleet.programs.stats()
    assert fleet.family_program_counts() == jfleet.family_program_counts()
    assert fleet.refresh_if_due(9) == jfleet.refresh_if_due(9) == []
    stats, jstats = fleet.stats(), jfleet.stats()
    for k in ("scheduler", "accounting", "families", "program_cache"):
        assert stats[k] == jstats[k], k
    for name in ("a", "b"):
        st = dict(stats["tenants"][name], engine=None)
        assert st == dict(jstats["tenants"][name], engine=None)


def test_solo_replay_bit_identical(data, two_tenants):
    """Tenant b replayed alone on a fresh cache: the same bits as in the
    fleet, and the builds the fleet made for b's family are the ones a
    solo tenant makes (tenant a's family is b's: same arch and spec)."""
    fleet, _, logs, _ = two_tenants
    toks, doms, _, tp = data[1]
    solo = Fleet(programs=ProgramCache())
    rt = solo.add_tenant("b", data["tcfg"], toks, doms, SEQ, params=tp,
                         spec=_spec(UnlearnSpec, RefreshSpec), device="cpu")
    for log in logs:
        for e in log:
            if e["tenant"] == "b":
                rt.params, _ = rt.run_due(rt.params, e["payloads"],
                                          e["batch"])
    b = fleet.tenant("b")
    assert _bits_equal(rt.params, b.params)
    assert _bits_equal(rt.unlearner.fisher_global,
                       b.unlearner.fisher_global)
    assert _strip(rt.group_log)[0]["sweep_sig"] == [1, 8]
    # each stream keys its refresh steps by its own token; every other
    # step the solo tenant built is one the fleet built once for both
    def steps(f):
        return {k for k in f.programs.keys() if k[1] != "refresh"}
    assert steps(solo) == steps(fleet)
    assert len(solo.programs) - len(steps(solo)) == 1


GUARDED = {
    "nan-retry": (GuardSpec(max_retries=1), [{"site": "nan_batch",
                                              "tenant": "a"}]),
    "nan-dead": (GuardSpec(max_retries=1), [{"site": "nan_batch",
                                             "tenant": "a", "count": 2}]),
    "fisher-corrupt": (GuardSpec(max_layer_rel_edit=0.5, max_retries=1),
                       [{"site": "fisher_corrupt", "tenant": "a"}]),
    "worker-exc": (GuardSpec(max_retries=0), [{"site": "worker_exc",
                                               "tenant": "a"}]),
    "deadline-miss": (GuardSpec(max_retries=0), [{"site": "deadline_miss",
                                                  "tenant": "a"}]),
}


def _abort_view(log):
    out = []
    for a in log:
        a = dict(a)
        a.pop("rel_edit", None)
        if "detail" in a:
            a["detail"] = a["detail"].split("(")[0]
        out.append(a)
    return out


def _warm_caches(two_tenants):
    """The two-tenant fleets' step caches: the same family, so the fleets
    below reuse their steps on both sides instead of building again."""
    return two_tenants[0].programs, two_tenants[1].programs


@pytest.mark.parametrize("case", list(GUARDED))
def test_guarded_drains_match_reference(data, two_tenants, case):
    guard, specs = GUARDED[case]
    fleet, jfleet = _pair(data, {"a": 0}, guard=guard,
                          programs=_warm_caches(two_tenants))
    rt, jrt = fleet.tenant("a"), jfleet.tenant("a")
    live = rt.params
    runs = []
    for f, fmod, spec_cls in ((fleet, faults, faults.FaultSpec),
                              (jfleet, jfaults, jfaults.FaultSpec)):
        f.submit("a", 1, due_batch=1)
        f.submit("a", 2, due_batch=1)
        prev = fmod.install(fmod.FaultInjector([spec_cls(**s)
                                                for s in specs]))
        try:
            runs.append([f.drain(idx) for idx in (1, 2, 3, float("inf"))])
        finally:
            fmod.install(prev)
    got, want = ([[{k: e.get(k) for k in ("tenant", "batch", "payloads",
                                            "ran", "aborted", "missed")}
                   for e in d] for d in r] for r in runs)
    assert got == want
    assert _abort_view(rt.abort_log) == _abort_view(jrt.abort_log)
    if case == "fisher-corrupt":
        for a, b in zip(rt.abort_log, jrt.abort_log):
            assert abs(a["rel_edit"] - b["rel_edit"]) <= 1e-5 * b["rel_edit"]
    assert fleet.scheduler.snapshot() == jfleet.scheduler.snapshot()
    assert fleet.scheduler.dead_entries("a") == \
        jfleet.scheduler.dead_entries("a")
    assert fleet.accounting() == jfleet.accounting()
    assert fleet.accounting()["a"]["ok"]
    assert rt.aborts == jrt.aborts and rt.groups == jrt.groups
    if rt.groups == 0:
        assert rt.params is live
    else:
        tree_close(rt.params, jrt.params)


def test_tenant_named_fisher_lock_and_add_tenant_refusals(data, two_tenants):
    fleet, jfleet = _pair(data, {"a": 0}, programs=_warm_caches(two_tenants))
    toks, doms, jp, tp = data[0]
    for f in (fleet, jfleet):
        f.submit("a", 1, due_batch=1)
        f.drain(1)
    unl, junl = fleet.tenant("a").unlearner, jfleet.tenant("a").unlearner
    bad = {"x": torch.zeros(3)}
    msg = _error(lambda: unl.set_fisher(bad))
    assert "tenant 'a' (model 'fleet-t')" in msg
    assert msg.split(" with ")[0] == _error(
        lambda: junl.set_fisher({"x": np.zeros(3)})).split(" with ")[0]
    for fn in (lambda F, s: F().add_tenant("z", data["tcfg"], toks, doms,
                                           SEQ, params=tp, device="cpu")
               if F is Fleet else F().add_tenant("z", data["jcfg"], toks,
                                                 doms, SEQ, params=jp),
               lambda F, s: F().tenant("nope")):
        assert _error(lambda: fn(Fleet, UnlearnSpec)) == \
            _error(lambda: fn(JFleet, JSpec))
    assert json.loads(fleet.tenant("a").spec.to_json()) == json.loads(
        jfleet.tenant("a").spec.to_json())


def test_step_publish_and_wal_match_reference(data, two_tenants, tmp_path):
    """publish="step": each drain's tree is staged and the live tree moves
    only at publish_staged, whose booking marks the WAL applied; the two
    packages write the same WAL bytes and end on the same trees."""
    fleet, jfleet = _pair(data, {"a": 0}, programs=_warm_caches(two_tenants),
                          wal_dirs=(str(tmp_path / "p"),
                                    str(tmp_path / "r")))
    rt, jrt = fleet.tenant("a"), jfleet.tenant("a")
    live = rt.params
    views = []
    for f, r in ((fleet, rt), (jfleet, jrt)):
        for d, due, now in ((1, 1, 0), (2, 1, 0), (3, 2, 1)):
            assert f.submit("a", d, due_batch=due, now=now)
        view = [f.drain(1, publish="step")]
        view.append((r.params_version, f.accounting()["a"]))
        view.append(r.publish_staged(step=5))
        view.append(f.drain(2, publish="step"))
        view.append(f.drain(3, publish="step"))
        view.append((r.publish_staged(step=9), r.publish_staged(step=10),
                     r.params_version, f.accounting()["a"],
                     r.wal.accounting(), r.wal.records()))
        views.append(view)
    assert [_drain_view(e) if isinstance(e, list) else e
            for e in views[0]] == [_drain_view(e) if isinstance(e, list)
                                   else e for e in views[1]]
    assert live is not rt.params and rt.params_version == 2
    assert Path(rt.wal.path).read_bytes() == Path(jrt.wal.path).read_bytes()
    tree_close(rt.params, jrt.params)
    with pytest.raises(ValueError, match="publish must be"):
        fleet.drain(4, publish="later")


def test_sequential_abort_keeps_committed_prefix(data, two_tenants):
    """coalesce=False: domain 1 commits in place, the NaN-poisoned domain
    2 aborts, and only the uncommitted tail retries — as the reference."""
    fleet, jfleet = _pair(data, {"a": 0}, guard=GuardSpec(max_retries=1),
                          programs=_warm_caches(two_tenants), coalesce=False)
    runs = []
    for f, fmod in ((fleet, faults), (jfleet, jfaults)):
        f.submit("a", 1, due_batch=1)
        f.submit("a", 2, due_batch=1)
        prev = fmod.install(fmod.FaultInjector(
            [fmod.FaultSpec("nan_batch", tenant="a", at=1)]))
        try:
            runs.append([_drain_view(f.drain(i)) for i in (1, 2)])
        finally:
            fmod.install(prev)
    assert runs[0] == runs[1]
    rt, jrt = fleet.tenant("a"), jfleet.tenant("a")
    assert rt.abort_log == jrt.abort_log
    assert rt.abort_log[0]["applied_idx"] == [0]
    assert rt.abort_log[0]["requeue_idx"] == [1]
    assert fleet.accounting() == jfleet.accounting()
    assert _strip(rt.log) == _strip(jrt.log)
    tree_close(rt.params, jrt.params)
