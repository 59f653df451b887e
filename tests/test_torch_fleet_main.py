"""The ``--fleet`` launcher of the port (``repro_torch.launch.serve``)
against the JAX package's:

  * ``main(["--fleet", spec, "--check"])`` on two gemma3-1b-smoke tenants
    (seeds 0 and 1) in both packages: both pass every gate (the solo
    replay bit for bit), and the served shapes, the drain log, every
    tenant's group log (the engine's build / hit / launch counts, the
    drain signatures) and the fleet stats' scheduler, accounting, WAL and
    family counts are equal. Each package draws its own weights, so the
    requests' ``stopped_at_l`` / ``macs_vs_ssd_pct`` are not compared;
  * each gate of ``fleet_check_problems`` fires, alone, on a finished
    two-tenant fleet of the reference's tiny LM that is broken for it.
"""
import copy
import json
import types

import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve as jserve  # noqa: E402
from repro_torch.data.synthetic import LMDataConfig, make_lm_domains  # noqa: E402
from repro_torch.fleet import FleetSpec  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402

torch.set_num_threads(2)
FLEET = {"tenants": [{"name": "a", "arch": "gemma3-1b", "seed": 0},
                     {"name": "b", "arch": "gemma3-1b", "seed": 1}],
         "serve": {"chunk_size": 4}}
ARGS = ["--requests", "4", "--prompt-len", "8", "--gen-len", "4",
        "--forget-domains", "1,2;3,2", "--check"]


@pytest.fixture(scope="module", autouse=True)
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def _strip(x):
    """Drop the wall-clock fields (``latency_s``) at any depth."""
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k != "latency_s"}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def test_fleet_main_matches_reference(tmp_path):
    path = tmp_path / "fleet.json"
    path.write_text(json.dumps(FLEET))
    got = serve.main(["--device", "cpu", "--fleet", str(path)] + ARGS)
    want = jserve.main(["--fleet", str(path)] + ARGS)
    assert got["fleet"] == want["fleet"]
    assert _strip(got["served"]) == _strip(want["served"])
    assert got["drain_log"] == want["drain_log"]
    assert len(got["drain_log"]) == 4
    for name in ("a", "b"):
        g, w = got["tenants"][name], want["tenants"][name]
        assert _strip(g["group_log"]) == _strip(w["group_log"])
        assert (g["coalesced_groups"], g["sweeps"]) == \
            (w["coalesced_groups"], w["sweeps"]) == (2, 2)
        assert [r["domain"] for r in g["unlearn_requests"]] == \
            [r["domain"] for r in w["unlearn_requests"]]
    gs, ws = got["fleet_stats"], want["fleet_stats"]
    for k in ("scheduler", "accounting", "program_cache", "families"):
        assert gs[k] == ws[k], k
    for name in ("a", "b"):
        for k in ("groups", "sweeps", "requests", "applied", "aborts",
                  "refreshes", "wal"):
            assert gs["tenants"][name][k] == ws["tenants"][name][k], k


# ---------------------------------------------------------------------------
# every fleet gate fires on a run that breaks it
# ---------------------------------------------------------------------------
TINY = dict(name="fleet-t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
            d_ff=64, vocab=64)


def _builder(seed_shift=0):
    def build(tspec):
        cfg = LM.LMConfig(**TINY)
        params = LM.init_lm(
            torch.Generator().manual_seed(tspec.seed + seed_shift), cfg,
            device="cpu")
        tokens, domains = make_lm_domains(LMDataConfig(
            vocab=64, n_domains=4, seq_len=12, n_per_domain=16,
            seed=tspec.seed))
        return {"cfg": cfg, "tokens": tokens, "domains": domains,
                "seq_len": 12, "params": params}
    return build


@pytest.fixture(scope="module")
def ran():
    args = types.SimpleNamespace(
        requests=4, prompt_len=8, gen_len=4, prefill_block=8,
        unlearn_after=1, forget_domains="1,2;3,2", coalesce=False,
        forget_domain=1)
    fspec = FleetSpec.from_dict(FLEET)
    fleet, result = serve.run_fleet(fspec, _builder(), args, device="cpu")
    assert serve.fleet_check_problems(fleet, fspec, _builder()) == []
    return fleet, fspec


def _break(fleet, what):
    """A copy of the finished fleet's bookkeeping, broken for one gate."""
    f = copy.copy(fleet)
    f.tenants = {n: copy.copy(rt) for n, rt in fleet.tenants.items()}
    f.drain_log = copy.deepcopy(fleet.drain_log)
    for rt in f.tenants.values():
        rt.group_log = copy.deepcopy(rt.group_log)
    a, b = f.tenants["a"], f.tenants["b"]
    sched = fleet.scheduler
    if what == "abort":
        a.aborts, a.abort_log = 1, [{"guard": "finite"}]
    elif what == "dead":
        # a dead letter that the accounting books (it balances)
        acct = fleet.accounting()
        f.scheduler = copy.copy(sched)
        f.scheduler.dead = lambda *n: 1
        f.accounting = lambda: acct
    elif what == "accounting":
        acct = fleet.accounting()
        acct["a"] = dict(acct["a"], ok=False)
        f.accounting = lambda: acct
    elif what == "coalesce":
        a.group_log.append(dict(a.group_log[0], group=9))
    elif what == "rebuild":
        e = [e for e in f.drain_log if e["group"]][-1]
        e["group"]["engine"] = dict(e["group"]["engine"], compiles=1)
    elif what == "fallback":
        a.group_log[0]["engine"] = dict(a.group_log[0]["engine"],
                                        sweep_mode="layerwise")
    elif what == "launches":
        a.group_log[0]["engine"] = dict(a.group_log[0]["engine"],
                                        sweep_launches=2)
    elif what == "precision":
        a.group_log[0]["engine"] = dict(a.group_log[0]["engine"],
                                        precision="int8")
    elif what == "no_family":
        for rt in f.tenants.values():
            rt.groups = 0
    elif what == "build_count":
        counts = fleet.family_program_counts()
        f.family_program_counts = lambda: {k: v + 1
                                           for k, v in counts.items()}
    elif what == "fisher":
        fisher = dict(b.unlearner.fisher_global)
        fisher["embed"] = {"w": torch.zeros_like(fisher["embed"]["w"])}
        b.unlearner = types.SimpleNamespace(fisher_global=fisher)
    return f


GATES = ["abort", "dead", "accounting", "coalesce", "rebuild", "fallback",
         "launches", "precision", "no_family", "build_count", "fisher"]


@pytest.mark.parametrize("what", GATES)
def test_fleet_gate_fires(ran, what):
    fleet, fspec = ran
    msgs = serve.fleet_check_problems(_break(fleet, what), fspec,
                                      _builder())
    assert len(msgs) == 1, msgs


def test_fleet_isolation_gate_fires(ran):
    """A solo replay from other weights: the params gate (and the Fisher
    gate, the replay's Fisher being of other weights) fire."""
    fleet, fspec = ran
    msgs = serve.fleet_check_problems(fleet, fspec, _builder(seed_shift=7))
    assert len(msgs) == 2 and "params" in msgs[0] and "Fisher" in msgs[1]
