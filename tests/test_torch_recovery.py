"""Crash recovery in the port (``repro_torch.fleet.Fleet.checkpoint`` /
``recover``, ``TenantRuntime.install_recovered``) against the JAX
package's, on the reference's tiny recovery LM ("recov-t", its weights
carried by ``bridge``):

  * ``Fleet.checkpoint`` / ``Fleet.recover`` round trip: params and Fisher
    restored bit for bit, keyed by ``params_version``, the WAL fully
    absorbed (nothing replayed), the ``fleet.recover`` event emitted;
  * recovery refuses a tenant with a RefreshSpec, with the reference's
    message;
  * the kill-and-recover proof: a subprocess in which ``jax`` and ``repro``
    cannot be imported drains once, checkpoints, WAL-accepts a second
    request and is SIGKILLed mid-drain (``kill_mid_drain``); the parent
    recovers (restored step 1, the unapplied request replayed exactly once,
    version 2, WAL accounting) to params and Fisher bit for bit equal to
    an uninterrupted twin, and within the serving tests' tolerances of the
    reference's recovery of the same crash (checkpoint, a fleet abandoned
    after the WAL accept, a new fleet's ``recover``).

Runs under deterministic algorithms (each fleet computes its own Fisher).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.api import RefreshSpec as JRefresh  # noqa: E402
from repro.api import UnlearnSpec as JSpec  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.fleet import Fleet as JFleet  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.robust import ForgetWAL as JWAL  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import RefreshSpec, UnlearnSpec  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.fleet import Fleet  # noqa: E402
from repro_torch.launch.serve import _trees_bitwise_equal  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.obs import telemetry as _t  # noqa: E402
from repro_torch.robust import ForgetWAL, faults  # noqa: E402

torch.set_num_threads(2)
SRC = Path(__file__).resolve().parent.parent / "src"
SEQ = 16
TINY = dict(name="recov-t", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab=64)
SPEC = dict(alpha=8.0, lam=1.0, tau=0.6, checkpoint_every=2, chunk_size=4,
            sweep_mode="scanned")


@pytest.fixture(scope="module", autouse=True)
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    faults.install(None)
    yield
    faults.install(None)


@pytest.fixture(scope="module")
def tiny():
    toks, doms = jsyn.make_lm_domains(jsyn.LMDataConfig(
        vocab=64, n_domains=4, seq_len=SEQ, n_per_domain=8, seed=0))
    jp = JLM.init_lm(jax.random.PRNGKey(0), JLM.LMConfig(**TINY))
    tp = bridge.params_to_torch(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    return toks, doms, jp, tp


def _build(tiny, wal_dir=None, **spec_kw):
    toks, doms, _, tp = tiny
    fleet = Fleet()
    rt = fleet.add_tenant("a", LM.LMConfig(**TINY), toks, doms, SEQ,
                          params=tp,
                          spec=UnlearnSpec.for_mode("ficabu",
                                                    **dict(SPEC, **spec_kw)),
                          device="cpu")
    if wal_dir is not None:
        rt.wal = ForgetWAL(str(wal_dir), "a")
    return fleet, rt


def test_fleet_checkpoint_recover_round_trip(tiny, tmp_path):
    fleet, rt = _build(tiny, wal_dir=tmp_path / "wal")
    fleet.submit("a", 1, due_batch=1)
    fleet.drain(1)
    assert rt.params_version == 1
    dirs = fleet.checkpoint(str(tmp_path / "ckpt"))
    assert dirs == {"a": str(tmp_path / "ckpt" / "a" / "step_00000001")}
    p1, f1 = rt.params, rt.unlearner.fisher_global

    fleet2, rt2 = _build(tiny, wal_dir=tmp_path / "wal")
    with _t.capture() as cap:
        report = fleet2.recover(str(tmp_path / "ckpt"))
    assert report["a"] == {"restored_step": 1, "restored_version": 1,
                           "replayed": []}
    assert [e["kind"] for e in cap.events].count("fleet.recover") == 1
    assert rt2.params_version == 1
    assert _trees_bitwise_equal(rt2.params, p1)
    assert _trees_bitwise_equal(rt2.unlearner.fisher_global, f1)
    # a tenant with no checkpoint keeps its tree at version 0
    fleet3, rt3 = _build(tiny)
    assert fleet3.recover(str(tmp_path / "none"))["a"] == {
        "restored_step": None, "restored_version": 0, "replayed": []}
    assert rt3.params is tiny[3] and rt3.unlearner is None


def test_recover_refuses_refresh_tenants(tiny, tmp_path):
    toks, doms, jp, _ = tiny
    fleet, _ = _build(tiny, refresh=RefreshSpec(every_drains=1))
    with pytest.raises(ValueError, match="RefreshSpec") as e:
        fleet.recover(str(tmp_path))
    jfleet = JFleet()
    jfleet.add_tenant("a", JLM.LMConfig(**TINY), toks, doms, SEQ, params=jp,
                      spec=JSpec.for_mode("ficabu", refresh=JRefresh(
                          every_drains=1), **SPEC))
    with pytest.raises(ValueError) as je:
        jfleet.recover(str(tmp_path))
    assert str(e.value) == str(je.value)


_VICTIM = textwrap.dedent("""\
    import sys

    BLOCKED = ("jax", "jaxlib", "repro")


    class Block:
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"blocked import of {name!r}")
            return None


    sys.meta_path.insert(0, Block())
    import torch
    from repro_torch.api import UnlearnSpec
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.data import synthetic as syn
    from repro_torch.fleet import Fleet
    from repro_torch.models import lm as LM
    from repro_torch.robust import FaultInjector, FaultSpec, ForgetWAL, faults

    torch.set_num_threads(2)
    torch.use_deterministic_algorithms(True)
    init_dir, wal_dir, ckpt_dir = sys.argv[1:4]
    SEQ = 16
    cfg = LM.LMConfig(name="recov-t", n_layers=2, d_model=32, n_heads=4,
                      n_kv_heads=2, d_ff=64, vocab=64)
    toks, doms = syn.make_lm_domains(syn.LMDataConfig(
        vocab=64, n_domains=4, seq_len=SEQ, n_per_domain=8, seed=0))
    like = LM.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    params = ckpt.restore(init_dir, 0, like, device="cpu")[0]
    spec = UnlearnSpec.for_mode("ficabu", alpha=8.0, lam=1.0, tau=0.6,
                                checkpoint_every=2, chunk_size=4,
                                sweep_mode="scanned")
    fleet = Fleet()
    rt = fleet.add_tenant("a", cfg, toks, doms, SEQ, params=params,
                          spec=spec, device="cpu")
    rt.wal = ForgetWAL(wal_dir, "a")
    fleet.submit("a", 1, due_batch=1)
    fleet.drain(1)                      # applied at params_version 1
    fleet.checkpoint(ckpt_dir)          # durable: v1 params + Fisher
    fleet.submit("a", 2, due_batch=2)   # durable WAL accept...
    faults.install(FaultInjector([FaultSpec("kill_mid_drain",
                                            tenant="a")]))
    fleet.drain(2)                      # ...SIGKILLed before it applies
    print("UNREACHABLE", flush=True)
""")


def _close(got, want):
    """The serving tests' fp32 tolerance on a tree of the port's against one
    of the reference's."""
    a = bridge.paths(bridge.params_to_numpy(got))
    b = bridge.paths(jax.tree_util.tree_map(np.asarray, want))
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        d = np.abs(x - y)
        assert (d <= 1e-6 + 1e-4 * np.abs(y)).mean() >= 0.995, k
        assert (d <= 1e-6 + 1e-2 * np.abs(y)).mean() >= 0.999, k


def test_kill_mid_drain_recovers_bit_exact(tiny, tmp_path):
    toks, doms, jp, tp = tiny
    # the victim makes its data with the port's generator: the same arrays
    ntoks, ndoms = syn.make_lm_domains(syn.LMDataConfig(
        vocab=64, n_domains=4, seq_len=SEQ, n_per_domain=8, seed=0))
    assert np.array_equal(ntoks, toks) and np.array_equal(ndoms, doms)
    init_dir, wal_dir, ckpt_dir = (str(tmp_path / n)
                                   for n in ("init", "wal", "ckpt"))
    ckpt.save(init_dir, 0, tp)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _VICTIM, init_dir, wal_dir,
                           ckpt_dir], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == -9, proc.stderr[-4000:]
    assert "UNREACHABLE" not in proc.stdout
    assert ForgetWAL(wal_dir, "a").accounting() == {
        "accepted": 2, "applied": 1, "dead": 0, "pending": 1}

    fleet, rt = _build(tiny, wal_dir=wal_dir)
    report = fleet.recover(ckpt_dir)
    assert report["a"]["restored_step"] == 1
    assert report["a"]["restored_version"] == 1
    assert len(report["a"]["replayed"]) == 1
    assert rt.params_version == 2
    assert rt.wal.accounting() == {"accepted": 2, "applied": 2,
                                   "dead": 0, "pending": 0}

    twin, rt_twin = _build(tiny)
    twin.submit("a", 1, due_batch=1)
    twin.drain(1)
    twin.submit("a", 2, due_batch=2)
    twin.drain(2)
    assert rt_twin.params_version == 2
    assert _trees_bitwise_equal(rt.params, rt_twin.params)
    assert _trees_bitwise_equal(rt.unlearner.fisher_global,
                                rt_twin.unlearner.fisher_global)

    # the reference's recovery of the same crash, in process: its fleet is
    # abandoned after the WAL accept, a new one recovers
    jwal, jck = str(tmp_path / "jwal"), str(tmp_path / "jckpt")

    def jbuild():
        f = JFleet()
        r = f.add_tenant("a", JLM.LMConfig(**TINY), toks, doms, SEQ,
                         params=jp, spec=JSpec.for_mode("ficabu", **SPEC))
        r.wal = JWAL(jwal, "a")
        return f, r

    jf, _ = jbuild()
    jf.submit("a", 1, due_batch=1)
    jf.drain(1)
    jf.checkpoint(jck)
    jf.submit("a", 2, due_batch=2)
    jf2, jrt = jbuild()
    jreport = jf2.recover(jck)
    assert jreport["a"] == report["a"]
    assert jrt.params_version == rt.params_version == 2
    _close(rt.params, jrt.params)
