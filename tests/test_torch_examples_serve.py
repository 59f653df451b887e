"""The port's launcher examples on the host (``--device cpu``):

  * ``examples/torch_load_fleet_smoke.py`` on the reference's tenant
    weights (bridged, as ``tests/test_torch_load.py`` holds the harness):
    the two runs' fingerprints equal each other AND the reference's run of
    the same scenario, the SLOs met, the queues bounded, no steady-state
    build.

``examples/torch_train_then_forget.py`` and
``examples/torch_fleet_two_tenants.py`` have files of their own,
``tests/test_torch_examples_train.py`` and
``tests/test_torch_examples_fleet.py``."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import load as jload  # noqa: E402
from repro.fleet import Fleet as JFleet  # noqa: E402
from repro.fleet import FleetSpec as JFleetSpec  # noqa: E402
from repro.obs import telemetry as jtel  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def reference_archs():
    """Every reference architecture registered: ``repro.configs`` fills its
    registry only where it is empty, and a test run earlier in this process
    may have imported a few of its config modules one by one."""
    jconfigs._load_all()


def example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_load_fingerprints_equal_the_reference():
    twin = example("torch_load_fleet_smoke")
    fspec = twin.FLEET.to_dict()
    sc = twin.SCENARIO

    built = {}

    def jbuild(t):
        """The reference's tenant, drawn once per tenant (its arrays are
        immutable; each fleet edits copies)."""
        if t.name not in built:
            built[t.name] = jload.build_lm_tenant(
                t, prompt_len=sc.prompt_len, gen_len=sc.gen_len)
        return dict(built[t.name])

    def tbuild(t):
        b = jbuild(t)
        return dict(b, cfg=configs.get(t.arch).smoke,
                    params=bridge.params_to_torch(jax.tree_util.tree_map(
                        np.asarray, b["params"]), device="cpu"))

    out = twin.run("cpu", build_tenant=tbuild)
    jfleet = JFleet.from_spec(JFleetSpec.from_dict(fspec), jbuild)
    jt = jtel.Telemetry(clock=jtel.VirtualClock(), keep=True)
    try:
        theirs = jload.LoadHarness(jfleet, jload.LoadScenario.from_dict(
            sc.to_dict())).run(jt)
    finally:
        jt.close()
    res, replay = out["res"], out["replay"]
    assert res["fingerprint"] == replay["fingerprint"] \
        == theirs["fingerprint"]
    assert res["event_counts"] == theirs["event_counts"]
    assert out["evaluation"]["ok"]
    assert res["fleet"]["queue_depth_max"] <= twin.FLEET.max_queue_per_tenant
    assert res["fleet"]["merged"] > 0          # the burst folded
    assert res["fleet"]["steady_state_compiles"] == 0
    assert "Load smoke SLO report" in out["report"]
