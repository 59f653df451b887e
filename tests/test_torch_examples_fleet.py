"""The port's fleet example (``examples/torch_fleet_two_tenants.py``) on
the host (``--device cpu``): ``serve --fleet --check`` passes every gate (a
failed gate exits), the same-family tenant's first drain builds nothing and
hits the shared cache, the other family builds its own, and no drain after
a tenant's first builds a program. The shared cache's counts and every
tenant's groups, sweeps and builds and hits per drain EQUAL the
reference's ``repro.launch.serve.main`` on the same fleet JSON and traffic
(without ``--check``: its solo replay changes none of these figures, and
the port's passed)."""
import importlib.util
import os
import tempfile
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402

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


def test_fleet_check_with_zero_warm_builds():
    twin = example("torch_fleet_two_tenants")
    out = twin.run("cpu")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fleet.json")
        with open(path, "w") as f:
            f.write(twin.FLEET.to_json(indent=1))
        want = twin.summary(jserve.main(
            ["--fleet", path] + [a for a in twin.ARGS if a != "--check"]))
    assert out == want
    tenants = out["tenants"]
    assert set(tenants) == {"acme", "globex", "initech"}
    assert tenants["acme"]["first_drain"]["compiles"] > 0
    assert tenants["globex"]["first_drain"] == {
        "compiles": 0, "cache_hits": tenants["globex"]["first_drain"][
            "cache_hits"]}
    assert tenants["globex"]["first_drain"]["cache_hits"] > 0
    assert tenants["initech"]["first_drain"]["compiles"] > 0
    for name, t in tenants.items():
        assert t["groups"] == t["sweeps"] == 2, name
        assert t["drain_compiles"][1:] == [0], name
    cache = out["cache"]
    assert cache["programs"] == cache["compiles"] == 2 and cache["hits"] > 0
