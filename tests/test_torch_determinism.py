"""Where the port turns on deterministic algorithms: ``repro_torch.device.
deterministic`` sets them for a CUDA device and restores the process's
setting after (nothing on the host or without a card), and the two entry
points whose gates hold one run bit for bit against another enter it
themselves: ``serve.main`` under ``--check`` (the fleet's solo replay) and
``LoadHarness.run`` (the double-run fingerprint), with the tenants'
device."""
import contextlib
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch import device as D  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.load import harness  # noqa: E402


@pytest.fixture
def restored():
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    yield prev
    torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


@pytest.mark.parametrize("card", [False, True])
def test_deterministic_sets_and_restores(restored, monkeypatch, card):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
    torch.use_deterministic_algorithms(False)
    with D.deterministic("cuda"):
        assert torch.are_deterministic_algorithms_enabled() is card
        assert torch.is_deterministic_algorithms_warn_only_enabled() is card
    assert not torch.are_deterministic_algorithms_enabled()
    # the caller's cuBLAS workspace setting is kept
    assert D.os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":16:8"


def test_deterministic_does_nothing_on_the_host(restored, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    torch.use_deterministic_algorithms(False)
    with D.deterministic("cpu"):
        assert not torch.are_deterministic_algorithms_enabled()
    assert not torch.are_deterministic_algorithms_enabled()


def test_deterministic_restores_after_a_failure(restored, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    torch.use_deterministic_algorithms(False)
    with pytest.raises(RuntimeError, match="drain"):
        with D.deterministic("cuda"):
            raise RuntimeError("drain")
    assert not torch.are_deterministic_algorithms_enabled()


def _recording(monkeypatch, module):
    """Replace ``module.deterministic`` by a recorder of its devices."""
    seen = []

    @contextlib.contextmanager
    def record(device):
        seen.append(str(device))
        yield

    monkeypatch.setattr(module, "deterministic", record)
    return seen


@pytest.mark.parametrize("argv, want", [
    (["--check", "--device", "cpu"], ["cpu"]),
    (["--check", "--fleet", "f.json", "--device", "cuda"], ["cuda"]),
    (["--device", "cpu"], []),
    (["--fleet", "f.json", "--device", "cpu"], []),
])
def test_serve_main_checks_under_deterministic(monkeypatch, argv, want):
    seen = _recording(monkeypatch, serve)
    monkeypatch.setattr(serve, "_main_one", lambda args: {"one": True})
    monkeypatch.setattr(serve, "_main_fleet", lambda args: {"fleet": True})
    res = serve.main(argv)
    assert seen == want
    assert res == ({"fleet": True} if "--fleet" in argv else {"one": True})


# None: a tenant without a device (a model-free fleet, as the CPU tests'
# stub fleets are)
@pytest.mark.parametrize("devices, want", [
    (("cpu", "cpu"), ["cpu"]), (("cpu", "cuda"), ["cuda"]),
    ((None, None), ["cpu"])])
def test_load_harness_runs_under_deterministic(monkeypatch, devices, want):
    seen = _recording(monkeypatch, harness)
    monkeypatch.setattr(harness.LoadHarness, "_run",
                        lambda self, tel: {"tel": tel})
    fleet = types.SimpleNamespace(tenants={
        f"t{i}": types.SimpleNamespace(**({} if d is None else
                                          {"device": torch.device(d)}))
        for i, d in enumerate(devices)})
    sc = harness.LoadScenario(ticks=1)
    assert harness.LoadHarness(fleet, sc).run("tel") == {"tel": "tel"}
    assert seen == want
