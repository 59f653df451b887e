"""The port's request vocabulary and facade lifecycle against the JAX
package's: spec lowering and JSON round trip, the slices not ported yet
refused by name, the structure-locked global Fisher, and the metrics."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.api import UnlearnSpec as JSpec  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro_torch.api import ForgetRequest, Unlearner, UnlearnSpec  # noqa: E402
from repro_torch.core import adapters, metrics  # noqa: E402
from repro_torch.core.cau import UnlearnConfig  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.models import vision as V  # noqa: E402

torch.set_num_threads(2)
SHARED = ("alpha", "lam", "tau", "checkpoint_every", "balanced", "b_r",
          "c_m", "chunk_size", "use_kernel", "max_layers", "sweep_mode",
          "precision")


@pytest.mark.parametrize("mode", ["ssd", "cau", "bd", "ficabu"])
def test_spec_lowers_like_the_reference(mode):
    kw = dict(alpha=7.0, lam=0.3, tau=0.2, checkpoint_every=3, b_r=4.0,
              c_m=2.5, max_layers=6, chunk_size=4, use_kernel=True)
    got = UnlearnSpec.for_mode(mode, **kw).to_config()
    want = JSpec.for_mode(mode, **kw).to_config()
    for f in SHARED:
        assert getattr(got, f) == getattr(want, f), f


def test_spec_json_round_trip_and_validation():
    spec = UnlearnSpec.for_mode("bd", alpha=3.0, c_m=4.0, donate=True)
    back = UnlearnSpec.from_json(spec.to_json())
    assert back == spec
    assert json.loads(spec.to_json())["exec"]["donate"] is True
    with pytest.raises(ValueError, match="mode"):
        UnlearnSpec.for_mode("nope")
    with pytest.raises(ValueError, match="unknown"):
        UnlearnSpec.from_dict({"mode": "ssd", "refresh": None})
    with pytest.raises(ValueError, match="alpha"):
        UnlearnSpec.for_mode("ssd", alpha=-1.0)


@pytest.mark.parametrize("kw,slice_word", [
    ({"sweep_mode": "scanned"}, "scanned-sweep slice"),
    ({"precision": "int8"}, "int8 slice")])
def test_unported_modes_raise_naming_their_slice(kw, slice_word):
    with pytest.raises(ValueError, match=slice_word):
        UnlearnSpec.for_mode("ficabu", **kw)
    with pytest.raises(ValueError, match=slice_word):
        UnlearnConfig(**kw)


@pytest.fixture(scope="module")
def tiny():
    cfg = V.ResNetConfig(width=8, n_classes=4, img_size=8)
    params = V.init_resnet(torch.Generator().manual_seed(1), cfg,
                           device="cpu")
    x, y = syn.make_classification(syn.ClsDataConfig(
        n_classes=4, n_per_class=8, img_size=8, seed=1))
    loss = lambda p, b: V.cls_loss(V.resnet_forward(p, cfg, b[0]), b[1])  # noqa: E731
    return cfg, params, x, y, loss


def test_fisher_lifecycle_and_with_spec(tiny):
    cfg, params, x, y, loss = tiny
    adapter = adapters.resnet_adapter(cfg, device="cpu")
    unl = Unlearner(adapter, spec=UnlearnSpec.for_mode("ssd", chunk_size=4),
                    device="cpu")
    with pytest.raises(ValueError, match="no global Fisher"):
        unl.forget((x[:4], y[:4]), params=params)
    fisher = unl.ensure_fisher(loss, params, (x[:8], y[:8]))
    assert unl.ensure_fisher(loss, params, (x[8:16], y[8:16])) is fisher
    bad = dict(fisher, fc={"w": torch.zeros(3, 3), "b": fisher["fc"]["b"]})
    with pytest.raises(ValueError, match="structurally different"):
        unl.set_fisher(bad)
    _, st = unl.forget(ForgetRequest(x[:4], y[:4], tag="t1"), params=params)
    assert st["tag"] == "t1" and st["mode"] == "ssd"
    sib = unl.with_spec(UnlearnSpec.for_mode("ssd", chunk_size=4))
    assert sib.session is unl.session
    _, st2 = sib.forget((x[:4], y[:4]), params=params)
    assert st2["engine"]["compiles"] == 0
    assert unl.stats["requests"] == 2
    other = adapters.resnet_adapter(cfg, device="cpu")
    with pytest.raises(ValueError, match="bound to adapter"):
        Unlearner(other, session=unl.session, device="cpu")


def test_metrics_match_reference():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(12, 5)).astype(np.float32)
    labels = rng.integers(0, 5, size=12).astype(np.int32)
    np.testing.assert_allclose(
        metrics.per_sample_nll(torch.from_numpy(logits),
                               torch.from_numpy(labels)).numpy(),
        np.asarray(jmetrics.per_sample_nll(jnp.asarray(logits),
                                           jnp.asarray(labels))),
        rtol=1e-6, atol=1e-6)
    assert float(metrics.accuracy(torch.from_numpy(logits),
                                  torch.from_numpy(labels))) == \
        float(jmetrics.accuracy(jnp.asarray(logits), jnp.asarray(labels)))
    f, h = rng.normal(size=20), rng.normal(size=30) + 0.5
    assert metrics.mia_accuracy(f, h) == jmetrics.mia_accuracy(f, h)
    assert metrics.rpr(0.02, 0.08) == jmetrics.rpr(0.02, 0.08)
    mc_t = metrics.MacCounter([10, 20, 30], [1, 2, 3], batch=4)
    mc_j = jmetrics.MacCounter([10, 20, 30], [1, 2, 3], batch=4)
    for mc in (mc_t, mc_j):
        mc.add_forward_all()
        mc.add_backward_layer(2)
        mc.add_fisher_layer(2)
        mc.add_dampen_layer(2)
        mc.add_partial_inference(1, 3)
    assert mc_t.total == mc_j.total
    assert metrics.MacCounter.ssd_total([10, 20], [3, 4], 2) == \
        jmetrics.MacCounter.ssd_total([10, 20], [3, 4], 2)


def test_restore_excluded_keeps_excluded_paths():
    """Excluded parameter paths (the reference excludes MoE routers) come
    back untouched after dampening; the others keep the edit."""
    from repro_torch.core.cau import _restore_excluded
    old = {"a": {"router": torch.ones(2), "w": torch.ones(2)}}
    new = {"a": {"router": torch.zeros(2), "w": torch.zeros(2)}}
    out = _restore_excluded(lambda path: "router" in path, new, old)
    assert out["a"]["router"] is old["a"]["router"]
    assert out["a"]["w"] is new["a"]["w"]
