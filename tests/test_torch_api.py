"""The port's request vocabulary and facade lifecycle against the JAX
package's: spec lowering and JSON round trip (the int8 ``QuantSpec``
included), the engine modes and their refusals, the structure-locked
global Fisher, and the metrics."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.api import ExecSpec as JExecSpec  # noqa: E402
from repro.api import QuantSpec as JQuantSpec  # noqa: E402
from repro.api import UnlearnSpec as JSpec  # noqa: E402
from repro.core import cau as jcau  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro_torch.api import (ExecSpec, ForgetRequest, QuantSpec,  # noqa: E402
                             Unlearner, UnlearnSpec)
from repro_torch import bridge  # noqa: E402
from repro_torch.core import adapters, metrics  # noqa: E402
from repro_torch.core.cau import (UnlearnConfig, _chunk,  # noqa: E402
                                  _logit_cotangents)
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.engine import build_fused_step  # noqa: E402
from repro_torch.models import vision as V  # noqa: E402
from repro_torch.models.module import tree_map  # noqa: E402

torch.set_num_threads(2)
SHARED = ("alpha", "lam", "tau", "checkpoint_every", "balanced", "b_r",
          "c_m", "chunk_size", "use_kernel", "max_layers", "sweep_mode",
          "precision", "quant_min_scale")


@pytest.mark.parametrize("mode", ["ssd", "cau", "bd", "ficabu"])
def test_spec_lowers_like_the_reference(mode):
    """fp32, int8 with the default calibration, and int8 with a QuantSpec
    whose min_scale lowers to quant_min_scale."""
    kw = dict(alpha=7.0, lam=0.3, tau=0.2, checkpoint_every=3, b_r=4.0,
              c_m=2.5, max_layers=6, chunk_size=4, use_kernel=True)
    for extra, jextra in (({}, {}),
                          ({"precision": "int8"}, {"precision": "int8"}),
                          ({"precision": "int8",
                            "quant": QuantSpec(min_scale=1e-10)},
                           {"precision": "int8",
                            "quant": JQuantSpec(min_scale=1e-10)})):
        got = UnlearnSpec.for_mode(mode, **kw, **extra).to_config()
        want = JSpec.for_mode(mode, **kw, **jextra).to_config()
        for f in SHARED:
            assert getattr(got, f) == getattr(want, f), (f, extra)
    assert got.precision == "int8" and got.quant_min_scale == 1e-10


def test_spec_json_round_trip_and_validation():
    spec = UnlearnSpec.for_mode("bd", alpha=3.0, c_m=4.0, donate=True)
    back = UnlearnSpec.from_json(spec.to_json())
    assert back == spec
    assert json.loads(spec.to_json())["exec"]["donate"] is True
    with pytest.raises(ValueError, match="mode"):
        UnlearnSpec.for_mode("nope")
    with pytest.raises(ValueError, match="unknown"):
        UnlearnSpec.from_dict({"mode": "ssd", "shard": None})
    # "refresh" is a field since the refresh slice: it round-trips
    assert UnlearnSpec.from_dict({"mode": "ssd", "refresh": None}) == \
        UnlearnSpec.for_mode("ssd")
    with pytest.raises(ValueError, match="alpha"):
        UnlearnSpec.for_mode("ssd", alpha=-1.0)


@pytest.mark.parametrize("kw,slice_word", [
    ({"sweep_mode": "scanned"}, "scanned-sweep slice"),
    ({"precision": "int8"}, "int8 slice")],
    ids=["kw0-scanned-sweep slice", "kw1-int8 slice"])
def test_unported_modes_raise_naming_their_slice(kw, slice_word):
    """Both modes came with their slices (the int8 path, then the scanned
    sweep): each is accepted and lowered, and a mistyped value is refused
    with the reference's text."""
    if "precision" in kw:
        assert UnlearnSpec.for_mode("ficabu", **kw).to_config().precision \
            == UnlearnConfig(**kw).precision == "int8"
        for bad in ("int4", "fp16"):
            with pytest.raises(ValueError, match="precision must be one of"):
                UnlearnSpec.for_mode("ficabu", precision=bad)
            with pytest.raises(ValueError, match="mistyped precision"):
                UnlearnConfig(precision=bad)
            with pytest.raises(ValueError, match="mistyped precision"):
                jcau.UnlearnConfig(precision=bad)
        return
    assert UnlearnSpec.for_mode("ficabu", **kw).to_config().sweep_mode \
        == UnlearnConfig(**kw).sweep_mode == "scanned"
    for bad in ("Scanned", "fused"):
        with pytest.raises(ValueError) as got:
            UnlearnConfig(sweep_mode=bad)
        with pytest.raises(ValueError) as want:
            jcau.UnlearnConfig(sweep_mode=bad)
        assert str(got.value) == str(want.value)
        with pytest.raises(ValueError) as got:
            ExecSpec(sweep_mode=bad)
        with pytest.raises(ValueError) as want:
            JExecSpec(sweep_mode=bad)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [{"bits": 4}, {"channel_axis": 1},
                                {"min_scale": 0.0}, {"min_scale": -1.0},
                                {"min_scale": float("nan")}],
                         ids=["bits", "channel_axis", "min_scale0",
                              "min_scale_neg", "min_scale_nan"])
def test_quantspec_validation_matches_reference(kw):
    with pytest.raises(ValueError) as got:
        QuantSpec(**kw)
    with pytest.raises(ValueError) as want:
        JQuantSpec(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("bad", [-1.0, 0.0, 1, float("inf")])
def test_quant_min_scale_validation_matches_reference(bad):
    with pytest.raises(ValueError) as got:
        UnlearnConfig(quant_min_scale=bad)
    with pytest.raises(ValueError) as want:
        jcau.UnlearnConfig(quant_min_scale=bad)
    assert str(got.value) == str(want.value)


def test_quant_on_fp32_is_a_contradiction():
    with pytest.raises(ValueError) as got:
        ExecSpec(precision="fp32", quant=QuantSpec())
    with pytest.raises(ValueError) as want:
        JExecSpec(precision="fp32", quant=JQuantSpec())
    assert str(got.value) == str(want.value)
    ex = ExecSpec(precision="int8", quant={"min_scale": 1e-9})
    assert ex.quant == QuantSpec(min_scale=1e-9)
    with pytest.raises(ValueError, match="unknown quant field"):
        ExecSpec(precision="int8", quant={"scale": 1.0})


def test_quantspec_json_round_trip_and_reference_reads_it():
    """The JSON carries ``quant``: the port reads its own JSON back
    unchanged, and the reference reads it into a spec that lowers to the
    same engine config."""
    spec = UnlearnSpec.for_mode("ficabu", alpha=8.0, tau=0.2,
                                precision="int8",
                                quant=QuantSpec(min_scale=1e-10))
    text = spec.to_json()
    assert json.loads(text)["exec"]["quant"] == {
        "bits": 8, "channel_axis": 0, "min_scale": 1e-10}
    back = UnlearnSpec.from_json(text)
    assert back == spec and back.exec.quant.min_scale == 1e-10
    jback = JSpec.from_json(text)
    assert jback.exec.quant == JQuantSpec(min_scale=1e-10)
    got, want = back.to_config(), jback.to_config()
    for f in SHARED:
        assert getattr(got, f) == getattr(want, f), f


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


def test_split_edit_step_equals_the_fused_step(tiny):
    """With the edit target equal to the vjp reference, the split-signature
    step (the int8 path's signature) computes exactly what the fused step
    does; an unknown precision is refused."""
    cfg, params, x, y, _ = tiny
    adapter = adapters.resnet_adapter(cfg, device="cpu")
    xs, ys = torch.as_tensor(x[:8]), torch.as_tensor(y[:8])
    logits, acts = adapter.forward_collect(params, xs)
    cot = _logit_cotangents(adapter.loss, _chunk(logits, 4), _chunk(ys, 4))
    gen = torch.Generator().manual_seed(2)
    for j in (adapter.n_layers - 1, adapter.n_layers - 2):
        layer_p = adapter.get_layer(params, j)
        fisher_g = tree_map(
            lambda v: torch.rand(v.shape, generator=gen) * 1e-3, layer_p)

        def apply_fn(c, lp, a, _j=j):
            return adapter.apply_layer(c, _j, lp, a)

        fused = build_fused_step(apply_fn, use_kernel=True)
        split = build_fused_step(apply_fn, use_kernel=True, split_edit=True)
        args = (_chunk(acts[j], 4), cot, (10.0, 1.0))
        new_f, g_f, n_f = fused(None, layer_p, fisher_g, *args)
        new_s, g_s, n_s = split(None, layer_p, layer_p, fisher_g, *args)
        assert int(n_f) == int(n_s) > 0
        assert torch.equal(g_f, g_s)
        a, b = bridge.paths(new_f), bridge.paths(new_s)
        assert all(torch.equal(a[k], b[k]) for k in a)
        cot = g_f
    with pytest.raises(ValueError, match="precision must be 'fp32' or "
                                         "'int8'"):
        build_fused_step(apply_fn, precision="int4")


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
