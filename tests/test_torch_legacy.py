"""The port's legacy CAU oracle (``repro_torch.core.cau.
context_adaptive_unlearn_legacy``, three steps per layer and no step cache)
as the oracle of the port's engine, and the MAC proxies
(``repro_torch.core.metrics``), against the JAX package.

  * the port's ``UnlearnSession.forget`` equals the port's legacy oracle
    BIT FOR BIT, in the trees and in ``selected_per_layer``,
    ``stopped_at_l``, ``checkpoints_hit``, ``forget_acc_trace`` and
    ``macs``, on ResNet-18-small, a tiny ViT and an MoE LM with its
    routers excluded (twins of tests/test_engine.py's legacy tests; the
    routers come through untouched), on weights from the reference's init;
  * the port's legacy oracle against the reference's, same weights, same
    Fisher (the reference's own I_D, bridged), same request: halting,
    checkpoints, the accuracy trace and the MACs EQUAL; the per-layer
    selection counts within 0.1% of the layer's parameters (a forget
    Fisher that differs in the last bit can flip a selection sitting on
    the threshold); the edited parameters within rtol 1e-4 / atol 1e-6 on
    >= 99.9% of the entries and rtol 1e-2 / atol 1e-5 on all (the slice
    tolerances of tests/test_torch_unlearn.py: beta = lam * I_D / I_Df
    carries the forget Fisher's error);
  * ``mac_proxy_table`` equals the reference's dict exactly (keys, values,
    types) at several MAC counts, and an unknown precision raises the same
    ValueError text.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs.ficabu_vision import RESNET18_SMALL as JRESNET  # noqa: E402
from repro.core import adapters as jadapters  # noqa: E402
from repro.core import cau as jcau  # noqa: E402
from repro.core import fisher as jfisher  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.models import vision as JV  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import adapters, cau, metrics  # noqa: E402
from repro_torch.engine import UnlearnSession  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models import vision as V  # noqa: E402

torch.set_num_threads(2)
STATS = ("stopped_at_l", "checkpoints_hit", "forget_acc_trace", "macs",
         "macs_ssd", "macs_vs_ssd_pct", "profile_S")


def _resnet():
    x, y = jsyn.make_classification(jsyn.ClsDataConfig(
        n_classes=JRESNET.n_classes, n_per_class=8,
        img_size=JRESNET.img_size, seed=0))
    jp = JV.init_resnet(jax.random.PRNGKey(0), JRESNET)
    jloss = lambda p, b: JV.cls_loss(JV.resnet_forward(p, JRESNET, b[0]), b[1])
    i_d = jfisher.diag_fisher(jloss, jp, (x[:16], y[:16]), chunk_size=8)
    tcfg = V.ResNetConfig(width=JRESNET.width, n_classes=JRESNET.n_classes,
                          img_size=JRESNET.img_size)
    cfg = jcau.UnlearnConfig(alpha=10.0, lam=1.0, tau=1 / 6 + 0.03,
                             checkpoint_every=2, balanced=True, chunk_size=8)
    return {"jp": jp, "i_d": i_d, "x": x[16:32], "y": y[16:32], "cfg": cfg,
            "jadapter": jadapters.resnet_adapter(JRESNET),
            "adapter": adapters.resnet_adapter(tcfg, device="cpu")}


def _vit():
    jcfg = JV.ViTConfig(name="vit-t", n_layers=4, d_model=32, n_heads=2,
                        d_ff=64, n_classes=6, img_size=16, patch=4)
    x, y = jsyn.make_classification(jsyn.ClsDataConfig(
        n_classes=6, n_per_class=8, img_size=16, seed=0))
    jp = JV.init_vit(jax.random.PRNGKey(0), jcfg)
    jloss = lambda p, b: JV.cls_loss(JV.vit_forward(p, jcfg, b[0]), b[1])
    i_d = jfisher.diag_fisher(jloss, jp, (x[:16], y[:16]), chunk_size=8)
    tcfg = V.ViTConfig(n_layers=4, d_model=32, n_heads=2, d_ff=64,
                       n_classes=6, img_size=16, patch=4)
    cfg = jcau.UnlearnConfig(alpha=5.0, lam=1.0, tau=-1.0,
                             checkpoint_every=2, balanced=True, chunk_size=8)
    return {"jp": jp, "i_d": i_d, "x": x[:16], "y": y[:16], "cfg": cfg,
            "jadapter": jadapters.vit_adapter(jcfg),
            "adapter": adapters.vit_adapter(tcfg, device="cpu")}


def _moe():
    kw = dict(name="moe-t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
              d_ff=64, vocab=64)
    jcfg = JLM.LMConfig(**kw, moe=JLM.MoESpec(num_experts=4, top_k=2))
    tcfg = LM.LMConfig(**kw, moe=LM.MoESpec(num_experts=4, top_k=2))
    toks, _ = jsyn.make_lm_domains(jsyn.LMDataConfig(
        vocab=64, n_domains=2, seq_len=16, n_per_domain=8, seed=0))
    jp = JLM.init_lm(jax.random.PRNGKey(0), jcfg)
    jloss = lambda p, b: JLM.lm_loss(p, jcfg, b[0], b[1], aux_weight=0.0)
    i_d = jfisher.diag_fisher(jloss, jp, (toks[:, :-1], toks[:, 1:]),
                              chunk_size=4)
    fb = toks[:8]
    cfg = jcau.UnlearnConfig(alpha=4.0, lam=0.5, tau=-1.0,
                             checkpoint_every=1, balanced=True, chunk_size=4)
    adapter = adapters.lm_adapter(tcfg, 16, device="cpu")
    assert adapter.exclude is not None  # router exclusion active
    return {"jp": jp, "i_d": i_d, "x": fb[:, :-1], "y": fb[:, 1:],
            "cfg": cfg, "jadapter": jadapters.lm_adapter(jcfg, 16),
            "adapter": adapter}


MODELS = {"resnet": _resnet, "vit": _vit, "moe": _moe}


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    """The reference's init, Fisher and request, bridged to the port, and
    the port's legacy and engine results on them."""
    m = MODELS[request.param]()
    m["name"] = request.param
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    m["params"] = bridge.params_to_torch(host(m["jp"]), device="cpu")
    m["fisher"] = bridge.params_to_torch(host(m["i_d"]), device="cpu")
    m["tx"] = torch.as_tensor(m["x"])
    m["ty"] = torch.as_tensor(m["y"]).long()
    tcfg = cau.UnlearnConfig(**{
        k: getattr(m["cfg"], k) for k in ("alpha", "lam", "tau",
                                          "checkpoint_every", "balanced",
                                          "chunk_size")})
    m["legacy"] = cau.context_adaptive_unlearn_legacy(
        m["adapter"], m["params"], m["fisher"], m["tx"], m["ty"], tcfg)
    m["engine"] = UnlearnSession(m["adapter"], m["fisher"]).forget(
        m["params"], m["tx"], m["ty"], tcfg)
    return m


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_engine_equals_legacy_bit_for_bit(model):
    (pl, sl), (pe, se) = model["legacy"], model["engine"]
    a, b = bridge.paths(pl), bridge.paths(pe)
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(_bits(a[k]), _bits(b[k])), k
    for key in ("selected_per_layer",) + STATS:
        assert sl[key] == se[key], key
    # the request did edit something, and (ficabu, tau = -1 on the ViT and
    # the MoE) swept every layer
    assert sum(sl["selected_per_layer"].values()) > 0
    ad = model["adapter"]
    if model["name"] != "resnet":
        assert sl["stopped_at_l"] == ad.n_layers
    if model["name"] == "moe":
        # the routers come through both paths untouched
        for j in range(1, ad.n_layers - 1):
            orig = ad.get_layer(model["params"], j)["ffn"]["router"]
            for tree in (pl, pe):
                assert torch.equal(ad.get_layer(tree, j)["ffn"]["router"],
                                   orig)


def test_legacy_matches_reference_legacy(model):
    jnew, jst = jcau.context_adaptive_unlearn_legacy(
        model["jadapter"], model["jp"], model["i_d"], model["x"], model["y"],
        model["cfg"])
    pl, sl = model["legacy"]
    for key in STATS:
        assert sl[key] == jst[key], key
    counts = model["adapter"]
    prm = cau._layer_param_counts(counts, model["params"])
    L = counts.n_layers
    assert sorted(sl["selected_per_layer"]) == sorted(jst["selected_per_layer"])
    for l, n in jst["selected_per_layer"].items():
        assert abs(sl["selected_per_layer"][l] - n) <= 1e-3 * prm[L - l], l
    want = bridge.paths(jax.tree_util.tree_map(np.asarray, jnew))
    got = bridge.paths(bridge.params_to_numpy(pl))
    assert sorted(want) == sorted(got)
    for k in want:
        w = np.asarray(want[k], np.float64)
        g = np.asarray(got[k], np.float64)
        close = np.isclose(g, w, rtol=1e-4, atol=1e-6)
        assert close.mean() >= 0.999, (k, close.mean())
        np.testing.assert_allclose(g, w, rtol=1e-2, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("macs", [0, 1, 12_345, 2_468_013_579, 10 ** 15])
def test_mac_proxy_table_equals_reference(macs):
    got, want = metrics.mac_proxy_table(macs), jmetrics.mac_proxy_table(macs)
    assert list(got) == list(want)
    for k in want:
        assert type(got[k]) is type(want[k]) and got[k] == want[k], k
    for p in ("fp32", "int8"):
        assert metrics.byte_macs(macs, p) == jmetrics.byte_macs(macs, p)
        assert metrics.mac_energy_j(macs, p) == jmetrics.mac_energy_j(macs, p)
    assert metrics.MAC_OPERAND_BYTES == jmetrics.MAC_OPERAND_BYTES
    assert metrics.MAC_ENERGY_PJ == jmetrics.MAC_ENERGY_PJ


@pytest.mark.parametrize("fn", ["byte_macs", "mac_energy_j"])
def test_mac_proxy_refuses_unknown_precision(fn):
    with pytest.raises(ValueError) as want:
        getattr(jmetrics, fn)(10, "bf16")
    with pytest.raises(ValueError) as got:
        getattr(metrics, fn)(10, "bf16")
    assert str(got.value) == str(want.value)
