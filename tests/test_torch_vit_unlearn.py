"""The ViT slice end to end: one FiCABU forget request through the port's
``Unlearner`` against the JAX package's, on a JAX-trained tiny ViT.

The tiny ViT (3 blocks, d_model 32, 2 heads, d_ff 64, 16x16 images, patch
4: 17 tokens, 5 unlearn layers) is trained here in JAX on the synthetic
6-class data, as ``tests/conftest.py::trained_resnet`` trains the ResNet,
and bridged into the port. Both facades then serve the same forget request
(alpha 5, lambda 1, b_r 5: the reference's ViT settings; chunk 8;
``checkpoint_every=2``, so the checkpoints are l = 1, 2, 4, 5). The port
runs on the CPU, where the dampening wrappers take their plain versions;
the JAX side runs its Pallas kernels in interpret mode. What must hold:

  * the global Fisher I_D at rtol 1e-4 / atol 1e-12 on >= 99.9% of its
    entries and at rtol 2e-3 on every entry but ``attn/bk``'s. A key bias
    moves every score of a query by the same amount, which the softmax
    cancels: its gradient is zero in exact arithmetic, so its Fisher is
    rounding noise (~1e-16) on either side. It is held at atol 1e-12
    alone;
  * per mode (ssd/cau/bd/ficabu, and ficabu with tau = 0 so that the sweep
    passes every checkpoint): halting, checkpoints, the accuracy trace,
    the profile and the MACs EQUAL; the per-layer selection counts within
    0.1% of the layer's parameters; the edit masks agree on >= 99.9% of
    the entries outside ``attn/bk`` (whose selection compares noise with
    noise) and, where they agree, the values at rtol 1e-4 / atol 1e-6 on
    >= 99.5% of them and at rtol 1e-2 on all; ``attn/bk`` moves by at
    most the size of its entries (a dampened entry is theta * beta with
    beta in [0, 1]);
  * the build/hit counts of every family (fused, partial, quant) EQUAL the
    reference's. The activations are shape-uniform, so the checkpoints at
    j >= 1 share one depth-operand runner and j = 0 takes its own: 2
    "partial" builds for the tau = 0 request, as the reference counts;
  * a warm request builds nothing; without donation the caller's tensors
    are untouched.

The int8 path (ssd and ficabu with tau = 0) as in
``tests/test_torch_unlearn.py``: halting, checkpoints, trace, profile, MACs
and counts equal; selection counts within 0.1%; every deployed leaf on
the reference's q8 grid, the codes equal on >= 99.9% of the entries and
the values bit-equal wherever the codes agree; per layer
||p8 - p32|| / ||p32|| in (0, INT8_SWEEP_RTOL] and within 5% (relative)
of the reference's own value.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import ForgetRequest as JRequest  # noqa: E402
from repro.api import UnlearnSpec as JSpec  # noqa: E402
from repro.api import Unlearner as JUnlearner  # noqa: E402
from repro.core import adapters as jadapters  # noqa: E402
from repro.core import fisher as jfisher  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import ForgetRequest, Unlearner, UnlearnSpec  # noqa: E402
from repro_torch.core import adapters as tadapters  # noqa: E402
from repro_torch.core import fisher as tfisher  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models import vision as TV  # noqa: E402
from repro_torch.models.module import tree_leaves  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402

torch.set_num_threads(2)
TINY = dict(n_layers=3, d_model=32, n_heads=2, d_ff=64, n_classes=6,
            img_size=16, patch=4)
L = TINY["n_layers"] + 2
FORGET = 2
RANDOM_GUESS = 1.0 / 6 + 0.03
CASES = {m: (m, {}) for m in ("ssd", "cau", "bd", "ficabu")}
CASES["ficabu-tau0"] = ("ficabu", {"tau": 0.0})
CASES8 = {"ssd": ("ssd", {}), "ficabu-tau0": ("ficabu", {"tau": 0.0})}
STAT_KEYS = ("stopped_at_l", "checkpoints_hit", "forget_acc_trace",
             "profile_S", "macs", "macs_ssd", "macs_vs_ssd_pct")
COUNTERS = ("fused_compiles", "fused_hits", "partial_compiles",
            "partial_hits")
COUNTERS8 = COUNTERS + ("quant_compiles", "quant_hits")


def _noise(path):
    """Leaves whose gradient is zero in exact arithmetic (module
    docstring)."""
    return path.endswith("attn/bk")


def _np_tree(t):
    return bridge.paths(bridge.params_to_numpy(t))


def _jax_tree(t):
    return bridge.paths(jax.tree_util.tree_map(np.asarray, t))


@pytest.fixture(scope="module")
def setting():
    """The tiny ViT trained to ~100% in JAX (AdamW, 150 steps), its global
    Fisher on both sides, and both adapters."""
    from repro.data import synthetic as jsyn
    from repro.models import vision as JV
    from repro.optim import AdamWConfig, init_adamw, make_train_step

    x, y = jsyn.make_classification(jsyn.ClsDataConfig(
        n_classes=6, n_per_class=32, img_size=16, seed=0))
    jcfg = JV.ViTConfig(**TINY)
    params = JV.init_vit(jax.random.PRNGKey(0), jcfg)
    ocfg = AdamWConfig(lr=2e-3, total_steps=150, warmup_steps=10,
                       weight_decay=1e-4)

    def loss_fn(p, b):
        return JV.cls_loss(JV.vit_forward(p, jcfg, b[0]), b[1])

    step = jax.jit(make_train_step(loss_fn, ocfg))
    st = init_adamw(ocfg, params)
    bt = jsyn.Batches((x, y), batch=48, seed=1)
    for _ in range(150):
        params, st, _ = step(params, st, next(bt))

    tcfg = TV.ViTConfig(**TINY)
    tparams = bridge.params_to_torch(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")

    def tloss(p, b):
        return TV.cls_loss(TV.vit_forward(p, tcfg, b[0]), b[1])

    batches = [(x[i:i + 32], y[i:i + 32]) for i in range(0, len(y) - 31, 32)]
    return {
        "x": x, "y": y, "params": params, "tparams": tparams,
        "splits": tsyn.split_forget_retain(x, y, forget_class=FORGET),
        "jI": jfisher.diag_fisher_streaming(loss_fn, params, batches,
                                            chunk_size=8),
        "tI": tfisher.diag_fisher_streaming(tloss, tparams, batches,
                                            chunk_size=8, device="cpu"),
        "jadapter": jadapters.vit_adapter(jcfg),
        "tadapter": tadapters.vit_adapter(tcfg, device="cpu"),
    }


def _spec(cls, mode, **kw):
    kw = {"tau": RANDOM_GUESS, **kw}
    return cls.for_mode(mode, alpha=5.0, lam=1.0, b_r=5.0,
                        checkpoint_every=2, chunk_size=8, use_kernel=True,
                        **kw)


def _serve(s, cases, **extra):
    """Each case cold then warm on both facades (a fresh Unlearner per
    case), and the caller's tensors as they were before."""
    fx, fy = s["splits"]["forget"]
    fx, fy = fx[:32], fy[:32]
    before = {k: v.clone() for k, v in bridge.paths(s["tparams"]).items()}
    out = {}
    for case, (mode, kw) in cases.items():
        kw = dict(kw, **extra)
        junl = JUnlearner(s["jadapter"], s["jI"], _spec(JSpec, mode, **kw))
        tunl = Unlearner(s["tadapter"], s["tI"],
                         _spec(UnlearnSpec, mode, **kw), device="cpu")
        jp, jst = junl.forget(JRequest(fx, fy), params=s["params"])
        tp, tst = tunl.forget(ForgetRequest(fx, fy), params=s["tparams"])
        _, jwarm = junl.forget(JRequest(fx, fy), params=s["params"])
        _, twarm = tunl.forget(ForgetRequest(fx, fy), params=s["tparams"])
        out[case] = {"j": (jp, jst, jwarm, junl.stats),
                     "t": (tp, tst, twarm, tunl.stats)}
    out["before"] = before
    return out


@pytest.fixture(scope="module")
def results(setting):
    return _serve(setting, CASES)


@pytest.fixture(scope="module")
def results8(setting):
    out = _serve(setting, CASES8, precision="int8")
    out["scales"] = _jax_tree(jcomp.q8_quantize_tree(setting["params"])[1])
    return out


def _assert_bulk_close(got, want, *, rtol, atol, bulk, rtol_all, mask=None):
    """Over the tree (by path): at least ``bulk`` of the entries within
    rtol/atol and every entry within rtol_all/atol."""
    ok = total = 0
    for k in want:
        g, w = got[k], want[k]
        if mask is not None:
            g, w = g[mask[k]], w[mask[k]]
        np.testing.assert_allclose(g, w, rtol=rtol_all, atol=atol, err_msg=k)
        ok += int((np.abs(g - w) <= atol + rtol * np.abs(w)).sum())
        total += w.size
    assert ok >= bulk * total, (ok, total)


def test_global_fisher_matches_jax(setting):
    want = _jax_tree(setting["jI"])
    got = _np_tree(setting["tI"])
    assert sorted(got) == sorted(want) and len(want) == 4 + 14 * 3 + 4
    noise = {k for k in want if _noise(k)}
    for k in noise:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12,
                                   err_msg=k)
    _assert_bulk_close({k: got[k] for k in want if k not in noise},
                       {k: v for k, v in want.items() if k not in noise},
                       rtol=1e-4, atol=1e-12, bulk=0.999, rtol_all=2e-3)


@pytest.mark.parametrize("case", CASES)
def test_halting_and_macs_equal_jax(results, case):
    _, jst, _, _ = results[case]["j"]
    _, tst, _, _ = results[case]["t"]
    for k in STAT_KEYS:
        assert tst[k] == jst[k], (case, k, tst[k], jst[k])
    assert tst["mode"] == jst["mode"] == CASES[case][0]
    assert set(tst["engine"]) == set(jst["engine"])
    assert tst["engine"]["uniform_suffix"] is jst["engine"]["uniform_suffix"]
    assert tst["engine"]["uniform_suffix"] is True
    if case == "ficabu-tau0":
        assert tst["checkpoints_hit"] == [1, 2, 4, 5]
        assert tst["stopped_at_l"] == L


@pytest.mark.parametrize("case", CASES)
def test_selection_counts_within_tolerance(setting, results, case):
    _, jst, _, _ = results[case]["j"]
    _, tst, _, _ = results[case]["t"]
    _assert_counts_close(setting, jst, tst)


def _assert_counts_close(setting, jst, tst):
    adapter = setting["tadapter"]
    assert sorted(tst["selected_per_layer"]) == \
        sorted(jst["selected_per_layer"])
    for l, n_j in jst["selected_per_layer"].items():
        n_prm = sum(t.numel() for t in bridge.paths(
            adapter.get_layer(setting["tparams"], L - l)).values())
        assert abs(tst["selected_per_layer"][l] - n_j) <= 1e-3 * n_prm, l


@pytest.mark.parametrize("case", CASES)
def test_edited_params_match_jax(setting, results, case):
    orig = _jax_tree(setting["params"])
    want = _jax_tree(results[case]["j"][0])
    got = _np_tree(results[case]["t"][0])
    agree = total = 0
    same = {}
    for k in want:
        if _noise(k):
            np.testing.assert_array_less(np.abs(got[k] - want[k]),
                                         np.abs(orig[k]) + 1e-30,
                                         err_msg=k)
            continue
        same[k] = (want[k] != orig[k]) == (got[k] != orig[k])
        agree += int(same[k].sum())
        total += same[k].size
    assert agree >= 0.999 * total, (agree, total)
    _assert_bulk_close({k: got[k] for k in same},
                       {k: want[k] for k in same}, rtol=1e-4, atol=1e-6,
                       bulk=0.995, rtol_all=1e-2, mask=same)


@pytest.mark.parametrize("case", CASES)
def test_counts_equal_jax_and_warm_builds_nothing(results, case):
    _, jst, jwarm, jcounts = results[case]["j"]
    _, tst, twarm, tcounts = results[case]["t"]
    assert twarm["engine"]["compiles"] == jwarm["engine"]["compiles"] == 0
    assert twarm["engine"]["cache_hits"] == jwarm["engine"]["cache_hits"]
    assert tst["engine"]["compiles"] == jst["engine"]["compiles"]
    for k in COUNTERS:
        assert tcounts[k] == jcounts[k], (k, tcounts, jcounts)
    # the patch, block and head steps; every block shares one
    assert tcounts["fused_compiles"] == min(3, tst["stopped_at_l"])
    if case == "ficabu-tau0":
        # the depth-operand runner for j = 4, 3, 1 and the j = 0 runner
        assert tcounts["partial_compiles"] == 2
        assert tcounts["partial_hits"] == 2 + 4


def test_forget_leaves_caller_tensors_untouched(setting, results):
    for k, t in bridge.paths(setting["tparams"]).items():
        assert torch.equal(t, results["before"][k]), k


def test_forget_accuracy_falls(setting, results):
    """Every mode leaves the forget class no better recognised than
    before, on both sides alike."""
    fx, fy = setting["splits"]["forget"]
    cfg = TV.ViTConfig(**TINY)

    def acc(p):
        return float(TV.cls_accuracy(TV.vit_forward(
            p, cfg, torch.from_numpy(fx)), torch.from_numpy(fy)))

    start = acc(setting["tparams"])
    assert start > 0.9
    for case in CASES:
        assert acc(results[case]["t"][0]) < start, case


# -- the int8 path (precision="int8") ---------------------------------------
@pytest.mark.parametrize("case", CASES8)
def test_int8_halting_macs_and_counts_equal_jax(setting, results8, case):
    _, jst, jwarm, jcounts = results8[case]["j"]
    _, tst, twarm, tcounts = results8[case]["t"]
    for k in STAT_KEYS:
        assert tst[k] == jst[k], (case, k, tst[k], jst[k])
    assert tst["engine"]["precision"] == jst["engine"]["precision"] == "int8"
    assert set(tst["engine"]) == set(jst["engine"])
    _assert_counts_close(setting, jst, tst)
    assert twarm["engine"]["compiles"] == jwarm["engine"]["compiles"] == 0
    assert twarm["engine"]["cache_hits"] == jwarm["engine"]["cache_hits"]
    for k in COUNTERS8:
        assert tcounts[k] == jcounts[k], (k, tcounts, jcounts)
    assert tcounts["quant_compiles"] == 1 and tcounts["quant_hits"] == 1
    if case == "ficabu-tau0":
        assert tst["checkpoints_hit"] == [1, 2, 4, 5]
        assert tcounts["partial_compiles"] == 2


@pytest.mark.parametrize("case", CASES8)
def test_int8_codes_match_jax(setting, results8, case):
    scales = results8["scales"]
    want = _jax_tree(results8[case]["j"][0])
    got = _np_tree(results8[case]["t"][0])
    orig = _jax_tree(setting["params"])
    agree = total = edited = 0
    for k, sc in scales.items():
        cj, ct = np.round(want[k] / sc), np.round(got[k] / sc)
        # every deployed leaf lies on its grid: value == f32(code * scale)
        np.testing.assert_array_equal(want[k], (cj * sc).astype(np.float32))
        np.testing.assert_array_equal(got[k], (ct * sc).astype(np.float32))
        assert np.abs(ct).max() <= 127, k
        same = cj == ct
        agree += int(same.sum())
        total += same.size
        np.testing.assert_array_equal(got[k][same].view(np.uint32),
                                      want[k][same].view(np.uint32),
                                      err_msg=k)
        edited += int((ct != np.round(orig[k] / sc)).sum())
    assert agree >= 0.999 * total, (agree, total)
    assert edited > 0


@pytest.mark.parametrize("case", CASES8)
def test_int8_error_against_fp32_within_contract(setting, results, results8,
                                                 case):
    s = setting
    rels = {}
    for side in ("t", "j"):
        adapter = s["tadapter"] if side == "t" else s["jadapter"]
        p8, p32 = results8[case][side][0], results[case][side][0]
        leaves = tree_leaves if side == "t" else jax.tree_util.tree_leaves
        rels[side] = []
        for j in range(adapter.n_layers):
            a = [np.asarray(x, np.float64) for x in
                 leaves(adapter.get_layer(p8, j))]
            b = [np.asarray(x, np.float64) for x in
                 leaves(adapter.get_layer(p32, j))]
            d = sum(float(((x - y) ** 2).sum()) for x, y in zip(a, b))
            n = sum(float((y ** 2).sum()) for y in b)
            rels[side].append((d / n) ** 0.5)
    for j, (rt, rj) in enumerate(zip(rels["t"], rels["j"])):
        assert 0.0 < rt <= tcomp.INT8_SWEEP_RTOL, (j, rels)
        assert abs(rt - rj) <= 0.05 * rj, (j, rels)


def test_int8_forget_leaves_caller_tensors_untouched(setting, results8):
    for k, t in bridge.paths(setting["tparams"]).items():
        assert torch.equal(t, results8["before"][k]), k
