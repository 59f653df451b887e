"""The slice end to end: one FiCABU forget request through the port's
``Unlearner`` against the JAX package's, on the JAX-trained tiny ResNet.

Both sides start from the same weights (the ``trained_resnet`` fixture,
bridged into the port) and the same numpy data. The port runs on the CPU,
where the dampening wrapper takes its plain version; the JAX side runs its
Pallas kernel in interpret mode. What must hold:

  * the global Fisher I_D agrees at rtol 1e-4 / atol 1e-12 on >= 99.9% of
    its entries and at rtol 2e-3 on every entry. Both sides compute in f32,
    but the forward passes differ at ~5e-7 (convolution sums in another
    order), and on a confident model the loss gradient p_y - 1 cancels to
    ~1e-4, which turns that into ~1e-3 relative on a few gradients;
  * ``dampen_tree`` fed the reference's own Fisher is bit-exact;
  * per mode (ssd/cau/bd/ficabu, and ficabu with tau = 0 so that the
    sweep runs through several checkpoints): halting, checkpoints, the accuracy trace
    and the MAC accounting are EQUAL; the per-layer selection counts differ
    by at most 0.1% of the layer's parameters (a Fisher that differs in the
    last bit can flip a selection sitting on the threshold); the edit masks
    agree on >= 99.9% of entries and, where they agree, the values at
    rtol 1e-4 / atol 1e-6 on >= 99.5% of them and at rtol 1e-2 on all:
    beta = lam * I_D / I_Df carries the error of the 32-sample forget
    Fisher, which like any one-batch Fisher has ~0.3% of its entries
    beyond 1e-4 (test_fisher_partial_tail_matches_jax);
  * a warm request builds nothing, and the step-cache counts equal the
    reference's compile/hit counts;
  * without donation the caller's tensors are untouched.

The int8 path (``precision="int8"``, cases ssd and ficabu with tau = 0) is
held the same way, with these tolerances:

  * ``dampen_q8_tree`` fed the reference's own Fisher and codes is
    bit-exact, codes and masks;
  * halting, checkpoints, the accuracy trace, the profile and the MACs are
    EQUAL; the build/hit counts of every family (fused, partial, quant)
    equal the reference's; selection counts within 0.1% of the layer's
    parameters, as for fp32;
  * the deployed weights lie on the reference's q8 grid (both sides
    quantise the same pristine weights, so the scale tables are the same
    bits), the codes agree on >= 99.9% of entries, and the values are
    bit-equal wherever the codes agree. Wherever both sides edited an entry
    (or both left it alone) the codes differ by at most one step: the
    forget Fisher differs by up to ~1e-3 relative on a few entries, which
    can move round(theta_q * beta) across a half. An entry that only one
    side edits is a selection flip and may differ by more (13 steps at one
    entry of ficabu-tau0 on this model); those are bounded by the 0.1%
    selection tolerance;
  * per layer, ||p8 - p32|| / ||p32|| lies in (0, INT8_SWEEP_RTOL] and
    within 5% (relative) of the reference's own value: one selection flip
    moves a whole code, which moved one layer's value by 1.1% here.

Every use of the (slow to train) ``trained_resnet`` fixture lives in this
file, so the suite trains it once per worker.
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
from repro.core import ssd as jssd  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import ForgetRequest, Unlearner, UnlearnSpec  # noqa: E402
from repro_torch.core import adapters as tadapters  # noqa: E402
from repro_torch.core import cau as tcau  # noqa: E402
from repro_torch.core import fisher as tfisher  # noqa: E402
from repro_torch.core import ssd as tssd  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models import vision as TV  # noqa: E402
from repro_torch.models.module import tree_leaves  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402

torch.set_num_threads(2)
FORGET = 2
RANDOM_GUESS = 1.0 / 6 + 0.03
MODES = ("ssd", "cau", "bd", "ficabu")
# request cases: the four modes, plus ficabu with tau = 0, which the first
# checkpoint cannot meet, so the sweep runs on through later checkpoints
CASES = {m: (m, {}) for m in MODES}
CASES["ficabu-tau0"] = ("ficabu", {"tau": 0.0})
STAT_KEYS = ("stopped_at_l", "checkpoints_hit", "forget_acc_trace",
             "profile_S", "macs", "macs_ssd", "macs_vs_ssd_pct")
COUNTERS = ("fused_compiles", "fused_hits", "partial_compiles",
            "partial_hits")
# the int8 request cases (each cold JAX int8 forget costs 5-25 s here)
CASES8 = {"ssd": ("ssd", {}), "ficabu-tau0": ("ficabu", {"tau": 0.0})}
COUNTERS8 = COUNTERS + ("quant_compiles", "quant_hits")


def _np_tree(t):
    """The port's tree in the reference's layout, by path."""
    return bridge.paths(bridge.params_to_numpy(t))


def _jax_tree(t):
    return bridge.paths(jax.tree_util.tree_map(np.asarray, t))


@pytest.fixture(scope="module")
def setting(trained_resnet):
    m = trained_resnet
    x, y = m["x"], m["y"]
    splits = tsyn.split_forget_retain(x, y, forget_class=FORGET)
    batches = [(x[i:i + 32], y[i:i + 32]) for i in range(0, len(y) - 31, 32)]
    cfg = m["cfg"]
    tcfg = TV.ResNetConfig(width=cfg.width, n_classes=cfg.n_classes,
                           img_size=cfg.img_size)
    tparams = bridge.params_to_torch(
        jax.tree_util.tree_map(np.asarray, m["params"]), device="cpu")

    def tloss(p, b):
        return TV.cls_loss(TV.resnet_forward(p, tcfg, b[0]), b[1])

    return {
        **m, "splits": splits, "batches": batches, "tcfg": tcfg,
        "tparams": tparams, "tloss": tloss,
        "jI": jfisher.diag_fisher_streaming(m["loss_fn"], m["params"],
                                            batches, chunk_size=8),
        "tI": tfisher.diag_fisher_streaming(tloss, tparams, batches,
                                            chunk_size=8, device="cpu"),
        "jadapter": jadapters.resnet_adapter(cfg),
        "tadapter": tadapters.resnet_adapter(tcfg, device="cpu"),
    }


def _spec(cls, mode, **kw):
    kw = {"tau": RANDOM_GUESS, **kw}
    return cls.for_mode(mode, alpha=10.0, lam=1.0, checkpoint_every=2,
                        chunk_size=8, use_kernel=True, **kw)


def _assert_bulk_close(got, want, *, rtol, atol, bulk, rtol_all, mask=None):
    """Over the whole tree (by path): at least ``bulk`` of the entries lie
    within rtol/atol and every entry within rtol_all/atol."""
    ok = total = 0
    for k in want:
        g, w = got[k], want[k]
        if mask is not None:
            g, w = g[mask[k]], w[mask[k]]
        np.testing.assert_allclose(g, w, rtol=rtol_all, atol=atol, err_msg=k)
        ok += int((np.abs(g - w) <= atol + rtol * np.abs(w)).sum())
        total += w.size
    assert ok >= bulk * total, (ok, total)


@pytest.fixture(scope="module")
def results(setting):
    s = setting
    fx, fy = s["splits"]["forget"]
    fx, fy = fx[:32], fy[:32]
    before = {k: v.clone() for k, v in bridge.paths(s["tparams"]).items()}
    out = {}
    for case, (mode, kw) in CASES.items():
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


def test_global_fisher_matches_jax(setting):
    want = _jax_tree(setting["jI"])
    got = _np_tree(setting["tI"])
    assert sorted(got) == sorted(want)
    _assert_bulk_close(got, want, rtol=1e-4, atol=1e-12, bulk=0.999,
                       rtol_all=2e-3)


def test_fisher_partial_tail_matches_jax(setting):
    """28 samples at chunk 8: three chunks plus a 4-sample tail evaluated at
    its own size and sample-weighted into the mean. One batch averages less
    of the gradient noise away than I_D's six, hence the wider tail bound;
    a tail dropped, padded or weighted wrongly moves most entries by
    several percent."""
    s = setting
    b = (s["x"][:28], s["y"][:28])
    want = _jax_tree(jfisher.diag_fisher(s["loss_fn"], s["params"], b, 8))
    got = _np_tree(tfisher.diag_fisher(s["tloss"], s["tparams"], b, 8,
                                       device="cpu"))
    _assert_bulk_close(got, want, rtol=1e-4, atol=1e-12, bulk=0.99,
                       rtol_all=2e-2)


def test_dampen_tree_bit_exact_on_jax_fisher(setting):
    """Fed the reference's own Fisher trees, the port's dampening edit is
    bit for bit the reference's kernel path."""
    s = setting
    fx, fy = s["splits"]["forget"]
    jf = jfisher.diag_fisher(s["loss_fn"], s["params"], (fx[:32], fy[:32]), 8)
    jnew, jmask = jssd.dampen_tree(s["params"], jf, s["jI"], 10.0, 1.0,
                                   use_kernel=True)
    tf, tI = (bridge.params_to_torch(jax.tree_util.tree_map(np.asarray, t),
                                     device="cpu") for t in (jf, s["jI"]))
    tnew, tmask = tssd.dampen_tree(s["tparams"], tf, tI, 10.0, 1.0,
                                   use_kernel=True)
    want, got = _jax_tree(jnew), _np_tree(tnew)
    wmask, gmask = _jax_tree(jmask), _np_tree(tmask)
    assert sum(int(m.sum()) for m in wmask.values()) > 0
    for k in want:
        np.testing.assert_array_equal(got[k].view(np.uint32),
                                      want[k].view(np.uint32), err_msg=k)
        np.testing.assert_array_equal(gmask[k], wmask[k], err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_halting_and_macs_equal_jax(results, case):
    _, jst, _, _ = results[case]["j"]
    _, tst, _, _ = results[case]["t"]
    for k in STAT_KEYS:
        assert tst[k] == jst[k], (case, k, tst[k], jst[k])
    assert tst["mode"] == jst["mode"] == CASES[case][0]
    assert set(tst["engine"]) == set(jst["engine"])
    if case in ("cau", "ficabu"):
        assert tst["stopped_at_l"] < 10  # the checkpoint halted the sweep
    if case == "ficabu-tau0":
        assert len(tst["checkpoints_hit"]) >= 3


@pytest.mark.parametrize("case", CASES)
def test_selection_counts_within_tolerance(setting, results, case):
    _, jst, _, _ = results[case]["j"]
    _, tst, _, _ = results[case]["t"]
    adapter = setting["tadapter"]
    L = adapter.n_layers
    assert sorted(tst["selected_per_layer"]) == sorted(jst["selected_per_layer"])
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
        same[k] = (want[k] != orig[k]) == (got[k] != orig[k])
        agree += int(same[k].sum())
        total += same[k].size
    assert agree >= 0.999 * total, (agree, total)
    _assert_bulk_close(got, want, rtol=1e-4, atol=1e-6, bulk=0.995,
                       rtol_all=1e-2, mask=same)


@pytest.mark.parametrize("case", CASES)
def test_warm_request_builds_nothing(results, case):
    _, _, jwarm, jcounts = results[case]["j"]
    _, _, twarm, tcounts = results[case]["t"]
    assert twarm["engine"]["compiles"] == jwarm["engine"]["compiles"] == 0
    assert twarm["engine"]["cache_hits"] == jwarm["engine"]["cache_hits"]
    for k in COUNTERS:
        assert tcounts[k] == jcounts[k], (k, tcounts, jcounts)


def test_forget_leaves_caller_tensors_untouched(setting, results):
    for k, t in bridge.paths(setting["tparams"]).items():
        assert torch.equal(t, results["before"][k]), k


def test_donate_edits_in_place(setting, results):
    """With ExecSpec(donate=True) the step writes the edit into the
    caller's tensors: same storage, same values as the copying run."""
    s = setting
    fx, fy = s["splits"]["forget"]
    mine = bridge.params_to_torch(bridge.params_to_numpy(s["tparams"]),
                                  device="cpu")
    ptrs = {k: t.data_ptr() for k, t in bridge.paths(mine).items()}
    unl = Unlearner(s["tadapter"], s["tI"],
                    _spec(UnlearnSpec, "ssd", donate=True), device="cpu")
    new, _ = unl.forget(ForgetRequest(fx[:32], fy[:32]), params=mine)
    want = bridge.paths(results["ssd"]["t"][0])
    for k, t in bridge.paths(new).items():
        assert t.data_ptr() == ptrs[k], k
        assert torch.equal(t, want[k]), k


def test_ssd_unlearn_selects_like_jax(setting):
    """Vanilla one-shot SSD over the whole tree: the selected fraction
    agrees within 0.1% of the parameters."""
    s = setting
    fx, fy = s["splits"]["forget"]
    _, jst = jssd.ssd_unlearn(s["loss_fn"], s["params"], (fx[:32], fy[:32]),
                              s["jI"], 10.0, 1.0, chunk_size=8)
    _, tst = tssd.ssd_unlearn(s["tloss"], s["tparams"], (fx[:32], fy[:32]),
                              s["tI"], 10.0, 1.0, chunk_size=8,
                              use_kernel=True, device="cpu")
    assert 0.0 < tst["selected_fraction"] < 1.0
    assert abs(tst["selected_fraction"] - jst["selected_fraction"]) <= 1e-3


def test_context_adaptive_unlearn_is_the_facade(setting, results):
    """The legacy entry point routes through Unlearner: same stats as the
    facade's ficabu request, without the mode key."""
    s = setting
    fx, fy = s["splits"]["forget"]
    cfg = _spec(UnlearnSpec, "ficabu").to_config()
    _, st = tcau.context_adaptive_unlearn(
        s["tadapter"], s["tparams"], s["tI"], torch.as_tensor(fx[:32]),
        torch.as_tensor(fy[:32]), cfg)
    want = results["ficabu"]["t"][1]
    assert "mode" not in st
    for k in STAT_KEYS + ("selected_per_layer",):
        assert st[k] == want[k], k


# -- the int8 path (precision="int8") ---------------------------------------
@pytest.fixture(scope="module")
def results8(setting):
    s = setting
    fx, fy = s["splits"]["forget"]
    fx, fy = fx[:32], fy[:32]
    before = {k: v.clone() for k, v in bridge.paths(s["tparams"]).items()}
    out = {}
    for case, (mode, kw) in CASES8.items():
        kw = dict(kw, precision="int8")
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
    # the reference's scale tables of the pristine weights, by path
    out["scales"] = _jax_tree(jcomp.q8_quantize_tree(s["params"])[1])
    return out


def test_dampen_q8_tree_bit_exact_on_jax_fisher(setting):
    """Fed the reference's own codes and Fisher trees, the port's int8 edit
    is bit for bit the reference's kernel path, codes and masks."""
    s = setting
    fx, fy = s["splits"]["forget"]
    jf = jfisher.diag_fisher(s["loss_fn"], s["params"], (fx[:32], fy[:32]), 8)
    jq, _ = jcomp.q8_quantize_tree(s["params"])
    jnew, jmask = jssd.dampen_q8_tree(jq, jf, s["jI"], 10.0, 1.0,
                                      use_kernel=True)
    tq, tf, tI = (bridge.params_to_torch(jax.tree_util.tree_map(np.asarray, t),
                                         device="cpu")
                  for t in (jq, jf, s["jI"]))
    tnew, tmask = tssd.dampen_q8_tree(tq, tf, tI, 10.0, 1.0, use_kernel=True)
    want, got = _jax_tree(jnew), _np_tree(tnew)
    wmask, gmask = _jax_tree(jmask), _np_tree(tmask)
    assert sum(int(m.sum()) for m in wmask.values()) > 0
    assert sum(int((want[k] != _jax_tree(jq)[k]).sum()) for k in want) > 0
    for k in want:
        assert got[k].dtype == np.int8, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(gmask[k], wmask[k], err_msg=k)


@pytest.mark.parametrize("case", CASES8)
def test_int8_halting_and_macs_equal_jax(results8, case):
    _, jst, _, _ = results8[case]["j"]
    _, tst, _, _ = results8[case]["t"]
    for k in STAT_KEYS:
        assert tst[k] == jst[k], (case, k, tst[k], jst[k])
    assert tst["engine"]["precision"] == jst["engine"]["precision"] == "int8"
    assert set(tst["engine"]) == set(jst["engine"])
    if case == "ficabu-tau0":
        assert len(tst["checkpoints_hit"]) >= 3


@pytest.mark.parametrize("case", CASES8)
def test_int8_selection_counts_within_tolerance(setting, results8, case):
    _, jst, _, _ = results8[case]["j"]
    _, tst, _, _ = results8[case]["t"]
    adapter = setting["tadapter"]
    L = adapter.n_layers
    assert sorted(tst["selected_per_layer"]) == \
        sorted(jst["selected_per_layer"])
    for l, n_j in jst["selected_per_layer"].items():
        n_prm = sum(t.numel() for t in bridge.paths(
            adapter.get_layer(setting["tparams"], L - l)).values())
        assert abs(tst["selected_per_layer"][l] - n_j) <= 1e-3 * n_prm, l


@pytest.mark.parametrize("case", CASES8)
def test_int8_counts_equal_jax_and_warm_builds_nothing(results8, case):
    _, _, jwarm, jcounts = results8[case]["j"]
    _, _, twarm, tcounts = results8[case]["t"]
    assert twarm["engine"]["compiles"] == jwarm["engine"]["compiles"] == 0
    assert twarm["engine"]["cache_hits"] == jwarm["engine"]["cache_hits"]
    for k in COUNTERS8:
        assert tcounts[k] == jcounts[k], (k, tcounts, jcounts)
    assert tcounts["quant_compiles"] == 1 and tcounts["quant_hits"] == 1


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
        c0 = np.round(orig[k] / sc)
        both = (cj != c0) == (ct != c0)
        assert np.abs(cj - ct)[both].max(initial=0) <= 1, k
        edited += int((ct != c0).sum())
    assert agree >= 0.999 * total, (agree, total)
    assert edited > 0


@pytest.mark.parametrize("case", CASES8)
def test_int8_error_against_fp32_within_contract(setting, results, results8,
                                                 case):
    """Per layer, ||p8 - p32|| / ||p32|| in (0, INT8_SWEEP_RTOL], on the
    port and close to the reference's own value (module docstring)."""
    s = setting
    rels = {}
    for side in ("t", "j"):
        adapter = s["tadapter"] if side == "t" else s["jadapter"]
        p8, p32 = results8[case][side][0], results[case][side][0]
        leaves = (tree_leaves if side == "t" else jax.tree_util.tree_leaves)
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
    """The int8 forget works on its own fake-quantised copy."""
    for k, t in bridge.paths(setting["tparams"]).items():
        assert torch.equal(t, results8["before"][k]), k


def test_resnet_checkpoints_keep_per_depth_runners(results):
    """ResNet's activations change shape from stage to stage, so the
    depth-operand checkpoint runner never applies: every checkpoint depth
    builds its own runner in the cold tau = 0 request and hits it in the
    warm one, as the reference counts."""
    _, jst, _, jcounts = results["ficabu-tau0"]["j"]
    _, tst, _, tcounts = results["ficabu-tau0"]["t"]
    assert tst["engine"]["uniform_suffix"] is False
    assert jst["engine"]["uniform_suffix"] is False
    n_cps = len(tst["checkpoints_hit"])
    assert tcounts["partial_compiles"] == jcounts["partial_compiles"] == n_cps
    assert tcounts["partial_hits"] == jcounts["partial_hits"] == n_cps
