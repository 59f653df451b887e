"""The dense GQA archs end to end: forget requests through the port's
``Unlearner`` against the JAX package's, on yi-6b-smoke (two "attn"
blocks, both in ``period_stack``; d_model 64, 4 heads over 2 KV heads of
16, d_ff 160, vocab 256, untied: 4 unlearn layers).
``test_torch_dense_unlearn_yi9b.py`` and ``test_torch_dense_unlearn_qwen.py``
run every per-model test of this file (``__all__``) again on yi-9b-smoke
(three blocks) and qwen1.5-32b-smoke (two blocks, 4 heads over 4 KV heads,
q/k/v biases added before RoPE), so that the three models' reference runs
land on three test workers. The FULL-structure tests below run here only.

Each model is the reference's own initialisation (``init_lm`` from
PRNGKey(0), untrained), bridged into the port; the settings are those of
``test_torch_recurrent_unlearn.py`` (its ``_serve``: one facade per
package, every case in turn): ``make_lm_domains`` streams (vocabulary 256,
16-token inputs), requests of 8 sequences labelled with the model's own
argmax, the global Fisher from ``lm_loss`` over 8 retain sequences on each
side, alpha 6, lambda 0.5, chunk 4, checkpoints every 2 layers. What must
hold, with the declared tolerances of ``test_torch_lm_unlearn.py``:

  * the global Fisher at rtol 1e-4 / atol 1e-12 on >= 99.9% of its entries
    and at rtol 2e-3 / atol 1e-9 on all (the LM test's atol there is
    1e-12: on these untrained models a few entries of ``embed/w`` of 1e-10
    to 3e-9, nine to ten orders below the leaf's largest, differ by up to
    4.5% between the packages, as the reference's own eager and compiled
    Fisher differ there by 3%, measured on the CPU on yi-9b-smoke; 1e-9 is
    the recurrent tests' atol for all entries), every leaf together — on
    qwen the key bias
    ``bk`` too: the bias is added before the rotation, so ``rope(bk)``
    varies with the key's position, the softmax does not cancel it (the
    ViT's ``bk`` has a zero gradient; this one has not), and its Fisher is
    held at the common tolerance;
  * per request (fp32: ssd, cau, bd, ficabu at tau = 0 and a ficabu whose
    tau, the reference's own forget accuracy at its middle checkpoint,
    halts it partway; int8: ssd, ficabu): halting, checkpoints, the
    accuracy trace, the profile and the MACs EQUAL, the per-layer
    selection counts within 0.1% of the layer's parameters, every program
    family's build/hit counts EQUAL;
  * fp32 parameters: the edit masks agree on >= 99.9% of the entries and,
    where they agree, the values at rtol 1e-4 / atol 1e-6 on >= 99.5% of
    them and rtol 1e-2 on all but the entries whose global Fisher lies
    below ``FISHER_FLOOR`` (1e-8): beta = lambda I_g / I_f carries that
    noise of I_g (one entry of yi-9b's K = 2 drain, 4.4% off);
  * int8 parameters: every layer on the grid the reference gives it (the
    stacked [n_periods, d] biases too), the codes equal on >= 99.99% of
    the entries and the values bit-equal where they agree;
  * ``plan_scanned_sweep`` returns a plan, equal to the reference's (the
    blocks are uniform); a scanned request (ssd, the halting ficabu, int8
    ssd and int8 ficabu) and a scanned K = 2 drain (fp32 ficabu, int8 ssd)
    equal the layerwise ones BIT FOR BIT — except, for an int8 request that
    halted, the layers it never reached, which the reference's two paths
    quantise differently (``lead_axes`` 1 and 2, ROADMAP Queue 3): there
    each port path equals the reference's own (an int8 ficabu halting
    partway, the stacked [n_periods, d] biases among those layers on qwen);
  * a K = 2 ficabu drain of domains 1 and 2 against the reference's
    layerwise drain: per-set stats equal, parameters within the fp32
    tolerances.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_recurrent_unlearn import (  # noqa: E402
    BIT_KEYS, CASES, _assert_bulk_close, _assert_stats_equal, _jax_tree,
    _np_tree, _same_bits, _serve, _spec)
from test_torch_recurrent_unlearn import _setting as _rec_setting  # noqa: E402

from repro.api import ForgetRequest as JRequest  # noqa: E402
from repro.api import UnlearnSpec as JSpec  # noqa: E402
from repro.api import Unlearner as JUnlearner  # noqa: E402
from repro.configs import qwen1_5_32b as jqwen  # noqa: E402
from repro.configs import yi_6b as jyi6  # noqa: E402
from repro.configs import yi_9b as jyi9  # noqa: E402
from repro.core import adapters as jadapters  # noqa: E402
from repro.engine import plan_scanned_sweep as jplan  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.api import ForgetRequest, UnlearnSpec  # noqa: E402
from repro_torch.core import adapters as tadapters  # noqa: E402
from repro_torch.engine import plan_scanned_sweep  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models.module import tree_leaves  # noqa: E402

torch.set_num_threads(2)
ARCHS = {"yi-6b": jyi6, "yi-9b": jyi9, "qwen1.5-32b": jqwen}
SEQ = 16
# global Fisher entries below this are rounding noise on both sides (module
# docstring): an edit whose beta reads one is held by the bulk bound only
FISHER_FLOOR = 1e-8
# the per-model tests, which the per-arch files run again on their models
__all__ = ["test_global_fisher_matches_jax",
           "test_halting_macs_and_counts_equal_jax",
           "test_edited_params_match_jax", "test_int8_codes_match_jax",
           "test_forget_leaves_caller_tensors_untouched",
           "test_planner_plans_as_the_reference",
           "test_scanned_requests_equal_layerwise_bit_for_bit",
           "test_scanned_group_equals_layerwise_bit_for_bit",
           "test_int8_halted_request_matches_each_reference_path",
           "test_group_matches_jax_layerwise"]


def _setting(arch):
    """The dense model's setting (``test_torch_recurrent_unlearn._setting``
    over this file's archs)."""
    return _rec_setting(arch, archs=ARCHS)


@pytest.fixture(scope="module")
def served():
    s = _setting("yi-6b")
    return s, _serve(s)


def _assert_params_close(s, want_j, got_t):
    """The edit masks (against the starting tree) and the edited values
    where they agree, with the fp32 tolerances of the module docstring."""
    orig = _jax_tree(s["params"])
    want, got = _jax_tree(want_j), _np_tree(got_t)
    assert sorted(got) == sorted(want)
    same = {k: (want[k] != orig[k]) == (got[k] != orig[k]) for k in want}
    n_agree = sum(int(m.sum()) for m in same.values())
    total = sum(m.size for m in same.values())
    assert n_agree >= 0.999 * total, (n_agree, total)
    _assert_bulk_close(got, want, rtol=1e-4, atol=1e-6, bulk=0.995,
                       rtol_all=None, mask=same)
    fisher = _jax_tree(s["jI"])
    _assert_bulk_close(got, want, rtol=1e-2, atol=1e-6, bulk=0.0,
                       rtol_all=1e-2, mask={
                           k: m & (fisher[k] >= FISHER_FLOOR)
                           for k, m in same.items()})


def _stacked_row(s, whole, j, k):
    """Layer j's leaf ``k`` of a whole-tree result (every block of these
    models lies in period_stack)."""
    L = s["tadapter"].n_layers
    if j == 0:
        return whole[f"embed/{k}"]
    if j == L - 1:
        return whole[k]
    return whole[f"period_stack/0/{k}"][j - 1]


def _assert_int8_on_grid_and_close(s, jp, tp, stopped, scanned=False,
                                   codes=0.9999):
    """Every layer on the reference's grid for it: a swept layer on the
    per-row scales of its own pristine leaves, a layer the request never
    reached as the reference's path left it (the layerwise loop: the
    whole-tree fake quantisation, one scale per period; the scanned
    program: the layer's own, per row). Codes equal on at least ``codes``
    of the entries, the values bit-equal wherever they agree."""
    ad, jad = s["tadapter"], s["jadapter"]
    L = ad.n_layers
    whole = _jax_tree(jcomp.q8_fakequant_tree(s["params"]))
    agree = total = 0
    for j in range(L):
        want = _jax_tree(jad.get_layer(jp, j))
        got = {k: v.numpy() for k, v in bridge.paths(
            ad.get_layer(tp, j)).items()}
        pristine = jad.get_layer(s["params"], j)
        scales = _jax_tree(jcomp.q8_quantize_tree(pristine)[1])
        fq = _jax_tree(jcomp.q8_fakequant_tree(pristine))
        for k, w in want.items():
            w, g = np.asarray(w, np.float32), got[k]
            if L - j > stopped:
                ref = np.asarray(fq[k] if scanned
                                 else _stacked_row(s, whole, j, k),
                                 np.float32)
                np.testing.assert_array_equal(g.view(np.uint32),
                                              ref.view(np.uint32),
                                              err_msg=(j, k))
                same = g.view(np.uint32) == w.view(np.uint32)
            else:
                sc = scales[k]
                cj, ct = np.round(w / sc), np.round(g / sc)
                assert np.abs(ct).max() <= 127, (j, k)
                np.testing.assert_array_equal(w, (cj * sc).astype(np.float32))
                np.testing.assert_array_equal(g, (ct * sc).astype(np.float32))
                same = cj == ct
            agree += int(same.sum())
            total += same.size
            np.testing.assert_array_equal(g[same].view(np.uint32),
                                          w[same].view(np.uint32),
                                          err_msg=(j, k))
    assert agree >= codes * total, (agree, total)


# -- the Fisher and the requests ---------------------------------------------
def test_global_fisher_matches_jax(served):
    s, _ = served
    want = _jax_tree(s["jI"])
    got = _np_tree(s["tI"])
    assert sorted(got) == sorted(want)
    _assert_bulk_close(got, want, rtol=1e-4, atol=1e-12, bulk=0.999,
                       rtol_all=2e-3, atol_all=1e-9)
    if s["tcfg"].qkv_bias:
        # the key bias's Fisher is no rounding noise here: the same order
        # as the value bias's, held with the rest above
        bk, bv = (want[f"period_stack/0/mixer/{b}"] for b in ("bk", "bv"))
        assert bk.max() > 1e-3 * bv.max() > 0.0, (bk.max(), bv.max())


@pytest.mark.parametrize("case", CASES)
def test_halting_macs_and_counts_equal_jax(served, case):
    s, res = served
    jp, jst, jcounts = res[case]["j"]
    tp, tst, tcounts = res[case]["t"]
    _assert_stats_equal(jst, tst, s)
    assert tst["mode"] == jst["mode"] == CASES[case][0]
    assert tst["engine"]["precision"] == jst["engine"]["precision"]
    assert tst["engine"]["uniform_suffix"] is jst["engine"]["uniform_suffix"]
    assert tcounts == {k: jcounts[k] for k in tcounts}, (tcounts, jcounts)
    assert (tst["engine"]["compiles"], tst["engine"]["cache_hits"]) == \
        (jst["engine"]["compiles"], jst["engine"]["cache_hits"])
    L = s["tadapter"].n_layers
    if case == "ficabu-halt":
        assert 1 <= tst["stopped_at_l"] < L, tst["forget_acc_trace"]
    elif case in ("ssd", "bd", "ssd-int8"):
        assert tst["stopped_at_l"] == L


@pytest.mark.parametrize("case", [c for c in CASES if "int8" not in c])
def test_edited_params_match_jax(served, case):
    s, res = served
    _assert_params_close(s, res[case]["j"][0], res[case]["t"][0])


@pytest.mark.parametrize("case", [c for c in CASES if "int8" in c])
def test_int8_codes_match_jax(served, case):
    s, res = served
    jp, jst, _ = res[case]["j"]
    tp, tst, _ = res[case]["t"]
    _assert_int8_on_grid_and_close(s, jp, tp, tst["stopped_at_l"])


def test_forget_leaves_caller_tensors_untouched(served):
    s, res = served
    for k, t in bridge.paths(s["tparams"]).items():
        assert torch.equal(t, res["before"][k]), k


# -- the scanned program and the drains ---------------------------------------
def test_planner_plans_as_the_reference(served):
    """Uniform "attn" blocks: a plan of one kind, equal to the
    reference's."""
    s, _ = served
    fx = s["sets"][0][0]
    plan = plan_scanned_sweep(s["tadapter"], s["tparams"],
                              torch.from_numpy(fx))
    want = jplan(s["jadapter"], s["params"], jnp.asarray(fx))
    assert plan is not None and want is not None
    assert plan.kinds == (("blk", "attn"),)
    assert (plan.n_layers, plan.kinds, plan.rep_depths, plan.type_ids) == \
        (want.n_layers, want.kinds, want.rep_depths, want.type_ids)


@pytest.mark.parametrize("case", ["ssd", "ficabu-halt", "ssd-int8",
                                  "ficabu-int8"])
def test_scanned_requests_equal_layerwise_bit_for_bit(served, case):
    """One scanned program per request, == the layerwise request bit for
    bit (parameters and stats); a halted int8 request's unreached layers
    each equal the reference's own path (module docstring)."""
    s, res = served
    fx, fy = s["sets"][0]
    _, tunl = res["facades"]
    mode, kw = CASES[case][0], res[case]["kw"]
    p, st = tunl.with_spec(_spec(UnlearnSpec, mode, sweep_mode="scanned",
                                 **kw)).forget(ForgetRequest(fx, fy),
                                               params=s["tparams"])
    p_lw, st_lw, _ = res[case]["t"]
    assert st["engine"]["sweep_mode"] == "scanned"
    assert st_lw["engine"]["sweep_mode"] == "layerwise"
    for k in BIT_KEYS:
        assert st[k] == st_lw[k], (case, k)
    L = s["tadapter"].n_layers
    stop = st_lw["stopped_at_l"]
    if "int8" in case and stop < L:
        ad = s["tadapter"]
        for j in range(L - stop, L):
            _same_bits(ad.get_layer(p, j), ad.get_layer(p_lw, j))
        jp, _ = JUnlearner(s["jadapter"], s["jI"], _spec(
            JSpec, mode, sweep_mode="scanned", **kw)).forget(
                JRequest(fx, fy), params=s["params"])
        _assert_int8_on_grid_and_close(s, jp, p, stop, scanned=True)
    else:
        _same_bits(p, p_lw)


def test_int8_halted_request_matches_each_reference_path(served):
    """An int8 ficabu whose tau, the reference's int8 forget accuracy at
    the middle checkpoint of the int8 ficabu at tau = 0, halts it partway,
    layerwise and scanned, on both sides: the layers it swept equal
    between the port's two paths bit for bit, and every layer of each port
    path, the unreached ones included (the whole-tree fake quantisation
    layerwise, one scale per period of a stacked leaf; the layer's own,
    per row, scanned), on the grid the reference's same path gives it,
    codes as declared."""
    s, res = served
    fx, fy = s["sets"][0]
    trace = res["ficabu-int8"]["j"][1]["forget_acc_trace"]
    kw = {"precision": "int8", "tau": trace[len(trace) // 2][1]}
    junl, tunl = res["facades"]
    L = s["tadapter"].n_layers
    out = {}
    for sm in ("layerwise", "scanned"):
        tp, tst = tunl.with_spec(_spec(UnlearnSpec, "ficabu", sweep_mode=sm,
                                       **kw)).forget(ForgetRequest(fx, fy),
                                                     params=s["tparams"])
        jp, jst = junl.with_spec(_spec(JSpec, "ficabu", sweep_mode=sm,
                                       **kw)).forget(JRequest(fx, fy),
                                                     params=s["params"])
        assert tst["engine"]["sweep_mode"] == sm
        _assert_stats_equal(jst, tst, s)
        _assert_int8_on_grid_and_close(s, jp, tp, tst["stopped_at_l"],
                                       scanned=sm == "scanned")
        out[sm] = (tp, tst)
    stop = out["layerwise"][1]["stopped_at_l"]
    assert 1 <= stop < L and out["scanned"][1]["stopped_at_l"] == stop
    ad = s["tadapter"]
    for j in range(L - stop, L):
        _same_bits(ad.get_layer(out["scanned"][0], j),
                   ad.get_layer(out["layerwise"][0], j))


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_scanned_group_equals_layerwise_bit_for_bit(served, precision):
    """A K = 2 drain of domains 1 and 2 (the halting ficabu in fp32, ssd in
    int8), scanned == layerwise, parameters and per-set stats."""
    s, res = served
    case = "ficabu-halt" if precision == "fp32" else "ssd-int8"
    mode, kw = CASES[case][0], res[case]["kw"]
    _, tunl = res["facades"]
    sets = [ForgetRequest(*st) for st in s["sets"]]
    out = {}
    for sm in ("layerwise", "scanned"):
        out[sm] = tunl.with_spec(_spec(UnlearnSpec, mode, sweep_mode=sm,
                                       **kw)).forget_group(
            sets, params=s["tparams"])
    (p_lw, st_lw, g_lw), (p_sc, st_sc, g_sc) = out["layerwise"], \
        out["scanned"]
    assert g_sc["engine"]["sweep_mode"] == "scanned"
    assert g_lw["engine"]["sweep_mode"] == "layerwise"
    _same_bits(p_sc, p_lw)
    for a, b in zip(st_sc, st_lw):
        for k in BIT_KEYS:
            assert a[k] == b[k], k


def test_group_matches_jax_layerwise(served):
    """A K = 2 ficabu drain (the halting tau) against the reference's
    layerwise drain: per-set stats equal, parameters within the fp32
    tolerances."""
    s, res = served
    kw = res["ficabu-halt"]["kw"]
    junl, tunl = res["facades"]
    jp, jst, jg = junl.with_spec(_spec(JSpec, "ficabu", **kw)).forget_group(
        [JRequest(*st) for st in s["sets"]], params=s["params"])
    tp, tst, tg = tunl.with_spec(_spec(UnlearnSpec, "ficabu", **kw)
                                 ).forget_group(
        [ForgetRequest(*st) for st in s["sets"]], params=s["tparams"])
    assert tg["stopped_at_l"] == jg["stopped_at_l"]
    for a, b in zip(jst, tst):
        _assert_stats_equal(a, b, s)
    _assert_params_close(s, jp, tp)


# -- FULL structure (this file only) -------------------------------------------
# (stored leaves, parameters, unlearn layers) of the reference's FULL trees
FULL_SIZES = {"yi-6b": (12, 6_061_035_520, 34),
              "yi-9b": (12, 8_829_407_232, 50),
              "qwen1.5-32b": (15, 35_197_096_960, 66)}


@pytest.mark.parametrize("arch", FULL_SIZES)
def test_full_structure_matches_reference(arch):
    """The FULL config's tree from ``jax.eval_shape`` (no weights): its
    leaves, parameters and unlearn layers; the port's adapter over a tree
    of those shapes on ``meta`` sees the reference's layer keys, layer
    leaves and ``layer_ctx`` (untied: no context anywhere); the stacked
    biases sit under the reference's paths as [n_periods, d]."""
    jcfg, tcfg = ARCHS[arch].FULL, tconfigs.get(arch).full
    jshapes = jax.eval_shape(lambda: JLM.init_lm(jax.random.PRNGKey(0),
                                                 jcfg))
    sizes = [int(np.prod(x.shape)) for x in
             jax.tree_util.tree_leaves(jshapes)]
    n_leaves, n_params, n_layers = FULL_SIZES[arch]
    assert (len(sizes), sum(sizes)) == (n_leaves, n_params)
    tree = jax.tree_util.tree_map(
        lambda x: torch.empty(x.shape, dtype=torch.bfloat16, device="meta"),
        jshapes)
    ta = tadapters.lm_adapter(tcfg, 2048, device="cpu")
    ja = jadapters.lm_adapter(jcfg, 2048)
    assert ta.n_layers == ja.n_layers == n_layers
    assert [ta.layer_key(j) for j in range(n_layers)] == \
        [ja.layer_key(j) for j in range(n_layers)]
    for j in range(n_layers):
        assert ta.layer_ctx(tree, j) is None and ja.layer_ctx(jshapes, j) \
            is None
        got = bridge.paths(ta.get_layer(tree, j))
        want = bridge.paths(jax.eval_shape(
            lambda p, j=j: ja.get_layer(p, j), jshapes))
        assert sorted(got) == sorted(want), j
        for k, x in want.items():
            assert tuple(got[k].shape) == tuple(x.shape), (j, k)
    stack = bridge.paths(tree)
    n_p = jcfg.n_layers
    for b, width in (("bq", jcfg.n_heads), ("bk", jcfg.n_kv_heads),
                     ("bv", jcfg.n_kv_heads)):
        key = f"period_stack/0/mixer/{b}"
        if jcfg.qkv_bias:
            assert tuple(stack[key].shape) == (n_p, width * jcfg.head_dim)
        else:
            assert key not in stack


@pytest.mark.parametrize("arch", FULL_SIZES)
def test_smoke_tree_matches_reference(arch):
    """The port's SMOKE init equals the reference's tree path by path in
    shape and dtype; the reference's tree crosses the bridge and back
    unchanged (the stacked [n_periods, d] biases too: no leaf is 4-D), and
    runs the port's forward to the reference's logits within the LM tests'
    forward tolerance (rtol 1e-5 / atol 2e-5)."""
    jcfg, tcfg = ARCHS[arch].SMOKE, tconfigs.get(arch).smoke
    tp = TLM.init_lm(torch.Generator().manual_seed(0), tcfg, device="cpu")
    params = JLM.init_lm(jax.random.PRNGKey(0), jcfg)
    want = _jax_tree(params)
    got = bridge.paths(tp)
    assert sorted(got) == sorted(want)
    for k, x in want.items():
        assert tuple(got[k].shape) == x.shape, k
        assert got[k].is_contiguous() and got[k].dtype == torch.float32, k
    bridged = bridge.params_to_torch(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    back = bridge.paths(bridge.params_to_numpy(bridged))
    assert sorted(back) == sorted(want)
    for k, x in want.items():
        assert x.ndim <= 3, k
        np.testing.assert_array_equal(back[k], x, err_msg=k)
    tok = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 12)).astype(
        np.int32)
    jlog, _ = JLM.forward(params, jcfg, jnp.asarray(tok))
    tlog, _ = TLM.forward(bridged, tcfg, torch.from_numpy(tok))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-5,
                               atol=2e-5)
    per_block = len(tree_leaves(tp["period_stack"]))
    assert sum(len(tree_leaves(TLM.get_layer(tp, tcfg, j))) for j in
               range(TLM.n_unlearn_layers(tcfg))) == \
        1 + tcfg.n_layers * per_block + 2
