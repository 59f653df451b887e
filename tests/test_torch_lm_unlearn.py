"""The LM slice end to end: FiCABU forget requests through the port's
``Unlearner`` against the JAX package's, on a JAX-trained tiny
gemma3-shaped LM.

The tiny LM (5 blocks of pattern ("local", "attn"): two stacked periods and
one tail block; d_model 32, 4 heads over 2 KV heads of 8, d_ff 64, vocab
64, window 8 over 16 tokens; 7 unlearn layers) is trained here in JAX
(AdamW, 100 steps) on ``make_lm_domains`` streams, with tied embeddings
(the head reads the embedding as context) and, as a twin, untied. Both are
bridged into the port. The global Fisher I_D comes from ``lm_loss`` (z-loss
1e-4) over 16 retain sequences of the trained model, on each side. A
forget request is 8 sequences of domain 1, labelled with the model's own
argmax (forget accuracy 1 before the edit; ``tests/test_sweep.py``'s
``lm_setting``): alpha 6, lambda 0.5, chunk 4, checkpoints every 2 layers
(l = 1, 2, 4, 6, 7) and tau 0.7, at which cau and ficabu halt partway. The
port runs on the CPU, where the dampening wrappers take their plain
versions; the reference runs its Pallas kernels in interpret mode. What
must hold:

  * the global Fisher at rtol 1e-4 / atol 1e-12 on >= 99.9% of its entries
    and at rtol 2e-3 on all;
  * per mode (fp32: ssd, cau, bd, ficabu and a ficabu with tau = -1 that
    passes every checkpoint; int8: ssd, ficabu; tied and untied): halting,
    checkpoints, the accuracy trace, the profile and the MACs EQUAL; the
    per-layer selection counts within 0.1% of the layer's parameters; the
    build/hit counts of every family EQUAL; a warm request builds nothing
    and the caller's tensors are untouched;
  * fp32 parameters: the edit masks agree on >= 99.9% of the entries and,
    where they agree, the values at rtol 1e-4 / atol 1e-6 on >= 99.5% of
    them and at rtol 1e-2 on all;
  * int8 parameters: every layer on the grid the reference
    gives it — a swept layer on its own per-row scales (the edit codes are
    quantised from the indexed [d_in, d_out] leaf), a layer the sweep did
    not reach as the whole-tree fake quantisation left it (one scale per
    period on a stacked leaf) — the codes equal on >= 99.998% of the
    entries and the values bit-equal wherever they agree;
  * the port's scanned program equals its layerwise loop BIT FOR BIT
    (parameters and stats) for one request and for a K = 2 drain, fp32 and
    int8 — except, in int8, the layers a halted request never reached: the
    reference's scanned program quantises its stack per layer and row
    (``lead_axes=2``) where its layerwise loop leaves the whole-tree fake
    quantisation (one scale per period), and the port reproduces both: each
    equals the reference's own path there;
  * ``plan_scanned_sweep`` plans the mixed-kind stack (two kinds, the tied
    head's context allowed), as the reference does;
  * the K = 2 drain (layerwise, and ``reference=snapshot``) holds against
    the reference's LAYERWISE drain (ROADMAP Queue 3: the reference's
    scanned snapshot path is a known caveat under tied embeddings), and
    its per-set halting against single-set requests of the same sets, on
    both sides: in the drain a set's checkpoints read the suffix both sets
    edited, so it need not halt where it halts alone (l = 4 against 6
    here; on the card one set halted earlier and the other later).
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
from repro.engine import plan_scanned_sweep as jplan  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import ForgetRequest, Unlearner, UnlearnSpec  # noqa: E402
from repro_torch.core import adapters as tadapters  # noqa: E402
from repro_torch.core import fisher as tfisher  # noqa: E402
from repro_torch.engine import plan_scanned_sweep  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models.module import tree_leaves  # noqa: E402

torch.set_num_threads(2)
TINY = dict(name="t-lm-unlearn", n_layers=5, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab=64,
            block_pattern=("local", "attn"), window=8)
SEQ = 16
L = TINY["n_layers"] + 2
TAU = 0.7
CASES = {m: (m, {}) for m in ("ssd", "cau", "bd", "ficabu")}
CASES["ficabu-nohalt"] = ("ficabu", {"tau": -1.0})
CASES8 = {"ssd": ("ssd", {}), "ficabu": ("ficabu", {})}
UNTIED = {"ssd": ("ssd", {}), "ficabu": ("ficabu", {})}
STAT_KEYS = ("stopped_at_l", "checkpoints_hit", "forget_acc_trace",
             "profile_S", "macs", "macs_ssd", "macs_vs_ssd_pct")
BIT_KEYS = STAT_KEYS + ("selected_per_layer",)
COUNTERS = ("fused_compiles", "fused_hits", "partial_compiles",
            "partial_hits", "quant_compiles", "quant_hits")


def _np_tree(t):
    return bridge.paths(bridge.params_to_numpy(t))


def _jax_tree(t):
    return bridge.paths(jax.tree_util.tree_map(np.asarray, t))


def _train(tied):
    """The tiny LM trained in JAX, its Fisher on both sides, the adapters
    and the forget sets of domains 1 and 2 (argmax labels)."""
    from repro.data import synthetic as jsyn
    from repro.models import lm as JLM
    from repro.optim import AdamWConfig, init_adamw, make_train_step

    jcfg = JLM.LMConfig(**TINY, tie_embeddings=tied)
    tcfg = TLM.LMConfig(**TINY, tie_embeddings=tied)
    toks, doms = jsyn.make_lm_domains(jsyn.LMDataConfig(
        vocab=64, n_domains=4, seq_len=SEQ, n_per_domain=16, seed=1))
    params = JLM.init_lm(jax.random.PRNGKey(0), jcfg)
    ocfg = AdamWConfig(lr=3e-3, total_steps=100, warmup_steps=10,
                       weight_decay=1e-4)

    def jloss(p, b):
        return JLM.lm_loss(p, jcfg, b[0], b[1])

    step = jax.jit(make_train_step(jloss, ocfg))
    st = init_adamw(ocfg, params)
    bt = jsyn.Batches((toks[:, :-1], toks[:, 1:]), batch=16, seed=1)
    for _ in range(100):
        params, st, _ = step(params, st, next(bt))
    tparams = bridge.params_to_torch(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    retain = jsyn.lm_split_forget_retain(toks, doms, 1)["retain"][:16]
    batch = (retain[:, :-1], retain[:, 1:])
    jad = jadapters.lm_adapter(jcfg, SEQ)

    def forget_set(d):
        f = jsyn.lm_split_forget_retain(toks, doms, d)["forget"][:8]
        logits, _ = jad.forward_collect(params, jnp.asarray(f[:, :-1]))
        return f[:, :-1], np.array(jnp.argmax(logits, -1), np.int32)

    return {
        "tied": tied, "jcfg": jcfg, "tcfg": tcfg,
        "params": params, "tparams": tparams,
        "jI": jfisher.diag_fisher(jloss, params, batch, chunk_size=4),
        "tI": tfisher.diag_fisher(
            lambda p, b: TLM.lm_loss(p, tcfg, b[0], b[1]), tparams, batch,
            chunk_size=4, device="cpu"),
        "jadapter": jad,
        "tadapter": tadapters.lm_adapter(tcfg, SEQ, device="cpu"),
        "sets": [forget_set(1), forget_set(2)],
    }


@pytest.fixture(scope="module")
def tied():
    return _train(True)


@pytest.fixture(scope="module")
def untied():
    return _train(False)


def _spec(cls, mode, **kw):
    kw = {"tau": TAU, **kw}
    return cls.for_mode(mode, alpha=6.0, lam=0.5, checkpoint_every=2,
                        chunk_size=4, use_kernel=True, **kw)


def _serve(s, cases, **extra):
    """Each case on fresh facades of both packages (the port's cold, then
    warm), and the caller's tensors as they were before."""
    fx, fy = s["sets"][0]
    before = {k: v.clone() for k, v in bridge.paths(s["tparams"]).items()}
    out = {}
    for case, (mode, kw) in cases.items():
        kw = dict(kw, **extra)
        junl = JUnlearner(s["jadapter"], s["jI"], _spec(JSpec, mode, **kw))
        tunl = Unlearner(s["tadapter"], s["tI"],
                         _spec(UnlearnSpec, mode, **kw), device="cpu")
        jp, jst = junl.forget(JRequest(fx, fy), params=s["params"])
        tp, tst = tunl.forget(ForgetRequest(fx, fy), params=s["tparams"])
        cold = dict(tunl.stats)
        _, twarm = tunl.forget(ForgetRequest(fx, fy), params=s["tparams"])
        out[case] = {"j": (jp, jst, junl.stats), "t": (tp, tst, cold),
                     "warm": twarm}
    out["before"] = before
    return out


@pytest.fixture(scope="module")
def results(tied):
    return _serve(tied, CASES)


@pytest.fixture(scope="module")
def results8(tied):
    return _serve(tied, CASES8, precision="int8")


@pytest.fixture(scope="module")
def results_untied(untied):
    out = _serve(untied, UNTIED)
    out8 = _serve(untied, {"ssd": ("ssd", {})}, precision="int8")
    out["ssd-int8"] = out8["ssd"]
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


def _assert_stats_equal(jst, tst, s):
    for k in STAT_KEYS:
        assert tst[k] == jst[k], (k, tst[k], jst[k])
    if "engine" in jst:          # a request's stats, not a drain set's
        assert set(tst["engine"]) == set(jst["engine"])
        assert tst["engine"]["uniform_suffix"] is \
            jst["engine"]["uniform_suffix"]
    assert sorted(tst["selected_per_layer"]) == \
        sorted(jst["selected_per_layer"])
    for l, n_j in jst["selected_per_layer"].items():
        n_prm = sum(t.numel() for t in tree_leaves(
            s["tadapter"].get_layer(s["tparams"], L - l)))
        assert abs(tst["selected_per_layer"][l] - n_j) <= 1e-3 * n_prm, l


def _assert_fp32_close(orig_j, want_j, got_t, orig_t=None):
    """The edit masks (against each side's own starting tree) and the
    edited values, with the declared fp32 tolerances."""
    orig, want, got = _jax_tree(orig_j), _jax_tree(want_j), _np_tree(got_t)
    orig_t = orig if orig_t is None else _np_tree(orig_t)
    assert sorted(got) == sorted(want)
    same = {k: (want[k] != orig[k]) == (got[k] != orig_t[k]) for k in want}
    agree = sum(int(m.sum()) for m in same.values())
    total = sum(m.size for m in same.values())
    assert agree >= 0.999 * total, (agree, total)
    _assert_bulk_close(got, want, rtol=1e-4, atol=1e-6, bulk=0.995,
                       rtol_all=1e-2, mask=same)


def _assert_int8_on_grid_and_close(s, jp, tp, stopped, scanned=False):
    """Codes equal on >= 99.998% of the entries, values bit-equal wherever
    they agree, every layer on the reference's grid for it."""
    ad, jad = s["tadapter"], s["jadapter"]
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
            g = got[k]
            if L - j > stopped:
                # never swept: the fake quantisation of the pristine layer
                ref = fq[k] if scanned else _row(s, whole, j, k)
                np.testing.assert_array_equal(g.view(np.uint32),
                                              ref.view(np.uint32),
                                              err_msg=(j, k))
            sc = scales[k]
            cj, ct = np.round(w / sc), np.round(g / sc)
            if L - j <= stopped:
                np.testing.assert_array_equal(w, (cj * sc).astype(np.float32))
                np.testing.assert_array_equal(g, (ct * sc).astype(np.float32))
                assert np.abs(ct).max() <= 127, (j, k)
                same = cj == ct
            else:
                same = g.view(np.uint32) == w.view(np.uint32)
            agree += int(same.sum())
            total += same.size
            np.testing.assert_array_equal(g[same].view(np.uint32),
                                          w[same].view(np.uint32),
                                          err_msg=(j, k))
    assert agree >= 0.99998 * total, (agree, total)


def _row(s, whole, j, k):
    """Layer j's leaf ``k`` of the whole-tree fake quantisation."""
    cfg = s["jcfg"]
    period = len(cfg.block_pattern)
    if j == 0:
        return whole[f"embed/{k}"]
    if j == L - 1:
        return whole[k]
    i = j - 1
    if i < cfg.n_periods * period:
        return whole[f"period_stack/{i % period}/{k}"][i // period]
    return whole[f"tail/{i - cfg.n_periods * period}/{k}"]


# -- fp32 --------------------------------------------------------------------
def test_global_fisher_matches_jax(tied):
    want = _jax_tree(tied["jI"])
    got = _np_tree(tied["tI"])
    assert sorted(got) == sorted(want) and len(want) == 2 * 9 + 9 + 2
    _assert_bulk_close(got, want, rtol=1e-4, atol=1e-12, bulk=0.999,
                       rtol_all=2e-3)


@pytest.mark.parametrize("case", CASES)
def test_halting_macs_and_counts_equal_jax(tied, results, case):
    jp, jst, jcounts = results[case]["j"]
    tp, tst, tcounts = results[case]["t"]
    _assert_stats_equal(jst, tst, tied)
    assert tst["mode"] == jst["mode"] == CASES[case][0]
    assert tst["engine"]["uniform_suffix"] is True
    for k in COUNTERS:
        assert tcounts[k] == jcounts[k], (k, tcounts, jcounts)
    warm = results[case]["warm"]
    assert warm["engine"]["compiles"] == 0
    assert warm["engine"]["cache_hits"] == \
        tst["engine"]["compiles"] + tst["engine"]["cache_hits"]
    if case in ("cau", "ficabu"):
        assert 1 < tst["stopped_at_l"] < L, tst["forget_acc_trace"]
    if case == "ficabu-nohalt":
        assert tst["checkpoints_hit"] == [1, 2, 4, 6, 7]
        assert tst["stopped_at_l"] == L


@pytest.mark.parametrize("case", CASES)
def test_edited_params_match_jax(tied, results, case):
    _assert_fp32_close(tied["params"], results[case]["j"][0],
                       results[case]["t"][0])


def test_forget_leaves_caller_tensors_untouched(tied, results, results8):
    for before in (results["before"], results8["before"]):
        for k, t in bridge.paths(tied["tparams"]).items():
            assert torch.equal(t, before[k]), k


@pytest.mark.parametrize("case", UNTIED)
def test_untied_head_matches_jax(untied, results_untied, case):
    """lm_head as a leaf of the head layer, no context: fp32 ssd / ficabu
    and int8 ssd."""
    for c in (case, "ssd-int8") if case == "ssd" else (case,):
        jp, jst, jcounts = results_untied[c]["j"]
        tp, tst, tcounts = results_untied[c]["t"]
        _assert_stats_equal(jst, tst, untied)
        for k in COUNTERS:
            assert tcounts[k] == jcounts[k], (c, k)
        if c == "ssd-int8":
            _assert_int8_on_grid_and_close(untied, jp, tp,
                                           tst["stopped_at_l"])
        else:
            _assert_fp32_close(untied["params"], jp, tp)
        assert "lm_head/w" in bridge.paths(
            untied["tadapter"].get_layer(tp, L - 1))
    for k, t in bridge.paths(untied["tparams"]).items():
        assert torch.equal(t, results_untied["before"][k]), k


# -- int8 --------------------------------------------------------------------
@pytest.mark.parametrize("case", CASES8)
def test_int8_halting_codes_and_counts_equal_jax(tied, results8, case):
    jp, jst, jcounts = results8[case]["j"]
    tp, tst, tcounts = results8[case]["t"]
    _assert_stats_equal(jst, tst, tied)
    assert tst["engine"]["precision"] == jst["engine"]["precision"] == "int8"
    for k in COUNTERS:
        assert tcounts[k] == jcounts[k], (k, tcounts, jcounts)
    assert tcounts["quant_compiles"] == 1
    assert results8[case]["warm"]["engine"]["compiles"] == 0
    _assert_int8_on_grid_and_close(tied, jp, tp, tst["stopped_at_l"])
    if case == "ficabu":
        assert 1 < tst["stopped_at_l"] < L, tst["forget_acc_trace"]


@pytest.mark.parametrize("case", CASES8)
def test_int8_error_against_fp32_within_contract(tied, results, results8,
                                                 case):
    """Per layer, ||p8 - p32|| / ||p32|| > 0 and within 5% (relative) of the
    reference's own value. The tiny LM does not meet INT8_SWEEP_RTOL on
    either side (up to 0.146 in the reference itself: a third of a tiny
    layer's entries selected, so the two paths' betas differ widely);
    chip_smoke.py's [lm] phase holds the full-width model to it."""
    rels = {}
    for side in ("t", "j"):
        adapter = tied["tadapter"] if side == "t" else tied["jadapter"]
        p8, p32 = results8[case][side][0], results[case][side][0]
        leaves = tree_leaves if side == "t" else jax.tree_util.tree_leaves
        rels[side] = []
        for j in range(L):
            a = [np.asarray(x, np.float64) for x in
                 leaves(adapter.get_layer(p8, j))]
            b = [np.asarray(x, np.float64) for x in
                 leaves(adapter.get_layer(p32, j))]
            d = sum(float(((x - y) ** 2).sum()) for x, y in zip(a, b))
            n = sum(float((y ** 2).sum()) for y in b)
            rels[side].append((d / n) ** 0.5)
    for j, (rt, rj) in enumerate(zip(rels["t"], rels["j"])):
        assert rt > 0.0 and abs(rt - rj) <= 0.05 * rj, (j, rels)


# -- the scanned program, drains and the planner ----------------------------
def test_planner_plans_the_mixed_kind_stack(tied, untied):
    """Two block kinds of equal shapes and the tied head's context: a plan,
    not None, equal to the reference's."""
    for s in (tied, untied):
        fx = s["sets"][0][0]
        plan = plan_scanned_sweep(s["tadapter"], s["tparams"],
                                  torch.from_numpy(fx))
        want = jplan(s["jadapter"], s["params"], jnp.asarray(fx))
        assert plan is not None and want is not None
        assert plan.kinds == (("blk", "local"), ("blk", "attn"))
        assert (plan.n_layers, plan.kinds, plan.rep_depths, plan.type_ids) \
            == (want.n_layers, want.kinds, want.rep_depths, want.type_ids)


def _same_bits(p, q):
    a, b = bridge.paths(p), bridge.paths(q)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k].view(torch.int32), b[k].view(torch.int32)), k


def _same_bits_from(adapter, p, q, j0):
    """Layers j0..L-1 (the ones a request halted at l = L - j0 swept) bit
    for bit, through the adapter's layer views."""
    for j in range(j0, L):
        a = bridge.paths(adapter.get_layer(p, j))
        b = bridge.paths(adapter.get_layer(q, j))
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k].view(torch.int32),
                               b[k].view(torch.int32)), (j, k)


SCAN_CASES = {"ssd": ("ssd", {}), "ficabu": ("ficabu", {}),
              "ficabu-nohalt": ("ficabu", {"tau": -1.0}),
              "ssd-int8": ("ssd", {"precision": "int8"}),
              "ficabu-int8": ("ficabu", {"precision": "int8"})}


@pytest.mark.parametrize("case", SCAN_CASES)
def test_scanned_forget_equals_layerwise_bit_for_bit(tied, case):
    s = tied
    mode, kw = SCAN_CASES[case]
    fx, fy = s["sets"][0]
    out = {}
    for sm in ("layerwise", "scanned"):
        unl = Unlearner(s["tadapter"], s["tI"],
                        _spec(UnlearnSpec, mode, sweep_mode=sm, **kw),
                        device="cpu")
        out[sm] = unl.forget(ForgetRequest(fx, fy), params=s["tparams"])
    (p_lw, st_lw), (p_sc, st_sc) = out["layerwise"], out["scanned"]
    assert st_sc["engine"]["sweep_mode"] == "scanned"
    assert st_lw["engine"]["sweep_mode"] == "layerwise"
    for k in BIT_KEYS:
        assert st_sc[k] == st_lw[k], k
    stop = st_lw["stopped_at_l"]
    if case == "ficabu-int8":
        # the layers the halted request never reached differ by design
        # (module docstring); each side there equals the reference's path
        assert stop < L
        _same_bits_from(s["tadapter"], p_sc, p_lw, L - stop)
        for sm, p in (("scanned", p_sc), ("layerwise", p_lw)):
            jp, _ = JUnlearner(s["jadapter"], s["jI"], _spec(
                JSpec, mode, sweep_mode=sm, **kw)).forget(
                    JRequest(fx, fy), params=s["params"])
            _assert_int8_on_grid_and_close(s, jp, p, stop,
                                           scanned=sm == "scanned")
    else:
        _same_bits(p_sc, p_lw)


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_scanned_group_equals_layerwise_bit_for_bit(tied, precision):
    """A K = 2 drain of domains 1 and 2 (ssd, and ficabu in fp32), scanned
    == layerwise, parameters and per-set stats."""
    s = tied
    sets = [ForgetRequest(*st) for st in s["sets"]]
    for mode in (("ssd",) if precision == "int8" else ("ssd", "ficabu")):
        res = {}
        for sm in ("layerwise", "scanned"):
            unl = Unlearner(s["tadapter"], s["tI"], _spec(
                UnlearnSpec, mode, sweep_mode=sm, precision=precision),
                device="cpu")
            res[sm] = unl.forget_group(sets, params=s["tparams"])
        (p_lw, st_lw, g_lw), (p_sc, st_sc, g_sc) = (res["layerwise"],
                                                    res["scanned"])
        assert g_sc["engine"]["sweep_mode"] == "scanned"
        assert g_lw["engine"]["sweep_mode"] == "layerwise"
        _same_bits(p_sc, p_lw)
        for a, b in zip(st_sc, st_lw):
            for k in BIT_KEYS:
                assert a[k] == b[k], (mode, k)


def test_group_matches_jax_layerwise_and_single_sets(tied):
    """The K = 2 ficabu drain against the reference's layerwise drain
    (stats equal, parameters within the fp32 tolerances), and each set's
    halting against a single-set request of that set, on both sides."""
    s = tied
    jsets = [JRequest(*st) for st in s["sets"]]
    tsets = [ForgetRequest(*st) for st in s["sets"]]
    junl = JUnlearner(s["jadapter"], s["jI"], _spec(JSpec, "ficabu"))
    tunl = Unlearner(s["tadapter"], s["tI"], _spec(UnlearnSpec, "ficabu"),
                     device="cpu")
    jp, jst, jg = junl.forget_group(jsets, params=s["params"])
    tp, tst, tg = tunl.forget_group(tsets, params=s["tparams"])
    assert tg["stopped_at_l"] == jg["stopped_at_l"]
    for a, b in zip(jst, tst):
        _assert_stats_equal(a, b, s)
    _assert_fp32_close(s["params"], jp, tp)
    singles = [tunl.forget(r, params=s["tparams"])[1]["stopped_at_l"]
               for r in tsets]
    jsingles = [junl.forget(r, params=s["params"])[1]["stopped_at_l"]
                for r in jsets]
    assert singles == jsingles
    # each set halts at its own first checkpoint at or below tau, read on
    # the suffix both sets edited, so not where it halts alone
    for st in tst:
        trace = st["forget_acc_trace"]
        assert trace[-1][0] == st["stopped_at_l"] and trace[-1][1] <= TAU
        assert all(a > TAU for _, a in trace[:-1])


def test_reference_snapshot_matches_jax_layerwise(tied):
    """forget_group(reference=snapshot) on an already-edited tree: the
    port's scanned program == its layerwise loop bit for bit, and the
    layerwise drain against the reference's LAYERWISE drain (its scanned
    snapshot path is a known caveat under tied embeddings)."""
    s = tied
    fx, fy = s["sets"][1]
    spec = _spec(UnlearnSpec, "ssd")
    edited, _ = Unlearner(s["tadapter"], s["tI"], spec, device="cpu").forget(
        ForgetRequest(fx, fy), params=s["tparams"])
    jedited, _ = JUnlearner(s["jadapter"], s["jI"], _spec(JSpec, "ssd")
                            ).forget(JRequest(fx, fy), params=s["params"])
    sets = [ForgetRequest(*s["sets"][0])]
    out = {}
    for sm in ("layerwise", "scanned"):
        unl = Unlearner(s["tadapter"], s["tI"],
                        _spec(UnlearnSpec, "ficabu", sweep_mode=sm),
                        device="cpu")
        out[sm] = unl.forget_group(sets, params=edited,
                                   reference=s["tparams"])
    _same_bits(out["scanned"][0], out["layerwise"][0])
    jp, jst, _ = JUnlearner(s["jadapter"], s["jI"], _spec(
        JSpec, "ficabu")).forget_group([JRequest(*s["sets"][0])],
                                       params=jedited,
                                       reference=s["params"])
    tp, tst, _ = out["layerwise"]
    _assert_stats_equal(jst[0], tst[0], s)
    _assert_fp32_close(jedited, jp, tp, orig_t=edited)


def test_donated_forget_equals_the_copying_one(tied):
    """``donate=True`` writes each edit into the layer's own tensors — for
    a block of the stack, a view into a stacked leaf — and gives the same
    tree bit for bit as the default, which leaves the caller's tensors
    alone."""
    s = tied
    fx, fy = s["sets"][0]
    donated = {k: v.clone() for k, v in bridge.paths(s["tparams"]).items()}
    tree = _rebuild(s["tparams"], donated)
    out = {}
    for donate, prm in ((False, s["tparams"]), (True, tree)):
        unl = Unlearner(s["tadapter"], s["tI"],
                        _spec(UnlearnSpec, "ssd", donate=donate),
                        device="cpu")
        out[donate] = unl.forget(ForgetRequest(fx, fy), params=prm)[0]
    _same_bits(out[True], out[False])
    assert not torch.equal(donated["embed/w"],
                           bridge.paths(s["tparams"])["embed/w"])


def _rebuild(like, by_path, prefix=""):
    return {k: (_rebuild(v, by_path, f"{prefix}{k}/")
                if isinstance(v, dict) else by_path[f"{prefix}{k}"])
            for k, v in like.items()}
