"""The recurrent-LM slice end to end: forget requests through the port's
``Unlearner`` against the JAX package's, on xlstm-125m-smoke (mlstm x3 +
slstm, no FFN: 6 unlearn layers). ``test_torch_recurrent_unlearn_griffin.py``
runs every test of this file on recurrentgemma-9b-smoke (two (rglru,
rglru, local) periods and a two-layer rglru tail: 10 unlearn layers), so
that the two models' reference runs land on two test workers, and holds
the bf16 model.

Each model is the reference's own initialisation (``init_lm`` from
PRNGKey(0), untrained), bridged into the port. Token streams come from
``make_lm_domains`` (vocabulary 256, 16-token inputs); a request is 8
sequences of domain 1, labelled with the model's own argmax (forget
accuracy 1 before the edit), the global Fisher I_D comes from ``lm_loss``
(z-loss 1e-4) over 8 retain sequences labelled the same way, computed on
each side. alpha 6, lambda 0.5, chunk 4, checkpoints every 2 layers. The
port runs on the CPU with ``use_kernel=True`` (the dampening wrappers take
their plain versions, through the per-dtype split of
``core.ssd.dampen_tree_counted``); the reference with ``use_kernel=False``
(its Pallas kernels in interpret mode would only be slower). Requests of a
model run one after another on ONE facade per package (``with_spec``), so
each program is built once and the build/hit counts compare as the cache
fills. What must hold:

  * the global Fisher at rtol 1e-4 / atol 1e-12 on >= 99.5% of its entries
    and at rtol 1e-2 / atol 1e-9 on all (the recurrences carry the
    products' f32 rounding through the sequence, and the Fisher squares
    it; its largest entries are about 0.3);
  * per request (fp32: ssd, cau, bd, ficabu at tau = 0, and a ficabu whose
    tau, the reference's own forget accuracy at its middle checkpoint,
    halts it partway; int8: ssd, ficabu): halting, checkpoints, the
    accuracy trace, the profile and the MACs EQUAL; the per-layer
    selection counts within 0.1% of the layer's parameters; every
    program family's build/hit counts EQUAL;
  * fp32 parameters: the edit masks agree on >= 99.9% of the entries and,
    where they agree, the values at rtol 1e-4 / atol 1e-6 on >= 99.5% of
    them and rtol 1e-2 on all;
  * int8 parameters: every layer on the grid the reference gives it (the
    stacked 4-D sLSTM weights included: one scale per period for the
    whole-tree fake quantisation, per head row for the edit codes), the
    codes equal on >= 99.99% of the entries, the values bit-equal where
    they agree;
  * ``plan_scanned_sweep`` returns None, as the reference does (the middle
    layers differ in shape), after its ``meta`` forward ran the sLSTM's
    time loop or the RG-LRU scan; a scanned request (ssd, the halting
    ficabu, int8 ssd) and a scanned K = 2 drain are the layerwise ones,
    BIT FOR BIT, and report ``sweep_mode: "layerwise"``;
  * a K = 2 ficabu drain of domains 1 and 2 against the reference's
    layerwise drain: per-set stats equal, parameters within the fp32
    tolerances.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import ForgetRequest as JRequest  # noqa: E402
from repro.api import UnlearnSpec as JSpec  # noqa: E402
from repro.api import Unlearner as JUnlearner  # noqa: E402
from repro.configs import recurrentgemma_9b as jrg  # noqa: E402
from repro.configs import xlstm_125m as jxl  # noqa: E402
from repro.core import adapters as jadapters  # noqa: E402
from repro.core import fisher as jfisher  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.engine import plan_scanned_sweep as jplan  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.api import ForgetRequest, Unlearner, UnlearnSpec  # noqa: E402
from repro_torch.core import adapters as tadapters  # noqa: E402
from repro_torch.core import fisher as tfisher  # noqa: E402
from repro_torch.engine import plan_scanned_sweep  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models.module import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(2)
ARCHS = {"xlstm-125m": jxl, "recurrentgemma-9b": jrg}
SEQ = 16
CASES = {m: (m, {}) for m in ("ssd", "cau", "bd", "ficabu")}
CASES["ficabu-halt"] = ("ficabu", {"tau": None})     # tau set per model
CASES["ssd-int8"] = ("ssd", {"precision": "int8"})
CASES["ficabu-int8"] = ("ficabu", {"precision": "int8"})
STAT_KEYS = ("stopped_at_l", "checkpoints_hit", "forget_acc_trace",
             "profile_S", "macs", "macs_ssd", "macs_vs_ssd_pct")
BIT_KEYS = STAT_KEYS + ("selected_per_layer",)


def _np_tree(t):
    return bridge.paths(bridge.params_to_numpy(t))


def _jax_tree(t):
    return bridge.paths(jax.tree_util.tree_map(np.asarray, t))


def _spec(cls, mode, **kw):
    kw = {"tau": 0.0, **kw}
    return cls.for_mode(mode, alpha=6.0, lam=0.5, checkpoint_every=2,
                        chunk_size=4, use_kernel=cls is UnlearnSpec, **kw)


def _setting(arch, dtype="float32", archs=ARCHS):
    """The model on both sides, its Fisher on each, the adapters, the
    forget sets of domains 1 and 2 and the retain batch the Fisher ran on
    (argmax labels); ``archs`` maps the arch to its reference config
    module."""
    jcfg = archs[arch].SMOKE.with_(param_dtype=dtype)
    tcfg = tconfigs.get(arch).smoke.with_(param_dtype=dtype)
    params = JLM.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_to_torch(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    toks, doms = jsyn.make_lm_domains(jsyn.LMDataConfig(
        vocab=256, n_domains=4, seq_len=SEQ, n_per_domain=16, seed=1))
    jad = jadapters.lm_adapter(jcfg, SEQ)
    argmax = jax.jit(lambda p, t: jnp.argmax(jad.forward_collect(p, t)[0],
                                             -1))

    def labelled(seqs):
        x = seqs[:, :-1]
        return x, np.array(argmax(params, jnp.asarray(x)), np.int32)

    split = {d: jsyn.lm_split_forget_retain(toks, doms, d) for d in (1, 2)}
    retain = labelled(split[1]["retain"][:8])
    return {
        "arch": arch, "jcfg": jcfg, "tcfg": tcfg,
        "params": params, "tparams": tparams,
        "jI": jfisher.diag_fisher(
            lambda p, b: JLM.lm_loss(p, jcfg, b[0], b[1]), params, retain,
            chunk_size=4),
        "tI": tfisher.diag_fisher(
            lambda p, b: TLM.lm_loss(p, tcfg, b[0], b[1]), tparams, retain,
            chunk_size=4, device="cpu"),
        "jadapter": jad,
        "tadapter": tadapters.lm_adapter(tcfg, SEQ, device="cpu"),
        "sets": [labelled(split[d]["forget"][:8]) for d in (1, 2)],
        "retain": retain,
    }


def _serve(s):
    """Every case, in CASES' order, on one facade per package; each case's
    result, stats and the facades' counters after it."""
    fx, fy = s["sets"][0]
    before = {k: v.clone() for k, v in bridge.paths(s["tparams"]).items()}
    junl = JUnlearner(s["jadapter"], s["jI"], _spec(JSpec, "ssd"))
    tunl = Unlearner(s["tadapter"], s["tI"], _spec(UnlearnSpec, "ssd"),
                     device="cpu")
    out = {}
    for case, (mode, kw) in CASES.items():
        if kw.get("tau", 0.0) is None:
            trace = out["ficabu"]["j"][1]["forget_acc_trace"]
            kw = dict(kw, tau=trace[len(trace) // 2][1])
        junl = junl.with_spec(_spec(JSpec, mode, **kw))
        tunl = tunl.with_spec(_spec(UnlearnSpec, mode, **kw))
        jp, jst = junl.forget(JRequest(fx, fy), params=s["params"])
        tp, tst = tunl.forget(ForgetRequest(fx, fy), params=s["tparams"])
        out[case] = {"j": (jp, jst, dict(junl.stats)),
                     "t": (tp, tst, dict(tunl.stats)), "kw": kw}
    out["before"] = before
    out["facades"] = (junl, tunl)
    return out


@pytest.fixture(scope="module")
def served():
    s = _setting("xlstm-125m")
    return s, _serve(s)


def _layer_params(s, l):
    return sum(t.numel() for t in tree_leaves(
        s["tadapter"].get_layer(s["tparams"], s["tadapter"].n_layers - l)))


def _assert_stats_equal(jst, tst, s):
    for k in STAT_KEYS:
        assert tst[k] == jst[k], (k, tst[k], jst[k])
    assert sorted(tst["selected_per_layer"]) == \
        sorted(jst["selected_per_layer"])
    for l, n_j in jst["selected_per_layer"].items():
        assert abs(tst["selected_per_layer"][l] - n_j) <= \
            1e-3 * _layer_params(s, l), l


def _assert_bulk_close(got, want, *, rtol, atol, bulk, rtol_all, mask=None,
                       atol_all=None):
    """Over the tree (by path): at least ``bulk`` of the entries within
    rtol/atol and every entry within rtol_all/atol_all (default atol)."""
    ok = total = 0
    for k in want:
        g, w = got[k], want[k]
        if mask is not None:
            g, w = g[mask[k]], w[mask[k]]
        if rtol_all is not None:
            np.testing.assert_allclose(
                g, w, rtol=rtol_all, atol=atol if atol_all is None
                else atol_all, err_msg=k)
        ok += int((np.abs(g - w) <= atol + rtol * np.abs(w)).sum())
        total += w.size
    assert ok >= bulk * total, (ok, total)


def _assert_params_close(orig_j, want_j, got_t, *, agree=0.999, rtol=1e-4,
                         atol=1e-6, bulk=0.995, rtol_all=1e-2):
    """The edit masks (against each side's starting tree) and the edited
    values where they agree, in f32 (bf16 leaves are upcast exactly)."""
    f32 = lambda t: {k: np.asarray(v, np.float32)  # noqa: E731
                     for k, v in t.items()}
    orig = f32(_jax_tree(orig_j))
    want = f32(_jax_tree(want_j))
    got = {k: v.float().numpy() for k, v in bridge.paths(got_t).items()}
    assert sorted(got) == sorted(want)
    same = {k: (want[k] != orig[k]) == (got[k] != orig[k]) for k in want}
    n_agree = sum(int(m.sum()) for m in same.values())
    total = sum(m.size for m in same.values())
    assert n_agree >= agree * total, (n_agree, total)
    _assert_bulk_close(got, want, rtol=rtol, atol=atol, bulk=bulk,
                       rtol_all=rtol_all, mask=same)


def _assert_int8_on_grid_and_close(s, jp, tp, stopped, codes=0.9999):
    """Every layer on the reference's grid for it; codes equal on at least
    ``codes`` of the entries and the values bit-equal wherever they
    agree."""
    ad, jad = s["tadapter"], s["jadapter"]
    L = ad.n_layers
    whole = _jax_tree(jcomp.q8_fakequant_tree(s["params"]))
    agree = total = 0
    for j in range(L):
        want = _jax_tree(jad.get_layer(jp, j))
        got = {k: v.float().numpy() for k, v in bridge.paths(
            ad.get_layer(tp, j)).items()}
        pristine = jad.get_layer(s["params"], j)
        scales = _jax_tree(jcomp.q8_quantize_tree(pristine)[1])
        for k, w in want.items():
            w, g = np.asarray(w, np.float32), got[k]
            if L - j > stopped:
                # never swept: the whole-tree fake quantisation
                ref = np.asarray(_row(s, whole, j, k), np.float32)
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


def _row(s, whole, j, k):
    """Layer j's leaf ``k`` of the whole-tree fake quantisation."""
    cfg = s["jcfg"]
    L = s["tadapter"].n_layers
    period = len(cfg.block_pattern)
    if j == 0:
        return whole[f"embed/{k}"]
    if j == L - 1:
        return whole[k]
    i = j - 1
    if i < cfg.n_periods * period:
        return whole[f"period_stack/{i % period}/{k}"][i // period]
    return whole[f"tail/{i - cfg.n_periods * period}/{k}"]


# -- the Fisher and the requests ---------------------------------------------
def test_global_fisher_matches_jax(served):
    s, _ = served
    want = _jax_tree(s["jI"])
    got = _np_tree(s["tI"])
    assert sorted(got) == sorted(want)
    _assert_bulk_close(got, want, rtol=1e-4, atol=1e-12, bulk=0.995,
                       rtol_all=1e-2, atol_all=1e-9)


@pytest.mark.parametrize("case", CASES)
def test_halting_macs_and_counts_equal_jax(served, case):
    s, res = served
    jp, jst, jcounts = res[case]["j"]
    tp, tst, tcounts = res[case]["t"]
    _assert_stats_equal(jst, tst, s)
    assert tst["mode"] == jst["mode"] == CASES[case][0]
    assert tst["engine"]["precision"] == jst["engine"]["precision"]
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
    _assert_params_close(s["params"], res[case]["j"][0], res[case]["t"][0])


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
def test_planner_falls_back_as_the_reference(served):
    """Both models' middle layers differ in shape (mlstm / slstm; rglru /
    local): no plan, on either side. The meta forward the planner uses
    runs through the sLSTM's time loop and the RG-LRU scan."""
    s, _ = served
    fx = s["sets"][0][0]
    assert plan_scanned_sweep(s["tadapter"], s["tparams"],
                              torch.from_numpy(fx)) is None
    assert jplan(s["jadapter"], s["params"], jnp.asarray(fx)) is None
    meta = tree_map(lambda t: torch.empty_like(t, device="meta"),
                    s["tparams"])
    x, acts = s["tadapter"].forward_collect(
        meta, torch.empty(fx.shape, dtype=torch.int32, device="meta"))
    V = s["tcfg"].vocab
    assert x.shape == (*fx.shape, V) and len(acts) == s["tadapter"].n_layers


def _same_bits(p, q):
    a, b = bridge.paths(p), bridge.paths(q)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(
            a[k].contiguous().view(torch.uint8),
            b[k].contiguous().view(torch.uint8)), k


def test_scanned_requests_equal_layerwise_bit_for_bit(served):
    """sweep_mode="scanned" falls back to the layerwise loop on these
    models: ssd, the halting ficabu and int8 ssd equal their layerwise
    requests bit for bit and report the loop."""
    s, res = served
    fx, fy = s["sets"][0]
    _, tunl = res["facades"]
    for case in ("ssd", "ficabu-halt", "ssd-int8"):
        mode, kw = CASES[case][0], res[case]["kw"]
        p, st = tunl.with_spec(_spec(UnlearnSpec, mode, sweep_mode="scanned",
                                     **kw)).forget(ForgetRequest(fx, fy),
                                                   params=s["tparams"])
        assert st["engine"]["sweep_mode"] == "layerwise", case
        _same_bits(p, res[case]["t"][0])
        for k in BIT_KEYS:
            assert st[k] == res[case]["t"][1][k], (case, k)


def test_group_matches_jax_layerwise_and_scanned_is_layerwise(served):
    """A K = 2 ficabu drain (the halting tau) against the reference's
    layerwise drain, and the port's scanned drain == its layerwise one."""
    s, res = served
    kw = res["ficabu-halt"]["kw"]
    junl, tunl = res["facades"]
    jsets = [JRequest(*st) for st in s["sets"]]
    tsets = [ForgetRequest(*st) for st in s["sets"]]
    jp, jst, jg = junl.with_spec(_spec(JSpec, "ficabu", **kw)).forget_group(
        jsets, params=s["params"])
    out = {}
    for sm in ("layerwise", "scanned"):
        out[sm] = tunl.with_spec(_spec(UnlearnSpec, "ficabu", sweep_mode=sm,
                                       **kw)).forget_group(
            tsets, params=s["tparams"])
    tp, tst, tg = out["layerwise"]
    assert tg["stopped_at_l"] == jg["stopped_at_l"]
    for a, b in zip(jst, tst):
        _assert_stats_equal(a, b, s)
    _assert_params_close(s["params"], jp, tp)
    sp, sst, sg = out["scanned"]
    assert sg["engine"]["sweep_mode"] == "layerwise"
    _same_bits(sp, tp)
    for a, b in zip(sst, tst):
        for k in BIT_KEYS:
            assert a[k] == b[k], k
