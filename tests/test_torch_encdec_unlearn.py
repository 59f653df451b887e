"""The encoder-decoder end to end: forget requests through the port's
``Unlearner`` against the JAX package's, on whisper-tiny-smoke (2 encoder
and 2 decoder blocks, d_model 64, 4 heads, d_ff 160, vocab 256, 32 stub
frames; the adapter sweeps the decoder chain: 4 unlearn layers).

The model is the reference's own initialisation (``init_encdec`` from
PRNGKey(0), untrained), bridged into the port. Token streams come from
``make_lm_domains`` (vocabulary 256, 16-token inputs) and the stub frames
[16, 32, 64] from a numpy seed; the adapters are built on frames[:8], a
request is 8 sequences of domain 1 labelled with the model's own argmax,
and the global Fisher I_D comes from ``lm_loss`` (z-loss 1e-4) over 8
retain sequences labelled the same way with frames[8:16], computed on
each side. alpha 6, lambda 0.5, checkpoints at every layer, and chunk 8,
the frames' batch: there the reference's cross attention pairs each query
row with its own frames. The port runs with ``use_kernel=True`` (the
dampening wrappers take their plain versions on the CPU), the reference
with ``use_kernel=False``; one facade per package serves the cases in
turn, so the build/hit counts compare as the caches fill. What must hold,
with ``test_torch_recurrent_unlearn.py``'s tolerances:

  * the global Fisher at rtol 1e-4 / atol 1e-12 on >= 99.9% of its entries
    and rtol 2e-3 / atol 1e-9 on all, the encoder's leaves among them;
  * per request (cau, ssd, ficabu at tau = 0 and a ficabu that halts
    partway, each in fp32 and int8): halting, checkpoints, the accuracy
    trace, the profile and the MACs EQUAL, the per-layer selection counts
    within 0.1% of the layer's parameters, every program family's build /
    hit counts EQUAL;
  * fp32 parameters: the edit masks agree on >= 99.9% of the entries and,
    where they agree, the values at rtol 1e-4 / atol 1e-6 on >= 99.5% of
    them and rtol 1e-2 on all; int8: every layer on the reference's grid,
    the codes equal on >= 99.99% of the entries, the values bit-equal where
    they agree;
  * the encoder and ``enc_norm`` come back as the reference returns them,
    bit for bit: the caller's tensors in fp32, their whole-tree fake
    quantisation in int8 — the sweep never edits them;
  * ``plan_scanned_sweep`` returns None on both sides (no ``layer_ctx``:
    the blocks re-encode from the full tree), and every scanned request
    is its layerwise request, bit for bit, reporting ``"layerwise"``;
  * at chunk 4, below the frames' batch, a request still matches the
    reference (the reshape by the query's batch, ROADMAP Queue 3), and
    differs from the chunk-8 request;
  * a K = 2 ficabu drain of domains 1 and 2 against the reference's
    layerwise drain.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_recurrent_unlearn import (  # noqa: E402
    BIT_KEYS, _assert_bulk_close, _assert_params_close, _assert_stats_equal,
    _jax_tree, _np_tree, _same_bits)

from repro.api import ForgetRequest as JRequest  # noqa: E402
from repro.api import UnlearnSpec as JSpec  # noqa: E402
from repro.api import Unlearner as JUnlearner  # noqa: E402
from repro.configs import whisper_tiny as jw  # noqa: E402
from repro.core import adapters as jadapters  # noqa: E402
from repro.core import fisher as jfisher  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.engine import plan_scanned_sweep as jplan  # noqa: E402
from repro.models import encdec as JED  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.api import ForgetRequest, Unlearner, UnlearnSpec  # noqa: E402
from repro_torch.core import adapters as tadapters  # noqa: E402
from repro_torch.core import fisher as tfisher  # noqa: E402
from repro_torch.engine import plan_scanned_sweep  # noqa: E402
from repro_torch.models import encdec as TED  # noqa: E402

torch.set_num_threads(2)
SEQ = 16
N = 8
CASES = {}
for _p in ("fp32", "int8"):
    _s = "" if _p == "fp32" else "-int8"
    CASES.update({f"cau{_s}": ("cau", {"precision": _p}),
                  f"ssd{_s}": ("ssd", {"precision": _p}),
                  f"ficabu{_s}": ("ficabu", {"precision": _p}),
                  f"ficabu-halt{_s}": ("ficabu", {"precision": _p,
                                                  "tau": None})})
FRONT = ("encoder/", "enc_norm/")


def _spec(cls, mode, **kw):
    kw = {"tau": 0.0, "chunk_size": N, **kw}
    return cls.for_mode(mode, alpha=6.0, lam=0.5, checkpoint_every=1,
                        use_kernel=cls is UnlearnSpec, **kw)


def _setting():
    jcfg = jw.SMOKE
    tcfg = tconfigs.get("whisper-tiny").smoke
    params = JED.init_encdec(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_to_torch(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    frames = np.random.default_rng(7).standard_normal(
        (2 * N, jcfg.n_frames, jcfg.d_model)).astype(np.float32)
    toks, doms = jsyn.make_lm_domains(jsyn.LMDataConfig(
        vocab=256, n_domains=4, seq_len=SEQ, n_per_domain=16, seed=1))
    jad = jadapters.encdec_adapter(jcfg, SEQ, jnp.asarray(frames[:N]))
    argmax = jax.jit(lambda p, t: jnp.argmax(jad.forward_collect(p, t)[0],
                                             -1))

    def labelled(seqs):
        x = seqs[:, :-1]
        return x, np.array(argmax(params, jnp.asarray(x)), np.int32)

    split = {d: jsyn.lm_split_forget_retain(toks, doms, d) for d in (1, 2)}
    # the retain batch, labelled through its own frames
    rx = split[1]["retain"][:N, :-1]
    ry = np.array(jnp.argmax(JED.forward(params, jcfg, jnp.asarray(rx),
                                         jnp.asarray(frames[N:])), -1),
                  np.int32)
    rf = frames[N:]
    return {
        "jcfg": jcfg, "tcfg": tcfg, "params": params, "tparams": tparams,
        "frames": frames,
        "jI": jfisher.diag_fisher(
            lambda p, b: JED.lm_loss(p, jcfg, b[0], b[1], b[2]), params,
            (rx, ry, rf), chunk_size=4),
        "tI": tfisher.diag_fisher(
            lambda p, b: TED.lm_loss(p, tcfg, b[0], b[1], b[2]), tparams,
            tuple(torch.from_numpy(a) for a in (rx, ry, rf)), chunk_size=4,
            device="cpu"),
        "jadapter": jad,
        "tadapter": tadapters.encdec_adapter(
            tcfg, SEQ, torch.from_numpy(frames[:N]), device="cpu"),
        "sets": [labelled(split[d]["forget"][:N]) for d in (1, 2)],
    }


def _serve(s):
    fx, fy = s["sets"][0]
    before = {k: v.clone() for k, v in bridge.paths(s["tparams"]).items()}
    junl = JUnlearner(s["jadapter"], s["jI"], _spec(JSpec, "ssd"))
    tunl = Unlearner(s["tadapter"], s["tI"], _spec(UnlearnSpec, "ssd"),
                     device="cpu")
    out = {}
    for case, (mode, kw) in CASES.items():
        if kw.get("tau", 0.0) is None:
            trace = out[case.replace("-halt", "")]["j"][1]["forget_acc_trace"]
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
    s = _setting()
    return s, _serve(s)


def _assert_int8_on_grid_and_close(s, jp, tp, stopped, codes=0.9999):
    """Every layer on the reference's grid for it (a layer never swept:
    the whole-tree fake quantisation); codes equal on at least ``codes``
    of the entries, the values bit-equal wherever they agree."""
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
                ref = (whole[f"embed/{k}"] if j == 0 else whole[k]
                       if j == L - 1 else whole[f"decoder/{k}"][j - 1])
                ref = np.asarray(ref, np.float32)
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


def _front(tree):
    return {k: v for k, v in tree.items() if k.startswith(FRONT)}


# -- the Fisher and the requests ---------------------------------------------
def test_global_fisher_matches_jax(served):
    s, _ = served
    want = _jax_tree(s["jI"])
    got = _np_tree(s["tI"])
    assert sorted(got) == sorted(want) and len(want) == 27
    _assert_bulk_close(got, want, rtol=1e-4, atol=1e-12, bulk=0.999,
                       rtol_all=2e-3, atol_all=1e-9)
    assert all(want[k].max() > 0 for k in _front(want))


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
    if "halt" in case:
        assert 1 <= tst["stopped_at_l"] < L, tst["forget_acc_trace"]
    elif case.startswith("ssd"):
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


@pytest.mark.parametrize("case", CASES)
def test_encoder_comes_back_unedited(served, case):
    """The encoder and enc_norm: the caller's tensors (fp32) or their
    whole-tree fake quantisation (int8), bit for bit, on both sides."""
    s, res = served
    want = _front(_jax_tree(res[case]["j"][0]))
    got = _front(_np_tree(res[case]["t"][0]))
    orig = _front(_jax_tree(s["params"]))
    if "int8" in case:
        orig = _front(_jax_tree(jcomp.q8_fakequant_tree(s["params"])))
    assert sorted(got) == sorted(want) == sorted(orig) and len(got) == 10
    for k in want:
        np.testing.assert_array_equal(want[k].view(np.uint32),
                                      orig[k].view(np.uint32), err_msg=k)
        np.testing.assert_array_equal(got[k].view(np.uint32),
                                      orig[k].view(np.uint32), err_msg=k)


def test_forget_leaves_caller_tensors_untouched(served):
    s, res = served
    for k, t in bridge.paths(s["tparams"]).items():
        assert torch.equal(t, res["before"][k]), k


# -- the scanned program, the chunk caveat and the drain ----------------------
def test_planner_declines_as_the_reference(served):
    s, _ = served
    fx = s["sets"][0][0]
    assert s["tadapter"].layer_ctx is None
    assert plan_scanned_sweep(s["tadapter"], s["tparams"],
                              torch.from_numpy(fx)) is None
    assert jplan(s["jadapter"], s["params"], jnp.asarray(fx)) is None


@pytest.mark.parametrize("case", ["cau", "ssd", "ficabu-halt", "ssd-int8",
                                  "ficabu-int8"])
def test_scanned_requests_equal_layerwise_bit_for_bit(served, case):
    s, res = served
    fx, fy = s["sets"][0]
    _, tunl = res["facades"]
    mode, kw = CASES[case][0], res[case]["kw"]
    p, st = tunl.with_spec(_spec(UnlearnSpec, mode, sweep_mode="scanned",
                                 **kw)).forget(ForgetRequest(fx, fy),
                                               params=s["tparams"])
    assert st["engine"]["sweep_mode"] == "layerwise", case
    _same_bits(p, res[case]["t"][0])
    for k in BIT_KEYS:
        assert st[k] == res[case]["t"][1][k], (case, k)


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_chunk_below_frames_batch_matches_jax(served, precision):
    """chunk 4 against 8 memory rows: each vjp chunk's cross attention
    reads two rows' frames per query row, in both packages; the stats and
    parameters still match the reference, and the decoder's edit differs
    from the chunk-8 request's (the caveat is live, not vacuous)."""
    s, res = served
    fx, fy = s["sets"][0]
    junl, tunl = res["facades"]
    kw = {"precision": precision, "chunk_size": 4}
    jp, jst = junl.with_spec(_spec(JSpec, "ssd", **kw)).forget(
        JRequest(fx, fy), params=s["params"])
    tp, tst = tunl.with_spec(_spec(UnlearnSpec, "ssd", **kw)).forget(
        ForgetRequest(fx, fy), params=s["tparams"])
    _assert_stats_equal(jst, tst, s)
    if precision == "fp32":
        _assert_params_close(s["params"], jp, tp)
    else:
        _assert_int8_on_grid_and_close(s, jp, tp, tst["stopped_at_l"])
    at8 = _np_tree(res["ssd" if precision == "fp32" else "ssd-int8"]["t"][0])
    at4 = _np_tree(tp)
    gap = max(float(np.abs(at4[k].astype(np.float32)
                           - at8[k].astype(np.float32)).max())
              for k in at4 if k.startswith("decoder/"))
    assert gap > 1e-3, gap


def test_group_matches_jax_layerwise_and_scanned_is_layerwise(served):
    """A K = 2 ficabu drain (the halting tau) against the reference's
    layerwise drain; the port's scanned drain is its layerwise one."""
    s, res = served
    kw = res["ficabu-halt"]["kw"]
    junl, tunl = res["facades"]
    jp, jst, jg = junl.with_spec(_spec(JSpec, "ficabu", **kw)).forget_group(
        [JRequest(*st) for st in s["sets"]], params=s["params"])
    out = {}
    for sm in ("layerwise", "scanned"):
        out[sm] = tunl.with_spec(_spec(UnlearnSpec, "ficabu", sweep_mode=sm,
                                       **kw)).forget_group(
            [ForgetRequest(*st) for st in s["sets"]], params=s["tparams"])
    tp, tst, tg = out["layerwise"]
    assert tg["stopped_at_l"] == jg["stopped_at_l"]
    for a, b in zip(jst, tst):
        _assert_stats_equal(a, b, s)
    _assert_params_close(s["params"], jp, tp)
    sp, sst, sg = out["scanned"]
    assert sg["engine"]["sweep_mode"] == "layerwise"
    _same_bits(sp, tp)
