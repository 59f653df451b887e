"""The streamed Fisher refresh in the port (``repro_torch.engine.
fisher_stream`` and the facade's refresh) against the JAX package's, on the
reference's tiny fleet LM ("fleet-t": 2 blocks, d_model 32, 4 heads over 2
KV heads, d_ff 64, vocab 64) with its weights carried across by ``bridge``
and 16-token ``make_lm_domains`` streams:

  * ``RefreshPolicy`` / ``RefreshSpec``: the same validation messages and
    the same trigger decisions;
  * one fold at decay 1 leaves I_D bit-identical; at decay 0 it equals the
    port's own ``fisher_tree`` bit for bit and the reference's fold within
    the declared Fisher tolerance (rtol 1e-4 on >= 99.9% of the entries,
    2e-3 on all, atol 1e-9); a donating stream folds the same bits and
    never writes the live tree;
  * the facade (``enable_fisher_refresh``, ``refresh_if_due``,
    ``refresh_now``, ``edited_fraction``): after the same forget requests
    the refresh log, the trigger state, the ``fisher.refresh`` events and
    the refresh build/hit counters EQUAL the reference's, the refreshed I_D
    within the Fisher tolerance; a later refresh builds nothing;
  * re-arming evicts the old stream's steps; structural and empty refreshes
    raise the reference's messages with the installed I_D and the stream
    state intact;
  * ``tree_rel_err`` within 1e-6 relative of the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.api import ForgetRequest as JRequest  # noqa: E402
from repro.api import RefreshSpec as JRefreshSpec  # noqa: E402
from repro.api import UnlearnSpec as JSpec  # noqa: E402
from repro.api import Unlearner as JUnlearner  # noqa: E402
from repro.core import adapters as jadapters  # noqa: E402
from repro.core import fisher as jfisher  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.engine import FisherStream as JStream  # noqa: E402
from repro.engine import RefreshPolicy as JPolicy  # noqa: E402
from repro.engine import tree_rel_err as jrel  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.obs import telemetry as jtel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import (ForgetRequest, RefreshSpec,  # noqa: E402
                             UnlearnSpec, Unlearner)
from repro_torch.core import adapters, fisher  # noqa: E402
from repro_torch.engine import FisherStream, RefreshPolicy  # noqa: E402
from repro_torch.engine import tree_rel_err  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models.module import tree_leaves, tree_map  # noqa: E402
from repro_torch.obs import telemetry as tel  # noqa: E402

torch.set_num_threads(2)
TINY = dict(name="fleet-t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
            d_ff=64, vocab=64)
SEQ = 16


def fisher_close(got, want, rtol=1e-4, share=0.999, rtol_all=2e-3,
                 atol=1e-9):
    """The declared Fisher tolerance, leaf by leaf by path."""
    a = bridge.paths(tree_map(lambda t: t.detach().numpy(), got))
    b = bridge.paths(jax.tree_util.tree_map(np.asarray, want))
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = a[k].astype(np.float64), b[k].astype(np.float64)
        close = np.abs(x - y) <= atol + rtol * np.abs(y)
        assert close.mean() >= share, (k, close.mean())
        np.testing.assert_allclose(x, y, rtol=rtol_all, atol=atol, err_msg=k)


def bits_equal(a, b):
    a, b = bridge.paths(a), bridge.paths(b)
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.fixture(scope="module")
def m():
    jcfg, tcfg = JLM.LMConfig(**TINY), LM.LMConfig(**TINY)
    toks, doms = jsyn.make_lm_domains(jsyn.LMDataConfig(
        vocab=64, n_domains=4, seq_len=SEQ, n_per_domain=8, seed=1))
    jparams = JLM.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_to_torch(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")

    def jloss(p, b):
        return JLM.lm_loss(p, jcfg, b[0], b[1], aux_weight=0.0)

    def tloss(p, b):
        return LM.lm_loss(p, tcfg, b[0], b[1], aux_weight=0.0)

    retain = [(toks[16:24, :-1], toks[16:24, 1:]),
              (toks[24:32, :-1], toks[24:32, 1:])]
    first = (toks[:16, :-1], toks[:16, 1:])
    return {
        "toks": toks, "jcfg": jcfg, "tcfg": tcfg, "jparams": jparams,
        "tparams": tparams, "jloss": jloss, "tloss": tloss, "retain":
        retain, "jI": jfisher.diag_fisher(jloss, jparams, first,
                                          chunk_size=4),
        "tI": fisher.diag_fisher(tloss, tparams, first, chunk_size=4,
                                 device="cpu"),
        "jad": jadapters.lm_adapter(jcfg, SEQ),
        "tad": adapters.lm_adapter(tcfg, SEQ, device="cpu"),
    }


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


BAD_POLICIES = [
    {"every_drains": -1}, {"every_drains": True},
    {"staleness_threshold": 1.5}, {"staleness_threshold": "x"},
    {"max_batches": 0}, {"decay": -0.1}, {"decay": 2},
    {"every_drains": 0, "staleness_threshold": 0.0},
]


@pytest.mark.parametrize("kw", BAD_POLICIES,
                         ids=[str(k) for k in BAD_POLICIES])
def test_policy_and_spec_validation_equal(kw):
    assert _error(lambda: RefreshPolicy(**kw)) == \
        _error(lambda: JPolicy(**kw))
    msg = _error(lambda: RefreshSpec(**kw))
    assert msg == _error(lambda: JRefreshSpec(**kw))
    assert "RefreshSpec" in msg and "RefreshPolicy" not in msg


def test_policy_triggers_equal():
    for kw in ({}, {"every_drains": 2}, {"every_drains": 0,
                                         "staleness_threshold": 0.1},
               {"every_drains": 3, "staleness_threshold": 0.5}):
        p, jp = RefreshPolicy(**kw), JPolicy(**kw)
        for drains in range(0, 4):
            for frac in (0.0, 0.05, 0.1, 0.5, 1.0):
                assert p.due(drains, frac) == jp.due(drains, frac)
    spec = RefreshSpec(every_drains=2, max_batches=3, decay=0.25)
    assert spec.to_policy() == RefreshPolicy(every_drains=2, max_batches=3,
                                             decay=0.25)


def _streams(m, decay, **kw):
    return (FisherStream(m["tloss"], m["tI"], decay=decay, chunk_size=4,
                         **kw),
            JStream(m["jloss"], m["jI"], decay=decay, chunk_size=4,
                    donate=False))


def test_fold_decay_one_leaves_fisher_bits(m):
    s, _ = _streams(m, 1.0)
    batch = tree_map(torch.as_tensor, m["retain"][0])
    out = s.fold_into(m["tI"], m["tparams"], batch)
    assert bits_equal(out, m["tI"])


def test_fold_decay_zero_is_the_fisher_of_the_batch(m):
    s, js = _streams(m, 0.0)
    batch = tree_map(torch.as_tensor, m["retain"][0])
    out = s.fold_into(m["tI"], m["tparams"], batch)
    own = fisher.fisher_tree(m["tloss"], m["tparams"], batch, 4)
    assert bits_equal(out, own)
    fisher_close(out, js.fold_into(m["jI"], m["jparams"], m["retain"][0]))


@pytest.mark.parametrize("decay", [0.3, 0.5, 0.9])
def test_fold_matches_reference(m, decay):
    s, js = _streams(m, decay)
    batch = tree_map(torch.as_tensor, m["retain"][1])
    fisher_close(s.fold_into(m["tI"], m["tparams"], batch),
                 js.fold_into(m["jI"], m["jparams"], m["retain"][1]))
    fisher_close(s.blend(m["tI"], m["tI"], 0.3),
                 js.blend(m["jI"], m["jI"], 0.3))


def test_donating_stream_same_bits_live_tree_untouched(m):
    plain, _ = _streams(m, 0.5)
    donor, _ = _streams(m, 0.5, donate=True)
    live = tree_map(torch.clone, m["tI"])
    batch = tree_map(torch.as_tensor, m["retain"][0])
    want = plain.fold_into(m["tI"], m["tparams"], batch)
    assert plain.protect_live_input(m["tI"]) is m["tI"]
    seed = donor.protect_live_input(m["tI"])
    assert donor.donates and seed is not m["tI"]
    got = donor.fold_into(seed, m["tparams"], batch)
    assert bits_equal(got, want) and bits_equal(m["tI"], live)
    assert all(a.data_ptr() == b.data_ptr() for a, b in
               zip(tree_leaves(got), tree_leaves(seed)))
    # standalone: a private cache with the same keying
    donor.fold(m["tparams"], batch)
    assert donor.stats == {"refresh_compiles": 1, "refresh_hits": 1}
    assert donor.count == 1 and bits_equal(m["tI"], live)


def _spec(mod, refresh_cls, **kw):
    rkw = dict(every_drains=2, staleness_threshold=0.0005, max_batches=2,
               decay=0.5)
    rkw.update(kw)
    return mod.for_mode("ficabu", alpha=6.0, lam=0.5, tau=-1.0,
                        checkpoint_every=2, chunk_size=4,
                        refresh=refresh_cls(**rkw))


def _armed(m, **kw):
    unl = Unlearner(m["tad"], m["tI"], _spec(UnlearnSpec, RefreshSpec, **kw),
                    device="cpu")
    unl.enable_fisher_refresh(None, m["retain"], m["tloss"])
    junl = JUnlearner(m["jad"], m["jI"], _spec(JSpec, JRefreshSpec, **kw))
    junl.enable_fisher_refresh(None, m["retain"], m["jloss"])
    return unl, junl


def _event_view(events):
    return [{k: v for k, v in e.items() if k not in ("seq", "t")}
            for e in events if e["kind"] == "fisher.refresh"]


def test_facade_refresh_matches_reference(m):
    """Two forget requests (domains 1 and 2, 8 sequences each) then the
    policy's refreshes, on both sides: the trigger state, the log, the
    events and the counters equal; the I_D within the Fisher tolerance."""
    unl, junl = _armed(m)
    toks = m["toks"]
    tp, jp = m["tparams"], m["jparams"]
    with tel.capture() as cap, jtel.capture() as jcap:
        for d in (1, 2):
            f = toks[8 * d:8 * d + 8]
            tp, st = unl.forget(ForgetRequest(f[:, :-1], f[:, 1:]), params=tp)
            jp, jst = junl.forget(JRequest(f[:, :-1], f[:, 1:]), params=jp)
            assert st["selected_per_layer"] == jst["selected_per_layer"]
            assert unl.edited_fraction == junl.edited_fraction
            e, je = unl.refresh_if_due(tp), junl.refresh_if_due(jp)
            assert (e is None) == (je is None)
            assert e == je
        assert unl.refresh_log == junl.refresh_log and len(unl.refresh_log)
        fisher_close(unl.fisher_global, junl.fisher_global)
        # a manual refresh of three microbatches (the cursor wraps)
        e, je = unl.refresh_now(tp, max_batches=3), junl.refresh_now(jp, 3)
        assert e == je and e["engine"] == {"refresh_compiles": 0,
                                           "refresh_hits": 3}
        fisher_close(unl.fisher_global, junl.fisher_global)
    assert _event_view(cap.events) == _event_view(jcap.events)
    for k in ("refresh_compiles", "refresh_hits", "fused_compiles",
              "fused_hits", "partial_compiles", "partial_hits"):
        assert unl.stats[k] == junl.stats[k], k
    st, jst = unl.fisher_stream, junl.fisher_stream
    assert (st.count, st.decay) == (jst.count, jst.decay)
    assert st.total is unl.fisher_global
    assert _error(lambda: unl.refresh_now(tp, max_batches=0)) == \
        _error(lambda: junl.refresh_now(jp, max_batches=0))


def test_rearm_evicts_old_stream_programs(m):
    unl, _ = _armed(m)
    unl.refresh_now(m["tparams"])
    sess = unl.session
    old = unl.fisher_stream.cache_token
    assert len(sess._refresh) == 1
    unl.enable_fisher_refresh(RefreshPolicy(decay=0.2), m["retain"][:1],
                              m["tloss"])
    assert not any(k[1] is old for k in sess._refresh)
    assert len(sess._refresh) == 0
    e = unl.refresh_now(m["tparams"])
    assert e["engine"]["refresh_compiles"] == 1 and len(sess._refresh) == 1
    assert sess.evict_refresh_programs(object()) == 0
    assert sess.evict_refresh_programs(unl.fisher_stream.cache_token) == 1


def test_structural_refresh_rejected_state_intact(m):
    unl, junl = _armed(m)
    unl.refresh_now(m["tparams"])
    junl.refresh_now(m["jparams"])
    before = tree_map(torch.clone, unl.fisher_global)
    count = unl.fisher_stream.count
    tp = {k: v for k, v in m["tparams"].items() if k != "final_norm"}
    jp = {k: v for k, v in m["jparams"].items() if k != "final_norm"}
    assert _error(lambda: unl.refresh_now(tp)) == \
        _error(lambda: junl.refresh_now(jp))
    assert bits_equal(unl.fisher_global, before)
    assert unl.fisher_stream.count == count
    assert unl.fisher_stream.total is unl.fisher_global


def test_empty_and_unarmed_refreshes_rejected(m):
    unl = Unlearner(m["tad"], m["tI"], UnlearnSpec(), device="cpu")
    junl = JUnlearner(m["jad"], m["jI"], JSpec())
    assert unl.refresh_if_due(m["tparams"]) is None
    assert junl.refresh_if_due(m["jparams"]) is None
    empty = [(m["toks"][:0, :-1], m["toks"][:0, 1:])]
    for fn in (lambda u, loss, P, S: u.refresh_now(None),
               lambda u, loss, P, S: u.enable_fisher_refresh(None, [], loss),
               lambda u, loss, P, S: u.enable_fisher_refresh(P(), [], loss),
               lambda u, loss, P, S: u.enable_fisher_refresh(S(), [], loss),
               lambda u, loss, P, S: u.enable_fisher_refresh(S(), empty,
                                                             loss)):
        assert _error(lambda: fn(unl, m["tloss"], RefreshPolicy,
                                 RefreshSpec)) == \
            _error(lambda: fn(junl, m["jloss"], JPolicy, JRefreshSpec))
    bare = Unlearner(m["tad"], spec=UnlearnSpec(), device="cpu")
    jbare = JUnlearner(m["jad"], spec=JSpec())
    assert _error(lambda: bare.enable_fisher_refresh(
        RefreshSpec(), m["retain"], m["tloss"])) == _error(
        lambda: jbare.enable_fisher_refresh(JRefreshSpec(), m["retain"],
                                            m["jloss"]))
    assert unl.fisher_stream is None and unl.edited_fraction == 0.0


def test_tree_rel_err_matches_reference():
    rng = np.random.default_rng(3)
    a = {"x": rng.random((40, 7), np.float32),
         "y": {"z": rng.random(13).astype(np.float32)}}
    b = {"x": a["x"] * 1.1, "y": {"z": a["y"]["z"] + 0.01}}
    got = tree_rel_err(tree_map(torch.as_tensor, a),
                       tree_map(torch.as_tensor, b))
    want = jrel(a, b)
    assert abs(got - want) <= 1e-6 * want
    # a host tree against another (the stale snapshot's case) and numpy
    assert tree_rel_err(a, tree_map(torch.as_tensor, b)) == got
    zero = {"x": np.zeros((2, 2), np.float32)}
    assert tree_rel_err(zero, zero) == jrel(zero, zero) == float("inf")
    assert _error(lambda: tree_rel_err(a, {"x": b["x"]})) == \
        _error(lambda: jrel(a, {"x": b["x"]}))
