"""The scanned whole-sweep program and the coalesced ``forget_group`` of the
port (``repro_torch.engine.sweep``, ``UnlearnSession.forget_many``) against
the port's own layerwise driver and against the JAX package.

The tiny ViT is the reference's sweep-test model (4 blocks, d_model 32, 2
heads, d_ff 64, 16x16 images, patch 4: 6 unlearn layers), JAX-initialised
from PRNGKey(0) and bridged into the port, with the reference's global
Fisher (over all 48 synthetic images) bridged too, so both packages see the
same operands; a request forgets 16 of them. The port runs on
the CPU with ``use_kernel=True`` (the dampening wrappers take their plain
versions there); the reference runs with ``use_kernel=False`` (its Pallas
kernels in interpret mode would be slow inside a scan). What must hold:

  * the plan equals the reference's (kinds, representative depths, type
    ids); a ResNet stack and a ragged group fall back to the layerwise
    driver, in both packages;
  * ``effective_tau32`` equals the reference's;
  * the port's scanned path equals the port's layerwise path BIT FOR BIT —
    edited parameters, ``stopped_at_l``, ``selected_per_layer``,
    ``checkpoints_hit``, ``forget_acc_trace`` and MACs — in fp32 (ssd;
    ficabu with tau = -1 at checkpoint_every 1 and 2; a ficabu that halts
    mid-sweep; balanced on and off; max_layers 1, 2 and 4) and int8 (ssd,
    ficabu), for one request (alpha 2, lambda 1) and for a coalesced group
    of two;
  * against the reference's scanned path (and, for ``reference=snapshot``,
    its LAYERWISE path: ROADMAP Queue 3): halting, checkpoints, the
    accuracy trace, MACs and build/hit counts EQUAL; selection counts
    within 0.1% of the layer's parameters; the parameters with
    ``tests/test_torch_vit_unlearn.py``'s declared tolerances — edit masks
    agree on >= 99.9% of the entries outside ``attn/bk``, the values where
    they agree at rtol 1e-4 / atol 1e-6 on >= 99.5% and rtol 1e-2 on all,
    ``attn/bk`` moving by at most the size of its entries (its gradient is
    zero in exact arithmetic); int8 codes equal on >= 99.9% of the entries;
  * the K = 2 group uses alpha 32, lambda 0.9, tau 0.5, checkpoint_every 1,
    BD off: set H is labelled with the model's own argmax (accuracy 1) and
    sweeps all 6 layers, set E with its true labels (accuracy 0.25 <= tau)
    halts at l = 1, so the device-side mask is exercised: halts [6, 1];
  * a warm program is never rebuilt: ``TRACE_LOG`` stays empty on repeats
    and on changes of (alpha, lam, tau, b_r) and of the Fisher's values.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import adapters as jadapters  # noqa: E402
from repro.core import cau as jcau  # noqa: E402
from repro.core import fisher as jfisher  # noqa: E402
from repro.core import ficabu as jficabu  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.engine import ProgramCache as JProgramCache  # noqa: E402
from repro.engine import UnlearnSession as JSession  # noqa: E402
from repro.engine import effective_tau32 as jeffective_tau32  # noqa: E402
from repro.engine import plan_scanned_sweep as jplan  # noqa: E402
from repro.models import vision as JV  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import (ExecSpec, ForgetRequest, Unlearner,  # noqa: E402
                             UnlearnSpec)
from repro_torch.core import adapters as tadapters  # noqa: E402
from repro_torch.core import cau as tcau  # noqa: E402
from repro_torch.core import ficabu as tficabu  # noqa: E402
from repro.obs import telemetry as jtel  # noqa: E402
from repro_torch.engine import (TRACE_LOG, ProgramCache,  # noqa: E402
                                UnlearnSession, effective_tau32,
                                plan_scanned_sweep)
from repro_torch.models import vision as TV  # noqa: E402
from repro_torch.models.module import tree_leaves, tree_map  # noqa: E402
from repro_torch.obs import telemetry as ttel  # noqa: E402

torch.set_num_threads(2)
TINY = dict(n_layers=4, d_model=32, n_heads=2, d_ff=64, n_classes=6,
            img_size=16, patch=4)
L = TINY["n_layers"] + 2
STAT_KEYS = ("stopped_at_l", "selected_per_layer", "checkpoints_hit",
             "forget_acc_trace", "macs", "macs_ssd", "macs_vs_ssd_pct")
# the K = 2 group of the module docstring
GROUP = dict(alpha=32.0, lam=0.9, tau=0.5, checkpoint_every=1,
             balanced=False, chunk_size=8)


@pytest.fixture(scope="module")
def m():
    jcfg = JV.ViTConfig(name="vit-t", **TINY)
    params = JV.init_vit(jax.random.PRNGKey(0), jcfg)
    x, y = jsyn.make_classification(jsyn.ClsDataConfig(
        n_classes=6, n_per_class=8, img_size=16, seed=0))
    loss_fn = lambda p, b: JV.cls_loss(JV.vit_forward(p, jcfg, b[0]), b[1])  # noqa: E731
    i_d = jfisher.diag_fisher(loss_fn, params, (x, y), chunk_size=8)
    hard = np.asarray(jnp.argmax(JV.vit_forward(params, jcfg, x[:16]), -1))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"jparams": params, "jI": i_d, "x": x, "y": y,
            "tparams": bridge.params_to_torch(np_tree(params), device="cpu"),
            "tI": bridge.params_to_torch(np_tree(i_d), device="cpu"),
            "jadapter": jadapters.vit_adapter(jcfg),
            "tadapter": tadapters.vit_adapter(TV.ViTConfig(name="vit-t",
                                                           **TINY),
                                              device="cpu"),
            # set H: the model's own argmax (never halts at tau 0.5); set
            # E: the true labels of other images (halts at l = 1)
            "group": [(x[:16], hard), (x[16:32], y[16:32])]}


def _t(sets):
    return [(torch.tensor(a), torch.tensor(b)) for a, b in sets]


def _cfg(mod, **kw):
    base = dict(alpha=2.0, lam=1.0, chunk_size=8)
    base.update(kw)
    return mod.UnlearnConfig(**base)


def _port(m, cfg, sets=None, *, session=None, reference=None):
    """The port's forget (one set) or forget_many (a list of sets)."""
    sess = session or UnlearnSession(m["tadapter"], m["tI"])
    if sets is None:
        x, y = _t([(m["x"][:16], m["y"][:16])])[0]
        return sess.forget(m["tparams"], x, y, cfg)
    return sess.forget_many(m["tparams"] if reference is None
                            else reference[0], _t(sets), cfg,
                            reference=None if reference is None
                            else reference[1])


def _assert_bits_equal(a, b):
    pa, pb = bridge.paths(a), bridge.paths(b)
    assert sorted(pa) == sorted(pb)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


def _assert_stats_equal(sa, sb):
    for k in STAT_KEYS:
        assert sa[k] == sb[k], (k, sa[k], sb[k])


# ---------------------------------------------------------------------------
# the plan and tau
# ---------------------------------------------------------------------------
def test_plan_equals_reference(m):
    want = jplan(m["jadapter"], m["jparams"], m["x"][:16])
    got = plan_scanned_sweep(m["tadapter"], m["tparams"],
                             torch.as_tensor(m["x"][:16]))
    for f in ("n_layers", "kinds", "rep_depths", "type_ids",
              "cache_fields"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.type_ids == (0,) * TINY["n_layers"]


def test_resnet_and_ragged_groups_fall_back_to_layerwise(m):
    """A ResNet's per-stage shapes and a group whose sets differ in batch
    size cannot be scanned: both packages report plan None / "layerwise",
    and the port's result is its layerwise one, bit for bit."""
    rcfg = dict(width=8, n_classes=6, img_size=16)
    tres = TV.init_resnet(torch.Generator().manual_seed(0),
                          TV.ResNetConfig(**rcfg), device="cpu")
    jres = bridge.params_to_numpy(tres)
    tad = tadapters.resnet_adapter(TV.ResNetConfig(**rcfg), device="cpu")
    x = m["x"][:16]
    assert jplan(jadapters.resnet_adapter(JV.ResNetConfig(**rcfg)), jres,
                 x) is None
    assert plan_scanned_sweep(tad, tres, torch.as_tensor(x)) is None
    i_r = tree_map(lambda t: t * t + 1e-6, tres)
    sets = _t([(x[:8], m["y"][:8]), (x[8:16], m["y"][8:16])])
    cfg = _cfg(tcau, tau=-1.0, checkpoint_every=2, sweep_mode="scanned")
    p_sc, st_sc, g_sc = UnlearnSession(tad, i_r).forget_many(tres, sets, cfg)
    p_lw, st_lw, g_lw = UnlearnSession(tad, i_r).forget_many(
        tres, sets, dataclasses.replace(cfg, sweep_mode="layerwise"))
    assert g_sc["engine"]["sweep_mode"] == "layerwise"
    assert "sweep_launches" not in g_sc["engine"]
    _assert_bits_equal(p_sc, p_lw)
    for a, b in zip(st_sc, st_lw):
        _assert_stats_equal(a, b)
    # ragged: 16 and 8 images
    ragged = [(m["x"][:16], m["y"][:16]), (m["x"][16:24], m["y"][16:24])]
    _, _, g_t = _port(m, _cfg(tcau, tau=-1.0, checkpoint_every=2,
                              sweep_mode="scanned"), ragged)
    _, _, g_j = JSession(m["jadapter"], m["jI"]).forget_many(
        m["jparams"], ragged, _cfg(jcau, tau=-1.0, checkpoint_every=2,
                                   sweep_mode="scanned"))
    assert g_t["engine"]["sweep_mode"] == g_j["engine"]["sweep_mode"] \
        == "layerwise"
    assert g_t["stopped_at_l"] == g_j["stopped_at_l"] == [L, L]


def test_effective_tau32_equals_reference():
    rng = np.random.default_rng(0)
    f32 = np.float32
    taus = list(rng.normal(size=64)) + list(rng.uniform(0, 1, 64)) + [
        0.0, -0.0, 1 / 3, 0.05, -1.0, 0.5, 1.0, np.inf, -np.inf,
        float(np.nextafter(f32(0.3), f32(1))),
        float(np.nextafter(f32(0.3), f32(-1))), 1e-45, -1e-45, 3.4e38]
    for tau in taus:
        got, want = effective_tau32(tau), jeffective_tau32(tau)
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes(), tau
        for a in (f32(tau), np.nextafter(f32(tau), f32(np.inf)),
                  np.nextafter(f32(tau), f32(-np.inf))):
            assert (a <= got) == (float(a) <= tau), (tau, a)


# ---------------------------------------------------------------------------
# scanned == layerwise in the port, bit for bit
# ---------------------------------------------------------------------------
SINGLE = {
    "ssd": dict(tau=-1.0, checkpoint_every=0),
    "ficabu-nohalt-ce1": dict(tau=-1.0, checkpoint_every=1, balanced=True),
    "ficabu-nohalt-ce2": dict(tau=-1.0, checkpoint_every=2, balanced=True),
    "ficabu-nohalt-ce2-bd-off": dict(tau=-1.0, checkpoint_every=2),
    "ficabu-halts": dict(tau=0.35, checkpoint_every=1, balanced=True),
    "bounded-1": dict(tau=-1.0, checkpoint_every=1, max_layers=1),
    "bounded-2": dict(tau=-1.0, checkpoint_every=1, max_layers=2,
                      balanced=True),
    "bounded-4": dict(tau=-1.0, checkpoint_every=2, max_layers=4),
    "int8-ssd": dict(tau=-1.0, checkpoint_every=0, precision="int8"),
    "int8-ficabu": dict(tau=-1.0, checkpoint_every=2, balanced=True,
                        precision="int8"),
    "int8-ficabu-halts": dict(tau=0.3, checkpoint_every=1,
                              precision="int8"),
}


@pytest.mark.parametrize("case", SINGLE)
def test_scanned_forget_equals_layerwise_bit_for_bit(m, case):
    cfg = _cfg(tcau, use_kernel=True, **SINGLE[case])
    p_lw, s_lw = _port(m, cfg)
    p_sc, s_sc = _port(m, dataclasses.replace(cfg, sweep_mode="scanned"))
    assert s_sc["engine"]["sweep_mode"] == "scanned"
    assert s_sc["engine"]["sweep_launches"] == 1
    assert s_lw["engine"]["sweep_mode"] == "layerwise"
    _assert_bits_equal(p_lw, p_sc)
    _assert_stats_equal(s_lw, s_sc)
    assert sum(s_sc["selected_per_layer"].values()) > 0
    if "halts" in case:
        assert s_sc["stopped_at_l"] < L
    if case.startswith("bounded"):
        assert s_sc["stopped_at_l"] == SINGLE[case]["max_layers"]


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_scanned_group_equals_layerwise_bit_for_bit(m, precision):
    cfg = tcau.UnlearnConfig(use_kernel=True, precision=precision, **GROUP)
    p_lw, st_lw, g_lw = _port(m, cfg, m["group"])
    p_sc, st_sc, g_sc = _port(m, dataclasses.replace(cfg,
                                                     sweep_mode="scanned"),
                              m["group"])
    assert g_sc["engine"]["sweep_mode"] == "scanned"
    assert g_sc["engine"]["sweep_launches"] == 1
    assert g_sc["stopped_at_l"] == g_lw["stopped_at_l"] == [L, 1]
    assert g_sc["macs"] == g_lw["macs"]
    _assert_bits_equal(p_lw, p_sc)
    for a, b in zip(st_lw, st_sc):
        _assert_stats_equal(a, b)
    # the halted set edited the head only, and paid for it alone
    assert list(st_sc[1]["selected_per_layer"]) == [1]
    assert st_sc[1]["macs"] < st_sc[0]["macs"]


def test_single_set_group_equals_forget(m):
    for mode in ("layerwise", "scanned"):
        cfg = _cfg(tcau, tau=0.3, checkpoint_every=1, balanced=True,
                   use_kernel=True, sweep_mode=mode)
        p_g, st_g, g = _port(m, cfg, [(m["x"][:16], m["y"][:16])])
        p_f, st_f = _port(m, cfg)
        assert g["engine"]["sweep_mode"] == st_f["engine"]["sweep_mode"] \
            == mode
        _assert_bits_equal(p_g, p_f)
        _assert_stats_equal(st_g[0], st_f)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------
def _noise(path):
    """``attn/bk``: its gradient is zero in exact arithmetic (the softmax
    cancels a key bias), so its Fisher is rounding noise on both sides."""
    return path.endswith("attn/bk")


def _assert_params_close(m, tp, jp, int8=False, orig=None):
    orig = bridge.paths(jax.tree_util.tree_map(
        np.asarray, m["jparams"] if orig is None else orig))
    want = bridge.paths(jax.tree_util.tree_map(np.asarray, jp))
    got = bridge.paths(bridge.params_to_numpy(tp))
    agree = total = ok = n_ok = 0
    for k in want:
        if _noise(k):
            np.testing.assert_array_less(np.abs(got[k] - want[k]),
                                         np.abs(orig[k]) + 1e-30, err_msg=k)
            continue
        if int8:
            same = got[k] == want[k]   # codes on one grid: equal or not
        else:
            same = (want[k] != orig[k]) == (got[k] != orig[k])
        agree += int(same.sum())
        total += same.size
        if int8:
            continue
        g, w = got[k][same], want[k][same]
        np.testing.assert_allclose(g, w, rtol=1e-2, atol=1e-6, err_msg=k)
        ok += int((np.abs(g - w) <= 1e-6 + 1e-4 * np.abs(w)).sum())
        n_ok += w.size
    assert agree >= 0.999 * total, (agree, total)
    assert ok >= 0.995 * n_ok, (ok, n_ok)


def _assert_stats_close(m, st_t, st_j):
    for k in STAT_KEYS:
        if k != "selected_per_layer":
            assert st_t[k] == st_j[k], (k, st_t[k], st_j[k])
    assert sorted(st_t["selected_per_layer"]) == \
        sorted(st_j["selected_per_layer"])
    for l, n_j in st_j["selected_per_layer"].items():
        n_prm = sum(t.numel() for t in tree_leaves(
            m["tadapter"].get_layer(m["tparams"], L - l)))
        assert abs(st_t["selected_per_layer"][l] - n_j) <= 1e-3 * n_prm, l


@pytest.mark.parametrize("case", ["ficabu-nohalt-ce2", "int8-ssd"])
def test_scanned_forget_matches_reference(m, case):
    kw = SINGLE[case]
    sess = UnlearnSession(m["tadapter"], m["tI"])
    jsess = JSession(m["jadapter"], m["jI"])
    tp, tst = _port(m, _cfg(tcau, use_kernel=True, sweep_mode="scanned",
                            **kw), session=sess)
    jp, jst = jsess.forget(m["jparams"], m["x"][:16], m["y"][:16],
                           _cfg(jcau, sweep_mode="scanned", **kw))
    assert tst["engine"] == jst["engine"]
    _assert_stats_close(m, tst, jst)
    _assert_params_close(m, tp, jp, int8=case.startswith("int8"))
    for k in ("sweep_compiles", "sweep_hits", "sweep_launches",
              "int8_sweep_compiles", "int8_sweep_hits",
              "int8_sweep_launches", "quant_compiles", "quant_hits",
              "fused_compiles", "partial_compiles", "requests"):
        assert sess.stats[k] == jsess.stats[k], k


def test_scanned_group_matches_reference_per_set(m):
    tcfg = tcau.UnlearnConfig(use_kernel=True, sweep_mode="scanned", **GROUP)
    jcfg = jcau.UnlearnConfig(sweep_mode="scanned", **GROUP)
    tp, tst, tg = _port(m, tcfg, m["group"])
    jp, jst, jg = JSession(m["jadapter"], m["jI"]).forget_many(
        m["jparams"], m["group"], jcfg)
    assert tg["engine"] == jg["engine"]
    assert tg["stopped_at_l"] == jg["stopped_at_l"] == [L, 1]
    assert tg["macs"] == jg["macs"]
    for a, b in zip(tst, jst):
        _assert_stats_close(m, a, b)
    _assert_params_close(m, tp, jp)


def test_reference_snapshot_matches_reference_layerwise(m):
    """``forget_many(reference=snapshot)`` after an earlier edit, held
    against the reference's LAYERWISE drain (its scanned snapshot path is a
    Queue 3 caveat); the port's scanned and layerwise runs agree bit for
    bit. The earlier edit comes from the reference and is bridged, so both
    sides start from one tree."""
    first = _cfg(jcau, tau=-1.0, checkpoint_every=1)
    jp1, _, _ = JSession(m["jadapter"], m["jI"]).forget_many(
        m["jparams"], [(m["x"][32:48], m["y"][32:48])], first)
    tp1 = bridge.params_to_torch(jax.tree_util.tree_map(np.asarray, jp1),
                                 device="cpu")
    assert any(not torch.equal(a, b) for a, b in zip(
        tree_leaves(tp1), tree_leaves(m["tparams"])))
    setB = [(m["x"][16:32], m["y"][16:32])]
    kw = dict(tau=0.02, checkpoint_every=1, balanced=True)
    jp, jst, jg = JSession(m["jadapter"], m["jI"]).forget_many(
        jp1, setB, _cfg(jcau, **kw), reference=m["jparams"])
    runs = {}
    for mode in ("layerwise", "scanned"):
        runs[mode] = _port(m, _cfg(tcau, use_kernel=True, sweep_mode=mode,
                                   **kw), setB,
                           reference=(tp1, m["tparams"]))
        assert runs[mode][2]["engine"]["sweep_mode"] == mode
    _assert_bits_equal(runs["layerwise"][0], runs["scanned"][0])
    _assert_stats_equal(runs["layerwise"][1][0], runs["scanned"][1][0])
    assert runs["scanned"][2]["stopped_at_l"] == jg["stopped_at_l"]
    _assert_stats_close(m, runs["scanned"][1][0], jst[0])
    _assert_params_close(m, runs["scanned"][0], jp, orig=jp1)


# ---------------------------------------------------------------------------
# the program cache: one build, no warm rebuild
# ---------------------------------------------------------------------------
def test_sweep_family_no_warm_rebuild(m):
    x, y = _t([(m["x"][:16], m["y"][:16])])[0]
    cfg = _cfg(tcau, tau=-1.0, checkpoint_every=2, balanced=True,
               use_kernel=True, sweep_mode="scanned")
    unl = Unlearner(m["tadapter"], m["tI"],
                    UnlearnSpec.for_mode("ficabu", alpha=2.0, tau=-1.0,
                                         checkpoint_every=2, chunk_size=8,
                                         use_kernel=True,
                                         sweep_mode="scanned"),
                    device="cpu")
    TRACE_LOG.clear()
    p1, s1 = unl.forget((x, y), params=m["tparams"], cfg=cfg)
    assert s1["engine"]["compiles"] == 1
    assert TRACE_LOG == ["sweep:K1"]
    assert (unl.stats["sweep_compiles"], unl.stats["sweep_hits"],
            unl.stats["sweep_launches"]) == (1, 0, 1)
    TRACE_LOG.clear()
    p2, s2 = unl.forget((x, y), params=m["tparams"], cfg=cfg)
    assert (s2["engine"]["compiles"], s2["engine"]["cache_hits"]) == (0, 1)
    assert (unl.stats["sweep_compiles"], unl.stats["sweep_hits"]) == (1, 1)
    _assert_bits_equal(p1, p2)
    # (alpha, lam, tau, b_r) are operands: no rebuild
    for change in (dict(alpha=9.0), dict(lam=0.7), dict(tau=0.4),
                   dict(b_r=5.0)):
        _, s = unl.forget((x, y), params=m["tparams"],
                          cfg=dataclasses.replace(cfg, **change))
        assert s["engine"]["compiles"] == 0, change
    # a refreshed Fisher (same structure, new values) reuses it too, and
    # the result follows the new values
    unl.set_fisher(tree_map(lambda t: t * 1.5, m["tI"]))
    p3, s3 = unl.forget((x, y), params=m["tparams"], cfg=cfg)
    assert s3["engine"]["compiles"] == 0
    assert TRACE_LOG == [], TRACE_LOG
    assert unl.stats["sweep_launches"] == 7
    want, _ = UnlearnSession(m["tadapter"], unl.fisher_global).forget(
        m["tparams"], x, y, dataclasses.replace(cfg, sweep_mode="layerwise"))
    _assert_bits_equal(p3, want)
    TRACE_LOG.clear()
    # the int8 family counts apart, fp32's counters untouched
    cfg8 = dataclasses.replace(cfg, precision="int8")
    for _ in range(2):
        _, s8 = unl.forget((x, y), params=m["tparams"], cfg=cfg8)
    assert s8["engine"]["precision"] == "int8"
    assert (unl.stats["int8_sweep_compiles"], unl.stats["int8_sweep_hits"],
            unl.stats["int8_sweep_launches"]) == (1, 1, 2)
    assert (unl.stats["sweep_compiles"], unl.stats["sweep_launches"]) == \
        (1, 9)
    assert TRACE_LOG == ["sweep8:K1", "quant"], TRACE_LOG
    # a K = 2 drain is its own program; its repeat builds nothing
    TRACE_LOG.clear()
    for _ in range(2):
        _, _, g = unl.forget_group(m["group"], params=m["tparams"])
    assert (g["engine"]["compiles"], g["engine"]["cache_hits"],
            g["engine"]["sweep_launches"]) == (0, 1, 1)
    assert TRACE_LOG == ["sweep:K2"], TRACE_LOG
    TRACE_LOG.clear()


def test_program_cache_matches_reference_and_is_shared(m):
    """The cache's bookkeeping (builds, hits, sessions, plans, eviction)
    and its events equal the reference cache's on one sequence of
    lookups; two sessions on one cache build each step once."""
    seq = [(("ns", 6, False), "fused", 1), (("ns", 6, False), "fused", 1),
           (("ns", 6, False), ("sweep", "fp32"), 2), ("flat", "quant", 3),
           (("ns", 6, False), ("sweep", "fp32"), 2)]
    streams, stats = {}, {}
    for side, cls, tel in (("t", ProgramCache, ttel),
                           ("j", JProgramCache, jtel)):
        cache = cls()
        cache.sessions += 2
        with tel.capture() as t:
            for ns, kind, v in seq:
                key = (ns, kind, v)
                prog, built = cache.get_or_build(key, lambda v=v: v)
                assert prog == v
            plans = [cache.plan_or_build(("p",), lambda: None),
                     cache.plan_or_build(("p",), lambda: 1 / 0)]
        assert plans == [None, None]
        n = len(cache)
        dead = cache.evict_where(lambda k: k[1] == "fused")
        stats[side] = (cache.stats(), n, dead, sorted(map(repr,
                                                          cache.keys())))
        streams[side] = tel.canonical_events(t.events)
    assert stats["t"] == stats["j"]
    assert stats["t"][0] == {"programs": 2, "compiles": 3, "hits": 2,
                             "sessions": 2}
    assert streams["t"] == streams["j"]
    # two sessions, one cache: the second session's request builds nothing
    cache = ProgramCache()
    cfg = _cfg(tcau, tau=-1.0, checkpoint_every=2, use_kernel=True,
               sweep_mode="scanned")
    first = UnlearnSession(m["tadapter"], m["tI"], programs=cache)
    second = UnlearnSession(m["tadapter"], m["tI"], programs=cache)
    p1, s1 = _port(m, cfg, session=first)
    p2, s2 = _port(m, cfg, session=second)
    assert cache.sessions == 2
    assert (s1["engine"]["compiles"], s2["engine"]["compiles"]) == (1, 0)
    assert second.stats["sweep_hits"] == 1
    _assert_bits_equal(p1, p2)


# ---------------------------------------------------------------------------
# specs and the deprecated shims
# ---------------------------------------------------------------------------
def test_execspec_sweep_mode_round_trip():
    spec = UnlearnSpec.for_mode("ficabu", sweep_mode="scanned",
                                precision="int8")
    assert spec.exec.sweep_mode == "scanned"
    assert spec.to_config().sweep_mode == "scanned"
    assert UnlearnSpec().to_config().sweep_mode == "layerwise"
    back = UnlearnSpec.from_json(spec.to_json())
    assert back == spec and back.exec.sweep_mode == "scanned"
    assert ExecSpec(sweep_mode="scanned") == \
        UnlearnSpec.from_dict({"exec": {"sweep_mode": "scanned"}}).exec
    with pytest.raises(ValueError, match="sweep_mode"):
        ExecSpec(sweep_mode="fused")
    with pytest.raises(ValueError, match="sweep_mode"):
        tcau.UnlearnConfig(sweep_mode="Scanned")


def test_ficabu_shims_warn_and_equal_the_facade(m):
    kw = dict(mode="ficabu", alpha=2.0, lam=1.0, tau=0.3,
              checkpoint_every=1, b_r=5.0, chunk_size=8, use_kernel=True)
    spec = UnlearnSpec.for_mode(**kw)
    x, y = _t([(m["x"][:16], m["y"][:16])])[0]
    with pytest.warns(DeprecationWarning, match="Unlearner.forget"):
        p_s, st_s = tficabu.unlearn(m["tadapter"], m["tparams"], m["tI"],
                                    x, y, **kw)
    p_f, st_f = Unlearner(m["tadapter"], m["tI"], spec, device="cpu").forget(
        ForgetRequest(x, y), params=m["tparams"])
    _assert_bits_equal(p_s, p_f)
    _assert_stats_equal(st_s, st_f)
    with pytest.warns(DeprecationWarning, match="Unlearner.forget_group"):
        p_g, st_g, g_s = tficabu.unlearn_group(
            m["tadapter"], m["tparams"], m["tI"], m["group"], **kw)
    p_h, st_h, g_f = Unlearner(m["tadapter"], m["tI"], spec,
                               device="cpu").forget_group(
        m["group"], params=m["tparams"])
    _assert_bits_equal(p_g, p_h)
    assert g_s == g_f
    with pytest.warns(DeprecationWarning, match="to_config"):
        got = tficabu._mode_config("bd", 3.0, 0.5, 0.2, 3, 4.0, None, 8,
                                   True)
    assert got == UnlearnSpec.for_mode(
        "bd", alpha=3.0, lam=0.5, tau=0.2, checkpoint_every=3, b_r=4.0,
        chunk_size=8, use_kernel=True).to_config()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = jficabu._mode_config("bd", 3.0, 0.5, 0.2, 3, 4.0, None, 8,
                                    True)
    for f in ("alpha", "lam", "tau", "checkpoint_every", "balanced", "b_r",
              "chunk_size", "use_kernel", "sweep_mode", "precision"):
        assert getattr(got, f) == getattr(want, f), f


def test_auto_midpoint_equals_reference(m):
    _, st = _port(m, _cfg(tcau, tau=-1.0, checkpoint_every=0,
                          use_kernel=True))
    assert tficabu.auto_midpoint(st) == jficabu.auto_midpoint(st)
    rng = np.random.default_rng(1)
    for _ in range(5):
        sel = {l: int(n) for l, n in enumerate(rng.integers(0, 999, 14), 1)}
        st = {"selected_per_layer": sel}
        assert tficabu.auto_midpoint(st) == jficabu.auto_midpoint(st)
    for bad in ({}, [1, 2], {"stopped_at_l": 3}):
        with pytest.raises(ValueError) as got:
            tficabu.auto_midpoint(bad)
        with pytest.raises(ValueError) as want:
            jficabu.auto_midpoint(bad)
        assert str(got.value) == str(want.value)
