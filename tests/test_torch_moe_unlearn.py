"""The MoE slice end to end: forget requests through the port's
``Unlearner`` against the JAX package's, on llama4-scout-smoke (two "attn"
blocks in ``period_stack``, each FFN a mixture of 4 experts, top-1, with a
shared expert; d_model 64, 4 heads over 2 KV heads of 16, d_ff 64, vocab
256, untied: 4 unlearn layers). ``test_torch_moe_unlearn_kimi.py`` runs
every per-model test of this file (``__all__``) again on kimi-k2-smoke (8
experts, top-2, a shared expert), so that the two models' reference runs
land on two test workers. The FULL-structure tests run here only.

The model, the data and the settings are those of
``test_torch_dense_unlearn.py`` (its ``_setting`` and ``_serve``: the
reference's own initialisation, bridged; requests of 8 sequences of 16
tokens at chunk 4, so each vjp chunk dispatches 64 tokens at capacity 24
and the collection 128 at capacity 40; the global Fisher from ``lm_loss``
with its default aux weight 0.01), and so are its declared tolerances;
every per-model test of that file (its ``__all__``) runs here on the MoE
model. This file adds what the MoE brings:

  * the router's global Fisher against the reference's, at aux weight 0.01
    and 0 (at 0 a top-1 router's gradient is rounding noise on both sides:
    the renormalised gate is exactly 1 in exact arithmetic; its entries
    are held at atol 1e-12 there, nine orders below the aux-weighted
    ones);
  * every router of every request's result (fp32 and int8, layerwise,
    scanned and drained) bit-identical to the caller's: ``lm_adapter``
    excludes them from the edit, as the reference does (in int8, the
    caller's pre-edit codes: every leaf of an int8 result lies on its q8
    grid);
  * the routing decisions (expert ids, and whether each choice was kept
    within capacity) of every block on the request's collection and on
    each vjp chunk equal the reference's;
  * the FULL structure of llama4-scout and kimi-k2 from ``jax.eval_shape``
    (llama4-scout at 1 block: 4,271,078,400 parameters, as
    ``chip_smoke.py``'s ``[moe]`` phase builds it), and the bridge's round
    trip of the stacked [n_periods, E, d, f] expert leaves.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_dense_unlearn import *  # noqa: F401,F403,E402
from test_torch_dense_unlearn import __all__ as _dense_tests  # noqa: E402
from test_torch_dense_unlearn import _serve  # noqa: E402
from test_torch_recurrent_unlearn import (  # noqa: E402
    CASES, _assert_bulk_close, _jax_tree, _np_tree, _spec)
from test_torch_moe import _routes_jax, _routes_torch  # noqa: E402
from test_torch_recurrent_unlearn import _setting as _rec_setting  # noqa: E402

from repro.configs import kimi_k2_1t_a32b as jkimi  # noqa: E402
from repro.configs import llama4_scout_17b_a16e as jscout  # noqa: E402
from repro.core import adapters as jadapters  # noqa: E402
from repro.core import fisher as jfisher  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.api import ForgetRequest, UnlearnSpec  # noqa: E402
from repro_torch.core import adapters as tadapters  # noqa: E402
from repro_torch.core import fisher as tfisher  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.optim.compression import q8_fakequant_tree  # noqa: E402

torch.set_num_threads(2)
ARCHS = {"llama4-scout-17b-a16e": jscout, "kimi-k2-1t-a32b": jkimi}
# the per-model tests, which the kimi file runs again on its model
__all__ = list(_dense_tests) + [
    "test_router_fisher_matches_jax_with_and_without_aux",
    "test_routers_come_back_bit_identical",
    "test_routing_decisions_equal_jax"]


def _setting(arch):
    """The MoE model's setting (``test_torch_recurrent_unlearn._setting``
    over this file's archs)."""
    return _rec_setting(arch, archs=ARCHS)


@pytest.fixture(scope="module")
def served():
    s = _setting("llama4-scout-17b-a16e")
    return s, _serve(s)


def _routers(tree):
    return {k: v for k, v in bridge.paths(tree).items() if "router" in k}


# -- the MoE's own checks ------------------------------------------------------
def test_router_fisher_matches_jax_with_and_without_aux(served):
    """The routers' global Fisher at aux weight 0.01 (the setting's) and 0:
    with the aux loss at the common tolerance; without it, on the top-1
    model, rounding noise on both sides, held at atol 1e-12 (on the top-2
    model a real gradient, at the common tolerance)."""
    s, _ = served
    want = _routers(s["jI"])
    got = {k: v.numpy() for k, v in _routers(s["tI"]).items()}
    assert sorted(got) == sorted(want) == ["period_stack/0/ffn/router"]
    _assert_bulk_close(got, {k: np.asarray(v) for k, v in want.items()},
                       rtol=1e-4, atol=1e-12, bulk=0.999, rtol_all=2e-3,
                       atol_all=1e-9)
    assert min(float(v.max()) for v in got.values()) > 1e-9
    retain = s["retain"]
    jcfg, tcfg = s["jcfg"], s["tcfg"]
    j0 = _routers(jfisher.diag_fisher(
        lambda p, b: JLM.lm_loss(p, jcfg, b[0], b[1], aux_weight=0.0),
        s["params"], retain, chunk_size=4))
    t0 = _routers(tfisher.diag_fisher(
        lambda p, b: TLM.lm_loss(p, tcfg, b[0], b[1], aux_weight=0.0),
        s["tparams"], retain, chunk_size=4, device="cpu"))
    for k in j0:
        w, g = np.asarray(j0[k]), t0[k].numpy()
        if tcfg.moe.top_k == 1:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12, err_msg=k)
            assert w.max() < 1e-9 * got[k].max(), (w.max(), got[k].max())
        else:
            _assert_bulk_close({k: g}, {k: w}, rtol=1e-4, atol=1e-12,
                               bulk=0.999, rtol_all=2e-3, atol_all=1e-9)


def test_routers_come_back_bit_identical(served):
    """Every request's result (every case), a scanned request and a
    scanned K = 2 drain, fp32 and int8: each router the caller's, bit for
    bit. An int8 result holds every leaf on its q8 grid, so there each
    router is the caller's pre-edit codes: a swept block's router the
    fake quantisation of its own layer leaf (per row), a block a halted
    request never reached the whole tree's (one scale per period), as the
    reference leaves them."""
    s, res = served
    ad = s["tadapter"]
    L = ad.n_layers
    fx, fy = s["sets"][0]
    _, tunl = res["facades"]
    whole = q8_fakequant_tree(s["tparams"])

    def want(j, int8, swept):
        if not int8:
            return ad.get_layer(s["tparams"], j)["ffn"]["router"]
        if swept:
            return q8_fakequant_tree(ad.get_layer(s["tparams"], j))["ffn"][
                "router"]
        return ad.get_layer(whole, j)["ffn"]["router"]

    results = [(res[case]["t"][0], "int8" in case,
                res[case]["t"][1]["stopped_at_l"]) for case in CASES]
    for case in ("ssd", "ssd-int8"):
        mode, kw = CASES[case][0], res[case]["kw"]
        scan = tunl.with_spec(_spec(UnlearnSpec, mode, sweep_mode="scanned",
                                    **kw))
        p, st = scan.forget(ForgetRequest(fx, fy), params=s["tparams"])
        assert st["engine"]["sweep_mode"] == "scanned"
        results.append((p, "int8" in case, st["stopped_at_l"]))
        p, sts, g = scan.forget_group(
            [ForgetRequest(*st) for st in s["sets"]], params=s["tparams"])
        assert g["engine"]["sweep_mode"] == "scanned"
        results.append((p, "int8" in case, min(st["stopped_at_l"]
                                               for st in sts)))
    n_int8 = 0
    for p, int8, stopped in results:
        assert len(_routers(p)) == 1
        for j in range(1, L - 1):
            got = ad.get_layer(p, j)["ffn"]["router"]
            ref = want(j, int8, L - j <= stopped)
            assert got.dtype == torch.float32 and torch.equal(
                got.view(torch.int32), ref.view(torch.int32)), (j, int8)
        n_int8 += int8
    assert n_int8 == 4 and len(results) == len(CASES) + 4


def test_routing_decisions_equal_jax(served):
    """Every block's routing on the forget request's collection (all 8
    sequences: 128 tokens) and on each vjp chunk (4 sequences: 64 tokens)
    equals the reference's: the same experts, the same choices kept within
    capacity (none differs). The block inputs are each side's own
    collected activations; some choices overflow, as the capacity is
    sized."""
    s, _ = served
    fx = s["sets"][0][0]
    jcfg, tcfg = s["jcfg"], s["tcfg"]
    _, jacts = s["jadapter"].forward_collect(s["params"], jnp.asarray(fx))
    _, tacts = s["tadapter"].forward_collect(s["tparams"],
                                             torch.from_numpy(fx))
    dropped = 0
    for j in range(1, tcfg.n_layers + 1):
        jblk = s["jadapter"].get_layer(s["params"], j)
        tblk = s["tadapter"].get_layer(s["tparams"], j)
        jh = JL.rmsnorm(jblk["ln1"], jacts[j])
        jx = jacts[j] + JL.attention(jblk["mixer"], jcfg.attn_cfg("attn"), jh,
                                     jnp.broadcast_to(
                                         jnp.arange(fx.shape[1])[None],
                                         fx.shape))
        jx = JL.rmsnorm(jblk["ln2"], jx)
        th = TL.rmsnorm(tblk["ln1"], tacts[j])
        tx = tacts[j] + TL.attention(tblk["mixer"], tcfg.attn_cfg("attn"), th,
                                     TLM._positions(tacts[j]))
        tx = TL.rmsnorm(tblk["ln2"], tx)
        for lo, hi in ((0, 8), (0, 4), (4, 8)):
            D = tx.shape[-1]
            je, jk = _routes_jax(jblk["ffn"], jcfg.moe_cfg(),
                                 jx[lo:hi].reshape(1, -1, D))
            te, tk = _routes_torch(tblk["ffn"], tcfg.moe_cfg(),
                                   tx[lo:hi].reshape(1, -1, D))
            assert int((je != te).sum()) == 0 and int((jk != tk).sum()) == 0, \
                (j, lo, hi)
            dropped += int((~tk).sum())
    assert dropped > 0


# -- FULL structure (this file only) -------------------------------------------
# (blocks, stored leaves, parameters, unlearn layers) of the reference's FULL
# trees: every block, and the one block of chip_smoke.py's [moe] phase
FULL_SIZES = {
    ("llama4-scout-17b-a16e", 48): (16, 107_769_861_120, 50),
    ("llama4-scout-17b-a16e", 1): (16, 4_271_078_400, 3),
    ("kimi-k2-1t-a32b", 61): (16, 1_044_860_859_392, 63),
}


@pytest.mark.parametrize("arch,blocks", FULL_SIZES)
def test_full_structure_matches_reference(arch, blocks):
    """The FULL config's tree (at ``blocks`` blocks) from ``jax.eval_shape``
    (no weights): its leaves, parameters and unlearn layers; the port's
    adapter over a tree of those shapes on ``meta`` sees the reference's
    layer keys, leaves and shapes, the router f32 beside bf16 experts
    stacked [n_periods, E, d, f], the MoE MACs and the router exclusion."""
    jcfg = ARCHS[arch].FULL.with_(n_layers=blocks)
    tcfg = tconfigs.get(arch).full.with_(n_layers=blocks)
    jshapes = jax.eval_shape(lambda: JLM.init_lm(jax.random.PRNGKey(0),
                                                 jcfg))
    sizes = [int(np.prod(x.shape)) for x in
             jax.tree_util.tree_leaves(jshapes)]
    n_leaves, n_params, n_layers = FULL_SIZES[(arch, blocks)]
    assert (len(sizes), sum(sizes)) == (n_leaves, n_params)
    tree = jax.tree_util.tree_map(
        lambda x: torch.empty(x.shape, dtype=getattr(torch, x.dtype.name),
                              device="meta"), jshapes)
    ta = tadapters.lm_adapter(tcfg, 1024, device="cpu")
    ja = jadapters.lm_adapter(jcfg, 1024)
    assert ta.n_layers == ja.n_layers == n_layers
    assert list(ta.layer_fwd_macs) == list(ja.layer_fwd_macs)
    assert [ta.layer_key(j) for j in range(n_layers)] == \
        [ja.layer_key(j) for j in range(n_layers)]
    for j in range(n_layers):
        got = bridge.paths(ta.get_layer(tree, j))
        want = bridge.paths(jax.eval_shape(
            lambda p, j=j: ja.get_layer(p, j), jshapes))
        assert sorted(got) == sorted(want), j
        for k, x in want.items():
            assert tuple(got[k].shape) == tuple(x.shape), (j, k)
            assert got[k].dtype == getattr(torch, x.dtype.name), (j, k)
            assert ta.exclude(k) == ja.exclude(k) == ("router" in k), k
    stack = bridge.paths(tree)
    E, D, F = jcfg.moe.num_experts, jcfg.d_model, jcfg.d_ff
    assert tuple(stack["period_stack/0/ffn/w_gate"].shape) == \
        (blocks, E, D, F)
    assert stack["period_stack/0/ffn/router"].dtype == torch.float32
    assert stack["period_stack/0/ffn/w_down"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_tree_and_bridge_match_reference(arch):
    """The port's SMOKE init equals the reference's tree path by path in
    shape and dtype; the reference's tree, in bf16 with the f32 router,
    crosses the bridge bit for bit (the 4-D expert stacks under
    ``period_stack`` keep the reference's layout), and the f32 tree runs
    the port's forward to the reference's logits and aux loss."""
    jcfg, tcfg = ARCHS[arch].SMOKE, tconfigs.get(arch).smoke
    tp = TLM.init_lm(torch.Generator().manual_seed(0), tcfg, device="cpu")
    want = bridge.paths(jax.eval_shape(lambda: JLM.init_lm(
        jax.random.PRNGKey(0), jcfg)))
    got = bridge.paths(tp)
    assert sorted(got) == sorted(want)
    for k, x in want.items():
        assert tuple(got[k].shape) == tuple(x.shape), k
        assert got[k].dtype == getattr(torch, x.dtype.name), k
    jb = jcfg.with_(param_dtype="bfloat16")
    params = JLM.init_lm(jax.random.PRNGKey(0), jb)
    ref = _jax_tree(params)
    bridged = bridge.paths(bridge.params_to_torch(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    assert sorted(bridged) == sorted(ref)
    for k, x in ref.items():
        t = bridged[k]
        assert tuple(t.shape) == x.shape and t.is_contiguous(), k
        bits = torch.int32 if t.dtype == torch.float32 else torch.int16
        np.testing.assert_array_equal(
            t.view(bits).numpy(),
            np.asarray(x).view(np.int32 if bits == torch.int32
                               else np.int16), err_msg=k)
    assert ref["period_stack/0/ffn/w_up"].ndim == 4
    assert bridged["period_stack/0/ffn/router"].dtype == torch.float32
    assert bridged["period_stack/0/ffn/w_up"].dtype == torch.bfloat16
    params = JLM.init_lm(jax.random.PRNGKey(0), jcfg)
    tok = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 12)).astype(
        np.int32)
    jlog, jaux = JLM.forward(params, jcfg, jnp.asarray(tok))
    tlog, taux = TLM.forward(bridge.params_to_torch(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"), tcfg,
        torch.from_numpy(tok))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-5,
                               atol=2e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
