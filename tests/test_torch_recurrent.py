"""The port's recurrent blocks (``repro_torch.models.recurrent``: mLSTM,
sLSTM, RG-LRU) and the two LMs built from them, against
``repro.models.recurrent`` / ``repro.models.lm`` on the same weights, on
the CPU.

The models are the registry's SMOKE configs: xlstm-125m-smoke (one period
of mlstm x3 + slstm, d_model 64, 2 heads of 32, mLSTM chunk 8, no FFN,
untied head) and recurrentgemma-9b-smoke (two (rglru, rglru, local)
periods and a two-layer rglru tail, d_model 64, d_rnn 88, d_ff 160,
window 16). Weights are drawn with numpy in the reference's shapes (norm
scales away from 1, biases away from 0) and carried over by
``repro_torch.bridge``; token ids and activations come from a numpy seed,
13 tokens (not a multiple of the mLSTM chunk, so its padding runs) or 16.
Tolerances, per tensor (both sides compute in f32, the products, sums and
scans in another order):

  * each block's forward (mLSTM, sLSTM, RG-LRU) and the log-depth scan
    against a sequential loop: rtol 1e-5 / atol 1e-5; the RG-LRU scan's
    combine order differs from ``jax.lax.associative_scan``'s and the
    sLSTM adds its gate biases before the recurrent term (the reference
    after), both within that;
  * each block's vjp (parameters and input) under a random N(0, 1)
    cotangent: rtol 1e-4 / atol 1e-5 (its gradients reach 3 in size);
  * ``forward``'s logits, the adapter's collected activations and
    ``lm_loss``: rtol 1e-5 / atol 2e-5; the ``lm_loss`` gradients: rtol
    1e-4 / atol 1e-5 on every leaf (the recurrences carry the products'
    rounding through the sequence: up to 6e-6 on the embedding's);
  * a bf16 forward (the FULL configs' dtype; ``log_lambda`` stays f32),
    against the reference evaluated op by op (``jax.disable_jit``), which
    rounds every op to bf16 as the port does: the logits within atol 5e-2
    (a bf16 step of the residual stream, flipped once in an RG-LRU layer,
    carried through the later layers) and the argmax equal on at least 99%
    of the positions; against the compiled reference, whose fusions keep
    chains of bf16 ops (the causal conv's taps, ``h * gb``, the casts) in
    f32: within 0.1 x max|logit| and the argmax equal on at least 95%.

Exact: the MAC tables (``_lm_block_macs``'s recurrent terms), the tree
structure and dtypes of ``init_lm``, the layer views, the registry's
configs, the structure at full width (xlstm-125m FULL 109,192,008
parameters; recurrentgemma-9b at the card's n_layers = 5, 3,395,363,392,
counted with ``jax.eval_shape``), the bridge round trip of the stacked
4-D sLSTM recurrent weights, and the int8 codes and scale tables of the
xlstm tree and of its stacked ``rz`` (``lead_axes`` 1 and 2), which keep
the reference's grouping.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import recurrentgemma_9b as jrg  # noqa: E402
from repro.configs import xlstm_125m as jxl  # noqa: E402
from repro.core import adapters as jadapters  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import adapters as tadapters  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import recurrent as TR  # noqa: E402
from repro_torch.models.module import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402

torch.set_num_threads(2)
ARCHS = {"xlstm-125m": jxl, "recurrentgemma-9b": jrg}
TOL = dict(rtol=1e-5, atol=1e-5)
TOL_FWD = dict(rtol=1e-5, atol=2e-5)
TOL_GRAD = dict(rtol=1e-4, atol=1e-5)
TOL_VJP = dict(rtol=1e-4, atol=1e-5)


def _cfgs(arch, **kw):
    return (ARCHS[arch].SMOKE.with_(**kw),
            tconfigs.get(arch).smoke.with_(**kw))


def _draw(rng):
    def draw(path, s):
        name = str(path[-1].key)
        if name in ("scale", "bi", "bf", "bz", "bo", "conv_b"):
            return (float(name == "scale") + 0.1 * rng.normal(size=s.shape)
                    ).astype(np.float32)
        if name == "log_lambda":      # softplus^-1 of lambda in (0.3, 0.8)
            lam = rng.uniform(0.3, 0.8, size=s.shape)
            return np.log(np.expm1(lam)).astype(np.float32)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else 1
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(
            np.float32)
    return draw


def _weights(arch, seed=5):
    jc, _ = _cfgs(arch)
    shapes = jax.eval_shape(lambda: JLM.init_lm(jax.random.PRNGKey(0), jc))
    tree = jax.tree_util.tree_map_with_path(
        _draw(np.random.default_rng(seed)), shapes)
    return (jax.tree_util.tree_map(jnp.asarray, tree), tree,
            bridge.params_to_torch(tree, device="cpu"))


@pytest.fixture(scope="module")
def xlstm():
    """(JAX tree, numpy tree, port tree) of xlstm-125m-smoke."""
    return _weights("xlstm-125m")


@pytest.fixture(scope="module")
def griffin():
    """(JAX tree, numpy tree, port tree) of recurrentgemma-9b-smoke."""
    return _weights("recurrentgemma-9b", seed=6)


def _weights_of(arch, xlstm, griffin):
    return xlstm if arch == "xlstm-125m" else griffin


def _jtree(t):
    return bridge.paths(jax.tree_util.tree_map(np.asarray, t))


def _acts(S, n=3, seed=1, d=64):
    return np.random.default_rng(seed).normal(size=(n, S, d)).astype(
        np.float32)


def _tokens(S, n=3, seed=2):
    return np.random.default_rng(seed).integers(0, 256, (n, S)).astype(
        np.int32)


# (arch, depth j of a block of that kind, the kind's config method, the
# reference's forward, the port's)
BLOCKS = {
    "mlstm": ("xlstm-125m", 1, "mlstm_cfg", JR.mlstm_forward,
              TR.mlstm_forward),
    "slstm": ("xlstm-125m", 4, "slstm_cfg", JR.slstm_forward,
              TR.slstm_forward),
    "rglru": ("recurrentgemma-9b", 8, "rglru_cfg", JR.rglru_forward,
              TR.rglru_forward),
}


def _mixer(block, xlstm, griffin):
    arch, j, cfg_fn, jfwd, tfwd = BLOCKS[block]
    jp, _, tp = _weights_of(arch, xlstm, griffin)
    jc, tc = _cfgs(arch)
    assert tc.layer_types[j - 1] == block
    jm = JLM.get_layer(jp, jc, j)["mixer"]
    tm = TLM.get_layer(tp, tc, j)["mixer"]
    return (jm, getattr(jc, cfg_fn)(), jfwd), (tm, getattr(tc, cfg_fn)(),
                                              tfwd)


@pytest.mark.parametrize("S", [13, 16])
@pytest.mark.parametrize("block", BLOCKS)
def test_block_forward_matches_jax(xlstm, griffin, block, S):
    (jm, jcfg, jfwd), (tm, tcfg, tfwd) = _mixer(block, xlstm, griffin)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    x = _acts(S, seed=S)
    want = jax.jit(lambda p, a: jfwd(p, jcfg, a))(jm, jnp.asarray(x))
    got = tfwd(tm, tcfg, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("block", BLOCKS)
def test_block_vjp_matches_jax(xlstm, griffin, block):
    """The vjp of each block under a random cotangent: every parameter's
    gradient and the input's."""
    (jm, jcfg, jfwd), (tm, tcfg, tfwd) = _mixer(block, xlstm, griffin)
    S = 13
    x, ct = _acts(S, seed=3), _acts(S, seed=4)
    jg_p, jg_x = jax.jit(lambda p, a, c: jax.vjp(
        lambda p, a: jfwd(p, jcfg, a), p, a)[1](c))(
            jm, jnp.asarray(x), jnp.asarray(ct))
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in bridge.paths(tm).items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tfwd(leaves, tcfg, xt)
    grads = torch.autograd.grad(out, [*leaves.values(), xt],
                                torch.from_numpy(ct))
    want = _jtree(jg_p)
    assert sorted(leaves) == sorted(want)
    for k, g in zip(leaves, grads[:-1]):
        np.testing.assert_allclose(g.numpy(), want[k], **TOL_VJP,
                                   err_msg=k)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jg_x),
                               **TOL_VJP)


def test_linear_scan_equals_the_sequential_recurrence():
    """The log-depth scan against h_t = a_t h_{t-1} + b_t step by step, at
    lengths that are and are not powers of two, and S = 1."""
    rng = np.random.default_rng(7)
    for S in (1, 2, 5, 16, 37):
        a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, S, 3)).astype(
            np.float32))
        b = torch.from_numpy(rng.normal(size=(2, S, 3)).astype(np.float32))
        h = torch.zeros(2, 3)
        want = []
        for t in range(S):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        torch.testing.assert_close(TR.linear_scan(a, b),
                                   torch.stack(want, 1), rtol=1e-6,
                                   atol=1e-6)


def test_causal_conv_is_the_references():
    """The depthwise causal conv, f32 and bf16 (taps summed in order, in
    the input's dtype)."""
    rng = np.random.default_rng(8)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    x = rng.normal(size=(2, 9, 6)).astype(np.float32)
    want = JR._causal_conv1d(jnp.asarray(w), jnp.asarray(b), jnp.asarray(x))
    got = TR._causal_conv1d(torch.from_numpy(w), torch.from_numpy(b),
                            torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = TR._causal_conv1d(torch.from_numpy(w), torch.from_numpy(b), xb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=2e-2, atol=3e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_collect_and_loss_match_jax(xlstm, griffin, arch):
    jp, _, tp = _weights_of(arch, xlstm, griffin)
    jc, tc = _cfgs(arch)
    S = 13
    tok = _tokens(S)
    jlog = jax.jit(lambda p, t: JLM.forward(p, jc, t)[0])(
        jp, jnp.asarray(tok))
    tlog, taux = TLM.forward(tp, tc, torch.from_numpy(tok))
    assert tlog.dtype == torch.float32 and float(taux) == 0.0
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL_FWD)
    ja = jadapters.lm_adapter(jc, S)
    ta = tadapters.lm_adapter(tc, S, device="cpu")
    jx, jacts = ja.forward_collect(jp, jnp.asarray(tok))
    tx, tacts = ta.forward_collect(tp, torch.from_numpy(tok))
    assert len(tacts) == len(jacts) == tc.n_layers + 2
    for j, (a, b) in enumerate(zip(jacts[1:], tacts[1:]), start=1):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL_FWD,
                                   err_msg=f"act {j}")
    np.testing.assert_array_equal(tx.numpy(), tlog.numpy())
    lbl = _tokens(S, seed=9)
    np.testing.assert_allclose(
        float(TLM.lm_loss(tp, tc, torch.from_numpy(tok),
                          torch.from_numpy(lbl))),
        float(jax.jit(lambda p, t, y: JLM.lm_loss(p, jc, t, y))(
            jp, jnp.asarray(tok), jnp.asarray(lbl))),
        **TOL_FWD)


def _rebuild(like, by_path, prefix=""):
    return {k: (_rebuild(v, by_path, f"{prefix}{k}/")
                if isinstance(v, dict) else by_path[f"{prefix}{k}"])
            for k, v in like.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_gradients_match_jax(xlstm, griffin, arch):
    jp, _, tp = _weights_of(arch, xlstm, griffin)
    jc, tc = _cfgs(arch)
    tok, lbl = _tokens(16, seed=10), _tokens(16, seed=11)
    jg = jax.jit(jax.grad(lambda p, t, y: JLM.lm_loss(p, jc, t, y)))(
        jp, jnp.asarray(tok), jnp.asarray(lbl))
    leaves = {k: t.clone().requires_grad_(True)
              for k, t in bridge.paths(tp).items()}
    loss = TLM.lm_loss(_rebuild(tp, leaves), tc, torch.from_numpy(tok),
                       torch.from_numpy(lbl))
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    want = _jtree(jg)
    assert sorted(grads) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(grads[k].numpy(), w, **TOL_GRAD,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_layer_views_match_reference(xlstm, griffin, arch):
    """init_lm's tree (paths, shapes, dtypes, in f32 and bf16: the RG-LRU's
    log_lambda stays f32), the layer views (a period's block or a tail
    block), set_layer leaving the caller's tree alone, and the layer keys."""
    jp, _, tp = _weights_of(arch, xlstm, griffin)
    jc, tc = _cfgs(arch)
    for dt in ("float32", "bfloat16"):
        want = bridge.paths(jax.eval_shape(lambda: JLM.init_lm(
            jax.random.PRNGKey(0), jc.with_(param_dtype=dt))))
        got = bridge.paths(TLM.init_lm(torch.Generator().manual_seed(0),
                                       tc.with_(param_dtype=dt),
                                       device="cpu"))
        assert sorted(got) == sorted(want)
        for k, s in want.items():
            assert tuple(got[k].shape) == tuple(s.shape), (dt, k)
            assert str(got[k].dtype).split(".")[-1] == str(s.dtype), (dt, k)
    L = TLM.n_unlearn_layers(tc)
    assert L == JLM.n_unlearn_layers(jc)
    ta = tadapters.lm_adapter(tc, 16, device="cpu")
    ja = jadapters.lm_adapter(jc, 16)
    assert [ta.layer_key(j) for j in range(L)] == \
        [ja.layer_key(j) for j in range(L)]
    before = {k: v.clone() for k, v in bridge.paths(tp).items()}
    for j in range(L):
        got = bridge.paths(TLM.get_layer(tp, tc, j))
        want = _jtree(JLM.get_layer(jp, jc, j))
        assert sorted(got) == sorted(want), j
        for k, w in want.items():
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=(j, k))
        new = TLM.set_layer(tp, tc, j, tree_map(lambda x: x * 2.0,
                                                TLM.get_layer(tp, tc, j)))
        jnew = _jtree(JLM.set_layer(jp, jc, j, jax.tree_util.tree_map(
            lambda x: x * 2.0, JLM.get_layer(jp, jc, j))))
        for k, w in jnew.items():
            np.testing.assert_array_equal(bridge.paths(new)[k].numpy(), w,
                                          err_msg=(j, k))
    for k, v in bridge.paths(tp).items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("which", ["smoke", "full"])
def test_lm_layer_macs_match_reference(arch, which):
    jc = getattr(ARCHS[arch], which.upper())
    tc = getattr(tconfigs.get(arch), which)
    for s in (13, 16, 1024, 4096):
        assert tadapters.lm_layer_macs(tc, s) == jadapters.lm_layer_macs(jc, s)
        for bt in set(tc.block_pattern):
            assert tadapters._lm_block_macs(tc, bt, s) == \
                jadapters._lm_block_macs(jc, bt, s)
    assert dataclasses.asdict(tc.rglru_cfg()) == \
        dataclasses.asdict(jc.rglru_cfg())
    assert dataclasses.asdict(tc.mlstm_cfg()) == \
        dataclasses.asdict(jc.mlstm_cfg())
    assert dataclasses.asdict(tc.slstm_cfg()) == \
        dataclasses.asdict(jc.slstm_cfg())


def test_rglru_width_rounds_as_the_reference():
    """d_rnn = 0 takes 4 * d_model // 3, rounded up to a multiple of 8."""
    for d, dr in ((64, 0), (100, 0), (96, 90), (4096, 5464)):
        jc = jrg.SMOKE.with_(d_model=d, d_rnn=dr)
        tc = tconfigs.get("recurrentgemma-9b").smoke.with_(d_model=d,
                                                           d_rnn=dr)
        assert tc.rglru_cfg().d_rnn == jc.rglru_cfg().d_rnn
        assert tc.rglru_cfg().d_rnn % 8 == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_configs_equal_the_references(arch):
    spec, jmod = tconfigs.get(arch), ARCHS[arch]
    for name in ("full", "smoke"):
        jcfg, tcfg = getattr(jmod, name.upper()), getattr(spec, name)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg), name
        assert tcfg.dtype == getattr(torch, jcfg.param_dtype)
    assert (spec.kind, spec.source, spec.shapes()) == \
        (jmod.SPEC.kind, jmod.SPEC.source, jmod.SPEC.shapes())


@pytest.mark.parametrize("arch,n_layers,n_params,n_stored,n_leaves", [
    ("xlstm-125m", 12, 109_192_008, 44, 126),
    ("recurrentgemma-9b", 5, 3_395_363_392, 64, 64)],
    ids=["xlstm-125m-full", "recurrentgemma-9b-5-layers"])
def test_full_width_structure_matches_reference(arch, n_layers, n_params,
                                                n_stored, n_leaves):
    """At full width (recurrentgemma-9b at the depth the card runs, one
    whole period and the two-layer tail): the reference's tree
    (``jax.eval_shape``) by path, its parameter count, and the port's
    adapter over a tree of those shapes — unlearn layers, layer leaves and
    keys. The bf16 RG-LRU layers hold an f32 log_lambda."""
    jc = ARCHS[arch].FULL.with_(n_layers=n_layers)
    tc = tconfigs.get(arch).full.with_(n_layers=n_layers)
    jshapes = jax.eval_shape(lambda: JLM.init_lm(jax.random.PRNGKey(0), jc))
    flat = bridge.paths(jshapes)
    assert sum(int(np.prod(s.shape)) for s in flat.values()) == n_params
    assert len(flat) == n_stored
    tree = jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, dtype=getattr(torch, str(s.dtype)),
                              device="meta"), jshapes)
    ta = tadapters.lm_adapter(tc, 1024, device="cpu")
    ja = jadapters.lm_adapter(jc, 1024)
    L = ta.n_layers
    assert L == ja.n_layers == n_layers + 2
    assert sum(len(tree_leaves(ta.get_layer(tree, j)))
               for j in range(L)) == n_leaves
    assert [ta.layer_key(j) for j in range(L)] == \
        [ja.layer_key(j) for j in range(L)]
    dtypes = {j: {t.dtype for t in tree_leaves(ta.get_layer(tree, j))}
              for j in range(L)}
    for j in range(1, L - 1):
        want = {torch.bfloat16, torch.float32} \
            if tc.layer_types[j - 1] == "rglru" else {torch.bfloat16}
        assert dtypes[j] == want, j


def test_bridge_keeps_stacked_slstm_weights(xlstm):
    """The stacked sLSTM recurrent weights [1, H, dh, dh] are 4-D but no
    conv weight: they cross the bridge unchanged, both ways, and the round
    trip of the xlstm tree equals the reference's leaves."""
    _, tree, tp = xlstm
    ref = bridge.paths(tree)
    got = bridge.paths(tp)
    back = bridge.paths(bridge.params_to_numpy(tp))
    four_d = sorted(k for k, v in ref.items() if v.ndim == 4)
    assert four_d == [f"period_stack/3/mixer/r{g}" for g in "fioz"]
    for k, v in ref.items():
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert not bridge.is_conv_weight("period_stack/3/mixer/rz", 4)
    assert bridge.is_conv_weight("blocks/0/conv1", 4)
    assert bridge.is_conv_weight("conv1", 4)
    assert not bridge.is_conv_weight("blocks/0/conv1", 3)


@pytest.mark.parametrize("lead_axes", [1, 2])
def test_q8_on_stacked_slstm_weights_matches_reference(xlstm, lead_axes):
    """q8_scales / q8_quantize on the stacked rz (conv=False: a bare tensor
    has no path) and the q8 tree functions on the whole xlstm tree (by
    path) equal the reference's bit for bit: one scale per period, or per
    period and head, never the conv grouping."""
    jp, _, tp = xlstm
    jrz = jp["period_stack"]["3"]["mixer"]["rz"]
    trz = tp["period_stack"]["3"]["mixer"]["rz"]
    js = jcomp.q8_scales(jrz, lead_axes=lead_axes)
    ts = tcomp.q8_scales(trz, lead_axes=lead_axes, conv=False)
    assert tuple(ts.shape) == js.shape == \
        ((1, 1, 1, 1) if lead_axes == 1 else (1, 2, 1, 1))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    jq, js = jcomp.q8_quantize(jrz, lead_axes=lead_axes)
    tq, ts = tcomp.q8_quantize(trz, lead_axes=lead_axes, conv=False)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    jq, js = jcomp.q8_quantize_tree(jp, lead_axes=lead_axes)
    tq, ts = tcomp.q8_quantize_tree(tp, lead_axes=lead_axes)
    for got, want in ((tq, jq), (ts, js),
                      (tcomp.q8_fakequant_tree(tp, lead_axes=lead_axes),
                       jcomp.q8_fakequant_tree(jp, lead_axes=lead_axes))):
        g, w = bridge.paths(bridge.params_to_numpy(got)), _jtree(want)
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k].view(np.uint8),
                                          w[k].view(np.uint8), err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_matches_jax(xlstm, griffin, arch):
    """bf16 parameters (the FULL configs' dtype) beside the f32 log_lambda:
    the activations stay bf16, the logits are f32, and they agree within
    the declared bf16 tolerance (module docstring)."""
    _, tree, _ = _weights_of(arch, xlstm, griffin)
    jc, tc = _cfgs(arch, param_dtype="bfloat16")
    jb = _bf16(jax.tree_util.tree_map(jnp.asarray, tree),
               lambda x: x.astype(jnp.bfloat16))
    tb = _bf16(bridge.params_to_torch(tree, device="cpu"),
               lambda t: t.to(torch.bfloat16))
    for k, t in bridge.paths(tb).items():
        assert t.dtype == (torch.float32 if k.endswith("log_lambda")
                           else torch.bfloat16), k
    tok = _tokens(8, n=2, seed=12)
    tlog, _ = TLM.forward(tb, tc, torch.from_numpy(tok))
    assert tlog.dtype == torch.float32
    _, acts = tadapters.lm_adapter(tc, 8, device="cpu").forward_collect(
        tb, torch.from_numpy(tok))
    assert all(a.dtype == torch.bfloat16 for a in acts[1:])
    tl = tlog.numpy()
    with jax.disable_jit():
        eager = np.asarray(JLM.forward(jb, jc, jnp.asarray(tok))[0])
    compiled = np.asarray(jax.jit(lambda p, t: JLM.forward(p, jc, t)[0])(
        jb, jnp.asarray(tok)))
    np.testing.assert_allclose(tl, eager, rtol=0, atol=5e-2)
    assert (tl.argmax(-1) == eager.argmax(-1)).mean() >= 0.99
    np.testing.assert_allclose(tl, compiled, rtol=0,
                               atol=0.1 * np.abs(compiled).max())
    assert (tl.argmax(-1) == compiled.argmax(-1)).mean() >= 0.95


def _bf16(tree, cast):
    """Every leaf cast by ``cast`` except log_lambda, which stays f32 as
    the reference's init makes it."""
    return {k: (_bf16(v, cast) if isinstance(v, dict)
                else v if k == "log_lambda" else cast(v))
            for k, v in tree.items()}
