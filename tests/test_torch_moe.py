"""The MoE FFN of the port (``repro_torch.models.layers.moe_ffn``) against
the JAX package's ``repro.models.layers.moe_ffn``, on the same weights and
tokens made from numpy seeds.

The cases are SMOKE widths (d_model 64, d_ff 32 or 64): top-1 and top-2,
with and without a shared expert, f32 and bf16 weights (the router f32
beside them, as ``init_moe`` makes it), capacity factors at which choices
overflow, and ``dispatch_blocks`` 2. Declared tolerances:

  * routing decisions (expert ids and whether each choice was kept within
    capacity) EQUAL: the router's f32 softmax differs between the packages
    by rounding, which can flip a choice only between near-equal
    probabilities, and none is that near at these sizes; equal
    probabilities go to the lower expert id on both sides;
  * the output and the input / weight gradients of a fixed cotangent (the
    vjp; in bf16 the reference's on its weights upcast exactly, see
    ``_jax_vjp``): f32 at rtol 1e-5 / atol 1e-5 (the products' f32
    summation order); bf16, the f32 router's gradient too, at rtol 2e-2 /
    atol 2e-2 on >= 99.9% of entries and atol 0.25 on all (bf16 outputs
    and gradients round to 8 bits, and an entry a rounding step apart in
    an intermediate can move one step);
  * the aux loss at rtol 1e-6 (f32) and equal capacity; the MACs of
    ``_lm_block_macs`` EQUAL; the ValueError texts EQUAL.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import kimi_k2_1t_a32b as jkimi  # noqa: E402
from repro.configs import llama4_scout_17b_a16e as jscout  # noqa: E402
from repro.core import adapters as jadapters  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import adapters as tadapters  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models.module import tree_map  # noqa: E402

torch.set_num_threads(2)
D = 64
# (name, num_experts, top_k, d_ff, shared_ff, capacity_factor,
#  dispatch_blocks, dtype, batch, seq)
CASES = [
    ("top1-shared-f32", 4, 1, 64, 64, 1.25, 1, "float32", 4, 16),
    ("top1-f32-overflow", 4, 1, 64, 0, 0.5, 1, "float32", 4, 16),
    ("top2-shared-f32", 8, 2, 32, 32, 1.25, 1, "float32", 4, 16),
    ("top2-f32-blocks2", 8, 2, 32, 0, 1.0, 2, "float32", 4, 16),
    ("top1-shared-bf16", 4, 1, 64, 64, 1.25, 1, "bfloat16", 4, 16),
    ("top2-shared-bf16-blocks2", 8, 2, 32, 32, 0.75, 2, "bfloat16", 2, 24),
]


def _cfgs(E, K, F, shared, cf, nb):
    kw = dict(d_model=D, d_ff=F, num_experts=E, top_k=K, capacity_factor=cf,
              shared_ff=shared, dispatch_blocks=nb)
    return JL.MoEConfig(**kw), TL.MoEConfig(**kw)


def _case(name):
    E, K, F, shared, cf, nb, dt, B, S = next(c[1:] for c in CASES
                                             if c[0] == name)
    jcfg, tcfg = _cfgs(E, K, F, shared, cf, nb)
    seed = [c[0] for c in CASES].index(name)
    jp = JL.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.dtype(dt))
    tp = bridge.params_to_torch(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    x = np.random.default_rng(seed).standard_normal((B, S, D)).astype(
        np.float32)
    ct = np.random.default_rng(seed + 100).standard_normal((B, S, D)).astype(
        np.float32)
    return jcfg, tcfg, jp, tp, x, ct, dt


def _jax_vjp(jp, jcfg, x, ct, dt):
    """The reference's vjp, compiled. XLA on the CPU has no bf16 x bf16 ->
    f32 product with batch axes (the experts' einsums), so the weights go
    in upcast to f32, exactly: the reference asks for f32 products of its
    bf16 operands, which are these; x and the cotangent stay in ``dt``, so
    every cast of the reference's still rounds as it does, and the weight
    gradients come back rounded to their leaves' dtype, as a bf16 leaf's
    gradient is."""
    @jax.jit
    def run(p, xx, c):
        p32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), p)
        (y, aux), vjp = jax.vjp(lambda q, z: JL.moe_ffn(q, jcfg, z), p32, xx)
        gp, gx = vjp((c, jnp.ones((), jnp.float32)))
        return y, aux, jax.tree_util.tree_map(lambda g, a: g.astype(a.dtype),
                                              gp, p), gx

    return run(jp, jnp.asarray(x).astype(dt), jnp.asarray(ct).astype(dt))


def _torch_vjp(tp, tcfg, x, ct, dt):
    lp = {k: (v.detach().requires_grad_(True) if not isinstance(v, dict)
              else {kk: vv.detach().requires_grad_(True)
                    for kk, vv in v.items()}) for k, v in tp.items()}
    xt = torch.from_numpy(x).to(getattr(torch, dt)).requires_grad_(True)
    y, aux = TL.moe_ffn(lp, tcfg, xt)
    leaves = list(bridge.paths(lp).items())
    grads = torch.autograd.grad(
        (y.float() * torch.from_numpy(ct).to(y.dtype).float()).sum() + aux,
        [t for _, t in leaves] + [xt])
    return y, aux, {k: g for (k, _), g in zip(leaves, grads[:-1])}, grads[-1]


def _f32(a):
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) \
        else a.detach().float().numpy()


def _close(got, want, dt, what):
    got, want = _f32(got), _f32(want)
    if dt == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=what)
        return
    ok = np.abs(got - want) <= 2e-2 + 2e-2 * np.abs(want)
    assert ok.mean() >= 0.999, (what, ok.mean())
    np.testing.assert_allclose(got, want, rtol=0, atol=0.25, err_msg=what)


def _routes_jax(jp, jcfg, xt):
    """The reference's routing decisions on tokens [nb, Tb, D], by the
    reference's own steps (``repro.models.layers.moe_ffn``): expert ids
    and whether each choice was kept within capacity."""
    K = jcfg.top_k
    nb, Tb, _ = xt.shape
    logits = jnp.einsum("ntd,de->nte", xt.astype(jnp.float32), jp["router"])
    _, eidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    sel = jax.nn.one_hot(eidx, jcfg.num_experts, dtype=jnp.int32)
    pos = jnp.take_along_axis(
        (jnp.cumsum(sel.reshape(nb, Tb * K, -1), axis=1) - 1).reshape(
            nb, Tb, K, -1), eidx[..., None], axis=-1)[..., 0]
    return np.asarray(eidx), np.asarray(pos < JL.moe_capacity(jcfg, Tb))


def _routes_torch(tp, tcfg, xt):
    _, _, eidx, in_cap, _, _ = TL.moe_dispatch(tp, tcfg, xt)
    return eidx.numpy(), in_cap.numpy()


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_moe_ffn_forward_and_vjp_match_jax(name):
    jcfg, tcfg, jp, tp, x, ct, dt = _case(name)
    jy, jaux, jgp, jgx = _jax_vjp(jp, jcfg, x, ct, dt)
    ty, taux, tgp, tgx = _torch_vjp(tp, tcfg, x, ct, dt)
    assert ty.dtype == getattr(torch, dt) and tuple(ty.shape) == x.shape
    _close(ty, jy, dt, "y")
    np.testing.assert_allclose(float(taux.detach()), float(jaux), rtol=1e-6)
    _close(tgx, jgx, dt, "dx")
    jgp = bridge.paths(jax.tree_util.tree_map(np.asarray, jgp))
    assert sorted(tgp) == sorted(jgp)
    for k, g in tgp.items():
        assert g.dtype == (torch.float32 if k == "router"
                           else getattr(torch, dt)), k
        # the router's gradient reaches it through the gates' bf16 casts:
        # the bf16 tolerance, though the leaf is f32
        _close(g, jgp[k], dt, k)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_routing_decisions_and_capacity_equal_jax(name):
    """Expert ids and kept choices equal, per dispatch block; the capacity
    of a block of Tb tokens equal; the overflow cases drop choices."""
    jcfg, tcfg, jp, tp, x, _, dt = _case(name)
    nb = jcfg.dispatch_blocks
    xt = x.reshape(nb, -1, D)
    je, jk = _routes_jax(jp, jcfg, jnp.asarray(xt).astype(dt))
    te, tk = _routes_torch(tp, tcfg, torch.from_numpy(xt).to(
        getattr(torch, dt)))
    assert int((je != te).sum()) == 0 and int((jk != tk).sum()) == 0
    Tb = xt.shape[1]
    assert TL.moe_capacity(tcfg, Tb) == JL.moe_capacity(jcfg, Tb)
    if jcfg.capacity_factor < 1.25:
        assert int((~tk).sum()) > 0


def test_equal_probabilities_go_to_the_lower_expert_as_lax_top_k():
    """A router whose columns 1 and 2 are equal and 3 the largest: every
    token's top-2 is (3, 1) on both sides, the tie broken by the lower id,
    and with top-1 the choice (1) beats (2) when column 3 is removed."""
    jcfg, tcfg = _cfgs(4, 2, 32, 0, 1.25, 1)
    jp = JL.init_moe(jax.random.PRNGKey(7), jcfg)
    r = np.zeros((D, 4), np.float32)
    r[:, 1] = r[:, 2] = 0.01
    r[:, 3] = 0.05
    jp = dict(jp, router=jnp.asarray(r))
    tp = bridge.params_to_torch(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    xt = np.abs(np.random.default_rng(1).standard_normal((1, 16, D))).astype(
        np.float32)
    je, _ = _routes_jax(jp, jcfg, jnp.asarray(xt))
    te, _ = _routes_torch(tp, tcfg, torch.from_numpy(xt))
    np.testing.assert_array_equal(te, je)
    assert (te[..., 0] == 3).all() and (te[..., 1] == 1).all()
    r[:, 3] = -0.05
    jp = dict(jp, router=jnp.asarray(r))
    tp["router"] = torch.from_numpy(r)
    j1, t1 = _cfgs(4, 1, 32, 0, 1.25, 1)
    je, _ = _routes_jax(jp, j1, jnp.asarray(xt))
    te, _ = _routes_torch(tp, t1, torch.from_numpy(xt))
    np.testing.assert_array_equal(te, je)
    assert (te == 1).all()


def test_top1_gate_is_exactly_one_and_aux_carries_the_router():
    """With top-1 the renormalised gate is 1 exactly, so the router's
    gradient through the output is rounding noise on both sides, three
    orders below the aux loss's; with the aux loss the gradients agree at
    rtol 1e-4 beside twice that noise."""
    jcfg, tcfg, jp, tp, x, ct, _ = _case("top1-shared-f32")
    gate = TL.moe_dispatch(tp, tcfg, torch.from_numpy(x).reshape(1, -1,
                                                                  D))[1]
    assert torch.equal(gate, torch.ones_like(gate))

    def jgrad(aux_w):
        return jax.grad(lambda p: (JL.moe_ffn(p, jcfg, jnp.asarray(x))[0]
                                   * jnp.asarray(ct)).sum()
                        + aux_w * JL.moe_ffn(p, jcfg, jnp.asarray(x))[1]
                        )(jp)["router"]

    def tgrad(aux_w):
        r = tp["router"].detach().requires_grad_(True)
        y, aux = TL.moe_ffn(dict(tp, router=r), tcfg, torch.from_numpy(x))
        return torch.autograd.grad((y * torch.from_numpy(ct)).sum()
                                   + aux_w * aux, r)[0].numpy()

    j0, t0 = np.asarray(jgrad(0.0)), tgrad(0.0)
    j1, t1 = np.asarray(jgrad(1.0)), tgrad(1.0)
    assert np.abs(j0).max() < 1e-3 * np.abs(j1).max()
    assert np.abs(t0).max() < 1e-3 * np.abs(t1).max()
    # each side's gradient is the aux loss's plus its own rounding noise
    noise = max(np.abs(j0).max(), np.abs(t0).max())
    np.testing.assert_allclose(t1, j1, rtol=1e-4, atol=2 * noise)


def test_errors_and_unported_constraints():
    """The dispatch ValueError's text equals the reference's; the sharding
    constraints raise "not ported yet"; moe_cfg on a dense config raises
    the reference's ValueError."""
    jcfg, tcfg = _cfgs(4, 1, 32, 0, 1.25, 3)
    jp = JL.init_moe(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_to_torch(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    x = np.zeros((2, 4, D), np.float32)
    with pytest.raises(ValueError) as je:
        JL.moe_ffn(jp, jcfg, jnp.asarray(x))
    with pytest.raises(ValueError) as te:
        TL.moe_ffn(tp, tcfg, torch.from_numpy(x))
    assert str(te.value) == str(je.value)
    import dataclasses
    with pytest.raises(ValueError, match="not ported yet"):
        TL.moe_ffn(tp, dataclasses.replace(tcfg, shard_constraints=True,
                                           dispatch_blocks=1),
                   torch.from_numpy(x))
    dense = tconfigs.get("yi-6b").smoke
    with pytest.raises(ValueError) as te:
        dense.moe_cfg()
    jdense = JLM.LMConfig(**{f: getattr(dense, f) for f in (
        "name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
        "vocab")})
    with pytest.raises(ValueError) as je:
        jdense.moe_cfg()
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("arch,jmod", [("llama4-scout-17b-a16e", jscout),
                                       ("kimi-k2-1t-a32b", jkimi)])
def test_moe_macs_and_configs_equal_the_references(arch, jmod):
    """``_lm_block_macs``' MoE terms (router S·D·E, S·top_k·3·D·F, the
    shared 3·S·D·shared_ff) and the registered configs, FULL and SMOKE,
    equal the reference's."""
    import dataclasses
    spec = tconfigs.get(arch)
    for which in ("full", "smoke"):
        jc, tc = getattr(jmod, which.upper()), getattr(spec, which)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.moe_cfg() == TL.MoEConfig(**dataclasses.asdict(
            jc.moe_cfg()))
        for s in (16, 1024, 2048):
            assert tadapters.lm_layer_macs(tc, s) == \
                jadapters.lm_layer_macs(jc, s)
            m = tc.moe
            dense = tadapters._lm_block_macs(tc.with_(moe=None, d_ff=0),
                                             "attn", s)
            assert tadapters._lm_block_macs(tc, "attn", s) - dense == (
                s * tc.d_model * m.num_experts
                + s * m.top_k * 3 * tc.d_model * tc.d_ff
                + 3 * s * tc.d_model * m.shared_ff)
    assert (spec.kind, spec.source, spec.shapes(), spec.skip_shapes) == \
        (jmod.SPEC.kind, jmod.SPEC.source, jmod.SPEC.shapes(),
         jmod.SPEC.skip_shapes)


def test_lm_loss_and_its_gradient_carry_the_aux_loss():
    """On llama4-scout-smoke: ``forward``'s aux is the sum over the blocks,
    ``lm_loss`` adds it at ``aux_weight``, and the loss and its gradient
    match the reference's at two aux weights."""
    jcfg = jscout.SMOKE
    tcfg = tconfigs.get("llama4-scout-17b-a16e").smoke
    params = JLM.init_lm(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_to_torch(jax.tree_util.tree_map(np.asarray, params),
                                device="cpu")
    rng = np.random.default_rng(5)
    tok = rng.integers(0, 256, (4, 16)).astype(np.int32)
    lab = rng.integers(0, 256, (4, 16)).astype(np.int32)
    _, jaux = JLM.forward(params, jcfg, jnp.asarray(tok))
    _, taux = TLM.forward(tp, tcfg, torch.from_numpy(tok))
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    assert float(taux) > 0.0
    for w in (0.01, 0.5):
        jl, jg = jax.value_and_grad(lambda p: JLM.lm_loss(
            p, jcfg, jnp.asarray(tok), jnp.asarray(lab), aux_weight=w))(
                params)
        lp = tree_map(lambda t: t.detach().requires_grad_(True), tp)
        tl = TLM.lm_loss(lp, tcfg, torch.from_numpy(tok),
                         torch.from_numpy(lab), aux_weight=w)
        named = list(bridge.paths(lp).items())
        grads = torch.autograd.grad(tl, [t for _, t in named])
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
        jg = bridge.paths(jax.tree_util.tree_map(np.asarray, jg))
        for (k, _), g in zip(named, grads):
            np.testing.assert_allclose(g.numpy(), jg[k], rtol=1e-4,
                                       atol=1e-6, err_msg=(w, k))
