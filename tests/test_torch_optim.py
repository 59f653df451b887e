"""The port's optimizer and gradient codecs (``repro_torch.optim``) against
the JAX package's (``repro.optim``).

  * twins of tests/test_substrate.py's optimizer and compression tests: the
    quadratic converges, the cosine schedule's shape, the clip, each codec's
    error feedback conserving the signal, the wire bytes;
  * ``cosine_lr`` at steps 0-120 on four schedules: the reference's eager
    ``cosine_lr`` bit for bit at all but one step, where XLA's cosine is an
    ulp off the correctly rounded one; within MAX_JIT_LR_ULPS f32 ulps of
    the reference's jitted one (inside a jit XLA multiplies by the
    reciprocal of a constant divisor, and the cosine's slope carries that
    ulp of progress further, and it fuses the last multiply-add);
  * ``adamw_update`` over five steps with the same gradients, on an f32
    tree and a bf16 tree (each with the clip active and inactive): the step
    count equal; without the clip the parameters, ``mu`` and ``nu`` BIT FOR
    BIT the reference's eager ``adamw_update``; with it (the global norm
    sums each leaf in another order) and against the jitted update (XLA's
    reciprocal constants and fused multiply-adds) within MAX_LEAF_ULPS
    ulps of each leaf's largest magnitude, in the leaf's dtype;
  * ``Int8Codec.apply`` and ``TopKCodec.apply`` over five rounds, a conv
    weight among the leaves (the port holds it as OIHW, the reference as
    HWIO): the sent trees and the error feedback BIT FOR BIT the jitted
    reference's (the codec's caller, the train step, is jitted), and
    ``Int8Codec``'s codes and block scales equal. TopK's tie rule: at equal
    magnitudes the lower index (in the reference's layout) is kept, as
    ``lax.top_k`` documents; the tie case holds whole blocks of equal
    magnitudes across the k-th value.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.optim import (AdamWConfig, Int8Codec, TopKCodec,  # noqa: E402
                               adamw_update, cosine_lr, init_adamw)

torch.set_num_threads(2)

# adamw_update against the reference where the two may round apart (the
# clipped eager step: the global norm's sums; any jitted step: XLA's
# reciprocal constants and fused multiply-adds), in ulps of each leaf's
# largest magnitude in its dtype (4.0 seen, on the clipped f32 eager step)
MAX_LEAF_ULPS = 8
# cosine_lr against the jitted reference, in f32 ulps: a one-ulp move of
# the jit's progress (multiplied by the reciprocal) goes through the
# cosine's slope (7 seen)
MAX_JIT_LR_ULPS = 8
SCHEDULES = [dict(lr=3e-3, warmup_steps=5, total_steps=120),
             dict(lr=3e-3, warmup_steps=5, total_steps=12),
             dict(lr=1.0, warmup_steps=10, total_steps=100),
             dict(lr=3e-3, warmup_steps=7, total_steps=33)]


def _ulps(a, b):
    """Elementwise distance in units in the last place (f32)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    # to a monotone integer line
    ia = np.where(ia < 0, -(1 << 31) - ia, ia)
    ib = np.where(ib < 0, -(1 << 31) - ib, ib)
    return np.abs(ia - ib)


def _leaf_ulps(got, want):
    """max |got - want| in ulps of the leaf's largest magnitude, in the
    leaf's own dtype (f32: 24-bit significand, bf16: 8-bit): a bound that
    does not blow up where a value cancels to near zero."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    top = np.abs(w).max()
    if top == 0:
        return 0.0 if np.array_equal(g, w) else np.inf
    bits = 8 if np.asarray(want).dtype.name == "bfloat16" else 24
    ulp = 2.0 ** (np.floor(np.log2(top)) - (bits - 1))
    return float(np.abs(g - w).max() / ulp)


def _host(tree):
    """The port's tree as numpy by path in the reference's layout (conv
    weights as HWIO), bf16 leaves as ml_dtypes bf16."""
    def one(path, t):
        a = (t.view(torch.int16).numpy().view(jnp.bfloat16)
             if t.dtype == torch.bfloat16 else t.numpy())
        if bridge.is_conv_weight(path, a.ndim):
            a = a.transpose(bridge._OIHW_TO_HWIO)
        return a

    return {k: one(k, v) for k, v in bridge.paths(tree).items()}


# ---------------------------------------------------------------------------
# twins of tests/test_substrate.py
# ---------------------------------------------------------------------------
def test_adamw_converges_quadratic():
    cfg = AdamWConfig(lr=0.1, total_steps=200, warmup_steps=0,
                      weight_decay=0.0, clip_norm=100.0)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    opt = init_adamw(cfg, params)
    loss = lambda p, _: torch.sum((p["w"] - target) ** 2)
    for _ in range(200):
        _, g = topt.value_and_grad(loss, params, None)
        params, opt = adamw_update(cfg, g, opt, params)
    assert float(loss(params, None)) < 1e-2
    assert int(opt.step) == 200 and opt.step.dtype == torch.int32


def test_make_train_step_is_functional():
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=10)
    params = {"w": torch.ones(3)}
    step = topt.make_train_step(lambda p, b: torch.sum(p["w"] * b), cfg)
    st = init_adamw(cfg, params)
    new, st2, loss = step(params, st, torch.tensor([1.0, 2.0, 3.0]))
    assert float(loss) == 6.0 and int(st2.step) == 1 and int(st.step) == 0
    assert torch.equal(params["w"], torch.ones(3))   # the caller's tree
    assert params["w"].grad is None and not torch.equal(new["w"], params["w"])


def test_cosine_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    lrs = [float(cosine_lr(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in [0, 5, 10, 50, 100]]
    assert lrs[0] < lrs[1] < lrs[2]          # warmup rising
    assert abs(lrs[2] - 1.0) < 1e-6          # peak at end of warmup
    assert lrs[3] < lrs[2]                   # decaying
    assert abs(lrs[4] - 0.1) < 1e-2          # floor at min_lr_frac


def test_grad_clip_applied():
    cfg = AdamWConfig(lr=1e-3, clip_norm=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    opt = init_adamw(cfg, params)
    p2, _ = adamw_update(cfg, {"w": torch.full((4,), 1e6)}, opt, params)
    assert float(p2["w"].abs().max()) < 1.0  # clipped update is sane


@pytest.mark.parametrize("codec", [Int8Codec(block=64), TopKCodec(frac=0.1)],
                         ids=["int8", "topk"])
def test_compression_error_feedback_conserves_signal(codec):
    """With EF, the accumulated (sent + residual) equals the true gradient
    sum: no information is permanently lost."""
    rng = np.random.default_rng(0)
    g = {"w": torch.tensor(rng.normal(size=257), dtype=torch.float32)}
    ef = codec.init_state(g)
    sent_total = np.zeros(257)
    g_total = np.zeros(257)
    for _ in range(5):
        sent, ef = codec.apply(g, ef)
        sent_total += sent["w"].double().numpy()
        g_total += g["w"].double().numpy()
    resid = ef["w"].double().numpy()
    np.testing.assert_allclose(sent_total + resid, g_total, rtol=1e-3,
                               atol=1e-3)


def test_wire_bytes():
    c = Int8Codec(block=256)
    assert c.wire_bytes(1024) == 1024 + 4 * 4       # payload + scales
    t = TopKCodec(frac=0.01)
    assert t.wire_bytes(10_000) == 100 * 8
    for n in (1, 255, 257, 10_001):
        assert c.wire_bytes(n) == jopt.Int8Codec(block=256).wire_bytes(n)
        assert t.wire_bytes(n) == jopt.TopKCodec(frac=0.01).wire_bytes(n)


# ---------------------------------------------------------------------------
# parity with repro.optim
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sched", range(len(SCHEDULES)))
def test_cosine_lr_matches_reference(sched):
    kw = SCHEDULES[sched]
    tcfg, jcfg = AdamWConfig(**kw), jopt.AdamWConfig(**kw)
    jitted = jax.jit(lambda s: jopt.cosine_lr(jcfg, s))
    got, eager, jit = [], [], []
    for s in range(0, 121):
        got.append(cosine_lr(tcfg, torch.tensor(s, dtype=torch.int32)).numpy())
        eager.append(np.asarray(jopt.cosine_lr(jcfg, jnp.int32(s))))
        jit.append(np.asarray(jitted(jnp.int32(s))))
    got, eager, jit = map(np.array, (got, eager, jit))
    assert got.dtype == np.float32
    # XLA's eager cosine is an ulp off the correctly rounded one at step 62
    # of the third schedule; every other step is the same bits
    assert _ulps(got, eager).max() <= 1
    assert (got != eager).sum() <= 1
    assert _ulps(got, jit).max() <= MAX_JIT_LR_ULPS


def _trees(dtype, rng, scale):
    """Parameters and five gradient trees of one structure (a nested
    dense layer, an embedding, a scalar), as numpy in ``dtype``."""
    def tree(s=1.0):
        return {"a": {"w": rng.normal(size=(17, 9)) * s,
                      "b": rng.normal(size=(9,)) * s},
                "emb": rng.normal(size=(33, 8)) * s,
                "s": np.asarray(rng.normal() * s)}

    to = ((lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)))
          if dtype == "bfloat16" else (lambda x: np.asarray(x, np.float32)))
    cast = lambda t: jax.tree_util.tree_map(to, t)
    return cast(tree()), [cast(tree(scale)) for _ in range(5)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", ["clipped", "unclipped"])
def test_adamw_update_matches_reference(dtype, clip):
    rng = np.random.default_rng(7)
    # gradients of norm ~60 (clip 1.0 scales them) or ~0.06 (no clip)
    p, gs = _trees(dtype, rng, 5.0 if clip == "clipped" else 5e-3)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=5, weight_decay=0.01)
    tcfg, jcfg = AdamWConfig(**kw), jopt.AdamWConfig(**kw)
    tp = bridge.params_to_torch(p, device="cpu")
    ts = init_adamw(tcfg, tp)
    jp_e = jp_j = jax.tree_util.tree_map(jnp.asarray, p)
    js_e = js_j = jopt.init_adamw(jcfg, jp_e)
    jstep = jax.jit(lambda g, s, q: jopt.adamw_update(jcfg, g, s, q))
    for g in gs:
        tp, ts = adamw_update(tcfg, bridge.params_to_torch(g, device="cpu"),
                              ts, tp)
        jg = jax.tree_util.tree_map(jnp.asarray, g)
        jp_e, js_e = jopt.adamw_update(jcfg, jg, js_e, jp_e)
        jp_j, js_j = jstep(jg, js_j, jp_j)
    assert ts.step.dtype == torch.int32 and int(ts.step) == int(js_e.step) == 5
    host = lambda t: bridge.paths(jax.tree_util.tree_map(np.asarray, t))
    worst = {}
    for name, got, eager, jit in (("params", tp, jp_e, jp_j),
                                  ("mu", ts.mu, js_e.mu, js_j.mu),
                                  ("nu", ts.nu, js_e.nu, js_j.nu)):
        g, e, j = _host(got), host(eager), host(jit)
        assert sorted(g) == sorted(e)
        for k in e:
            assert g[k].dtype == e[k].dtype, (name, k)
            if clip == "unclipped":
                np.testing.assert_array_equal(g[k], e[k],
                                              err_msg=f"{name} {k}")
            worst[(name, k, "eager")] = _leaf_ulps(g[k], e[k])
            worst[(name, k, "jit")] = _leaf_ulps(g[k], j[k])
    assert max(worst.values()) <= MAX_LEAF_ULPS, worst


def _codec_leaves(rng, ties):
    """A dense weight, a bias, a conv weight (HWIO here) and, with ``ties``,
    leaves whose magnitudes repeat across the top-k cut."""
    g = {"dense": {"w": rng.normal(size=(37, 19))},
         "b": rng.normal(size=(300,)) * 1e-3,
         "conv": {"w": rng.normal(size=(3, 3, 4, 8))}}
    if ties:
        v = np.repeat(rng.normal(size=16), 16) * rng.choice([-1, 1], 256)
        g["tie"] = v
        g["conv"]["w"] = np.round(g["conv"]["w"] * 2) / 2  # a few magnitudes
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), g)


@pytest.mark.parametrize("name", ["int8", "topk"])
@pytest.mark.parametrize("ties", [False, True], ids=["plain", "ties"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codec_apply_matches_jitted_reference(name, ties, dtype):
    """bf16 gradients: ``sent`` comes back in bf16 (the f32 value cast,
    round to nearest even), the EF state in f32, on both sides."""
    rng = np.random.default_rng(3)
    tcodec = Int8Codec() if name == "int8" else TopKCodec(frac=0.1)
    jcodec = jopt.Int8Codec() if name == "int8" else jopt.TopKCodec(frac=0.1)
    japply = jax.jit(jcodec.apply)
    g0 = _codec_leaves(rng, ties)
    if dtype == "bfloat16":
        g0 = jax.tree_util.tree_map(
            lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)), g0)
    tef = tcodec.init_state(bridge.params_to_torch(g0, device="cpu"))
    jef = jcodec.init_state(g0)
    for r in range(5):
        g = g0 if r % 2 == 0 else jax.tree_util.tree_map(
            lambda x: (x * 0.5).astype(x.dtype), g0)
        tsent, tef = tcodec.apply(bridge.params_to_torch(g, device="cpu"),
                                  tef)
        jsent, jef = japply(g, jef)
        for what, got, want in (("sent", tsent, jsent), ("ef", tef, jef)):
            gp = _host(got)
            wp = bridge.paths(jax.tree_util.tree_map(np.asarray, want))
            assert sorted(gp) == sorted(wp)
            for k in wp:
                assert gp[k].dtype == wp[k].dtype, (what, k)
                np.testing.assert_array_equal(gp[k], wp[k],
                                              err_msg=f"round {r} {what} {k}")
        if name == "int8" and dtype == "float32":
            # the codes and block scales: the reference's roundtrip inside a
            # jit on the same total, leaf by leaf in its layout
            for k, tot in bridge.paths(jax.tree_util.tree_map(
                    np.asarray, g)).items():
                flat, scale, q = tcodec._blocks(torch.as_tensor(tot))
                want = np.asarray(jax.jit(jcodec._roundtrip)(tot))
                deq = (q.float() * scale).reshape(-1)[:tot.size]
                np.testing.assert_array_equal(deq.numpy().reshape(tot.shape),
                                              want, err_msg=k)
                np.testing.assert_array_equal(
                    tcodec._roundtrip(torch.as_tensor(tot)).numpy(), want)


def test_topk_tie_rule_lower_index():
    """Every magnitude equal: the first k indices (reference layout) are
    kept, as ``lax.top_k`` keeps them."""
    x = np.array([1.0, -1.0, 1.0, -1.0, 1.0, 1.0, -1.0, 1.0, 1.0, -1.0],
                 np.float32)
    codec, jcodec = TopKCodec(frac=0.3), jopt.TopKCodec(frac=0.3)
    sent, _ = codec.apply({"v": torch.as_tensor(x)},
                          {"v": torch.zeros(10)})
    jsent, _ = jax.jit(jcodec.apply)({"v": x}, {"v": np.zeros(10, np.float32)})
    np.testing.assert_array_equal(sent["v"].numpy(), np.asarray(jsent["v"]))
    assert np.flatnonzero(sent["v"].numpy()).tolist() == [0, 1, 2]
