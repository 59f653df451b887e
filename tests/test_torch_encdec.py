"""The port's encoder-decoder against ``repro.models.encdec`` and the cross
attention of ``repro.models.layers``, on the same weights, on the CPU.

The weights are whisper-tiny-smoke's shapes (2 encoder and 2 decoder
blocks, d_model 64, 4 heads, d_ff 160, vocab 256, 32 frames) drawn with
numpy (RMSNorm scales away from 1, so every leaf is exercised) and carried
over by ``repro_torch.bridge``; tokens and the stub frames come from a
numpy seed. Tolerances, per tensor: both sides compute in f32 with the
products and sums in another order in each framework, so

  * the cross attention (query batch equal to and below the memory's):
    rtol 1e-5 / atol 1e-5;
  * ``encode``, the adapter's activations, ``forward``'s logits and
    ``lm_loss``: rtol 1e-5 / atol 2e-5 (four blocks compound the error);
  * the ``lm_loss`` gradients: rtol 1e-4 / atol 1e-6 on every leaf, the
    encoder's too;
  * ``decode_step`` (``encode`` then one token at a time against the KV
    caches): the logits at rtol 1e-5 / atol 2e-5 against the reference's
    own decode and against the port's ``forward``; the caches at rtol 1e-5
    / atol 1e-5;
  * a bf16 forward: the logits within atol 0.1 everywhere and within rtol
    2e-2 / atol 2e-2 on at least 99% of the entries, the argmax equal at
    every position where the reference's two largest logits lie more than
    0.05 apart (an encoder and a decoder of two bf16 blocks each: on these
    weights the two positions whose argmax moves have margins of 0.001 and
    0.023, below the logits' largest difference, 0.043; 81% of the
    positions have a margin past 0.05, and at least 75% must).

Exact: the configs of the registry, the FULL tree (27 stored leaves,
61,074,432 parameters, counted with ``jax.eval_shape`` on the reference;
no leaf of four axes, so the bridge keeps every leaf's layout), the
adapter's MAC table, layer keys and layer views, ``set_layer`` (the
caller's tensors untouched) and the bridge round trip.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import whisper_tiny as jw  # noqa: E402
from repro.core import adapters as jadapters  # noqa: E402
from repro.models import encdec as JED  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import adapters as tadapters  # noqa: E402
from repro_torch.models import encdec as TED  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.module import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(2)
JCFG = jw.SMOKE
TCFG = tconfigs.get("whisper-tiny").smoke
B, S = 3, 12
TOL = dict(rtol=1e-5, atol=1e-5)
TOL_FWD = dict(rtol=1e-5, atol=2e-5)


def _draw(rng):
    def draw(path, s):
        if path.endswith("['scale']"):
            return (1.0 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        return (rng.normal(size=s.shape)
                / np.sqrt(s.shape[-2])).astype(np.float32)
    return draw


@pytest.fixture(scope="module")
def weights():
    """(JAX tree, port tree) of whisper-tiny-smoke's shapes."""
    shapes = jax.eval_shape(lambda: JED.init_encdec(jax.random.PRNGKey(0),
                                                    JCFG))
    rng = np.random.default_rng(5)
    draw = _draw(rng)
    tree = jax.tree_util.tree_map_with_path(
        lambda kp, s: draw(jax.tree_util.keystr(kp), s), shapes)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            bridge.params_to_torch(tree, device="cpu"))


def _tokens(n=B, seed=2):
    return np.random.default_rng(seed).integers(
        0, JCFG.vocab, (n, S)).astype(np.int32)


def _frames(n=B, seed=3):
    return np.random.default_rng(seed).normal(
        size=(n, JCFG.n_frames, JCFG.d_model)).astype(np.float32)


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# -- configs and structure ----------------------------------------------------
def test_registry_whisper_equals_the_reference():
    spec = tconfigs.get("whisper-tiny")
    for name in ("full", "smoke"):
        jcfg, tcfg = getattr(jw, name.upper()), getattr(spec, name)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg), name
        assert tcfg.dtype == getattr(torch, jcfg.param_dtype)
        assert tcfg.dh == jcfg.dh
        for c in (True, False):
            assert dataclasses.asdict(tcfg.self_cfg(c)) == \
                dataclasses.asdict(jcfg.self_cfg(c))
        assert dataclasses.asdict(tcfg.cross_cfg()) == \
            dataclasses.asdict(jcfg.cross_cfg())
        assert TED.n_unlearn_layers(tcfg) == JED.n_unlearn_layers(jcfg)
    assert (spec.kind, spec.source, spec.shapes(), spec.skip_shapes) == \
        (jw.SPEC.kind, jw.SPEC.source, jw.SPEC.shapes(), jw.SPEC.skip_shapes)
    assert spec.kind == "encdec"
    assert tbase.ENCDEC_CHUNKED_SKIP == jbase.ENCDEC_CHUNKED_SKIP


def test_full_tree_keeps_every_layout():
    """whisper-tiny FULL: the reference's tree holds 27 leaves and
    61,074,432 parameters, untied, none of four axes (the stacks lie
    outside ``period_stack``): ``is_conv_weight`` leaves every one in its
    [in, out] layout. The port's adapter over a tree of those shapes sees
    the decoder chain (6 layers) under the reference's layer keys, and its
    SMOKE tree equals the reference's path by path."""
    jshapes = bridge.paths(jax.eval_shape(
        lambda: JED.init_encdec(jax.random.PRNGKey(0), jw.FULL)))
    sizes = [int(np.prod(s.shape)) for s in jshapes.values()]
    assert len(sizes) == 27 and sum(sizes) == 61_074_432
    assert "lm_head/w" in jshapes
    for k, s in jshapes.items():
        assert len(s.shape) <= 3, k
        assert not bridge.is_conv_weight(k, len(s.shape)), k
    tree = jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, dtype=torch.bfloat16, device="meta"),
        jax.eval_shape(lambda: JED.init_encdec(jax.random.PRNGKey(0),
                                               jw.FULL)))
    tc = tconfigs.get("whisper-tiny").full
    frames = torch.empty(2, tc.n_frames, tc.d_model, device="meta")
    ta = tadapters.encdec_adapter(tc, 448, frames, device="cpu")
    ja = jadapters.encdec_adapter(jw.FULL, 448,
                                  jnp.zeros((2, jw.FULL.n_frames,
                                             jw.FULL.d_model)))
    assert ta.n_layers == ja.n_layers == 6
    assert [ta.layer_key(j) for j in range(6)] == \
        [ja.layer_key(j) for j in range(6)]
    assert ta.layer_ctx is None and ja.layer_ctx is None
    assert ta.int_input_layer0 and ja.int_input_layer0
    assert list(ta.layer_fwd_macs) == list(ja.layer_fwd_macs)
    assert [len(tree_leaves(ta.get_layer(tree, j))) for j in range(6)] == \
        [1, 14, 14, 14, 14, 2]
    tp = TED.init_encdec(torch.Generator().manual_seed(0), TCFG,
                         device="cpu")
    jsm = bridge.paths(jax.eval_shape(
        lambda: JED.init_encdec(jax.random.PRNGKey(0), JCFG)))
    got = bridge.paths(tp)
    assert sorted(got) == sorted(jsm)
    for k, s in jsm.items():
        assert tuple(got[k].shape) == tuple(s.shape), k
        assert got[k].is_contiguous() and got[k].dtype == torch.float32, k


def test_bridge_round_trip_keeps_encdec_layouts(weights):
    jp, tp = weights
    ref = bridge.paths(jax.tree_util.tree_map(np.asarray, jp))
    back = bridge.paths(bridge.params_to_numpy(tp))
    got = bridge.paths(tp)
    assert sorted(back) == sorted(ref) and len(ref) == 27
    assert tuple(got["decoder/cross_attn/wk"].shape) == (2, 64, 64)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        np.testing.assert_array_equal(back[k], v, err_msg=k)


# -- cross attention ----------------------------------------------------------
@pytest.mark.parametrize("rows", [B, 1], ids=["same-batch", "query-batch-1"])
def test_cross_attention_matches_jax(rows):
    """Cross attention with a memory of another width (d_kv_in) and
    length; with a query batch of 1 against 3 memory rows the keys are
    reshaped by the query's batch, each query attending to all three
    rows' frames, in both packages."""
    jac = JL.AttnConfig(32, 4, 2, 8, causal=False, cross=True,
                        use_rope=False, d_kv_in=24)
    tac = TL.AttnConfig(32, 4, 2, 8, causal=False, cross=True,
                        use_rope=False, d_kv_in=24)
    shapes = jax.eval_shape(lambda: JL.init_attention(jax.random.PRNGKey(0),
                                                      jac))
    rng = np.random.default_rng(4)
    p = jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) / np.sqrt(s.shape[0])).astype(
            np.float32), shapes)
    tp = bridge.params_to_torch(p, device="cpu")
    init = TL.init_attention(torch.Generator().manual_seed(0), tac,
                             device="cpu")
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: tuple(v.shape) for k, v in p.items()}
    x = rng.normal(size=(rows, 5, 32)).astype(np.float32)
    mem = rng.normal(size=(B, 7, 24)).astype(np.float32)
    want = JL.attention(jax.tree_util.tree_map(jnp.asarray, p), jac, _j(x),
                        kv_src=_j(mem))
    got = TL.attention(tp, tac, _t(x), kv_src=_t(mem))
    assert got.shape == (rows, 5, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cp_attention_raises_not_ported():
    """Context-parallel attention, once refused here, is ported: it equals
    the reference's ``_sdpa_cp`` path (the full-sequence scores), and a
    cross attention never takes it, as in the reference."""
    tac = TL.AttnConfig(32, 4, 4, 8, causal=True, use_rope=True, cp=2)
    jac = JL.AttnConfig(32, 4, 4, 8, cp=2)
    p = TL.init_attention(torch.Generator().manual_seed(0), tac,
                          device="cpu")
    x = np.linspace(-1, 1, 4 * 32, dtype=np.float32).reshape(1, 4, 32)
    auto = (jax.sharding.AxisType.Auto,) * 2
    with jax.set_mesh(jax.make_mesh((1, 1), ("data", "model"),
                                    axis_types=auto)):
        want = JL.attention(jax.tree_util.tree_map(
            lambda t: jnp.asarray(t.numpy()), p), jac, _j(x))
    got = TL.attention(p, tac, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- the model ------------------------------------------------------------------
def test_encode_forward_and_loss_match_jax(weights):
    jp, tp = weights
    tok, fr = _tokens(), _frames()
    np.testing.assert_allclose(
        TED.encode(tp, TCFG, _t(fr)).numpy(),
        np.asarray(JED.encode(jp, JCFG, _j(fr))), **TOL_FWD)
    want = JED.forward(jp, JCFG, _j(tok), _j(fr))
    got = TED.forward(tp, TCFG, _t(tok).long(), _t(fr))
    assert got.dtype == torch.float32 and got.shape == (B, S, JCFG.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_FWD)
    lab = _tokens(seed=9)
    jl = JED.lm_loss(jp, JCFG, _j(tok), _j(lab), _j(fr))
    tl = TED.lm_loss(tp, TCFG, _t(tok).long(), _t(lab), _t(fr))
    np.testing.assert_allclose(float(tl), float(jl), **TOL_FWD)


def test_loss_gradients_match_jax(weights):
    jp, tp = weights
    tok, lab, fr = _tokens(), _tokens(seed=9), _frames()
    jg = jax.grad(lambda p: JED.lm_loss(p, JCFG, _j(tok), _j(lab),
                                        _j(fr)))(jp)
    tq = tree_map(lambda t: t.detach().clone().requires_grad_(True), tp)
    TED.lm_loss(tq, TCFG, _t(tok).long(), _t(lab), _t(fr)).backward()
    want = bridge.paths(jax.tree_util.tree_map(np.asarray, jg))
    got = {k: v.grad.numpy() for k, v in bridge.paths(tq).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.abs(want[k]).max() > 0, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_adapter_matches_jax(weights):
    """MACs, the forward's activations and logits, the layer views, and
    ``set_layer``: a new tree, the caller's tensors untouched."""
    jp, tp = weights
    tok, fr = _tokens(), _frames()
    ja = jadapters.encdec_adapter(JCFG, S, _j(fr))
    ta = tadapters.encdec_adapter(TCFG, S, _t(fr), device="cpu")
    assert list(ta.layer_fwd_macs) == list(ja.layer_fwd_macs)
    jx, jacts = ja.forward_collect(jp, _j(tok))
    tx, tacts = ta.forward_collect(tp, _t(tok).long())
    assert len(tacts) == len(jacts) == 4
    np.testing.assert_array_equal(tacts[0].numpy(), np.asarray(jacts[0]))
    for a, b in zip(tacts[1:], jacts[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL_FWD)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL_FWD)
    np.testing.assert_allclose(
        tx.numpy(), TED.forward(tp, TCFG, _t(tok).long(), _t(fr)).numpy(),
        rtol=0, atol=1e-6)
    for j in range(4):
        want = bridge.paths(jax.tree_util.tree_map(np.asarray,
                                                   ja.get_layer(jp, j)))
        got = bridge.paths(ta.get_layer(tp, j))
        assert sorted(got) == sorted(want), j
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    before = {k: v.clone() for k, v in bridge.paths(tp).items()}
    for j in range(4):
        sub = tree_map(lambda t: t + 1.0, ta.get_layer(tp, j))
        new = ta.set_layer(tp, j, sub)
        jnew = ja.set_layer(jp, j, jax.tree_util.tree_map(
            lambda a: a + 1.0, ja.get_layer(jp, j)))
        want = bridge.paths(jax.tree_util.tree_map(np.asarray, jnew))
        got = bridge.paths(new)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k, v in bridge.paths(tp).items():
        assert torch.equal(v, before[k]), k


def test_bf16_forward_matches_jax(weights):
    jp, tp = weights
    jc, tc = JCFG.with_(param_dtype="bfloat16"), TCFG.with_(
        param_dtype="bfloat16")
    jb = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp)
    tb = tree_map(lambda t: t.to(torch.bfloat16), tp)
    tok, fr = _tokens(4, seed=12), _frames(4, seed=13)
    jl = np.asarray(JED.forward(jb, jc, _j(tok), _j(fr)))
    tl = TED.forward(tb, tc, _t(tok).long(), _t(fr))
    assert tl.dtype == torch.float32
    assert TED.encode(tb, tc, _t(fr)).dtype == torch.bfloat16
    tl = tl.numpy()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=0.1)
    assert (np.abs(tl - jl) <= 2e-2 + 2e-2 * np.abs(jl)).mean() >= 0.99
    top2 = np.sort(jl, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 0.05
    assert clear.mean() >= 0.75
    np.testing.assert_array_equal(tl.argmax(-1)[clear], jl.argmax(-1)[clear])


# -- decode ---------------------------------------------------------------------
def test_decode_step_matches_jax_and_forward(weights):
    """``encode`` once, then S tokens one at a time through ``decode_step``
    against the decoder's KV caches, on both sides: the logits of each step
    and the caches after it, and the logits against the full forward."""
    jp, tp = weights
    tok, fr = _tokens(), _frames()
    jmem = JED.encode(jp, JCFG, _j(fr))
    tmem = TED.encode(tp, TCFG, _t(fr))
    jc = JED.init_cache(JCFG, B, S)
    tc = TED.init_cache(TCFG, B, S, device="cpu")
    assert {k: tuple(v.shape) for k, v in bridge.paths(tc).items()} == \
        {k: tuple(v.shape) for k, v in bridge.paths(jc).items()}
    outs = []
    for i in range(S):
        jl, jc = JED.decode_step(jp, JCFG, _j(tok[:, i:i + 1]), jc,
                                 jnp.int32(i), jmem)
        tl, tc = TED.decode_step(tp, TCFG, _t(tok[:, i:i + 1]).long(), tc,
                                 i, tmem)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL_FWD)
        outs.append(tl[:, 0])
    want = bridge.paths(jax.tree_util.tree_map(np.asarray, jc))
    for k, v in bridge.paths(tc).items():
        np.testing.assert_allclose(v.numpy(), want[k], **TOL, err_msg=k)
    full = TED.forward(tp, TCFG, _t(tok).long(), _t(fr))
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               **TOL_FWD)


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the host without one")
    with pytest.raises(RuntimeError, match="is_available"):
        TED.init_encdec(torch.Generator(), TCFG)
    with pytest.raises(RuntimeError, match="is_available"):
        TED.init_cache(TCFG, 1, 4)
    with pytest.raises(RuntimeError, match="is_available"):
        tadapters.encdec_adapter(TCFG, 4, torch.zeros(1, 32, 64))
