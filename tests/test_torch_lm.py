"""The port's dense decoder LM against ``repro.models.lm`` /
``repro.models.layers`` on the same weights, module by module, on the CPU.

The weights are drawn with numpy in the reference's shapes (RMSNorm scales
away from 1, so every leaf is exercised) and carried over by
``repro_torch.bridge``; token ids and activations come from a numpy seed.
The tiny gemma3-shaped LM has 5 blocks of pattern ("local", "attn") — two
stacked periods and one tail block — d_model 32, 4 heads over 2 KV heads
of 8, d_ff 64, vocab 64, window 4 over 12 tokens (so local blocks differ
from global ones), tied embeddings; an untied twin covers ``lm_head``.
Tolerances, per tensor: both sides compute in f32, but the products, the
RMSNorm means, RoPE's angles and the softmax sums run in another order in
each framework, so

  * rmsnorm, apply_rope, attention (causal, local, GQA), mlp and one block:
    rtol 1e-5 / atol 1e-5;
  * the activations of the adapter's ``forward_collect``, ``forward``'s
    logits and ``lm_loss``: rtol 1e-5 / atol 2e-5 (five blocks compound the
    per-layer error);
  * the ``lm_loss`` gradients: rtol 1e-4 / atol 1e-6 on every leaf;
  * a bf16 forward (weights and activations in bf16, products and logits in
    f32): the logits within rtol 2e-2 / atol 2e-2 on at least 99% of the
    entries and within atol 0.1 on all, and the argmax equal on at least
    99% of the positions — one bf16 rounding of a sum that differs in its
    last f32 bit moves a value by up to 2^-8 relative, and five blocks
    compound it.

Exact: the MAC tables, the tree structure (74 stored leaves, 236 layer
leaves and 999,812,736 parameters at gemma3-1b FULL, counted with
``jax.eval_shape`` on the reference), the layer views and ``set_layer``
(the caller's dicts and tensors untouched), the bridge round trip, the
synthetic token streams, and the configs of the registry.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import gemma3_1b as jgemma  # noqa: E402
from repro.configs import qwen1_5_32b as jqwen  # noqa: E402
from repro.configs import yi_6b as jyi6  # noqa: E402
from repro.configs import yi_9b as jyi9  # noqa: E402
from repro.core import adapters as jadapters  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import adapters as tadapters  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models.module import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(2)
TINY = dict(name="t-lm", n_layers=5, d_model=32, n_heads=4, n_kv_heads=2,
            d_ff=64, vocab=64, block_pattern=("local", "attn"), window=4,
            tie_embeddings=True)
S = 12
TOL = dict(rtol=1e-5, atol=1e-5)
TOL_FWD = dict(rtol=1e-5, atol=2e-5)


def _cfgs(**kw):
    return (JLM.LMConfig(**dict(TINY, **kw)),
            TLM.LMConfig(**dict(TINY, **kw)))


def _jtree(t):
    return bridge.paths(jax.tree_util.tree_map(np.asarray, t))


def _tp(tree):
    return bridge.params_to_torch(tree, device="cpu")


def _draw(rng):
    def draw(s):
        if len(s.shape) == 1 or (len(s.shape) == 2 and s.shape[0] == 2
                                 and s.shape[1] == 32):
            # norm scales, stacked or not
            return (1.0 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        return (rng.normal(size=s.shape)
                / np.sqrt(s.shape[-2])).astype(np.float32)
    return draw


def _weights(seed=5, **kw):
    jc, _ = _cfgs(**kw)
    tree = jax.tree_util.tree_map(_draw(np.random.default_rng(seed)),
                                  jax.eval_shape(lambda: JLM.init_lm(
                                      jax.random.PRNGKey(0), jc)))
    return jax.tree_util.tree_map(jnp.asarray, tree), tree, _tp(tree)


@pytest.fixture(scope="module")
def weights():
    """(JAX tree, numpy tree, port tree) of the tiny tied LM."""
    return _weights()


@pytest.fixture(scope="module")
def untied():
    return _weights(seed=6, tie_embeddings=False)


def _acts(n=3, seed=1):
    return np.random.default_rng(seed).normal(
        size=(n, S, TINY["d_model"])).astype(np.float32)


def _tokens(n=3, seed=2):
    return np.random.default_rng(seed).integers(
        0, TINY["vocab"], (n, S)).astype(np.int32)


def _pos(n=3):
    return np.broadcast_to(np.arange(S)[None], (n, S)).astype(np.int32)


def test_rmsnorm_matches_jax(weights):
    _, tree, _ = weights
    x = _acts() * 3.0 + 1.5
    p = tree["tail"]["0"]["ln1"]
    want = JL.rmsnorm(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    got = TL.rmsnorm(_tp(p), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_apply_rope_matches_jax(theta):
    """Split halves (not interleaved), angles in f32; positions run to 40
    so that the angles wrap."""
    x = np.random.default_rng(3).normal(size=(2, 41, 3, 16)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(41)[None], (2, 41)).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(TL.rope_freqs(16, theta).numpy(),
                               np.asarray(JL.rope_freqs(16, theta)),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind,kv", [("attn", 2), ("local", 2),
                                     ("attn", 4), ("local", 1)],
                         ids=["causal-gqa", "local-gqa", "causal-mha",
                              "local-mqa"])
def test_attention_matches_jax(kind, kv):
    """Causal and sliding-window attention with RoPE, grouped (4 heads over
    2 or 1 KV heads) and not."""
    jc, tc = _cfgs(n_kv_heads=kv)
    jac, tac = jc.attn_cfg(kind), tc.attn_cfg(kind)
    assert (tac.causal, tac.use_rope, tac.window) == \
        (jac.causal, jac.use_rope, jac.window)
    rng = np.random.default_rng(4)
    p = jax.tree_util.tree_map(_draw(rng), jax.eval_shape(
        lambda: JL.init_attention(jax.random.PRNGKey(0), jac)))
    x = _acts()
    want = JL.attention(jax.tree_util.tree_map(jnp.asarray, p), jac,
                        jnp.asarray(x), jnp.asarray(_pos()))
    got = TL.attention(_tp(p), tac, torch.from_numpy(x),
                       torch.from_numpy(_pos()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # positions default to 0..S-1
    np.testing.assert_array_equal(
        TL.attention(_tp(p), tac, torch.from_numpy(x)).numpy(), got.numpy())


def test_window_mask_is_the_references():
    """A query sees the keys ik with iq - window < ik <= iq: with v the
    one-hot of the key position and equal scores, each output row is the
    mean over exactly those keys."""
    Sq, W = 9, 3
    v = torch.zeros(1, Sq, 1, Sq)
    v[0, :, 0] = torch.eye(Sq)
    out = TL._sdpa_block(torch.zeros(1, Sq, 1, Sq), torch.zeros(1, Sq, 1, Sq),
                         v, torch.float32, True, W)[0, :, 0]
    for iq in range(Sq):
        keys = [ik for ik in range(Sq) if iq - W < ik <= iq]
        want = torch.zeros(Sq)
        want[keys] = 1.0 / len(keys)
        torch.testing.assert_close(out[iq], want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("where", ["stack", "tail"])
def test_block_matches_jax(weights, where):
    jp, _, tp = weights
    jc, tc = _cfgs()
    j = 2 if where == "stack" else 5           # an "attn" and a "local"
    x = _acts(seed=7)
    want = JLM.apply_layer(jp, jc, j, JLM.get_layer(jp, jc, j),
                           jnp.asarray(x), jnp.asarray(_pos()))
    got = TLM.apply_layer(tp, tc, j, TLM.get_layer(tp, tc, j),
                          torch.from_numpy(x), torch.from_numpy(_pos()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mlp_matches_jax(weights):
    _, tree, _ = weights
    p = tree["tail"]["0"]["ffn"]
    x = _acts(seed=8)
    want = JL.mlp(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    got = TL.mlp(_tp(p), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_forward_and_collect_match_jax(weights, untied, tied):
    jp, _, tp = weights if tied else untied
    jc, tc = _cfgs(tie_embeddings=tied)
    tok = _tokens(4)
    jlog, jaux = JLM.forward(jp, jc, jnp.asarray(tok))
    tlog, taux = TLM.forward(tp, tc, torch.from_numpy(tok))
    assert tlog.dtype == torch.float32 and float(taux) == float(jaux) == 0.0
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL_FWD)
    ja = jadapters.lm_adapter(jc, S)
    ta = tadapters.lm_adapter(tc, S, device="cpu")
    jx, jacts = ja.forward_collect(jp, jnp.asarray(tok))
    tx, tacts = ta.forward_collect(tp, torch.from_numpy(tok))
    assert len(tacts) == len(jacts) == tc.n_layers + 2
    # the layer-0 input is the token ids themselves, never cast
    assert tacts[0].dtype == torch.int32
    np.testing.assert_array_equal(tacts[0].numpy(), tok)
    for j, (a, b) in enumerate(zip(jacts[1:], tacts[1:]), start=1):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL_FWD,
                                   err_msg=f"act {j}")
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL_FWD)
    np.testing.assert_array_equal(tx.numpy(), tlog.numpy())
    # the adapter's loss has no z-loss, lm_loss has 1e-4
    lbl = _tokens(4, seed=9)
    for z, (jl, tl) in (
            (0.0, (ja.loss(jx, jnp.asarray(lbl)),
                   ta.loss(tx, torch.from_numpy(lbl)))),
            (1e-4, (JLM.lm_loss(jp, jc, jnp.asarray(tok), jnp.asarray(lbl)),
                    TLM.lm_loss(tp, tc, torch.from_numpy(tok),
                                torch.from_numpy(lbl))))):
        np.testing.assert_allclose(float(tl), float(jl), **TOL_FWD,
                                   err_msg=f"z_loss {z}")
    assert float(TLM.softmax_xent(tx, torch.from_numpy(lbl))) > \
        float(ta.loss(tx, torch.from_numpy(lbl)))


def _rebuild(like, by_path, prefix=""):
    return {k: (_rebuild(v, by_path, f"{prefix}{k}/")
                if isinstance(v, dict) else by_path[f"{prefix}{k}"])
            for k, v in like.items()}


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_lm_loss_gradients_match_jax(weights, untied, tied):
    jp, _, tp = weights if tied else untied
    jc, tc = _cfgs(tie_embeddings=tied)
    tok, lbl = _tokens(4, seed=10), _tokens(4, seed=11)
    jg = jax.grad(lambda p: JLM.lm_loss(p, jc, jnp.asarray(tok),
                                        jnp.asarray(lbl)))(jp)
    leaves = {k: t.clone().requires_grad_(True)
              for k, t in bridge.paths(tp).items()}
    loss = TLM.lm_loss(_rebuild(tp, leaves), tc, torch.from_numpy(tok),
                       torch.from_numpy(lbl))
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    want = _jtree(jg)
    assert sorted(grads) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_layer_views_and_set_layer(weights):
    """get_layer over period_stack (views into the stacked leaves), the
    tail, the embedding and the head; set_layer returns a new tree and
    leaves the caller's dicts and tensors as they were, as the
    reference's .at[i].set does."""
    jp, _, tp = weights
    jc, tc = _cfgs()
    L = TLM.n_unlearn_layers(tc)
    assert L == JLM.n_unlearn_layers(jc) == 7
    for j in range(L):
        got = bridge.paths(TLM.get_layer(tp, tc, j))
        want = _jtree(JLM.get_layer(jp, jc, j))
        assert sorted(got) == sorted(want), j
        for k, w in want.items():
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=(j, k))
    # block 3 (j = 3) is period 1's "local" block: a view of the stack
    view = TLM.get_layer(tp, tc, 3)["mixer"]["wq"]
    assert view.data_ptr() == tp["period_stack"]["0"]["mixer"]["wq"][1] \
        .data_ptr()
    before = {k: v.clone() for k, v in bridge.paths(tp).items()}
    stack_dict = tp["period_stack"]["0"]
    for j in (3, 5, 0, L - 1):
        sub = tree_map(lambda x: x + 1.0, TLM.get_layer(tp, tc, j))
        jsub = jax.tree_util.tree_map(lambda x: x + 1.0,
                                      JLM.get_layer(jp, jc, j))
        new = TLM.set_layer(tp, tc, j, sub)
        want = _jtree(JLM.set_layer(jp, jc, j, jsub))
        got = bridge.paths(new)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=(j, k))
        for k, v in bridge.paths(tp).items():
            assert torch.equal(v, before[k]), (j, k)
    assert tp["period_stack"]["0"] is stack_dict
    # the new stacked leaf is a new tensor; the caller's still holds row 1
    new = TLM.set_layer(tp, tc, 3, TLM.get_layer(tp, tc, 3))
    assert new["period_stack"]["0"]["mixer"]["wq"].data_ptr() != \
        tp["period_stack"]["0"]["mixer"]["wq"].data_ptr()
    assert new["tail"] is tp["tail"] and new["embed"] is tp["embed"]


@pytest.mark.parametrize("which", ["tiny", "smoke", "full", "window",
                                   "yi-6b", "qwen1.5-32b"])
def test_lm_layer_macs_match_reference(which):
    """The MAC tables, gemma3-1b's and the dense GQA archs' FULL configs
    at S = 1024 and past the query-chunked attention's threshold (1536,
    2048)."""
    if which == "tiny":
        jc, tc = _cfgs()
        seqs = (S, 3)
    elif which == "window":
        jc, tc = _cfgs(window=64)
        seqs = (S, 128)
    elif which in ("yi-6b", "qwen1.5-32b"):
        jc = {"yi-6b": jyi6, "qwen1.5-32b": jqwen}[which].FULL
        tc = tconfigs.get(which).full
        seqs = (1024, 1536, 2048)
    else:
        jc = getattr(jgemma, which.upper())
        tc = getattr(tconfigs.get("gemma3-1b"), which)
        seqs = (1024, 17, 4096, 1536, 2048)
    for s in seqs:
        assert tadapters.lm_layer_macs(tc, s) == jadapters.lm_layer_macs(jc, s)
        assert tadapters.lm_adapter(tc, s, device="cpu").layer_fwd_macs == \
            list(jadapters.lm_adapter(jc, s).layer_fwd_macs)


def test_registry_configs_equal_the_references():
    """The FULL and SMOKE configs of gemma3-1b and the dense GQA archs
    field by field, with their kind, source and shape cells (the recurrent
    archs' are held in tests/test_torch_recurrent.py, whisper-tiny's in
    tests/test_torch_encdec.py); all ten of the reference's archs are
    registered, and an unknown one raises a KeyError naming them."""
    for arch, jmod in (("gemma3-1b", jgemma), ("yi-6b", jyi6),
                       ("yi-9b", jyi9), ("qwen1.5-32b", jqwen)):
        spec = tconfigs.get(arch)
        for name in ("full", "smoke"):
            jcfg, tcfg = getattr(jmod, name.upper()), getattr(spec, name)
            assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg), \
                (arch, name)
            assert tcfg.dtype == getattr(torch, jcfg.param_dtype)
        assert (spec.kind, spec.source, spec.shapes(), spec.skip_shapes) == \
            (jmod.SPEC.kind, jmod.SPEC.source, jmod.SPEC.shapes(),
             jmod.SPEC.skip_shapes), arch
    assert sorted(tconfigs.all_archs()) == [
        "gemma3-1b", "internvl2-1b", "kimi-k2-1t-a32b",
        "llama4-scout-17b-a16e", "qwen1.5-32b", "recurrentgemma-9b",
        "whisper-tiny", "xlstm-125m", "yi-6b", "yi-9b"]
    with pytest.raises(KeyError, match="yi-6b"):
        tconfigs.get("whisper-large")
    assert tconfigs.SHAPES["train_4k"].seq_len == 4096


def test_full_width_structure_matches_reference():
    """gemma3-1b FULL: the reference's tree (jax.eval_shape) holds 74 leaves
    and 999,812,736 parameters; the port's adapter over a tree of those
    shapes sees 28 unlearn layers of 236 leaves under the reference's layer
    keys, and its SMOKE tree equals the reference's path by path."""
    jshapes = jax.eval_shape(lambda: JLM.init_lm(jax.random.PRNGKey(0),
                                                 jgemma.FULL))
    sizes = [int(np.prod(s.shape)) for s in
             jax.tree_util.tree_leaves(jshapes)]
    assert len(sizes) == 74 and sum(sizes) == 999_812_736
    tree = jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, dtype=torch.bfloat16, device="meta"),
        jshapes)
    tc = tconfigs.get("gemma3-1b").full
    ta = tadapters.lm_adapter(tc, 1024, device="cpu")
    ja = jadapters.lm_adapter(jgemma.FULL, 1024)
    assert ta.n_layers == ja.n_layers == 28
    assert sum(len(tree_leaves(ta.get_layer(tree, j)))
               for j in range(28)) == 236
    assert [ta.layer_key(j) for j in range(28)] == \
        [ja.layer_key(j) for j in range(28)]
    assert ta.layer_ctx(tree, 27) == {"embed": tree["embed"]}
    assert ta.layer_ctx(tree, 26) is None and ta.int_input_layer0
    smoke = tconfigs.get("gemma3-1b").smoke
    tp = TLM.init_lm(torch.Generator().manual_seed(0), smoke, device="cpu")
    jsm = bridge.paths(jax.eval_shape(lambda: JLM.init_lm(
        jax.random.PRNGKey(0), jgemma.SMOKE)))
    got = bridge.paths(tp)
    assert sorted(got) == sorted(jsm)
    for k, s in jsm.items():
        assert tuple(got[k].shape) == tuple(s.shape), k
        assert got[k].is_contiguous() and got[k].dtype == torch.float32, k


def test_unported_parts_raise():
    """An unknown block type is not ported: it raises a ValueError that
    says so (the recurrent blocks are ported: tests/test_torch_recurrent.py;
    MoE and the modality prefix: tests/test_torch_moe.py,
    tests/test_torch_prefix.py). Context-parallel attention and the MoE's
    expert-parallel sharding constraints are ported: the model and its
    adapter build, and at this length (the query-chunked walk starts past
    1024 queries) their forward equals the plain config's bit for bit
    (against the reference: tests/test_torch_shard.py)."""
    _, tc = _cfgs(block_pattern=("moe_block", "attn"))
    with pytest.raises(ValueError, match="not ported yet"):
        TLM.init_lm(torch.Generator().manual_seed(0), tc, device="cpu")
    with pytest.raises(ValueError, match="not ported yet"):
        tadapters.lm_adapter(tc, S, device="cpu")
    moe = TLM.MoESpec(num_experts=4, top_k=2)
    tok = torch.arange(2 * S).reshape(2, S) % TINY["vocab"]
    for kw, off in (({"cp_attention": 2}, {"cp_attention": 0}),
                    ({"moe": moe, "moe_shard_constraints": True},
                     {"moe_shard_constraints": False})):
        _, tc = _cfgs(**kw)
        p = TLM.init_lm(torch.Generator().manual_seed(0), tc, device="cpu")
        tadapters.lm_adapter(tc, S, device="cpu")
        got = TLM.forward(p, tc, tok)[0]
        want = TLM.forward(p, tc.with_(**off), tok)[0]
        assert torch.equal(got, want), kw


@pytest.mark.parametrize("seed", [0, 3])
def test_lm_domains_equal_the_references(seed):
    cfg = dict(vocab=96, n_domains=3, seq_len=20, n_per_domain=5, seed=seed)
    jt, jd = jsyn.make_lm_domains(jsyn.LMDataConfig(**cfg))
    tt, td = tsyn.make_lm_domains(tsyn.LMDataConfig(**cfg))
    assert tt.dtype == jt.dtype and td.dtype == jd.dtype
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(td, jd)
    for d in range(3):
        js = jsyn.lm_split_forget_retain(jt, jd, d)
        ts = tsyn.lm_split_forget_retain(tt, td, d)
        assert sorted(ts) == sorted(js) == ["forget", "heldout", "retain"]
        for k in js:
            np.testing.assert_array_equal(ts[k], js[k], err_msg=(d, k))


def test_bridge_round_trip_keeps_lm_layouts(weights):
    """The LM has no 4-D leaf: the stacked [2, d_in, d_out] dense weights
    and [2, d] norm scales cross unchanged, and the round trip is exact."""
    _, tree, tp = weights
    ref = bridge.paths(tree)
    got = bridge.paths(tp)
    back = bridge.paths(bridge.params_to_numpy(tp))
    assert sorted(back) == sorted(ref) and len(ref) == 2 * 9 + 9 + 2
    assert tuple(got["period_stack/0/mixer/wq"].shape) == (2, 32, 32)
    assert tuple(got["period_stack/1/ln2/scale"].shape) == (2, 32)
    for k, v in ref.items():
        assert v.ndim <= 3, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_bf16_forward_matches_jax(weights):
    """bf16 parameters (the FULL config's dtype): the activations stay
    bf16, the logits are f32, and they agree within the declared bf16
    tolerance (module docstring)."""
    jp, tree, _ = weights
    jc, tc = _cfgs(param_dtype="bfloat16")
    jb = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp)
    tb = tree_map(lambda t: t.to(torch.bfloat16), _tp(tree))
    tok = _tokens(4, seed=12)
    jlog, _ = JLM.forward(jb, jc, jnp.asarray(tok))
    tlog, _ = TLM.forward(tb, tc, torch.from_numpy(tok))
    assert tlog.dtype == torch.float32
    ta = tadapters.lm_adapter(tc, S, device="cpu")
    _, acts = ta.forward_collect(tb, torch.from_numpy(tok))
    assert all(a.dtype == torch.bfloat16 for a in acts[1:])
    jl, tl = np.asarray(jlog), tlog.numpy()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=0.1)
    assert (np.abs(tl - jl) <= 2e-2 + 2e-2 * np.abs(jl)).mean() >= 0.99
    same = (tlog.numpy().argmax(-1) == jl.argmax(-1)).mean()
    assert same >= 0.99, same
