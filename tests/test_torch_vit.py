"""The port's ViT against ``repro.models.vision`` / ``repro.models.layers``
on the same weights, module by module, on the CPU.

The weights are drawn with numpy in the reference's shapes (LayerNorm
scales away from 1, biases away from 0, so every leaf is exercised) and
carried over by ``repro_torch.bridge``; inputs come from a numpy seed. The
tiny ViT has 3 blocks, d_model 32, 2 heads of 16, d_ff 64, 16x16 images
and patch 4 (17 tokens). Tolerances, per tensor: both sides compute in
f32, but the products, the LayerNorm means and the softmax sums run in
another order in each framework, so

  * layernorm, attention, mlp and each layer: rtol 1e-5 / atol 1e-5;
  * the activations of ``vit_forward(collect=True)`` and the logits:
    rtol 1e-5 / atol 2e-5 (three blocks compound the per-layer error);
  * the ``cls_loss`` gradients: rtol 1e-4 / atol 1e-6 on every leaf.

Exact: the MAC tables, the tree structure (176 leaves and 7,120,340
parameters at VIT_CIFAR20), the bridge round trip, the int8 calibration
(codes and scale tables, bit for bit) and the grouped dampening plain
versions over a full-width block's 14 leaves.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ficabu_vision as jcfgs  # noqa: E402
from repro.core import adapters as jadapters  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import vision as JV  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ficabu_vision as tcfgs  # noqa: E402
from repro_torch.core import adapters as tadapters  # noqa: E402
from repro_torch.kernels import dampen as kd  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import vision as TV  # noqa: E402
from repro_torch.models.module import tree_leaves  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402

torch.set_num_threads(2)
TINY = dict(n_layers=3, d_model=32, n_heads=2, d_ff=64, n_classes=6,
            img_size=16, patch=4)
JCFG = JV.ViTConfig(**TINY)
TCFG = TV.ViTConfig(**TINY)
TOL = dict(rtol=1e-5, atol=1e-5)


def _jtree(t):
    return bridge.paths(jax.tree_util.tree_map(np.asarray, t))


def _ttree(t):
    return bridge.paths(bridge.params_to_numpy(t))


def _draw(rng):
    def draw(s):
        if len(s.shape) == 1:
            return (1.0 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        if len(s.shape) == 3:   # cls / pos
            return (0.5 * rng.normal(size=s.shape)).astype(np.float32)
        return (rng.normal(size=s.shape)
                / np.sqrt(s.shape[0])).astype(np.float32)
    return draw


@pytest.fixture(scope="module")
def weights():
    """(JAX tree, numpy tree, port tree) of the tiny ViT."""
    tree = jax.tree_util.tree_map(_draw(np.random.default_rng(5)),
                                  jax.eval_shape(lambda: JV.init_vit(
                                      jax.random.PRNGKey(0), JCFG)))
    return (jax.tree_util.tree_map(jnp.asarray, tree), tree,
            bridge.params_to_torch(tree, device="cpu"))


def _images(n=4, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, TCFG.img_size, TCFG.img_size, 3)).astype(np.float32)


def _tokens(seed=1):
    return np.random.default_rng(seed).normal(
        size=(4, TCFG.n_tokens, TCFG.d_model)).astype(np.float32)


def _tp(tree):
    return bridge.params_to_torch(tree, device="cpu")


def test_layernorm_matches_jax(weights):
    _, tree, tp = weights
    x = _tokens() * 3.0 + 1.5   # a mean and a spread far from 0 and 1
    p = tree["blocks"]["0"]["ln1"]
    want = JL.layernorm(jax.tree_util.tree_map(jnp.asarray, p),
                        jnp.asarray(x))
    got = TL.layernorm(_tp(p), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kv", [2, 1], ids=["mha", "gqa"])
def test_attention_matches_jax(weights, kv):
    """The ViT's attention (2 heads, q/k/v biases), and the grouped form
    the same block function computes when k/v have fewer heads."""
    rng = np.random.default_rng(2)
    jcfg = JL.AttnConfig(32, 2, kv, 16, causal=False, use_rope=False,
                         qkv_bias=True)
    tcfg = TL.AttnConfig(32, 2, kv, 16, qkv_bias=True)
    shapes = jax.eval_shape(lambda: JL.init_attention(jax.random.PRNGKey(0),
                                                      jcfg))
    p = jax.tree_util.tree_map(_draw(rng), shapes)
    assert sorted(p) == sorted(TL.init_attention(
        torch.Generator().manual_seed(0), tcfg, device="cpu"))
    x = _tokens()
    want = JL.attention(jax.tree_util.tree_map(jnp.asarray, p), jcfg,
                        jnp.asarray(x))
    got = TL.attention(_tp(p), tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mlp_matches_jax(weights):
    _, tree, _ = weights
    p = tree["blocks"]["1"]["ffn"]
    x = _tokens(3)
    want = JL.mlp(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    got = TL.mlp(_tp(p), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_refuses_what_the_vit_never_runs():
    """The ViT (65 tokens) never reaches the chunked branch of _sdpa (more
    than 2 * Q_CHUNK queries, a multiple of Q_CHUNK); the LM does, and the
    port runs it rather than raise: bidirectional attention over 3 *
    Q_CHUNK queries, as the ViT's attention calls it, equals the
    reference's chunked branch within TOL, and 2 * Q_CHUNK queries take
    the unchunked block on both sides."""
    rng = np.random.default_rng(13)
    for S in (3 * TL.Q_CHUNK, 2 * TL.Q_CHUNK):
        q, k, v = (rng.normal(size=(1, S, 2, 4)).astype(np.float32)
                   for _ in range(3))
        want = JL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.float32, False, 0)
        got = TL._sdpa(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), torch.float32)
        assert got.shape == (1, S, 2, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("j", [0, 2, TCFG.n_layers + 1],
                         ids=["patch", "block", "head"])
def test_vit_apply_layer_matches_jax(weights, j):
    jp, _, tp = weights
    x = _images() if j == 0 else _tokens(j)
    want = JV.vit_apply_layer(JV.vit_layer_params(jp, j, JCFG), j,
                              jnp.asarray(x), JCFG)
    got = TV.vit_apply_layer(TV.vit_layer_params(tp, j, TCFG), j,
                             torch.from_numpy(x), TCFG)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_patch_order_is_the_references():
    """A patch vector runs (p_h, p_w, c): with the identity as patch/w, the
    tokens are the raw patches, each at the reference's position."""
    D = TCFG.patch * TCFG.patch * 3
    cfg = TV.ViTConfig(**dict(TINY, d_model=D))
    x = torch.arange(2 * 16 * 16 * 3, dtype=torch.float32).reshape(
        2, 16, 16, 3)
    p = {"w": torch.eye(D), "b": torch.zeros(D),
         "cls": torch.zeros(1, 1, D), "pos": torch.zeros(1, 17, D)}
    t = TV.vit_apply_layer(p, 0, x, cfg)
    # token 1 + (row 1, column 2) of the 4x4 patch grid
    want = x[1, 4:8, 8:12, :].reshape(-1)
    assert torch.equal(t[1, 1 + 1 * 4 + 2], want)
    assert torch.equal(t[:, 0], torch.zeros(2, D))


def test_vit_forward_collect_matches_jax(weights):
    jp, _, tp = weights
    x = _images(6)
    jlog, jacts = jax.jit(lambda p, im: JV.vit_forward(
        p, JCFG, im, collect=True))(jp, jnp.asarray(x))
    tlog, tacts = TV.vit_forward(tp, TCFG, torch.from_numpy(x),
                                 collect=True)
    assert len(tacts) == len(jacts) == TCFG.n_layers + 2
    np.testing.assert_array_equal(tacts[0].numpy(), x)  # images stay NHWC
    for j, (ja, ta) in enumerate(zip(jacts[1:], tacts[1:]), start=1):
        assert tuple(ta.shape) == (6, TCFG.n_tokens, TCFG.d_model)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5,
                                   atol=2e-5, err_msg=f"act {j}")
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-5,
                               atol=2e-5)


def test_cls_loss_gradients_match_jax(weights):
    jp, _, tp = weights
    x = _images(8, seed=3)
    y = np.random.default_rng(4).integers(0, TCFG.n_classes, 8)
    jg = jax.grad(lambda p: JV.cls_loss(
        JV.vit_forward(p, JCFG, jnp.asarray(x)), jnp.asarray(y)))(jp)
    leaves = {k: t.clone().requires_grad_(True)
              for k, t in bridge.paths(tp).items()}
    tree = _rebuild(tp, leaves)
    loss = TV.cls_loss(TV.vit_forward(tree, TCFG, torch.from_numpy(x)),
                       torch.from_numpy(y))
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    want = _jtree(jg)
    assert sorted(grads) == sorted(want) and len(want) == 4 + 14 * 3 + 4
    for k, w in want.items():
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def _rebuild(like, by_path, prefix=""):
    return {k: (_rebuild(v, by_path, f"{prefix}{k}/")
                if isinstance(v, dict) else by_path[f"{prefix}{k}"])
            for k, v in like.items()}


@pytest.mark.parametrize("name", ["VIT_CIFAR20", "VIT_SMALL", "tiny"])
def test_vit_macs_match_reference(name):
    jc, tc = ((JCFG, TCFG) if name == "tiny"
              else (getattr(jcfgs, name), getattr(tcfgs, name)))
    assert tc == TV.ViTConfig(**{f: getattr(jc, f) for f in (
        "name", "n_classes", "n_layers", "d_model", "n_heads", "d_ff",
        "patch", "img_size", "param_dtype")})
    assert tadapters._vit_macs(tc) == jadapters._vit_macs(jc)


def test_full_width_vit_matches_reference_structure():
    """VIT_CIFAR20 in the port: the reference's 176 leaves by path, shapes
    unchanged (no leaf is 4-D), 7,120,340 parameters, the largest leaf
    147,456 elements, and the adapter's 14 layers of 4, 14 x 12 and 4
    leaves under the reference's layer keys."""
    jshapes = jax.eval_shape(lambda: JV.init_vit(jax.random.PRNGKey(0),
                                                 jcfgs.VIT_CIFAR20))
    jpaths = bridge.paths(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), jshapes))
    tp = TV.init_vit(torch.Generator().manual_seed(0), tcfgs.VIT_CIFAR20,
                     device="cpu")
    tpaths = bridge.paths(tp)
    assert sorted(tpaths) == sorted(jpaths) and len(tpaths) == 176
    for k, a in jpaths.items():
        assert tuple(tpaths[k].shape) == a.shape, k
        assert tpaths[k].is_contiguous(), k
    sizes = [t.numel() for t in tpaths.values()]
    assert sum(sizes) == 7_120_340 and max(sizes) == 147_456
    ja = jadapters.vit_adapter(jcfgs.VIT_CIFAR20)
    ta = tadapters.vit_adapter(tcfgs.VIT_CIFAR20, device="cpu")
    assert ta.n_layers == ja.n_layers == 14
    assert [len(tree_leaves(ta.get_layer(tp, j))) for j in range(14)] == \
        [4] + [14] * 12 + [4]
    assert [ta.layer_key(j) for j in range(14)] == \
        [ja.layer_key(j) for j in range(14)]
    assert ta.layer_ctx(tp, 3) is None


def test_layer_views_match_reference(weights):
    jp, _, tp = weights
    for j in range(TCFG.n_layers + 2):
        assert sorted(bridge.paths(TV.vit_layer_params(tp, j, TCFG))) == \
            sorted(_jtree(JV.vit_layer_params(jp, j, JCFG)))
    for j, where in ((0, "patch"), (TCFG.n_layers + 1, "head")):
        sub = {"x": torch.zeros(1)}
        new = TV.vit_set_layer(tp, j, sub, TCFG)
        assert new[where] is sub and tp[where] is not sub
    blk = TV.vit_set_layer(tp, 2, {"x": torch.zeros(1)}, TCFG)
    assert blk["blocks"]["1"] == {"x": torch.zeros(1)}
    assert "x" not in tp["blocks"]["1"]


def test_bridge_round_trip_keeps_vit_layouts(weights):
    """No ViT leaf is 4-D, so the bridge transposes nothing: the 3-D
    patch/cls [1, 1, D] and patch/pos [1, T, D] keep their layout, and the
    round trip is exact."""
    _, tree, tp = weights
    ref = bridge.paths(tree)
    got = bridge.paths(tp)
    back = bridge.paths(bridge.params_to_numpy(tp))
    assert sorted(back) == sorted(ref)
    assert tuple(got["patch/cls"].shape) == (1, 1, TCFG.d_model)
    assert tuple(got["patch/pos"].shape) == (1, TCFG.n_tokens, TCFG.d_model)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        assert back[k].shape == v.shape and back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("lead_axes", [1, 0])
def test_q8_tables_match_reference_on_vit_leaves(weights, lead_axes):
    """q8_scales / q8_quantize_tree / q8_fakequant_tree on every ViT leaf,
    bit for bit: the reference keeps each leaf's first axis, so a dense
    weight gets one scale per input row, and a LayerNorm vector, a bias,
    patch/cls and patch/pos (first axis of size 1) one scale each."""
    jp, _, tp = weights
    jq, js = jcomp.q8_quantize_tree(jp, lead_axes=lead_axes)
    tq, ts = tcomp.q8_quantize_tree(tp, lead_axes=lead_axes)
    want = {"q": _jtree(jq), "s": _jtree(js),
            "f": _jtree(jcomp.q8_fakequant_tree(jp, lead_axes=lead_axes))}
    got = {"q": _ttree(tq), "s": _ttree(ts),
           "f": _ttree(tcomp.q8_fakequant_tree(tp, lead_axes=lead_axes))}
    for part in want:
        assert sorted(got[part]) == sorted(want[part])
        for k, w in want[part].items():
            g = got[part][k]
            assert g.shape == w.shape and g.dtype == w.dtype, (part, k)
            np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                          err_msg=f"{part} {k}")
    for k in ("patch/cls", "patch/pos", "blocks/0/ln1/scale",
              "blocks/0/attn/bq", "head/b"):
        assert got["s"][k].size == 1, k
    if lead_axes == 1:
        assert got["s"]["blocks/0/ffn/w_down"].shape == (TCFG.d_ff, 1)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_grouped_dampen_over_a_vit_block_bit_equal(int8):
    """The plain versions of the grouped kernels over one full-width ViT
    block's 14 leaves (192 ... 147,456 elements) equal the reference's
    ``kernels.ops.dampen`` / ``dampen_int8`` leaf by leaf, bit for bit,
    masks and the selection count included."""
    cfg = tcfgs.VIT_CIFAR20
    blk = TV.init_vit(torch.Generator().manual_seed(1), cfg,
                      device="cpu")["blocks"]["4"]
    rng = np.random.default_rng(9 + int8)
    thetas, i_fs, i_gs = [], [], []
    for leaf in tree_leaves(blk):
        n = leaf.numel()
        i_g = (np.abs(rng.normal(size=n)) + 1e-6).astype(np.float32)
        i_f = (rng.uniform(size=n) * 10 * i_g).astype(np.float32)
        i_f[::89] = np.float32(5.0) * i_g[::89]     # ties: never selected
        th = leaf.numpy().reshape(-1) + rng.normal(size=n).astype(np.float32)
        if int8:
            th = tcomp.q8_quantize(torch.from_numpy(th))[0].numpy()
        thetas.append(torch.from_numpy(th).view(leaf.shape))
        i_fs.append(torch.from_numpy(i_f).view(leaf.shape))
        i_gs.append(torch.from_numpy(i_g).view(leaf.shape))
    assert len(thetas) == 14
    fn = kd.dampen_int8_group_ref if int8 else kd.dampen_group_ref
    jfn = jops.dampen_int8 if int8 else jops.dampen
    got, masks, count = fn(thetas, i_fs, i_gs, 5.0, 1.0)
    n_sel = 0
    for th, i_f, i_g, new, mask in zip(thetas, i_fs, i_gs, got, masks):
        args = [jnp.asarray(t.numpy()) for t in (th, i_f, i_g)]
        if int8:
            want = jfn(*args, 5.0, 1.0)
            want_mask = args[1] > np.float32(5.0) * args[2]
        else:
            want, want_mask = jfn(*args, 5.0, 1.0)
        assert new.dtype == th.dtype and new.shape == th.shape
        np.testing.assert_array_equal(
            new.numpy().view(np.uint8), np.asarray(want).view(np.uint8))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
        n_sel += int(jnp.sum(want_mask))
    assert int(count) == n_sel > 0


def test_suffix_runner_matches_per_depth(weights):
    """The one depth-operand checkpoint runner equals the runner of each
    depth, bit for bit, and is built once for every j >= 1; the ViT's
    activations are shape-uniform, so the engine takes it."""
    from repro_torch.engine import UnlearnSession
    _, _, tp = weights
    adapter = tadapters.vit_adapter(TCFG, device="cpu")
    sess = UnlearnSession(adapter, tp)
    x = torch.from_numpy(_images(8, seed=6))
    y = torch.from_numpy(np.random.default_rng(7).integers(0, 6, 8))
    _, acts = adapter.forward_collect(tp, x)
    assert sess._uniform_suffix(acts)
    for j in range(1, adapter.n_layers):
        got = sess.partial_acc(j, tp, acts[j], y, uniform=True)
        want = sess.partial_acc(j, tp, acts[j], y, uniform=False)
        assert torch.equal(got, want), j
    assert sess.stats["partial_compiles"] == 1 + (adapter.n_layers - 1)
    assert sess.stats["partial_hits"] == adapter.n_layers - 2
    # depth 0 takes the images, so it keeps its own runner
    sess.partial_acc(0, tp, acts[0], y, uniform=True)
    assert sess.stats["partial_compiles"] == adapter.n_layers + 1
