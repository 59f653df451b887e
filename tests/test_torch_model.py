"""The port's ResNet-18 against ``repro.models.vision`` on the same weights.

The JAX package initialises the weights; ``repro_torch.bridge`` carries
them over (HWIO -> OIHW conv weights, compared by path). Activations are
channels-first in the port, so they are transposed back before comparing.
Tolerance rtol 1e-5 / atol 1e-5: both sides compute in f32, but the
convolution and GroupNorm sums run in another order in each framework.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ficabu_vision as jcfgs  # noqa: E402
from repro.core import adapters as jadapters  # noqa: E402
from repro.models import vision as JV  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ficabu_vision as tcfgs  # noqa: E402
from repro_torch.core import adapters as tadapters  # noqa: E402
from repro_torch.models import vision as TV  # noqa: E402

torch.set_num_threads(2)
JCFG = JV.ResNetConfig(width=8, n_classes=6, img_size=16)
TCFG = TV.ResNetConfig(width=8, n_classes=6, img_size=16)


def _nhwc(t):
    a = t.detach().numpy()
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else a


@pytest.fixture(scope="module")
def weights():
    """Random weights of the reference's shapes (numpy-drawn: GroupNorm
    scales and biases away from 1 and 0, so they are exercised too)."""
    rng = np.random.default_rng(3)

    def draw(s):
        if len(s.shape) == 1:
            return (1.0 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)

    tree = jax.tree_util.tree_map(draw, jax.eval_shape(
        lambda: JV.init_resnet(jax.random.PRNGKey(0), JCFG)))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    return jp, tree, bridge.params_to_torch(tree, device="cpu")


def test_resnet_activations_and_logits_match_jax(weights):
    jp, _, tp = weights
    x = np.random.default_rng(0).normal(size=(4, 16, 16, 3)).astype(np.float32)
    jlog, jacts = jax.jit(lambda p, im: JV.resnet_forward(
        p, JCFG, im, collect=True))(jp, jnp.asarray(x))
    tlog, tacts = TV.resnet_forward(tp, TCFG, torch.from_numpy(x),
                                    collect=True)
    assert len(tacts) == len(jacts) == TV.RESNET_N_LAYERS
    np.testing.assert_array_equal(tacts[0].numpy(), x)  # images stay NHWC
    for j, (ja, ta) in enumerate(zip(jacts[1:], tacts[1:]), start=1):
        np.testing.assert_allclose(_nhwc(ta), np.asarray(ja), rtol=1e-5,
                                   atol=1e-5, err_msg=f"act {j}")
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-5,
                               atol=1e-5)


def test_stride2_same_padding_pads_low0_high1():
    """Regression: JAX "SAME" on a stride-2 3x3 conv over an even size pads
    (0, 1), not (1, 1). The port must match the reference, and symmetric
    padding=1 must not (else this test could not catch a regression)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 16, 8)).astype(np.float32)
    w = rng.normal(size=(3, 3, 8, 16)).astype(np.float32)
    want = np.asarray(JV.conv2d(jnp.asarray(w), jnp.asarray(x), stride=2))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    got = _nhwc(TV.conv2d(wt, xt, stride=2))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert TV.same_padding(16, 3, 2) == (0, 1)
    assert TV.same_padding(16, 3, 1) == (1, 1)
    assert TV.same_padding(16, 1, 2) == (0, 0)
    sym = _nhwc(torch.nn.functional.conv2d(xt, wt, stride=2, padding=1))
    assert np.abs(sym - want).max() > 1e-2


def test_bridge_round_trip_is_exact(weights):
    _, tree, tp = weights
    back = bridge.paths(bridge.params_to_numpy(tp))
    ref = bridge.paths(tree)
    assert sorted(back) == sorted(ref)
    for k, v in ref.items():
        assert back[k].shape == v.shape and back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_full_width_resnet18_matches_reference_structure():
    """RESNET18_CIFAR20 in the port: the reference's 56 leaves by path,
    11,177,300 parameters, each leaf the bridged reference shape, and the
    same per-layer MAC table."""
    jshapes = jax.eval_shape(lambda: JV.init_resnet(jax.random.PRNGKey(0),
                                                    jcfgs.RESNET18_CIFAR20))
    jpaths = bridge.paths(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), jshapes))
    tp = TV.init_resnet(torch.Generator().manual_seed(0),
                        tcfgs.RESNET18_CIFAR20, device="cpu")
    tpaths = bridge.paths(tp)
    assert sorted(tpaths) == sorted(jpaths) and len(tpaths) == 56
    assert sum(t.numel() for t in tpaths.values()) == 11_177_300
    for k, a in jpaths.items():
        want = a.shape if a.ndim != 4 else tuple(a.shape[i]
                                                 for i in (3, 2, 0, 1))
        assert tuple(tpaths[k].shape) == want, k
    assert tadapters._resnet_macs(tcfgs.RESNET18_CIFAR20) == \
        jadapters._resnet_macs(jcfgs.RESNET18_CIFAR20)


def test_layer_views_match_reference(weights):
    """resnet_layer_params / resnet_set_layer address the same subtrees, and
    set_layer leaves the caller's dicts untouched."""
    jp, _, tp = weights
    for j in range(TV.RESNET_N_LAYERS):
        assert sorted(bridge.paths(TV.resnet_layer_params(tp, j))) == \
            sorted(bridge.paths(jax.tree_util.tree_map(
                np.asarray, JV.resnet_layer_params(jp, j))))
    sub = {"w": torch.zeros(64, 6), "b": torch.zeros(6)}
    new = TV.resnet_set_layer(tp, 9, sub)
    assert new["fc"] is sub and tp["fc"] is not sub
    blk = TV.resnet_set_layer(tp, 3, {"x": torch.zeros(1)})
    assert "x" in blk["blocks"]["2"]
    assert "x" not in tp["blocks"]["2"]


def test_data_generators_match_reference():
    """The port's numpy copy of the classification generators gives the
    reference's arrays, splits and batches for the same seed."""
    from repro.data import synthetic as jsyn
    from repro_torch.data import synthetic as tsyn
    cfg = dict(n_classes=5, n_per_class=6, img_size=12, seed=4)
    jx, jy = jsyn.make_classification(jsyn.ClsDataConfig(**cfg))
    tx, ty = tsyn.make_classification(tsyn.ClsDataConfig(**cfg))
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    js, ts = (m.split_forget_retain(jx, jy, 1) for m in (jsyn, tsyn))
    for k in js:
        for a, b in zip(ts[k], js[k]):
            np.testing.assert_array_equal(a, b)
    jb = jsyn.Batches((jx, jy), batch=8, seed=2)
    tb = tsyn.Batches((tx, ty), batch=8, seed=2)
    for _ in range(5):
        for a, b in zip(next(tb), next(jb)):
            np.testing.assert_array_equal(a, b)
