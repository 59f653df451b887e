"""The port's int8 calibration against the JAX package's, on the CPU.

``repro_torch.optim.compression`` must give the same codes, scale tables
and fake-quantised weights as ``repro.optim.compression`` BIT FOR BIT on
every leaf of a ResNet tree, compared by path after the bridge: each step
(max, one f32 multiply, one f32 divide, round half to even, clip) is
exact or correctly rounded on both sides, so there is nothing to tolerate.
The grouping is the reference's: the first axis of the HWIO leaf, which on
a 3×3 conv is the kernel row (three scales), not the output channel.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import vision as JV  # noqa: E402
from repro.optim import compression as jc  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.optim import compression as tc  # noqa: E402

torch.set_num_threads(2)
CFG = JV.ResNetConfig(width=8, n_classes=6, img_size=16)


def _jtree(t):
    return bridge.paths(jax.tree_util.tree_map(np.asarray, t))


def _ttree(t):
    return bridge.paths(bridge.params_to_numpy(t))


def _assert_same_bits(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, (k, got[k].shape, want[k].shape)
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].view(np.uint8),
                                      want[k].view(np.uint8), err_msg=k)


@pytest.fixture(scope="module", params=[0, 1], ids=["seed0", "seed1"])
def trees(request):
    """A width-8 ResNet tree from the reference's initialiser, with every
    leaf rescaled by a random power of two and noise on the GroupNorm
    vectors (init puts them at exactly 0 and 1)."""
    rng = np.random.default_rng(request.param)
    jp = JV.init_resnet(jax.random.PRNGKey(request.param), CFG)
    jp = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) * 2.0 ** rng.integers(-4, 4)
                              + rng.normal(size=x.shape) * 0.05, jnp.float32),
        jp)
    tp = bridge.params_to_torch(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    return jp, tp


@pytest.mark.parametrize("lead_axes", [1, 0, 2])
def test_q8_tree_bit_identical_to_reference(trees, lead_axes):
    jp, tp = trees
    jq, js = jc.q8_quantize_tree(jp, lead_axes=lead_axes)
    tq, ts = tc.q8_quantize_tree(tp, lead_axes=lead_axes)
    _assert_same_bits(_ttree(tq), _jtree(jq))
    _assert_same_bits(_ttree(ts), _jtree(js))
    _assert_same_bits(
        _ttree(tc.q8_fakequant_tree(tp, lead_axes=lead_axes)),
        _jtree(jc.q8_fakequant_tree(jp, lead_axes=lead_axes)))
    _assert_same_bits(_ttree(tc.q8_dequantize_tree(tq, ts, like=tp)),
                      _jtree(jc.q8_dequantize_tree(jq, js, like=jp)))
    assert all(q.dtype == torch.int8 and int(q.abs().max()) <= 127
               for q in bridge.paths(tq).values())


def test_grouping_is_the_references_not_per_output_channel(trees):
    """A 3×3 conv gets three scales (one per kernel row), the fc weight one
    per input row, a GroupNorm vector one per tensor."""
    jp, tp = trees
    _, js = jc.q8_quantize_tree(jp)
    _, ts = tc.q8_quantize_tree(tp)
    conv = tp["blocks"]["0"]["conv1"]
    cout, cin, kh, kw = conv.shape
    assert (kh, kw) == (3, 3) and cout == cin == 8
    assert tuple(ts["blocks"]["0"]["conv1"].shape) == (1, 1, 3, 1)
    assert js["blocks"]["0"]["conv1"].shape == (3, 1, 1, 1)
    d_in, d_out = tp["fc"]["w"].shape
    assert tuple(ts["fc"]["w"].shape) == (d_in, 1)
    assert tuple(ts["blocks"]["0"]["gn1"]["scale"].shape) == (1,)
    # a per-output-channel table would give cout scales: not the same grid
    per_cout = conv.abs().amax(dim=(1, 2, 3), keepdim=True) / 127
    assert not torch.equal(torch.round(conv / per_cout),
                           tc.q8_quantize(conv)[0].float())


@pytest.mark.parametrize("min_scale", [tc.Q8_MIN_SCALE, 1e-6])
def test_allzero_channel_gets_the_floor(min_scale):
    """An all-zero channel gets scale f32(min_scale) and codes 0, and
    dequantises to exact zeros, on both sides (HWIO kernel row 1 of a conv
    is zero, so is the port's axis-2 slice 1)."""
    w = np.random.default_rng(3).normal(size=(3, 3, 4, 5)).astype(np.float32)
    w[1] = 0.0
    fc = np.random.default_rng(4).normal(size=(6, 3)).astype(np.float32)
    fc[2] = 0.0
    for x in (w, fc, np.zeros(7, np.float32)):
        jq, js = jc.q8_quantize(jnp.asarray(x), min_scale=min_scale)
        tx = bridge.params_to_torch({"x": x}, device="cpu")["x"]
        tq, ts = tc.q8_quantize(tx, min_scale=min_scale)
        got = bridge.params_to_numpy({"q": tq, "s": ts})
        np.testing.assert_array_equal(got["q"], np.asarray(jq))
        np.testing.assert_array_equal(got["s"].view(np.uint32),
                                      np.asarray(js).view(np.uint32))
        zero = (x == 0).all(axis=tuple(range(1, x.ndim))) if x.ndim > 1 \
            else np.array([True])
        assert (got["s"].reshape(len(zero), -1)[zero]
                == np.float32(min_scale)).all()
        fq = tc.q8_fakequant(tx, min_scale=min_scale)
        assert (fq[tx == 0] == 0).all()


@pytest.mark.parametrize("bad", [-1, 1.5, "1", None])
def test_lead_axes_validation_matches_reference(bad):
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError) as got:
        tc.q8_scales(x, lead_axes=bad)
    with pytest.raises(ValueError) as want:
        jc.q8_scales(jnp.zeros((4, 3)), lead_axes=bad)
    assert str(got.value) == str(want.value)
    assert "lead_axes must be an int >= 0" in str(got.value)


def test_ties_saturation_and_nan_match_reference():
    """x / s on exact half steps rounds half to even; a NaN poisons its
    channel's scale and its codes come out 0 (XLA converts NaN to 0); the
    constants are the reference's."""
    s = np.float32(127.0) * np.float32(1.0 / 127.0)   # the scale of max 127
    row = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -127.0],
                   np.float32) * s
    x = np.stack([row, row * 3, np.full(8, np.nan, np.float32),
                  np.linspace(-1, 1, 8, dtype=np.float32)])
    x[3, 4] = np.nan
    jq, js = jc.q8_quantize(jnp.asarray(x))
    tq, ts = tc.q8_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(np.isnan(ts.numpy()),
                                  np.isnan(np.asarray(js)))
    assert s == 1.0 and tq[0].tolist() == [127, 0, 2, 2, 0, -2, 4, -127]
    assert (tq.numpy()[2:] == 0).all()
    assert tc.Q8_MIN_SCALE == jc.Q8_MIN_SCALE
    assert tc.INT8_SWEEP_RTOL == jc.INT8_SWEEP_RTOL == 0.10
