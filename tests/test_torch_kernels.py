"""The port's dampening wrapper against the JAX package's, on the CPU.

Here (no card) ``repro_torch.kernels.ops.dampen`` takes its plain PyTorch
version, ``dampen_ref``; the JAX side runs its Pallas kernel in interpret
mode, as tests/test_kernels.py does, and its pure-jnp oracle. The same
numpy inputs go to both, and theta' and the mask must agree BIT FOR BIT:
every step is one correctly rounded f32 operation, so there is nothing to
tolerate. (The CUDA kernel itself is held bit-exact against ``dampen_ref``
on the card by chip_smoke.py.)
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core.ssd import dampen_array  # noqa: E402
from repro_torch.kernels import dampen as tdampen  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

torch.set_num_threads(2)
RNG = np.random.default_rng(11)

PAIRS = [(2.0, 0.5), (10.0, 1.0), (0.5, 0.1)]   # tests/test_kernels.py:34
SHAPES = [(64,), (1000,), (77,), (12345,), (3, 3, 8, 16)]
DTYPES = {"float32": (torch.float32, jnp.float32, np.uint32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, np.uint16)}


def _bits(x, view):
    """Raw bits of a numpy/JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16 if view == np.uint16 else torch.int32).numpy()
    return np.asarray(x).view(view)


def _inputs(shape):
    th = RNG.normal(size=shape).astype(np.float32)
    i_f = (np.abs(RNG.normal(size=shape)) + 1e-6).astype(np.float32)
    i_g = (np.abs(RNG.normal(size=shape)) + 1e-6).astype(np.float32)
    return th, i_f, i_g


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("alpha,lam", PAIRS)
def test_dampen_bit_exact_against_jax(shape, dtype, alpha, lam):
    tdt, jdt, view = DTYPES[dtype]
    th, i_f, i_g = _inputs(shape)
    th_j = jnp.asarray(th, jdt)
    th_t = torch.from_numpy(th).to(tdt)
    np.testing.assert_array_equal(_bits(th_t, view), _bits(th_j, view))

    got, mask = ops.dampen(th_t, torch.from_numpy(i_f), torch.from_numpy(i_g),
                           alpha, lam)
    want, want_mask = jops.dampen(th_j, jnp.asarray(i_f), jnp.asarray(i_g),
                                  alpha, lam)
    oracle = jref.dampen_ref(th_j, jnp.asarray(i_f), jnp.asarray(i_g),
                             alpha, lam)
    assert got.dtype == tdt and tuple(got.shape) == shape
    assert mask.dtype == torch.bool
    np.testing.assert_array_equal(_bits(got, view), _bits(want, view))
    np.testing.assert_array_equal(_bits(got, view), _bits(oracle, view))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))


def test_dampen_edge_cases_against_jax():
    """Ties at the threshold, zeros, NaN/inf operands and n = 1 agree with
    the reference oracle (NaN positions equal, all other bits equal)."""
    alpha, lam = 2.0, 0.5
    i_g = np.array([1.0, 0.0, 0.0, 2.0, np.nan, 1.0, np.inf, 1.0, 3.0],
                   np.float32)
    i_f = np.array([2.0, 0.0, 1.0, np.inf, 1.0, np.nan, 1.0, 5.0, 6.0],
                   np.float32)   # [0] and [8] sit exactly on alpha * i_g
    th = np.array([1.5, -2.0, 3.0, np.inf, 4.0, np.nan, -1.0, -0.0, 7.0],
                  np.float32)
    for sl in (slice(None), slice(0, 1)):
        got, mask = ops.dampen(torch.from_numpy(th[sl]),
                               torch.from_numpy(i_f[sl]),
                               torch.from_numpy(i_g[sl]), alpha, lam)
        want = np.asarray(jref.dampen_ref(jnp.asarray(th[sl]),
                                          jnp.asarray(i_f[sl]),
                                          jnp.asarray(i_g[sl]), alpha, lam))
        g = got.numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(want))
        ok = ~np.isnan(want)
        np.testing.assert_array_equal(g[ok].view(np.uint32),
                                      want[ok].view(np.uint32))
        np.testing.assert_array_equal(mask.numpy(),
                                      i_f[sl] > np.float32(alpha) * i_g[sl])
    assert not mask[0]  # a tie is not selected (strict >)


def test_dampen_nan_lambda_propagates():
    """A NaN scale reaches every selected weight, as jnp.minimum lets it —
    fminf-style clamping to 1 would hide it."""
    th, i_f, i_g = _inputs((257,))
    i_f[::2] = 10.0 * i_g[::2] + 1.0
    got, mask = ops.dampen(torch.from_numpy(th), torch.from_numpy(i_f),
                           torch.from_numpy(i_g), 2.0, float("nan"))
    want = np.asarray(jref.dampen_ref(jnp.asarray(th), jnp.asarray(i_f),
                                      jnp.asarray(i_g), 2.0, float("nan")))
    m = mask.numpy()
    assert m.any() and np.isnan(got.numpy()[m]).all()
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    np.testing.assert_array_equal(got.numpy()[~m], th[~m])


def test_dampen_rejects_mismatched_shapes():
    th = torch.zeros(8)
    with pytest.raises(ValueError, match="elementwise"):
        ops.dampen(th, torch.zeros(9), torch.zeros(8), 2.0, 0.5)
    with pytest.raises(ValueError, match="elementwise"):
        ops.dampen(th, torch.zeros(8), torch.zeros(2, 4), 2.0, 0.5)


def test_cpu_path_matches_core_ssd_and_launches_nothing():
    """On the CPU the wrapper is the plain version (core.ssd.dampen_array,
    bit for bit) and the kernel's launch counter does not move."""
    th, i_f, i_g = (torch.from_numpy(a) for a in _inputs((513,)))
    before = tdampen.LAUNCHES
    kout, kmask = ops.dampen(th, i_f, i_g, 3.0, 0.7)
    cout, cmask = dampen_array(th, i_f, i_g, 3.0, 0.7)
    assert tdampen.LAUNCHES == before
    assert torch.equal(kout, cout) and torch.equal(kmask, cmask)


def test_dampen_out_writes_in_place():
    th, i_f, i_g = (torch.from_numpy(a) for a in _inputs((100,)))
    want, _ = ops.dampen(th, i_f, i_g, 2.0, 0.5)
    edit = th.clone()
    got, _ = ops.dampen(edit, i_f, i_g, 2.0, 0.5, out=edit)
    assert got.data_ptr() == edit.data_ptr()
    assert torch.equal(edit, want)


def test_alpha_rounds_to_f32_once():
    """alpha arrives as a Python double (alpha * S(l)); it is rounded to
    f32 once, as the reference's f32 scalar block is. Here the double is
    just below i_f but rounds up to it, so the entry is NOT selected."""
    alpha = 1.0 + 2.0 ** -23 - 2.0 ** -30    # f32(alpha) == 1 + 2**-23
    i_f = np.array([1.0 + 2.0 ** -23], np.float32)
    assert float(i_f[0]) > alpha                    # selected in doubles
    _, mask = ops.dampen(torch.ones(1), torch.from_numpy(i_f),
                         torch.ones(1), alpha, 1.0)
    _, jmask = jops.dampen(jnp.ones(1), jnp.asarray(i_f), jnp.ones(1),
                           alpha, 1.0)
    assert not bool(mask[0]) and not bool(np.asarray(jmask)[0])
