"""The port's dampening wrappers against the JAX package's, on the CPU.

Here (no card) ``repro_torch.kernels.ops.dampen`` and ``ops.dampen_int8``
take their plain PyTorch versions, ``dampen_ref`` and ``dampen_int8_ref``;
the JAX side runs its Pallas kernels in interpret mode, as
tests/test_kernels.py does, and its pure-jnp oracles. The same numpy inputs
go to both, and theta' (or the int8 codes) and the mask must agree BIT FOR
BIT: every step is one correctly rounded f32 operation, a round half to
even, or a clip, so there is nothing to tolerate. (The CUDA kernels
themselves are held bit-exact against their plain versions on the card by
chip_smoke.py.)
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import ssd as tssd  # noqa: E402
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


# -- the int8 kernel (precision="int8") -------------------------------------
INT8_SIZES = [1, 3, 4, 5, 1000, 1024, 4097]


def _int8_inputs(n):
    th = RNG.integers(-128, 128, size=n).astype(np.int8)
    i_g = (np.abs(RNG.normal(size=n)) + 1e-6).astype(np.float32)
    i_f = (RNG.uniform(size=n) * 20 * i_g).astype(np.float32)
    return th, i_f, i_g


def _check_int8(th, i_f, i_g, alpha, lam):
    """ops.dampen_int8 vs the reference's ops.dampen_int8 (Pallas,
    interpret mode) and its oracle; returns the port's (codes, mask)."""
    got, mask = ops.dampen_int8(torch.from_numpy(th), torch.from_numpy(i_f),
                                torch.from_numpy(i_g), alpha, lam)
    args = (jnp.asarray(th), jnp.asarray(i_f), jnp.asarray(i_g), alpha, lam)
    want = np.asarray(jops.dampen_int8(*args))
    oracle = np.asarray(jref.dampen_int8_ref(*args))
    assert got.dtype == torch.int8 and mask.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), oracle)
    with np.errstate(invalid="ignore"):
        np.testing.assert_array_equal(mask.numpy(),
                                      i_f > np.float32(alpha) * i_g)
    return got.numpy(), mask.numpy()


@pytest.mark.parametrize("n", INT8_SIZES)
@pytest.mark.parametrize("alpha,lam", PAIRS)
def test_dampen_int8_bit_exact_against_jax(n, alpha, lam):
    got, mask = _check_int8(*_int8_inputs(n), alpha, lam)
    assert int(np.abs(got.astype(np.int32)).max()) <= 127


def test_dampen_int8_ties_round_half_to_even():
    """beta = 0.5 (and 0.25) exactly: every odd code (code = 2 mod 4) lands
    on k + 0.5 and rounds to the even neighbour; -128 saturates to -127."""
    th = np.arange(-128, 128).astype(np.int8)
    ones = np.ones(256, np.float32)
    got, mask = _check_int8(th, ones, ones, 0.5, 0.5)
    assert mask.all()
    t = th.astype(np.int32)
    np.testing.assert_array_equal(got, np.clip(np.round(t * 0.5), -127, 127))
    assert (got[t == 3][0], got[t == 5][0], got[t == -3][0]) == (2, 2, -2)
    got, _ = _check_int8(th, 4 * ones, ones, 0.5, 1.0)
    assert got[t == 2][0] == 0 and got[t == 6][0] == 2 and got[t == 10][0] == 2


def test_dampen_int8_saturation_and_edge_cases():
    """A negative beta (a negative Fisher) saturates at ±127; alpha = 0,
    lambda = NaN/inf and zero/NaN/inf Fisher entries agree with the
    reference, and a NaN product gives code 0, as XLA converts NaN."""
    th = np.arange(-128, 128).astype(np.int8)
    ones = np.ones(256, np.float32)
    got, mask = _check_int8(th, ones, -ones, 2.0, 10.0)
    assert mask.all()
    assert (got[th == 100][0], got[th == -100][0]) == (-127, 127)
    # normal numbers only: subnormals are the one divergence (next test)
    special = np.array([0.0, np.nan, np.inf, 1.0, 2.0, 1e-30, 1e-37, -1.0],
                       np.float32)
    f = np.tile(special, 8 * 4)[:256]
    g = np.repeat(special, 32)
    for alpha, lam in [(0.0, 1.0), (2.0, float("nan")), (2.0, float("inf")),
                       (10.0, 1.0), (0.5, 0.1)]:
        got, mask = _check_int8(th, f, g, alpha, lam)
        if lam != lam:
            assert mask.any() and (got[mask] == 0).all()
        np.testing.assert_array_equal(got[~mask], np.clip(th[~mask], -127,
                                                          127))


def test_subnormal_fisher_keeps_ieee_meaning_in_the_port():
    """A known divergence (ROADMAP Queue 3): XLA on the CPU flushes f32
    subnormals to zero, PyTorch and the CUDA kernels (built without fast
    math) do not. So i_f = 1e-38 against i_g = 0 is selected in the port
    (1e-38 > 0, beta = 0: the weight is zeroed) and not in the reference."""
    i_f = np.array([1e-38, 1e-40, 1.0], np.float32)
    i_g = np.zeros(3, np.float32)
    th = np.array([5.0, -7.0, 3.0], np.float32)
    got, mask = ops.dampen(torch.from_numpy(th), torch.from_numpy(i_f),
                           torch.from_numpy(i_g), 2.0, 0.5)
    got8, mask8 = ops.dampen_int8(torch.from_numpy(th.astype(np.int8)),
                                  torch.from_numpy(i_f),
                                  torch.from_numpy(i_g), 2.0, 0.5)
    assert mask.tolist() == mask8.tolist() == [True, True, True]
    assert got.tolist() == got8.tolist() == [0, 0, 0]
    want = np.asarray(jref.dampen_ref(jnp.asarray(th), jnp.asarray(i_f),
                                      jnp.asarray(i_g), 2.0, 0.5))
    assert want.tolist() == [5.0, -7.0, 0.0]   # flushed: not selected


def test_dampen_int8_rejects_bad_operands():
    """The wrapper's ValueErrors, as tests/test_kernels.py checks the
    reference's: float theta and mismatched Fisher shapes."""
    th = torch.zeros(8, dtype=torch.int8)
    with pytest.raises(ValueError, match="int8 weight codes"):
        ops.dampen_int8(th.float(), torch.zeros(8), torch.zeros(8), 2.0, 0.5)
    with pytest.raises(ValueError, match="int8 weight codes"):
        jops.dampen_int8(jnp.zeros(8), jnp.zeros(8), jnp.zeros(8), 2.0, 0.5)
    with pytest.raises(ValueError, match="elementwise"):
        ops.dampen_int8(th, torch.zeros(9), torch.zeros(8), 2.0, 0.5)
    with pytest.raises(ValueError, match="elementwise"):
        jops.dampen_int8(jnp.zeros(8, jnp.int8), jnp.zeros(9), jnp.zeros(8),
                         2.0, 0.5)


def test_int8_cpu_path_matches_core_ssd_and_launches_nothing():
    """On the CPU the wrapper is the plain version (core.ssd.dampen_q8_array,
    bit for bit), neither launch counter moves, and ``out`` edits in
    place."""
    th, i_f, i_g = (torch.from_numpy(a) for a in _int8_inputs(513))
    before = (tdampen.LAUNCHES, tdampen.INT8_LAUNCHES)
    kout, kmask = ops.dampen_int8(th, i_f, i_g, 3.0, 0.7)
    cout, cmask = tssd.dampen_q8_array(th, i_f, i_g, 3.0, 0.7)
    assert (tdampen.LAUNCHES, tdampen.INT8_LAUNCHES) == before
    assert torch.equal(kout, cout) and torch.equal(kmask, cmask)
    edit = th.clone()
    got, _ = ops.dampen_int8(edit, i_f, i_g, 3.0, 0.7, out=edit)
    assert got.data_ptr() == edit.data_ptr() and torch.equal(edit, kout)
