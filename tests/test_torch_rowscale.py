"""The port's dampen_int8_rowscale against the JAX package's on the CPU, at
the shapes that the card kernel's decomposition treats apart, and the host
plan that its launch rests on.

Here (no card) ``repro_torch.kernels.ops`` takes the plain PyTorch version;
the JAX side runs its Pallas kernel in interpret mode and its pure-jnp
oracle. The same numpy inputs go to both; the result must be BIT-identical
(correctly rounded f32 steps and one rounding to int8), and equal to
``dampen_int8`` on the dequantised Fisher. The shapes: rows of one element
(every quad of the 16-byte path crosses three row ends), rows of 3 and of
1025 (a quad crosses one row end), rows of 4099 with a partial last block,
a single element, and the stem's [64, 27].

The plan (``kernels.dampen``): ``fast_divisor``'s multiplier and shift must
give ``//`` and ``%`` for every row length the kernel can be handed at the
dividends where a round-up error would show, and ``rowscale_parts`` must
cover every element of a leaf once, in parts of fewer than 2^31 elements,
also for leaves of 2^31 elements or more (their plans only: nothing that
size is allocated here). The card kernel itself is held against the plain
version by chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import dampen as kd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

torch.set_num_threads(2)
RNG = np.random.default_rng(16)

SHAPES = [(4097, 1), (3, 3), (2, 1025), (5, 4099), (1, 1), (64, 27)]
PAIRS = [(2.0, 0.5), (0.5, 1.0)]
# leaves of 2^31 elements or more: several rows per part, one row of more
# than a part, and rows of one element
HUGE = [(524289, 4096), (1, 2 ** 31 + 5), (3, 2 ** 32 + 7), (2 ** 31, 1),
        (2 ** 31 + 3, 1), (65537, 32771)]


def _operands(R, C):
    """int8 codes, a quant-domain Fisher with zeros, per-row scales with a
    zero, and a global Fisher, as numpy arrays."""
    thq = RNG.integers(-128, 128, size=(R, C)).astype(np.int8)
    i_fq = RNG.integers(0, 128, size=(R, C)).astype(np.float32)
    i_fq[RNG.random((R, C)) < 0.1] = 0.0
    fs = (np.abs(RNG.normal(size=(R,))) * 0.05).astype(np.float32)
    fs[0] = 0.0 if R > 1 else fs[0]
    i_g = (np.abs(RNG.normal(size=(R, C))) + 1e-6).astype(np.float32)
    return thq, i_fq, fs, i_g


@pytest.mark.parametrize("R,C", SHAPES)
@pytest.mark.parametrize("alpha,lam", PAIRS)
def test_rowscale_bit_exact_at_the_kernels_shapes(R, C, alpha, lam):
    args = _operands(R, C)
    got = ops.dampen_int8_rowscale(*map(torch.from_numpy, args), alpha, lam)
    assert got.dtype == torch.int8 and tuple(got.shape) == (R, C)
    jargs = tuple(jnp.asarray(x) for x in args)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.dampen_int8_rowscale(*jargs, alpha,
                                                           lam)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.dampen_int8_rowscale_ref(*jargs, alpha,
                                                              lam)))
    thq, i_fq, fs, i_g = map(torch.from_numpy, args)
    codes, _ = ops.dampen_int8(thq, i_fq * fs[:, None], i_g, alpha, lam)
    assert torch.equal(got, codes)


def _divide(e, mul, shr):
    """The card's row of element e: umulhi(2e, mul) >> shr, in uint64."""
    two_e = np.asarray(e, np.uint64) * np.uint64(2)
    return (two_e * np.asarray(mul, np.uint64) >> np.uint64(32)) \
        >> np.asarray(shr, np.uint64)


def _extreme_dividends(d):
    """Per divisor (a column), the dividends below 2^31 where a multiplier
    that rounds wrongly would show first: 0, 1, the multiples of d next to
    1, to d and to 2^31 - 1, one below and above each, and 2^31 - 1."""
    top = np.int64(2 ** 31 - 1)
    last = top // d * d
    e = np.stack([np.zeros_like(d), np.ones_like(d), d - 1, d, d + 1,
                  2 * d - 1, last - 1, last, np.minimum(last + d - 1, top),
                  np.full_like(d, top), np.full_like(d, top - 1),
                  RNG.integers(0, top, size=d.shape)])
    return np.clip(e, 0, top)


@pytest.mark.parametrize("divisors", ["1..70000", "random", "powers of two"])
def test_fast_divisor_equals_floor_division(divisors):
    if divisors == "1..70000":
        d = np.arange(1, 70_001, dtype=np.int64)
    elif divisors == "random":
        d = RNG.integers(1, 2 ** 31, size=20_000, dtype=np.int64)
    else:
        p = 2 ** np.arange(31, dtype=np.int64)
        d = np.unique(np.concatenate([p, p + 1, p - 1, [2 ** 31 - 1]]))
        d = d[(d >= 1) & (d < 2 ** 31)]
    ms = np.array([kd.fast_divisor(int(x)) for x in d], dtype=np.int64)
    mul, shr = ms[:, 0], ms[:, 1]
    assert (mul > 0).all() and (mul < 2 ** 32).all() and (shr <= 31).all()
    e = _extreme_dividends(d)
    q = _divide(e, mul, shr).astype(np.int64)
    np.testing.assert_array_equal(q, e // d)
    np.testing.assert_array_equal(e - q * d, e % d)


def _check_parts(R, C, parts, limit):
    """Every element once, in order; each part under 2^31 elements and at
    most ``limit``; a whole-row part starts at a row start and holds whole
    rows, a piece lies inside its row and is a row of its own."""
    at = 0
    for r, e, n, c in parts:
        assert e == at and 0 < n <= limit < 2 ** 31
        assert r * C <= e < (r + 1) * C
        if c == C:
            assert e % C == 0 and n % C == 0
        else:
            assert c == n and e + n <= (r + 1) * C and C > limit
        at += n
    assert at == R * C
    rows_per_part = [n // C for _, _, n, c in parts if c == C]
    if rows_per_part and limit // C >= 4:
        assert all(k % 4 == 0 for k in rows_per_part[:-1])


@pytest.mark.parametrize("R,C", HUGE)
def test_rowscale_parts_of_huge_leaves(R, C):
    parts = kd.rowscale_parts(R, C)
    _check_parts(R, C, parts, kd.PART_LIMIT)
    assert len(parts) >= 2
    # a part of whole rows, or a piece of a row that starts on it, starts
    # on the 16-byte path's grid: a multiple of 4 elements
    assert all(e % 4 == 0 for r, e, _, c in parts
               if c == C or r * C % 4 == 0)
    rows, blocks = kd.rowscale_plan(R, C, (0, 0, 0, 0, 0))
    assert len(rows) == len(parts) <= kd.MAX_ROW_PARTS
    assert (rows[:, 5] < 2 ** 31).all()
    np.testing.assert_array_equal(rows[:, 7], rows[:, 0] % 4 == 0)
    assert blocks == sum(-(-int(n) // kd.ELEMS_PER_BLOCK)
                         for n in rows[:, 5]) < 2 ** 31


@pytest.mark.parametrize("R,C", SHAPES + [(40, 257), (2, 5000)])
@pytest.mark.parametrize("limit", [kd.PART_LIMIT, 3000, 1030, 5, 4])
def test_rowscale_parts_rows_match_floor_division(R, C, limit):
    """Each element's row as the card finds it from its part (the part's
    first row plus umulhi(2e, mul) >> shr of its index in the part, with
    fast_divisor of the part's row length) is its row in the leaf."""
    parts = kd.rowscale_parts(R, C, limit)
    _check_parts(R, C, parts, limit)
    got = np.empty(R * C, np.int64)
    for r0, e0, n, c in parts:
        local = np.arange(n, dtype=np.int64)
        got[e0:e0 + n] = r0 + _divide(local, *kd.fast_divisor(c)).astype(
            np.int64)
    np.testing.assert_array_equal(got, np.arange(R * C) // C)


@pytest.mark.parametrize("R,C,limit", [
    (4097, 1, kd.PART_LIMIT), (5, 4099, 3000), (40, 257, 3000),
    (2, 5000, 3000), (64, 27, 1030), (3500, 1, 3000), (5, 1025, 3000)])
@pytest.mark.parametrize("lo", [0, 1])
def test_rowscale_plan_lays_out_the_parts(R, C, limit, lo):
    """One table row per part: the pointers at its first element and first
    row, its length, blocks numbered on from the previous part, its row
    length and divisor, and the 16-byte path where its pointers allow it
    (lo = 1: every pointer one element past the grid)."""
    ptrs = (1024 + lo, 2048 + 4 * lo, 4096, 8192 + 4 * lo, 16384 + lo)
    rows, blocks = kd.rowscale_plan(R, C, ptrs, limit)
    parts = kd.rowscale_parts(R, C, limit)
    assert len(rows) == len(parts)
    first = 0
    for (r0, e0, n, c), row in zip(parts, rows):
        assert tuple(map(int, row)) == (
            ptrs[0] + e0, ptrs[1] + 4 * e0, ptrs[2] + 4 * r0,
            ptrs[3] + 4 * e0, ptrs[4] + e0, n, first,
            int((lo + e0) % 4 == 0), c, *kd.fast_divisor(c))
        first += -(-n // kd.ELEMS_PER_BLOCK)
    assert blocks == first


def test_rowscale_plan_refuses_more_parts_than_a_table_holds():
    assert len(kd.rowscale_parts(4097, 1, 4)) > kd.MAX_ROW_PARTS
    with pytest.raises(ValueError, match="at most 16 parts"):
        kd.rowscale_plan(4097, 1, (0, 0, 0, 0, 0), 4)
