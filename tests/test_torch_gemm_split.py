"""The split over N of the port's backward GEMMs (``gemm_fisher`` and
``gemm_fisher_int8``), on the CPU.

The CUDA kernels cut the reduction over N into S slices when the dW tiles
alone would leave the card idle, and a second pass sums the partials in
slice order. The plan is Python (``gemm_fisher.split_plan``): its
invariants are checked here at the shapes of chip_smoke.py's
``[fisher kernels]`` phase and on a grid of odd shapes, and so are the
wrappers' refusals, which the redesign left as they were. The kernels
themselves run on the card only (chip_smoke.py holds them against their
plain versions, split cases included)."""
import itertools

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import gemm_fisher as kgf  # noqa: E402
from repro_torch.kernels import gemm_fisher_int8 as kgf8  # noqa: E402

# (N, M, K) of the [fisher kernels] GEMMs: the fc and three convs of a
# 64-image chunk of 8 on full-width ResNet-18, and gemm_fisher_int8's
# 1024-row blocks of the first two convs
FISHER_SHAPES = [(8, 512, 20), (8192, 576, 64), (2048, 576, 128),
                 (128, 4608, 512), (1024, 576, 64), (1024, 576, 128)]
ODD_SHAPES = list(itertools.product((0, 1, 31, 33, 255, 257, 1000, 4097,
                                     kgf8.MAX_N),
                                    (1, 65, 576, 4608), (1, 20, 64, 130)))
SLABS = (kgf.SLAB, kgf8.SLAB)


def _tiles(M, K):
    return -(-M // 64) * -(-K // 64)


def _check_plan(N, M, K, slab):
    S, rows = kgf.split_plan(N, M, K, slab)
    assert S >= 1
    slices = [(z * rows, min(N, (z + 1) * rows)) for z in range(S)]
    # disjoint, in order, covering [0, N), none empty (but for N = 0)
    assert slices[0][0] == 0 and slices[-1][1] == max(N, 0)
    assert all(b == c for (_, b), (c, _) in zip(slices, slices[1:]))
    assert all(hi > lo for lo, hi in slices) or N == 0
    if S > 1:
        # every slice but the last a whole number of slabs
        assert rows % slab == 0
        assert S <= -(-N // kgf.SPLIT_MIN_ROWS)
        # the workspace [S, M, K] stays below two target grids of tiles
        assert S * _tiles(M, K) < 2 * kgf.SPLIT_TARGET
        assert S * M * K * 4 < 2 * kgf.SPLIT_TARGET * 64 * 64 * 4
    else:
        assert rows == max(N, 0)
    if _tiles(M, K) >= kgf.SPLIT_TARGET:
        assert S == 1          # the tiles alone fill the card


@pytest.mark.parametrize("slab", SLABS)
@pytest.mark.parametrize("N,M,K", FISHER_SHAPES)
def test_split_plan_invariants(N, M, K, slab):
    _check_plan(N, M, K, slab)


@pytest.mark.parametrize("slab", SLABS)
def test_split_plan_invariants_at_odd_shapes(slab):
    for N, M, K in ODD_SHAPES:
        _check_plan(N, M, K, slab)


def test_split_plan_at_the_fisher_shapes():
    """The plans chip_smoke.py's timings report, pinned."""
    plan = {nmk: kgf.split_plan(*nmk) for nmk in FISHER_SHAPES}
    assert plan[(8192, 576, 64)] == (29, 288)        # 9 tiles
    assert plan[(128, 4608, 512)] == (1, 128)        # 576 tiles
    assert plan[(2048, 576, 128)] == (8, 256)
    assert plan[(8, 512, 20)] == (1, 8)
    plan8 = {nmk: kgf.split_plan(*nmk, kgf8.SLAB) for nmk in FISHER_SHAPES}
    assert plan8[(8192, 576, 64)] == (26, 320)
    assert plan8[(1024, 576, 64)] == (4, 256)
    assert plan8[(128, 4608, 512)] == (1, 128)
    # the int32 limit: every partial and every running sum fits int32
    S, rows = kgf.split_plan(kgf8.MAX_N, 64, 64, kgf8.SLAB)
    assert S > 1 and kgf8.MAX_N % rows != 0
    assert 128 * 128 * kgf8.MAX_N <= 2 ** 31 - 1


def test_split_plan_depends_on_the_shape_only(monkeypatch):
    """No card property enters the plan, so a result does not depend on
    the card it ran on; the same shape gives the same plan."""
    want = [kgf.split_plan(*nmk) for nmk in FISHER_SHAPES]

    def no_card(*_a, **_k):
        raise AssertionError("split_plan asked the card")

    for name in ("get_device_properties", "device_count", "is_available",
                 "current_device"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    assert [kgf.split_plan(*nmk) for nmk in FISHER_SHAPES] == want
    assert [kgf.split_plan(*nmk) for nmk in FISHER_SHAPES] == want


@pytest.mark.parametrize("N,M,K", FISHER_SHAPES)
def test_gemm_fisher_refusals_unchanged(N, M, K):
    """check_operands, which gemm_fisher_cuda runs before it launches,
    takes the phase's operands and refuses what the kernel never took."""
    a, g = torch.zeros(N, M), torch.zeros(N, K)
    assert kgf.check_operands(a, g) == (N, M, K)
    assert kgf.check_operands(a.bfloat16(), g.bfloat16()) == (N, M, K)
    for bad_a, bad_g in ((a.double(), g.double()), (a, g.bfloat16()),
                         (a.half(), g.half())):
        with pytest.raises(ValueError, match="contiguous 2-D f32 or bf16"):
            kgf.check_operands(bad_a, bad_g)
    wide = torch.zeros(2 * N, 2 * M)[::2, ::2]
    with pytest.raises(ValueError, match=r"\(contiguous=False\)"):
        kgf.check_operands(wide, g)
    with pytest.raises(ValueError, match=r"g \[N, K\]"):
        kgf.check_operands(a, torch.zeros(N + 1, K))


def test_gemm_fisher_refuses_m_past_the_grid():
    M = 64 * 65535 + 1
    with pytest.raises(ValueError, match=f"M <= {64 * 65535}"):
        kgf.check_operands(torch.zeros(1, M), torch.zeros(1, 1))


@pytest.mark.parametrize("N,M,K", FISHER_SHAPES)
def test_gemm_fisher_int8_refusals_unchanged(N, M, K):
    a_q = torch.zeros(N, M, dtype=torch.int8)
    g_q = torch.zeros(N, K, dtype=torch.int8)
    sa, sg = torch.ones(M), torch.ones(K)
    assert kgf8.check_operands(a_q, g_q, sa, sg) == (N, M, K)
    for args, what in (((a_q.float(), g_q, sa, sg), "a_q"),
                       ((a_q, g_q.short(), sa, sg), "g_q"),
                       ((a_q, g_q, sa.double(), sg), "sa"),
                       ((a_q, g_q, sa, torch.ones(K + 1)), "sg"),
                       ((torch.zeros(M, N, dtype=torch.int8).t(), g_q, sa,
                         sg), "a_q")):
        with pytest.raises(ValueError, match=f"operand {what} must be"):
            kgf8.check_operands(*args)
    with pytest.raises(ValueError, match=r"a_q \[N, M\] and g_q"):
        kgf8.check_operands(a_q, torch.zeros(N + 1, K, dtype=torch.int8),
                            sa, sg)


def test_gemm_fisher_int8_refuses_past_max_n_and_the_grid():
    n = kgf8.MAX_N
    ok = (torch.zeros(n, 4, dtype=torch.int8),
          torch.zeros(n, 4, dtype=torch.int8), torch.ones(4), torch.ones(4))
    assert kgf8.check_operands(*ok) == (n, 4, 4)
    with pytest.raises(ValueError, match=f"N <= {n}"):
        kgf8.check_operands(torch.zeros(n + 1, 4, dtype=torch.int8),
                            torch.zeros(n + 1, 4, dtype=torch.int8),
                            torch.ones(4), torch.ones(4))
    M = 64 * 65535 + 1
    with pytest.raises(ValueError, match=f"M <= {64 * 65535}"):
        kgf8.check_operands(torch.zeros(1, M, dtype=torch.int8),
                            torch.zeros(1, 1, dtype=torch.int8),
                            torch.ones(M), torch.ones(1))
