"""The grouped dampening entry points against the JAX package, on the CPU.

``repro_torch.kernels.ops.dampen_group`` / ``dampen_int8_group`` dampen a
whole table of leaves (a layer, or a tree) in one kernel launch on the
card and return the number of selected elements from the same pass. Here
(no card) they take their plain versions, a loop of ``dampen_ref`` /
``dampen_int8_ref`` plus the mask sum. The same seeded numpy tables go
through the reference's ``repro.kernels.ops.dampen`` / ``dampen_int8`` leaf
by leaf (Pallas in interpret mode, as tests/test_kernels.py runs it; its
Pallas wrapper refuses an empty array, so an empty leaf goes through its
oracle ``repro.kernels.ref``), and every leaf's result, mask and the count
must agree BIT FOR BIT: each step is one correctly rounded f32 operation, a
round half to even, a clip or an integer sum. The table plan that the CUDA
wrappers hand the kernel is computed in Python and checked here; the
kernel itself is held against these plain versions on the card by
chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import ssd as jssd  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import adapters  # noqa: E402
from repro_torch.core import ssd as tssd  # noqa: E402
from repro_torch.core.cau import _chunk, _logit_cotangents  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.engine.fused import (build_fused_step,  # noqa: E402
                                      grad_fisher_chunks)
from repro_torch.kernels import dampen as kd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import vision as V  # noqa: E402
from repro_torch.models.module import (flatten_with_paths,  # noqa: E402
                                       tree_leaves, tree_map)

torch.set_num_threads(2)

PAIRS = [(2.0, 0.5), (10.0, 1.0), (0.5, 0.1)]   # tests/test_kernels.py:34
SIZES = (0, 1, 3, 4, 5, 64, 4608, 73728)
# NaN, +-inf and zero go into theta and both Fisher operands, 1e-30 (the
# beta clamp) and 1e-38 (a subnormal) into i_f. XLA on the CPU flushes
# subnormals (ROADMAP Queue 3), so 1e-38 goes only where i_g is a normal
# number of at least 1e-6 (never selected on either side), and no operand
# is chosen so small that theta * beta could fall below the normal range.
SPECIAL = np.array([np.nan, np.inf, -np.inf, 0.0], np.float32)
DTYPES = {"float32": (torch.float32, jnp.float32, np.uint32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, np.uint16)}


def _bits(x, view):
    """Raw bits of a numpy/JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16 if view == np.uint16 else torch.int32).numpy()
    return np.asarray(x).view(view)


def _table(seed, int8=False):
    """One leaf per size in SIZES: (theta, i_f, i_g) numpy arrays with a
    share of special values, ties at i_f == f32(alpha) * i_g left to the
    caller."""
    rng = np.random.default_rng(seed)
    leaves = []
    for n in SIZES:
        i_g = (np.abs(rng.normal(size=n)) + 1e-6).astype(np.float32)
        i_f = (rng.uniform(size=n) * 20 * i_g).astype(np.float32)
        if int8:
            th = rng.integers(-128, 128, size=n).astype(np.int8)
        else:
            th = rng.normal(size=n).astype(np.float32)
        for a, special in ((i_g, SPECIAL), (i_f, np.append(SPECIAL, 1e-30)),
                           (th, SPECIAL if th.dtype == np.float32 else ())):
            if not len(special):
                continue
            hit = rng.uniform(size=n) < 0.05
            a[hit] = rng.choice(special, size=int(hit.sum())).astype(a.dtype)
        i_f[(rng.uniform(size=n) < 0.02) & (i_g >= 1e-6)] = 1e-38
        leaves.append((th, i_f, i_g))
    return leaves


def _jax_leaf(fn, oracle, th, i_f, i_g, alpha, lam):
    args = (jnp.asarray(th), jnp.asarray(i_f), jnp.asarray(i_g), alpha, lam)
    return fn(*args) if th.size else oracle(*args)


def _assert_same_float(got, want, view):
    """NaN where the reference has NaN, every other bit equal (the edge
    cases of tests/test_torch_kernels.py)."""
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    ok = ~np.isnan(w)
    np.testing.assert_array_equal(_bits(got, view)[ok],
                                  _bits(want, view)[ok])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("alpha,lam", PAIRS + [(2.0, float("nan")),
                                               (2.0, float("inf"))])
def test_dampen_group_bit_exact_against_jax(dtype, alpha, lam):
    tdt, jdt, view = DTYPES[dtype]
    leaves = _table(3)
    for th, i_f, i_g in leaves:   # ties: never selected (strict >)
        i_f[::97] = np.float32(alpha) * i_g[::97]
    thetas = [torch.from_numpy(th).to(tdt) for th, _, _ in leaves]
    got, masks, count = ops.dampen_group(
        thetas, [torch.from_numpy(f) for _, f, _ in leaves],
        [torch.from_numpy(g) for _, _, g in leaves], alpha, lam)
    n_sel = 0
    for (th, i_f, i_g), t, new, mask in zip(leaves, thetas, got, masks):
        th_j = jnp.asarray(th, jdt)
        _assert_same_float(t, th_j, view)   # a NaN's payload may differ
        if th.size:
            want, want_mask = jops.dampen(th_j, jnp.asarray(i_f),
                                          jnp.asarray(i_g), alpha, lam)
        else:
            want = jref.dampen_ref(th_j, jnp.asarray(i_f), jnp.asarray(i_g),
                                   alpha, lam)
            want_mask = jnp.asarray(i_f) > np.float32(alpha) * jnp.asarray(
                i_g)
        assert new.dtype == tdt and new.shape == t.shape
        assert mask.dtype == torch.bool and mask.shape == t.shape
        _assert_same_float(new, want, view)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
        n_sel += int(jnp.sum(want_mask))
    assert count.dtype == torch.int64 and count.ndim == 0
    assert int(count) == n_sel > 0


@pytest.mark.parametrize("alpha,lam", PAIRS + [(0.5, 0.5), (2.0, 10.0),
                                               (2.0, float("nan"))])
def test_dampen_int8_group_bit_exact_against_jax(alpha, lam):
    leaves = _table(5, int8=True)
    # a leaf of every code at beta = 0.5 exactly (half-way products round
    # to even) and one at a negative beta (saturation at +-127)
    codes = np.arange(-128, 128).astype(np.int8)
    ones = np.ones(256, np.float32)
    leaves += [(codes, ones, ones), (codes, ones, -ones)]
    got, masks, count = ops.dampen_int8_group(
        [torch.from_numpy(th) for th, _, _ in leaves],
        [torch.from_numpy(f) for _, f, _ in leaves],
        [torch.from_numpy(g) for _, _, g in leaves], alpha, lam)
    n_sel = 0
    for (th, i_f, i_g), new, mask in zip(leaves, got, masks):
        want = _jax_leaf(jops.dampen_int8, jref.dampen_int8_ref, th, i_f,
                         i_g, alpha, lam)
        assert new.dtype == torch.int8 and mask.dtype == torch.bool
        np.testing.assert_array_equal(new.numpy(), np.asarray(want))
        with np.errstate(invalid="ignore"):
            want_mask = i_f > np.float32(alpha) * i_g
        np.testing.assert_array_equal(mask.numpy(), want_mask)
        n_sel += int(want_mask.sum())
    assert int(count) == n_sel > 0
    half = got[len(SIZES)].numpy().astype(np.int32)
    if (alpha, lam) == (0.5, 0.5):
        t = codes.astype(np.int32)
        np.testing.assert_array_equal(half, np.clip(np.round(t * 0.5),
                                                    -127, 127))
        assert (half[t == 3][0], half[t == -3][0]) == (2, -2)


def _simulate(rows, blocks):
    """The kernel's work split, as csrc/dampen.cu does it: block b takes
    the last leaf whose first block is <= b and its elements
    [(b - first) * epb, min(n, (b - first + 1) * epb)), epb the elements
    per block. Returns per leaf how often each element is taken."""
    epb = kd.ELEMS_PER_BLOCK
    firsts = rows[:, 6]
    hits = [np.zeros(n, np.int64) for n in rows[:, 5]]
    for b in range(max(blocks, 1)):
        i = int(np.searchsorted(firsts, b, side="right")) - 1
        start = (b - firsts[i]) * epb
        hits[i][start:min(rows[i, 5], start + epb)] += 1
    return hits


def test_table_plan_covers_every_element_once():
    epb = kd.ELEMS_PER_BLOCK
    rng = np.random.default_rng(7)
    ns = [0, 1, 3, 1024, 1025, 4608, 0, 73728, 5, 0] + list(
        rng.integers(0, 5000, size=150))
    ptrs = [(16 * i, 32, 48, 64, 16 * i) for i in range(len(ns))]
    plan = kd.table_plan(ns, ptrs, 4)
    # past capacity: leaves in order, MAX_LEAVES per launch
    assert [len(r) for r, _ in plan] == [64, 64, len(ns) - 128]
    assert np.concatenate([r[:, 5] for r, _ in plan]).tolist() == ns
    for rows, blocks in plan:
        assert rows.dtype == np.int64 and rows.shape[1] == 8
        # contiguous block ranges, one per leaf, ceil(n / epb) blocks each
        owned = -(-rows[:, 5] // epb)
        assert rows[0, 6] == 0
        np.testing.assert_array_equal(np.diff(rows[:, 6]), owned[:-1])
        assert blocks == rows[-1, 6] + owned[-1] == owned.sum()
        for hits in _simulate(rows, blocks):
            assert (hits == 1).all()


def test_table_plan_flags_misaligned_leaves_scalar():
    """A leaf takes the 16-byte path only if every pointer is aligned for
    it: an offset view of theta (f32, bf16, int8), of a Fisher operand or of
    the output puts the leaf on the scalar path alone."""
    base = torch.empty(64)
    b16 = torch.empty(64, dtype=torch.bfloat16)
    i8 = torch.empty(64, dtype=torch.int8)
    assert base.data_ptr() % 16 == 0 and b16.data_ptr() % 16 == 0

    def vec(theta, i_f=base, i_g=base, out=None, mask=0):
        out = theta if out is None else out
        (rows, _), = kd.table_plan(
            [8], [(theta.data_ptr(), i_f.data_ptr(), i_g.data_ptr(),
                   out.data_ptr(), mask)], theta.element_size())
        return int(rows[0, 7])

    assert vec(base) == vec(b16) == vec(i8) == 1
    assert vec(base[4:]) == vec(b16[4:]) == vec(i8[4:]) == 1
    assert vec(base[1:]) == vec(b16[2:]) == vec(i8[1:]) == vec(i8[3:]) == 0
    assert vec(base, i_f=base[1:]) == vec(base, i_g=base[2:]) == 0
    assert vec(base, out=base[3:]) == vec(base, mask=2) == 0


def test_group_refuses_bad_tables():
    """The per-leaf wrappers' ValueErrors, leaf by leaf, and a table whose
    lists disagree in length."""
    th = torch.zeros(8)
    with pytest.raises(ValueError, match="elementwise"):
        ops.dampen_group([th, th], [torch.zeros(8), torch.zeros(9)],
                         [th, th], 2.0, 0.5)
    with pytest.raises(ValueError, match="int8 weight codes"):
        ops.dampen_int8_group([th.to(torch.int8), th], [th, th], [th, th],
                              2.0, 0.5)
    with pytest.raises(ValueError, match="one i_f, i_g"):
        ops.dampen_group([th, th], [th], [th, th], 2.0, 0.5)
    with pytest.raises(ValueError, match="'cpu' \\(plain version\\) or "
                                         "'cuda'"):
        ops.dampen_group([torch.zeros(8, device="meta")],
                         [torch.zeros(8, device="meta")],
                         [torch.zeros(8, device="meta")], 2.0, 0.5)
    for call in (lambda: kd.dampen_group_cuda([th], [th], [th], 2.0, 0.5),
                 lambda: kd.dampen_int8_group_cuda([th.to(torch.int8)], [th],
                                                   [th], 2.0, 0.5)):
        with pytest.raises(ValueError, match="takes CUDA tensors"):
            call()


def test_group_refuses_a_table_on_two_devices():
    """A table whose first leaf lies on the CPU takes the plain version
    only if every operand of every leaf lies there too: a later leaf, a
    Fisher operand or an out on another device is refused, never dampened
    by the plain version."""
    th = torch.zeros(8)
    meta = torch.zeros(8, device="meta")
    for fn, t in ((ops.dampen_group, th), (ops.dampen_int8_group,
                                           th.to(torch.int8))):
        for table in (([t, meta.to(t.dtype)], [th, meta], [th, meta], None),
                      ([t, t], [th, meta], [th, th], None),
                      ([t, t], [th, th], [th, th], [t, meta.to(t.dtype)])):
            with pytest.raises(ValueError, match="first theta's device"):
                fn(*table[:3], 2.0, 0.5, outs=table[3])


@pytest.mark.parametrize("what,case,match", [
    ("dampen", "shape", "dampen is elementwise"),
    ("dampen_int8", "shape", "dampen_int8 is elementwise"),
    ("dampen_int8", "dtype", "dampen_int8 edits int8 weight codes"),
    ("dampen", "dtype", "operand i_f must be a contiguous torch.float32"),
    ("dampen", "stride", "operand theta must be a contiguous"),
])
def test_card_check_refuses_with_the_reference_texts(what, case, match):
    """On the card, ``kernels.ops`` hands a table to the kernel's wrapper
    unchecked, and a leaf that fails its one check is refused by
    ``_refuse``: the reference's texts for a shape or a non-int8 code, the
    kernel's for an operand it cannot take."""
    dt = torch.int8 if what == "dampen_int8" else torch.float32
    th, f = torch.zeros(4, 4, dtype=dt), torch.zeros(4, 4)
    g, out = f, th
    if case == "shape":
        f = torch.zeros(4, 5)
    elif case == "dtype":
        th, out = (th.float(), th.float()) if dt == torch.int8 else (th, th)
        f = f if dt == torch.int8 else f.double()
    else:
        th = th.t()
    with pytest.raises(ValueError, match=match):
        kd._refuse(what, th.device, dt, th, f, g, out)


@pytest.fixture(scope="module")
def tiny():
    cfg = V.ResNetConfig(width=8, n_classes=4, img_size=8)
    params = V.init_resnet(torch.Generator().manual_seed(1), cfg,
                           device="cpu")
    x, y = syn.make_classification(syn.ClsDataConfig(
        n_classes=4, n_per_class=8, img_size=8, seed=1))
    return cfg, params, x, y


def _np_tree(tree):
    return tree_map(lambda t: jnp.asarray(t.detach().numpy()), tree)


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_trees_with_kernel_equal_plain_and_edit_in_place(tiny, precision):
    """dampen_tree / dampen_q8_tree with use_kernel=True on the CPU (one
    group call, its plain version) equal use_kernel=False bit for bit, leave
    the caller's tensors alone, write into them with in_place, and count
    what the masks hold; the launch counters do not move."""
    _, params, _, _ = tiny
    gen = torch.Generator().manual_seed(4)
    if precision == "int8":
        params = tree_map(lambda t: torch.randint(
            -128, 128, t.shape, generator=gen, dtype=torch.int8), params)
    fg = tree_map(lambda t: torch.rand(t.shape, generator=gen), params)
    ff = tree_map(lambda t: torch.rand(t.shape, generator=gen) * 20, fg)
    tree_fn = tssd.dampen_q8_tree if precision == "int8" else tssd.dampen_tree
    before = (kd.LAUNCHES, kd.LEAVES, kd.INT8_LAUNCHES, kd.INT8_LEAVES)
    pristine = [t.clone() for t in tree_leaves(params)]
    new_k, masks_k = tree_fn(params, ff, fg, 10.0, 1.0, use_kernel=True)
    new_p, masks_p = tree_fn(params, ff, fg, 10.0, 1.0)
    for a, b in zip(tree_leaves(new_k) + tree_leaves(masks_k),
                    tree_leaves(new_p) + tree_leaves(masks_p)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(params), pristine))
    _, masks, count = tssd.dampen_tree_counted(precision, params, ff, fg,
                                               10.0, 1.0, use_kernel=True)
    assert int(count) == sum(int(m.sum()) for m in tree_leaves(masks)) > 0
    assert tssd.dampen_tree_counted(precision, params, ff, fg, 10.0, 1.0
                                    )[2] is None
    edit = tree_map(lambda t: t.clone(), params)
    got, _ = tree_fn(edit, ff, fg, 10.0, 1.0, use_kernel=True, in_place=True)
    for g, e, want in zip(tree_leaves(got), tree_leaves(edit),
                          tree_leaves(new_p)):
        assert g.data_ptr() == e.data_ptr() and torch.equal(e, want)
    assert (kd.LAUNCHES, kd.LEAVES, kd.INT8_LAUNCHES,
            kd.INT8_LEAVES) == before


@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("excluded", [None, "gn", "conv"])
def test_fused_step_counts_as_the_reference(tiny, precision, excluded):
    """The fused step's n_selected (the group call's count with use_kernel,
    the masks' sum without) equals the reference's _n_sel, the sum of its
    dampen_tree masks on the same Fisher pair, also with ``exclude`` set:
    the count covers the masks before the excluded leaves are restored."""
    cfg, params, x, y = tiny
    adapter = adapters.resnet_adapter(cfg, device="cpu")
    xs, ys = torch.as_tensor(x[:8]), torch.as_tensor(y[:8])
    logits, acts = adapter.forward_collect(params, xs)
    cot = _logit_cotangents(adapter.loss, _chunk(logits, 4), _chunk(ys, 4))
    gen = torch.Generator().manual_seed(6)
    exclude = None if excluded is None else (
        lambda path: excluded in path)
    for j in (adapter.n_layers - 1, adapter.n_layers - 2):
        layer_p = adapter.get_layer(params, j)
        fisher_g = tree_map(
            lambda v: torch.rand(v.shape, generator=gen) * 1e-3, layer_p)

        def apply_fn(c, lp, a, _j=j):
            return adapter.apply_layer(c, _j, lp, a)

        acts_c = _chunk(acts[j], 4)
        fish, g_acts = grad_fisher_chunks(
            lambda lp, a: apply_fn(None, lp, a), layer_p, acts_c, cot)
        edit = layer_p if precision == "fp32" else tree_map(
            lambda t: torch.randint(-128, 128, t.shape, generator=gen,
                                    dtype=torch.int8), layer_p)
        _, jmasks = jssd.dampen_tree(_np_tree(layer_p), _np_tree(fish),
                                     _np_tree(fisher_g), 10.0, 1.0)
        want = int(sum(jnp.sum(m) for m in tree_leaves(jmasks)))
        assert want > 0
        for use_kernel in (True, False):
            step = build_fused_step(apply_fn, use_kernel=use_kernel,
                                    exclude=exclude, split_edit=True,
                                    precision=precision)
            new, _, n_sel = step(None, layer_p, edit, fisher_g, acts_c, cot,
                                 (10.0, 1.0))
            assert int(n_sel) == want
            for path, leaf in flatten_with_paths(new):
                old = dict(flatten_with_paths(edit))[path]
                if exclude is not None and exclude(path):
                    assert torch.equal(leaf, old)
        cot = g_acts
