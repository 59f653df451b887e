"""The port's dry-run cells (``repro_torch.launch.specs``) against the
reference's (``repro.launch.specs``) on a 1 x 1 host mesh, for every
architecture x input shape of the registry: names, the "skips" errors, the
argument trees by path (shape and dtype), the in / out spec trees,
``donate_argnums``, model FLOPs, parameter counts and the scan correction,
all exactly. Also the abstract build against ``jax.eval_shape(init_lm)``
and the unroll flag. Pod meshes and the probe variants are in
``test_torch_specs_pod.py``.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from repro import configs as jconfigs
from repro.launch import specs as JS
from repro.models import lm as JLM
from repro_torch import configs as tconfigs
from repro_torch.dist.sharding import P
from repro_torch.launch import specs as TS
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.models.module import tree_leaves

torch.set_num_threads(2)

CELLS = [(a, s) for a in sorted(tconfigs.all_archs()) for s in tconfigs.SHAPES]


# ---------------------------------------------------------------------------
# Trees of both packages, by path
# ---------------------------------------------------------------------------
def _key(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def ref_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(_key(k) for k in path): (tuple(x.shape), str(x.dtype))
            for path, x in flat}


def _walk(tree, prefix, leaf, is_leaf):
    if is_leaf(tree):
        return {prefix[:-1]: leaf(tree)}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_walk(v, f"{prefix}{k}/", leaf, is_leaf))
    return out


def port_leaves(tree):
    return _walk(tree, "", lambda t: (tuple(t.shape),
                                      str(t.dtype).replace("torch.", "")),
                 lambda t: isinstance(t, torch.Tensor))


def _norm(spec):
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else
           (tuple(e) if isinstance(e, tuple) else e) for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def ref_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: x is None or isinstance(x, NamedSharding))[0]
    return {"/".join(_key(k) for k in path):
            None if x is None else _norm(x.spec) for path, x in flat}


def port_specs(tree):
    return _walk(tree, "", lambda s: None if s is None else _norm(s),
                 lambda s: s is None or isinstance(s, P))


def compare_cells(jcell, tcell):
    assert tcell.name == jcell.name
    assert port_leaves(tcell.args) == ref_leaves(jcell.args)
    assert port_specs(tcell.in_shardings) == ref_specs(jcell.in_shardings)
    assert port_specs(tcell.out_shardings) == ref_specs(jcell.out_shardings)
    assert tcell.donate_argnums == jcell.donate_argnums
    assert tcell.model_flops == jcell.model_flops
    assert (tcell.n_params, tcell.n_active_params) == (
        jcell.n_params, jcell.n_active_params)
    assert tcell.scan_correction_flops == jcell.scan_correction_flops


@pytest.fixture(scope="module")
def meshes():
    """The reference's 1 x 1 host mesh and the port's, and the reference's
    parameter counts cached by config (a pure function of a frozen config:
    the cells of one arch share it)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "_param_counts",
                   functools.lru_cache(maxsize=None)(JS._param_counts))
        yield (jax.make_mesh((1, 1), ("data", "model"),
                             devices=jax.devices()[:1]),
               AbstractMesh((1, 1), ("data", "model")))


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_build_cell_matches_the_reference(meshes, arch, shape):
    jmesh, tmesh = meshes
    jspec, tspec = jconfigs.get(arch), tconfigs.get(arch)
    try:
        jcell = JS.build_cell(jspec, shape, jmesh)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            TS.build_cell(tspec, shape, tmesh)
        assert str(got.value) == str(e) and "skips" in str(e)
        return
    compare_cells(jcell, TS.build_cell(tspec, shape, tmesh))


def test_abstract_build_is_eval_shape_of_init_lm():
    """qwen1.5-32b FULL at 2 blocks: the port's abstract tree is the
    reference's ``jax.eval_shape(init_lm)`` path for path, and holds
    2,608,389,120 parameters with nothing allocated (meta tensors)."""
    jcfg = jconfigs.get("qwen1.5-32b").full.with_(n_layers=2)
    tcfg = tconfigs.get("qwen1.5-32b").full.with_(n_layers=2)
    want = ref_leaves(jax.eval_shape(lambda k: JLM.init_lm(k, jcfg),
                                     jax.random.PRNGKey(0)))
    tree = TS.eval_shape(TLM.init_lm, None, tcfg, device="cpu")
    assert port_leaves(tree) == want
    leaves = list(_walk(tree, "", lambda t: t,
                        lambda t: isinstance(t, torch.Tensor)).values())
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) == 2_608_389_120


def test_abstract_build_allocates_nothing_outside_fake_mode():
    """gen=None draws nothing: outside ``eval_shape`` the meta tensors
    cannot become host tensors."""
    cfg = tconfigs.get("yi-6b").smoke
    with pytest.raises(NotImplementedError):
        TLM.init_lm(None, cfg, device="cpu")


@pytest.mark.parametrize("arch", ["yi-6b", "xlstm-125m"])
def test_unroll_inner_changes_no_bit(arch):
    """``set_unroll_inner`` on and off: forwards bit-identical, through
    the query-chunked attention (2048 queries) where the arch has one."""
    cfg = tconfigs.get(arch).smoke
    S = 2048 if arch == "yi-6b" else 64
    params = TLM.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, S)))
    outs = []
    try:
        for flag in (False, True):
            TL.set_unroll_inner(flag)
            assert TL.unroll_inner() is flag
            with torch.no_grad():
                outs.append(TLM.forward(params, cfg, toks)[0])
    finally:
        TL.set_unroll_inner(False)
    assert torch.equal(outs[0], outs[1])


def test_forward_last_only_and_remat_match_the_reference():
    """The cells' forms of ``LM.forward``: ``last_only`` against the
    reference's on the same weights (f32 products in another order: rtol
    1e-5), and ``remat`` (a checkpoint per period and tail block) leaving
    the loss and every gradient bit for bit as they were."""
    import jax.numpy as jnp

    from repro_torch import bridge
    from repro_torch.optim import value_and_grad

    tcfg = tconfigs.get("recurrentgemma-9b").smoke       # periods + a tail
    jcfg = jconfigs.get("recurrentgemma-9b").smoke
    params = TLM.init_lm(torch.Generator().manual_seed(0), tcfg,
                         device="cpu")
    toks = np.random.default_rng(0).integers(0, tcfg.vocab, (2, 12))
    with torch.no_grad():
        got = TLM.forward(params, tcfg, torch.as_tensor(toks),
                          last_only=True)[0]
    jp = jax.tree_util.tree_map(jnp.asarray, bridge.params_to_numpy(params))
    want = JLM.forward(jp, jcfg, jnp.asarray(toks), last_only=True)[0]
    assert got.shape == (2, 1, tcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    batch = (torch.as_tensor(toks[:, :-1]), torch.as_tensor(toks[:, 1:]))
    runs = [value_and_grad(lambda p, b, c=c: TLM.lm_loss(p, c, *b), params,
                           batch)
            for c in (tcfg, tcfg.with_(remat=True))]
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(runs[0][1]), tree_leaves(runs[1][1])))
