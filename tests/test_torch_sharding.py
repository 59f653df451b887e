"""The port's sharding rules (``repro_torch.dist.sharding``) and mesh
construction (``repro_torch.launch.mesh``) against the JAX package's
(``repro.dist.sharding``, ``repro.launch.mesh``):

  * twins of the reference's rule tests (the tp rules, the MoE rank
    disambiguation, divisibility fitting, stacked specs, the mode
    refusal) and of its mesh capacity guard;
  * parity: over every config's SMOKE parameter tree and its Fisher tree
    (the registry's ten archs, ResNet-18-small and ViT-small), for mode tp
    and fsdp, on fake meshes {data: 1, model: 1}, {data: 2, model: 4},
    {data: 16, model: 16} and {pod: 2, data: 16, model: 16}: the port's
    ``param_pspecs``, ``stacked_param_pspecs``, ``batch_pspec`` and
    ``cache_pspecs`` (on each family's decode cache) equal the reference's
    as tuples, leaf by leaf by path. Conv leaves are OIHW in the port:
    their specs are compared in the reference's HWIO order
    (``bridge.is_conv_weight``);
  * ``placements`` turns a spec into DTensor placements, a tuple entry
    sharding one dim over several mesh dims in mesh order.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import ficabu_vision as jvision_cfgs  # noqa: E402
from repro.dist import sharding as jshd  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import encdec as JED  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.models import vision as JV  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.dist.sharding import P  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import encdec as TED  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import vision as TV  # noqa: E402
from repro_torch.models.module import tree_map  # noqa: E402

torch.set_num_threads(2)
ARCHS = sorted(jconfigs.all_archs())
VISION = ("resnet18-small", "vit-small")
MODES = ("tp", "fsdp")


def _fake(**shape):
    return type("FakeMesh", (), {"shape": dict(shape)})


MESHES = {"1x1": _fake(data=1, model=1), "2x4": _fake(data=2, model=4),
          "16x16": _fake(data=16, model=16),
          "2x16x16": _fake(pod=2, data=16, model=16)}
CACHE_B, CACHE_S = 32, 16


# -- twins of the reference's rule tests ------------------------------------
def test_param_pspec_rules():
    tree = {
        "embed": {"w": torch.zeros((64, 32))},
        "period_stack": {"0": {
            "mixer": {"wq": torch.zeros((4, 32, 32)),
                      "bf": torch.zeros((4, 8))},
            "ffn": {"w_gate": torch.zeros((4, 32, 64)),
                    "router": torch.zeros((4, 32, 8))},
        }},
        "final_norm": {"scale": torch.zeros(32)},
    }
    specs = shd.param_pspecs(tree)
    assert specs["embed"]["w"] == P("model", "data")
    assert specs["period_stack"]["0"]["mixer"]["wq"] == \
        P(None, "data", "model")
    assert specs["period_stack"]["0"]["ffn"]["w_gate"] == \
        P(None, "data", "model")
    assert specs["final_norm"]["scale"] == P(None)


def test_param_pspec_moe_rank_disambiguation():
    tree = {"period_stack": {"0": {"ffn": {
        "w_gate": torch.zeros((4, 8, 32, 64)),       # stacked MoE [L,E,D,F]
        "shared": {"w_gate": torch.zeros((4, 32, 64))},  # stacked dense
    }}}}
    specs = shd.param_pspecs(tree)
    assert specs["period_stack"]["0"]["ffn"]["w_gate"] == \
        P(None, "model", "data", None)
    assert specs["period_stack"]["0"]["ffn"]["shared"]["w_gate"] == \
        P(None, "data", "model")


def test_pspec_divisibility_filter():
    mesh = _fake(data=16, model=16)
    assert shd._fit_spec(P(None, "model"), (3, 4), mesh) == P(None, None)
    assert shd._fit_spec(P("data", "model"), (32, 32), mesh) == \
        P("data", "model")
    # the reference's PartitionSpec compares by tuple
    assert tuple(shd._fit_spec(P(None, "model"), (3, 4), mesh)) == \
        tuple(jshd._fit_spec(JP(None, "model"), (3, 4), mesh))


def test_stacked_param_pspecs():
    stack = {"mixer": {"wq": torch.zeros((6, 32, 64))},   # [L, in, out]
             "ln": {"scale": torch.zeros((6, 32))}}
    specs = shd.stacked_param_pspecs(stack, None, mode="tp")
    assert specs["mixer"]["wq"] == P(None, "data", "model")
    assert specs["ln"]["scale"] == P(None, None)
    # divisibility fitting: a mesh axis that does not divide the layer dims
    # degrades to replication, the stack dim stays replicated
    fitted = shd.stacked_param_pspecs(
        {"w": torch.zeros((6, 31, 64))}, _fake(data=2, model=4), mode="tp")
    assert fitted["w"] == P(None, None, "model")
    fsdp = shd.stacked_param_pspecs(stack, _fake(data=2, model=4),
                                    mode="fsdp")
    assert fsdp["mixer"]["wq"][0] is None


@pytest.mark.parametrize("fn", [shd.param_pspecs, shd.stacked_param_pspecs])
def test_sharding_mode_rejected(fn):
    with pytest.raises(ValueError, match="'tp' or 'fsdp'"):
        fn({"w": torch.ones((4, 4))}, mode="dp")


def test_mesh_capacity_guard():
    """The production mesh needs 256 ranks; the host has one. The port's
    message names what it needs (a world size), where the reference's names
    XLA_FLAGS."""
    with pytest.raises(ValueError, match="XLA_FLAGS"):
        jmesh.make_production_mesh()
    with pytest.raises(ValueError, match="need 256 ranks.*world_size=256"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="need 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")


def test_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = MESHES["2x16x16"]
    assert shd.placements(P(None, ("data", "model")), mesh) == \
        (Replicate(), Shard(1), Shard(1))
    assert shd.placements(P("model", "data"), mesh) == \
        (Replicate(), Shard(1), Shard(0))
    assert shd.placements(P(("pod", "data"), None), mesh) == \
        (Shard(0), Shard(0), Replicate())
    assert shd.placements(P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        shd.placements(P(("model", "data")), mesh)
    with pytest.raises(ValueError, match="two tensor dims"):
        shd.placements(P("data", "data"), mesh)
    with pytest.raises(ValueError, match="mesh's axes"):
        shd.placements(P("expert"), mesh)


# -- parity over every config's SMOKE trees ---------------------------------
def _jpaths(tree):
    """{'a/b/c': leaf} of a reference tree (specs are leaves)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {jshd._path_str(p): leaf for p, leaf in flat}


@functools.lru_cache(maxsize=None)
def _models(name):
    """(port params, reference params as shapes, port cache, reference
    cache as shapes); the caches None for the vision models."""
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    if name in VISION:
        attr = name.replace("-", "_").upper()
        tcfg, jcfg = getattr(tconfigs, attr), getattr(jvision_cfgs, attr)
        if name.startswith("resnet"):
            return (TV.init_resnet(gen, tcfg, device="cpu"),
                    jax.eval_shape(lambda: JV.init_resnet(key, jcfg)),
                    None, None)
        return (TV.init_vit(gen, tcfg, device="cpu"),
                jax.eval_shape(lambda: JV.init_vit(key, jcfg)), None, None)
    tspec, jspec = tconfigs.get(name), jconfigs.get(name)
    if tspec.kind == "encdec":
        tm, jm = TED, JED
        tinit, jinit = TED.init_encdec, JED.init_encdec
    else:
        tm, jm = TLM, JLM
        tinit, jinit = TLM.init_lm, JLM.init_lm
    return (tinit(gen, tspec.smoke, device="cpu"),
            jax.eval_shape(lambda: jinit(key, jspec.smoke)),
            tm.init_cache(tspec.smoke, CACHE_B, CACHE_S, device="cpu"),
            jax.eval_shape(lambda: jm.init_cache(jspec.smoke, CACHE_B,
                                                 CACHE_S)))


def _hwio(path, spec, ndim):
    """A port spec in the reference's layout (conv leaves OIHW -> HWIO)."""
    if bridge.is_conv_weight(path, ndim):
        return tuple(spec[i] for i in shd._OIHW_AS_HWIO)
    return tuple(spec)


def _assert_equal_specs(got, want, tree, conv=True):
    """Leaf by leaf by path; ``conv``: a parameter tree, whose conv leaves
    are compared in HWIO order (a cache holds no conv weight)."""
    got, want = shd.spec_paths(got), _jpaths(want)
    shapes = bridge.paths(tree)
    assert sorted(got) == sorted(want)
    bad = {k: (got[k], want[k]) for k in got
           if (_hwio(k, got[k], shapes[k].ndim) if conv else tuple(got[k]))
           != tuple(want[k])}
    assert not bad, bad


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ARCHS + list(VISION))
def test_rules_equal_the_reference(name, mode, mesh):
    fake = MESHES[mesh]
    tp, jp, tc, jc = _models(name)
    fisher = tree_map(lambda t: torch.zeros_like(t, dtype=torch.float32), tp)
    jfisher = jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(s.shape, np.float32), jp)
    for ours, theirs in ((tp, jp), (fisher, jfisher)):
        _assert_equal_specs(shd.param_pspecs(ours, fake, mode=mode),
                            jshd.param_pspecs(theirs, fake, mode=mode), ours)
        _assert_equal_specs(shd.param_pspecs(ours, mode=mode),
                            jshd.param_pspecs(theirs, mode=mode), ours)
    # stacked: the [L, ...] period stacks (an LM) or every leaf with a
    # leading dim (a vision model's trees have no stack; any leaf of rank
    # >= 1 is a stack for the rule)
    sel = {k: v for k, v in bridge.paths(tp).items()
           if v.ndim >= 1 and not bridge.is_conv_weight(k, v.ndim)}
    jsel = {k: v for k, v in _jpaths(jp).items() if k in sel}
    _assert_equal_specs(shd.stacked_param_pspecs(sel, fake, mode=mode),
                        jshd.stacked_param_pspecs(jsel, fake, mode=mode),
                        sel)
    for B in (1, 8, 32, 64, 512):
        for ndim in (1, 2, 4):
            assert tuple(shd.batch_pspec(fake, B, ndim, mode=mode)) == \
                tuple(jshd.batch_pspec(fake, B, ndim, mode=mode))
    assert shd.dp_size(fake) == jshd.dp_size(fake)
    if tc is not None:
        _assert_equal_specs(shd.cache_pspecs(tc, fake, CACHE_B),
                            jshd.cache_pspecs(jc, fake, CACHE_B), tc,
                            conv=False)
