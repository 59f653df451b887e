"""The port's dry-run cells on the production meshes (16 x 16 and
2 x 16 x 16, abstract on both sides: JAX's ``AbstractMesh`` and the
port's), and the probe variants with ``_shrink`` / ``n_periods_of``,
against the reference's (``repro.launch.specs``)."""
import dataclasses
import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh as JMesh

from repro import configs as jconfigs
from repro.launch import specs as JS
from repro_torch import configs as tconfigs
from repro_torch.launch import specs as TS
from repro_torch.launch.mesh import (AbstractMesh, abstract_production_mesh,
                                     production_mesh_shape)

from test_torch_specs import compare_cells

torch.set_num_threads(2)

ARCHS = sorted(tconfigs.all_archs())
POD = ([("16x16", a, s) for a in ARCHS for s in ("train_4k", "decode_32k")]
       + [("2x16x16", a, "prefill_32k") for a in ARCHS])


@pytest.fixture(scope="module", autouse=True)
def cached_param_counts():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "_param_counts",
                   functools.lru_cache(maxsize=None)(JS._param_counts))
        yield


def _meshes(name):
    multi = name == "2x16x16"
    shape, axes = production_mesh_shape(multi)
    return JMesh(shape, axes), abstract_production_mesh(multi)


def test_production_mesh_shape():
    for multi, want in ((False, {"data": 16, "model": 16}),
                        (True, {"pod": 2, "data": 16, "model": 16})):
        mesh = abstract_production_mesh(multi)
        assert mesh.shape == want and mesh.size == (512 if multi else 256)
    with pytest.raises(ValueError, match="extents"):
        AbstractMesh((2, 2), ("data",))


@pytest.mark.parametrize("mesh,arch,shape", POD,
                         ids=[f"{m}-{a}-{s}" for m, a, s in POD])
def test_build_cell_on_the_pod_meshes(mesh, arch, shape):
    jmesh, tmesh = _meshes(mesh)
    jspec, tspec = jconfigs.get(arch), tconfigs.get(arch)
    try:
        jcell = JS.build_cell(jspec, shape, jmesh)
    except ValueError as e:
        with pytest.raises(ValueError, match="skips"):
            TS.build_cell(tspec, shape, tmesh)
        assert "skips" in str(e)
        return
    compare_cells(jcell, TS.build_cell(tspec, shape, tmesh))


@pytest.mark.parametrize("arch", ARCHS)
def test_probe_variants_shrink_and_periods(arch):
    """Both probe variants' cells, ``_shrink`` at k = 1, 2 (every config
    field) and ``n_periods_of``, as the reference's."""
    jspec, tspec = jconfigs.get(arch), tconfigs.get(arch)
    assert TS.n_periods_of(tspec) == JS.n_periods_of(jspec)
    for k in (1, 2):
        assert (dataclasses.asdict(TS._shrink(tspec.full, k))
                == dataclasses.asdict(JS._shrink(jspec.full, k)))
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          devices=jax.devices()[:1])
    tmesh = AbstractMesh((1, 1), ("data", "model"))
    for variant in ("probe1", "probe2"):
        compare_cells(JS.build_cell(jspec, "decode_32k", jmesh, variant),
                      TS.build_cell(tspec, "decode_32k", tmesh, variant))
