"""Production mesh construction (port of ``repro.launch.mesh``).

Single pod: (16, 16)       -> ("data", "model")       = 256 ranks
Multi pod:  (2, 16, 16)    -> ("pod", "data", "model") = 512 ranks

A ``Mesh`` wraps a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions and exposes ``.shape`` as the reference's mesh does: a mapping
axis name -> extent, in mesh order, which is all the sharding rules
(``repro_torch.dist.sharding``) read.

Functions, not module constants: importing this module starts no process
group. Nothing here reaches a network: the one-rank group of
``make_host_mesh`` rendezvouses through a file in a temp dir, and a larger
world is started by the caller (``torch.distributed.init_process_group``
with its own ``init_method``, world size and rank).
"""
from __future__ import annotations

import math
import os
import shutil
import tempfile
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

HOST_AXES = ("data", "model")


class Mesh:
    """A named device mesh: ``device_mesh`` (the DeviceMesh), ``shape``
    (axis name -> extent, in order), ``axis_names`` and ``device_type``.
    Hashes by identity, so it can key the engine's program cache."""

    def __init__(self, device_mesh, *, owns_group: Optional[str] = None):
        if device_mesh.mesh_dim_names is None:
            raise ValueError("a Mesh needs a DeviceMesh with "
                             "mesh_dim_names (the sharding rules read axes "
                             "by name)")
        self.device_mesh = device_mesh
        # the rendezvous dir of a process group this mesh started (closed
        # with it); None when the caller owns the group
        self._owns_group = owns_group

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.device_mesh.mesh_dim_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.device_mesh.shape))

    @property
    def device_type(self) -> str:
        return self.device_mesh.device_type

    @property
    def size(self) -> int:
        return self.device_mesh.size()

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({dims}, {self.device_type!r})"

    def close(self) -> None:
        """Destroy the process group this mesh started (make_host_mesh's
        one-rank group); a no-op for a group the caller started."""
        if self._owns_group is not None:
            if dist.is_initialized():
                dist.destroy_process_group()
            shutil.rmtree(self._owns_group, ignore_errors=True)
            self._owns_group = None


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device="cuda") -> Mesh:
    """A mesh of ``shape`` named ``axes`` over the ranks of the running
    process group, rank r at row-major position r. The group must be
    started (``torch.distributed.init_process_group``) with a world of
    exactly ``prod(shape)`` ranks."""
    dev = resolve_device(device)
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"make_mesh got {len(shape)} extents {shape} for "
                         f"{len(axes)} axis names {axes}")
    n = math.prod(shape)
    if not dist.is_initialized():
        raise ValueError(
            f"make_mesh needs a running process group of {n} ranks — call "
            f"torch.distributed.init_process_group(backend, init_method=..., "
            f"world_size={n}, rank=...) first")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks, the process "
                         f"group has {world}")
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(n).reshape(shape)
    return Mesh(DeviceMesh(dev.type, ranks, mesh_dim_names=axes))


def production_mesh_shape(multi_pod: bool = False
                          ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(extents, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), HOST_AXES


class AbstractMesh:
    """A mesh by its shape alone, for the dry run: ``shape`` (axis name ->
    extent, in order), ``axis_names`` and ``size``, which is all the
    sharding rules read. It starts no process group and names no device."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        if len(shape) != len(axes):
            raise ValueError(f"AbstractMesh got {len(shape)} extents "
                             f"{tuple(shape)} for {len(axes)} axis names "
                             f"{tuple(axes)}")
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"AbstractMesh({dims})"


def abstract_production_mesh(multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's shape (16 x 16, or 2 x 16 x 16 with
    ``multi_pod``) as an ``AbstractMesh``: no 256 processes."""
    return AbstractMesh(*production_mesh_shape(multi_pod))


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> Mesh:
    shape, axes = production_mesh_shape(multi_pod)
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise ValueError(
            f"need {n} ranks, have {have} — start the process group with "
            f"world_size={n} (torch.distributed.init_process_group, one "
            f"process per card) before building the production mesh; the "
            f"port reads the world size, not XLA_FLAGS")
    return make_mesh(shape, axes, device=device)


def make_host_mesh(device="cuda") -> Mesh:
    """The 1x1 ("data", "model") mesh (axis names kept so the same sharding
    rules apply). Starts a one-rank process group when none is running —
    gloo on the CPU, nccl on the card, rendezvous through a file in a temp
    dir — which ``Mesh.close()`` destroys; a running one-rank group is
    reused."""
    dev = resolve_device(device)
    owned = None
    if not dist.is_initialized():
        owned = tempfile.mkdtemp(prefix="ficabu-pg-")
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group(
            _backend(dev.type),
            init_method=f"file://{os.path.join(owned, 'rendezvous')}",
            world_size=1, rank=0)
    elif dist.get_world_size() != 1:
        raise ValueError(
            f"make_host_mesh builds a one-rank mesh, but the running "
            f"process group has {dist.get_world_size()} ranks — use "
            f"make_mesh for a larger world")
    mesh = make_mesh((1, 1), HOST_AXES, device=dev)
    mesh._owns_group = owned
    return mesh
