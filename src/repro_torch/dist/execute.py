"""Sharded execution: how the engine runs a request whose parameters,
Fisher and batch are DTensors laid out by ``repro_torch.dist.sharding``.

The reference runs a sharded request as one GSPMD program: placements
never change a value, only where it is computed. PyTorch has no such
compiler, and DTensor has no rule for the port's ctypes kernels, so the
port runs a request in the ZeRO-3 manner, not tensor-parallel:

  * storage: parameters, Fisher and batches live with the reference's
    placements; a rank holds its shard;
  * layer products run GATHERED: the request gathers the parameter and
    Fisher trees (``full_tensor``) and runs the engine's per-layer vjp on
    whole weights;
  * the batch is split over the axes that shard its rows (``batch_pspec``:
    "pod" and "data", and "model" in fsdp mode): a rank runs its own rows'
    chunks, and ``grad_fisher_chunks`` / ``fisher_tree`` all-reduce the
    Fisher's partial sums over those axes before they divide by the global
    chunk count (``ShardedRun.reduce_batch_``);
  * dampening runs on LOCAL shards: each leaf of a layer is cut to this
    rank's part by the layer's placements, dampened by the same kernel
    (``kernels.ops`` takes DTensors), and gathered back into the working
    tree; the selection count is summed over the mesh, each element once;
  * the forget accuracy that decides halting is all-reduced over the batch
    axes (``reduce_acc``), so every rank halts at the same layer;
  * the result is stored again with the caller's placements.

``ShardedRun`` is the per-request context; ``current()`` returns the one
active on this thread (None outside a sharded request), which is how the
engine's Fisher, dampening and accuracy steps find it.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.module import tree_leaves, tree_map, tree_unflatten

from . import sharding as shd

Params = Any
F32 = torch.float32

_TLS = threading.local()


def current() -> Optional["ShardedRun"]:
    """The sharded request running on this thread, or None."""
    return getattr(_TLS, "run", None)


# ---------------------------------------------------------------------------
# DTensor helpers
# ---------------------------------------------------------------------------
def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def first_dtensor(tree) -> Optional[torch.Tensor]:
    """The first DTensor leaf of ``tree`` (sorted-key order), or None."""
    for leaf in tree_leaves(tree):
        if is_dtensor(leaf):
            return leaf
    return None


class _MeshShape:
    """The ``.shape`` mapping the sharding rules read, for a DeviceMesh."""

    def __init__(self, device_mesh):
        self.shape = dict(zip(device_mesh.mesh_dim_names, device_mesh.shape))


def local_slice(t: torch.Tensor, device_mesh, placements) -> torch.Tensor:
    """This rank's part of the whole tensor ``t`` under ``placements`` (a
    view): mesh dims in order, each ``Shard(d)`` cutting dim d into equal
    parts — DTensor's own order for a dim split over several mesh dims."""
    from torch.distributed.tensor import Shard

    coord = device_mesh.get_coordinate()
    for k, p in enumerate(placements):
        if isinstance(p, Shard):
            n = device_mesh.size(k)
            size = t.shape[p.dim]
            if size % n:
                raise ValueError(
                    f"dim {p.dim} of extent {size} does not split evenly "
                    f"over mesh dim {k} of {n} ranks (fit the spec first: "
                    f"dist.sharding._fit_spec)")
            t = t.narrow(p.dim, coord[k] * (size // n), size // n)
    return t


def wrap(local: torch.Tensor, device_mesh, placements,
         like: torch.Tensor) -> torch.Tensor:
    """A DTensor of ``local`` with the global shape of ``like``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, device_mesh, placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride() if not is_dtensor(like)
                              else like.stride())


def place(t: torch.Tensor, device_mesh, placements) -> torch.Tensor:
    """The whole tensor ``t`` stored as a DTensor: this rank keeps its part
    (a contiguous copy); no communication."""
    if is_dtensor(t):
        t = t.full_tensor()
    return wrap(local_slice(t, device_mesh, placements).contiguous(),
                device_mesh, placements, t)


def gather(x):
    """The whole tensor of a DTensor (an all-gather); other values as
    they are."""
    return x.full_tensor() if is_dtensor(x) else x


def gather_tree(tree: Params) -> Params:
    return tree_map(gather, tree)


def local_of(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x``'s part matching the DTensor ``like``: its local shard when it
    is a DTensor with the same placements, the slice of this rank when it
    is a whole tensor."""
    if is_dtensor(x):
        if tuple(x.placements) != tuple(like.placements) \
                or x.device_mesh != like.device_mesh:
            raise ValueError(
                f"an operand laid out {tuple(x.placements)} cannot pair with "
                f"a leaf laid out {tuple(like.placements)} elementwise; "
                f"place both by the same spec")
        return x.to_local()
    return local_slice(x, like.device_mesh, like.placements)


def _owner(placements, coord) -> bool:
    """Whether this rank's copy of its shard is the one that counts: the
    first along every mesh dim that replicates the leaf."""
    from torch.distributed.tensor import Replicate
    return all(c == 0 for p, c in zip(placements, coord)
               if isinstance(p, Replicate))


def sum_over_mesh_(t: torch.Tensor, device_mesh) -> torch.Tensor:
    """All-reduce ``t`` (in place) over every dim of the mesh."""
    import torch.distributed as dist
    for k in range(device_mesh.ndim):
        if device_mesh.size(k) > 1:
            dist.all_reduce(t, group=device_mesh.get_group(k))
    return t


def selection_count(masks: Sequence[torch.Tensor], placements_list,
                    device_mesh, local_count: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """The number of selected elements over the WHOLE leaves, each counted
    once: every rank adds the local masks it owns, then a sum over the
    mesh. ``local_count`` (the kernel's own count of the local table) is
    used when this rank owns every leaf."""
    coord = device_mesh.get_coordinate()
    owned = [_owner(pl, coord) for pl in placements_list]
    if local_count is not None and all(owned):
        total = local_count.clone()
    else:
        dev = masks[0].device if masks else torch.device("cpu")
        total = torch.zeros((), dtype=torch.int64, device=dev)
        for m, own in zip(masks, owned):
            if own:
                total += m.sum()
    return sum_over_mesh_(total, device_mesh)


# ---------------------------------------------------------------------------
# the per-request context
# ---------------------------------------------------------------------------
class ShardedRun:
    """One sharded request: the mesh, the layout rule (``mode``) and the
    mesh dims that split the batch rows (``batch_dims``)."""

    def __init__(self, device_mesh, *, mode: str = "tp",
                 batch_dims: Sequence[int] = ()):
        self.device_mesh = device_mesh
        self.mode = mode
        self.batch_dims = tuple(batch_dims)
        self.dp = math.prod(device_mesh.size(k) for k in self.batch_dims)
        self.mesh_shape = _MeshShape(device_mesh)

    @classmethod
    def for_request(cls, params: Params, batch: Any, *,
                    mode: str = "tp") -> Optional["ShardedRun"]:
        """The run for a request, or None when no parameter leaf is a
        DTensor. The batch rows are split over the mesh dims that shard
        dim 0 of the first batch leaf (when it is a DTensor)."""
        from torch.distributed.tensor import Shard
        p0 = first_dtensor(params)
        if p0 is None:
            return None
        b0 = first_dtensor(batch)
        dims = ()
        if b0 is not None:
            if b0.device_mesh != p0.device_mesh:
                raise ValueError("the forget batch and the parameters lie "
                                 "on different meshes")
            dims = tuple(k for k, p in enumerate(b0.placements)
                         if isinstance(p, Shard) and p.dim == 0)
        return cls(p0.device_mesh, mode=mode, batch_dims=dims)

    @contextlib.contextmanager
    def active(self) -> Iterator["ShardedRun"]:
        prev = current()
        _TLS.run = self
        try:
            yield self
        finally:
            _TLS.run = prev

    @staticmethod
    @contextlib.contextmanager
    def suspended() -> Iterator[None]:
        """No run on this thread for the body (the local computations
        inside a sharded step)."""
        prev = current()
        _TLS.run = None
        try:
            yield
        finally:
            _TLS.run = prev

    # -- the batch ----------------------------------------------------------
    def local_rows(self, batch: Any) -> Any:
        """This rank's rows of a batch tree (a DTensor leaf's local shard;
        a whole tensor stays whole, as on a mesh that does not split it)."""
        return tree_map(lambda x: x.to_local() if is_dtensor(x) else x,
                        batch)

    def rows(self, n_local: int) -> int:
        """The global batch size from this rank's row count."""
        return int(n_local) * self.dp

    def check_chunks(self, n_local: int, chunk_size: int) -> None:
        """A rank runs whole chunks of the global batch: its rows must be a
        multiple of the chunk size when the rows are split."""
        if self.dp > 1 and n_local % chunk_size:
            raise ValueError(
                f"a batch split over {self.dp} ranks gives each "
                f"{n_local} rows, not a multiple of chunk_size "
                f"{chunk_size}: the chunks would straddle ranks — pad the "
                f"batch to a multiple of {self.dp * chunk_size}")

    def reduce_batch_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum ``tensors`` in place over the ranks that hold other rows."""
        import torch.distributed as dist
        for k in self.batch_dims:
            if self.device_mesh.size(k) > 1:
                g = self.device_mesh.get_group(k)
                for t in tensors:
                    dist.all_reduce(t, group=g)

    def reduce_acc(self, acc: torch.Tensor, n_local: int) -> torch.Tensor:
        """The global hit rate from this rank's: the hits are recovered
        exactly (``acc`` is their f32 sum times f32(1 / n), within half a
        hit for n < 2^23), summed over the batch ranks and rescaled as
        ``core.metrics._hit_rate`` does."""
        if self.dp == 1:
            return acc
        hits = torch.round(acc.double() * n_local)
        self.reduce_batch_([hits])
        n = n_local * self.dp
        return hits.to(F32) * float(np.float32(1.0 / n))

    # -- layouts ------------------------------------------------------------
    def layer_placements(self, layer: Params,
                         specs: Optional[List] = None) -> List[tuple]:
        """Placements of a layer's leaves (tree order): by ``specs`` (spec
        leaves in tree order, e.g. the scanned program's stack layout)
        or by the parameter rule on the layer's own subtree."""
        if specs is None:
            specs = shd.spec_leaves(shd.param_pspecs(layer, self.mesh_shape,
                                                     mode=self.mode))
        return [shd.placements(s, self.mesh_shape) for s in specs]

    def shard_like(self, tree: Params, like: Params,
                   gathered: Optional[Params] = None) -> Params:
        """``tree`` (whole tensors) stored with the placements of the
        matching DTensor leaves of ``like``. A leaf that is still the
        gathered copy of ``like``'s leaf (``gathered``, the tree
        ``gather_tree(like)`` returned) comes back as that DTensor itself,
        as an unsharded request returns the layers it did not reach."""
        def one(t, ref, g=None):
            if not is_dtensor(ref):
                return t
            if t is g:
                return ref
            return place(t, ref.device_mesh, ref.placements)
        if gathered is None:
            return tree_map(one, tree, like)
        return tree_map(one, tree, like, gathered)

    # -- dampening on local shards -------------------------------------------
    def dampen_tree(self, counted: Callable, precision: str, params: Params,
                    fisher_f: Params, fisher_g: Params, alpha: float,
                    lam: float, use_kernel: bool, *, in_place: bool = False,
                    specs: Optional[List] = None):
        """``counted`` (``core.ssd.dampen_tree_counted``) on this rank's
        shards of a layer: the parameter leaves become DTensors of their
        local parts, the Fishers pair with them, the kernel (or the plain
        version) edits the local parts, and the edited leaves are gathered
        whole for the working tree. Returns (params', masks as DTensors,
        global count)."""
        dm = self.device_mesh
        flat_p = tree_leaves(params)
        pls = self.layer_placements(params, specs)
        p_d = [wrap(local_slice(t, dm, pl), dm, pl, t)
               for t, pl in zip(flat_p, pls)]
        with self.suspended():
            new_d, masks_d, count = counted(
                precision, tree_unflatten(params, p_d), fisher_f, fisher_g,
                alpha, lam, use_kernel)
        masks = tree_leaves(masks_d)
        if count is None:  # the plain path counts by its masks
            count = selection_count([m.to_local() for m in masks], pls, dm)
        new = [d.full_tensor() for d in tree_leaves(new_d)]
        if in_place:
            new = [t.copy_(n) for t, n in zip(flat_p, new)]
        return (tree_unflatten(params, new), masks_d, count)


def local_call(fn: Callable, theta: torch.Tensor, *operands,
               **kw) -> Any:
    """``fn(theta_local, *operands_local, **kw)`` for a DTensor ``theta``:
    every operand cut to theta's shard (``local_of``), each tensor of the
    result rewrapped with theta's placements."""
    locs = [local_of(o, theta) if isinstance(o, torch.Tensor) else o
            for o in operands]
    out = fn(theta.to_local(), *locs, **kw)

    def rewrap(x):
        if isinstance(x, torch.Tensor) and x.shape == theta.to_local().shape:
            return wrap(x, theta.device_mesh, theta.placements, theta)
        return x

    if isinstance(out, tuple):
        return tuple(rewrap(x) for x in out)
    return rewrap(out)


def reduce_fisher_(fish: Sequence[torch.Tensor], n_chunks: int) -> int:
    """Inside a sharded request: sum the Fisher partial sums over the batch
    ranks (in place) and return the global chunk count; ``n_chunks``
    unchanged outside one."""
    run = current()
    if run is None or run.dp == 1:
        return n_chunks
    run.reduce_batch_(fish)
    return n_chunks * run.dp


def global_acc(acc: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The forget accuracy over the whole batch inside a sharded request
    (``acc`` of this rank's ``labels``); ``acc`` outside one."""
    run = current()
    return acc if run is None else run.reduce_acc(acc, labels.numel())


def global_rows(labels: torch.Tensor) -> int:
    """The global batch size of a request from this rank's labels."""
    run = current()
    n = int(labels.shape[0])
    return n if run is None else run.rows(n)

