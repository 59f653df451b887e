"""Sharding rules for the production mesh (port of ``repro.dist.sharding``):
one place that decides how every tensor in the system — parameters, token
batches, KV caches — is laid out over the ("data", "model") (optionally
("pod", "data", "model")) mesh.

Rules are *structural*: they look only at the parameter path and the leaf
rank, never at a concrete model config, so the same function covers every
arch in the zoo (dense, MoE, recurrent, enc-dec) and the engine's per-layer
subtrees.

Two parallelism modes:
  "tp"    TP+FSDP hybrid (default): matrices [in, out] are sharded
          ("data", "model"); the embedding [vocab, d] is transposed to
          ("model", "data") so the vocab all-gather rides the model axis;
          stacked MoE expert weights [E, D, F] put experts on "model"
          (expert parallelism) and D on "data".
  "fsdp"  pure ZeRO-3: every parameter is sharded over ALL devices along
          its largest dimension; nothing is model-parallel.

A spec is a ``P``: a tuple with one entry per tensor dimension, each None,
an axis name or a tuple of names; it compares equal to the reference's
``PartitionSpec`` by ``tuple(spec)``. The rules read only a mapping
``mesh.shape`` of axis name -> extent (tests pass a fake). The port's conv
weights are OIHW where the reference's are HWIO: their rules run in the
reference's order and the spec is permuted back, so both packages shard
the same physical axis. ``placements`` turns a spec into the DTensor
placements of a mesh.

Every public helper accepts an optional mesh; when given, specs are fitted
with ``_fit_spec`` so any axis whose mesh extent does not divide the tensor
dimension degrades to replication instead of erroring — the elastic-mesh
path (1x1 meshes, odd vocab sizes, tiny adapter layers) depends on this.
"""
from __future__ import annotations

import math
from typing import Any, List, Sequence, Tuple

from repro_torch.bridge import is_conv_weight
from repro_torch.models.module import map_with_paths

Params = Any

# conv leaves: the port's OIHW axes in the reference's HWIO order, and back
_OIHW_AS_HWIO = (2, 3, 1, 0)
_HWIO_AS_OIHW = (3, 2, 0, 1)


class P(tuple):
    """A partition spec: one entry per tensor dimension (None, an axis name
    or a tuple of axis names, major to minor)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _path_str(path) -> str:
    """A path as the rules read it: 'a/b/c'."""
    return path if isinstance(path, str) else "/".join(str(p) for p in path)


def _axis_size(mesh, axis) -> int:
    """Total devices behind a spec entry (str or tuple of axis names)."""
    if axis is None:
        return 1
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    return math.prod(int(mesh.shape[a]) for a in axes)


def _mesh_axes(mesh) -> Tuple[str, ...]:
    return tuple(mesh.shape.keys())


def _collapse(axes: Sequence[str]):
    """Singleton axis tuples collapse to the bare name for readable specs."""
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def dp_size(mesh) -> int:
    """Data-parallel degree: the product of the batch-bearing axes."""
    return math.prod(int(mesh.shape[a]) for a in _mesh_axes(mesh)
                     if a in ("pod", "data"))


def _fit_spec(spec: P, shape: Tuple[int, ...], mesh) -> P:
    """Degrade non-dividing axes to replication.

    For each dimension, keep the spec entry only if the total mesh extent
    behind it divides the tensor dimension; otherwise replicate that dim.
    ``mesh`` only needs a ``.shape`` mapping (tests pass a fake).
    """
    out = []
    for d, size in enumerate(shape):
        axis = spec[d] if d < len(spec) else None
        n = _axis_size(mesh, axis)
        out.append(axis if size % n == 0 else None)
    return P(*out)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def _leaf_spec_tp(path: str, shape: Tuple[int, ...]) -> P:
    leaf_name = path.rsplit("/", 1)[-1]
    stacked = "period_stack" in path
    prefix: Tuple = (None,) if stacked and len(shape) >= 1 else ()
    dims = shape[1:] if stacked else shape
    r = len(dims)

    if "embed" in path and r == 2:
        return P(*prefix, "model", "data")          # [vocab, d]
    if "router" in path:
        return P(*prefix, *([None] * r))            # tiny; replicate
    if r == 3 and "ffn" in path and leaf_name.startswith("w_") \
            and "shared" not in path:
        return P(*prefix, "model", "data", None)    # MoE experts [E, D, F]
    if r == 2:
        return P(*prefix, "data", "model")          # matrices [in, out]
    if r == 3:
        return P(*prefix, None, "data", "model")    # unknown leading stack
    return P(*prefix, *([None] * r))                # vectors / scalars


def _leaf_spec_fsdp(path: str, shape: Tuple[int, ...], all_axes) -> P:
    if len(shape) == 0 or max(shape) <= 1:
        return P(*([None] * len(shape)))
    d = max(range(len(shape)), key=lambda i: shape[i])
    out = [None] * len(shape)
    out[d] = _collapse(all_axes)
    return P(*out)


def _check_mode(fn: str, mode: str) -> None:
    if mode not in ("tp", "fsdp"):
        raise ValueError(
            f"{fn} mode must be 'tp' or 'fsdp', got {mode!r}")


def _fsdp_axes(mesh) -> List[str]:
    return ([a for a in _mesh_axes(mesh) if a != "pod"]
            if mesh is not None else ["data", "model"])


def _map_specs(tree: Params, rule) -> Params:
    """``rule(path, shape) -> P`` over every leaf, conv leaves in the
    reference's HWIO order (the spec permuted back to OIHW)."""
    def one(path, leaf):
        shape = tuple(leaf.shape)
        if not is_conv_weight(path, len(shape)):
            return rule(path, shape)
        spec = rule(path, tuple(shape[i] for i in _OIHW_AS_HWIO))
        return P(*(spec[i] for i in _HWIO_AS_OIHW))

    return map_with_paths(one, tree)


def param_pspecs(tree: Params, mesh=None, mode: str = "tp") -> Params:
    """Spec tree for a parameter tree (see module docstring).

    Without a mesh, returns the raw structural rules; with one, every spec
    is divisibility-fitted for that mesh.
    """
    _check_mode("param_pspecs", mode)
    axes = _fsdp_axes(mesh)

    def rule(path, shape):
        spec = (_leaf_spec_fsdp(path, shape, axes) if mode == "fsdp"
                else _leaf_spec_tp(path, shape))
        return _fit_spec(spec, shape, mesh) if mesh is not None else spec

    return _map_specs(tree, rule)


def stacked_param_pspecs(tree: Params, mesh=None, mode: str = "tp") -> Params:
    """Specs for a leading-``[L, ...]`` per-layer STACK (the scanned-sweep
    program's layout, ``repro_torch.engine.sweep``): the stack dimension is
    replicated — the sweep walks it layer by layer, so sharding it would
    put collectives inside every step — and the per-layer dimensions follow
    the same structural rule as the unstacked parameter.

    Like ``param_pspecs``, passing a mesh divisibility-fits every spec so
    non-dividing axes degrade to replication.
    """
    _check_mode("stacked_param_pspecs", mode)
    axes = _fsdp_axes(mesh)

    def one(path, leaf):
        shape = tuple(leaf.shape)
        inner_shape = shape[1:]
        if mode == "fsdp":
            inner = _leaf_spec_fsdp(path, inner_shape, axes)
        else:
            inner = _leaf_spec_tp(path, inner_shape)
        spec = P(None, *inner)
        return _fit_spec(spec, shape, mesh) if mesh is not None else spec

    return map_with_paths(one, tree)


# ---------------------------------------------------------------------------
# batches / activations
# ---------------------------------------------------------------------------
def batch_pspec(mesh, global_batch: int, ndim: int, mode: str = "tp") -> P:
    """Spec for a [B, ...] batch tensor: the batch dim rides the DP axes
    ("pod" + "data"; in fsdp mode also "model" — there is no TP to respect),
    the rest replicated. Falls back to full replication when the mesh's DP
    extent does not divide B."""
    axes = [a for a in _mesh_axes(mesh) if a in ("pod", "data")]
    if mode == "fsdp" and "model" in _mesh_axes(mesh):
        axes.append("model")
    n = math.prod(int(mesh.shape[a]) for a in axes)
    if not axes or global_batch % n != 0:
        return P(*([None] * ndim))
    return P(_collapse(axes), *([None] * (ndim - 1)))


def cache_pspecs(cache_tree: Params, mesh, global_batch: int) -> Params:
    """Specs for decode caches (KV blocks, recurrent states): shard the
    batch dimension on "data", replicate everything else. The batch dim is
    dim 0 for tail-layer leaves and dim 1 for period-stacked leaves (dim 0
    is the layer stack)."""
    data = math.prod(int(mesh.shape[a]) for a in _mesh_axes(mesh)
                     if a in ("pod", "data"))

    def one(path, leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        stacked = "period_stack" in path
        b_dim = 1 if stacked and len(shape) >= 2 else 0
        if len(shape) > b_dim and shape[b_dim] == global_batch \
                and data > 1 and global_batch % data == 0:
            axes = [a for a in _mesh_axes(mesh) if a in ("pod", "data")]
            spec[b_dim] = _collapse(axes)
        return P(*spec)

    return map_with_paths(one, cache_tree)


def spec_leaves(tree) -> List[P]:
    """The specs of a spec tree in the parameter tree's leaf order (sorted
    dict keys); a ``P`` is a leaf, not a node."""
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in spec_leaves(tree[k])]
    return [s for sub in tree for s in spec_leaves(sub)]


def spec_paths(tree, prefix: str = "") -> dict:
    """{'a/b/c': spec} for a spec tree."""
    if isinstance(tree, P):
        return {prefix[:-1]: tree}
    items = (sorted(tree.items()) if isinstance(tree, dict)
             else enumerate(tree))
    out: dict = {}
    for k, v in items:
        out.update(spec_paths(v, f"{prefix}{k}/"))
    return out


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------
def placements(spec: Sequence, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh
    dimension: ``Shard(d)`` where the mesh axis appears at tensor dim ``d``
    (alone or inside a tuple entry), ``Replicate()`` elsewhere. A tuple
    entry shards its dim over several mesh dims; DTensor splits them in
    mesh order, so the tuple must name them in mesh order (major to minor,
    as JAX reads it)."""
    from torch.distributed.tensor import Replicate, Shard

    names = _mesh_axes(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {tuple(spec)} names mesh axis {a!r}, "
                                 f"but the mesh's axes are {names}")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(
                f"spec entry {entry!r} at dim {d} names its mesh axes out of "
                f"mesh order {names}: DTensor splits a dim over mesh dims in "
                f"mesh order only")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {tuple(spec)} puts mesh axis "
                                 f"{names[i]!r} on two tensor dims")
            out[i] = Shard(d)
    return tuple(out)
