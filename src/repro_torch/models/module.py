"""Minimal module substrate: initialisers and nested-dict tree helpers.

Parameters are nested dicts of tensors ("trees") with the JAX package's
keys. The tree helpers visit dict keys in SORTED order, as
``jax.tree_util`` does, so leaf lists line up with the reference's whatever
order a dict was built in; tuples and lists (batches) keep their order.

Initialisers draw from an explicit ``torch.Generator`` on the generator's
own device and then move to ``device``: a CPU generator gives the same
weights on every device for one seed, a CUDA generator makes a large model
on the card without a trip through the host.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Initialisers
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               device, dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init, [d_in, d_out] (the JAX layout)."""
    std = 1.0 / math.sqrt(d_in)
    w = torch.empty(d_in, d_out, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, a=-2.0, b=2.0, generator=gen)
    return (w * std).to(device=device, dtype=dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, *,
               device, dtype=torch.float32) -> torch.Tensor:
    """Normal(0, 0.02) token embedding, [vocab, d]."""
    w = torch.randn(vocab, d, generator=gen, dtype=torch.float32,
                    device=gen.device) * 0.02
    return w.to(device=device, dtype=dtype)


def zeros(shape, *, device, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def ones(shape, *, device, dtype=torch.float32) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Tree utilities
# ---------------------------------------------------------------------------
def _children(tree) -> List[Tuple[Any, Any]]:
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    return list(enumerate(tree))


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def tree_leaves(tree) -> List[Any]:
    if not _is_node(tree):
        return [] if tree is None else [tree]
    return [leaf for _, sub in _children(tree) for leaf in tree_leaves(sub)]


def tree_map(fn: Callable, tree, *rests):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rests`` (matched by key, not by position)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rests))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rests))
                          for i, v in enumerate(tree))
    return fn(tree, *rests)


def tree_unflatten(like, leaves: List[Any]):
    """Inverse of ``tree_leaves``: a tree shaped like ``like`` holding
    ``leaves`` in sorted-key order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten got more leaves than the tree holds")
    return out


def flatten_with_paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """Yield ('a/b/c', leaf) pairs in deterministic (sorted-key) order."""
    if _is_node(tree):
        for k, v in _children(tree):
            yield from flatten_with_paths(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def index_tree(tree: Params, i: int) -> Params:
    """Index the leading (stacked layer) axis of every leaf: views into the
    stacked tensors, not copies."""
    return tree_map(lambda x: x[i], tree)


def map_with_paths(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """Like tree_map but ``fn`` also receives the 'a/b/c' path string."""
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_paths(fn, v, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)
