"""Random weights from the seed, made on the device in one generator, one
draw per stacked leaf, in the type they are served in.

The tree has the port's layout (``models/lm.py``): ``embed/w`` [V, d];
``period_stack/0/...`` every block's leaves stacked [n_layers, ...]
(``ln1/scale``, ``mixer/{wq, wk, wv, wo}`` in the [d_in, d_out] layout,
``mixer/{bq, bk, bv}`` with q/k/v biases, ``ln2/scale``,
``ffn/{w_gate, w_up, w_down}``); ``final_norm/scale``; ``lm_head/w``
[d, V]. Dense weights are N(0, 1/d_in), the embedding N(0, 0.02^2),
biases N(0, 0.02^2), norm scales 1 + N(0, 0.05^2): a trained model's norm
scales and biases are not constant, and a constant leaf would make its
edits invisible to the check.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from .config import Dims

F32 = torch.float32


def make_params(dims: Dims, seed: int, device) -> Dict[str, Any]:
    dev = torch.device(device)
    dt = getattr(torch, dims.dtype)
    g = torch.Generator(device=dev).manual_seed(int(seed))
    n, d, H, KV, dh, F, V = (dims.n_layers, dims.d_model, dims.n_heads,
                             dims.n_kv_heads, dims.head_dim, dims.d_ff,
                             dims.vocab)

    def normal(shape, std, mean=0.0):
        x = torch.randn(shape, generator=g, device=dev, dtype=F32)
        return (x.mul_(std).add_(mean)).to(dt)

    def dense(d_in, d_out, stacked=True):
        shape = (n, d_in, d_out) if stacked else (d_in, d_out)
        return normal(shape, 1.0 / math.sqrt(d_in))

    mixer = {"wq": dense(d, H * dh), "wk": dense(d, KV * dh),
             "wv": dense(d, KV * dh), "wo": dense(H * dh, d)}
    if dims.qkv_bias:
        mixer.update(bq=normal((n, H * dh), 0.02),
                     bk=normal((n, KV * dh), 0.02),
                     bv=normal((n, KV * dh), 0.02))
    block = {"ln1": {"scale": normal((n, d), 0.05, 1.0)},
             "mixer": mixer,
             "ln2": {"scale": normal((n, d), 0.05, 1.0)},
             "ffn": {"w_gate": dense(d, F), "w_up": dense(d, F),
                     "w_down": dense(F, d)}}
    return {"embed": {"w": normal((V, d), 0.02)},
            "period_stack": {"0": block},
            "final_norm": {"scale": normal((d,), 0.05, 1.0)},
            "lm_head": {"w": dense(d, V, stacked=False)}}


def leaf_items(tree: Dict[str, Any], prefix: str = ""):
    """(path, tensor) of every leaf, keys in sorted order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaf_items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def get_leaf(tree: Dict[str, Any], path: str) -> torch.Tensor:
    node = tree
    for k in path.split("/"):
        node = node[k]
    return node


def layer_leaves(dims: Dims, j: int):
    """The leaves of the paper's layer at depth j (0: the embedding,
    1..n_layers: the blocks, n_layers + 1: the final norm and the head),
    as (path, block index or None)."""
    if j == 0:
        return [("embed/w", None)]
    if j == dims.n_layers + 1:
        return [("final_norm/scale", None), ("lm_head/w", None)]
    block = [p for p, _ in leaf_items({"b": _block_keys(dims)})]
    return [("period_stack/0/" + p[2:], j - 1) for p in block]


def _block_keys(dims: Dims) -> Dict[str, Any]:
    mixer = {k: 0 for k in ("wq", "wk", "wv", "wo")}
    if dims.qkv_bias:
        mixer.update(bq=0, bk=0, bv=0)
    return {"ln1": {"scale": 0}, "mixer": mixer, "ln2": {"scale": 0},
            "ffn": {"w_gate": 0, "w_up": 0, "w_down": 0}}


def layer_tensor(tree: Dict[str, Any], path: str, index) -> torch.Tensor:
    t = get_leaf(tree, path)
    return t if index is None else t[index]


def tree_to(tree: Dict[str, Any], device, done: Dict[int, torch.Tensor]
            ) -> Dict[str, Any]:
    """A copy of ``tree`` on ``device``; a tensor shared between trees
    moves once (``done`` maps a tensor's id to its copy)."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = tree_to(v, device, done)
        else:
            if id(v) not in done:
                done[id(v)] = v.to(device)
            out[k] = done[id(v)]
    return out
