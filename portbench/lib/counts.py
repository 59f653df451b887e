"""The work a forget request needs, counted from the shapes: the
algorithm's need at the cell's sizes and the request's halt depth, never
what a program happens to launch.

FLOPs (2 per multiply-add) of a dense decoder LM with B sequences of S
tokens:

* one forward of the forget batch: per token, each block's projections
  2 (d H dh + 2 d KV dh + H dh d + 3 d d_ff), its attention 2 H dh S
  (q.k and p.v over the S / 2 earlier positions on average: causal,
  halved), the head 2 d V, nothing for the embedding's gather;
* the backward of each swept layer, inputs and weights: twice its
  forward (the embedding's, a scatter, counts 0);
* at each checkpoint hit, the forward of the suffix from that layer to
  the head;
* the Fisher's square-accumulate, 2 per parameter of a swept layer and
  chunk, and the dampening rule, 4 per parameter of a swept layer;
* nothing for the masked work a scanned program does past the halt.

Bytes of the dampening rule: each swept parameter read (its own type),
its forget and global Fisher read (float32 each) and the edit written
(its own type): once each.
"""
from __future__ import annotations

from typing import Iterable

from .config import Dims

_ELT = {"bfloat16": 2, "float16": 2, "float32": 4}


def layer_forward_flops(dims: Dims, j: int, seq_len: int) -> float:
    """FLOPs per token of the paper's layer at depth j (0: embedding,
    1..n: blocks, n + 1: head)."""
    d, H, KV, dh, F = (dims.d_model, dims.n_heads, dims.n_kv_heads,
                       dims.head_dim, dims.d_ff)
    if j == 0:
        return 0.0
    if j == dims.n_layers + 1:
        return 2.0 * d * dims.vocab
    proj = 2.0 * (d * H * dh + 2 * d * KV * dh + H * dh * d + 3 * d * F)
    return proj + 2.0 * H * dh * seq_len


def layer_params(dims: Dims, j: int) -> int:
    d, H, KV, dh, F = (dims.d_model, dims.n_heads, dims.n_kv_heads,
                       dims.head_dim, dims.d_ff)
    if j == 0:
        return dims.vocab * d
    if j == dims.n_layers + 1:
        return d + d * dims.vocab
    bias = (H + 2 * KV) * dh if dims.qkv_bias else 0
    return 2 * d + d * H * dh + 2 * d * KV * dh + H * dh * d + 3 * d * F \
        + bias


def request_flops(dims: Dims, batch: int, seq_len: int, chunk: int,
                  stop_l: int, checkpoints_hit: Iterable[int]) -> float:
    L = dims.n_unlearn_layers
    tok = batch * seq_len
    fwd = [layer_forward_flops(dims, j, seq_len) for j in range(L)]
    total = tok * sum(fwd)
    for l in range(1, stop_l + 1):
        j = L - l
        total += 2.0 * tok * fwd[j]
        total += (2.0 * (batch // chunk) + 4.0) * layer_params(dims, j)
    for c in checkpoints_hit:
        total += tok * sum(fwd[L - c:])
    return total


def dampen_bytes(dims: Dims, stop_l: int) -> float:
    """Bytes the dampening rule needs over the swept layers; biases and
    norm scales are in the parameters' type like every other leaf."""
    elt = _ELT[dims.dtype]
    L = dims.n_unlearn_layers
    n = sum(layer_params(dims, L - l) for l in range(1, stop_l + 1))
    return float(n) * (2 * elt + 4 + 4)

