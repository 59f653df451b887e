"""Diagonal Fisher information estimation (Eq. 2).

``I_i = E[(d ln p(D|theta) / d theta_i)^2]`` estimated by accumulating squared
gradients of chunk log-likelihoods:

* ``chunk_size == 1`` reproduces the per-sample expectation of Eq. (2) exactly;
* larger chunks match the official SSD implementation (per-batch squared
  gradients), trading estimator variance for throughput.  The alpha-threshold
  comparison and the beta ratio are scale-invariant as long as I_Df and I_D
  use the same chunking.

A batch whose length is not a multiple of ``chunk_size`` is chunked as usual
over its divisible head; the partial TAIL is evaluated exactly as one
smaller chunk, then sample-weighted into the mean.  ``chunked`` itself, the
low-level reshape helper, still requires divisibility and raises an
actionable ``ValueError``.

Chunk gradients come from ``torch.autograd.grad``, one chunk after another
(O(1) extra memory, as the reference's ``lax.map``). Accumulation is f32.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable

import torch

from repro_torch.device import resolve_device
from repro_torch.models.module import tree_leaves, tree_map, tree_unflatten

F32 = torch.float32
Params = Any


def _batch_len(batch) -> int:
    leaves = tree_leaves(batch)
    if not leaves:
        raise ValueError("Fisher estimation got an empty batch tree — "
                         "pass (inputs, labels) arrays with a leading "
                         "sample dimension")
    return int(leaves[0].shape[0])


def _check_chunk_size(chunk_size) -> None:
    if not isinstance(chunk_size, int) or isinstance(chunk_size, bool) \
            or chunk_size < 1:
        raise ValueError(f"chunk_size must be an int >= 1, "
                         f"got {chunk_size!r}")


def chunked(batch, chunk_size: int):
    """Reshape every leaf [N, ...] -> [N//cs, cs, ...].

    N must be a multiple of ``chunk_size``; callers with a partial last
    chunk should use ``diag_fisher``, which splits the tail off and
    evaluates it exactly instead of reshaping."""
    _check_chunk_size(chunk_size)
    n = _batch_len(batch)
    if n % chunk_size != 0:
        raise ValueError(
            f"batch length {n} is not a multiple of chunk_size "
            f"{chunk_size}; pad the batch to a multiple, or call "
            f"diag_fisher / diag_fisher_streaming, which evaluate the "
            f"partial last chunk exactly at its own size")
    return tree_map(
        lambda x: x.reshape(n // chunk_size, chunk_size, *x.shape[1:]), batch)


def _chunk_grad(loss_fn, params: Params, chunk) -> Params:
    """d loss_fn(params, chunk) / d params, as a tree like ``params``."""
    with torch.enable_grad():
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        leaves = tree_leaves(p)
        grads = torch.autograd.grad(loss_fn(p, chunk), leaves)
    return tree_unflatten(params, list(grads))


def fisher_tree(loss_fn: Callable[[Params, Any], torch.Tensor],
                params: Params, batch: Any, chunk_size: int) -> Params:
    """Diag-Fisher body: mean over chunks of squared chunk-gradients, with
    the partial tail (if any) evaluated exactly as one smaller chunk and
    sample-weighted into the mean."""
    n = _batch_len(batch)
    if n < 1:
        # a zero-sample batch would otherwise average over nothing and
        # return an all-NaN Fisher that poisons the installed I_D
        raise ValueError(
            "Fisher estimation needs at least one sample in the batch "
            "(leading dimension is 0 — check the retain split)")
    head = (n // chunk_size) * chunk_size

    def mean_sq_over(chunks_batch, cs):
        chunks = chunked(chunks_batch, cs)
        nc = _batch_len(chunks)
        total = None
        for i in range(nc):
            g = _chunk_grad(loss_fn, params,
                            tree_map(lambda x: x[i], chunks))
            if total is None:
                total = tree_map(lambda x: x.to(F32) * x.to(F32), g)
            else:
                tree_map(lambda t, x: t.addcmul_(x.to(F32), x.to(F32)),
                         total, g)
        return tree_map(lambda x: x / nc, total)

    if head == n:
        return mean_sq_over(batch, chunk_size)
    if head == 0:  # the whole batch is one partial chunk
        return mean_sq_over(batch, n)
    f_head = mean_sq_over(tree_map(lambda x: x[:head], batch), chunk_size)
    f_tail = mean_sq_over(tree_map(lambda x: x[head:], batch), n - head)
    w_h, w_t = head / n, (n - head) / n
    return tree_map(lambda a, b: w_h * a + w_t * b, f_head, f_tail)


def _on_device(batch, dev: torch.device):
    return tree_map(lambda x: torch.as_tensor(x, device=dev), batch)


def diag_fisher(loss_fn: Callable[[Params, Any], torch.Tensor],
                params: Params, batch: Any, chunk_size: int = 8, *,
                device="cuda") -> Params:
    """Diagonal Fisher of ``params`` on ``batch`` (leaves [N, ...], numpy
    arrays or tensors; moved to ``device``).

    ``loss_fn(params, chunk) -> scalar`` must be the mean NLL over the chunk.
    Returns a tree matching ``params`` with f32 leaves.  N need not divide
    ``chunk_size`` — see ``fisher_tree`` for the partial-tail handling."""
    dev = resolve_device(device)
    _check_chunk_size(chunk_size)
    _batch_len(batch)  # empty-tree check (n==0 raises in fisher_tree)
    return fisher_tree(loss_fn, params, _on_device(batch, dev), chunk_size)


def diag_fisher_streaming(loss_fn, params, batches: Iterable[Any],
                          chunk_size: int = 8, *, device="cuda") -> Params:
    """Global importance I_D over a dataset iterator (computed once after
    training and stored, per SSD).  Each batch contributes with equal
    weight (the per-batch Fisher mean)."""
    total = None
    n = 0
    for b in batches:
        f = diag_fisher(loss_fn, params, b, chunk_size, device=device)
        total = f if total is None else tree_map(torch.add, total, f)
        n += 1
    if n == 0:
        raise ValueError(
            "diag_fisher_streaming got an empty dataset iterator — the "
            "global Fisher I_D needs at least one retain microbatch "
            "(check the retain split / data loader)")
    return tree_map(lambda x: x * (1.0 / n), total)
