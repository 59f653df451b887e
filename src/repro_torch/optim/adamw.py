"""AdamW + cosine schedule + global-norm clipping (port of
``repro.optim.adamw``), in plain PyTorch: no ``torch.optim``.

The optimizer is functional, as the reference's: ``adamw_update`` takes the
gradient, state and parameter trees and returns NEW parameter and state
trees; the caller's tensors are never written. The state mirrors the
parameters (``mu``, ``nu``: one tensor per leaf in ``state_dtype``) beside
a 0-d int32 ``step`` on the parameters' device, so it checkpoints like
them (``repro_torch.ckpt``).

Every scalar is an f32 tensor, as the reference computes them: the step
count, the bias corrections ``1 - b ** step``, the schedule's warm-up ratio
and cosine, the learning rate and the clip scale ``min(1, clip_norm /
max(gn, 1e-9))``. Python floats would hold them in f64 and round
differently. Constants (``b1``, ``1 - b1``, ...) are rounded to f32 once,
as JAX rounds a weakly typed Python scalar against an f32 array; the
reference's ``(1 - min_lr_frac) * 0.5`` is a Python product, so it is too.
The schedule's cosine is taken in f64 and rounded to f32 once: that is the
value the reference's eager ``jnp.cos`` gives at every step tested, where
``torch.cos`` in f32 is an ulp off at some. Inside the reference's jitted
train step XLA multiplies by the reciprocal of a constant divisor and fuses
multiply-adds, so its learning rate may sit one f32 ulp from the eager
one; the port follows the source, the eager form (tests/test_torch_optim.py
states both bounds).

``global_norm`` sums each leaf's f32 sum of squares in ``tree_leaves``
order (sorted dict keys, as ``jax.tree_util``) into an f32 accumulator, as
the reference's Python ``sum`` does. bf16 leaves update in f32 and are
cast back to their dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.models.module import tree_leaves, tree_map, tree_unflatten

F32 = torch.float32
Params = Any


def _c(x: float) -> float:
    """A Python constant rounded to f32 once."""
    return float(np.float32(x))


class AdamState(NamedTuple):
    step: torch.Tensor   # 0-d int32, on the parameters' device
    mu: Params
    nu: Params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    state_dtype: torch.dtype = torch.float32  # bf16 halves optimizer memory


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine decay
    to ``min_lr_frac * lr`` at ``total_steps``: an f32 0-d tensor on
    ``step``'s device."""
    s = torch.as_tensor(step).to(F32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = ((s - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = torch.cos((prog * _c(math.pi)).double()).to(F32)
    cos = _c(cfg.min_lr_frac) + _c((1 - cfg.min_lr_frac) * 0.5) * (1.0 + cos)
    return _c(cfg.lr) * torch.where(s < cfg.warmup_steps, warm, cos)


def init_adamw(cfg: AdamWConfig, params: Params) -> AdamState:
    """Zero moments in ``state_dtype``, step 0, on the parameters'
    device."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")

    def z(p):
        return tree_map(lambda x: torch.zeros(x.shape, dtype=cfg.state_dtype,
                                              device=x.device), p)

    return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                     mu=z(params), nu=z(params))


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum over leaves (in ``tree_leaves`` order) of each
    leaf's f32 sum of squares, accumulated in f32."""
    total = None
    for x in tree_leaves(tree):
        x = x.to(F32)
        s = (x * x).sum()
        total = s if total is None else total + s
    if total is None:
        return torch.zeros((), dtype=F32)
    return torch.sqrt(total)


def adamw_update(cfg: AdamWConfig, grads: Params, state: AdamState,
                 params: Params) -> Tuple[Params, AdamState]:
    """One AdamW step with global-norm clipping and the cosine schedule.
    Returns ``(new_params, new_state)``; nothing of the caller's is
    written."""
    with torch.no_grad():
        step = state.step + 1
        gn = global_norm(grads)
        # a true division (``float / tensor`` takes the reciprocal first)
        scale = torch.clamp_max(torch.div(
            torch.tensor(_c(cfg.clip_norm), dtype=F32, device=gn.device),
            torch.maximum(gn, torch.tensor(1e-9, dtype=F32,
                                           device=gn.device))), 1.0)
        lr = cosine_lr(cfg, step)
        sf = step.to(F32)
        b1c = 1.0 - torch.pow(torch.tensor(_c(cfg.b1), device=sf.device), sf)
        b2c = 1.0 - torch.pow(torch.tensor(_c(cfg.b2), device=sf.device), sf)
        b1, b2 = _c(cfg.b1), _c(cfg.b2)
        c1, c2 = _c(1 - cfg.b1), _c(1 - cfg.b2)
        eps, wd = _c(cfg.eps), _c(cfg.weight_decay)

        def upd(p, g, m, v):
            g = g.to(F32) * scale
            m2 = b1 * m.to(F32) + c1 * g
            v2 = b2 * v.to(F32) + c2 * g * g
            mh = m2 / b1c
            vh = v2 / b2c
            pf = p.to(F32)
            delta = mh / (torch.sqrt(vh) + eps) + wd * pf
            return ((pf - lr * delta).to(p.dtype),
                    m2.to(cfg.state_dtype), v2.to(cfg.state_dtype))

        outs = [upd(p, g, m, v) for p, g, m, v in zip(
            tree_leaves(params), tree_leaves(grads), tree_leaves(state.mu),
            tree_leaves(state.nu))]
    return (tree_unflatten(params, [o[0] for o in outs]),
            AdamState(step=step,
                      mu=tree_unflatten(params, [o[1] for o in outs]),
                      nu=tree_unflatten(params, [o[2] for o in outs])))


def value_and_grad(loss_fn: Callable[[Params, Any], torch.Tensor],
                   params: Params, batch: Any
                   ) -> Tuple[torch.Tensor, Params]:
    """``(loss, d loss / d params)`` by autograd on detached leaf copies
    of ``params`` (the caller's tensors get no ``.grad``), the gradient a
    tree like ``params`` in each leaf's dtype."""
    with torch.enable_grad():
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = loss_fn(p, batch)
        grads = torch.autograd.grad(loss, tree_leaves(p))
    return loss.detach(), tree_unflatten(params, list(grads))


def make_train_step(loss_fn: Callable[[Params, Any], torch.Tensor],
                    cfg: AdamWConfig) -> Callable:
    """``step(params, state, batch) -> (params, state, loss)``: the loss
    and gradient by autograd, then ``adamw_update``. Gradient compression
    (``optim.compression``) is composed by the launcher, which owns the
    error-feedback state."""
    def step(params, state, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        params, state = adamw_update(cfg, grads, state, params)
        return params, state, loss

    return step
