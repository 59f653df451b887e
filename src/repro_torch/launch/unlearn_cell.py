"""HC-3, the paper's technique at pod scale (port of
``repro.launch.unlearn_cell``): ONE per-layer CAU step of yi-6b (a forget
batch of 64 x 4096 tokens) on the 16 x 16 mesh, one attention block's
backward products, the diagonal Fisher's square-accumulate (FIMD) and
select / beta / multiply (dampening), in two variants:

  "streamed"  the paper's DRAM-streaming organisation: three programs
              (the vjp's gradients -> stored; their squares <- loaded;
              ``dampen_tree``), the gradient and the Fisher each making a
              round trip through HBM between them;
  "fused"     the production per-layer step, ``engine.build_fused_step``,
              which the serving engine caches per layer shape.

Each is what one rank runs (``launch.dryrun``): its share of the forget
rows (64 / 16 = 4) on the whole, gathered block, counted under
``FakeTensorMode``, with the collectives of the port's sharded execution
(the block's sharded leaves gathered, its gradient all-reduced over the
batch axes) and read at a card's peaks.

    PYTHONPATH=src python -m repro_torch.launch.unlearn_cell \\
        --device cpu --card "NVIDIA H100 80GB HBM3"

It writes ``experiments/torch_perf/unlearn_cell.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from repro_torch import configs
from repro_torch.api import UnlearnSpec
from repro_torch.core.ssd import dampen_tree
from repro_torch.dist.sharding import _axis_size, batch_pspec, spec_paths
from repro_torch.engine import build_fused_step
from repro_torch.kernels.ops import f32
from repro_torch.launch import roofline as RL
from repro_torch.launch.dryrun import card_of, count_program
from repro_torch.launch.mesh import abstract_production_mesh
from repro_torch.launch.specs import eval_shape
from repro_torch.models import lm as LM
from repro_torch.models.module import (flatten_with_paths, tree_leaves,
                                       tree_map, tree_unflatten)

F32 = torch.float32
ARCH = "yi-6b"
N_FORGET = 64
SEQ = 4096
# the analysed cell's configuration, as the same typed spec serving uses
# (mode "ssd": one uniform-strength layer step, no CAU machinery involved)
SPEC = UnlearnSpec.for_mode("ssd", alpha=10.0, lam=1.0, chunk_size=1,
                            mesh_axes=("data", "model"), sharding="tp")


def layer_fn(cfg: LM.LMConfig) -> Callable:
    """One mid-stack attention block's forward, ``f(blk, act)``, act
    [N, S, D] at positions 0..S-1."""
    def f(blk, act):
        N, S = act.shape[0], act.shape[1]
        pos = torch.arange(S, device=act.device)[None].expand(N, S)
        out, _ = LM.block_forward(blk, cfg, "attn", act, pos)
        return out
    return f


def grads_program(layer: Callable) -> Callable:
    """``(blk, act, cot) -> (g_blk, g_act)``: the block's vjp."""
    def grads(blk, act, cot):
        with torch.enable_grad():
            lp = tree_map(lambda t: t.detach().requires_grad_(True), blk)
            a = act.detach().requires_grad_(True)
            g = torch.autograd.grad(layer(lp, a), tree_leaves(lp) + [a],
                                    grad_outputs=cot)
        return tree_unflatten(blk, list(g[:-1])), g[-1]
    return grads


def fimd_program(g_blk):
    """The gradients' squares in f32: the diagonal Fisher of one chunk."""
    return tree_map(lambda g: g.to(F32) ** 2, g_blk)


def dampen_program(blk, fish, fish_global):
    """``core.ssd.dampen_tree`` at SPEC's alpha and lambda: ``blk'``."""
    with torch.no_grad():
        return dampen_tree(blk, fish, fish_global, SPEC.dampen.alpha,
                           SPEC.dampen.lam)[0]


def fused_program(layer: Callable, use_kernel: bool = False) -> Callable:
    """The production fused step, ``step(ctx, blk, fisher_g, acts_c,
    cot_c, scalars) -> (blk', g_acts, n_selected)`` with one chunk
    [1, N, S, D]."""
    return build_fused_step(lambda ctx, blk, act: layer(blk, act),
                            use_kernel=use_kernel, tag="unlearn_cell")


def scalars():
    return (f32(SPEC.dampen.alpha), f32(SPEC.dampen.lam))


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def run(*, card: Optional[str] = None, device="cuda") -> Dict[str, Any]:
    """Both variants' terms for yi-6b FULL (N_FORGET x SEQ) at ``card``'s
    peaks (the card of ``device`` unless given)."""
    card = card_of(card, device)
    cfg = configs.get(ARCH).full
    n_forget, seq = N_FORGET, SEQ
    mesh = abstract_production_mesh()
    chips = mesh.size
    rows = n_forget // _axis_size(mesh, batch_pspec(mesh, n_forget, 3)[0])
    blk = eval_shape(LM.init_block, None, cfg, "attn", device="cpu")
    specs = spec_paths(SPEC.exec.param_pspecs(blk, mesh))
    act = _meta((rows, seq, cfg.d_model), torch.bfloat16)
    fisher = tree_map(lambda t: _meta(t.shape, F32), blk)

    # the port's sharded execution: the block's sharded leaves gathered,
    # the gradient all-reduced over the batch ranks (rows < n_forget)
    gather = [("all-gather", (RL.dtype_name(t.dtype), tuple(t.shape)))
              for p, t in flatten_with_paths(blk)
              if any(_axis_size(mesh, e) > 1 for e in specs[p])]
    reduce = ([("all-reduce", (RL.dtype_name(t.dtype), tuple(t.shape)))
               for t in tree_leaves(blk)] if rows < n_forget else [])

    def analyse(c, colls) -> Dict[str, float]:
        coll = RL.collective_stats(colls)
        cost = {"flops": c["flops"], "bytes accessed": c["bytes"]}
        terms = RL.roofline_terms(cost, coll["bytes_per_device"], chips,
                                  model_flops=0.0, card=card)
        return {"flops": float(c["flops"]), "bytes": float(c["bytes"]),
                "collective_bytes": coll["bytes_per_device"],
                "compute_s": terms["compute_s"],
                "memory_s": terms["memory_s"],
                "collective_s": terms["collective_s"],
                "temp_gib": c["temp_size_in_bytes"] / 2**30,
                "seconds": c["seconds"]}

    layer = layer_fn(cfg)
    r1 = analyse(count_program(grads_program(layer), (blk, act, act)),
                 gather + reduce)
    grads = tree_map(lambda t: _meta(t.shape, t.dtype), blk)
    r2 = analyse(count_program(fimd_program, (grads,)), [])
    r3 = analyse(count_program(dampen_program, (blk, fisher, fisher)), [])
    streamed = {k: r1[k] + r2[k] + r3[k]
                for k in ("flops", "bytes", "collective_bytes", "compute_s",
                          "memory_s", "collective_s")}
    # plus the round trips between the programs the paper's streaming pays
    # explicitly: the gradients stored and loaded, the Fisher stored and
    # loaded (the reference's reckoning, over the chips)
    n_blk_bytes = sum(t.numel() * 4 for t in tree_leaves(blk))
    streamed["bytes"] += 2 * 2 * n_blk_bytes / chips
    streamed["memory_s"] = streamed["bytes"] / RL.peaks(card)["hbm"]
    streamed["programs"] = {"grads": r1, "fimd": r2, "dampen": r3}

    acts_c = _meta((1,) + tuple(act.shape), act.dtype)
    fused = analyse(count_program(fused_program(layer),
                                  (None, blk, fisher, acts_c, acts_c,
                                   scalars())), gather + reduce)
    return {"streamed": streamed, "fused": fused,
            "speedup_memory_term": streamed["memory_s"] / fused["memory_s"],
            "cell": (f"{cfg.name} CAU layer step, N={n_forget} S={seq}, "
                     f"16x16"),
            "rows_per_rank": rows, "card": card,
            "spec": SPEC.to_dict()}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the card whose peaks the terms read (cuda), or "
                         "cpu with --card")
    ap.add_argument("--card", default=None,
                    help="the card whose peaks the terms read (default: "
                         "the card of --device)")
    ap.add_argument("--out", default="experiments/torch_perf")
    args = ap.parse_args(argv)
    t0 = time.time()
    res = run(card=args.card, device=args.device)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "unlearn_cell.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))
    print(f"[unlearn_cell] done in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
