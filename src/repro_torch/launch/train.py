"""End-to-end training launcher with first-class unlearning (port of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch yi-6b --steps 12 --batch 8 --seq 24 --ckpt-dir /tmp/run1 \
        --unlearn-at 8

What it runs, as the reference does:

  * the train step: the value and gradient of ``LM.lm_loss(p, cfg, toks,
    labels, aux_weight=0.01)`` by autograd, the gradient codec under
    ``--compress int8`` (``optim.Int8Codec`` with its error feedback; the
    EF state is ``{"_": zeros(())}`` without one), then ``adamw_update``
    (``optim.adamw``: the cosine schedule over ``--steps`` with 5 warm-up
    steps, global-norm clipping at 1, weight decay 0.01), in plain
    PyTorch;
  * checkpoint/restart: every ``--ckpt-every`` steps the tree
    ``{"params", "opt": {"step", "mu", "nu"}, "ef"}`` goes through
    ``repro_torch.ckpt`` (the reference's file format) with the data
    pipeline's position (``data_step``) in META, then ``gc_old(keep=2)``;
    ``--resume`` restarts from the newest complete step, the pipeline at
    its ``data_step``;
  * a straggler watchdog: a step whose wall exceeds ``--step-deadline-s``
    is logged and counted. The clock is read before the loss is read back,
    as the reference reads it, so on the card a step's wall is the host's
    time to fetch the batch and enqueue the step's kernels, not the
    device's time (the previous step's loss read has drained the queue);
  * a mid-run forget request at ``--unlearn-at``: journaled, then a
    pre-unlearn checkpoint, then the global Fisher
    (``diag_fisher_streaming`` over the first 64 sequences in batches of
    16, chunk 4) and one FiCABU request on 16 sequences of
    ``--forget-domain`` through ``Unlearner`` (alpha 8, lambda 1, tau 0.6,
    checkpoints every 2 layers, chunk 4; the plain dampen path, as in the
    reference), and training goes on with the edited weights.

``--device`` picks the card (``cuda``, the default; it raises without
one) or ``cpu``. As in the reference, ``--smoke`` is a ``store_true`` flag
that defaults to True, so the command line always trains the SMOKE
config; ``train(cfg, device, args, params=, data=)`` runs the same loop on
any config, initial weights and token data.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import ckpt as CKPT
from repro_torch import configs
from repro_torch.core import adapters, fisher
from repro_torch.data.synthetic import (Batches, LMDataConfig,
                                        lm_split_forget_retain,
                                        make_lm_domains)
from repro_torch.device import resolve_device
from repro_torch.models import lm as LM
from repro_torch.optim import (AdamState, AdamWConfig, Int8Codec,
                               adamw_update, init_adamw, value_and_grad)

Params = Any


def build(arch_id: str, smoke: bool, seq: int, vocab_cap: Optional[int] = None):
    spec = configs.get(arch_id)
    if spec.kind != "lm":
        raise ValueError(
            f"train.py drives LM archs; {arch_id!r} is kind {spec.kind!r} — "
            "see serve.py / the encdec entry points")
    cfg = spec.smoke if smoke else spec.full
    if vocab_cap:
        cfg = cfg.with_(vocab=min(cfg.vocab, vocab_cap))
    return cfg


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_train")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--step-deadline-s", type=float, default=120.0)
    ap.add_argument("--compress", choices=("none", "int8"), default="none")
    ap.add_argument("--unlearn-at", type=int, default=-1,
                    help="send a forget request at this step (-1: off)")
    ap.add_argument("--forget-domain", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="where the model, the train step and the forget "
                         "run: 'cuda' (the default; raises without a card) "
                         "or 'cpu'")
    return ap.parse_args(argv)


@dataclasses.dataclass
class TrainRun:
    """What a run leaves besides ``result`` (``main``'s return value): the
    final trees and the data pipeline's position, every loss, the mid-run
    forget's stats and edited weights (None when no forget ran), and host
    walls in seconds: ``timings["step"]`` each step's as the watchdog read
    it, ``"step_synced"`` each step's up to its loss read back (on the card
    the step's whole time), ``"save"`` each checkpoint write's (periodic
    and pre-unlearn, in order), ``"restore"`` the resume's read (None
    without one)."""
    result: Dict[str, Any]
    params: Params
    opt: AdamState
    ef: Params
    data_step: int
    losses: List[float]
    timings: Dict[str, Any]
    forget_stats: Optional[Dict[str, Any]] = None
    forgotten: Optional[Params] = None


def train(cfg: LM.LMConfig, device, args: argparse.Namespace, *,
          params: Optional[Params] = None,
          data: Optional[Tuple[np.ndarray, np.ndarray]] = None) -> TrainRun:
    """``main``'s loop on ``cfg`` at ``device``: ``params`` (else
    ``init_lm`` from a generator seeded 0 on the device) and ``data``
    ``(tokens [N, seq + 1], domains [N])`` (else ``make_lm_domains`` at the
    config's vocabulary: 8 domains of 24 sequences, seed 0)."""
    dev = resolve_device(device)
    if data is None:
        data = make_lm_domains(LMDataConfig(
            vocab=cfg.vocab, n_domains=8, seq_len=args.seq, n_per_domain=24,
            seed=0))
    tokens, domains = data

    ocfg = AdamWConfig(lr=args.lr, total_steps=args.steps, warmup_steps=5,
                       weight_decay=0.01)
    codec = Int8Codec() if args.compress == "int8" else None

    def loss_fn(p, batch):
        toks, labels = batch
        return LM.lm_loss(p, cfg, toks, labels, aux_weight=0.01)

    def step_fn(params, opt, ef, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        if codec is not None:
            grads, ef = codec.apply(grads, ef)
        params, opt = adamw_update(ocfg, grads, opt, params)
        return params, opt, ef, loss

    def on_device(*arrays):
        return tuple(torch.as_tensor(a, device=dev) for a in arrays)

    # ---- init or resume -------------------------------------------------
    if params is None:
        params = LM.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                            device=dev)
    opt = init_adamw(ocfg, params)
    ef = (codec.init_state(params) if codec
          else {"_": torch.zeros((), device=dev)})
    start_step = 0
    bt = Batches((tokens[:, :-1], tokens[:, 1:]), batch=args.batch, seed=1)

    timings: Dict[str, Any] = {"step": [], "step_synced": [], "save": [],
                               "restore": None}

    def save(step, extra):
        t = time.time()
        CKPT.save(args.ckpt_dir, step,
                  {"params": params, "opt": opt._asdict(), "ef": ef},
                  extra_meta=extra)
        timings["save"].append(time.time() - t)

    latest = CKPT.latest_step(args.ckpt_dir) if args.resume else None
    if latest is not None:
        state = {"params": params, "opt": opt._asdict(), "ef": ef}
        t = time.time()
        restored, meta = CKPT.restore(args.ckpt_dir, latest, state,
                                      device=dev)
        timings["restore"] = time.time() - t
        params = restored["params"]
        opt = AdamState(**restored["opt"])
        ef = restored["ef"]
        start_step = meta["step"]
        bt = Batches((tokens[:, :-1], tokens[:, 1:]), batch=args.batch,
                     seed=1, step=meta.get("data_step", start_step))
        print(f"[train] resumed from step {start_step}", flush=True)

    # ---- train loop with watchdog + unlearn hook -------------------------
    stragglers = 0
    losses: List[float] = []
    forget_stats, forgotten = None, None
    for it in range(start_step, args.steps):
        t0 = time.time()
        bx, by = next(bt)
        params, opt, ef, loss = step_fn(params, opt, ef, on_device(bx, by))
        dt = time.time() - t0
        timings["step"].append(dt)
        if dt > args.step_deadline_s:
            stragglers += 1
            print(f"[watchdog] step {it} took {dt:.1f}s > deadline "
                  f"{args.step_deadline_s}s", flush=True)
        losses.append(float(loss))
        timings["step_synced"].append(time.time() - t0)

        if args.ckpt_every and (it + 1) % args.ckpt_every == 0:
            save(it + 1, {"data_step": bt.step})
            CKPT.gc_old(args.ckpt_dir, keep=2)

        if it + 1 == args.unlearn_at:
            # journal -> checkpoint -> unlearn -> verify -> resume
            CKPT.journal_append(args.ckpt_dir, {
                "step": it + 1, "forget_domain": args.forget_domain,
                "mode": "ficabu"})
            save(it + 1, {"data_step": bt.step, "pre_unlearn": True})
            splits = lm_split_forget_retain(tokens, domains,
                                            args.forget_domain)
            fb = splits["forget"][:16]
            batches = [(tokens[i:i + 16, :-1], tokens[i:i + 16, 1:])
                       for i in range(0, min(len(tokens), 64) - 15, 16)]
            I_D = fisher.diag_fisher_streaming(loss_fn, params, batches,
                                               chunk_size=4, device=dev)
            adapter = adapters.lm_adapter(cfg, args.seq, device=dev)
            from repro_torch.api import ForgetRequest, UnlearnSpec, Unlearner
            unl = Unlearner(adapter, I_D, UnlearnSpec.for_mode(
                "ficabu", alpha=8.0, lam=1.0, tau=0.6,
                checkpoint_every=2, chunk_size=4), device=dev)
            params, stats = unl.forget(
                ForgetRequest(fb[:, :-1], fb[:, 1:],
                              tag=args.forget_domain), params=params)
            forget_stats, forgotten = stats, params
            print(f"[unlearn] stopped at l={stats['stopped_at_l']} "
                  f"macs%={stats['macs_vs_ssd_pct']:.1f}", flush=True)

    result = {"final_loss": losses[-1] if losses else None,
              "first_loss": losses[0] if losses else None,
              "stragglers": stragglers, "steps_run": len(losses),
              "start_step": start_step}
    print(f"[train] done: {json.dumps(result)}", flush=True)
    return TrainRun(result=result, params=params, opt=opt, ef=ef,
                    data_step=bt.step, losses=losses, timings=timings,
                    forget_stats=forget_stats, forgotten=forgotten)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = build(args.arch, args.smoke, args.seq)
    return train(cfg, dev, args).result


if __name__ == "__main__":
    main()
