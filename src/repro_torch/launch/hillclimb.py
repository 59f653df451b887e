"""Hill-climbing on the dry run (port of ``repro.launch.hillclimb``): the
reference's nine experiments, each a cell counted again with its config
overrides (``cp_attention``, ``parallelism``, ``moe_shard_constraints``,
all accepted by the port's ``LMConfig``), read at a card's peaks.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb qwen_fsdp \\
        --device cpu --card "NVIDIA H100 80GB HBM3"
    PYTHONPATH=src python -m repro_torch.launch.hillclimb --all \\
        --device cpu --card "NVIDIA H100 80GB HBM3"

The port's sharded execution gathers weights and splits the batch
(``launch.dryrun``), so an override moves one rank's count only through
its program: ``parallelism="fsdp"`` splits the batch over every rank,
``cp_attention`` takes ``layers._sdpa_cp``'s one product over the whole
sequence in place of the query-chunked blocks, and
``moe_shard_constraints`` (a layout) changes no count. The hypotheses
below are the reference's, about its XLA lowering.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

from repro_torch.launch.dryrun import run_cell

OUT_DIR = "experiments/torch_perf"

# Each experiment: cell + config overrides + the reference's hypothesis.
EXPERIMENTS = {
    # HC-1: qwen1.5-32b train_4k; 40 heads do not divide TP = 16, so the
    # reference's attention is replicated per device; CP shards queries
    # into 16 sequence segments on "model"
    "qwen_cp16": dict(arch="qwen1.5-32b", shape="train_4k",
                      overrides={"cp_attention": 16}),
    # HC-1 iter 3: pure FSDP, the batch over data x model, weights gathered
    # layer by layer instead of activations all-reduced
    "qwen_fsdp": dict(arch="qwen1.5-32b", shape="train_4k",
                      overrides={"parallelism": "fsdp"}),
    "qwen_fsdp_prefill": dict(arch="qwen1.5-32b", shape="prefill_32k",
                              overrides={"parallelism": "fsdp"}),
    # HC-2: llama4-scout prefill_32k, the reference's most collective-bound
    # cell; forcing the MoE buffers' shardings
    "llama4_moe_constraints": dict(arch="llama4-scout-17b-a16e",
                                   shape="prefill_32k",
                                   overrides={"moe_shard_constraints": True}),
    "llama4_moe_constraints_train": dict(
        arch="llama4-scout-17b-a16e", shape="train_4k",
        overrides={"moe_shard_constraints": True}),
    # HC-2 on kimi (the same mechanism)
    "kimi_moe_constraints": dict(arch="kimi-k2-1t-a32b", shape="train_4k",
                                 overrides={"moe_shard_constraints": True}),
    # HC-2 iter 2+3: a last-token-only head on prefill and CP / pure FSDP
    "llama4_prefill_cp": dict(arch="llama4-scout-17b-a16e",
                              shape="prefill_32k",
                              overrides={"cp_attention": 16}),
    "llama4_fsdp_train": dict(arch="llama4-scout-17b-a16e", shape="train_4k",
                              overrides={"parallelism": "fsdp"}),
    "kimi_fsdp_train": dict(arch="kimi-k2-1t-a32b", shape="train_4k",
                            overrides={"parallelism": "fsdp"}),
    # HC-3 (the paper's technique at pod scale) is launch/unlearn_cell.py.
}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*", default=[])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the card whose peaks the terms read (cuda), or "
                         "cpu with --card")
    ap.add_argument("--card", default=None,
                    help="the card whose peaks the terms read (default: "
                         "the card of --device)")
    args = ap.parse_args(argv)
    names = list(EXPERIMENTS) if args.all or not args.names else args.names
    unknown = [n for n in names if n not in EXPERIMENTS]
    if unknown:
        raise ValueError(f"unknown experiments {unknown}; have "
                         f"{sorted(EXPERIMENTS)}")

    os.makedirs(OUT_DIR, exist_ok=True)
    for name in names:
        exp = EXPERIMENTS[name]
        print(f"[hillclimb] {name}: {exp['arch']} x {exp['shape']} "
              f"overrides={exp['overrides']}", flush=True)
        rec = run_cell(exp["arch"], exp["shape"], multi_pod=False,
                       overrides=exp["overrides"], card=args.card,
                       device=args.device)
        rec["experiment"] = name
        rec["overrides"] = exp["overrides"]
        with open(os.path.join(OUT_DIR, name + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
        if rec.get("status") == "ok":
            t = rec["roofline"]
            print(f"  -> dom={t['dominant']} compute={t['compute_s']:.3g}s "
                  f"memory={t['memory_s']:.3g}s coll={t['collective_s']:.3g}s"
                  f" frac={t['roofline_fraction']:.3f}", flush=True)


if __name__ == "__main__":
    main()
