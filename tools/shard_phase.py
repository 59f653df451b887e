#!/usr/bin/env python3
"""``chip_smoke.py``'s [shard] and [cache] phases alone, on one card, and
the [serve] depth cut that pays for them.

    python3 tools/shard_phase.py            # [lm], then [shard], [cache]
    python3 tools/shard_phase.py --cuts     # [serve] at 26 and 12 blocks

from the repository root. Builds the kernels, then runs
``chip_smoke.lm_phase`` (gemma3-1b at full width and 12 blocks, whose
weights, Fisher and request [shard] serves on), ``chip_smoke.shard_phase``
(sharded requests on the 1x1 mesh of a one-rank NCCL group, each == the
unsharded one bit for bit, and the elastic restore) and
``chip_smoke.cache_phase`` (two cold starts of ``serve --fleet
--cache-dir --check`` on one cache dir). ``--cuts`` instead times
``chip_smoke.serve_phase`` at the depth it ran before the cut (26 blocks)
and at ``SERVE_BLOCKS``, in one process, on one card. A last JSON line
holds every figure beside the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cuts", action="store_true",
                    help="time [serve] at 26 blocks and at SERVE_BLOCKS")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("shard_phase: no CUDA card", file=sys.stderr)
        return 1
    # as chip_smoke.main, before the first use of the card
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import dampen as kd
    from repro_torch.kernels import fimd as kf
    from repro_torch.kernels import gemm_fisher as kg
    from repro_torch.kernels import gemm_fisher_int8 as kg8

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t_main = time.perf_counter()
    kbuild.build_all()
    dev = torch.device("cuda", 0)
    rate = cs.peaks(torch.cuda.get_device_name(0))[0]

    def zero_counts():
        kd.LAUNCHES = kd.INT8_LAUNCHES = kd.ROWSCALE_LAUNCHES = 0
        kd.LEAVES = kd.INT8_LEAVES = 0
        kf.LAUNCHES = kg.LAUNCHES = kg8.LAUNCHES = 0

    def dampen_counts():
        return (kd.LAUNCHES, kd.LEAVES, kd.INT8_LAUNCHES, kd.INT8_LEAVES)

    def fisher_counts():
        return (kf.LAUNCHES, kg.LAUNCHES, kg8.LAUNCHES, kd.ROWSCALE_LAUNCHES)

    out = {"card": smi}
    if args.cuts:
        cut = (cs.SERVE_BLOCKS, cs.SERVE_WANT)
        for blocks, want in ((26, (999_812_736, 74)), cut):
            cs.SERVE_BLOCKS, cs.SERVE_WANT = blocks, want
            t0 = time.perf_counter()
            cs.serve_phase(dev, rate, zero_counts, dampen_counts,
                           fisher_counts)
            out[f"serve_{blocks}_blocks_seconds"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
            cs.log(f"[cuts] [serve] at {blocks} blocks: "
                   f"{out[f'serve_{blocks}_blocks_seconds']:.1f} s; {smi}")
    else:
        keep = {}
        t0 = time.perf_counter()
        cs.lm_phase(dev, rate, zero_counts, dampen_counts, fisher_counts,
                    keep=keep)
        out["lm_seconds"] = time.perf_counter() - t0
        out["shard"] = cs.shard_phase(dev, smi, zero_counts, dampen_counts,
                                      fisher_counts, keep)
        keep.clear()
        torch.cuda.empty_cache()
        out["cache"] = cs.cache_phase(smi)
    out["seconds"] = time.perf_counter() - t_main
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
