#!/usr/bin/env python3
"""``chip_smoke.py``'s [qwen] and [dryrun] phases alone, on one card, and
the depth cuts that pay for them.

    python3 tools/dryrun_phase.py           # [qwen], then [dryrun]
    python3 tools/dryrun_phase.py --cuts    # the candidate cuts, timed

from the repository root. Builds the kernels, then runs
``chip_smoke.qwen_phase`` (qwen1.5-32b at full width and 2 blocks) and
``chip_smoke.dryrun_phase`` on its weights (the decode cell's device time
beside the dry run's terms at the card's peaks, unlearn_cell's streamed
and fused programs, two host cells). ``--cuts`` instead times, in one
process on one card, [lm] at 12 and 6 of gemma3-1b's 26 blocks, [serve]
at 12 and 6, and [fleet] and [load] with their tenants at 26 and 12. A
last JSON line holds every figure beside the card's name and power limit.
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
                    help="time [lm], [serve], [fleet] and [load] before and "
                         "after their candidate depth cuts")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dryrun_phase: no CUDA card", file=sys.stderr)
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
    kind = torch.cuda.get_device_name(0)
    rate = cs.peaks(kind)[0]

    def zero_counts():
        kd.LAUNCHES = kd.INT8_LAUNCHES = kd.ROWSCALE_LAUNCHES = 0
        kd.LEAVES = kd.INT8_LEAVES = 0
        kf.LAUNCHES = kg.LAUNCHES = kg8.LAUNCHES = 0

    def dampen_counts():
        return (kd.LAUNCHES, kd.LEAVES, kd.INT8_LAUNCHES, kd.INT8_LEAVES)

    def fisher_counts():
        return (kf.LAUNCHES, kg.LAUNCHES, kg8.LAUNCHES, kd.ROWSCALE_LAUNCHES)

    counters = (zero_counts, dampen_counts, fisher_counts)
    out = {"card": smi}
    if args.cuts:
        lm6 = (463_026_816, 56, 56, 8)
        for blocks, want in ((12, cs.LM_WANT), (6, lm6)):
            cs.LM_BLOCKS, cs.LM_WANT = blocks, want
            t0 = time.perf_counter()
            cs.lm_phase(dev, rate, *counters, keep={})
            torch.cuda.empty_cache()
            out[f"lm_{blocks}_seconds"] = time.perf_counter() - t0
        for blocks, want in ((12, (624_062_592, 56)), (6, lm6[:2])):
            cs.SERVE_BLOCKS, cs.SERVE_WANT = blocks, want
            t0 = time.perf_counter()
            cs.serve_phase(dev, rate, *counters)
            torch.cuda.empty_cache()
            out[f"serve_{blocks}_seconds"] = time.perf_counter() - t0
        for blocks in (None, 12):
            cs.FLEET_BLOCKS = blocks
            t0 = time.perf_counter()
            cs.fleet_phase(dev, *counters)
            t1 = time.perf_counter()
            cs.load_phase(dev)
            out[f"fleet_{blocks or 26}_seconds"] = t1 - t0
            out[f"load_{blocks or 26}_seconds"] = time.perf_counter() - t1
    else:
        keep = {}
        t0 = time.perf_counter()
        q, _ = cs.qwen_phase(dev, rate, *counters, keep)
        t1 = time.perf_counter()
        d = cs.dryrun_phase(dev, kind, *counters, keep)
        out.update(q["fp32"], **{"int8": q["int8"]}, **d,
                   qwen_seconds=t1 - t0,
                   dryrun_seconds=time.perf_counter() - t1)
    out["seconds"] = time.perf_counter() - t_main
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
