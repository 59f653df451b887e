#!/usr/bin/env python3
"""``chip_smoke.py``'s [train] phase alone on one card, and the depth cuts
that pay for it, each phase timed before and after in this one process.

    python3 tools/train_phase.py            # [train] only
    python3 tools/train_phase.py --cuts     # and the depth cuts

from the repository root. Builds the kernels, then runs
``chip_smoke.train_phase`` (gemma3-1b at full width and 6 of its 26
blocks: 10 steps with checkpoints, the mid-run forget, a resume, the
kernel replay of the forget, the int8 codec). With ``--cuts`` it then runs
recurrentgemma-9b's half of the [recurrent] phase (``rec_model``) at the
depth the script ran before (5 blocks) and at the one it runs now (3), and
the [dense] phase at 8 blocks and at 4, and the [lm] phase at all 26 of
gemma3-1b's blocks and at 12, and prints each one's seconds and what the
cuts give back. A last JSON line holds every figure.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent

# (blocks, expected parameters, stored leaves, layer leaves, unlearn
# layers): the depth before the [train] phase, then the one since
RG_DEPTHS = ((5, (3_395_363_392, 64, 64, 7)), (3, (2_839_587_104, 38, 38, 5)))
DENSE_DEPTHS = ((8, (1_908_477_952, 12, 75, 10)),
                (4, (1_216_385_024, 12, 39, 6)))
LM_DEPTHS = ((None, (999_812_736, 74, 236, 28)),
             (12, (624_062_592, 56, 110, 14)))


def main() -> int:
    if not torch.cuda.is_available():
        print("train_phase: no CUDA card", file=sys.stderr)
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
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
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

    out = {"card": smi, "train": cs.train_phase(
        dev, smi, zero_counts, dampen_counts, fisher_counts)}
    if "--cuts" in sys.argv[1:]:
        counters = (zero_counts, dampen_counts, fisher_counts)
        rg = []
        for blocks, want in RG_DEPTHS:
            t0 = time.perf_counter()
            cs.rec_model("recurrentgemma-9b", blocks, 4, 2, 25.0, want, dev,
                         rate, counters)
            rg.append((blocks, time.perf_counter() - t0))
        dense = []
        for blocks, want in DENSE_DEPTHS:
            cs.DENSE_BLOCKS, cs.DENSE_WANT = blocks, want
            t0 = time.perf_counter()
            cs.dense_phase(dev, rate, zero_counts, dampen_counts,
                           fisher_counts)
            torch.cuda.empty_cache()
            dense.append((blocks, time.perf_counter() - t0))
        lm = []
        for blocks, want in LM_DEPTHS:
            cs.LM_BLOCKS, cs.LM_WANT = blocks, want
            t0 = time.perf_counter()
            cs.lm_phase(dev, rate, zero_counts, dampen_counts, fisher_counts)
            torch.cuda.empty_cache()
            lm.append((blocks or 26, time.perf_counter() - t0))
        back = sum(a[1] - b[1] for a, b in (rg, dense, lm))
        out.update(rg_seconds=rg, dense_seconds=dense, lm_seconds=lm,
                   given_back=back)
        print(f"[cuts] recurrentgemma-9b {rg} (blocks, s); yi-6b [dense] "
              f"{dense}; gemma3-1b [lm] {lm}; given back by all three "
              f"{back:.1f} s against [train]'s "
              f"{out['train']['train_phase_seconds']:.1f} s ({smi})",
              flush=True)
    out["seconds"] = time.perf_counter() - t_main
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
