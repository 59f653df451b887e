#!/usr/bin/env python3
"""``chip_smoke.py``'s [stream], [fleet], [recover] and [load] phases alone,
on one card: the quick way to rerun the rest of the serving slice without
the whole smoke test.

    python3 tools/stream_phase.py

from the repository root. Builds the kernels, builds [serve]'s gemma3-1b
FULL weights and data (bf16, a CUDA generator seeded with 0) and
``generate``'s tokens for batch 0, then runs ``chip_smoke.stream_phase``
(the continuous-batching StreamEngine with shadow drains, a kernel run
against a plain run bit for bit, a worker_exc fault), ``fleet_phase``
(``serve.run_fleet`` on two FULL tenants and every fleet gate),
``recover_phase`` (a SIGKILLed drain recovered from its checkpoint and
WAL) and ``load_phase`` (the load harness twice and ``report --slo``). A
last JSON line holds every figure.
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


def main() -> int:
    if not torch.cuda.is_available():
        print("stream_phase: no CUDA card", file=sys.stderr)
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

    out = cs.stream_phase(dev, rate, zero_counts, dampen_counts,
                          fisher_counts)
    torch.cuda.empty_cache()
    out.update(cs.fleet_phase(dev, zero_counts, dampen_counts,
                              fisher_counts))
    out.update(cs.recover_phase(dev))
    out.update(cs.load_phase(dev))
    print(json.dumps({"card": smi, "stream": out,
                      "seconds": time.perf_counter() - t_main}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
