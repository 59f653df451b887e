#!/usr/bin/env python3
"""``chip_smoke.py``'s [serve] phase alone, on one card: the quick way to
rerun the serving slice without the whole smoke test.

    python3 tools/serve_phase.py

from the repository root. Builds the kernels, then runs
``chip_smoke.serve_phase``: gemma3-1b FULL (bf16, a CUDA generator seeded
with 0) served through ``repro_torch.launch.serve.ForgetService`` in fp32
and int8 (3 batches of 8 prompts of 128 tokens, 32 generated each; forget
bursts "1,2;3,2"; a streamed Fisher refresh after every drain), each
against a one-tenant Fleet with the CUDA dampen kernels (bit for bit, the
dampen counters zeroed before its path and read after), the fp32 service
layerwise (bit for bit), and a guarded drain under a nan_batch fault. A
last JSON line holds every figure. About 3.5 minutes on an H100.
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
        print("serve_phase: no CUDA card", file=sys.stderr)
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

    out = cs.serve_phase(
        dev, rate, zero_counts,
        lambda: (kd.LAUNCHES, kd.LEAVES, kd.INT8_LAUNCHES, kd.INT8_LEAVES),
        lambda: (kf.LAUNCHES, kg.LAUNCHES, kg8.LAUNCHES,
                 kd.ROWSCALE_LAUNCHES))
    print(json.dumps({"card": smi, "serve": out,
                      "seconds": time.perf_counter() - t_main}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
