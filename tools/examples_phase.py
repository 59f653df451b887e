#!/usr/bin/env python3
"""``chip_smoke.py``'s [examples] phase alone, on one card: the port's six
examples (``examples/torch_*.py``), each one's ``run(device="cuda")`` at
the example's own sizes, checked as the phase checks them.

    python3 tools/examples_phase.py

from the repository root. Builds the kernels (as the phase finds them
built), then runs ``chip_smoke.examples_phase``. A last JSON line holds
each example's seconds.
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
        print("examples_phase: no CUDA card", file=sys.stderr)
        return 1
    # as chip_smoke.main, before the first use of the card
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import build as kbuild

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t_main = time.perf_counter()
    kbuild.build_all()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = cs.examples_phase(torch.device("cuda", 0))
    print(json.dumps({"card": smi, "examples": out,
                      "seconds": time.perf_counter() - t_main}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
