#!/usr/bin/env python3
"""``chip_smoke.py``'s [encdec] phase and its decode checks alone, on one
card: the quick way to rerun the encoder-decoder slice without the whole
smoke test.

    python3 tools/encdec_phase.py [--alpha A] [--no-decode]

from the repository root. Builds the kernels, then runs
``chip_smoke.encdec_phase`` (whisper-tiny FULL, 8 x 448 tokens at chunk 8,
with the dampen counters zeroed before its path and read after; ``--alpha``
overrides ``ENCDEC_ALPHA``), then the decode checks the LM phases run on
their models, each model built as its phase builds it (bf16, a CUDA
generator seeded with 0) and freed before the next, without the phase's
forget requests: gemma3-1b FULL (64 tokens stepped through decode_step
against the forward, and the chunked prefill against the tokenwise
decode), xlstm-125m and recurrentgemma-9b at the [recurrent] phase's
depths, llama4-scout at 1 block (capacity that drops nothing). The tokens
are the phases' own: the first 64 of the first two forget sequences of
make_lm_domains (vocabulary 512, S = 1024). A last JSON line holds every
figure. About 3 minutes on an H100.
"""
from __future__ import annotations

import argparse
import dataclasses
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
    ap.add_argument("--alpha", type=float, default=None)
    ap.add_argument("--no-decode", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("encdec_phase: no CUDA card", file=sys.stderr)
        return 1
    # as chip_smoke.main: segments that grow in place (the MoE block)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.configs import get as get_arch
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import dampen as kd
    from repro_torch.kernels import fimd as kf
    from repro_torch.kernels import gemm_fisher as kg
    from repro_torch.kernels import gemm_fisher_int8 as kg8
    from repro_torch.models import lm as LM

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t_main = time.perf_counter()
    kbuild.build_all()
    dev = torch.device("cuda", 0)
    rate = cs.peaks(torch.cuda.get_device_name(0))[0]
    if args.alpha is not None:
        cs.ENCDEC_ALPHA = args.alpha

    def zero_counts():
        kd.LAUNCHES = kd.INT8_LAUNCHES = kd.ROWSCALE_LAUNCHES = 0
        kd.LEAVES = kd.INT8_LEAVES = 0
        kf.LAUNCHES = kg.LAUNCHES = kg8.LAUNCHES = 0

    out, err = cs.encdec_phase(
        dev, rate, zero_counts,
        lambda: (kd.LAUNCHES, kd.LEAVES, kd.INT8_LAUNCHES, kd.INT8_LEAVES),
        lambda: (kf.LAUNCHES, kg.LAUNCHES, kg8.LAUNCHES,
                 kd.ROWSCALE_LAUNCHES))
    result = {"card": smi, "alpha": cs.ENCDEC_ALPHA, "encdec": out,
              "max_abs_err": err}
    if not args.no_decode:
        toks, doms = syn.make_lm_domains(syn.LMDataConfig(
            vocab=cs.LM_DATA_VOCAB, n_domains=4, seq_len=cs.LM_SEQ,
            n_per_domain=8, seed=cs.SEED))
        seqs = syn.lm_split_forget_retain(toks, doms, cs.LM_FORGET)["forget"]
        tokens = torch.as_tensor(seqs[:2, :cs.DECODE_TOKENS],
                                 device=dev).long().contiguous()
        depth = {arch: n for arch, n, *_ in cs.REC_MODELS}
        depth[cs.MOE_ARCH] = cs.MOE_BLOCKS
        result["decode"] = {}
        for arch in (cs.LM_ARCH, "xlstm-125m", "recurrentgemma-9b",
                     cs.MOE_ARCH):
            cfg = get_arch(arch).full
            if arch in depth:
                cfg = cfg.with_(n_layers=depth[arch])
            params = LM.init_lm(torch.Generator(device=dev).manual_seed(
                cs.SEED), cfg, device="cuda")
            run = cfg
            if cfg.moe is not None:
                run = cfg.with_(moe=dataclasses.replace(
                    cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
            result["decode"][arch] = cs.lm_decode_check(
                arch, run, params, tokens, prefill=arch == cs.LM_ARCH,
                rtol=(cs.DECODE_RTOL_CONV if arch == "recurrentgemma-9b"
                      else cs.DECODE_RTOL))
            del params
            torch.cuda.empty_cache()
    result["seconds"] = time.perf_counter() - t_main
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
