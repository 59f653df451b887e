#!/usr/bin/env python3
"""Ablations of the port's backward-GEMM kernels on one NVIDIA card.

    python3 tools/gemm_variants.py        # from the repository root, one card

Each variant is a committed kernel source (src/repro_torch/kernels/csrc/
gemm_fisher.cu or gemm_fisher_int8.cu) with one part taken out, built with
the same nvcc flags as kernels/build.py into kernels/_build/variants/ and
called through its C entry point at the two shapes of chip_smoke.py's GEMM
timings (blocks/7/conv2 and blocks/1/conv1 of a 64-image chunk of 8 on
ResNet-18), on operand sets rotated beyond the L2 cache, with the split plan
of the wrapper. The variants compute wrong results on purpose; they show
which part of a kernel its time rests on:

  base       the committed source
  no_mma     the tensor-core instructions replaced by one integer or float
             operation on the same fragments
  one_pass   (f32) only the big x big TF32 pass of 3xTF32
  no_store   the epilogue's global stores skipped (the tile still staged)
  no_pdl     the reduce pass launched plainly, not as a programmatic
             dependent launch (split shapes only)

plus the time of zeroing dw and fish (two [M, K] f32 outputs) as the floor
for the stores. Prints one line per shape and a last JSON line with every
time in microseconds.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(128, 4608, 512), (8192, 576, 64)]
L2_BYTES = 50e6

F32_VARIANTS = {
    "no_mma": [('  asm volatile(\n      "mma.sync.aligned.m16n8k8',
                '  d[0] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1);'
                '\n  if (0) asm volatile(\n      "mma.sync.aligned.m16n8k8')],
    "one_pass": [("""          if (kSplit) {
            mma_tf32(part[i][j], as[i], bb[j][0], bb[j][1]);
            mma_tf32(part[i][j], ab[i], bs[j][0], bs[j][1]);
          }
""", "")],
    "no_store": [("    if (m < M && k < K) {\n      store4(",
                  "    if (m < M && k < K && cs[r][c] == 1.2345f) {\n"
                  "      store4(")],
    "no_pdl": [("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;")],
}
INT8_VARIANTS = {
    "no_mma": [('  asm volatile(\n      "mma.sync.aligned.m16n8k32',
                '  d[0] += int(a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1);'
                '\n  if (0) asm volatile(\n      "mma.sync.aligned.m16n8k32')],
    "no_store": [("    if (m >= M || k >= K) continue;",
                  "    if (m >= M || k >= K || cs[r][c] != 12345) continue;")],
    "no_pdl": [("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;")],
}


def build_variants(kb):
    """name -> bound C entry of every variant, built in parallel."""
    out = kb.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src, entry, nptr, variants in (
            ("gemm_fisher", "ficabu_gemm_fisher_f32", 5, F32_VARIANTS),
            ("gemm_fisher_int8", "ficabu_gemm_fisher_int8", 7,
             INT8_VARIANTS)):
        text = (kb.CSRC / f"{src}.cu").read_text()
        for name, edits in {"base": [], **variants}.items():
            body = text
            for old, new in edits:
                if old not in body:
                    raise RuntimeError(f"{src}/{name}: source text not found")
                body = body.replace(old, new)
            cu = out / f"{src}-{name}.cu"
            cu.write_text(body)
            so = cu.with_suffix(".so")
            jobs.append((f"{src}/{name}", entry, nptr, so, subprocess.Popen(
                [kb._nvcc(), *kb.NVCC_FLAGS, "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for key, entry, nptr, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        fn = getattr(ctypes.CDLL(str(so)), entry)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * nptr + [ctypes.c_longlong] * 5 + [
            ctypes.c_void_p]
        fns[key] = fn
    return fns


def device_us(fn, iters=50):
    """Mean device time of fn() in microseconds, launches queued behind a
    spin kernel so the events see the card only."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("gemm_variants: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as kb
    from repro_torch.kernels import gemm_fisher as kg
    from repro_torch.kernels import gemm_fisher_int8 as kg8

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    fns = build_variants(kb)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rot = iter(range(1 << 30))
    result = {}
    for N, M, K in SHAPES:
        fsets = [(torch.randn(N, M, generator=gen, device=dev),
                  torch.randn(N, K, generator=gen, device=dev))
                 for _ in range(max(3, int(L2_BYTES // (4 * N * (M + K))) + 1))]
        qsets = [(torch.randint(-127, 128, (N, M), generator=gen, device=dev,
                                dtype=torch.int8),
                  torch.randint(-127, 128, (N, K), generator=gen, device=dev,
                                dtype=torch.int8))
                 for _ in range(max(3, int(L2_BYTES // (N * (M + K))) + 1))]
        sa = torch.rand(M, generator=gen, device=dev)
        sg = torch.rand(K, generator=gen, device=dev)
        dw = torch.empty(M, K, device=dev)
        fish = torch.empty(M, K, device=dev)
        times = {}
        for key, fn in fns.items():
            int8 = key.startswith("gemm_fisher_int8")
            S, rows = kg.split_plan(N, M, K, kg8.SLAB if int8 else kg.SLAB)
            if key.endswith("no_pdl") and S == 1:
                continue
            ws = torch.empty(S, M, K, device=dev)

            def call(fn=fn, int8=int8, S=S, rows=rows, ws=ws):
                if int8:
                    a, g = qsets[next(rot) % len(qsets)]
                    ptrs = (a.data_ptr(), g.data_ptr(), sa.data_ptr(),
                            sg.data_ptr(), dw.data_ptr(), fish.data_ptr(),
                            ws.data_ptr())
                else:
                    a, g = fsets[next(rot) % len(fsets)]
                    ptrs = (a.data_ptr(), g.data_ptr(), dw.data_ptr(),
                            fish.data_ptr(), ws.data_ptr())
                if fn(*ptrs, N, M, K, rows, S, stream) != 0:
                    raise RuntimeError(f"{key}: launch failed")

            times[key] = device_us(call)
        times["zero dw and fish"] = device_us(
            lambda: (dw.zero_(), fish.zero_()))
        name = f"{N},{M},{K}"
        result[name] = times
        print(f"({name}) " + ", ".join(f"{k} {v:.2f} us"
                                       for k, v in times.items()), flush=True)
    print(json.dumps({"device": smi, "us": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
