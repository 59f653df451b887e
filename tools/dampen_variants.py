#!/usr/bin/env python3
"""Ablations of the port's grouped dampen kernels on one NVIDIA card.

    python3 tools/dampen_variants.py      # from the repository root, one card

The committed source src/repro_torch/kernels/csrc/dampen.cu is built as it
is and with one part changed, with the same nvcc flags as kernels/build.py,
into kernels/_build/variants/, and its C entry points are called directly
on the tables of one ssd forget request on full-width ResNet-18 (the 10
layers' leaves, random weights from a seed, a random Fisher pair), with the
tables laid out by kernels/dampen.py::table_plan:

  base       the committed source
  cap8       a parameter table of 8 leaves instead of 64 (456 bytes of
             kernel parameters instead of 3,592; every layer fits)
  no_count   base, called without a count (no block reduction, no atomic
             add)
  epb2048    2048 elements per block instead of 1024 (the table laid out
             for it)
  epb4096    4096 elements per block

For each: the device time (launches queued behind a spin kernel) of the
sweep (10 launches, one per layer), f32 and int8, and of the largest leaf
alone (2,359,296 elements, four operand sets rotated beyond the L2). Then
the host's time per sweep, without waiting for the card: the bare C entry
points with ready tables, kernels.dampen.dampen_group_cuda, and
kernels.ops.dampen_group as the forget request calls it. Prints one line per
measurement and a last JSON line with every time in microseconds.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
EPB = "constexpr int kElemsPerBlock = 4 * kThreads;"
VARIANTS = {"cap8": [("constexpr int kMaxLeaves = 64;",
                      "constexpr int kMaxLeaves = 8;")],
            "epb2048": [(EPB, "constexpr int kElemsPerBlock = 2048;")],
            "epb4096": [(EPB, "constexpr int kElemsPerBlock = 4096;")]}
ENTRIES = {"f32": "ficabu_dampen_group_f32", "int8": "ficabu_dampen_group_int8"}
GROUP_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
              ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
              ctypes.c_void_p]


def build_variants(kb, variants=VARIANTS, entries=ENTRIES,
                   argtypes=GROUP_ARGS, prefix="dampen"):
    """name -> (library path, {kind: bound C entry}) of the committed
    source and every variant, built in parallel. A variant is a list of
    (old, new) text edits of the source; old None appends new at its
    end."""
    out = kb.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    text = (kb.CSRC / "dampen.cu").read_text()
    jobs = []
    for name, edits in {"base": [], **variants}.items():
        body = text
        for old, new in edits:
            if old is None:
                body += new
                continue
            if old not in body:
                raise RuntimeError(f"dampen/{name}: source text not found")
            body = body.replace(old, new)
        cu = out / f"{prefix}-{name}.cu"
        cu.write_text(body)
        so = cu.with_suffix(".so")
        jobs.append((name, so, subprocess.Popen(
            [kb._nvcc(), *kb.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = {}
    for name, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for dampen/{name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        built[name] = (so, {kind: kb.bind(lib, entry, argtypes)
                            for kind, entry in entries.items()})
    return built


@contextlib.contextmanager
def elems_per_block(kd, epb):
    """table_plan lays tables out for a kernel built with epb elements per
    block (kernels/dampen.py::ELEMS_PER_BLOCK mirrors the committed
    source's constant)."""
    was, kd.ELEMS_PER_BLOCK = kd.ELEMS_PER_BLOCK, epb
    try:
        yield
    finally:
        kd.ELEMS_PER_BLOCK = was


def device_us(fn, iters=20):
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


def host_us(fn, iters=200):
    """Mean host time of fn() in microseconds, not waiting for the card
    (the launch queue stays far from full)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / iters * 1e6


def main() -> int:
    if not torch.cuda.is_available():
        print("dampen_variants: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import RESNET18_CIFAR20 as cfg
    from repro_torch.core import adapters
    from repro_torch.kernels import build as kb
    from repro_torch.kernels import dampen as kd
    from repro_torch.kernels import ops
    from repro_torch.models import vision as V
    from repro_torch.models.module import tree_leaves
    from repro_torch.optim.compression import q8_quantize

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    fns = {k: v[1] for k, v in build_variants(kb).items()}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    params = V.init_resnet(torch.Generator().manual_seed(0), cfg,
                           device="cuda")
    adapter = adapters.resnet_adapter(cfg, device="cuda")
    tables = {"f32": [], "int8": []}
    for j in range(adapter.n_layers - 1, -1, -1):
        ths = tree_leaves(adapter.get_layer(params, j))
        i_gs = [torch.rand(t.shape, generator=gen, device=dev) for t in ths]
        i_fs = [torch.rand(g.shape, generator=gen, device=dev) * 20 * g
                for g in i_gs]
        tables["f32"].append((ths, i_fs, i_gs))
        tables["int8"].append(([q8_quantize(t)[0] for t in ths], i_fs, i_gs))
    big = max((t for tab in tables["f32"] for t in tab[0]),
              key=lambda t: t.numel())
    bigs = {"f32": [], "int8": []}
    for _ in range(4):    # four sets of 40 / 21 MB: beyond the 50 MB L2
        th = torch.randn(big.shape, generator=gen, device=dev)
        i_g = torch.rand(big.shape, generator=gen, device=dev)
        i_f = torch.rand(big.shape, generator=gen, device=dev) * 20 * i_g
        bigs["f32"].append(([th], [i_f], [i_g]))
        bigs["int8"].append(([q8_quantize(th)[0]], [i_f], [i_g]))

    def launches(tabs, epb):
        """Per table: its rows, block count, count address and the buffers
        that keep its outputs alive."""
        out = []
        for ths, i_fs, i_gs in tabs:
            outs = [torch.empty_like(t) for t in ths]
            masks = [torch.empty(t.shape, dtype=torch.uint8, device=dev)
                     for t in ths]
            count = torch.zeros((), dtype=torch.int64, device=dev)
            with elems_per_block(kd, epb):
                (rows, blocks), = kd.table_plan(
                    [t.numel() for t in ths],
                    [(t.data_ptr(), f.data_ptr(), g.data_ptr(), o.data_ptr(),
                      m.data_ptr()) for t, f, g, o, m
                     in zip(ths, i_fs, i_gs, outs, masks)],
                    ths[0].element_size())
            out.append((rows, blocks, count, (outs, masks)))
        return out

    def run(fn, plan, with_count):
        for rows, blocks, count, _ in plan:
            if fn(rows.ctypes.data, len(rows), blocks, 10.0, 1.0,
                  count.data_ptr() if with_count else None, stream) != 0:
                raise RuntimeError("launch failed")

    # (name, source variant, its elements per block, with a count)
    cases = [("base", "base", kd.ELEMS_PER_BLOCK, True),
             ("cap8", "cap8", kd.ELEMS_PER_BLOCK, True),
             ("no_count", "base", kd.ELEMS_PER_BLOCK, False),
             ("epb2048", "epb2048", 2048, True),
             ("epb4096", "epb4096", 4096, True)]
    result = {}
    for kind in ("f32", "int8"):
        for name, source, epb, with_count in cases:
            fn = fns[source][kind]
            sweep = launches(tables[kind], epb)
            big_plans = [launches([b], epb) for b in bigs[kind]]
            rot = iter(range(1 << 30))
            key = f"{kind} {name}"
            result[key] = {
                "sweep": device_us(lambda: run(fn, sweep, with_count)),
                "largest_leaf": device_us(lambda: run(
                    fn, big_plans[next(rot) % 4], with_count), 200),
            }
            print(f"[variant] {key}: sweep (10 launches) "
                  f"{result[key]['sweep']:.2f} us, largest leaf "
                  f"{result[key]['largest_leaf']:.2f} us", flush=True)

    fn, sweep = fns["base"]["f32"], launches(tables["f32"],
                                             kd.ELEMS_PER_BLOCK)
    host = {
        "bare C entry points": host_us(lambda: run(fn, sweep, True)),
        "dampen_group_cuda": host_us(lambda: [
            kd.dampen_group_cuda(*tab, 10.0, 1.0) for tab in tables["f32"]]),
        "ops.dampen_group": host_us(lambda: [
            ops.dampen_group(*tab, 10.0, 1.0) for tab in tables["f32"]]),
        "dampen_cuda per leaf (56 calls)": host_us(lambda: [
            kd.dampen_cuda(t, f, g, 10.0, 1.0) for tab in tables["f32"]
            for t, f, g in zip(*tab)]),
    }
    for key, us in host.items():
        print(f"[host] f32 sweep through {key}: {us:.2f} us of host time",
              flush=True)
    print(json.dumps({"device": smi, "device_us": result, "host_us": host}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
