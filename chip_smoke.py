#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases, in order; any failure exits non-zero and prints no result line:

  1. the card's name and power limit, as nvidia-smi reports them;
  2. build every kernel of the main paths from the sources in the checkout
     (csrc/dampen.cu: the f32/bf16 dampen kernel and the int8 one, one nvcc
     for sm_90a), with each kernel's registers and spills;
  3. each kernel against its plain PyTorch version on the card, at every
     ResNet-18 leaf shape, three (alpha, lambda) pairs (f32 and bf16 theta
     for dampen, int8 codes for dampen_int8), and the edge cases (ties,
     half-way codes, saturation, zeros, NaN/inf, lambda = NaN/inf,
     alpha = 0, n = 1, n % 4 != 0, misaligned pointers): the result and the
     mask must be BIT-identical;
  4. the slices at full width: RESNET18_CIFAR20 (random weights from a
     seed, pre-trained here for a few hundred AdamW steps so that halting
     means something) served through ``Unlearner`` with ``use_kernel=True``:
     ensure_fisher on a retain batch, a 64-image forget request of one
     class at chunk 8, in "ssd" mode (all 10 layers, 56 kernel launches)
     and "ficabu" mode (checkpoint_every=2), then warm requests that must
     build nothing — first the fp32 path, then the int8 path
     (``precision="int8"``: dampen_int8 on the codes, every leaf on its q8
     grid, per-layer error against fp32 within INT8_SWEEP_RTOL). Both
     launch counters are zeroed just before each path and read just after:
     an fp32 request launches only dampen, an int8 request only
     dampen_int8;
  5. the whole ssd forget with the kernel against the same forget with the
     plain version, under deterministic cuDNN, fp32 and int8:
     bit-identical parameters;
  6. times: each kernel and its plain version at the main paths' shapes,
     beside the memory bound, printed as one ``{"kernels": [...]}`` line,
     and where a warm fp32 and a warm int8 ssd request spend their time.

The last line is the contract line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
This script imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
PAIRS = [(2.0, 0.5), (10.0, 1.0), (0.5, 0.1)]
SEED = 0
FORGET_CLASS = 3
# Device-memory rate of the card, bytes/s (NVIDIA data sheets); the bound
# of a memory-bound kernel is the bytes it must move over this rate.
MEM_RATE = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12,
            "H100": 3.35e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def mem_rate(name: str) -> float:
    for key, rate in MEM_RATE.items():
        if key in name:
            return rate
    raise RuntimeError(f"no memory rate on record for card {name!r}")


def cuda_time_ms(fn, iters: int, *, queue_ahead: bool = False) -> float:
    """Mean time of one ``fn()`` over ``iters`` calls, from CUDA events
    around the run, after a warm-up.

    ``queue_ahead`` first parks the stream on a spin kernel that outlasts
    the host's enqueueing of all ``iters`` calls, so the events see only
    the device running them back to back (device time; keep ``iters``
    small enough for the launch queue). Without it the events also see the
    host's launch overhead wherever the host is the slower side (stream
    time, what the request itself experiences)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if queue_ahead:
        # >= 2x the host time at SM clocks up to 2 GHz
        torch.cuda._sleep(int(host_s * 4e9) + 1_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_request(run):
    """Device busy time of one ``run()`` from torch.profiler: the sum of
    the CUDA kernels' self time, the number of device kernels, and the top
    kernels by time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:6]
    return busy, sum(e.count for e in evs), [
        (e.key[:70], e.self_device_time_total / 1e3, e.count) for e in top]


def bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else
                  torch.int32 if t.element_size() == 4 else torch.uint8)


def check_kernel_against_plain(leaf_shapes, dev):
    """Phase 3: the CUDA kernel vs dampen_ref, bit for bit."""
    from repro_torch.kernels import dampen as kd

    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_err = 0.0
    cases = 0

    def compare(theta, i_f, i_g, alpha, lam, what):
        nonlocal max_err, cases
        got, mask = kd.dampen_cuda(theta, i_f, i_g, alpha, lam)
        want, want_mask = kd.dampen_ref(theta, i_f, i_g, alpha, lam)
        torch.cuda.synchronize()
        if not torch.equal(bits(got), bits(want)) \
                or not torch.equal(mask, want_mask):
            raise AssertionError(f"dampen kernel != dampen_ref: {what}")
        fin = torch.isfinite(want)
        if fin.any():
            max_err = max(max_err, float((got.float() - want.float())[fin]
                                         .abs().max()))
        cases += 1

    def operands(n, dtype):
        th = torch.randn(n, generator=gen, device=dev).to(dtype)
        i_g = torch.rand(n, generator=gen, device=dev) + 1e-6
        i_f = torch.rand(n, generator=gen, device=dev) * 20 * i_g
        return th, i_f, i_g

    for shape in leaf_shapes:
        n = 1
        for s in shape:
            n *= s
        for dtype in (torch.float32, torch.bfloat16):
            for alpha, lam in PAIRS:
                th, i_f, i_g = operands(n, dtype)
                # ties: i_f == f32(alpha) * i_g exactly, never selected
                tie = torch.rand(n, generator=gen, device=dev) < 0.01
                i_f = torch.where(tie, alpha * i_g, i_f)
                compare(th.view(shape), i_f.view(shape), i_g.view(shape),
                        alpha, lam, f"{shape} {dtype} a={alpha} l={lam}")

    nan, inf = float("nan"), float("inf")
    special = torch.tensor([0.0, -0.0, nan, inf, -inf, 1.0, 2.0, 1e-30,
                            1e-38, 3.0], device=dev)
    for n in (1, 2, 3, 4, 5, 7, 33, 1023, 4097):
        for dtype in (torch.float32, torch.bfloat16):
            for alpha, lam in PAIRS + [(2.0, nan), (2.0, inf), (0.0, 1.0)]:
                th, i_f, i_g = operands(n + 1, dtype)
                pick = lambda: special[torch.randint(  # noqa: E731
                    0, len(special), (n + 1,), generator=gen, device=dev)]
                th = torch.where(torch.rand(n + 1, generator=gen, device=dev)
                                 < 0.3, pick().to(dtype), th)
                i_f = torch.where(torch.rand(n + 1, generator=gen, device=dev)
                                  < 0.3, pick(), i_f)
                i_g = torch.where(torch.rand(n + 1, generator=gen, device=dev)
                                  < 0.3, pick(), i_g)
                for lo in (0, 1):   # lo=1: pointers off the 16-byte grid
                    compare(th[lo:lo + n], i_f[lo:lo + n], i_g[lo:lo + n],
                            alpha, lam, f"edge n={n} {dtype} lo={lo} "
                            f"a={alpha} l={lam}")
    return cases, max_err


def check_int8_kernel_against_plain(leaf_shapes, dev):
    """Phase 3, int8: dampen_int8_cuda vs dampen_int8_ref, bit for bit."""
    from repro_torch.kernels import dampen as kd

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    max_err = 0
    cases = 0

    def compare(theta_q, i_f, i_g, alpha, lam, what):
        nonlocal max_err, cases
        got, mask = kd.dampen_int8_cuda(theta_q, i_f, i_g, alpha, lam)
        want, want_mask = kd.dampen_int8_ref(theta_q, i_f, i_g, alpha, lam)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or not torch.equal(mask, want_mask):
            raise AssertionError(f"dampen_int8 kernel != dampen_int8_ref: "
                                 f"{what}")
        if got.numel():
            max_err = max(max_err, int((got.int() - want.int()).abs().max()))
        cases += 1

    def operands(n):
        th = torch.randint(-128, 128, (n,), generator=gen, device=dev,
                           dtype=torch.int8)
        i_g = torch.rand(n, generator=gen, device=dev) + 1e-6
        i_f = torch.rand(n, generator=gen, device=dev) * 20 * i_g
        return th, i_f, i_g

    for shape in leaf_shapes:
        n = torch.Size(shape).numel()
        for alpha, lam in PAIRS:
            th, i_f, i_g = operands(n)
            tie = torch.rand(n, generator=gen, device=dev) < 0.01
            i_f = torch.where(tie, alpha * i_g, i_f)
            compare(th.view(shape), i_f.view(shape), i_g.view(shape), alpha,
                    lam, f"{shape} a={alpha} l={lam}")

    # every code at beta = 0.5 exactly (half-way products round to even),
    # and at a negative beta (saturation at +-127)
    codes = torch.arange(-128, 128, device=dev).to(torch.int8)
    ones = torch.ones(256, device=dev)
    compare(codes, ones, ones, 0.5, 0.5, "half-way codes")
    compare(codes, ones, -ones, 2.0, 10.0, "saturation")
    nan, inf = float("nan"), float("inf")
    special = torch.tensor([0.0, -0.0, nan, inf, -inf, 1.0, 2.0, 1e-30,
                            1e-38, 3.0], device=dev)
    for n in (1, 2, 3, 4, 5, 7, 33, 1023, 4097):
        for alpha, lam in PAIRS + [(2.0, nan), (2.0, inf), (0.0, 1.0),
                                   (0.5, 0.5)]:
            th, i_f, i_g = operands(n + 3)
            pick = lambda: special[torch.randint(  # noqa: E731
                0, len(special), (n + 3,), generator=gen, device=dev)]
            i_f = torch.where(torch.rand(n + 3, generator=gen, device=dev)
                              < 0.3, pick(), i_f)
            i_g = torch.where(torch.rand(n + 3, generator=gen, device=dev)
                              < 0.3, pick(), i_g)
            for lo in (0, 1, 3):   # lo > 0: pointers off the 4/16-byte grid
                compare(th[lo:lo + n], i_f[lo:lo + n], i_g[lo:lo + n],
                        alpha, lam, f"edge n={n} lo={lo} a={alpha} l={lam}")
    return cases, max_err


def on_q8_grid(new, pristine):
    """True when every leaf of ``new`` is f32(code * scale) with integer
    codes in +-127 on the scale table of the pristine leaf."""
    from repro_torch.optim.compression import q8_scales
    for k, p in pristine.items():
        s = q8_scales(p)
        q = torch.round(new[k] / s)
        if q.abs().max() > 127 or not torch.equal(q * s, new[k]):
            return False
    return True


def layer_rel_l2(adapter, p8, p32):
    """Per layer, ||p8 - p32|| / ||p32|| over the layer's leaves."""
    from repro_torch.models.module import tree_leaves
    from repro_torch.optim.compression import INT8_SWEEP_RTOL, q8_quantize
    out = []
    for j in range(adapter.n_layers):
        a = tree_leaves(adapter.get_layer(p8, j))
        b = tree_leaves(adapter.get_layer(p32, j))
        d = sum(float(((x.double() - y.double()) ** 2).sum())
                for x, y in zip(a, b))
        n = sum(float((y.double() ** 2).sum()) for y in b)
        out.append((d / n) ** 0.5)
    return out


def pretrain(params, x, y, steps, batch, dev):
    """A few hundred AdamW steps on the synthetic classes, so the forget
    class is learnt and the checkpoints have something to halt on."""
    from repro_torch.configs import RESNET18_CIFAR20 as cfg
    from repro_torch.models import vision as V
    from repro_torch.models.module import tree_leaves, tree_map

    params = tree_map(lambda t: t.clone().requires_grad_(True), params)
    opt = torch.optim.AdamW(tree_leaves(params), lr=1e-3, weight_decay=1e-4)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for _ in range(steps):
        idx = torch.randint(0, x.shape[0], (batch,), generator=gen, device=dev)
        loss = V.cls_loss(V.resnet_forward(params, cfg, x[idx]), y[idx])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return tree_map(lambda t: t.detach(), params), float(loss.detach())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import bridge
    from repro_torch.api import (ForgetRequest, QuantSpec, Unlearner,
                                 UnlearnSpec)
    from repro_torch.configs import RESNET18_CIFAR20 as cfg
    from repro_torch.core import adapters
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import dampen as kd
    from repro_torch.models import vision as V
    from repro_torch.models.module import tree_leaves
    from repro_torch.optim.compression import INT8_SWEEP_RTOL, q8_quantize

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    rate = mem_rate(kind)
    log(f"[card] {kind} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | memory rate used for bounds {rate / 1e12:.2f} TB/s")

    # 2. build
    t0 = time.perf_counter()
    so = kd.build()
    log(f"[build] {so.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    for line in kd.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build]   {line.strip()}")

    # 3. kernel vs plain at every leaf shape + edge cases
    params = V.init_resnet(torch.Generator().manual_seed(SEED), cfg,
                           device="cuda")
    leaves = bridge.paths(params)
    shapes = [tuple(t.shape) for t in leaves.values()]
    n_params = sum(t.numel() for t in leaves.values())
    if len(shapes) != 56 or n_params != 11_177_300:
        raise AssertionError(f"RESNET18_CIFAR20 has {len(shapes)} leaves and "
                             f"{n_params} parameters, expected 56 / 11177300")
    t0 = time.perf_counter()
    cases, max_err = check_kernel_against_plain(shapes, dev)
    log(f"[kernel] dampen bit-identical to dampen_ref in {cases} cases "
        f"(56 leaf shapes x f32/bf16 x 3 pairs + edges), max |err| "
        f"{max_err} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    cases8, max_err8 = check_int8_kernel_against_plain(shapes, dev)
    log(f"[kernel] dampen_int8 bit-identical to dampen_int8_ref in {cases8} "
        f"cases (56 leaf shapes x 3 pairs + half-way, saturation, edges), "
        f"max |err| {max_err8} ({time.perf_counter() - t0:.1f} s)")

    # 4. the slice at full width
    x, y = syn.make_classification(syn.ClsDataConfig(
        n_classes=cfg.n_classes, img_size=cfg.img_size, n_per_class=80,
        seed=SEED))
    xd, yd = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    t0 = time.perf_counter()
    params, loss = pretrain(params, xd, yd, steps=300, batch=128, dev=dev)
    torch.cuda.synchronize()
    log(f"[train] 300 AdamW steps at batch 128 in "
        f"{time.perf_counter() - t0:.1f} s, last loss {loss:.4f}")

    splits = syn.split_forget_retain(x, y, forget_class=FORGET_CLASS)
    fx, fy = splits["forget"]
    fx, fy = fx[:64], fy[:64]
    rx, ry = splits["retain"]

    def acc(p, xs, ys):
        with torch.no_grad():
            xs = torch.as_tensor(xs, device=dev)
            ys = torch.as_tensor(ys, device=dev)
            return float(V.cls_accuracy(V.resnet_forward(p, cfg, xs), ys))

    tau = 1.0 / cfg.n_classes + 0.03
    log(f"[slice] before: forget acc {acc(params, fx, fy):.4f}, retain acc "
        f"{acc(params, rx, ry):.4f}; tau {tau:.4f}")
    loss_fn = lambda p, b: V.cls_loss(V.resnet_forward(p, cfg, b[0]), b[1])  # noqa: E731
    adapter = adapters.resnet_adapter(cfg, device="cuda")
    spec = lambda mode, **kw: UnlearnSpec.for_mode(  # noqa: E731
        mode, alpha=10.0, lam=1.0, tau=tau, checkpoint_every=2, chunk_size=8,
        **kw)
    ssd = Unlearner(adapter, spec=spec("ssd", use_kernel=True), device="cuda")
    t0 = time.perf_counter()
    ssd.ensure_fisher(loss_fn, params, (rx[:256], ry[:256]))
    torch.cuda.synchronize()
    log(f"[slice] ensure_fisher on 256 retain images (chunk 8) in "
        f"{time.perf_counter() - t0:.2f} s")
    ficabu = ssd.with_spec(spec("ficabu", use_kernel=True))
    before = {k: v.clone() for k, v in bridge.paths(params).items()}

    def serve(path, pairs):
        """Drive one path: both launch counters zeroed just before, read
        just after; per request the launches of each kernel."""
        kd.LAUNCHES = kd.INT8_LAUNCHES = 0    # this path starts
        runs = []
        for name, unl in pairs:
            l0, i0 = kd.LAUNCHES, kd.INT8_LAUNCHES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new, st = unl.forget(ForgetRequest(fx, fy, tag=name),
                                 params=params)
            torch.cuda.synchronize()
            runs.append((name, new, st, kd.LAUNCHES - l0,
                         kd.INT8_LAUNCHES - i0, time.perf_counter() - t0))
        counts = (kd.LAUNCHES, kd.INT8_LAUNCHES)   # this path ends
        for i, (name, new, st, launches, launches8, secs) in enumerate(runs):
            warm = i >= 2
            swept = sum(len(tree_leaves(adapter.get_layer(new, 10 - l)))
                        for l in range(1, st["stopped_at_l"] + 1))
            log(f"[slice] {path} {name:6s} {'warm' if warm else 'cold'}: "
                f"stopped_at_l={st['stopped_at_l']} "
                f"checkpoints={st['checkpoints_hit']} "
                f"macs_vs_ssd_pct={st['macs_vs_ssd_pct']:.4f} "
                f"launches dampen={launches} dampen_int8={launches8} "
                f"builds={st['engine']['compiles']} "
                f"hits={st['engine']['cache_hits']} wall={secs * 1e3:.1f} ms "
                f"forget acc {acc(new, fx, fy):.4f} retain acc "
                f"{acc(new, rx, ry):.4f}")
            mine, other = ((launches, launches8) if path == "fp32"
                           else (launches8, launches))
            if mine != swept or other != 0:
                raise AssertionError(
                    f"{path} {name}: {launches} dampen and {launches8} "
                    f"dampen_int8 launches for {swept} dampened leaves")
            if name == "ssd" and (mine != 56 or st["stopped_at_l"] != 10):
                raise AssertionError(f"{path} ssd sweep: {mine} launches, "
                                     f"stopped at {st['stopped_at_l']}")
            if st["engine"]["precision"] != path:
                raise AssertionError(f"{path} {name}: the engine ran "
                                     f"{st['engine']['precision']}")
            if warm and st["engine"]["compiles"] != 0:
                raise AssertionError(f"warm {path} {name} request built "
                                     f"{st['engine']['compiles']} steps")
            if not all(torch.isfinite(t).all() for t in tree_leaves(new)):
                raise AssertionError(f"{path} {name}: non-finite parameters")
            if acc(new, fx, fy) > acc(params, fx, fy):
                raise AssertionError(f"{path} {name}: forget accuracy rose")
        for k, t in bridge.paths(params).items():
            if not torch.equal(t, before[k]):
                raise AssertionError(f"{path} forget without donation "
                                     f"edited {k}")
        return runs, counts

    runs, (main_launches, _) = serve(
        "fp32", (("ssd", ssd), ("ficabu", ficabu), ("ssd", ssd),
                 ("ficabu", ficabu)))
    spec8 = lambda mode: spec(mode, use_kernel=True,  # noqa: E731
                              precision="int8", quant=QuantSpec())
    ssd8 = ssd.with_spec(spec8("ssd"))
    ficabu8 = ssd.with_spec(spec8("ficabu"))
    runs8, (_, main_launches8) = serve(
        "int8", (("ssd", ssd8), ("ficabu", ficabu8), ("ssd", ssd8),
                 ("ficabu", ficabu8)))
    for (name, new8, *_), (name32, new32, *_) in zip(runs8[:2], runs[:2]):
        if not on_q8_grid(bridge.paths(new8), before):
            raise AssertionError(f"int8 {name}: a leaf left its q8 grid")
        rel = layer_rel_l2(adapter, new8, new32)
        log(f"[slice] int8 {name} vs fp32 {name32}, per-layer relative L2 "
            f"(j = 0..9): {[round(r, 6) for r in rel]}")
        if not all(0.0 < r <= INT8_SWEEP_RTOL for r in rel):
            raise AssertionError(f"int8 {name}: per-layer error {rel} "
                                 f"outside (0, {INT8_SWEEP_RTOL}]")

    # 5. whole forget: kernel vs plain, deterministic cuDNN
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    for path, unl, plain in (
            ("fp32", ssd, ssd.with_spec(spec("ssd", use_kernel=False))),
            ("int8", ssd8, ssd.with_spec(spec("ssd", precision="int8",
                                              quant=QuantSpec())))):
        p_kernel, _ = unl.forget(ForgetRequest(fx, fy), params=params)
        p_plain, _ = plain.forget(ForgetRequest(fx, fy), params=params)
        a, b = bridge.paths(p_kernel), bridge.paths(p_plain)
        diff = [k for k in a if not torch.equal(bits(a[k]), bits(b[k]))]
        if diff:
            raise AssertionError(f"{path} kernel forget != plain forget at "
                                 f"{diff}")
        log(f"[slice] {path} ssd forget with the kernel == plain forget, bit "
            f"for bit, all 56 leaves")

    # 6. times at the main path's shapes
    fisher_g = ssd.fisher_global
    fl = bridge.paths(fisher_g)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    sweep_ops = []
    for k, th in bridge.paths(params).items():
        i_f = torch.rand(th.shape, generator=gen, device=dev) * 20 * fl[k]
        sweep_ops.append((th, i_f, fl[k]))
    n_sweep = sum(t.numel() for t, _, _ in sweep_ops)

    def sweep(fn):
        for th, i_f, i_g in sweep_ops:
            fn(th, i_f, i_g, 10.0, 1.0)

    big = max(shapes, key=lambda s: torch.Size(s).numel())
    n_big = torch.Size(big).numel()
    # four operand sets of the largest leaf (4 x 40 MB) so that every
    # launch reads from device memory, not from the 50 MB L2
    sets = [(torch.randn(big, generator=gen, device=dev),
             torch.rand(big, generator=gen, device=dev),
             torch.rand(big, generator=gen, device=dev)) for _ in range(4)]
    rot = iter(range(1 << 30))

    def one_big(fn, dtype=torch.float32):
        th, i_f, i_g = sets[next(rot) % 4]
        fn(th if dtype == torch.float32 else th.to(dtype), i_f, i_g, 10.0,
           1.0)

    sets_bf16 = [(s[0].to(torch.bfloat16),) + s[1:] for s in sets]

    def one_big_bf16(fn):
        th, i_f, i_g = sets_bf16[next(rot) % 4]
        fn(th, i_f, i_g, 10.0, 1.0)

    t = {
        "sweep_kernel": cuda_time_ms(lambda: sweep(kd.dampen_cuda), 8,
                                     queue_ahead=True),
        "sweep_plain": cuda_time_ms(lambda: sweep(kd.dampen_ref), 1,
                                    queue_ahead=True),
        "sweep_kernel_stream": cuda_time_ms(lambda: sweep(kd.dampen_cuda), 20),
        "sweep_plain_stream": cuda_time_ms(lambda: sweep(kd.dampen_ref), 20),
        "big_kernel": cuda_time_ms(lambda: one_big(kd.dampen_cuda), 200,
                                   queue_ahead=True),
        "big_plain": cuda_time_ms(lambda: one_big(kd.dampen_ref), 50,
                                  queue_ahead=True),
        "bf16_kernel": cuda_time_ms(lambda: one_big_bf16(kd.dampen_cuda),
                                    200, queue_ahead=True),
        "bf16_plain": cuda_time_ms(lambda: one_big_bf16(kd.dampen_ref), 40,
                                   queue_ahead=True),
    }
    bound = {"sweep": n_sweep * 17 / rate * 1e3, "big": n_big * 17 / rate
             * 1e3, "bf16": n_big * 13 / rate * 1e3}
    for key in ("sweep", "big", "bf16"):
        log(f"[time] dampen {key:5s} device: kernel {t[key + '_kernel']:.5f}"
            f" ms, plain {t[key + '_plain']:.5f} ms, bound "
            f"{bound[key]:.5f} ms ({bound[key] / t[key + '_kernel'] * 100:.1f}"
            f"% of the memory bound)")
    log(f"[time] dampen sweep stream (host launch overhead included): "
        f"kernel {t['sweep_kernel_stream']:.5f} ms, plain "
        f"{t['sweep_plain_stream']:.5f} ms")
    log(f"[time] (sweep = the 56 leaves of one ssd request, {n_sweep} "
        f"elements, f32; big = the largest leaf {big}, {n_big} elements; "
        f"device = launches queued ahead, back to back on the card)")

    # the int8 kernel at the int8 path's shapes: the same 56 leaves (and
    # four sets of the largest, 4 x 21 MB) as int8 codes
    sweep8_ops = [(q8_quantize(th)[0], i_f, i_g) for th, i_f, i_g in sweep_ops]
    sets8 = [(q8_quantize(st[0])[0],) + st[1:] for st in sets]

    def sweep8(fn):
        for q, i_f, i_g in sweep8_ops:
            fn(q, i_f, i_g, 10.0, 1.0)

    def one_big8(fn):
        q, i_f, i_g = sets8[next(rot) % 4]
        fn(q, i_f, i_g, 10.0, 1.0)

    t8 = {
        "sweep_kernel": cuda_time_ms(lambda: sweep8(kd.dampen_int8_cuda), 8,
                                     queue_ahead=True),
        "sweep_plain": cuda_time_ms(lambda: sweep8(kd.dampen_int8_ref), 1,
                                    queue_ahead=True),
        "sweep_kernel_stream": cuda_time_ms(
            lambda: sweep8(kd.dampen_int8_cuda), 20),
        "sweep_plain_stream": cuda_time_ms(
            lambda: sweep8(kd.dampen_int8_ref), 20),
        "big_kernel": cuda_time_ms(lambda: one_big8(kd.dampen_int8_cuda),
                                   200, queue_ahead=True),
        "big_plain": cuda_time_ms(lambda: one_big8(kd.dampen_int8_ref), 50,
                                  queue_ahead=True),
    }
    # 11 bytes per element: theta_q (1) + i_f (4) + i_g (4) read, codes (1)
    # + mask (1) written
    bound8 = {"sweep": n_sweep * 11 / rate * 1e3,
              "big": n_big * 11 / rate * 1e3}
    for key in ("sweep", "big"):
        log(f"[time] dampen_int8 {key:5s} device: kernel "
            f"{t8[key + '_kernel']:.5f} ms, plain {t8[key + '_plain']:.5f} ms,"
            f" bound {bound8[key]:.5f} ms "
            f"({bound8[key] / t8[key + '_kernel'] * 100:.1f}% of the memory "
            f"bound)")
    log(f"[time] dampen_int8 sweep stream (host launch overhead included): "
        f"kernel {t8['sweep_kernel_stream']:.5f} ms, plain "
        f"{t8['sweep_plain_stream']:.5f} ms")

    # where one warm ssd request spends its time on the card, per path
    prof = {}
    for path, unl in (("fp32", ssd), ("int8", ssd8)):
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            unl.forget(ForgetRequest(fx, fy), params=params)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = sorted(walls)[1]
        busy, n_kernels, top = profile_request(
            lambda: unl.forget(ForgetRequest(fx, fy), params=params))
        prof[path] = (wall, busy, n_kernels)
        log(f"[profile] warm {path} ssd request: wall {wall:.2f} ms (median "
            f"of {[round(w, 2) for w in walls]}), device busy {busy:.3f} ms, "
            f"idle share {1 - busy / wall:.3f}, {n_kernels} device kernels")
        for name, ms, count in top:
            log(f"[profile]   {ms:9.3f} ms  x{count:<5d} {name}")
    log(f"[profile] int8 / fp32 warm ssd request: wall "
        f"{prof['int8'][0] / prof['fp32'][0]:.3f}x, device busy "
        f"{prof['int8'][1] / prof['fp32'][1]:.3f}x, device kernels "
        f"{prof['int8'][2]} vs {prof['fp32'][2]} "
        f"(+{prof['int8'][2] - prof['fp32'][2]})")

    print(json.dumps({"kernels": [{
        "name": "dampen", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dampen.cu",
        "replaces": "src/repro/kernels/dampen.py:28",
        "launches": main_launches, "max_abs_err": max_err,
        "ms": t["sweep_kernel"], "plain_ms": t["sweep_plain"],
        "bound_ms": bound["sweep"], "bound_by": "bytes",
        "library_ms": None,
        "stream_ms": t["sweep_kernel_stream"],
        "plain_stream_ms": t["sweep_plain_stream"],
        "largest_leaf": {"n": n_big, "ms": t["big_kernel"],
                         "plain_ms": t["big_plain"],
                         "bound_ms": bound["big"],
                         "bf16_ms": t["bf16_kernel"],
                         "bf16_plain_ms": t["bf16_plain"],
                         "bf16_bound_ms": bound["bf16"]},
    }, {
        "name": "dampen_int8", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dampen.cu",
        "replaces": "src/repro/kernels/dampen.py:39",
        "launches": main_launches8, "max_abs_err": max_err8,
        "ms": t8["sweep_kernel"], "plain_ms": t8["sweep_plain"],
        "bound_ms": bound8["sweep"], "bound_by": "bytes",
        "library_ms": None,
        "stream_ms": t8["sweep_kernel_stream"],
        "plain_stream_ms": t8["sweep_plain_stream"],
        "largest_leaf": {"n": n_big, "ms": t8["big_kernel"],
                         "plain_ms": t8["big_plain"],
                         "bound_ms": bound8["big"]},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
