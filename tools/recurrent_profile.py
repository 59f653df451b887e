#!/usr/bin/env python3
"""Where a warm xlstm-125m forget request spends its time on one card.

    python3 tools/recurrent_profile.py     # from the repository root

xlstm-125m FULL (bf16 weights from a CUDA generator seeded with 0) serves
the warm fp32 ssd request of ``chip_smoke.py``'s [recurrent] phase (8
sequences of 1024 tokens from make_lm_domains, argmax labels, chunk 2,
alpha 50, lambda 1, the retain Fisher of 4 sequences from ensure_fisher).
The request makes about a million device kernels, mostly the sLSTM's time
loop (a few dozen per step, 1024 steps, in each of its 3 layers, forward
and backward, per chunk), so torch.profiler takes minutes to process it:
this script profiles it with the device's activity alone, outside the
smoke test. It prints the card, the request's wall (the least of two warm
requests), its NVML busy share (chip_smoke.nvml_busy) beside the
profile's device busy time, the device kernels and the kernels by time.
Then the int8 setting: the ssd request at alpha 25 ([lm]'s) and at the
phase's alpha, fp32 and int8, with each layer's int8-against-fp32
relative L2 (INT8_SWEEP_RTOL bounds it) and the share of its entries
selected. Last, each block kind of the two recurrent archs at full width
(mLSTM, sLSTM; RG-LRU, local attention; one block's random bf16 weights),
and the RG-LRU's scan alone, timed forward and backward on one chunk of a
request (2 sequences of 1024 tokens), host clock around a synchronised
call, the least of 3 after one warm-up: what a request's vjp pays per
layer and chunk. A last JSON line holds every figure.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def block_times(dev):
    """Forward + backward of one block of each recurrent kind (and of the
    RG-LRU's scan alone) on a chunk of 2 x 1024 tokens, in ms."""
    from repro_torch.configs import get as get_arch
    from repro_torch.models import lm as LM
    from repro_torch.models import recurrent as R
    from repro_torch.models.module import tree_leaves, tree_unflatten

    def timed(fn, args):
        best = float("inf")
        for i in range(4):
            leaves = [a.detach().requires_grad_(True) for a in args]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*leaves)
            torch.autograd.grad(out.float().sum(), leaves)
            torch.cuda.synchronize()
            if i:
                best = min(best, (time.perf_counter() - t0) * 1e3)
        return best

    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for arch, kinds in (("xlstm-125m", ("mlstm", "slstm")),
                        ("recurrentgemma-9b", ("rglru", "local"))):
        cfg = get_arch(arch).full
        x = torch.randn(2, 1024, cfg.d_model, generator=gen, device=dev).to(
            cfg.dtype)
        pos = torch.arange(1024, device=dev)[None].expand(2, 1024)
        for kind in kinds:
            p = LM.init_block(gen, cfg, kind, device=dev)
            flat = tree_leaves(p)

            def fwd(xx, *ws, _p=p, _k=kind, _c=cfg):
                q = tree_unflatten(_p, list(ws))
                return LM.block_forward(q, _c, _k, xx, pos)[0]

            out[kind] = timed(fwd, [x] + flat)
        if arch == "recurrentgemma-9b":
            dr = cfg.rglru_cfg().d_rnn
            a = torch.rand(2, 1024, dr, generator=gen, device=dev)
            b = torch.randn(2, 1024, dr, generator=gen, device=dev)
            out["rglru scan"] = timed(R.linear_scan, [a, b])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("recurrent_profile: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.api import (ForgetRequest, QuantSpec, Unlearner,
                                 UnlearnSpec)
    from repro_torch.configs import get as get_arch
    from repro_torch.core import adapters
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import build as kbuild
    from repro_torch.models import lm as LM
    from repro_torch.models.module import tree_leaves

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    kbuild.build_all()
    dev = torch.device("cuda", 0)
    arch, _, n_seq, every, alpha, _ = cs.REC_MODELS[0]
    cfg = get_arch(arch).full
    params = LM.init_lm(torch.Generator(device=dev).manual_seed(cs.SEED),
                        cfg, device="cuda")
    adapter = adapters.lm_adapter(cfg, cs.LM_SEQ, device="cuda")
    toks, doms = syn.make_lm_domains(syn.LMDataConfig(
        vocab=cs.LM_DATA_VOCAB, n_domains=4, seq_len=cs.LM_SEQ,
        n_per_domain=8, seed=cs.SEED))
    split = syn.lm_split_forget_retain(toks, doms, cs.LM_FORGET)

    def request(seqs):
        x = torch.as_tensor(seqs[:, :-1], device=dev).long().contiguous()
        with torch.no_grad():
            y = LM.forward(params, cfg, x)[0].argmax(-1)
        return ForgetRequest(x, y)

    req, retain = request(split["forget"][:n_seq]), request(
        split["retain"][:4])
    def spec(a, **kw):
        return UnlearnSpec.for_mode("ssd", alpha=a, lam=1.0, tau=-1.0,
                                    checkpoint_every=every, chunk_size=2,
                                    use_kernel=True, **kw)

    unl = Unlearner(adapter, spec=spec(alpha), device="cuda")
    unl.ensure_fisher(lambda p, b: LM.lm_loss(p, cfg, b[0], b[1]), params,
                      (retain.inputs, retain.labels), chunk_size=2)
    unl.forget(req, params=params)                  # builds the steps
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        unl.forget(req, params=params)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    share, n_samples = cs.nvml_busy(lambda: unl.forget(req, params=params))
    t0 = time.perf_counter()
    busy, n_kernels, ranked = cs.profile_request(
        lambda: unl.forget(req, params=params))
    prof_s = time.perf_counter() - t0
    wall = min(walls)
    print(f"[recurrent_profile] {cfg.name} warm fp32 ssd request: wall "
          f"{wall:.2f} ms (least of {[round(w, 2) for w in walls]}), NVML "
          f"busy share {share:.3f} ({n_samples} samples), profiled device "
          f"busy {busy:.3f} ms (idle share {1 - busy / wall:.3f}), "
          f"{n_kernels} device kernels; profiled in {prof_s:.1f} s",
          flush=True)
    for name, ms, count in ranked[:12]:
        print(f"[recurrent_profile]   {ms:9.3f} ms  x{count:<8d} {name[:90]}")
    L = adapter.n_layers
    n_layer = [sum(t.numel() for t in tree_leaves(adapter.get_layer(
        params, j))) for j in range(L)]
    by_alpha = {}
    for a in (25.0, alpha):
        got = {prec: unl.with_spec(spec(a, **kw)).forget(req, params=params)
               for prec, kw in (("fp32", {}), ("int8", {
                   "precision": "int8", "quant": QuantSpec()}))}
        rel = cs.layer_rel_l2(adapter, got["int8"][0], got["fp32"][0])
        sel = {prec: [got[prec][1]["selected_per_layer"][L - j] / n_layer[j]
                      for j in range(L)] for prec in got}
        by_alpha[a] = {"rel_l2": rel, "selected_share": sel}
        print(f"[recurrent_profile] alpha {a}: int8 against fp32 per layer "
              f"(j = 0..{L - 1}) {[round(r, 6) for r in rel]} (largest "
              f"{max(rel):.6f}); share selected, fp32 "
              f"{[round(x, 4) for x in sel['fp32']]}, int8 "
              f"{[round(x, 4) for x in sel['int8']]}", flush=True)
    del unl, params
    torch.cuda.empty_cache()
    blocks = block_times(dev)
    print(f"[recurrent_profile] forward + backward on 2 x 1024 tokens, ms: "
          f"{ {k: round(v, 3) for k, v in blocks.items()} }", flush=True)
    print(json.dumps({"card": smi, "arch": cfg.name, "wall_ms": wall,
                      "walls_ms": walls, "nvml_busy_share": share,
                      "device_busy_ms": busy, "device_kernels": n_kernels,
                      "profile_seconds": prof_s,
                      "top": [[n[:120], ms, c] for n, ms, c in ranked[:12]],
                      "int8_by_alpha": by_alpha, "block_ms": blocks}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
