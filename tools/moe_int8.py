#!/usr/bin/env python3
"""The int8 error of an MoE forget request against fp32, by alpha, on one
card.

    python3 tools/moe_int8.py     # from the repository root

llama4-scout-17b-a16e at full width and 1 block, built as
``chip_smoke.py``'s [moe] phase builds it (bf16 weights and an f32 router
from a CUDA generator seeded with 0; sequences of 1024 tokens from
make_lm_domains, argmax labels, lambda 1, the retain Fisher of 4 sequences
at chunk 2 from ensure_fisher), with two requests: 4 sequences at chunk 2
and the phase's own (``MOE_SEQS`` at ``MOE_CHUNK``). For each request and
alpha, one fp32 and one int8 ssd request: each layer's int8-against-fp32 relative L2 (INT8_SWEEP_RTOL
bounds it), the block's leaf by leaf, and the share of each layer's
entries selected on each side. Then the routing that the int8 deployment
changes: each block's top-1 expert and kept choices on the request's
tokens (``chip_smoke.moe_dispatches``), under the caller's weights and
under their fake quantisation (the weights an int8 request's forward and
vjp run on), in the collection and in each vjp chunk. A last JSON line
holds every figure.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
ALPHAS = (25.0, 50.0, 100.0, 200.0, 400.0, 800.0)


def main() -> int:
    if not torch.cuda.is_available():
        print("moe_int8: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch import bridge
    from repro_torch.api import (ForgetRequest, QuantSpec, Unlearner,
                                 UnlearnSpec)
    from repro_torch.configs import get as get_arch
    from repro_torch.core import adapters
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import build as kbuild
    from repro_torch.models import lm as LM
    from repro_torch.models.module import tree_leaves, tree_map
    from repro_torch.optim.compression import q8_fakequant_tree

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    kbuild.build_all()
    dev = torch.device("cuda", 0)
    cfg = get_arch(cs.MOE_ARCH).full.with_(n_layers=cs.MOE_BLOCKS)
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

    retain = request(split["retain"][:4])

    def spec(a, chunk, **kw):
        return UnlearnSpec.for_mode("ssd", alpha=a, lam=1.0, tau=-1.0,
                                    checkpoint_every=1, chunk_size=chunk,
                                    use_kernel=True, **kw)

    unl = Unlearner(adapter, spec=spec(ALPHAS[0], 2), device="cuda")
    unl.ensure_fisher(lambda p, b: LM.lm_loss(p, cfg, b[0], b[1]), params,
                      (retain.inputs, retain.labels), chunk_size=2)
    L = adapter.n_layers
    n_layer = [sum(t.numel() for t in tree_leaves(adapter.get_layer(
        params, j))) for j in range(L)]
    out = {}
    for n_seq, chunk in ((4, 2), (cs.MOE_SEQS, cs.MOE_CHUNK)):
        req = request(split["forget"][:n_seq])
        tag = f"{n_seq}x{cs.LM_SEQ} chunk {chunk}"
        by_alpha = {}
        for a in ALPHAS:
            p32, st32 = unl.with_spec(spec(a, chunk)).forget(req,
                                                             params=params)
            p32 = tree_map(lambda t: t.cpu(), p32)
            p8, st8 = unl.with_spec(spec(a, chunk, precision="int8",
                                         quant=QuantSpec())).forget(
                req, params=params)
            rel = cs.layer_rel_l2(adapter, p8, p32)
            blk8 = bridge.paths(adapter.get_layer(p8, 1))
            blk32 = bridge.paths(adapter.get_layer(p32, 1))
            leaf = {}
            for k, x in blk8.items():
                y = blk32[k].to(dev).double()
                leaf[k] = float(((x.double() - y) ** 2).sum().sqrt()
                                / (y ** 2).sum().sqrt())
            sel = {prec: [st["selected_per_layer"][L - j] / n_layer[j]
                          for j in range(L)]
                   for prec, st in (("fp32", st32), ("int8", st8))}
            by_alpha[a] = {"rel_l2": rel, "block_leaf_rel_l2": leaf,
                           "selected_share": sel}
            print(f"[moe_int8] {tag} alpha {a}: int8 against fp32 per layer "
                  f"(j = 0..{L - 1}) {[round(r, 6) for r in rel]}; share "
                  f"selected, fp32 {[round(x, 5) for x in sel['fp32']]}, "
                  f"int8 {[round(x, 5) for x in sel['int8']]}", flush=True)
            print(f"[moe_int8]   block 1 by leaf: "
                  f"{ {k: round(v, 5) for k, v in leaf.items()} }",
                  flush=True)
            del p8, p32, blk8, blk32
            torch.cuda.empty_cache()
        r32, _ = cs.moe_dispatches(adapter, cfg, params, req.inputs, chunk)
        r8, _ = cs.moe_dispatches(adapter, cfg, q8_fakequant_tree(params),
                                  req.inputs, chunk)
        flips = {}
        for (j, what, e32, k32, _), (_, _, e8, k8, _) in zip(r32, r8):
            flips[f"{j} {what}"] = f = {
                "tokens": int(e32.numel()),
                "top1_differs": int((e32 != e8).sum()),
                "kept_differs": int((k32 != k8).sum()),
                "dropped_fp32": int((~k32).sum()),
                "dropped_int8": int((~k8).sum())}
            print(f"[moe_int8] {tag} block {j} {what}: {f}", flush=True)
        out[tag] = {"by_alpha": by_alpha, "routing_fp32_vs_fq": flips}
    print(json.dumps({"card": smi, "arch": cfg.name, "blocks": cfg.n_layers,
                      "requests": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
