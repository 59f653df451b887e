"""LM unlearning on the PyTorch/CUDA port: forget a DOMAIN from a language
model.

The paper forgets an image class; the LM analogue forgets a token-tagged
subdomain — here one Markov-chain domain out of four. The example trains
a 2-layer LM until every domain is predictable, then removes domain 1 with
FiCABU and shows its next-token accuracy collapsing while the other
domains keep theirs. The same steps, sizes and seeds as
``examples/unlearn_lm_domain.py``, on ``repro_torch``; the weights are
drawn from a ``torch.Generator``.

    PYTHONPATH=src python examples/torch_unlearn_lm_domain.py               # card
    PYTHONPATH=src python examples/torch_unlearn_lm_domain.py --device cpu  # host
"""
import argparse

import torch

from repro_torch.api import ForgetRequest, UnlearnSpec, Unlearner
from repro_torch.core import adapters, metrics
from repro_torch.data import synthetic as syn
from repro_torch.device import resolve_device
from repro_torch.models import lm as LM
from repro_torch.optim import AdamWConfig, init_adamw, make_train_step

CFG = LM.LMConfig(name="demo", n_layers=2, d_model=64, n_heads=4,
                  n_kv_heads=2, d_ff=128, vocab=128)
DATA = syn.LMDataConfig(vocab=128, n_domains=4, seq_len=24, n_per_domain=24,
                        seed=1)


def run(device="cuda", *, params=None, steps=120) -> dict:
    """The example's steps on ``device``. ``params`` skips the training (a
    tree trained elsewhere, on ``device``). Returns what the script
    prints."""
    dev = resolve_device(device)
    cfg = CFG
    tokens, domains = syn.make_lm_domains(DATA)
    toks = torch.as_tensor(tokens, device=dev).long()

    def loss_fn(p, b):
        return LM.lm_loss(p, cfg, b[0], b[1], aux_weight=0.0)

    if params is None:
        params = LM.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                            device=dev)
        ocfg = AdamWConfig(lr=3e-3, total_steps=steps, warmup_steps=10)
        step = make_train_step(loss_fn, ocfg)
        opt = init_adamw(ocfg, params)
        bt = syn.Batches((tokens[:, :-1], tokens[:, 1:]), batch=32, seed=2)
        for _ in range(steps):
            params, opt, _ = step(params, opt, tuple(
                torch.as_tensor(a, device=dev).long() for a in next(bt)))

    def domain_accs(p):
        out = []
        with torch.no_grad():
            for d in range(4):
                t = toks[torch.as_tensor(domains == d, device=dev)]
                logits, _ = LM.forward(p, cfg, t[:, :-1])
                out.append(float(metrics.token_accuracy(logits, t[:, 1:])))
        return out

    pre = domain_accs(params)
    splits = syn.lm_split_forget_retain(tokens, domains, forget_domain=1)
    fb = torch.as_tensor(splits["forget"][:24], device=dev).long()
    adapter = adapters.lm_adapter(cfg, 24, device=dev)
    unl = Unlearner(adapter, spec=UnlearnSpec.for_mode(
        "ficabu", alpha=6.0, lam=0.5, tau=pre[1] * 0.5, checkpoint_every=1),
        device=dev)
    unl.ensure_fisher(loss_fn, params, (toks[:64, :-1], toks[:64, 1:]),
                      chunk_size=8)
    params2, stats = unl.forget(ForgetRequest(fb[:, :-1], fb[:, 1:],
                                              tag="domain-1"), params=params)
    return {"pre": pre, "post": domain_accs(params2),
            **{k: stats[k] for k in ("stopped_at_l", "checkpoints_hit",
                                     "macs_vs_ssd_pct")}}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    res = run(ap.parse_args().device)
    pre, post = res["pre"], res["post"]
    print("next-token acc per domain (pre): ",
          " ".join(f"{a * 100:5.1f}%" for a in pre))
    print("next-token acc per domain (post):",
          " ".join(f"{a * 100:5.1f}%" for a in post))
    print(f"domain 1 forgotten: {pre[1] * 100:.1f}% -> {post[1] * 100:.1f}%  "
          f"(MACs vs SSD: {res['macs_vs_ssd_pct']:.1f}%)")
