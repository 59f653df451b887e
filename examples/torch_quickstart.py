"""Quickstart on the PyTorch/CUDA port: FiCABU in ~60 lines.

Trains a small classifier on synthetic data, stands up an ``Unlearner``
facade (which computes and stores the global Fisher importance once, as SSD
prescribes), then serves a forget request with the full FiCABU method
(Context-Adaptive Unlearning + Balanced Dampening) and prints the
before/after metrics. The same steps, sizes and seeds as
``examples/quickstart.py``, on ``repro_torch``; the weights are drawn from
a ``torch.Generator`` on the host.

    PYTHONPATH=src python examples/torch_quickstart.py               # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # host
"""
import argparse

import torch

from repro_torch.api import ForgetRequest, RefreshSpec, UnlearnSpec, Unlearner
from repro_torch.core import adapters, metrics
from repro_torch.data import synthetic as syn
from repro_torch.device import resolve_device
from repro_torch.models import vision as V
from repro_torch.optim import AdamWConfig, init_adamw, make_train_step


def run(device="cuda", *, params=None, steps=150) -> dict:
    """The example's steps on ``device``. ``params`` skips the pre-training
    (a tree trained elsewhere, on ``device``). Returns what the script
    prints."""
    dev = resolve_device(device)
    out = {}

    def on_dev(*arrays):
        return tuple(torch.as_tensor(a, device=dev) for a in arrays)

    # 1. Data: 6 classes; class 3 will be the forget set.
    dcfg = syn.ClsDataConfig(n_classes=6, n_per_class=32, img_size=16,
                             seed=0)
    x, y = syn.make_classification(dcfg)
    splits = syn.split_forget_retain(x, y, forget_class=3)

    # 2. Pre-train a small ResNet.
    cfg = V.ResNetConfig(width=8, n_classes=6, img_size=16)

    def loss_fn(p, b):
        return V.cls_loss(V.resnet_forward(p, cfg, b[0]), b[1])

    if params is None:
        # (the port's vision init draws on the host's generator, then
        # moves the weights: the same weights on the card and the host)
        params = V.init_resnet(torch.Generator().manual_seed(0), cfg,
                               device=dev)
        ocfg = AdamWConfig(lr=2e-3, total_steps=steps, warmup_steps=10)
        step = make_train_step(loss_fn, ocfg)
        opt = init_adamw(ocfg, params)
        bt = syn.Batches((x, y), batch=48, seed=1)
        for _ in range(steps):
            params, opt, loss = step(params, opt, on_dev(*next(bt)))
        out["final_loss"] = float(loss)

    # 3. The unlearning service: one typed spec + one facade. The facade
    #    computes the global importance I_D ONCE after training and stores
    #    it.
    adapter = adapters.resnet_adapter(cfg, device=dev)
    unl = Unlearner(adapter, spec=UnlearnSpec.for_mode(
        "ficabu",                 # CAU + Balanced Dampening
        alpha=10.0, lam=1.0,      # the paper's SSD hyperparameters
        tau=1 / 6 + 0.03,         # random-guess target
        checkpoint_every=2),      # checkpoints every 2 layers
        device=dev)
    unl.ensure_fisher(loss_fn, params, on_dev(x[:128], y[:128]),
                      chunk_size=8)

    # 4. A forget request arrives: unlearn class 3 with FiCABU.
    fx, fy = on_dev(*splits["forget"])
    rx, ry = on_dev(*splits["retain"])

    def accs(p):
        with torch.no_grad():
            return (float(metrics.accuracy(V.resnet_forward(p, cfg, fx), fy)),
                    float(metrics.accuracy(V.resnet_forward(p, cfg, rx), ry)))

    out["before"] = accs(params)
    new_params, stats = unl.forget(
        ForgetRequest(fx[:32], fy[:32], tag="class-3"), params=params)
    out["after"] = accs(new_params)
    out.update({k: stats[k] for k in ("stopped_at_l", "checkpoints_hit",
                                      "macs_vs_ssd_pct")},
               n_layers=adapter.n_layers)

    # 5. Long-lived service: the edit just invalidated the stored I_D a
    #    little (it was computed on the PRE-edit weights). Stream a refresh
    #    — fold retain microbatches at the current weights into an EMA of
    #    I_D — so the next forget request dampens against importance that
    #    still describes the served parameters (serve.py --fisher-refresh N).
    unl.enable_fisher_refresh(RefreshSpec(every_drains=1, max_batches=2,
                                          decay=0.5),
                              [(rx[:32], ry[:32]), (rx[32:64], ry[32:64])],
                              loss_fn)
    # (a serving loop would call unl.refresh_if_due(params) after each
    # drain and let the policy decide; here we force one refresh)
    entry = unl.refresh_now(new_params)
    out["refresh"] = {k: entry[k] for k in ("batches", "ema_count")}
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    res = run(ap.parse_args().device)
    print(f"pre-trained, final loss {res['final_loss']:.4f}")
    for tag in ("before", "after"):
        fa, ra = res[tag]
        print(f"{tag:8s} forget={fa * 100:5.1f}%  retain={ra * 100:5.1f}%")
    print(f"early-stopped at layer l={res['stopped_at_l']} of "
          f"{res['n_layers']}; MACs vs SSD: {res['macs_vs_ssd_pct']:.1f}%")
    print(f"refreshed I_D: folded {res['refresh']['batches']} retain "
          f"microbatch(es) at the edited weights (EMA count="
          f"{res['refresh']['ema_count']})")
