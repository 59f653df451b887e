"""End-to-end driver on the PyTorch/CUDA port: train an LM for a few hundred
steps, checkpoint, receive a forget request mid-run (journaled), unlearn,
verify, resume.

This drives ``repro_torch.launch.train`` with the yi-6b reduced config, as
``examples/train_then_forget.py`` drives the JAX package's launcher: the
same arguments, with ``--device`` passed through.

    PYTHONPATH=src python examples/torch_train_then_forget.py               # card
    PYTHONPATH=src python examples/torch_train_then_forget.py --device cpu  # host
"""
import argparse
import tempfile

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.launch import train


def runs(*, steps=200, resume_steps=220, unlearn_at=150, ckpt_every=50,
         batch=16, seq=32):
    """The two runs' arguments to ``train.main``, the reference example's
    (without ``--ckpt-dir`` and ``--device``): run 1 trains ``steps`` steps
    with the forget request at ``unlearn_at``; run 2 restarts from the
    newest checkpoint and trains on to ``resume_steps``."""
    common = ["--arch", "yi-6b", "--batch", str(batch), "--seq", str(seq),
              "--lr", "3e-3", "--ckpt-every", str(ckpt_every)]
    return (common + ["--steps", str(steps), "--unlearn-at", str(unlearn_at),
                      "--forget-domain", "2"],
            common + ["--steps", str(resume_steps), "--resume",
                      "--unlearn-at", "-1"])


def run(device="cuda", **sizes) -> dict:
    """``runs(**sizes)`` on ``device``, one checkpoint directory between
    them. Returns both runs' results and the journal of forget requests."""
    first, second = runs(**sizes)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        where = ["--ckpt-dir", ckpt_dir, "--device", str(device)]
        res = train.main(first + where)
        res2 = train.main(second + where)
        journal = ckpt.journal_read(ckpt_dir)
    return {"run1": res, "run2": res2, "journal": journal}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    print("== run 1: train 200 steps, forget request at step 150; run 2: "
          "simulate restart — resume from newest checkpoint ==")
    out = run(ap.parse_args().device)
    print("run 1:", out["run1"])
    print("run 2 (resumed):", out["run2"])
    print("journal:", out["journal"])
    assert out["run2"]["start_step"] >= 150
