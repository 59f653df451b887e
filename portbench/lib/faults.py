"""Faults planted underneath the timed path, for the tests that show the
check fails them (and for reading them on the card): the program with one
thing broken. None of them runs in a benchmark run."""
from __future__ import annotations

import torch

from portbench.loops.forget import Program


class Unchanged(Program):
    """A step that returns its state unchanged: the request's stats come
    back, the weights do not move."""

    def forget(self, params, tokens, labels, *, tau=None):
        _, st = super().forget(params, tokens, labels, tau=tau)
        return params, st


class HalfBatch(Program):
    """Half of the batch left out: the request runs on the first half of
    its sequences, so its Fisher is the mean over the rest."""

    def forget(self, params, tokens, labels, *, tau=None):
        h = tokens.shape[0] // 2
        return super().forget(params, tokens[:h], labels[:h], tau=tau)


class LabelAltered(Program):
    """A token altered where it is produced: one label of every request
    is the next token id instead of the served model's argmax."""

    def labels(self, params, tokens):
        out = super().labels(params, tokens).clone()
        out[0, 0] = (out[0, 0] + 1) % self.cfg.vocab
        return out


class LeafBeta(Program):
    """One small leaf's edits wrong: in the last block's k projection
    (under 1% of the block's elements) each selected weight is
    multiplied by its beta twice. Its selection and counts stay right."""

    def forget(self, params, tokens, labels, *, tau=None):
        new, st = super().forget(params, tokens, labels, tau=tau)
        w_in = params["period_stack"]["0"]["mixer"]["wk"][-1]
        w = new["period_stack"]["0"]["mixer"]["wk"]
        f_in, f = w_in.float(), w[-1].float()
        twice = torch.where(f_in != 0, f * f / f_in.where(f_in != 0, 1.0),
                            f)
        w = w.clone()
        w[-1] = twice.to(w.dtype)
        mixer = dict(new["period_stack"]["0"]["mixer"], wk=w)
        block = dict(new["period_stack"]["0"], mixer=mixer)
        return dict(new, period_stack={"0": block}), st


class AccZero(Program):
    """The forget accuracy reported as 0 at every checkpoint, so every
    request halts at the first one (a warm-up's tau is kept)."""

    def forget(self, params, tokens, labels, *, tau=None):
        if tau is not None:
            return super().forget(params, tokens, labels, tau=tau)
        new, st = super().forget(params, tokens, labels, tau=2.0)
        st = dict(st, forget_acc_trace=[(l, 0.0) for l, _ in
                                        st["forget_acc_trace"]])
        return new, st


FAULTS = {"unchanged": Unchanged, "half_batch": HalfBatch,
          "label_altered": LabelAltered, "leaf_beta": LeafBeta,
          "acc_zero": AccZero}
