"""The comparison that decides ``correct``: a sample of the window's
forget requests, drawn from the seed, recomputed by the plain reference
(``portbench.reference``) and held against what ``Unlearner.forget``
returned.

The reference recomputes the global Fisher from the retain sequences at
the seed's weights, and each compared request's forget Fisher, selection,
edit and checkpoint accuracies from that request's input weights, in
float32. Request 0 starts from the seed's weights. A later request starts
from the weights the program published before it (the chain's state is
the program's: recomputing the whole chain would take the reference as
long as the window). The labels of a request are the served model's
argmax tokens, the program's output: the reference judges each by the
gap between its logit and the reference's best, and then takes it.

Numbers, the largest over the compared requests. Four are taken over the
request's swept leaves, two by the worst leaf (a fault confined to one
small leaf, a norm scale or a bias, is not averaged away by its layer's
large ones) and two by the median leaf (steady from seed to seed, so a
fault that moves every leaf a little shows). A cell compares those its
file gives a limit.

* ``label_gap``   the widest gap by which a label's logit lies below the
                  reference's best logit at its position (retain labels
                  included), in logits;
* ``flip_rate``   the worst leaf's elements selected differently, against
                  the reference's count of selected elements or the
                  cell's ``min_selected``, whichever is larger;
* ``flip_rate_median``  the same, the median over the leaves the
                  reference selects in;
* ``edit_gap``    the worst leaf's median of |ln(w_prog / w_ref)| over the
                  elements both select, of the leaves where both select
                  ``min_selected`` or more (the median of a handful of
                  elements swings by its nature): how far the program's
                  beta lies from the reference's;
* ``edit_gap_median``  the same, the median over those leaves;
* ``mismatches``  a count, limit 0: a checkpoint list or halt depth that
                  does not follow from the program's own accuracies and
                  tau; a layer whose reported selection count is not the
                  elements its output changed (plus at most its elements
                  that were 0); an element changed in a layer the sweep
                  did not reach.

A program's selection is read from its output: an element is selected
where the edited weight differs from the input, bit for bit (beta is
below 1 / alpha wherever the rule selects, so a selected weight never
rounds back to itself), except where the input is 0 and stays 0 whatever
the selection: there the reference's selection stands.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference import ficabu as RF
from portbench.reference import model as RM

from .config import Dims
from .weights import layer_leaves, layer_tensor

NUMBERS = ("label_gap", "flip_rate", "flip_rate_median", "edit_gap",
           "edit_gap_median", "mismatches")
_BIG = 1e30
# elements a leaf is compared in at a time: bounds the temporaries
_PIECE = 1 << 25
_COUNTS = ("n", "changed", "zero", "ref", "flips", "both")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def request_numbers(tallies: List[Dict], min_selected: int
                    ) -> Dict[str, float]:
    """One request's leaf numbers: the worst leaf's and the median
    leaf's."""
    flips = [t["flips"] / max(t["ref"], min_selected) for t in tallies
             if t["ref"]]
    gaps = [t["gap"] for t in tallies if t["both"] >= min_selected]
    out = {}
    for name, xs in (("flip_rate", flips), ("edit_gap", gaps)):
        out[name] = max(xs, default=0.0)
        out[name + "_median"] = float(np.median(xs)) if xs else 0.0
    return out


class Judge:
    """Accumulates the compared numbers over requests; ``leaves`` keeps
    every compared leaf's tally and ``accs`` each request's checkpoint
    accuracies, the program's beside the reference's (for calibration:
    no cell compares them, PERF.md says why)."""

    def __init__(self, dims: Dims, cell: Dict, device):
        self.dims, self.cell, self.device = dims, cell, torch.device(device)
        RM.no_tf32()
        self.rope = RM.rope_tables(dims, int(cell["seq_len"]), self.device)
        self.values = {n: 0.0 for n in NUMBERS}
        self.compared: List[int] = []
        self.reasons: List[str] = []
        self.leaves: List[Dict] = []
        self.accs: List[Dict] = []

    def _max(self, name: str, v: float) -> None:
        v = _BIG if not math.isfinite(v) else float(v)
        self.values[name] = max(self.values[name], v)

    def global_fisher(self, tree0: Dict, tokens: torch.Tensor,
                      labels: torch.Tensor, layers: int) -> Dict:
        """The reference's I_D of paper layers 1..layers."""
        f, gap = RF.global_fisher(self.dims, self.cell, tree0, tokens,
                                  labels, self.rope, layers)
        self._max("label_gap", gap)
        return f

    def halting(self, st: Dict) -> int:
        """Mismatches of the program's halting with its own trace."""
        L = self.dims.n_unlearn_layers
        _, cps = RF.rules(self.cell, L)
        tau = float(self.cell["tau"])
        stop = int(st["stopped_at_l"])
        trace = [(int(l), float(a)) for l, a in st["forget_acc_trace"]]
        want_stop = next((l for l, a in trace if a <= tau), L)
        want_cps = [c for c in cps if c <= stop]
        bad = [f"checkpoints {st['checkpoints_hit']} for {want_cps}"
               if list(st["checkpoints_hit"]) != want_cps else "",
               f"trace {trace} for {want_cps}"
               if [l for l, _ in trace] != want_cps else "",
               f"halt {stop} for {want_stop}" if stop != want_stop else ""]
        self.reasons += [b for b in bad if b]
        return sum(1 for b in bad if b)

    def request(self, k: int, tree_in: Dict, tree_out: Dict,
                tokens: torch.Tensor, labels: torch.Tensor, st: Dict,
                fisher_g: Dict) -> None:
        dims = self.dims
        L = dims.n_unlearn_layers
        stop = min(int(st["stopped_at_l"]), L)
        mism = self.halting(st)
        tallies: List[Dict] = []

        def on_leaf(l, path, idx, new_ref, sel_ref):
            t = dict.fromkeys(_COUNTS, 0)
            got_in = layer_tensor(tree_in, path, idx).to(self.device)
            got = layer_tensor(tree_out, path, idx).to(self.device)
            gaps = []
            parts = zip(*(x.reshape(-1).split(_PIECE) for x in
                          (got_in, got, new_ref, sel_ref)))
            for g_in, g, ref, s_ref in parts:
                gaps.append(self._piece(t, g_in, g, ref, s_ref))
            gap = torch.cat(gaps)
            t["gap"] = float(gap.median()) if gap.numel() else 0.0
            t.update(k=k, l=l, leaf=path if idx is None else f"{path}[{idx}]")
            tallies.append(t)

        res = RF.sweep(dims, self.cell, tree_in, tokens, labels, fisher_g,
                       stop, on_leaf, self.rope)
        self._max("label_gap", res["label_gap"])
        got_acc = [(int(l), float(a)) for l, a in st["forget_acc_trace"]]
        ref_acc = {int(l): float(a) for l, a in res["acc_trace"]}
        self.accs.append({"k": k, "program": got_acc,
                          "reference": sorted(ref_acc.items())})
        for name, v in request_numbers(
                tallies, int(self.cell["min_selected"])).items():
            self._max(name, v)
        for l in range(1, stop + 1):
            ts = [t for t in tallies if t["l"] == l]
            changed = sum(t["changed"] for t in ts)
            zero = sum(t["zero"] for t in ts)
            rep = int(st["selected_per_layer"].get(l, -1))
            # a weight that is 0 stays 0 when selected: the program's
            # selection of it cannot be read, only bounded
            if not changed <= rep <= changed + zero:
                mism += 1
                self.reasons.append(
                    f"request {k} layer {l}: {rep} selected reported, "
                    f"{changed} changed, {zero} zero")
        with torch.no_grad():
            for l in range(stop + 1, L + 1):
                for path, idx in layer_leaves(dims, L - l):
                    a = layer_tensor(tree_in, path, idx)
                    b = layer_tensor(tree_out, path, idx)
                    n = int((_bits(a) != _bits(b)).sum())
                    if n:
                        mism += n
                        self.reasons.append(f"request {k} layer {l} not "
                                            f"swept: {n} elements changed")
        self.values["mismatches"] += mism
        self.leaves += tallies
        self.compared.append(k)

    def _piece(self, t: Dict, got_in, got, new_ref, sel_ref
               ) -> torch.Tensor:
        """One piece of a swept leaf, flattened: adds to the leaf's tally
        and returns the log gaps of the elements both select. Where the
        input is 0 the program's selection cannot be read and the
        reference's stands."""
        zero = got_in == 0
        changed = _bits(got) != _bits(got_in)
        sel_prog = changed | (zero & sel_ref)
        both = sel_prog & sel_ref & ~zero
        t["n"] += got.numel()
        t["changed"] += int(changed.sum())
        t["zero"] += int(zero.sum())
        t["ref"] += int(sel_ref.sum())
        t["flips"] += int((sel_prog ^ sel_ref).sum())
        t["both"] += int(both.sum())
        g32, ref = got[both].to(torch.float32), new_ref[both]
        gap = (g32.abs().log() - ref.abs().log()).abs()
        return torch.where((g32 == 0) & (ref == 0), 0.0, gap)

    def verdict(self, limits: Dict[str, float]) -> Tuple[bool, Dict]:
        """(every number within its limit, {name: {value, limit}})."""
        out = {n: {"value": self.values[n], "limit": float(limits[n])}
               for n in NUMBERS if n in limits}
        ok = all(v["value"] <= v["limit"] for v in out.values())
        return ok, out


def sample_request(seed: int) -> int:
    """The later request compared besides request 0, drawn from the seed
    among requests 1..3 (compared when the window completes it)."""
    return 1 + int(np.random.default_rng([int(seed), 7]).integers(3))
