"""Back-end-first SSD / FiCABU in plain float32 PyTorch (the paper's
Algorithm 1 with Balanced Dampening, Eqs. 2-6).

* The diagonal Fisher: the mean over chunks of ``chunk_size`` sequences
  of the squared gradient of the chunk's mean token loss (Eq. 2 with the
  official SSD's per-batch chunks). The global I_D takes the training
  loss (cross-entropy plus ``z_loss * logsumexp^2``), a forget set's I_Df
  the cross-entropy alone.
* Layers l = 1 (the head) .. L (the embedding) are dampened back to front
  with the unedited weights' Fisher. Layer l selects ``I_Df > alpha_l *
  I_D`` and multiplies the selected weights by ``beta = min(lam_l * I_D /
  I_Df, 1)``, with ``alpha_l = alpha * S(l)``, ``lam_l = lam * S(l)``
  rounded to float32 and S(l) the sigmoid profile of Eq. 5/6 (all ones
  without Balanced Dampening).
* At each checkpoint (every ``checkpoint_every`` layers, and the first
  and last) the forget accuracy is taken by partial inference: the
  unedited forward's input of layer l pushed through the edited layers
  l .. 1. The sweep halts at the first checkpoint whose accuracy is at
  most tau.

``sweep`` walks to a halt depth it is given (the program's decision, which
the check judges by the accuracies) and hands each layer's leaves to a
callback, so the caller compares them one at a time.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench.lib.config import Dims
from portbench.lib.weights import layer_leaves, layer_tensor

from . import model as M

F32 = torch.float32


def sigmoid_profile(L: int, b_r: float, c_m: Optional[float]) -> np.ndarray:
    """S(l), l = 1..L: 1 at the head rising to b_r at the front,
    S(l) = 1 + (b_r - 1) (sig(l) - sig(1)) / (sig(L) - sig(1)),
    sig(l) = 1 / (1 + exp(-(l - c_m))), c_m the middle by default."""
    if L == 1:
        return np.ones(1)
    c = (1 + L) / 2.0 if c_m is None else c_m
    l = np.arange(1, L + 1, dtype=np.float64)
    sig = 1.0 / (1.0 + np.exp(-(l - c)))
    den = sig[-1] - sig[0]
    if abs(den) < 1e-12:
        return np.ones(L)
    return 1.0 + (b_r - 1.0) * (sig - sig[0]) / den


def checkpoints(L: int, every: int) -> List[int]:
    """Every ``every``-th layer, plus the first and the last."""
    if not 0 < every <= L:
        return []
    return sorted(set(range(every, L + 1, every)) | {1, L})


def rules(cell: Dict, L: int) -> Tuple[np.ndarray, List[int]]:
    """Per paper layer (alpha_l, lam_l) in float32, and the checkpoints."""
    balanced = cell["mode"] in ("bd", "ficabu")
    halting = cell["mode"] in ("cau", "ficabu")
    S = (sigmoid_profile(L, float(cell.get("b_r", 10.0)), cell.get("c_m"))
         if balanced else np.ones(L))
    al = np.empty((L, 2), np.float32)
    for l in range(1, L + 1):
        al[l - 1] = (np.float32(cell["alpha"] * float(S[l - 1])),
                     np.float32(cell["lam"] * float(S[l - 1])))
    cps = checkpoints(L, int(cell["checkpoint_every"])) if halting else []
    return al, cps


def layer_keys(dims: Dims, layers: int) -> List[Tuple[str, Optional[int]]]:
    """The leaves, as (path, block index or None), of paper layers
    1..layers."""
    L = dims.n_unlearn_layers
    return [k for l in range(1, layers + 1) for k in layer_leaves(dims, L - l)]


def float_tree(dims: Dims, tree: Dict, device) -> Dict:
    """Every layer's leaves of a port-layout tree in float32 on ``device``,
    by (path, block index or None)."""
    return {k: layer_tensor(tree, *k).detach().to(device, F32)
            for k in layer_keys(dims, dims.n_unlearn_layers)}


def getter(p32: Dict, edits: Optional[Dict] = None) -> M.Get:
    def get(path, index):
        if edits is not None and (path, index) in edits:
            return edits[(path, index)]
        return p32[(path, index)]
    return get


def fisher(dims: Dims, p32: Dict, tokens: torch.Tensor,
           labels: torch.Tensor, chunk: int, z_loss: float, rope,
           keys: List) -> Dict:
    """Mean over chunks of squared chunk gradients, of the leaves
    ``keys``."""
    acc = {k: torch.zeros_like(p32[k]) for k in keys}
    n = tokens.shape[0] // chunk
    for c in range(n):
        leaves = {k: p32[k].detach().requires_grad_(True) for k in keys}
        rows = slice(c * chunk, (c + 1) * chunk)
        with torch.enable_grad():
            logits, _ = M.forward(getter(p32, leaves), dims, tokens[rows],
                                  rope)
            loss = M.token_loss(logits, labels[rows], z_loss)
            del logits
            grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
        for k, g in zip(keys, grads):
            g = M.rd(g)
            acc[k].addcmul_(g, g)
        del grads, leaves
    for k in keys:
        acc[k].div_(n)
    return acc


def label_gap(logits: torch.Tensor, labels: torch.Tensor) -> float:
    """The widest gap by which a given label's logit lies below the
    reference's best logit at its position."""
    best = logits.max(dim=-1).values
    got = logits.gather(-1, labels[..., None])[..., 0]
    return float((best - got).max())


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> float:
    return float((logits.argmax(-1) == labels).to(torch.float64).mean())


LayerFn = Callable[[int, str, Optional[int], torch.Tensor, torch.Tensor],
                   None]


def sweep(dims: Dims, cell: Dict, tree_in: Dict, tokens: torch.Tensor,
          labels: torch.Tensor, fisher_g: Dict, stop_l: int,
          on_leaf: LayerFn, rope) -> Dict:
    """One forget request from ``tree_in`` swept to ``stop_l``.

    Calls ``on_leaf(l, path, index, theta_new, selected)`` for every leaf
    of every swept layer, the head first.
    Returns the label gap of ``labels`` under the unedited model and the
    forget accuracy at each checkpoint swept."""
    L = dims.n_unlearn_layers
    al, cps = rules(cell, L)
    p32 = float_tree(dims, tree_in, tokens.device)
    with torch.no_grad():
        logits, acts = M.forward(getter(p32), dims, tokens, rope,
                                 collect=True)
        gap = label_gap(logits, labels)
        del logits
    f_f = fisher(dims, p32, tokens, labels, int(cell["chunk_size"]), 0.0,
                 rope, layer_keys(dims, stop_l))
    edits: Dict = {}
    accs: List[Tuple[int, float]] = []
    with torch.no_grad():
        for l in range(1, stop_l + 1):
            j = L - l
            a_l, lam_l = float(al[l - 1, 0]), float(al[l - 1, 1])
            for key in layer_leaves(dims, j):
                th, i_f, i_g = p32[key], f_f.pop(key), fisher_g[key]
                thr = torch.tensor(a_l, dtype=F32, device=th.device) * i_g
                sel = i_f > thr
                beta = (torch.tensor(lam_l, dtype=F32, device=th.device)
                        * i_g / i_f.clamp_min(1e-30)).clamp_max(1.0)
                new = M.rd(torch.where(sel, th * beta, th))
                edits[key] = new
                on_leaf(l, key[0], key[1], new, sel)
                del i_f
            if l in cps:
                x = acts[j]
                for jj in range(j, L):
                    x = M.apply_layer(getter(p32, edits), dims, jj, x, rope)
                accs.append((l, accuracy(x, labels)))
                del x
    return {"label_gap": gap, "acc_trace": accs}


def global_fisher(dims: Dims, cell: Dict, tree: Dict, tokens: torch.Tensor,
                  labels: torch.Tensor, rope, layers: int,
                  z_loss: float = 1e-4) -> Tuple[Dict, float]:
    """I_D of paper layers 1..layers on the retain sequences (the
    training loss, z_loss 1e-4), and the label gap of their labels under
    ``tree``."""
    p32 = float_tree(dims, tree, tokens.device)
    with torch.no_grad():
        logits, _ = M.forward(getter(p32), dims, tokens, rope)
        gap = label_gap(logits, labels)
        del logits
    return fisher(dims, p32, tokens, labels, int(cell["chunk_size"]),
                  z_loss, rope, layer_keys(dims, layers)), gap
