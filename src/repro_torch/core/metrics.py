"""Evaluation metrics: forget/retain accuracy, membership-inference attack
(MIA) accuracy, Retain Preservation Rate (RPR, Eq. 7), and MAC accounting —
the paper's hardware-relevant computation proxy — with its int8-vs-fp32
byte-MAC and energy proxies (``mac_proxy_table``).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

F32 = torch.float32


def _hit_rate(hits: torch.Tensor) -> torch.Tensor:
    """The mean of a 0/1 tensor as the reference's compiled programs take
    ``jnp.mean``: the (exact) f32 sum times the f32 reciprocal of the
    count, the product XLA puts in place of a division by a constant. A
    division rounds otherwise where the count is no power of 2 (806 hits
    of 6144 tokens: one ulp apart)."""
    return hits.to(F32).sum() * float(np.float32(1.0 / hits.numel()))


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy as a device scalar (argmax ties take the first
    index, as jnp.argmax does)."""
    return _hit_rate(logits.argmax(-1) == labels)


def token_accuracy(logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """Next-token top-1 accuracy for LM forget/retain evaluation."""
    return _hit_rate(logits.argmax(-1) == labels)


def per_sample_nll(logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """[N, V], [N] -> [N] negative log-likelihoods (classification) or
    [N, S, V], [N, S] -> [N] mean-token NLL (LM)."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if nll.ndim == 2:
        nll = nll.mean(dim=-1)
    return nll


def mia_accuracy(forget_nll: np.ndarray, heldout_nll: np.ndarray) -> float:
    """Threshold-based membership inference: the attacker predicts "member"
    when the loss is below a threshold chosen to maximise attack accuracy.
    Returns the best achievable attack accuracy in [0, 1]; 0.5 = chance.
    After successful unlearning the forget samples look like non-members, so
    LOWER is better (the paper reports MIA accuracy the same way).
    """
    f = np.asarray(forget_nll, np.float64)
    h = np.asarray(heldout_nll, np.float64)
    scores = np.concatenate([f, h])
    labels = np.concatenate([np.ones_like(f), np.zeros_like(h)])
    order = np.argsort(scores)
    best = 0.0
    for thr in np.unique(scores[order]):
        pred = (scores <= thr).astype(np.float64)  # member == low loss
        best = max(best, float((pred == labels).mean()))
    return best


def rpr(delta_dr_ours: float, delta_dr_ssd: float) -> float:
    """Retain Preservation Rate, Eq. (7), in percent."""
    if abs(delta_dr_ssd) < 1e-12:
        return 0.0
    return (1.0 - delta_dr_ours / delta_dr_ssd) * 100.0


# ---------------------------------------------------------------------------
# MAC accounting (hardware proxy, per the paper)
# ---------------------------------------------------------------------------
class MacCounter:
    """Accumulates MACs on the host while the CAU driver runs on device.

    SSD cost model (per the paper's normalisation):
      - Fisher pass: forward + backward over all layers = 3x forward MACs
      - dampening: |theta| MAC-equivalents (one multiply per parameter)
    CAU cost: only the layers actually swept, plus checkpoint partial
    inference (cached activations -> layers l..1 only), which is the overhead
    the paper includes in its reported MACs.
    """

    def __init__(self, layer_fwd_macs: Sequence[int],
                 layer_params: Sequence[int], batch: int):
        self.fwd = list(layer_fwd_macs)       # per-sample forward MACs, depth j
        self.prm = list(layer_params)
        self.batch = batch
        self.total = 0

    # --- components -------------------------------------------------------
    def add_forward_all(self):
        self.total += self.batch * sum(self.fwd)

    def add_backward_layer(self, j: int):
        # dgrad + wgrad ~= 2x forward MACs of that layer
        self.total += self.batch * 2 * self.fwd[j]

    def add_fisher_layer(self, j: int):
        self.total += self.prm[j]             # square+accumulate per param

    def add_dampen_layer(self, j: int):
        self.total += self.prm[j]             # compare/beta/multiply per param

    def add_partial_inference(self, j_from: int, n_layers_total: int):
        # forward from depth j_from to the head using cached activations
        self.total += self.batch * sum(self.fwd[j_from:n_layers_total])

    @staticmethod
    def ssd_total(layer_fwd_macs, layer_params, batch) -> int:
        return batch * 3 * sum(layer_fwd_macs) + 2 * sum(layer_params)


# ---------------------------------------------------------------------------
# Precision proxies: byte-MACs and MAC energy (the int8-vs-fp32 table)
# ---------------------------------------------------------------------------
# Bytes of streamed operand traffic per MAC: two operands per MAC, 4 bytes
# each at fp32, 1 byte each at int8. Accumulators (f32/int32) and the
# per-channel f32 scale tables stay resident in on-chip memory and are
# amortised over a whole reduction, so they are left out of the per-MAC
# figure, the normalisation under which the paper's INT8 GEMM pipeline
# claims its bandwidth economy.
MAC_OPERAND_BYTES = {"fp32": 8.0, "int8": 2.0}

# Energy per MAC in pJ at 45nm (Horowitz, ISSCC'14 "Computing's energy
# problem"): 32b float mult 3.7 + add 0.9 ~= 4.6; 8b int mult 0.2 + 32b int
# add 0.03 ~= 0.23. A coarse proxy (the paper's measured RTL numbers fold
# in SRAM/DRAM traffic too), but it makes the fp32:int8 ratio reportable.
MAC_ENERGY_PJ = {"fp32": 4.6, "int8": 0.23}


def _check_precision(precision: str) -> None:
    if precision not in MAC_OPERAND_BYTES:
        raise ValueError(
            f"precision must be one of {sorted(MAC_OPERAND_BYTES)}, got "
            f"{precision!r}")


def byte_macs(macs: int, precision: str) -> float:
    """Operand-traffic-weighted MAC count: macs * bytes-per-MAC."""
    _check_precision(precision)
    return float(macs) * MAC_OPERAND_BYTES[precision]


def mac_energy_j(macs: int, precision: str) -> float:
    """Energy proxy in joules for ``macs`` MACs at ``precision``."""
    _check_precision(precision)
    return float(macs) * MAC_ENERGY_PJ[precision] * 1e-12


def mac_proxy_table(macs: int) -> dict:
    """The int8-vs-fp32 MAC and energy-proxy rows for one sweep's MAC
    count (the byte-MAC reduction is 8/2 = 4x by construction)."""
    return {
        "macs": int(macs),
        "fp32_byte_macs": byte_macs(macs, "fp32"),
        "int8_byte_macs": byte_macs(macs, "int8"),
        "bytemac_reduction": MAC_OPERAND_BYTES["fp32"] / MAC_OPERAND_BYTES["int8"],
        "fp32_mac_energy_j": mac_energy_j(macs, "fp32"),
        "int8_mac_energy_j": mac_energy_j(macs, "int8"),
        "energy_reduction": MAC_ENERGY_PJ["fp32"] / MAC_ENERGY_PJ["int8"],
    }
