"""Depth-aware schedules: the Balanced Dampening profile S(l) (Eq. 5/6) and
checkpoint-set construction for Context-Adaptive Unlearning.

Layer indexing follows the paper: l = 1 is the BACK-END layer (classifier /
lm head), l = L the FRONT-END layer (stem / embedding).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def sigmoid_profile(L: int, b_r: float = 10.0, c_m: Optional[float] = None) -> np.ndarray:
    """S(l) for l = 1..L (returned as index 0 == l=1, the back-end).

    S(l) = 1 + (b_r - 1) * (sigma(l) - sigma(1)) / (sigma(L) - sigma(1)),
    sigma(l) = 1 / (1 + exp(-(l - c_m))).

    S(1) == 1 (paper-strength edits at the back-end) rising monotonically to
    S(L) == b_r (edits weakened by b_r at the front-end: larger alpha selects
    fewer parameters, larger lambda dampens less).
    """
    if L == 1:
        return np.ones(1)
    if c_m is None:
        c_m = (1 + L) / 2.0
    l = np.arange(1, L + 1, dtype=np.float64)
    sig = 1.0 / (1.0 + np.exp(-(l - c_m)))
    denom = sig[-1] - sig[0]
    if abs(denom) < 1e-12:
        return np.ones(L)
    return 1.0 + (b_r - 1.0) * (sig - sig[0]) / denom


def midpoint_from_selection(selected_counts: Sequence[float],
                            smooth: int = 3) -> float:
    """Paper §III-B: smooth the layer-wise selected-parameter distribution and
    center c_m at the mid-point between the smoothed extrema.

    ``selected_counts[i]`` is the SSD selection count for paper-layer l = i+1.
    """
    x = np.asarray(selected_counts, dtype=np.float64)
    if len(x) < 2:
        return 1.0
    k = max(1, min(smooth, len(x)))
    kernel = np.ones(k) / k
    sm = np.convolve(x, kernel, mode="same")
    l_hi = int(np.argmax(sm)) + 1
    l_lo = int(np.argmin(sm)) + 1
    return (l_hi + l_lo) / 2.0


def checkpoint_set(L: int, every: int, include_first_last: bool = True) -> List[int]:
    """Checkpoint layers (paper indexing l=1..L): every ``every`` layers,
    plus the first and last layers (paper's placement)."""
    cps = set(range(every, L + 1, every))
    if include_first_last:
        cps.add(1)
        cps.add(L)
    return sorted(cps)
