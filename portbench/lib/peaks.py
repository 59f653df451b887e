"""Published peaks of the cards a cell may run on: NVIDIA's data sheet,
SXM part, dense rates without sparsity, at the full 700 W power limit.
A share of a roofline or of a peak is stated against these numbers."""
from __future__ import annotations

from typing import Dict

PEAKS: Dict[str, Dict[str, float]] = {
    "H100": {
        "bf16_flops": 989e12,
        "hbm_bytes": 3.35e12,
    },
}


def peaks(device_name: str) -> Dict[str, float]:
    """The peaks of the card whose ``torch.cuda.get_device_name()`` is
    ``device_name``; raises for a card this table does not hold."""
    for key, row in PEAKS.items():
        if key in device_name:
            return row
    raise KeyError(f"no peaks for card {device_name!r}; the table holds "
                   f"{sorted(PEAKS)}")
