"""Roofline terms of a dry-run cell at a card's peaks (port of
``repro.launch.roofline``).

    compute term    = FLOPs      / dense bf16 tensor FLOP/s
    memory term     = bytes      / HBM bytes/s
    collective term = coll_bytes / NVLink bytes/s per direction

Every count is per device (one rank of the mesh): the FLOPs and bytes of
the program one rank runs, counted by ``launch.dryrun`` under
``FakeTensorMode``, and the bytes the rank's collectives move. The
"global" FLOPs multiply back by the chip count (both are recorded).

The port has no HLO text: ``collective_stats`` reads its own record of
collectives, one ``(op, result)`` per collective, ``result`` a
``(dtype, shape)`` pair or a sequence of them (a tuple result), and sums
the reference's per-op bytes: the result bytes, the all-reduce's doubled
for its reduce and broadcast rounds.

``PEAKS`` holds the rates of each card by the name
``torch.cuda.get_device_name()`` gives (a key is a part of that name),
dense (no sparsity), at the card's full power limit, from NVIDIA's data
sheets: the H100 Tensor Core GPU data sheet (SXM5 and PCIe columns; the
PCIe card's NVLink is its bridge), the H100 NVL product brief and the H200
Tensor Core GPU data sheet (SXM column). NVLink is quoted there as the
bidirectional total: per direction is half of it.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Sequence, Tuple, Union

import torch

# name part -> rates; the first key found in a card's name wins, so a more
# specific name comes before "H100"
PEAKS: Dict[str, Dict[str, float]] = {
    "H100 PCIe": {"bf16": 756e12, "hbm": 2.0e12, "nvlink": 300e9,
                  "f32": 51e12, "tf32": 378e12, "int8": 1513e12},
    "H100 NVL": {"bf16": 835e12, "hbm": 3.9e12, "nvlink": 300e9,
                 "f32": 60e12, "tf32": 418e12, "int8": 1671e12},
    "H200": {"bf16": 989e12, "hbm": 4.8e12, "nvlink": 450e9,
             "f32": 67e12, "tf32": 495e12, "int8": 1979e12},
    "H100": {"bf16": 989e12, "hbm": 3.35e12, "nvlink": 450e9,
             "f32": 67e12, "tf32": 495e12, "int8": 1979e12},
}

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
}
_TORCH_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.bfloat16: "bf16", torch.float16: "f16",
    torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
    torch.float64: "f64",
}

Result = Tuple[Union[str, torch.dtype], Sequence[int]]


def peaks(card: str) -> Dict[str, float]:
    """The rates of the card named ``card`` (e.g. "NVIDIA H100 80GB
    HBM3"); raises for a card with none on record."""
    for key, rates in PEAKS.items():
        if key in card:
            return rates
    raise ValueError(f"no peak rates on record for card {card!r}; "
                     f"launch.roofline.PEAKS has {sorted(PEAKS)}")


def dtype_name(dtype) -> str:
    """The HLO name of a dtype ("bf16", "f32", ...)."""
    return _TORCH_NAMES[dtype] if isinstance(dtype, torch.dtype) else dtype


def _shape_bytes(dtype, shape: Iterable[int]) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * _DTYPE_BYTES.get(dtype_name(dtype), 4)


def collective_stats(records: Iterable[Tuple[str, Any]]) -> Dict[str, Any]:
    """Per-device bytes moved by ``records``: ``(op, result)`` pairs, op
    one of all-gather, all-reduce, reduce-scatter, all-to-all,
    collective-permute; ``result`` a ``(dtype, shape)`` pair or a sequence
    of them."""
    per_op: Dict[str, int] = {}
    counts: Dict[str, int] = {}
    for op, result in records:
        parts = ([result] if isinstance(result[0], (str, torch.dtype))
                 else list(result))
        b = sum(_shape_bytes(dt, shape) for dt, shape in parts)
        if op == "all-reduce":
            b *= 2                      # reduce-scatter + all-gather rounds
        per_op[op] = per_op.get(op, 0) + b
        counts[op] = counts.get(op, 0) + 1
    return {"bytes_per_device": sum(per_op.values()),
            "by_op_bytes": per_op, "by_op_counts": counts}


def roofline_terms(cost: Dict[str, float], coll_bytes_per_dev: int,
                   n_chips: int, model_flops: float, *,
                   card: str) -> Dict[str, Any]:
    """The reference's terms and keys at ``card``'s peaks (dense bf16
    FLOP/s, HBM bytes/s, NVLink bytes/s per direction)."""
    rates = peaks(card)
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    t_compute = flops_dev / rates["bf16"]
    t_memory = bytes_dev / rates["hbm"]
    t_coll = coll_bytes_per_dev / rates["nvlink"]
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(t_compute, t_memory, t_coll)
    hlo_flops_global = flops_dev * n_chips
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "hlo_flops_per_device": flops_dev,
        "hlo_bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll_bytes_per_dev,
        "hlo_flops_global": hlo_flops_global,
        "model_flops": model_flops,
        "useful_flops_ratio": (model_flops / hlo_flops_global
                               if hlo_flops_global else 0.0),
        "roofline_fraction": (t_compute / bound) if bound > 0 else 0.0,
        "step_time_bound_s": bound,
        "card": card,
        "peaks": {"bf16_flops": rates["bf16"], "hbm_bytes_s": rates["hbm"],
                  "nvlink_bytes_s": rates["nvlink"]},
    }


def memory_summary(mem: Dict[str, Any]) -> Dict[str, int]:
    """The reference's memory keys the port has a value for
    (``argument_size_in_bytes``, ``output_size_in_bytes``,
    ``temp_size_in_bytes``); others are absent, as a JAX version that does
    not expose a field leaves it out."""
    out = {}
    for k in ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "alias_size_in_bytes",
              "generated_code_size_in_bytes"):
        v = mem.get(k)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            out[k] = int(v)
    return out
