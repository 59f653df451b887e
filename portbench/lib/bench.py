"""What one run needs beside its loop: ``BENCHMARK.json`` and the cell's
files found by name, the reading the metric readers take, the readers
themselves (``metrics/<name>.py``), the result line, and the check that
no JAX module was loaded."""
from __future__ import annotations

import dataclasses
import importlib
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

from .config import Dims, dims_of, load_json

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    entry: Dict[str, Any]        # the cell's entry in BENCHMARK.json
    spec: Dict[str, Any]         # workloads/<name>.json
    config: Dict[str, Any]       # configs/<config>.json
    dims: Dims


def load_cell(root: Path, name: str) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"BENCHMARK.json has no cell {name!r}; it has "
                       f"{[w['name'] for w in bench['workloads']]}")
    entry = entries[0]
    spec = load_json(root / "portbench" / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if spec[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json names {key} "
                             f"{spec[key]!r}, BENCHMARK.json {entry[key]!r}")
    conf = [c for c in bench["configs"] if c["name"] == entry["config"]]
    if len(conf) != 1:
        raise KeyError(f"BENCHMARK.json has no configuration "
                       f"{entry['config']!r}")
    config = load_json(root / conf[0]["file"])
    return Cell(name, entry, spec, config, dims_of(config))


def cell_metrics(root: Path, name: str, trace: bool) -> List[Dict[str, Any]]:
    """The metrics a run of cell ``name`` reports: the end-to-end ones
    untraced, the per-layer ones traced; a metric with a ``workloads`` key
    only in the cells it lists."""
    bench = load_json(root / "BENCHMARK.json")
    rows = bench["per_layer" if trace else "end_to_end"]
    return [m for m in rows if name in m.get("workloads", [name])]


@dataclasses.dataclass
class Reading:
    """What a run measured, for the metric readers. ``trace`` is None in
    an untraced run."""
    cell: Cell
    setup_s: float
    window_s: float
    requests: List[Dict[str, Any]]      # latency_s, tokens, stats
    peak_window_bytes: int
    peaks: Dict[str, float]
    trace: Optional[Dict[str, Any]] = None   # lib.trace.reduce_ops


def read_metric(name: str, reading: Reading) -> Optional[float]:
    """``metrics/<name>.py``'s ``read(reading)``: a number, or None when
    the run holds nothing for it to read."""
    mod = importlib.import_module(f"portbench.metrics.{name}")
    return mod.read(reading)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Dict[str, Any]], device: Dict[str, Any],
                breakdown: Optional[Dict] = None,
                checks: Dict[str, Dict[str, float]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {"correct": bool(correct),
                           "attempted": int(attempted),
                           "failed": int(failed), "metrics": metrics,
                           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out
