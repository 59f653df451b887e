"""The device trace of a window and its reduction: the kernels that ran,
their time by class (``kernel_classes.json``), the device's busy time,
the longest idle gaps named by what the host was doing, and the top
operations.

The trace is ``torch.profiler`` with the device activity alone (recording
the host's operators beside the kernels costs about a millisecond a
kernel). The host's phases come from the harness's own clock: a marker
kernel launched right after a synchronise ties the trace's clock to the
host's, so a gap on the device can be named by the host phase it fell in.
"""
from __future__ import annotations

import json
import re
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

_CLASSES = Path(__file__).with_name("kernel_classes.json")


def load_classes() -> List[Tuple[str, "re.Pattern"]]:
    with open(_CLASSES) as f:
        rows = json.load(f)["classes"]
    return [(name, re.compile(pat)) for name, pat in rows]


def classify(name: str, classes) -> str:
    for cls, pat in classes:
        if pat.search(name):
            return cls
    return "elementwise"


class Tracer:
    """Profiles the device over a window; ``phase(name)`` marks what the
    host does from now on."""

    def __init__(self):
        self.phases: List[Tuple[float, str]] = []
        self._prof = None
        self.marker_host_s = 0.0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self.marker_host_s = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        return self

    def phase(self, name: str) -> None:
        self.phases.append((time.perf_counter(), name))

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        return False

    def device_ops(self) -> List[Tuple[str, float, float]]:
        """(name, start, end) of every device operation, in seconds on the
        host's ``perf_counter`` clock, by start."""
        evs = [e for e in self._prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        marks = [e for e in evs if "spin_kernel" in e.name]
        if not marks:
            raise RuntimeError("the marker kernel is missing from the trace")
        shift = self.marker_host_s - marks[0].time_range.start / 1e6
        ops = [(e.name, e.time_range.start / 1e6 + shift,
                e.time_range.end / 1e6 + shift) for e in evs
               if e is not marks[0]]
        return sorted(ops, key=lambda o: o[1])


def reduce_ops(ops: Sequence[Tuple[str, float, float]], t0: float, t1: float,
               phases: Sequence[Tuple[float, str]], classes) -> Dict:
    """The window [t0, t1]'s busy time (the union of operations, clipped),
    seconds by class and by name, and the idle gaps named by the host
    phase they began in."""
    by_class: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    busy = 0.0
    gaps: List[Tuple[float, str]] = []
    cur_end = t0
    prev = "window start"
    for name, s, e in ops:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        d = e - s
        cls = classify(name, classes)
        by_class[cls] = by_class.get(cls, 0.0) + d
        by_name[name] = by_name.get(name, 0.0) + d
        if s > cur_end:
            gaps.append((s - cur_end, _gap_name(cur_end, phases, prev)))
        if e > cur_end:
            busy += e - max(s, cur_end)
            cur_end = e
            prev = name
    if t1 > cur_end:
        gaps.append((t1 - cur_end, _gap_name(cur_end, phases, prev)))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    merged: Dict[str, float] = {}
    for d, n in gaps:
        merged[n] = merged.get(n, 0.0) + d
    idle = sorted(merged.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "by_class": by_class,
            "device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in idle]}


def _gap_name(at: float, phases: Sequence[Tuple[float, str]],
              prev: str) -> str:
    host = "before the window"
    for t, name in phases:
        if t > at:
            break
        host = name
    return f"host {host}, after {prev[:80]}"
