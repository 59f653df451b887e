"""The program's spans (``repro_torch.obs.telemetry.span``) against the
device trace of a window.

A span recorded on the card carries ``dev_start`` / ``dev_end`` on the
host's ``perf_counter`` clock, the clock ``Tracer.device_ops`` (here, a
``trace.Tracer`` tied to the host more closely) shifts the device's
operations onto. So the device's busy time inside a span is
the union of the operations clipped to the span (as ``trace.reduce_ops``
counts the window's), and a phase list made of the spans' host edges names
an idle gap by what the engine was doing.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import trace

# longest label of a span in a phase list
LABEL_CHARS = 16


class Tracer(trace.Tracer):
    """``trace.Tracer`` with its clock tied to the host's by many launches.

    ``trace.Tracer`` takes the host's clock read before its one marker
    launch as the marker's start; the first launch under the profiler
    takes 0.4–0.5 ms to return, and in a process's first profile the
    trace came out 0.6–5 ms early against the host. Here, after ``WARM``
    launches that let the profiler settle (the first ones start 50–100 µs
    late), each of ``TIES`` spin kernels is launched on an idle device
    after a host read: a kernel starts no earlier than its read, so the
    latest read less its kernel's start is the shift, early by the
    device's shortest delay."""

    WARM = 10
    TIES = 20

    def __enter__(self):
        super().__enter__()
        import torch
        # the host's read before each spin kernel; None for a warm one
        self.launch_host = [self.marker_host_s]
        for i in range(self.WARM + self.TIES):
            torch.cuda.synchronize()
            self.launch_host.append(
                None if i < self.WARM else time.perf_counter())
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        return self

    def device_ops(self) -> List[Tuple[str, float, float]]:
        import torch
        evs = [e for e in self._prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        marks = [e for e in evs if "spin_kernel" in e.name]
        marks = marks[:len(self.launch_host)]
        if len(marks) < len(self.launch_host):
            raise RuntimeError("the tying kernels are missing from the trace")
        shift = max(h - e.time_range.start / 1e6
                    for h, e in zip(self.launch_host, marks)
                    if h is not None)
        skip = {id(e) for e in marks}
        ops = [(e.name, e.time_range.start / 1e6 + shift,
                e.time_range.end / 1e6 + shift) for e in evs
               if id(e) not in skip]
        return sorted(ops, key=lambda o: o[1])


class Busy:
    """The device's busy intervals (the union of its operations), for
    the busy time inside any interval in O(log n)."""

    def __init__(self, ops: Iterable[Tuple[str, float, float]]):
        starts: List[float] = []
        ends: List[float] = []
        for _, s, e in sorted(ops, key=lambda o: o[1]):
            if e <= s:
                continue
            if ends and s <= ends[-1]:
                ends[-1] = max(ends[-1], e)
            else:
                starts.append(s)
                ends.append(e)
        self.starts, self.ends = starts, ends
        # cum[i]: busy time of intervals 0 .. i-1
        self.cum = [0.0]
        for s, e in zip(starts, ends):
            self.cum.append(self.cum[-1] + (e - s))

    def _upto(self, t: float) -> float:
        k = bisect.bisect_right(self.starts, t) - 1
        if k < 0:
            return 0.0
        return self.cum[k] + min(t, self.ends[k]) - self.starts[k]

    def between(self, s: float, e: float) -> float:
        """Busy seconds inside [s, e]."""
        return max(0.0, self._upto(e) - self._upto(s)) if e > s else 0.0


def busy_of(busy: Busy, span: Dict, t0: float, t1: float) -> float:
    """Busy seconds inside a span's device interval, clipped to the
    window [t0, t1]; 0 for a span without device times."""
    if "dev_start" not in span or span.get("dev_end") is None:
        return 0.0
    return busy.between(max(span["dev_start"], t0), min(span["dev_end"], t1))


def busy_by_name(ops: Sequence[Tuple[str, float, float]],
                 spans: Sequence[Dict], t0: float, t1: float
                 ) -> Dict[str, float]:
    """Device busy seconds inside the spans of each name, clipped to the
    window. Spans of one name never nest, so their sum counts no
    operation twice."""
    busy = Busy(ops)
    out: Dict[str, float] = {}
    for s in spans:
        out[s["name"]] = out.get(s["name"], 0.0) + busy_of(busy, s, t0, t1)
    return out


def past_halt(ops: Sequence[Tuple[str, float, float]],
              spans: Sequence[Dict], t0: float, t1: float,
              stopped_at: Dict[int, int]) -> float:
    """Device busy seconds in the ``layer`` and ``ckpt`` spans whose paper
    layer ``l`` lies past their request's halt (``stopped_at``: request
    id to ``stopped_at_l``): the masked walk's work."""
    busy = Busy(ops)
    total = 0.0
    for s in spans:
        if s["name"] not in ("layer", "ckpt") or s["req"] not in stopped_at:
            continue
        if s["attrs"].get("l", 0) > stopped_at[s["req"]]:
            total += busy_of(busy, s, t0, t1)
    return total


def idle_by_phase(ops: Sequence[Tuple[str, float, float]], t0: float,
                  t1: float, phase_list: Sequence[Tuple[float, str]]
                  ) -> Dict[str, float]:
    """The window's idle seconds by the phase each gap began in (every
    gap, where ``trace.reduce_ops`` keeps the ten longest names)."""
    busy = Busy(ops)
    times = [t for t, _ in phase_list]
    out: Dict[str, float] = {}
    cur = t0
    for s, e in list(zip(busy.starts, busy.ends)) + [(t1, t1)]:
        s, e = max(s, t0), min(e, t1)
        if s > cur:
            k = bisect.bisect_right(times, cur) - 1
            name = phase_list[k][1] if k >= 0 else "before the window"
            out[name] = out.get(name, 0.0) + (s - cur)
        cur = max(cur, e)
    return out


def label(span: Dict) -> str:
    """A span's name in a phase list: ``name@l<l>`` where it has a layer,
    at most ``LABEL_CHARS`` characters."""
    l = span["attrs"].get("l")
    name = span["name"] if l is None else f"{span['name']}@l{l}"
    return name[:LABEL_CHARS]


def phases(harness: Sequence[Tuple[float, str]], spans: Sequence[Dict]
           ) -> List[Tuple[float, str]]:
    """The harness's phases merged with the spans' host edges, by time: at
    a span's start its label, at its end its parent's label, or the
    harness's phase then current where it has no parent."""
    by_id = {s["id"]: s for s in spans}
    # (time, order, name): at one time the harness's marks, then the ends
    # (inner spans, the later ids, first), then the starts (outer first)
    edges: List[Tuple[float, Tuple[int, int], Optional[str]]] = []
    for s in spans:
        edges.append((s["host_start"], (1, s["id"]), label(s)))
        if s["host_end"] is not None:
            parent = by_id.get(s["parent"])
            edges.append((s["host_end"], (0, -s["id"]),
                          None if parent is None else label(parent)))
    events = sorted([(t, (-1, 0), n) for t, n in harness] + edges,
                    key=lambda e: (e[0], e[1]))
    out: List[Tuple[float, str]] = []
    current = "before the window"
    for t, (kind, _), name in events:
        if kind == -1:
            current = name
            out.append((t, name))
        else:
            out.append((t, current if name is None else name))
    return out
