"""Streaming metrics: counters, gauges, and the P² quantile sketch (port of
``repro.obs.metrics``; pure Python, the port's own copy).

The load harness observes millions of synthetic request lifecycles; storing
every latency/queue-age sample to sort at the end would defeat the point of
a bounded-memory serving process.  ``P2Quantile`` implements the classic P²
algorithm (Jain & Chlamtac, CACM 1985): five markers track an estimate of
one quantile with O(1) state per observation, adjusted by a piecewise-
parabolic interpolation — the standard streaming-telemetry tradeoff (exact
below 5 samples, a close estimate beyond).  The update rule is pure
arithmetic on the observation sequence, so seeded runs produce identical
sketches — the determinism contract extends to the derived metrics.

``Summary`` bundles count/sum/min/max with p50/p90/p99 sketches (the shape
SLO targets are written against); ``MetricsRegistry`` is a flat named pool
the harness and report tooling share.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence


class Counter:
    """Monotonic event count."""

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> int:
        if n < 0:
            raise ValueError(f"Counter.inc is monotonic; got n={n!r}")
        self.value += n
        return self.value


class Gauge:
    """Last-written value, tracking the extremes it passed through."""

    def __init__(self):
        self.value: Optional[float] = None
        self.max: Optional[float] = None
        self.min: Optional[float] = None

    def set(self, v: float) -> None:
        v = float(v)
        self.value = v
        self.max = v if self.max is None else max(self.max, v)
        self.min = v if self.min is None else min(self.min, v)


class P2Quantile:
    """One streaming quantile estimate via the P² algorithm.

    State is five (height, position) markers; ``update`` is O(1) and
    allocation-free, ``value`` returns the current estimate (exact while
    fewer than five samples have arrived).
    """

    def __init__(self, q: float):
        if not (isinstance(q, float) or isinstance(q, int)) \
                or not 0.0 < float(q) < 1.0:
            raise ValueError(f"P2Quantile q must be in (0, 1), got {q!r}")
        self.q = float(q)
        self.count = 0
        self._init: List[float] = []      # first five observations
        self._heights: List[float] = []   # marker heights q0..q4
        self._pos: List[float] = []       # marker positions n0..n4 (1-based)
        self._want: List[float] = []      # desired positions
        q = self.q
        self._dwant = (0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0)

    def update(self, x: float) -> None:
        x = float(x)
        self.count += 1
        if len(self._init) < 5:
            self._init.append(x)
            if len(self._init) == 5:
                self._heights = sorted(self._init)
                self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
                q = self.q
                self._want = [1.0, 1.0 + 2.0 * q, 1.0 + 4.0 * q,
                              3.0 + 2.0 * q, 5.0]
            return
        hs, pos, want = self._heights, self._pos, self._want
        if x < hs[0]:
            hs[0] = x
            k = 0
        elif x >= hs[4]:
            hs[4] = x
            k = 3
        else:
            k = 3
            for i in range(4):
                if x < hs[i + 1]:
                    k = i
                    break
        for i in range(k + 1, 5):
            pos[i] += 1.0
        for i in range(5):
            want[i] += self._dwant[i]
        for i in range(1, 4):
            d = want[i] - pos[i]
            if (d >= 1.0 and pos[i + 1] - pos[i] > 1.0) or \
                    (d <= -1.0 and pos[i - 1] - pos[i] < -1.0):
                s = 1.0 if d >= 0 else -1.0
                hp = self._parabolic(i, s)
                if not hs[i - 1] < hp < hs[i + 1]:
                    hp = self._linear(i, s)
                hs[i] = hp
                pos[i] += s

    def _parabolic(self, i: int, s: float) -> float:
        hs, pos = self._heights, self._pos
        return hs[i] + s / (pos[i + 1] - pos[i - 1]) * (
            (pos[i] - pos[i - 1] + s) * (hs[i + 1] - hs[i])
            / (pos[i + 1] - pos[i])
            + (pos[i + 1] - pos[i] - s) * (hs[i] - hs[i - 1])
            / (pos[i] - pos[i - 1]))

    def _linear(self, i: int, s: float) -> float:
        hs, pos = self._heights, self._pos
        j = i + int(s)
        return hs[i] + s * (hs[j] - hs[i]) / (pos[j] - pos[i])

    @property
    def value(self) -> Optional[float]:
        """Current estimate (None before any sample; exact order statistic
        while the five-sample init buffer is still filling)."""
        if self.count == 0:
            return None
        if len(self._init) < 5:
            data = sorted(self._init)
            # nearest-rank on the tiny exact buffer
            idx = min(len(data) - 1, max(0, round(self.q * (len(data) - 1))))
            return data[int(idx)]
        return self._heights[2]


class Summary:
    """count/sum/min/max + a fixed set of P² quantile sketches."""

    DEFAULT_QS = (0.5, 0.9, 0.99)

    def __init__(self, quantiles: Sequence[float] = DEFAULT_QS):
        if not quantiles:
            raise ValueError("Summary needs at least one quantile")
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._sketches: Dict[float, P2Quantile] = {
            float(q): P2Quantile(q) for q in quantiles}

    def observe(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.total += x
        self.min = x if self.min is None else min(self.min, x)
        self.max = x if self.max is None else max(self.max, x)
        for sk in self._sketches.values():
            sk.update(x)

    def quantile(self, q: float) -> Optional[float]:
        q = float(q)
        if q not in self._sketches:
            raise ValueError(
                f"Summary holds sketches for "
                f"{sorted(self._sketches)}; no q={q!r} — declare it at "
                f"construction (streaming sketches cannot be added "
                f"after the fact)")
        return self._sketches[q].value

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None

    def to_dict(self) -> Dict[str, Optional[float]]:
        d: Dict[str, Optional[float]] = {
            "count": self.count, "mean": self.mean,
            "min": self.min, "max": self.max,
        }
        for q, sk in sorted(self._sketches.items()):
            d[f"p{int(q * 100)}"] = sk.value
        return d


class MetricsRegistry:
    """Flat named pool of counters/gauges/summaries with one ``to_dict``
    rollup — what the harness summarises and the SLO spec evaluates."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._summaries: Dict[str, Summary] = {}

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge())

    def summary(self, name: str,
                quantiles: Sequence[float] = Summary.DEFAULT_QS) -> Summary:
        if name not in self._summaries:
            self._summaries[name] = Summary(quantiles)
        return self._summaries[name]

    def to_dict(self) -> Dict[str, object]:
        return {
            "counters": {k: c.value
                         for k, c in sorted(self._counters.items())},
            "gauges": {k: {"value": g.value, "min": g.min, "max": g.max}
                       for k, g in sorted(self._gauges.items())},
            "summaries": {k: s.to_dict()
                          for k, s in sorted(self._summaries.items())},
        }
