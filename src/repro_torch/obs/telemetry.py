"""Process-wide structured event emitter — the telemetry stream (port of
``repro.obs.telemetry``; pure Python, the port's own copy).

Every layer of the serving stack reports through ONE emitter: the drain
scheduler (enqueue/reject/merge/defer), the fleet drain loop (per-drain
group sizes, halt depths, queue ages), the engine session (sweep launches),
the shared program cache (compile/hit economics), the streamed Fisher
refresh (staleness trigger inputs) and the request lifecycle in the serving
loop.  Events are flat JSON objects written as a JSONL time-series:

    {"seq": 17, "t": 3, "kind": "drain.group", "tenant": "acme", ...}

``t`` comes from a MONOTONIC VIRTUAL CLOCK (the serving batch index at
smoke scale), never the wall clock, so two seeded runs of the same scenario
produce identical event streams — the determinism contract the load bench
gates on.  Wall-clock durations are still useful (drain latency, generate
latency); they enter as fields named in ``NONDETERMINISTIC_KEYS`` and are
stripped by ``canonical_events`` before any determinism comparison
("identical modulo timestamps").

The module-level emitter is OPT-IN: with none installed, ``emit`` is a
no-op and ``log`` still prints its human-readable line bit-identically to
the historical ``print(f"[{tag}] ...", flush=True)`` calls it replaced —
existing log-parsing gates see the exact same stdout whether or not a
telemetry capture is active.

``wall_time()`` is the ONE sanctioned wall-clock read for the virtual-clock
packages (load and fleet, as in the reference), so every wall-clock datum
flows through here and lands in a nondeterministic-by-convention field
instead of leaking into the deterministic stream.

Spans (the port's own, not in the reference): ``span(name, **attrs)``
marks a phase of a request where the work happens. They are recorded only
inside ``capture(spans=True)``, kept apart from the event stream (which,
and whose fingerprint, they never change) in ``Telemetry.spans``, and
written at ``close()`` beside the JSONL sink as ``<path>.spans.jsonl``.
A record holds ``name``, ``id``, ``parent`` (the innermost open span on
its thread), ``req`` (the enclosing span's request id; a span opened
outside any span starts a new request), ``host_start`` / ``host_end`` in
``time.perf_counter`` seconds and ``attrs``. With ``device=`` a CUDA
device, each span also records a CUDA event on the current stream at
entry and exit; ``close()`` synchronises once and resolves them onto the
host clock through one anchor taken at entry (``SpanLog._tie_clocks``):
``dev_start`` / ``dev_end`` (seconds) and ``dev_ms``, the span's time on
the device. A CPU capture writes no device field. Without such a capture
``span`` returns one shared no-op object.
"""
from __future__ import annotations

import contextlib
import hashlib
import itertools
import json
import threading
import time as _time
from typing import Any, Dict, Iterable, List, Optional

# field names carrying wall-clock-derived values; stripped (recursively) by
# canonical_events before determinism fingerprints
NONDETERMINISTIC_KEYS = frozenset({"latency_s", "wall_s", "elapsed_s"})


def wall_time() -> float:
    """Wall-clock seconds — the sanctioned read for load/fleet code (see
    module docstring); results belong in ``NONDETERMINISTIC_KEYS`` fields."""
    return _time.time()


class VirtualClock:
    """Monotonic integer clock the emitter timestamps events with.

    The serving harness advances it once per batch tick; ``now()`` never
    reads the wall clock, so timestamps are reproducible across runs."""

    def __init__(self, start: int = 0):
        if not isinstance(start, int) or isinstance(start, bool):
            raise ValueError(f"VirtualClock start must be an int, "
                             f"got {start!r}")
        self._t = start

    def now(self) -> int:
        return self._t

    def advance_to(self, t: int) -> int:
        """Move the clock forward to ``t`` (monotonic: moving backwards is
        a caller bug and raises)."""
        if not isinstance(t, int) or isinstance(t, bool):
            raise ValueError(f"VirtualClock.advance_to needs an int tick, "
                             f"got {t!r}")
        if t < self._t:
            raise ValueError(f"VirtualClock is monotonic: cannot move from "
                             f"t={self._t} back to t={t}")
        self._t = t
        return self._t

    def advance(self, dt: int = 1) -> int:
        if not isinstance(dt, int) or isinstance(dt, bool) or dt < 0:
            raise ValueError(f"VirtualClock.advance needs an int dt >= 0, "
                             f"got {dt!r}")
        self._t += dt
        return self._t


def _jsonable(v: Any) -> Any:
    """Coerce event field values to plain JSON types (numpy scalars/arrays
    and tuples are common at the call sites; a non-serializable payload
    falls back to repr instead of killing the serving loop)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    item = getattr(v, "item", None)
    if callable(item) and getattr(v, "shape", None) == ():
        return _jsonable(item())
    tolist = getattr(v, "tolist", None)
    if callable(tolist):
        return _jsonable(tolist())
    return repr(v)


class _NoSpan:
    """What ``span`` returns where spans are not recorded: nothing."""
    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


class SpanLog:
    """The spans of one capture, in order of entry (see the module
    docstring). ``device`` a CUDA device adds the device's times."""

    def __init__(self, device=None):
        self.records: List[Dict[str, Any]] = []
        self._ids = itertools.count()
        self._reqs = itertools.count()
        self._local = threading.local()
        # (record, entry event, exit event) until close() resolves them
        self._events: List[Any] = []
        self._cuda = None
        if device is not None:
            import torch
            if torch.device(device).type == "cuda":
                self._cuda = torch.cuda
                self._anchor, self._anchor_host = self._tie_clocks()

    # events recorded to tie the device's clock to the host's
    TIES = 20

    def _tie_clocks(self):
        """(an event, its time on the host's clock). An event recorded on
        an idle device is stamped no earlier than the host's clock read
        just before its record: the latest of those reads, each less the
        event's time after the first, is the first event's host time,
        early by the device's shortest delay."""
        cuda = self._cuda
        first = cuda.Event(enable_timing=True)
        cuda.synchronize()
        first.record()
        cuda.synchronize()
        host = -float("inf")
        for _ in range(self.TIES):
            ev = cuda.Event(enable_timing=True)
            t = _time.perf_counter()
            ev.record()
            cuda.synchronize()
            host = max(host, t - first.elapsed_time(ev) / 1e3)
        return first, host

    @contextlib.contextmanager
    def span(self, name: str, attrs: Dict[str, Any]):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        parent = stack[-1] if stack else None
        rec = {"name": name, "id": next(self._ids),
               "parent": None if parent is None else parent["id"],
               "req": next(self._reqs) if parent is None else parent["req"],
               "host_start": _time.perf_counter(), "host_end": None,
               "attrs": attrs}
        self.records.append(rec)
        ev = None
        if self._cuda is not None:
            ev = self._cuda.Event(enable_timing=True)
            ev.record()
        stack.append(rec)
        try:
            yield rec
        finally:
            stack.pop()
            if ev is not None:
                end = self._cuda.Event(enable_timing=True)
                end.record()
                self._events.append((rec, ev, end))
            rec["host_end"] = _time.perf_counter()

    def resolve(self) -> None:
        """Give every closed span its device times (one synchronise)."""
        if self._cuda is None or not self._events:
            return
        self._cuda.synchronize()
        a, h = self._anchor, self._anchor_host
        for rec, ev, end in self._events:
            rec["dev_start"] = h + a.elapsed_time(ev) / 1e3
            rec["dev_end"] = h + a.elapsed_time(end) / 1e3
            rec["dev_ms"] = ev.elapsed_time(end)
        self._events = []


class Telemetry:
    """One structured event stream: in-memory list + optional JSONL sink.

    ``path``  write each event as one JSON line (append-through; the file
              is flushed per event so a crashed run still leaves a stream).
    ``clock`` the virtual clock stamping ``t`` (default: a fresh
              ``VirtualClock`` at 0).
    ``keep``  retain events in ``self.events`` (set False for very long
              runs that only want the JSONL file).
    ``spans`` record ``span``s in ``self.spans`` (written at ``close()`` to
              ``<path>.spans.jsonl``); ``device`` a CUDA device adds their
              device times.
    """

    def __init__(self, path: Optional[str] = None,
                 clock: Optional[VirtualClock] = None, keep: bool = True,
                 *, spans: bool = False, device=None):
        if path is not None and (not isinstance(path, str) or not path):
            raise ValueError(f"Telemetry path must be None or a non-empty "
                             f"string, got {path!r}")
        self.clock = clock if clock is not None else VirtualClock()
        self.path = path
        self.keep = bool(keep)
        self.degraded = False
        self.events: List[Dict[str, Any]] = []
        self.counts: Dict[str, int] = {}
        self._seq = 0
        # the serving engine runs shadow sweeps on a worker thread whose
        # drain-path events interleave with the engine's own — the seq
        # counter, counts, events list and JSONL sink all need one lock
        self._lock = threading.Lock()
        self.span_log = SpanLog(device) if spans else None
        self.spans: List[Dict[str, Any]] = (
            self.span_log.records if spans else [])
        self._fh = None
        if path:
            try:
                self._fh = open(path, "w")
            except OSError as e:
                self._degrade_locked(e)

    def _degrade_locked(self, exc: BaseException) -> None:
        """JSONL sink failure (disk full, unwritable path, closed fd):
        observability must never take down the serving process.  One
        stderr warning, the sink is dropped, events are retained in
        memory from here on (even with ``keep=False``), and a synthetic
        ``telemetry.degraded`` event marks the spot in the stream.
        Caller must hold ``self._lock`` (or be in ``__init__``)."""
        if self.degraded:
            return
        self.degraded = True
        import sys
        print(f"[telemetry] WARNING: JSONL sink {self.path!r} degraded "
              f"({exc!r}); events kept in memory only", file=sys.stderr,
              flush=True)
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
        self.keep = True  # the in-memory stream is now the only record
        event = {"seq": self._seq, "t": self.clock.now(),
                 "kind": "telemetry.degraded", "path": self.path,
                 "error": repr(exc)}
        self._seq += 1
        self.counts["telemetry.degraded"] = \
            self.counts.get("telemetry.degraded", 0) + 1
        self.events.append(event)

    def emit(self, kind: str, **fields: Any) -> Dict[str, Any]:
        if not isinstance(kind, str) or not kind:
            raise ValueError(f"telemetry event kind must be a non-empty "
                             f"string, got {kind!r}")
        jfields = {k: _jsonable(v) for k, v in fields.items()}
        with self._lock:
            event: Dict[str, Any] = {"seq": self._seq, "t": self.clock.now(),
                                     "kind": kind}
            event.update(jfields)
            self._seq += 1
            self.counts[kind] = self.counts.get(kind, 0) + 1
            if self.keep:
                self.events.append(event)
            if self._fh is not None:
                try:
                    self._fh.write(json.dumps(event) + "\n")
                    self._fh.flush()
                except (OSError, ValueError) as e:
                    # ValueError: write on a closed file object
                    if not self.keep:
                        self.events.append(event)
                    self._degrade_locked(e)
        return event

    def log(self, tag: str, msg: str, **fields: Any) -> None:
        """Human-readable line + structured twin.  The printed form is
        bit-identical to the ``print(f"[{tag}] {msg}", flush=True)`` calls
        it replaced across serve.py/fleet.py."""
        print(f"[{tag}] {msg}", flush=True)
        self.emit("log", tag=tag, msg=msg, **fields)

    def close(self) -> None:
        if self.span_log is not None:
            self.span_log.resolve()
            if self.path:
                self._write_spans(self.path + ".spans.jsonl")
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError as e:
                with self._lock:
                    self._degrade_locked(e)
            self._fh = None

    def _write_spans(self, path: str) -> None:
        try:
            with open(path, "w") as f:
                for rec in self.spans:
                    f.write(json.dumps(_jsonable(rec)) + "\n")
        except OSError as e:
            import sys
            print(f"[telemetry] WARNING: spans not written to {path!r} "
                  f"({e!r}); they stay in memory", file=sys.stderr,
                  flush=True)

    def __enter__(self) -> "Telemetry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- the process-wide emitter -----------------------------------------------
_EMITTER: Optional[Telemetry] = None
# the installed emitter's span log (None: spans are not recorded)
_SPANS: Optional[SpanLog] = None


def install(t: Optional[Telemetry]) -> Optional[Telemetry]:
    """Install ``t`` as the process-wide emitter (None uninstalls);
    returns the previous emitter so callers can restore it."""
    global _EMITTER, _SPANS
    if t is not None and not isinstance(t, Telemetry):
        raise ValueError(f"telemetry.install needs a Telemetry or None, "
                         f"got {type(t).__name__}")
    prev, _EMITTER = _EMITTER, t
    _SPANS = None if t is None else t.span_log
    return prev


def emitter() -> Optional[Telemetry]:
    return _EMITTER


def emit(kind: str, **fields: Any) -> Optional[Dict[str, Any]]:
    """Emit through the installed emitter; a no-op (None) when telemetry
    is not captured — instrumented hot paths stay free when unobserved."""
    if _EMITTER is None:
        return None
    return _EMITTER.emit(kind, **fields)


def span(name: str, **attrs: Any):
    """A context manager marking one phase of a request: recorded inside
    ``capture(spans=True)``, else the shared no-op."""
    if _SPANS is None:
        return _NO_SPAN
    return _SPANS.span(name, attrs)


def log(tag: str, msg: str, **fields: Any) -> None:
    """The drop-in for the stack's ad-hoc ``print(f"[{tag}] ...")`` calls:
    ALWAYS prints the identical human-readable line; additionally records a
    structured ``log`` event when an emitter is installed."""
    if _EMITTER is not None:
        _EMITTER.log(tag, msg, **fields)
    else:
        print(f"[{tag}] {msg}", flush=True)


@contextlib.contextmanager
def capture(path: Optional[str] = None,
            clock: Optional[VirtualClock] = None, keep: bool = True,
            *, spans: bool = False, device=None):
    """Context manager installing a fresh ``Telemetry`` as the process-wide
    emitter for the block (restoring whatever was installed before);
    ``spans`` / ``device`` as ``Telemetry``'s."""
    t = Telemetry(path=path, clock=clock, keep=keep, spans=spans,
                  device=device)
    prev = install(t)
    try:
        yield t
    finally:
        install(prev)
        t.close()


# -- determinism tooling ------------------------------------------------------
def canonical_events(events: Iterable[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The determinism view of a stream: every wall-clock-derived field
    (``NONDETERMINISTIC_KEYS``, recursively) removed.  Two seeded runs of
    the same scenario must agree on this view exactly."""

    def scrub(v: Any) -> Any:
        if isinstance(v, dict):
            return {k: scrub(x) for k, x in v.items()
                    if k not in NONDETERMINISTIC_KEYS}
        if isinstance(v, list):
            return [scrub(x) for x in v]
        return v

    return [scrub(e) for e in events]


def fingerprint(events: Iterable[Dict[str, Any]]) -> str:
    """sha256 over the canonical (wall-clock-stripped) JSON stream — the
    value two runs of a seeded scenario are compared on."""
    h = hashlib.sha256()
    for e in canonical_events(events):
        h.update(json.dumps(e, sort_keys=True).encode())
        h.update(b"\n")
    return h.hexdigest()


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Load an event stream back from its JSONL sink."""
    events = []
    try:
        with open(path) as f:
            for ln, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except json.JSONDecodeError as e:
                    raise ValueError(f"{path}:{ln}: not valid JSONL: {e}") \
                        from e
    except OSError as e:
        raise ValueError(f"cannot read telemetry stream {path!r}: {e}") \
            from e
    return events
