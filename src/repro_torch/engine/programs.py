"""Process-level step cache — port of ``repro.engine.programs``, shared
across sessions.

The reference caches compiled XLA executables; the port caches the step
closures the engine builds (``build_fused_step``, the checkpoint runners,
the fake-quant entry step, the scanned whole-sweep program), under the
reference's keys:

  * every session namespaces its keys by a FAMILY tuple
    ``(adapter.name, n_layers, donate)`` — same-family sessions share
    entries, different families can never collide;
  * within a namespace the keys are the session's signature keys (layer
    kind + shape signatures + static config);
  * the cache counts ``compiles`` (a builder ran) and ``hits`` process-wide,
    and ``sessions`` attached, and emits ``program.compile`` /
    ``program.hit`` telemetry events with the reference's fields.

A session built without an explicit cache gets a private ``ProgramCache``;
sharing one between sessions is sound because a step closes over only the
adapter's pure apply-closures — all state (params, Fisher, forget batches)
enters as call operands.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Hashable, Tuple

from repro_torch.obs import telemetry as _t

Builder = Callable[[], Callable]


def _key_fields(key: Hashable) -> Dict[str, str]:
    """Human-legible telemetry fields for a fully-qualified program key:
    the namespace (family) tuple and the session key's leading kind tag
    ("fused", "sweep", "quant", ...)."""
    ns = fam = ""
    if isinstance(key, tuple) and key:
        ns = "/".join(map(str, key[0])) if isinstance(key[0], tuple) \
            else str(key[0])
        if len(key) > 1:
            sk = key[1]
            fam = str(sk[0]) if isinstance(sk, tuple) and sk else str(sk)
    return {"namespace": ns, "family": fam}


class ProgramCache:
    """Keyed store of built steps (and sweep plans) with process-wide
    build/hit accounting.

    Keys are fully-qualified tuples ``(namespace,) + session_key``; the
    session is responsible for the namespace (its adapter family).
    """

    def __init__(self):
        self._progs: Dict[Hashable, Callable] = {}
        self._plans: Dict[Hashable, Any] = {}
        self.compiles = 0   # a builder actually ran
        self.hits = 0       # an existing step was reused
        self.sessions = 0   # sessions attached

    # -- steps ----------------------------------------------------------------
    def get_or_build(self, key: Hashable, builder: Builder
                     ) -> Tuple[Callable, bool]:
        """Return ``(program, compiled)`` — ``compiled`` is True when the
        builder ran (a process-wide first for this key), False when any
        session already built it."""
        prog = self._progs.get(key)
        if prog is None:
            # a duration: the monotonic clock, which never steps
            t0 = time.perf_counter()
            prog = builder()
            self._progs[key] = prog
            self.compiles += 1
            _t.emit("program.compile", compiles=self.compiles,
                    wall_s=round(time.perf_counter() - t0, 3),
                    **_key_fields(key))
            return prog, True
        self.hits += 1
        _t.emit("program.hit", hits=self.hits, **_key_fields(key))
        return prog, False

    def evict_where(self, pred: Callable[[Hashable], bool]) -> int:
        """Drop every step whose key satisfies ``pred``; returns the number
        evicted."""
        dead = [k for k in self._progs if pred(k)]
        for k in dead:
            del self._progs[k]
        return len(dead)

    def keys(self):
        return self._progs.keys()

    def __len__(self) -> int:
        return len(self._progs)

    # -- sweep plans (pure structure, no build counters) ----------------------
    def plan_or_build(self, key: Hashable, builder: Callable[[], Any]) -> Any:
        """Sweep-plan memo (``plan_scanned_sweep`` results, including the
        ``None`` = not-scannable verdict): plans come from a forward pass on
        the ``meta`` device, so they carry no cost worth counting, but
        same-family sessions still skip re-deriving them."""
        if key not in self._plans:
            self._plans[key] = builder()
        return self._plans[key]

    # -- reporting ------------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        return {"programs": len(self._progs), "compiles": self.compiles,
                "hits": self.hits, "sessions": self.sessions}
