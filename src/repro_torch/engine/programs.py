"""Process-level step cache — port of ``repro.engine.programs``.

The reference caches compiled XLA executables; the port caches the step
closures the engine builds (``build_fused_step``, the partial-inference
runners), under the reference's keys:

  * every session namespaces its keys by a FAMILY tuple
    ``(adapter.name, n_layers, donate)`` — same-family sessions share
    entries, different families can never collide;
  * within a namespace the keys are the session's signature keys (layer
    kind + shape signatures + static config);
  * the cache counts ``compiles`` (a builder ran) and ``hits`` — the same
    counters the reference's zero-warm-recompile checks read.

(The reference's telemetry events and sweep-plan memo come with later
slices.)
"""
from __future__ import annotations

from typing import Callable, Dict, Hashable, Tuple

Builder = Callable[[], Callable]


class ProgramCache:
    """Keyed store of built steps with process-wide build/hit accounting.

    Keys are fully-qualified tuples ``(namespace,) + session_key``; the
    session is responsible for the namespace (its adapter family).
    """

    def __init__(self):
        self._progs: Dict[Hashable, Callable] = {}
        self.compiles = 0   # a builder actually ran
        self.hits = 0       # an existing step was reused

    def get_or_build(self, key: Hashable, builder: Builder
                     ) -> Tuple[Callable, bool]:
        """Return ``(program, compiled)`` — ``compiled`` is True when the
        builder ran (a process-wide first for this key)."""
        prog = self._progs.get(key)
        if prog is None:
            prog = builder()
            self._progs[key] = prog
            self.compiles += 1
            return prog, True
        self.hits += 1
        return prog, False
