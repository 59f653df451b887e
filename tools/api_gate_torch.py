#!/usr/bin/env python
"""api-gate for the PyTorch/CUDA port: the ``repro_torch.api.Unlearner``
facade is the only way into the unlearning engine, and the serving entry
points stay behind their facades. The rules of ``tools/api_gate.py`` (its
rule functions and patterns, imported), held over ``src/repro_torch`` and
the port's examples (``examples/torch_*.py``) with allow-lists of the
port's files.

Fails (exit 1) if any scanned module outside the allowed facade/shim files

  * references the deprecated ``ficabu._mode_config`` (the mode mapping
    lives in ``UnlearnSpec.for_mode(...).to_config()``),
  * constructs ``UnlearnSession(...)`` directly (sessions belong to the
    facade, which owns the Fisher lifecycle and cross-request warmth),
  * constructs ``ForgetService(...)`` directly (single-tenant serving is a
    shim over ``repro_torch.fleet.Fleet``: multi-tenant code goes through
    the fleet, so that queues share ONE scheduler and ONE program cache),
  * reaches into ``DrainScheduler._queues`` outside
    ``fleet/scheduler.py`` (queue contents are read through the public
    ``pending_entries`` / ``pending`` / ``queue_depth`` accessors),
  * adds a bare ``assert`` statement under ``src/repro_torch`` (user-facing
    validation raises ``ValueError`` with an actionable message; asserts
    vanish under ``python -O``),
  * reads the wall clock inside ``src/repro_torch/load`` or
    ``src/repro_torch/fleet`` (``import time`` / ``from time import ...``
    / ``datetime.now`` etc.): those packages run on the virtual clock, on
    which the load harness's event fingerprint depends, and the one
    sanctioned wall-clock read is ``repro_torch.obs.telemetry.wall_time``
    (whose outputs land only in fields ``canonical_events`` strips), or
  * swallows a failure inside ``src/repro_torch/fleet`` or
    ``src/repro_torch/launch``: a bare ``except:`` clause, or an except
    handler whose whole body is ``pass``. Failures in the drain path
    surface as a ``drain.abort`` (guarded retry / dead-letter).

tests/ are exempt: they drive the engine layer itself by design.

    python tools/api_gate_torch.py [--root DIR]
"""
from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import api_gate as ref  # noqa: E402  (the reference gate's rules)

ROOT = Path(__file__).resolve().parent.parent
PORT = "src/repro_torch"
# (directory, glob) pairs scanned under the root
SCAN = ((PORT, "**/*.py"), ("examples", "torch_*.py"))
ALLOW = {
    f"{PORT}/api/facade.py",      # the facade owns the session
    f"{PORT}/api/specs.py",       # documents the _mode_config succession
    f"{PORT}/engine/session.py",  # the class definition itself
    f"{PORT}/core/ficabu.py",     # the deprecation shim being gated
}
# files allowed to construct ForgetService (the single-tenant shim): its
# own definition, and the fleet package it delegates to
ALLOW_FORGET_SERVICE = {f"{PORT}/launch/serve.py", f"{PORT}/fleet/fleet.py"}
ALLOW_QUEUES = {f"{PORT}/fleet/scheduler.py"}
# the assert-free discipline applies to the library tree only: examples
# are harnesses
ASSERT_SCAN = PORT
WALL_CLOCK_SCAN = (f"{PORT}/load/", f"{PORT}/fleet/")
SWALLOW_SCAN = (f"{PORT}/fleet/", f"{PORT}/launch/")


def problems_in(root: Path):
    """Every violation under ``root``, one message each (the reference's,
    naming the port's modules); and the number of files scanned."""
    problems, n = [], 0
    for rel, pattern in SCAN:
        for path in sorted((root / rel).glob(pattern)):
            n += 1
            rp = path.relative_to(root).as_posix()
            if rp.startswith(ASSERT_SCAN) and rp not in ALLOW:
                problems += ref._bare_asserts(path, rp)
            if rp.startswith(WALL_CLOCK_SCAN):
                problems += ref._wall_clock_reads(path, rp)
            if rp.startswith(SWALLOW_SCAN):
                problems += ref._swallowed_exceptions(path, rp)
            if rp in ALLOW:
                continue
            rules = ref.RULES
            if rp not in ALLOW_FORGET_SERVICE:
                rules += (ref.FORGET_SERVICE_RULE,)
            if rp not in ALLOW_QUEUES:
                rules += (ref.QUEUES_RULE,)
            for ln, line in enumerate(path.read_text().splitlines(), 1):
                code = line.split("#", 1)[0]
                problems += [f"{rp}:{ln}: {why}\n    {line.strip()}"
                             for rx, why in rules if rx.search(code)]
    # a file that does not parse is reported once, not once per rule
    return [re.sub(r"\brepro\.", "repro_torch.", p)
            for p in dict.fromkeys(problems)], n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="the repository to scan (default: this one)")
    root = Path(ap.parse_args(argv).root).resolve()
    problems, n = problems_in(root)
    if n == 0:
        print(f"[api-gate-torch] FAILED: no file to scan under {root}")
        return 1
    if problems:
        print(f"[api-gate-torch] FAILED: {len(problems)} engine-layer "
              "use(s) outside the facade/shim —")
        for p in problems:
            print("  " + p)
        return 1
    print(f"[api-gate-torch] ok: {n} files of {PORT} and examples/torch_*.py:"
          " no _mode_config use, direct UnlearnSession/ForgetService "
          "construction or _queues access outside the facade/shim, no bare "
          "assert in the library, no wall-clock read in load/ or fleet/, no "
          "swallowed exception in fleet/ or launch/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
