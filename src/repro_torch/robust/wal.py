"""Durable per-tenant forget-request WAL (port of ``repro.robust.wal``: the
same JSON lines on disk, so either package reads the other's files).

A forget request may never be silently lost or half-applied: every
request the scheduler ACCEPTS is appended to the tenant's
``forget_wal.jsonl`` before it can be drained, and a drain that commits
(publishes or applies in place) marks its requests applied with the
resulting ``params_version``.  Recovery (``Fleet.recover``) restores the
latest complete checkpoint and replays exactly the entries the restored
version has not absorbed — no loss, no double-apply.

Record stream (JSONL, one op per line, folded by ``id``):

    {"id": 3, "op": "accept", "payload": 1, "due_batch": 4,
     "submitted": 2}
    {"id": 3, "op": "apply",  "params_version": 2, "batch": 4}
    {"id": 7, "op": "dead",   "reason": "retries_exhausted", "batch": 9}

Durability posture: the file is rewritten via a temp file in the same
directory, fsynced, then ``os.replace``d — a SIGKILL at any point leaves
either the previous complete WAL or the new complete WAL, never a torn
line.

The recovery rule for a request marked applied is version-aware: an
entry whose ``apply.params_version`` EXCEEDS the restored checkpoint's
version was committed by a drain the checkpoint never saw, so it
replays; an entry at or below the restored version is already inside the
restored weights and must not be applied twice.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.obs import telemetry as _t

WAL_NAME = "forget_wal.jsonl"
_OPS = ("accept", "apply", "dead")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


class ForgetWAL:
    """Append-only (logically) forget-request log for ONE tenant, stored
    at ``<root>/<tenant>/forget_wal.jsonl``.  Constructing over an
    existing file loads it — that is the crash-recovery read path."""

    def __init__(self, root: str, tenant: str):
        _require(isinstance(root, str) and root,
                 f"ForgetWAL root must be a non-empty path, got {root!r}")
        _require(isinstance(tenant, str) and tenant,
                 f"ForgetWAL tenant must be a non-empty name, "
                 f"got {tenant!r}")
        self.tenant = tenant
        self.dir = os.path.join(root, tenant)
        self.path = os.path.join(self.dir, WAL_NAME)
        os.makedirs(self.dir, exist_ok=True)
        self._ops: List[Dict[str, Any]] = []
        if os.path.exists(self.path):
            with open(self.path) as f:
                for ln, line in enumerate(f, 1):
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    _require(rec.get("op") in _OPS,
                             f"{self.path}:{ln}: unknown WAL op "
                             f"{rec.get('op')!r}")
                    self._ops.append(rec)
        self._next_id = 1 + max((r["id"] for r in self._ops), default=-1)

    # -- durability --------------------------------------------------------
    def _rewrite(self) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                for rec in self._ops:
                    f.write(json.dumps(rec) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    # -- writes ------------------------------------------------------------
    def append_accept(self, payload, due_batch: int,
                      submitted: Optional[int] = None) -> int:
        """Durably record one accepted request; returns its WAL id."""
        rid = self._next_id
        self._next_id += 1
        self._ops.append({"id": rid, "op": "accept", "payload": payload,
                          "due_batch": int(due_batch),
                          "submitted": submitted})
        self._rewrite()
        _t.emit("wal.accept", tenant=self.tenant, id=rid, payload=payload,
                due_batch=int(due_batch))
        return rid

    def mark_applied(self, ids: Sequence[int], *, params_version: int,
                     batch=None) -> None:
        """Mark ``ids`` absorbed into ``params_version`` (ONE durable
        rewrite for the whole drain group)."""
        ids = [int(i) for i in ids]
        if not ids:
            return
        accepted = {r["id"] for r in self._ops if r["op"] == "accept"}
        for rid in ids:
            _require(rid in accepted,
                     f"ForgetWAL.mark_applied: id {rid} was never "
                     f"accepted (tenant {self.tenant})")
            self._ops.append({"id": rid, "op": "apply",
                              "params_version": int(params_version),
                              "batch": batch})
        self._rewrite()
        _t.emit("wal.apply", tenant=self.tenant, ids=ids,
                params_version=int(params_version))

    def mark_dead(self, ids: Sequence[int], *, reason: str,
                  batch=None) -> None:
        """Terminal state for retries-exhausted requests: recovery must
        not resurrect what the guard permanently rejected."""
        ids = [int(i) for i in ids]
        if not ids:
            return
        for rid in ids:
            self._ops.append({"id": rid, "op": "dead",
                              "reason": str(reason), "batch": batch})
        self._rewrite()
        _t.emit("wal.dead", tenant=self.tenant, ids=ids, reason=reason)

    # -- reads -------------------------------------------------------------
    def records(self) -> List[Dict[str, Any]]:
        """Folded view: one dict per accepted id with its terminal state
        (``status`` in accepted/applied/dead), ordered by id."""
        by_id: Dict[int, Dict[str, Any]] = {}
        for rec in self._ops:
            if rec["op"] == "accept":
                by_id[rec["id"]] = dict(rec, status="accepted")
            elif rec["id"] in by_id:
                st = "applied" if rec["op"] == "apply" else "dead"
                by_id[rec["id"]].update(
                    {k: v for k, v in rec.items() if k != "op"},
                    status=st)
        return [by_id[i] for i in sorted(by_id)]

    def match_unapplied(self, payloads: Sequence[Any]) -> List[int]:
        """Map a drained group's payloads to WAL ids: for each payload in
        order, the EARLIEST still-open accept with that payload (each id
        matched at most once per call).  Submission order equals WAL
        order, so this is the deterministic inverse of the scheduler's
        FIFO-within-due draining."""
        open_recs = [r for r in self.records() if r["status"] == "accepted"]
        taken: set = set()
        out: List[int] = []
        for p in payloads:
            rid = next((r["id"] for r in open_recs
                        if r["payload"] == p and r["id"] not in taken),
                       None)
            _require(rid is not None,
                     f"ForgetWAL.match_unapplied: no open accept for "
                     f"payload {p!r} (tenant {self.tenant}) — every "
                     f"drained request must have been WAL-accepted")
            taken.add(rid)
            out.append(rid)
        return out

    def unapplied(self, up_to_version: Optional[int] = None
                  ) -> List[Dict[str, Any]]:
        """Entries recovery must replay: never applied, or applied into a
        ``params_version`` NEWER than ``up_to_version`` (committed after
        the checkpoint being restored).  Dead entries never replay.
        Ordered by (due_batch, id) — the replay schedule."""
        out = []
        for rec in self.records():
            if rec["status"] == "dead":
                continue
            if rec["status"] == "applied":
                if up_to_version is None \
                        or rec["params_version"] <= int(up_to_version):
                    continue
            out.append(rec)
        return sorted(out, key=lambda r: (r["due_batch"], r["id"]))

    def accounting(self) -> Dict[str, int]:
        recs = self.records()
        n = {"accepted": len(recs),
             "applied": sum(r["status"] == "applied" for r in recs),
             "dead": sum(r["status"] == "dead" for r in recs)}
        n["pending"] = n["accepted"] - n["applied"] - n["dead"]
        return n
