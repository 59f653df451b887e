"""Serving launcher with in-place unlearning between batches (port of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --requests 8 --gen-len 8 --forget-domains "1,2;3,2" \
        --fisher-refresh 1 --check

Serving loop: batched requests -> chunked prefill (``repro_torch.models.lm.
prefill`` consumes the prompt in blocks against the decode caches) ->
greedy decode with the caches, the tokens kept on the device and copied to
the host once at the end.  Forget requests can arrive at ANY point; the
server enqueues them, drains between batches, applies FiCABU dampening in
place (no retraining, no weight reload — the paper's deployment story),
and continues serving with the edited weights.

Unlearning is driven through the ``repro_torch.api.Unlearner`` facade,
configured by one ``ServeSpec`` lowered to an ``UnlearnSpec``.  Forget
requests due at the same drain point are COALESCED into one back-end-first
engine sweep (``Unlearner.forget_group``); the facade keeps ONE warm engine
session across all drains, so every later drain reuses the cached steps.

``--forget-domains`` accepts burst syntax: ``1,2`` queues one request per
domain on consecutive batches (two drains); ``1,2;3,2`` queues bursts —
domains within a burst share a due batch and coalesce into one sweep.
``--coalesce`` folds a comma list into a single burst.  ``--sweep-mode
scanned`` (the default) serves every drain as ONE whole-sweep program
(``repro_torch.engine.sweep``).  ``--fisher-refresh N`` arms the streamed
global-Fisher refresh (``RefreshSpec(every_drains=N)``).  ``--check`` exits
non-zero unless every gate of the reference's holds: one sweep per drain
point, no build for a drain signature already seen, one scanned launch per
drain, the precision tag (and an int8 sweep launched), at least one
refresh, no refresh build after the first, and the staleness oracle.

``--serve-mode stream`` serves through ``StreamEngine``, the continuous-
batching engine: a fixed pool of decode slots, per-step admission and
eviction, drains on a worker thread against a SHADOW tree, and an atomic
publication at ``fire_step + --publish-lag`` engine steps (DESIGN.md §15).
With ``--check`` it fails unless every sequence was served, the decode step
saw one operand signature, every drain group published once, and nothing
was left queued, aborted or dead-lettered.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --serve-mode stream --requests 4 --prompt-len 8 --gen-len 4 \
        --forget-domains "1,2;3,2" --check

``--fleet fleet.json`` serves a MULTI-TENANT fleet (``repro_torch.fleet``,
DESIGN.md §13): each tenant has its own weights, data, forget queue and
Fisher; ONE ``DrainScheduler`` and ONE shared ``ProgramCache``. With
``--check`` a drain of an already-seen (family, signature) must build
nothing, and a same-family tenant replayed alone on a fresh cache must
build exactly what the fleet built for its family and end with the same
weights and Fisher, bit for bit (``fleet_check_problems``).

``--device`` picks the card (``cuda``, the default; it raises without one)
or ``cpu``. ``--cache-dir`` makes a directory the kernel build directory,
the port's persistent compilation cache (``api.enable_compilation_cache``):
the result JSON's ``compilation_cache`` block counts its finished
libraries before the start and the ones the run added, and ``--check``
fails a start against a warm cache that still built one
(``cache_problems``). As in the reference,
``--smoke`` is a ``store_true`` flag that defaults to True, so the command
line always serves the SMOKE config.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import warnings
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import configs
from repro_torch.api import (ServeSpec, UnlearnSpec, Unlearner,
                             compilation_cache_entries,
                             enable_compilation_cache)
from repro_torch.data.synthetic import LMDataConfig, make_lm_domains
from repro_torch.device import deterministic, resolve_device
from repro_torch.engine import ProgramCache
from repro_torch.fleet import Fleet, FleetSpec, TenantSpec
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.models.module import flatten_with_paths
from repro_torch.obs import telemetry as _t


def generate(params, cfg, prompts: torch.Tensor, gen_len: int,
             decode, prefill_block: int = 8) -> np.ndarray:
    """prompts [B, P] (on the parameters' device) -> greedy continuation
    [B, gen_len]. ``decode(params, cache, token, pos) -> (logits, cache)``
    is the decode step."""
    B, Plen = prompts.shape
    S_max = Plen + gen_len
    with torch.no_grad():
        cache = LM.init_cache(cfg, B, S_max, device=prompts.device)
        # chunked prefill: the prompt is consumed in blocks against the
        # decode caches
        logits, cache = LM.prefill(params, cfg, prompts, cache,
                                   block=prefill_block)
        # tokens accumulate ON DEVICE and cross to the host ONCE at the
        # end: a host read inside the loop would sync every decode step
        out = []
        tok = torch.argmax(logits[:, -1:], dim=-1)
        for j in range(gen_len):
            out.append(tok)
            logits, cache = decode(params, cache, tok, Plen + j)
            tok = torch.argmax(logits[:, -1:], dim=-1)
        return torch.cat(out, dim=1).cpu().numpy()


def default_serve_spec(chunk_size: int = 4,
                       cache_dir: Optional[str] = None,
                       refresh_every: int = 0,
                       sweep_mode: str = "scanned",
                       precision: str = "fp32") -> UnlearnSpec:
    """Deprecated alias: build a ``ServeSpec`` and lower it."""
    return ServeSpec(chunk_size=chunk_size, cache_dir=cache_dir,
                     refresh_every=refresh_every, sweep_mode=sweep_mode,
                     precision=precision).to_unlearn_spec()


def _serve_spec_from_unlearn(spec: UnlearnSpec) -> ServeSpec:
    """Best-effort lift of a legacy engine-facing ``UnlearnSpec`` back to
    the serving-facing ``ServeSpec`` (for the deprecation shim's audit
    trail)."""
    return ServeSpec(
        chunk_size=spec.exec.chunk_size,
        refresh_every=(spec.refresh.every_drains
                       if spec.refresh is not None else 0),
        sweep_mode=spec.exec.sweep_mode,
        precision=spec.exec.precision,
        cache_dir=spec.exec.cache_dir)


class ForgetService:
    """Queue of forget requests + the warm ``Unlearner`` facade — a thin
    single-tenant adapter over ``repro_torch.fleet.Fleet``, with the shadow
    / publish surface that ``StreamEngine`` drives.

    ``submit`` enqueues; ``drain`` coalesces every request due at the drain
    point into ONE engine sweep over the unioned forget sets and returns the
    edited weights.  The drain mechanics (coalescing, pad-never-trim CHUNK
    alignment, drain-width equalization, streamed Fisher refresh, audit
    logs) live in ``repro_torch.fleet.TenantRuntime``; this class routes
    the legacy single-tenant API through a one-tenant fleet.

    Configure with a frozen ``repro_torch.api.ServeSpec`` (``serve=``).  The
    old ``spec=UnlearnSpec`` signature (positional or keyword) still works
    but emits a ``DeprecationWarning``. The tenant lives on ``device``.
    """

    # deprecated: Fisher/engine chunk size now lives on ServeSpec.chunk_size
    CHUNK = 4

    def __init__(self, cfg, tokens, domains, seq_len: int,
                 serve: Optional[ServeSpec] = None, *,
                 spec: Optional[UnlearnSpec] = None, programs=None,
                 device="cuda"):
        if isinstance(serve, UnlearnSpec):
            # legacy 5th positional arg: ForgetService(..., unlearn_spec)
            warnings.warn(
                "passing an UnlearnSpec to ForgetService is deprecated; "
                "pass serve=ServeSpec(...) (repro_torch.api.ServeSpec) "
                "instead",
                DeprecationWarning, stacklevel=2)
            spec, serve = serve, None
        elif spec is not None:
            warnings.warn(
                "ForgetService(spec=UnlearnSpec) is deprecated; pass "
                "serve=ServeSpec(...) (repro_torch.api.ServeSpec) instead",
                DeprecationWarning, stacklevel=2)
        if serve is not None and not isinstance(serve, ServeSpec):
            raise ValueError(
                f"ForgetService serve= must be a repro_torch.api.ServeSpec, "
                f"got {type(serve).__name__}")
        if serve is None:
            serve = (_serve_spec_from_unlearn(spec) if spec is not None
                     else ServeSpec(chunk_size=self.CHUNK))
        self.serve_spec = serve
        unlearn_spec = spec if spec is not None else serve.to_unlearn_spec()
        self.cfg = cfg
        self.tokens = tokens
        self.domains = domains
        self._fleet = Fleet(programs=programs)
        self._rt = self._fleet.add_tenant(
            "default", cfg, tokens, domains, seq_len, spec=unlearn_spec,
            tag="serve", coalesce=serve.coalesce,
            max_forget_samples=serve.max_forget_samples, device=device)

    # -- the legacy surface, delegated to the tenant runtime ---------------
    @property
    def queue(self) -> Deque[Dict]:
        """Read-only view of the pending forget queue (legacy shape — one
        entry per REQUEST, so admission-deferred folds are expanded)."""
        return deque({"domain": e["payload"], "due_batch": e["due_batch"]}
                     for e in self._fleet.scheduler.pending_entries(
                         self._rt.name))

    @property
    def scheduler(self):
        """The fleet's drain scheduler (one tenant here)."""
        return self._fleet.scheduler

    @property
    def adapter(self):
        return self._rt.adapter

    @property
    def spec(self) -> UnlearnSpec:
        return self._rt.spec

    @property
    def unlearner(self) -> Optional[Unlearner]:
        return self._rt.unlearner

    @property
    def log(self) -> List[Dict]:
        return self._rt.log

    @property
    def group_log(self) -> List[Dict]:
        return self._rt.group_log

    @property
    def refresh_log(self) -> List[Dict]:
        return self._rt.refresh_log

    @property
    def sweeps(self) -> int:
        return self._rt.sweeps

    @property
    def groups(self) -> int:
        return self._rt.groups

    @property
    def stale_fisher(self):
        return self._rt.stale_fisher

    @property
    def retain_batches(self) -> List:
        return self._rt.retain_batches

    def submit(self, domain: int, due_batch: int) -> None:
        self._fleet.submit("default", domain, due_batch)

    def _warm(self, params) -> Unlearner:
        return self._rt._warm(params)

    def maybe_refresh(self, params, batch_idx: int) -> bool:
        """Streamed I_D refresh between drains (policy-scheduled)."""
        return self._rt.maybe_refresh(params, batch_idx)

    def staleness_report(self, params) -> Optional[Dict]:
        """The --check oracle: is the refreshed I_D closer than the stale
        one-shot snapshot to a from-scratch recompute at the CURRENT
        (edited) weights?"""
        return self._rt.staleness_report(params)

    def drain(self, params, batch_idx):
        """Coalesce all requests due at ``batch_idx`` into one sweep;
        returns (params, ran_any)."""
        self._rt.params = params
        entries = self._fleet.drain(batch_idx)
        return self._rt.params, any(e["ran"] for e in entries)

    # -- double-buffered stream-mode surface (DESIGN.md §15) ---------------
    @property
    def params(self):
        """The LIVE served tree (stream mode: the runtime's pointer IS the
        tree decode reads; it only moves via ``publish_staged``)."""
        return self._rt.params

    @property
    def params_version(self) -> int:
        return self._rt.params_version

    def install_params(self, params) -> None:
        """Install the live tree on the tenant runtime (stream mode)."""
        self._rt.params = params

    def run_shadow(self, payloads, batch_idx):
        """Drain body against the shadow tree — safe to call from the
        engine's worker thread; the live tree is untouched.  Returns
        ``(tree, ran)`` for the engine to stage/publish at its deadline."""
        return self._rt.run_due_shadow(list(payloads), batch_idx)

    def run_shadow_guarded(self, payloads, batch_idx):
        """``run_shadow`` + the guard violation captured on the SAME
        worker thread (reading ``last_violation`` at the publication
        deadline would race with a LATER sweep overwriting it on the
        serialized worker).  Returns ``(tree, ran, violation)``.
        Delegates through ``run_shadow`` so a stubbed shadow runner
        (tests, bench warmup) stays on the call path."""
        tree, ran = self.run_shadow(payloads, batch_idx)
        return tree, ran, self._rt.last_violation

    def abort_group(self, group, violation, step, tree=None) -> str:
        """Route a failed shadow sweep through the fleet's abort path
        (retry/backoff via the scheduler, then the dead-letter queue);
        the live tree keeps serving.  Returns the action taken."""
        return self._fleet._abort(group, self._rt, violation, step,
                                  "step", tree=tree)

    def book_skipped(self, payloads, batch) -> None:
        """Account a clean no-op drain (no forget samples for the due
        payloads): the requests are served, just with nothing to edit."""
        self._rt.book_applied(list(payloads), batch=batch)

    def stage(self, tree, *, payloads=None, batch=None) -> None:
        self._rt.stage(tree, payloads=payloads, batch=batch)

    def publish_staged(self, step=None) -> bool:
        """Atomic between-steps pointer swap of the staged tree."""
        return self._rt.publish_staged(step=step)

    def discard_shadow(self) -> None:
        """Drop unpublished shadow state (bench warmup hygiene)."""
        self._rt.discard_shadow()


# event kinds emitted on the ENGINE thread (deterministic order); sweep
# worker threads emit their own events at scheduler-dependent points
ENGINE_EVENT_KINDS = frozenset({"batch.admit", "batch.evict", "drain.fire",
                                "drain.abort", "params.publish"})


def engine_fingerprint(events) -> str:
    """Determinism fingerprint of the engine-side event stream.

    Keeps only ``ENGINE_EVENT_KINDS`` and drops the global ``seq``
    counter: seq numbers are allocated process-wide across threads, so a
    sweep worker finishing a slice earlier or later shifts the seq values
    on engine events even though the engine-side ORDER (what the
    fingerprint must pin) is fully deterministic.
    """
    evs = [{k: v for k, v in e.items() if k != "seq"}
           for e in events if e.get("kind") in ENGINE_EVENT_KINDS]
    return _t.fingerprint(evs)


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev`` without a host sync: on the card through
    pinned memory and an asynchronous copy (the host allocator keeps the
    pinned buffer until the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _signature(tree) -> Tuple:
    """The (path, shape, dtype, device) of every leaf of ``tree``: the key
    the decode step's operands are counted under (``decode_cache_size``)."""
    return tuple((path, tuple(t.shape), str(t.dtype), str(t.device))
                 for path, t in flatten_with_paths(tree))


class StreamEngine:
    """Continuous-batching decode engine with zero-downtime drains.

    A fixed pool of ``max_batch`` decode slots steps in lockstep through
    ONE decode step (per-row positions, see
    ``models.layers.attention_decode``).  Per engine step the loop:

      1. PUBLISHES any shadow-drain result whose step deadline arrived —
         an atomic pointer swap BETWEEN decode steps, so a step can never
         observe a half-edited tree;
      2. fires newly due drains: the scheduler group is popped on the
         ENGINE thread (deterministic order) and the sweep runs on a
         single worker thread against the tenant's SHADOW tree
         (``ForgetService.run_shadow``) — serving never waits for it on
         the host;
      3. admits pending sequences into free slots via a fixed-width
         chunked prefill (``models.lm.prefill``) scattered into the pool
         caches (``models.lm.scatter_cache_rows``);
      4. evicts finished sequences (host-side length bookkeeping — no
         device sync), keeping a device copy of their output row;
      5. launches the decode step WITHOUT syncing.

    Every engine-side transition emits a deterministic telemetry event
    (``batch.admit`` / ``batch.evict`` / ``drain.fire`` /
    ``params.publish``); worker-thread events interleave freely and are
    excluded from determinism fingerprints.  Publication happens at the
    deterministic deadline ``fire_step + publish_lag`` regardless of how
    fast the worker finishes, so two runs of the same scenario publish at
    identical steps with identical content (drain k+1 chains off drain
    k's output via the runtime's shadow chain).

    The decode and the admission run under ``torch.no_grad`` on the engine
    thread; the worker's sweep runs under ``torch.enable_grad`` (grad mode
    is per thread). Both threads launch onto the card's default stream, so
    a drain's kernels queue between decode steps. Idle slots keep
    advancing their position; their cache writes past ``S_max`` and their
    output writes past ``gen_len`` are dropped on the device, and the pad
    rows of an admission chunk scatter to row ``max_batch``, dropped the
    same way. The engine lives on ``device`` (``"cuda"`` raises without a
    card).
    """

    def __init__(self, params, cfg, *, gen_len: int, prompt_len: int,
                 max_batch: int = 8, admit_chunk: int = 4,
                 prefill_block: int = 8, publish_lag: int = 16,
                 service: Optional[ForgetService] = None, device="cuda"):
        if gen_len < 1 or prompt_len < 1:
            raise ValueError(f"StreamEngine needs gen_len/prompt_len >= 1, "
                             f"got {gen_len}/{prompt_len}")
        self.device = dev = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.G = int(gen_len)
        self.P = int(prompt_len)
        self.B = int(max_batch)
        self.admit_chunk = min(int(admit_chunk), self.B)
        self.prefill_block = prefill_block
        self.publish_lag = int(publish_lag)
        self.svc = service
        if service is not None:
            service.install_params(params)
        self.S_max = self.P + self.G
        B, G = self.B, self.G
        self.cache = LM.init_cache(cfg, B, self.S_max, device=dev)
        self.tok = torch.zeros((B, 1), dtype=torch.int64, device=dev)
        self.pos = torch.zeros((B,), dtype=torch.int64, device=dev)
        # gidx starts at G so an unoccupied slot's writes DROP out of the
        # output buffer instead of clobbering it
        self.gidx = torch.full((B,), G, dtype=torch.int64, device=dev)
        self.outbuf = torch.zeros((B, G), dtype=torch.int64, device=dev)
        # host-side slot bookkeeping — never syncs the device
        self.slot_seq: List[Optional[int]] = [None] * B
        self.slot_written = [0] * B
        self.pending: Deque = deque()
        self.results: Dict[int, torch.Tensor] = {}
        self.step = 0
        self.publications = 0
        self.aborts = 0
        self.step_wall: List[float] = []   # per-step loop wall seconds
        # [deadline_step, future, scheduler group] — the group rides along
        # so a failed sweep can be requeued/dead-lettered at the deadline
        self._pending_pubs: List[List] = []
        self._executor = None
        # the decode step's operand signatures, one entry each: a new
        # (shape, dtype, device) of any operand leaf is a new signature
        self._decode_sigs = ProgramCache()

    # -- the device programs -------------------------------------------------
    def _step_fn(self, params, cache, tok, pos, gidx, outbuf):
        step, _ = self._decode_sigs.get_or_build(
            (("decode", self.cfg.name),
             _signature({"params": params, "cache": cache, "tok": tok,
                         "pos": pos, "gidx": gidx, "outbuf": outbuf})),
            lambda: self._step)
        return step(params, cache, tok, pos, gidx, outbuf)

    def _step(self, params, cache, tok, pos, gidx, outbuf):
        logits, cache = LM.decode_step(params, self.cfg, tok, cache, pos)
        ntok = torch.argmax(logits[:, -1:], dim=-1)
        outbuf = L.put_per_row(outbuf, gidx, ntok[:, 0])
        return cache, ntok, pos + 1, gidx + 1, outbuf

    def _admit_fn(self, cache, sub_cache, tok, pos, gidx, outbuf, rows,
                  first):
        cache = LM.scatter_cache_rows(cache, sub_cache, rows)
        tok = LM.put_rows(tok, 0, rows, first)
        pos = LM.put_rows(pos, 0, rows, torch.full_like(rows, self.P))
        # token 0 is the prefill argmax, already written at index 0
        gidx = LM.put_rows(gidx, 0, rows, torch.ones_like(rows))
        row0 = torch.cat([first, first.new_zeros((len(rows), self.G - 1))],
                         dim=1)
        outbuf = LM.put_rows(outbuf, 0, rows, row0)
        return cache, tok, pos, gidx, outbuf

    # -- traffic -----------------------------------------------------------
    def enqueue(self, seq_id: int, prompt) -> None:
        """Queue one sequence (prompt [P] tokens) for admission."""
        prompt = np.asarray(prompt)
        if prompt.shape != (self.P,):
            raise ValueError(f"StreamEngine prompts are fixed-length "
                             f"[{self.P}], got shape {prompt.shape}")
        if seq_id in self.results or seq_id in [s for s in self.slot_seq
                                                if s is not None]:
            raise ValueError(f"duplicate seq_id {seq_id}")
        self.pending.append((int(seq_id), prompt))

    def _admit_due(self) -> None:
        free = [i for i in range(self.B) if self.slot_seq[i] is None]
        while self.pending and free:
            take = min(len(free), len(self.pending), self.admit_chunk)
            chunk = [self.pending.popleft() for _ in range(take)]
            rows, free = free[:take], free[take:]
            width = self.admit_chunk
            # fixed-width sub-batch: ONE prefill/admit signature. Padding
            # rows repeat the last prompt and scatter to row index B — out
            # of bounds, dropped by the scatters
            prompts = np.stack([p for _, p in chunk]
                               + [chunk[-1][1]] * (width - take))
            rows_d = _to_device(np.asarray(rows + [self.B] * (width - take),
                                           dtype=np.int64), self.device)
            sub_cache = LM.init_cache(self.cfg, width, self.S_max,
                                      device=self.device)
            logits, sub_cache = LM.prefill(
                self.params, self.cfg,
                _to_device(prompts.astype(np.int64), self.device),
                sub_cache, block=self.prefill_block)
            first = torch.argmax(logits[:, -1:], dim=-1)
            (self.cache, self.tok, self.pos, self.gidx, self.outbuf) = \
                self._admit_fn(self.cache, sub_cache, self.tok, self.pos,
                               self.gidx, self.outbuf, rows_d, first)
            for r, (sid, _) in zip(rows, chunk):
                self.slot_seq[r] = sid
                self.slot_written[r] = 1
            _t.emit("batch.admit", step=self.step, rows=rows,
                    seqs=[sid for sid, _ in chunk], width=width,
                    padded=width - take)

    def _evict_done(self) -> None:
        for r in range(self.B):
            if self.slot_seq[r] is not None \
                    and self.slot_written[r] >= self.G:
                sid = self.slot_seq[r]
                # a copy on the device: the row of outbuf is a view that
                # later steps replace (copied to the host once, in finish)
                self.results[sid] = self.outbuf[r].clone()
                _t.emit("batch.evict", step=self.step, row=r, seq=sid)
                self.slot_seq[r] = None
                self.slot_written[r] = 0

    # -- drains ------------------------------------------------------------
    def _shadow(self, payloads, step):
        with torch.enable_grad():
            return self.svc.run_shadow_guarded(payloads, step)

    def _fire_drains(self, step) -> None:
        svc = self.svc
        if svc is None:
            return
        nd = svc.scheduler.next_due()
        if nd is None or nd > step:
            return
        if self._executor is None:
            import concurrent.futures
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1)   # serializes sweeps: drain k+1 after k
        for g in svc.scheduler.due_groups(step):
            fut = self._executor.submit(self._shadow, list(g.payloads),
                                        step)
            self._pending_pubs.append([step + self.publish_lag, fut, g])
            _t.emit("drain.fire", step=step, n_requests=len(g.payloads),
                    payloads=list(g.payloads),
                    publish_at=step + self.publish_lag)

    def _publish_due(self, step) -> None:
        if not self._pending_pubs:
            return
        due = [p for p in self._pending_pubs if p[0] <= step]
        if not due:
            return
        self._pending_pubs = [p for p in self._pending_pubs if p[0] > step]
        svc = self.svc
        published = False
        for _, fut, g in due:
            # joining at the DEADLINE keeps the publication step (and the
            # published content, via the shadow chain) deterministic no
            # matter how thread timing interleaved the sweep itself
            tree = None
            violation = None
            try:
                tree, ran, violation = fut.result()
            except Exception as e:   # worker died: nothing staged, abort
                ran = False
                violation = {"guard": "exception", "detail": repr(e),
                             "applied_idx": [], "handled_idx": [],
                             "requeue_idx": list(range(len(g.payloads)))}
            if violation is not None:
                # the live tree keeps serving; the failed group goes back
                # through the scheduler (retry budget) or dead-letters
                self.aborts += 1
                svc.abort_group(g, violation, self.step, tree=tree)
                continue
            if ran:
                svc.stage(tree, payloads=list(g.payloads), batch=self.step)
                if svc.publish_staged(step=self.step):
                    self.publications += 1
                    published = True
            else:
                svc.book_skipped(list(g.payloads), batch=self.step)
        if published:
            self.params = svc.params

    # -- the loop ----------------------------------------------------------
    def step_once(self) -> None:
        t0 = _t.wall_time()
        self._publish_due(self.step)
        self._fire_drains(self.step)
        with torch.no_grad():
            self._admit_due()
            self._evict_done()
            if any(s is not None for s in self.slot_seq):
                (self.cache, self.tok, self.pos, self.gidx, self.outbuf) = \
                    self._step_fn(self.params, self.cache, self.tok,
                                  self.pos, self.gidx, self.outbuf)
                for r in range(self.B):
                    if self.slot_seq[r] is not None:
                        self.slot_written[r] += 1
                self._evict_done()
        self.step += 1
        self.step_wall.append(_t.wall_time() - t0)

    def run(self) -> Dict[int, np.ndarray]:
        """Serve until every enqueued sequence completed, then flush any
        drains still queued/unpublished and materialize the outputs."""
        while self.pending or any(s is not None for s in self.slot_seq):
            self.step_once()
        return self.finish()

    def finish(self) -> Dict[int, np.ndarray]:
        if self.svc is not None:
            # a forget request must never be silently dropped at shutdown —
            # and an abort at the publish deadline can REQUEUE work, so the
            # flush must alternate fire/publish until both the queue and
            # the in-flight publications are empty (termination: the retry
            # budget bounds requeues before the dead-letter queue takes
            # the group)
            while self.svc.scheduler.pending() or self._pending_pubs:
                while self.svc.scheduler.pending():
                    self._fire_drains(float("inf"))
                self._publish_due(float("inf"))
            if self._executor is not None:
                self._executor.shutdown(wait=True)
                self._executor = None
        if not self.results:
            return {}
        # one copy to the host for every sequence's output row
        sids = sorted(self.results)
        rows = torch.stack([self.results[s] for s in sids]).cpu().numpy()
        return {sid: rows[i] for i, sid in enumerate(sids)}

    def decode_cache_size(self) -> int:
        """Distinct operand signatures of the decode step — the
        zero-recompile-across-publications gate reads this: a publication
        that changed any leaf's shape, dtype or device counts as a new
        one."""
        return len(self._decode_sigs)


def _parse_bursts(args) -> List[List[int]]:
    """Burst k is due at ``--unlearn-after + k``; domains within a burst
    coalesce into one sweep."""
    if args.forget_domains:
        if ";" in args.forget_domains:
            return [[int(d) for d in b.split(",") if d]
                    for b in args.forget_domains.split(";") if b]
        doms = [int(d) for d in args.forget_domains.split(",")]
        return [doms] if args.coalesce else [[d] for d in doms]
    return [[args.forget_domain]]


def cache_info_since(cache_dir: Optional[str],
                     entries_before: int) -> Optional[Dict]:
    """The result JSON's ``compilation_cache`` block: the cache directory,
    its finished libraries at the start and the ones added since (None
    without a cache)."""
    if not cache_dir:
        return None
    return {"dir": cache_dir, "entries_before": entries_before,
            "entries_new": (compilation_cache_entries(cache_dir)
                            - entries_before)}


def cache_problems(cache_info: Optional[Dict]) -> List[str]:
    """The cold-start gate: a process start against a WARM cache must load
    every library it uses from disk — any new entry is a rebuild the
    persistence layer missed."""
    if cache_info and cache_info["entries_before"] > 0 \
            and cache_info["entries_new"] > 0:
        return [f"cold start with a warm compilation cache "
                f"({cache_info['entries_before']} entries) still compiled "
                f"{cache_info['entries_new']} new program(s)"]
    return []


def check_problems(svc: "ForgetService",
                   refresh_info: Optional[Dict],
                   cache_info: Optional[Dict] = None) -> List[str]:
    """The ``--check`` gates over a finished service (``refresh_info`` and
    ``cache_info`` as ``main`` builds them, None without refresh or cache):
    one message per failed gate, an empty list when every gate holds."""
    problems: List[str] = []
    # coalescing gate: ONE engine sweep per drain point, however many
    # requests were due there — a regression to per-request sweeps shows
    # up as several group entries (or sweeps) at the same drain batch
    sweeps_by_batch: Dict = {}
    for g in svc.group_log:
        sweeps_by_batch[g["batch"]] = (sweeps_by_batch.get(g["batch"], 0)
                                       + g["sweeps"])
    for b, n in sorted(sweeps_by_batch.items()):
        if n > 1:
            problems.append(f"drain at batch {b} ran {n} engine sweeps "
                            "— due requests were not coalesced into "
                            "one group")
    seen_sigs = set()
    for g in svc.group_log:
        sig = tuple(g.get("sweep_sig", ()))
        if sig in seen_sigs and g["engine"]["compiles"] > 0:
            problems.append(f"drain {g['group']} recompiled "
                            f"{g['engine']['compiles']} programs for an "
                            "already-seen drain signature "
                            "(warm-session cache regressed)")
        seen_sigs.add(sig)
    # scanned-mode dispatch-count gate: every coalesced drain must be
    # exactly ONE whole-sweep program launch — a fallback to the
    # layerwise loop (or a K x L dispatch regression) shows up as the
    # engine reporting a different sweep_mode / launch count
    if svc.spec.exec.sweep_mode == "scanned":
        for g in svc.group_log:
            eng = g["engine"]
            if eng.get("sweep_mode") != "scanned":
                problems.append(
                    f"drain {g['group']} fell back to the "
                    f"{eng.get('sweep_mode')!r} drive loop although the "
                    "deployment requested the scanned megaprogram")
            elif eng.get("sweep_launches") != 1:
                problems.append(
                    f"drain {g['group']} ran "
                    f"{eng.get('sweep_launches')} sweep-program "
                    "launches — a coalesced drain must be exactly one")
    # precision gate: every drain's engine must report the precision the
    # deployment requested — an int8 deployment that silently fell back
    # to the fp32 path reproduces the oracle numerics exactly, so only
    # this explicit tag catches it (DESIGN.md §12)
    want_prec = svc.spec.exec.precision
    for g in svc.group_log:
        got = g["engine"].get("precision")
        if got != want_prec:
            problems.append(
                f"drain {g['group']} ran the {got!r} path although the "
                f"deployment requested precision={want_prec!r} (silent "
                "fallback)")
    if (want_prec == "int8" and svc.spec.exec.sweep_mode == "scanned"
            and svc.unlearner.stats.get("int8_sweep_launches", 0) < 1):
        problems.append(
            "precision='int8' with the scanned megaprogram never "
            "launched an int8_sweep program (int8 family unused)")
    # streamed-refresh gates: the refresh ran between drains, every
    # refresh after the first replayed the cached program (zero
    # compiles), and the refreshed I_D beats the stale snapshot against
    # a from-scratch recompute at the final weights
    if refresh_info is not None:
        if refresh_info["refreshes"] == 0:
            problems.append(
                f"--fisher-refresh {svc.serve_spec.refresh_every} was set "
                "but no refresh ran between drains")
        for i, r in enumerate(svc.refresh_log[1:], start=1):
            if r["engine"]["refresh_compiles"] > 0:
                problems.append(
                    f"fisher refresh {i} recompiled "
                    f"{r['engine']['refresh_compiles']} refresh "
                    "program(s) (warm refresh family regressed)")
        stale = refresh_info["staleness"]
        if stale is not None and not stale["improved"]:
            problems.append(
                f"refreshed I_D is NOT closer to the from-scratch "
                f"recompute at the edited weights (stale rel err "
                f"{stale['stale_rel_err']:.4f}, refreshed "
                f"{stale['refreshed_rel_err']:.4f}) — the streamed "
                "refresh failed its staleness oracle")
    return problems + cache_problems(cache_info)


def _build_lm_tenant(tspec: TenantSpec, args) -> Dict:
    """Model + synthetic domain data for one tenant on ``args.device``,
    deterministic in the tenant's seed (the --check isolation replay
    rebuilds from this). As in the reference, the data's vocabulary is the
    model's."""
    arch = configs.get(tspec.arch)
    if arch.kind != "lm":
        raise ValueError(
            f"serve.py --fleet drives LM decode loops; tenant "
            f"{tspec.name!r} declares arch {tspec.arch!r}, a "
            f"{arch.kind!r} architecture — pick LM entries from "
            f"repro_torch.configs")
    dev = resolve_device(args.device)
    cfg = arch.smoke if args.smoke else arch.full
    params = LM.init_lm(torch.Generator(device=dev).manual_seed(tspec.seed),
                        cfg, device=dev)
    dcfg = LMDataConfig(vocab=cfg.vocab, n_domains=4,
                        seq_len=args.prompt_len + args.gen_len,
                        n_per_domain=16, seed=tspec.seed)
    tokens, domains = make_lm_domains(dcfg)
    return {"cfg": cfg, "tokens": tokens, "domains": domains,
            "seq_len": dcfg.seq_len, "params": params}


def _trees_bitwise_equal(a, b) -> bool:
    """Equal paths, and every leaf of equal dtype, shape and bits."""
    la, lb = dict(flatten_with_paths(a)), dict(flatten_with_paths(b))
    if list(la) != list(lb):
        return False
    for k, x in la.items():
        y = lb[k]
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if x.is_floating_point():
            # bit patterns: NaN == NaN, -0.0 != 0.0
            w = {8: torch.int64, 4: torch.int32, 2: torch.int16,
                 1: torch.int8}[x.element_size()]
            x, y = x.view(w), y.view(w)
        if not torch.equal(x, y.to(x.device)):
            return False
    return True


def _family_program_count(fleet: Fleet, adapter_name: str) -> int:
    """Built-step count attributable to one adapter family in the fleet's
    shared cache (every cached step built exactly once)."""
    return sum(n for ns, n in fleet.family_program_counts().items()
               if ns[0] == adapter_name)


def _solo_replay(fleet: Fleet, fspec: FleetSpec, name: str, build_tenant):
    """Replay ONE tenant's drains alone against a fresh program cache.

    Rebuilds the tenant's weights/data with ``build_tenant(tspec)``
    (deterministic in the seed) and re-runs exactly the drain groups the
    fleet ran for it, in order, on the tenant's device.  Generation is
    skipped — it never mutates params — so the solo endpoint must be
    bit-identical to the tenant's in-fleet state, and the fresh cache's
    build count for the family is the N=1 baseline the shared cache is
    gated against."""
    tspec = fspec.tenant(name)
    built = build_tenant(tspec)
    solo = Fleet(scheduling=fspec.scheduling,
                 max_groups_per_drain=fspec.max_groups_per_drain)
    rt = solo.add_tenant(tspec, built["cfg"], built["tokens"],
                         built["domains"], built["seq_len"],
                         params=built["params"],
                         spec=fspec.tenant_unlearn_spec(name),
                         coalesce=fspec.serve.coalesce,
                         max_forget_samples=fspec.serve.max_forget_samples,
                         device=fleet.tenants[name].device)
    for e in fleet.drain_log:
        if e["tenant"] == name:
            rt.params, _ = rt.run_due(rt.params, e["payloads"], e["batch"])
    return solo, rt


def _shared_family_tenant(fleet: Fleet, fspec: FleetSpec) -> Optional[str]:
    """A tenant that BENEFITED from cross-tenant sharing: drained at least
    once, and some other tenant has the same arch + identical effective
    UnlearnSpec (so their program families coincide exactly)."""
    by_family: Dict = {}
    for name, rt in fleet.tenants.items():
        key = (rt.arch, json.dumps(fspec.tenant_unlearn_spec(name)
                                   .to_dict(), sort_keys=True))
        by_family.setdefault(key, []).append(name)
    for names in by_family.values():
        drained = [n for n in names if fleet.tenants[n].groups > 0]
        if len(names) >= 2 and drained:
            return drained[-1]  # the latest-drained: warmed by its siblings
    return None


def run_fleet(fspec: FleetSpec, build_tenant, args, *,
              device="cuda") -> Tuple[Fleet, Dict]:
    """The ``--fleet`` serving loop: every tenant built by
    ``build_tenant(tspec)`` on ``device``; ``args`` carries the traffic
    flags of ``main`` (requests, prompt_len, gen_len, prefill_block,
    unlearn_after and the burst flags). Returns the fleet and the result
    dict."""
    dev = resolve_device(device)
    fleet = Fleet.from_spec(fspec, build_tenant, device=dev)

    # decode steps are shared per family too: one decode closure per arch
    decodes: Dict[str, object] = {}
    for rt in fleet.tenants.values():
        if rt.arch not in decodes:
            decodes[rt.arch] = (lambda p, c, t, pos, _cfg=rt.cfg:
                                LM.decode_step(p, _cfg, t, c, pos))

    # the burst schedule applies to EVERY tenant — simultaneous deadlines
    # are exactly the contention the scheduler policy has to arbitrate
    if args.unlearn_after >= 0:
        for i, burst in enumerate(_parse_bursts(args)):
            for name in fleet.tenants:
                for d in burst:
                    fleet.submit(name, d, due_batch=args.unlearn_after + i)

    served: Dict[str, List[dict]] = {name: [] for name in fleet.tenants}
    tenant_batches = {
        name: [rt.tokens[i:i + args.requests, :args.prompt_len]
               for i in range(0, len(rt.tokens) - args.requests,
                              args.requests)][:3]
        for name, rt in fleet.tenants.items()}
    n_batches = min(len(b) for b in tenant_batches.values())
    for bi in range(n_batches):
        for name, rt in fleet.tenants.items():
            t0 = time.time()
            gen = generate(rt.params, rt.cfg,
                           torch.as_tensor(tenant_batches[name][bi],
                                           device=dev).long(),
                           args.gen_len, decodes[rt.arch],
                           prefill_block=args.prefill_block)
            entry = {"batch": bi,
                     "latency_s": round(time.time() - t0, 3),
                     "tokens": int(gen.size)}
            served[name].append(entry)
            _t.emit("request.generate", tenant=name, **entry)
        fleet.drain(bi + 1)
    # flush requests still queued past the last served batch — a forget
    # request must never be silently dropped at shutdown (the per-drain
    # group budget may need several flush rounds)
    while fleet.scheduler.pending():
        fleet.drain(float("inf"))

    result = {
        "fleet": fspec.to_dict(),
        "served": served,
        "tenants": {
            name: {"unlearn_requests": rt.log, "group_log": rt.group_log,
                   "coalesced_groups": rt.groups, "sweeps": rt.sweeps,
                   "refresh_log": rt.refresh_log,
                   "engine_stats": (dict(rt.unlearner.stats)
                                    if rt.unlearner is not None else {})}
            for name, rt in fleet.tenants.items()},
        "drain_log": [{k: e.get(k) for k in ("tenant", "batch", "payloads",
                                             "ran", "aborted", "missed")}
                      for e in fleet.drain_log],
        "fleet_stats": fleet.stats(),
        "compilation_cache": None,
    }
    return fleet, result


def fleet_check_problems(fleet: Fleet, fspec: FleetSpec,
                         build_tenant) -> List[str]:
    """Every gate of the reference's ``--fleet --check`` over a finished
    fleet (the solo replay rebuilds its tenant with ``build_tenant``): one
    message per failed gate, an empty list when every gate holds."""
    problems: List[str] = []
    # guarded-drain gate: a fault-free fleet serve must never abort a
    # drain, dead-letter a request, or break the request accounting
    for name, rt in fleet.tenants.items():
        if rt.aborts:
            problems.append(
                f"tenant {name!r}: {rt.aborts} drain abort(s) "
                f"(last: {rt.abort_log[-1].get('guard')!r}) in a "
                "fault-free serve")
    if fleet.scheduler.dead():
        problems.append(
            f"{fleet.scheduler.dead()} forget request(s) dead-lettered "
            "in a fault-free serve")
    for name, acct in fleet.accounting().items():
        if not acct["ok"]:
            problems.append(
                f"tenant {name!r}: request accounting broken — "
                f"{acct['submitted']} submitted != {acct['applied']} "
                f"applied + {acct['pending']} pending + "
                f"{acct['staged']} staged + {acct['dead']} dead")
    # per-tenant coalescing gate: ONE engine sweep per drain point
    if fspec.serve.coalesce:
        for name, rt in fleet.tenants.items():
            sweeps_by_batch: Dict = {}
            for g in rt.group_log:
                sweeps_by_batch[g["batch"]] = \
                    sweeps_by_batch.get(g["batch"], 0) + g["sweeps"]
            for b, n in sorted(sweeps_by_batch.items()):
                if n > 1:
                    problems.append(
                        f"tenant {name!r}: drain at batch {b} ran {n} "
                        "engine sweeps — due requests were not "
                        "coalesced into one group")
    # cross-tenant rebuild gate: once ANY tenant has drained a (family,
    # precision, sweep-mode, signature), every later drain of it — on ANY
    # tenant — must reuse the shared cache, zero builds
    seen_sigs = set()
    for e in fleet.drain_log:
        g = e["group"]
        if g is None:
            continue
        rt = fleet.tenants[e["tenant"]]
        sig = (rt.adapter.name, rt.spec.exec.precision,
               rt.spec.exec.sweep_mode, tuple(g["sweep_sig"]))
        if sig in seen_sigs and g["engine"]["compiles"] > 0:
            problems.append(
                f"tenant {e['tenant']!r} drain {g['group']} recompiled "
                f"{g['engine']['compiles']} program(s) for an "
                "already-seen family signature (cross-tenant program "
                "sharing regressed)")
        seen_sigs.add(sig)
    # per-tenant scanned-dispatch and precision gates (same contracts as
    # the single-tenant path)
    for name, rt in fleet.tenants.items():
        want_prec = rt.spec.exec.precision
        for g in rt.group_log:
            eng = g["engine"]
            if rt.spec.exec.sweep_mode == "scanned":
                if eng.get("sweep_mode") != "scanned":
                    problems.append(
                        f"tenant {name!r} drain {g['group']} fell back "
                        f"to the {eng.get('sweep_mode')!r} drive loop "
                        "although the deployment requested the scanned "
                        "megaprogram")
                elif eng.get("sweep_launches") != 1:
                    problems.append(
                        f"tenant {name!r} drain {g['group']} ran "
                        f"{eng.get('sweep_launches')} sweep-program "
                        "launches — a coalesced drain must be exactly "
                        "one")
            if eng.get("precision") != want_prec:
                problems.append(
                    f"tenant {name!r} drain {g['group']} ran the "
                    f"{eng.get('precision')!r} path although the tenant "
                    f"requested precision={want_prec!r} (silent "
                    "fallback)")
    # tenant-isolation + build-once gate: replay a tenant that was warmed
    # by a same-family sibling ALONE on a fresh cache — it must end bit for
    # bit equal (no cross-tenant state bleed) and its fresh cache must
    # build exactly the steps the WHOLE fleet built for that family
    pick = _shared_family_tenant(fleet, fspec)
    if pick is None:
        problems.append(
            "--check on a fleet needs at least two same-family tenants "
            "with at least one drain (cross-tenant sharing and "
            "isolation are otherwise unobservable) — add a same-arch "
            "tenant to the fleet spec")
    else:
        solo, rt_solo = _solo_replay(fleet, fspec, pick, build_tenant)
        rt_fleet = fleet.tenants[pick]
        n_fleet = _family_program_count(fleet, rt_fleet.adapter.name)
        n_solo = _family_program_count(solo, rt_solo.adapter.name)
        if n_fleet != n_solo:
            problems.append(
                f"family {rt_fleet.adapter.name!r}: the fleet's shared "
                f"cache holds {n_fleet} compiled program(s) but a "
                f"single-tenant replay compiles {n_solo} — the "
                "same-family compile count is NOT independent of "
                "tenant count")
        if not _trees_bitwise_equal(rt_fleet.params, rt_solo.params):
            problems.append(
                f"tenant {pick!r}: params after interleaved fleet "
                "drains differ bitwise from a solo replay — tenant "
                "isolation broken")
        if rt_fleet.unlearner is not None \
                and rt_solo.unlearner is not None \
                and not _trees_bitwise_equal(
                    rt_fleet.unlearner.fisher_global,
                    rt_solo.unlearner.fisher_global):
            problems.append(
                f"tenant {pick!r}: global Fisher after interleaved "
                "fleet drains differs bitwise from a solo replay — "
                "tenant isolation broken")
    return problems


def _main_fleet(args) -> dict:
    fspec = FleetSpec.from_file(args.fleet)
    cache_dir = fspec.serve.cache_dir or args.cache_dir
    cache_entries0 = enable_compilation_cache(cache_dir) if cache_dir else 0
    fleet, result = run_fleet(fspec, lambda t: _build_lm_tenant(t, args),
                              args, device=args.device)
    result["compilation_cache"] = cache_info_since(cache_dir, cache_entries0)
    _t.log("serve", f"fleet done: {json.dumps(result)}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    if args.check:
        problems = fleet_check_problems(
            fleet, fspec, lambda t: _build_lm_tenant(t, args))
        # cold-start gate (process-global cache, same as single-tenant)
        problems += cache_problems(result["compilation_cache"])
        if problems:
            _t.log("serve", "FLEET CHECK FAILED: " + "; ".join(problems))
            raise SystemExit(1)
        pick = _shared_family_tenant(fleet, fspec)
        cache_stats = fleet.programs.stats()
        _t.log("serve",
               f"fleet check ok: {len(fleet.tenants)} tenant(s), "
               f"{sum(rt.groups for rt in fleet.tenants.values())} drain "
               f"group(s), {cache_stats['compiles']} program compiles / "
               f"{cache_stats['hits']} shared-cache hits across "
               f"{cache_stats['sessions']} engine session(s); tenant "
               f"{pick!r} solo replay bit-identical")
    return result


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an ascending list (0 when empty)."""
    if not sorted_vals:
        return 0.0
    i = min(int(round(q * (len(sorted_vals) - 1))), len(sorted_vals) - 1)
    return sorted_vals[i]


def stream_check_problems(eng: StreamEngine, svc: ForgetService,
                          n_seq: int, results: Dict,
                          unlearn: bool = True) -> List[str]:
    """The ``--serve-mode stream --check`` gates over a finished engine run
    (``unlearn``: forget bursts were submitted): one message per failed
    gate, an empty list when every gate holds."""
    problems: List[str] = []
    if len(results) != n_seq:
        problems.append(f"stream served {len(results)} of {n_seq} "
                        "enqueued sequences")
    if eng.decode_cache_size() != 1:
        problems.append(
            f"decode step compiled {eng.decode_cache_size()} "
            "signatures — publications must replay the ONE warm "
            "decode program")
    if unlearn and svc.groups != eng.publications:
        problems.append(
            f"{svc.groups} drain group(s) ran but {eng.publications} "
            "publication(s) happened — a shadow sweep's result was "
            "dropped or double-published")
    if svc.scheduler.pending():
        problems.append(f"{svc.scheduler.pending()} forget request(s) "
                        "still queued at shutdown")
    if eng.aborts:
        problems.append(
            f"{eng.aborts} shadow drain(s) aborted (guard violation "
            "or worker exception) — a fault-free serve must never "
            "trip the drain guard")
    if svc.scheduler.dead():
        problems.append(
            f"{svc.scheduler.dead()} forget request(s) dead-lettered "
            "— no request may terminally fail in a fault-free serve")
    return problems


def _main_stream(args, cfg, params, tokens, domains, seq_len: int,
                 dev) -> dict:
    """--serve-mode stream: the continuous-batching engine with shadow
    drains and step-deadline publication (DESIGN.md §15)."""
    serve = ServeSpec(cache_dir=args.cache_dir,
                      refresh_every=args.fisher_refresh,
                      sweep_mode=args.sweep_mode,
                      precision=args.precision,
                      publish="step",
                      max_batch=args.max_batch,
                      admit_chunk=args.admit_chunk,
                      publish_lag=args.publish_lag)
    svc = ForgetService(cfg, tokens, domains, seq_len, serve=serve,
                        device=dev)
    eng = StreamEngine(params, cfg, gen_len=args.gen_len,
                       prompt_len=args.prompt_len,
                       max_batch=serve.max_batch,
                       admit_chunk=serve.admit_chunk,
                       prefill_block=args.prefill_block,
                       publish_lag=serve.publish_lag,
                       service=svc, device=dev)
    # the burst schedule lives on the ENGINE-STEP clock in stream mode:
    # one legacy "batch" is roughly gen_len decode steps
    if args.unlearn_after >= 0:
        for i, burst in enumerate(_parse_bursts(args)):
            for d in burst:
                svc.submit(d, due_batch=(args.unlearn_after + i)
                           * args.gen_len)
    n_seq = 3 * args.requests   # the batch path's traffic volume
    prompts = np.asarray(tokens[:, :args.prompt_len])
    for i in range(n_seq):
        eng.enqueue(i, prompts[i % len(prompts)])
    t0 = time.time()
    results = eng.run()
    lat = sorted(eng.step_wall)
    result = {
        "serve_mode": "stream",
        "sequences": len(results),
        "tokens": int(sum(r.size for r in results.values())),
        "steps": eng.step,
        "elapsed_s": round(time.time() - t0, 3),
        "publications": eng.publications,
        "drain_aborts": eng.aborts,
        "dead_letters": svc.scheduler.dead(),
        "params_version": svc.params_version,
        "decode_step_p50_ms": round(_percentile(lat, 0.50) * 1e3, 4),
        "decode_step_p99_ms": round(_percentile(lat, 0.99) * 1e3, 4),
        "decode_compile_signatures": eng.decode_cache_size(),
        "unlearn_requests": svc.log,
        "group_log": svc.group_log,
        "coalesced_groups": svc.groups,
        "sweeps": svc.sweeps,
        "engine_stats": (dict(svc.unlearner.stats)
                         if svc.unlearner is not None else {}),
        "unlearn_spec": svc.spec.to_dict(),
        "serve_spec": serve.to_dict(),
    }
    _t.log("serve", f"stream done: {json.dumps(result)}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    if args.check:
        problems = stream_check_problems(eng, svc, n_seq, results,
                                         unlearn=args.unlearn_after >= 0)
        if problems:
            _t.log("serve", "STREAM CHECK FAILED: " + "; ".join(problems))
            raise SystemExit(1)
        _t.log("serve",
               f"stream check ok: {len(results)} sequence(s) in "
               f"{eng.step} step(s), {svc.groups} shadow drain group(s), "
               f"{eng.publications} atomic publication(s), one decode "
               "signature")
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=8)
    ap.add_argument("--prefill-block", type=int, default=8,
                    help="chunked-prefill block size (tokens per dispatch)")
    ap.add_argument("--serve-mode", choices=("batch", "stream"),
                    default="batch",
                    help="'batch': the fixed-batch generate loop with "
                         "in-place drains between batches; 'stream': the "
                         "continuous-batching engine — per-step "
                         "admission/eviction over a fixed slot pool, "
                         "drains on a shadow tree, atomic between-steps "
                         "publication (DESIGN.md §15)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="stream mode: decode slot-pool width "
                         "(ServeSpec.max_batch)")
    ap.add_argument("--admit-chunk", type=int, default=4,
                    help="stream mode: fixed admission sub-batch width "
                         "(ServeSpec.admit_chunk)")
    ap.add_argument("--publish-lag", type=int, default=16,
                    help="stream mode: steps between firing a shadow "
                         "drain and its atomic publication deadline "
                         "(ServeSpec.publish_lag)")
    ap.add_argument("--unlearn-after", type=int, default=1,
                    help="first forget burst after this many batches "
                         "(-1: off)")
    ap.add_argument("--forget-domain", type=int, default=1)
    ap.add_argument("--forget-domains", default=None,
                    help="domains to forget: '1,2' = one request per domain "
                         "on consecutive batches; '1,2;3' = bursts (comma "
                         "within a burst, ';' between) — a burst coalesces "
                         "into one sweep (overrides --forget-domain)")
    ap.add_argument("--coalesce", action="store_true",
                    help="fold a comma list into a single same-due burst")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero unless sweeps == coalesced groups "
                         "and no drain of a seen signature built a step "
                         "(and the scanned, precision and refresh gates)")
    ap.add_argument("--cache-dir", default=None,
                    help="persistent compilation cache directory: the "
                         "kernel build directory (a cold start against a "
                         "warm one must build nothing; --check gates it)")
    ap.add_argument("--fisher-refresh", type=int, default=0,
                    help="refresh the global Fisher I_D every N drains "
                         "(streamed EMA over retain microbatches at the "
                         "edited weights; 0 = keep the one-shot I_D)")
    ap.add_argument("--sweep-mode", choices=("layerwise", "scanned"),
                    default="scanned",
                    help="engine drive loop: 'scanned' runs each drain "
                         "as ONE whole-sweep program with on-device "
                         "halting (repro_torch.engine.sweep); 'layerwise' "
                         "is the host-driven oracle loop")
    ap.add_argument("--precision", choices=("fp32", "int8"), default="fp32",
                    help="numeric path for the unlearning engine: 'int8' "
                         "drains through the quantised program family "
                         "(int8 weight codes + per-channel scale tables, "
                         "dequant-free dampening, quantization-aware "
                         "halting); 'fp32' is the oracle default")
    ap.add_argument("--fleet", default=None,
                    help="serve a multi-tenant fleet from this FleetSpec "
                         "JSON file (repro_torch.fleet): per-tenant "
                         "weights, queues and Fisher, ONE drain scheduler, "
                         "ONE shared step cache; the burst/check flags "
                         "apply to every tenant")
    ap.add_argument("--device", default="cuda",
                    help="where the model, the decode loop and every drain "
                         "run: 'cuda' (the default; raises without a card) "
                         "or 'cpu'")
    ap.add_argument("--out", default=None,
                    help="write the result JSON to this path")
    args = ap.parse_args(argv)
    # --check holds runs bit for bit against each other (the fleet's solo
    # replay): on the card that needs deterministic algorithms
    with (deterministic(args.device) if args.check
          else contextlib.nullcontext()):
        return _main_fleet(args) if args.fleet else _main_one(args)


def _main_one(args) -> dict:
    """``main`` on one tenant: the batch loop, or ``--serve-mode
    stream``."""
    # the cache must be live BEFORE the first kernel loads for a cold start
    # to be replayable from disk
    cache_entries0 = (enable_compilation_cache(args.cache_dir)
                      if args.cache_dir else 0)
    dev = resolve_device(args.device)

    spec = configs.get(args.arch)
    if spec.kind != "lm":
        raise ValueError(
            f"serve.py drives an LM decode loop; --arch {args.arch!r} is a "
            f"{spec.kind!r} architecture — pick an LM entry from "
            f"repro_torch.configs")
    cfg = spec.smoke if args.smoke else spec.full
    params = LM.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                        device=dev)

    dcfg = LMDataConfig(vocab=cfg.vocab, n_domains=4,
                        seq_len=args.prompt_len + args.gen_len,
                        n_per_domain=16, seed=0)
    tokens, domains = make_lm_domains(dcfg)

    if args.serve_mode == "stream":
        return _main_stream(args, cfg, params, tokens, domains,
                            dcfg.seq_len, dev)

    def decode(p, c, t, pos):
        return LM.decode_step(p, cfg, t, c, pos)

    svc = ForgetService(cfg, tokens, domains, dcfg.seq_len,
                        serve=ServeSpec(
                            cache_dir=args.cache_dir,
                            refresh_every=args.fisher_refresh,
                            sweep_mode=args.sweep_mode,
                            precision=args.precision), device=dev)
    if args.unlearn_after >= 0:
        for i, burst in enumerate(_parse_bursts(args)):
            for d in burst:
                svc.submit(d, due_batch=args.unlearn_after + i)

    served: List[dict] = []
    batches = [tokens[i:i + args.requests, :args.prompt_len]
               for i in range(0, len(tokens) - args.requests,
                              args.requests)][:3]
    for bi, prompts in enumerate(batches):
        t0 = time.time()
        gen = generate(params, cfg,
                       torch.as_tensor(prompts, device=dev).long(),
                       args.gen_len, decode,
                       prefill_block=args.prefill_block)
        entry = {"batch": bi, "latency_s": round(time.time() - t0, 3),
                 "tokens": int(gen.size)}
        served.append(entry)
        _t.emit("request.generate", tenant="default", **entry)
        params, _ = svc.drain(params, bi + 1)
    # flush requests still queued past the last served batch — a forget
    # request must never be silently dropped at shutdown
    params, _ = svc.drain(params, float("inf"))

    done = [r for r in svc.log if "engine" in r]
    last = done[-1] if done else {}
    cache_info = cache_info_since(args.cache_dir, cache_entries0)
    refresh_info = None
    if args.fisher_refresh > 0:
        refresh_info = {"every_drains": args.fisher_refresh,
                        "refreshes": len(svc.refresh_log),
                        "log": svc.refresh_log,
                        "staleness": svc.staleness_report(params)}
    result = {"served": served, "unlearned": bool(done),
              "unlearn_requests": svc.log,
              "coalesced_groups": svc.groups, "sweeps": svc.sweeps,
              "group_log": svc.group_log,
              "unlearn_stats": {k: last.get(k) for k in
                                ("stopped_at_l", "macs_vs_ssd_pct")},
              "engine_stats": svc.unlearner.stats if svc.unlearner else {},
              "unlearn_spec": svc.spec.to_dict(),
              "serve_spec": svc.serve_spec.to_dict(),
              "compilation_cache": cache_info,
              "fisher_refresh": refresh_info}
    _t.log("serve", f"done: {json.dumps(result)}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    if args.check:
        problems = check_problems(svc, refresh_info, cache_info)
        if problems:
            _t.log("serve", "CHECK FAILED: " + "; ".join(problems))
            raise SystemExit(1)
        n_req = sum(g["requests"] for g in svc.group_log)
        extra = ""
        if refresh_info is not None:
            stale = refresh_info["staleness"] or {}
            extra = (f"; {refresh_info['refreshes']} fisher refresh(es), "
                     f"I_D rel err "
                     f"{stale.get('stale_rel_err', float('nan')):.4f}"
                     f" -> {stale.get('refreshed_rel_err', float('nan')):.4f}")
        mode = svc.spec.exec.sweep_mode
        _t.log("serve",
               f"check ok: {n_req} request(s) in {svc.groups} "
               f"group(s), one {mode} sweep per drain, zero recompiles "
               f"after the first drain{extra}")
    return result


if __name__ == "__main__":
    main()
