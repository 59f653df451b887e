"""Serving launcher with in-place unlearning between batches (port of
``repro.launch.serve``, batch mode).

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

``--device`` picks the card (``cuda``, the default; it raises without one)
or ``cpu``.  Not ported yet: ``--serve-mode stream`` and ``--fleet``
(ROADMAP Queue 1 item 4b) and ``--cache-dir`` (item 5); each raises.  As in
the reference, ``--smoke`` is a ``store_true`` flag that defaults to True,
so the command line always serves the SMOKE config.
"""
from __future__ import annotations

import argparse
import json
import time
import warnings
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.api import ServeSpec, UnlearnSpec, Unlearner
from repro_torch.api.specs import _not_ported
from repro_torch.data.synthetic import LMDataConfig, make_lm_domains
from repro_torch.device import resolve_device
from repro_torch.fleet import Fleet
from repro_torch.models import lm as LM
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
    single-tenant adapter over ``repro_torch.fleet.Fleet`` (batch mode: the
    stream engine's shadow / publish surface comes with it, ROADMAP Queue
    1 item 4b).

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


def check_problems(svc: "ForgetService",
                   refresh_info: Optional[Dict]) -> List[str]:
    """The ``--check`` gates over a finished service (``refresh_info`` as
    ``main`` builds it, None without refresh): one message per failed gate,
    an empty list when every gate holds."""
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
    return problems


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
                         "continuous-batching engine (not ported yet: "
                         "ROADMAP Queue 1 item 4b)")
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
                    help="persistent compilation cache directory (not "
                         "ported yet: ROADMAP Queue 1 item 5)")
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
                         "JSON file (not ported yet: ROADMAP Queue 1 item "
                         "4b)")
    ap.add_argument("--device", default="cuda",
                    help="where the model, the decode loop and every drain "
                         "run: 'cuda' (the default; raises without a card) "
                         "or 'cpu'")
    ap.add_argument("--out", default=None,
                    help="write the result JSON to this path")
    args = ap.parse_args(argv)

    if args.fleet:
        raise _not_ported("--fleet (the multi-tenant serving launcher)",
                          "4b")
    if args.serve_mode == "stream":
        raise _not_ported("--serve-mode stream (the continuous-batching "
                          "StreamEngine)", "4b")
    if args.cache_dir:
        raise _not_ported("--cache-dir (the persistent compilation cache)",
                          "5")
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

    def decode(p, c, t, pos):
        return LM.decode_step(p, cfg, t, c, pos)

    svc = ForgetService(cfg, tokens, domains, dcfg.seq_len,
                        serve=ServeSpec(
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
    cache_info = None
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
        problems = check_problems(svc, refresh_info)
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
