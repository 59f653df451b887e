"""LoadHarness — seeded synthetic traffic against a multi-tenant fleet
(port of ``repro.load.harness``).

The harness is the "million users" of the paper's deployment story scaled
to a virtual clock: per-tenant seeded arrival processes emit forget and
generate requests tick by tick, the fleet's admission-controlled scheduler
absorbs them, drains run through the real engine (or are skipped entirely
with ``serve_generate=False`` drains still run — generation is the only
optional part, since it never mutates weights), and every lifecycle
transition lands on the telemetry stream.

Determinism contract: the scenario seed derives every generator (arrival
counts AND domain choices, per tenant, decoupled by stable integer offsets
— never ``hash()``, which is salted per process), the clock is virtual, and
no wall time is read except through
``repro_torch.obs.telemetry.wall_time`` for
the latency fields the fingerprint strips.  Two runs of one scenario over
identically-built fleets produce identical event streams modulo
timestamps (``canonical_events`` / ``fingerprint``), which is the load
bench's double-run gate.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.api.specs import _require
from repro_torch.obs import telemetry as _tel
from repro_torch.obs.report import summarize
from repro_torch.obs.telemetry import Telemetry, VirtualClock, wall_time
from repro_torch.robust.faults import FaultInjector, FaultSpec

from .arrivals import ArrivalSpec

# stable per-tenant stream decoupling offsets (primes, not hash())
_FORGET_STRIDE = 7919
_DOMAIN_STRIDE = 104729


@dataclasses.dataclass(frozen=True)
class LoadScenario:
    """One synthetic-traffic experiment over the virtual clock.

    ``ticks``           virtual serving batches to drive.
    ``warmup_ticks``    compiles at ``t < warmup_ticks`` are warmup; the
                        steady-state compile SLO only counts later ones.
    ``deadline_slack``  a forget request arriving at tick t falls due at
                        ``t + deadline_slack`` (the context-adaptive
                        deadline of the serving loop).
    ``forget``          per-tenant forget-request arrival process (each
                        tenant gets its own decoupled generator derived
                        from this spec's seed + the scenario seed).
    ``generate``        generate-request arrival process (drives optional
                        real decode batches).
    ``domains``         forget domains are drawn uniformly from
                        ``[0, domains)`` per request.
    ``serve_generate``  actually run the LM decode loop for generate
                        arrivals (real latency telemetry, much slower);
                        False keeps the arrival/queue dynamics only.
    ``gen_batch_cap``/``prompt_len``/``gen_len``  decode batch shape when
                        ``serve_generate`` is on.
    ``seed``            scenario master seed.
    ``faults``          seeded fault-injection plan (``FaultSpec`` tuple):
                        a fresh ``FaultInjector`` is installed for every
                        ``run()`` (and restored after), so a chaos
                        scenario is exactly as repeatable as a clean one.
    """
    ticks: int = 32
    warmup_ticks: int = 4
    deadline_slack: int = 1
    forget: ArrivalSpec = ArrivalSpec(kind="poisson", rate=0.5)
    generate: ArrivalSpec = ArrivalSpec(kind="poisson", rate=2.0, seed=1)
    domains: int = 3
    serve_generate: bool = False
    gen_batch_cap: int = 4
    prompt_len: int = 8
    gen_len: int = 4
    seed: int = 0
    faults: Tuple[FaultSpec, ...] = ()

    def __post_init__(self):
        for name, lo in (("ticks", 1), ("warmup_ticks", 0),
                         ("deadline_slack", 0), ("domains", 1),
                         ("gen_batch_cap", 1), ("prompt_len", 1),
                         ("gen_len", 1), ("seed", 0)):
            v = getattr(self, name)
            _require(isinstance(v, int) and not isinstance(v, bool)
                     and v >= lo,
                     f"LoadScenario.{name} must be an int >= {lo}, "
                     f"got {v!r}")
        for name in ("forget", "generate"):
            v = getattr(self, name)
            if isinstance(v, dict):
                object.__setattr__(self, name, ArrivalSpec.from_dict(v))
            _require(isinstance(getattr(self, name), ArrivalSpec),
                     f"LoadScenario.{name} must be an ArrivalSpec (or a "
                     f"mapping of its fields), got {type(v).__name__}")
        _require(isinstance(self.serve_generate, bool),
                 f"LoadScenario.serve_generate must be a bool, "
                 f"got {self.serve_generate!r}")
        _require(isinstance(self.faults, (tuple, list)),
                 f"LoadScenario.faults must be a tuple of FaultSpec (or "
                 f"mappings), got {type(self.faults).__name__}")
        object.__setattr__(self, "faults", tuple(
            FaultSpec.from_dict(f) if isinstance(f, dict) else f
            for f in self.faults))
        for f in self.faults:
            _require(isinstance(f, FaultSpec),
                     f"LoadScenario.faults entries must be FaultSpec (or "
                     f"mappings), got {type(f).__name__}")

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["forget"] = self.forget.to_dict()
        d["generate"] = self.generate.to_dict()
        d["faults"] = [f.to_dict() for f in self.faults]
        return d

    @classmethod
    def from_dict(cls, d: Any) -> "LoadScenario":
        _require(isinstance(d, dict),
                 f"LoadScenario.from_dict expects a mapping, "
                 f"got {type(d).__name__}")
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        _require(not unknown,
                 f"unknown LoadScenario field(s) {sorted(unknown)}; "
                 f"expected a subset of {sorted(fields)}")
        return cls(**d)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "LoadScenario":
        try:
            d = json.loads(s)
        except json.JSONDecodeError as e:
            raise ValueError(
                f"LoadScenario.from_json: not valid JSON: {e}") from e
        return cls.from_dict(d)


def build_lm_tenant(tspec, *, prompt_len: int = 8, gen_len: int = 4,
                    smoke: bool = True, device="cuda") -> Dict:
    """Model + synthetic domain data for one tenant on ``device`` — the
    programmatic sibling of ``repro_torch.launch.serve._build_lm_tenant``
    (which reads an argparse namespace).  Deterministic in the tenant's
    seed (the weights from a ``torch.Generator`` on ``device``)."""
    import torch
    from repro_torch import configs
    from repro_torch.data.synthetic import LMDataConfig, make_lm_domains
    from repro_torch.device import resolve_device
    from repro_torch.models import lm as LM
    arch = configs.get(tspec.arch)
    if arch.kind != "lm":
        raise ValueError(
            f"build_lm_tenant drives LM tenants; {tspec.name!r} declares "
            f"arch {tspec.arch!r}, a {arch.kind!r} architecture")
    dev = resolve_device(device)
    cfg = arch.smoke if smoke else arch.full
    params = LM.init_lm(torch.Generator(device=dev).manual_seed(tspec.seed),
                        cfg, device=dev)
    dcfg = LMDataConfig(vocab=cfg.vocab, n_domains=4,
                        seq_len=prompt_len + gen_len,
                        n_per_domain=16, seed=tspec.seed)
    tokens, domains = make_lm_domains(dcfg)
    return {"cfg": cfg, "tokens": tokens, "domains": domains,
            "seq_len": dcfg.seq_len, "params": params}


class LoadHarness:
    """Drive one ``LoadScenario`` against a built
    ``repro_torch.fleet.Fleet``."""

    def __init__(self, fleet, scenario: LoadScenario):
        if not isinstance(scenario, LoadScenario):
            raise ValueError(f"LoadHarness needs a LoadScenario, "
                             f"got {type(scenario).__name__}")
        if not getattr(fleet, "tenants", None):
            raise ValueError("LoadHarness needs a Fleet with at least one "
                             "registered tenant")
        self.fleet = fleet
        self.scenario = scenario
        self.names: Tuple[str, ...] = tuple(fleet.tenants)
        sc = scenario
        # decoupled per-tenant streams: tenant i's arrival seed and domain
        # seed are stable functions of (scenario seed, arrival seed, i)
        self._forget = [
            dataclasses.replace(
                sc.forget,
                seed=sc.forget.seed + sc.seed * 31 + i * _FORGET_STRIDE
            ).build()
            for i in range(len(self.names))]
        self._gen = [
            dataclasses.replace(
                sc.generate,
                seed=sc.generate.seed + sc.seed * 31 + i * _FORGET_STRIDE
            ).build()
            for i in range(len(self.names))]
        self._domains = [
            np.random.Generator(np.random.PCG64(
                sc.seed * 31 + i * _DOMAIN_STRIDE + 17))
            for i in range(len(self.names))]
        self._decode_jits: Dict[str, Any] = {}

    # -- decode path (optional) ---------------------------------------------
    def _decode_jit(self, rt):
        """The decode step of ``rt``'s arch (one closure per arch, as the
        reference keeps one jitted program per arch)."""
        if rt.arch not in self._decode_jits:
            from repro_torch.models import lm as LM
            cfg = rt.cfg
            self._decode_jits[rt.arch] = (
                lambda p, c, t, pos, _cfg=cfg:
                LM.decode_step(p, _cfg, t, c, pos))
        return self._decode_jits[rt.arch]

    def _generate(self, name: str, rt, t: int, n: int) -> None:
        import torch
        from repro_torch.launch.serve import generate
        sc = self.scenario
        b = min(n, sc.gen_batch_cap)
        prompts = rt.tokens[:b, :sc.prompt_len]
        t0 = wall_time()
        gen = generate(rt.params, rt.cfg,
                       torch.as_tensor(prompts, device=rt.device).long(),
                       sc.gen_len, self._decode_jit(rt))
        _tel.emit("request.generate", tenant=name, batch=t,
                  requested=n, served=b, tokens=int(gen.size),
                  latency_s=round(wall_time() - t0, 3))

    # -- the drive loop ------------------------------------------------------
    def run(self, telemetry: Optional[Telemetry] = None) -> Dict[str, Any]:
        """Drive the scenario; returns the result dict (summary rollup,
        scheduler snapshot, determinism fingerprint, admission accounting).

        With ``telemetry=None`` a fresh in-memory ``Telemetry`` on a
        virtual clock is installed for the run; pass your own (e.g. with a
        JSONL path) to keep the stream.  The harness drives the telemetry
        clock to the tick index, so every event carries virtual time.
        """
        own = telemetry is None
        tel = telemetry if telemetry is not None \
            else Telemetry(clock=VirtualClock(), keep=True)
        prev = _tel.install(tel)
        sc = self.scenario
        from repro_torch.robust import faults as _faults
        prev_inj = _faults.install(
            FaultInjector(sc.faults) if sc.faults else None)
        admitted = rejected = 0
        try:
            for t in range(sc.ticks):
                tel.clock.advance_to(t)
                for i, name in enumerate(self.names):
                    rt = self.fleet.tenants[name]
                    n_gen = self._gen[i].counts(t)
                    if n_gen and sc.serve_generate:
                        self._generate(name, rt, t, n_gen)
                    elif n_gen:
                        _tel.emit("request.generate", tenant=name,
                                  batch=t, requested=n_gen, served=0,
                                  tokens=0)
                    for _ in range(self._forget[i].counts(t)):
                        dom = int(self._domains[i].integers(0, sc.domains))
                        ok = self.fleet.submit(
                            name, dom, due_batch=t + sc.deadline_slack,
                            now=t)
                        admitted += int(ok)
                        rejected += int(not ok)
                    _tel.emit("queue.depth", tenant=name,
                              depth=self.fleet.scheduler.queue_depth(name),
                              pending=self.fleet.scheduler.pending(name))
                self.fleet.drain(t)
            # shutdown flush on FINITE ticks: queue ages stay measurable
            # and no request is silently dropped (several rounds when the
            # per-drain group budget bites)
            t = sc.ticks - 1
            flush_limit = 10 * sc.ticks + 1000
            while self.fleet.scheduler.pending():
                t += 1
                if t > flush_limit:
                    raise RuntimeError(
                        f"shutdown flush made no progress by tick {t} "
                        f"({self.fleet.scheduler.pending()} requests still "
                        f"queued) — scheduler drain stuck")
                tel.clock.advance_to(t)
                self.fleet.drain(t)
            events = tel.events
            summary = summarize(events, warmup_t=sc.warmup_ticks)
            return {
                "scenario": sc.to_dict(),
                **summary,
                "scheduler": self.fleet.scheduler.snapshot(),
                "accounting": self.fleet.accounting()
                if hasattr(self.fleet, "accounting") else {},
                "admitted": admitted,
                "rejected_submits": rejected,
                "final_tick": t,
                "n_events": len(events),
                "event_counts": dict(tel.counts),
                "fingerprint": _tel.fingerprint(events),
            }
        finally:
            _faults.install(prev_inj)
            _tel.install(prev)
            if own:
                tel.close()
