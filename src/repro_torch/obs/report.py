"""Render a telemetry event stream into an SLO report (port of
``repro.obs.report``; pure Python, the port's own copy).

``summarize(events)`` folds a structured event list (or JSONL file, via the
CLI) into the one rollup dict the whole observability stack shares:
``repro_torch.load.SLOSpec.evaluate`` scores it and ``render()`` turns it
into the human-facing markdown report (per-tenant drain throughput,
queue-age percentiles, compile economics, SLO attainment).

The aggregation is streaming — queue ages and latencies go through the P²
sketches in ``repro_torch.obs.metrics``, never a stored sample list — so
the same code path summarizes a 40-event smoke run and a million-request
synthetic day.  All derived quantities except the ``*_s`` wall-latency summaries are
functions of the virtual clock and therefore deterministic under a seeded
harness run.

CLI:

    PYTHONPATH=src python -m repro_torch.obs.report events.jsonl \
        -o report.md [--slo slo.json] [--warmup-t N]
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

from .metrics import Summary
from .telemetry import read_jsonl

# queue transitions that mean "the request was admitted"
_ADMITTED = ("queue.enqueue", "queue.merge")


def _tenant_of(ev: Dict[str, Any]) -> Optional[str]:
    t = ev.get("tenant")
    return t if isinstance(t, str) else None


def summarize(events: Iterable[Dict[str, Any]],
              warmup_t: int = 0) -> Dict[str, Any]:
    """Fold an event stream into the fleet/tenant rollup.

    ``warmup_t`` splits the virtual timeline: ``program.compile`` events at
    ``t >= warmup_t`` count as STEADY-STATE compiles — the quantity the
    zero-warm-compile SLO pins to 0 (the first drains legitimately compile;
    a compile under steady load is a cache regression).
    """
    fleet_age = Summary()
    fleet_lat = Summary()
    tenants: Dict[str, Dict[str, Any]] = {}
    halt_depths: Dict[int, int] = {}
    compile_ns: Dict[str, int] = {}
    gen_tokens = 0
    gen_lat = Summary()
    n = {"events": 0, "submitted": 0, "rejected": 0, "merged": 0,
         "deferrals": 0, "drains": 0, "drained_requests": 0,
         "aborts": 0, "requeues": 0, "dead_letters": 0, "faults": 0,
         "compiles": 0, "steady_state_compiles": 0, "program_hits": 0,
         "sweeps": 0, "refreshes": 0, "generates": 0}
    depth_max = 0
    t_min: Optional[int] = None
    t_max: Optional[int] = None

    def tstats(name: str) -> Dict[str, Any]:
        if name not in tenants:
            tenants[name] = {"submitted": 0, "rejected": 0, "merged": 0,
                             "deferrals": 0, "drains": 0,
                             "drained_requests": 0, "depth_max": 0,
                             "aborts": 0, "requeues": 0, "dead_letters": 0,
                             "age": Summary()}
        return tenants[name]

    for ev in events:
        kind = ev.get("kind")
        if not isinstance(ev, dict) or not isinstance(kind, str):
            raise ValueError(f"telemetry events must be dicts with a "
                             f"string 'kind', got {ev!r}")
        n["events"] += 1
        t = ev.get("t")
        if isinstance(t, int):
            t_min = t if t_min is None else min(t_min, t)
            t_max = t if t_max is None else max(t_max, t)
        tn = _tenant_of(ev)

        if kind in _ADMITTED or kind == "queue.reject":
            ts = tstats(tn) if tn else None
            n["submitted"] += 1
            if ts:
                ts["submitted"] += 1
            if kind == "queue.reject":
                n["rejected"] += 1
                if ts:
                    ts["rejected"] += 1
            elif kind == "queue.merge":
                n["merged"] += 1
                if ts:
                    ts["merged"] += 1
            d = ev.get("depth")
            if isinstance(d, int):
                depth_max = max(depth_max, d)
                if ts:
                    ts["depth_max"] = max(ts["depth_max"], d)
        elif kind == "queue.defer":
            n["deferrals"] += 1
            if tn:
                tstats(tn)["deferrals"] += 1
        elif kind == "queue.depth":
            d = ev.get("depth")
            if isinstance(d, int):
                depth_max = max(depth_max, d)
                if tn:
                    ts = tstats(tn)
                    ts["depth_max"] = max(ts["depth_max"], d)
        elif kind == "drain.group":
            n["drains"] += 1
            reqs = ev.get("n_requests", 0)
            n["drained_requests"] += reqs
            ts = tstats(tn) if tn else None
            if ts:
                ts["drains"] += 1
                ts["drained_requests"] += reqs
            for age in ev.get("ages") or ():
                if age is not None:
                    fleet_age.observe(age)
                    if ts:
                        ts["age"].observe(age)
            lat = ev.get("latency_s")
            if isinstance(lat, (int, float)):
                fleet_lat.observe(lat)
        elif kind == "drain.abort":
            # the robustness rollup: guard-rejected (or crashed) drains —
            # the live tree kept serving, the group retried or dead-lettered
            n["aborts"] += 1
            if tn:
                tstats(tn)["aborts"] += 1
        elif kind == "queue.requeue":
            n["requeues"] += 1
            if tn:
                tstats(tn)["requeues"] += 1
        elif kind == "queue.dead_letter":
            cnt = ev.get("n", 0) or 0
            n["dead_letters"] += cnt
            if tn:
                tstats(tn)["dead_letters"] += cnt
        elif kind == "fault.inject":
            n["faults"] += 1
        elif kind == "program.compile":
            n["compiles"] += 1
            if isinstance(t, int) and t >= warmup_t:
                n["steady_state_compiles"] += 1
            ns = ev.get("namespace", "")
            compile_ns[ns] = compile_ns.get(ns, 0) + 1
        elif kind == "program.hit":
            n["program_hits"] += 1
        elif kind == "engine.sweep":
            n["sweeps"] += 1
            for sl in ev.get("stopped_at_l") or ():
                if isinstance(sl, int):
                    halt_depths[sl] = halt_depths.get(sl, 0) + 1
        elif kind == "fisher.refresh":
            n["refreshes"] += 1
        elif kind == "request.generate":
            n["generates"] += 1
            gen_tokens += ev.get("tokens", 0) or 0
            lat = ev.get("latency_s")
            if isinstance(lat, (int, float)):
                gen_lat.observe(lat)

    duration = (t_max - t_min + 1) if t_min is not None else 0
    fleet = {
        **{k: v for k, v in n.items()},
        "duration_t": duration,
        "queue_depth_max": depth_max,
        "queue_age": fleet_age.to_dict(),
        "drain_latency_s": fleet_lat.to_dict(),
        "drain_throughput": (n["drained_requests"] / duration
                             if duration else 0.0),
        "generate_latency_s": gen_lat.to_dict(),
        "generate_tokens": gen_tokens,
        "compile_namespaces": dict(sorted(compile_ns.items())),
        "halt_depths": {str(k): v
                        for k, v in sorted(halt_depths.items())},
        "warmup_t": warmup_t,
    }
    per_tenant = {}
    for name in sorted(tenants):
        ts = tenants[name]
        per_tenant[name] = {
            **{k: v for k, v in ts.items() if k != "age"},
            "queue_age": ts["age"].to_dict(),
            "drain_throughput": (ts["drained_requests"] / duration
                                 if duration else 0.0),
        }
    return {"fleet": fleet, "tenants": per_tenant}


def _fmt(v: Any) -> str:
    if v is None:
        return "—"
    if isinstance(v, bool):
        return "yes" if v else "no"
    if isinstance(v, float):
        return f"{v:.3f}"
    return str(v)


def render(summary: Dict[str, Any],
           evaluation: Optional[Dict[str, Any]] = None,
           title: str = "Unlearning fleet SLO report") -> str:
    """Markdown report from a ``summarize()`` rollup (plus an optional
    ``SLOSpec.evaluate`` result for the attainment section)."""
    fleet = summary.get("fleet", {})
    tenants = summary.get("tenants", {})
    out: List[str] = [f"# {title}", ""]

    if evaluation is not None:
        rows = evaluation.get("objectives", [])
        att = evaluation.get("attained", 1.0)
        ok = evaluation.get("ok", True)
        out += [f"## SLO attainment: {att * 100:.0f}% "
                f"({'PASS' if ok else 'FAIL'})", ""]
        if rows:
            out += ["| objective | target | actual | ok |",
                    "|---|---:|---:|:--:|"]
            out += [f"| {r['objective']} | {_fmt(r['target'])} | "
                    f"{_fmt(r['actual'])} | "
                    f"{'✅' if r['ok'] else '❌'} |" for r in rows]
            out.append("")

    out += ["## Fleet", "",
            "| metric | value |", "|---|---:|"]
    for key in ("events", "duration_t", "submitted", "rejected", "merged",
                "deferrals", "drains", "drained_requests",
                "aborts", "requeues", "dead_letters", "faults",
                "drain_throughput", "queue_depth_max", "sweeps",
                "refreshes", "generates", "generate_tokens"):
        out.append(f"| {key} | {_fmt(fleet.get(key))} |")
    out.append("")

    age = fleet.get("queue_age", {})
    lat = fleet.get("drain_latency_s", {})
    out += ["## Queue age and drain latency", "",
            "| series | count | mean | p50 | p90 | p99 | max |",
            "|---|---:|---:|---:|---:|---:|---:|"]
    for label, s in (("queue age (batches)", age),
                     ("drain latency (s, wall)", lat),
                     ("generate latency (s, wall)",
                      fleet.get("generate_latency_s", {}))):
        out.append(f"| {label} | {_fmt(s.get('count'))} | "
                   f"{_fmt(s.get('mean'))} | {_fmt(s.get('p50'))} | "
                   f"{_fmt(s.get('p90'))} | {_fmt(s.get('p99'))} | "
                   f"{_fmt(s.get('max'))} |")
    out.append("")

    out += ["## Per-tenant drains", "",
            "| tenant | submitted | rejected | merged | deferrals | drains "
            "| requests | req/tick | age p50 | age p99 | depth max |",
            "|---|---:|---:|---:|---:|---:|---:|---:|---:|---:|---:|"]
    for name, ts in tenants.items():
        a = ts.get("queue_age", {})
        out.append(
            f"| {name} | {_fmt(ts.get('submitted'))} | "
            f"{_fmt(ts.get('rejected'))} | {_fmt(ts.get('merged'))} | "
            f"{_fmt(ts.get('deferrals'))} | {_fmt(ts.get('drains'))} | "
            f"{_fmt(ts.get('drained_requests'))} | "
            f"{_fmt(ts.get('drain_throughput'))} | {_fmt(a.get('p50'))} | "
            f"{_fmt(a.get('p99'))} | {_fmt(ts.get('depth_max'))} |")
    out.append("")

    total = fleet.get("compiles", 0) + fleet.get("program_hits", 0)
    hit_rate = (fleet.get("program_hits", 0) / total) if total else None
    out += ["## Compile economics", "",
            "| metric | value |", "|---|---:|",
            f"| program compiles | {_fmt(fleet.get('compiles'))} |",
            f"| program cache hits | {_fmt(fleet.get('program_hits'))} |",
            f"| hit rate | {_fmt(hit_rate)} |",
            f"| steady-state compiles (t >= {fleet.get('warmup_t', 0)}) | "
            f"{_fmt(fleet.get('steady_state_compiles'))} |"]
    ns = fleet.get("compile_namespaces", {})
    for k in sorted(ns):
        out.append(f"| compiles[{k}] | {ns[k]} |")
    out.append("")

    hd = fleet.get("halt_depths", {})
    if hd:
        out += ["## Halt depths (context-adaptive early stopping)", "",
                "| stopped_at_l | sweeps |", "|---:|---:|"]
        out += [f"| {k} | {hd[k]} |" for k in sorted(hd, key=int)]
        out.append("")
    return "\n".join(out)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Render a telemetry JSONL stream into a markdown SLO "
                    "report")
    ap.add_argument("events", help="telemetry JSONL file (repro_torch.obs)")
    ap.add_argument("-o", "--out", default=None,
                    help="write markdown here (default: stdout)")
    ap.add_argument("--slo", default=None,
                    help="SLOSpec JSON file to evaluate against")
    ap.add_argument("--warmup-t", type=int, default=0,
                    help="virtual time before which compiles are warmup")
    args = ap.parse_args(argv)

    events = read_jsonl(args.events)
    summary = summarize(events, warmup_t=args.warmup_t)
    evaluation = None
    if args.slo:
        from repro_torch.load.slo import SLOSpec
        with open(args.slo) as f:
            evaluation = SLOSpec.from_json(f.read()).evaluate(summary)
    md = render(summary, evaluation)
    if args.out:
        with open(args.out, "w") as f:
            f.write(md + "\n")
    else:
        print(md)
    return 0 if (evaluation is None or evaluation["ok"]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
