#!/usr/bin/env python
"""A benchmark cell's requests cut into the engine's phases, on the card.

    python3 tools/span_phase.py --workload yi6b_ficabu_scanned \
        --seed 2147483901 --seconds 45 [--spans 1] [--trace 1] \
        [--out chiprun_out/phase.json]

Runs one cell of ``BENCHMARK.json`` as ``portbench/run.py`` does (the same
loop, ``portbench/loops/forget.py``: set-up, the window, the check), with
the program's spans recorded (``--spans 1``: ``telemetry.capture(spans=True,
device="cuda")`` from the program's construction, before I_D and the
warm-up, with a ``labels`` span around each labelling forward) and with
the window's device trace (``--trace 1``). Prints one JSON line: the
end-to-end metrics and ``correct``; the set-up before the program
(imports, CUDA, weights, data); with spans the set-up's labels, I_D and
warm-up walls, host reads per request and each span's device time per
request (``dev_ms``, from its CUDA events); with the trace as well the
device's busy time per request inside each kind of span, the share of
the window's busy time five of them cover, the busy time past each
request's halt, the longest idle gaps named by the innermost span
(``host read@l2, after ...``) and all the idle time by span
(``portbench/lib/spans.py``, whose ``Tracer`` ties the trace's clock to
the host's more closely than the loop's own). ``--spans 0 --trace 0``
against ``--spans 1 --trace 0`` on one card is the cost of the spans.
``--device cpu --root DIR`` rehearses it on the host with a checkout whose
``BENCHMARK.json`` holds SMOKE cells (``portbench/tests/
support_portbench.make_smoke_root``): no trace and no device time there.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# the spans whose busy time should add up to the window's
PHASES = ("labels", "collect", "vjp", "dampen", "ckpt")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args(argv)
    cuda = args.device == "cuda"

    import torch

    from portbench import run as R  # the build caches inside the checkout
    from portbench.lib import bench
    from portbench.lib import spans as SP
    from portbench.lib import trace as TR
    from portbench.loops import forget as F
    from repro_torch.obs import telemetry as T

    if cuda and not torch.cuda.is_available():
        R.log("no CUDA card")
        return 2
    torch.set_num_threads(4)
    tracers, tel, reads = [], [], []
    res = {"workload": args.workload, "seed": args.seed,
           "spans": args.spans, "trace": args.trace}

    class KeptTracer(SP.Tracer):
        def __enter__(self):
            tracers.append(self)
            return super().__enter__()

    class Spanned(F.Program):
        def __init__(self, cell, device, precision="fp32"):
            # imports, CUDA, the weights and the data come before
            res["setup_before_program_s"] = time.perf_counter() - T_START
            if args.spans:
                tel.append(T.Telemetry(spans=True, device=device))
                T.install(tel[0])
            super().__init__(cell, device, precision)

        def labels(self, params, tokens):
            with T.span("labels"):
                return super().labels(params, tokens)

        def forget(self, params, tokens, labels, *, tau=None):
            new, st = super().forget(params, tokens, labels, tau=tau)
            reads.append(st.get("host_reads"))
            return new, st

    cell = bench.load_cell(Path(args.root), args.workload)
    F.Tracer = KeptTracer       # the loop looks it up when it runs
    try:
        out = F.run(cell, seed=args.seed, seconds=args.seconds,
                    trace=bool(args.trace) and cuda, device=args.device,
                    t_start=T_START, program=Spanned, log=R.log)
    finally:
        F.Tracer = TR.Tracer
        T.install(None)
    r = out["reading"]
    res.update(device=out["device_name"], correct=out["correct"],
               requests=len(r.requests))
    for m in ("forget_tokens_per_s", "forget_p95_s", "setup_s"):
        res[m] = bench.read_metric(m, r)
    if tel:
        tel[0].close()
        spans = tel[0].spans
        forgets = [s for s in spans if s["name"] == "forget"]
        # set-up runs one request, the warm-up; the window's follow
        res["setup_fisher_s"] = _wall(
            [s for s in spans if s["name"] == "fisher_global"][0])
        res["setup_warmup_s"] = _wall(forgets[0])
        res["setup_labels_s"] = sum(
            _wall(s) for s in spans if s["name"] == "labels"
            and s["host_end"] <= forgets[0]["host_start"])
        res["host_reads_per_req"] = reads[1:]
        win = forgets[1:1 + len(r.requests)]
        n = len(win)
        # the window's requests, and its labels spans: those after the
        # warm-up, each just before its request
        reqs = {s["req"] for s in win} | {
            s["req"] for s in spans if s["name"] == "labels"
            and s["host_start"] > forgets[0]["host_end"]}
        dev: dict = {}
        for s in spans:
            if s["req"] in reqs and "dev_ms" in s:
                dev[s["name"]] = dev.get(s["name"], 0.0) + s["dev_ms"]
        if dev:
            res["dev_ms_per_req"] = {k: v / n for k, v in dev.items()}
        if tracers:
            tr = tracers[0]
            t0 = next(t for t, p in tr.phases if p == "labels")
            t1 = [t for t, p in tr.phases if p == "between requests"][-1]
            ops = tr.device_ops()
            busy = SP.busy_by_name(ops, spans, t0, t1)
            red = TR.reduce_ops(ops, t0, t1, SP.phases(tr.phases, spans),
                                TR.load_classes())
            res["window_s"] = t1 - t0
            res["busy_ms_per_req"] = 1e3 * red["busy_s"] / n
            res["span_busy_ms_per_req"] = {k: 1e3 * v / n
                                           for k, v in busy.items()}
            res["covered_pct"] = 100.0 * sum(
                busy.get(k, 0.0) for k in PHASES) / red["busy_s"]
            stops = {s["req"]: q["stats"]["stopped_at_l"]
                     for s, q in zip(win, r.requests)}
            res["past_halt_ms_per_req"] = 1e3 * SP.past_halt(
                ops, spans, t0, t1, stops) / n
            res["halts"] = [q["stats"]["stopped_at_l"] for q in r.requests]
            res["idle_gaps"] = red["idle_gaps"]
            res["idle_ms_per_req_by_phase"] = {
                k: 1e3 * v / n for k, v in SP.idle_by_phase(
                    ops, t0, t1, SP.phases(tr.phases, spans)).items()}
            res["idle_pct"] = 100.0 * (1.0 - red["busy_s"] / (t1 - t0))
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0 if out["correct"] else 1


def _wall(span) -> float:
    return span["host_end"] - span["host_start"]


if __name__ == "__main__":
    sys.exit(main())
