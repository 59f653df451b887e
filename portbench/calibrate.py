"""Readings that set a cell's correctness limits and its halting tau, in
one process for many seeds (set-up is paid once per seed, the kernels
built once):

    python3 portbench/calibrate.py --workload <cell> --seconds 9 \
        --out chiprun_out/calib.jsonl --job sound@1,2,3 --job int8@4,5 \
        [--job round@6] [--job <fault>@7,8] [--tau <t>]

A job is a kind of run and the seeds it runs on: ``sound`` runs the cell
as ``run.py`` does, untraced; ``int8`` the control (the port's own int8
path in the program's place); ``round`` a sound run judged by the
reference rounded as the port rounds (the witness of the bf16 gap); a
name of ``lib/faults.py`` that planted fault. ``--tau`` overrides the
cell's tau (``-1`` never halts: the accuracy trace from which tau is
chosen). Each run appends one JSON line to ``--out``: every number the
check reads, each compared leaf's tally, each compared checkpoint's
accuracies on both sides with the halting's readings (``acc_gap``,
``halt_gap``: no cell compares them), the halts, the set-up and window
figures; and prints a short line. The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import run as R  # noqa: E402  (sets the caches' places)


def halt_gap(tau: float, got, ref) -> float:
    """How far the reference's forget accuracy lies on the other side of
    tau at a checkpoint the program hit (``got``: its trace of (l,
    accuracy); ``ref``: l -> the reference's accuracy). Where the program
    halted, the amount by which the reference's lies above tau; where it
    went past, the amount by which it lies at or below."""
    gap = 0.0
    for l, a in got:
        if l in ref:
            gap = max(gap, ref[l] - tau if a <= tau else tau - ref[l])
    return gap


def halting(tau: float, accs) -> dict:
    """``acc_gap`` (the largest gap of accuracies at a checkpoint both
    took) and ``halt_gap`` over the compared requests."""
    out = {"acc_gap": 0.0, "halt_gap": 0.0}
    for a in accs:
        ref = {int(l): float(v) for l, v in a["reference"]}
        got = [(int(l), float(v)) for l, v in a["program"]]
        for l, v in got:
            if l in ref:
                out["acc_gap"] = max(out["acc_gap"], abs(v - ref[l]))
        out["halt_gap"] = max(out["halt_gap"], halt_gap(tau, got, ref))
    return out


def one(cell, kind: str, seed: int, seconds: float) -> dict:
    import torch

    from portbench.lib.faults import FAULTS
    from portbench.loops import forget
    from portbench.reference import model as RM

    program = FAULTS.get(kind, forget.Program)
    RM.set_rounding(torch.bfloat16 if kind == "round" else None)
    try:
        out = forget.run(cell, seed=seed, seconds=seconds, trace=False,
                         device="cuda", t_start=time.perf_counter(),
                         precision="int8" if kind == "int8" else "fp32",
                         program=program, log=R.log)
    finally:
        RM.set_rounding(None)
    r = out["reading"]
    return {"workload": cell.name, "seed": seed, "kind": kind,
            "tau": cell.spec["tau"], "correct": out["correct"],
            "values": out["values"],
            "halting": halting(float(cell.spec["tau"]), out["accs"]),
            "setup_s": r.setup_s,
            "window_s": r.window_s, "requests": len(r.requests),
            "latency_s": [q["latency_s"] for q in r.requests],
            "halts": [q["stats"]["stopped_at_l"] for q in r.requests],
            "accs": out["accs"], "leaves": out["leaves"],
            "memory_peak_bytes": out["memory_peak_bytes"],
            "device": out["device_name"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--job", action="append", required=True,
                    help="KIND@SEED,SEED,...")
    ap.add_argument("--seconds", type=float, default=9.0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--tau", type=float, default=None)
    args = ap.parse_args(argv)
    import torch

    from portbench.lib import bench

    cell = bench.load_cell(ROOT, args.workload)
    if args.tau is not None:
        cell = dataclasses.replace(cell, spec=dict(cell.spec, tau=args.tau))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    bad = 0
    for job in args.job:
        kind, seeds = job.split("@")
        for seed in [int(s) for s in seeds.split(",")]:
            try:
                row = one(cell, kind, seed, args.seconds)
            except Exception:  # a crashed run is recorded, the rest go on
                bad += 1
                row = {"workload": cell.name, "seed": seed, "kind": kind,
                       "error": traceback.format_exc()[-2000:]}
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
            short = {k: row.get(k) for k in ("kind", "seed", "correct",
                                              "values", "halting", "halts",
                                              "setup_s")}
            print(json.dumps(short) if "error" not in row
                  else row["error"], flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
