"""Run one cell of ``BENCHMARK.json`` once, from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints progress on standard error, then, as its last lines there, each
number the correctness check compared beside its limit; the last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics untraced, its
per-layer metrics with ``--trace 1``), ``device``, ``breakdown`` when
traced, and ``checks`` last. Exits non-zero, printing no result, without
the card or cards the cell needs, or when a module of JAX or of the JAX
package was loaded by the time the window closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"
# every build and kernel cache at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(root: Path, args, *, device: str, precision: str = "fp32",
            program=None, t_start: float = T_START):
    """Run the cell and read its metrics: (result line, check lines)."""
    import importlib

    from portbench.lib import bench

    cell = bench.load_cell(root, args.workload)
    loop = importlib.import_module(f"portbench.loops.{cell.spec['loop']}")
    kw = {} if program is None else {"program": program}
    out = loop.run(cell, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), device=device, t_start=t_start,
                   precision=precision, log=log, **kw)
    reading = out["reading"]
    metrics = {}
    for m in bench.cell_metrics(root, args.workload, bool(args.trace)):
        v = bench.read_metric(m["name"], reading)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": out["device_name"], "count": int(cell.entry["chips"]),
           "memory_peak_bytes": int(out["memory_peak_bytes"])}
    breakdown = None
    if args.trace:
        dev["busy_s"] = reading.trace["busy_s"]
        dev["window_s"] = reading.window_s
        breakdown = out["breakdown"]
    line = bench.result_line(correct=out["correct"],
                             attempted=out["attempted"],
                             failed=out["failed"], metrics=metrics,
                             device=dev, breakdown=breakdown,
                             checks=out["checks"])
    checks = [f"check {n} {c['value']!r} limit {c['limit']!r}"
              for n, c in out["checks"].items()]
    return line, checks


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from portbench.lib import bench

    chips = int(bench.load_cell(ROOT, args.workload).entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"cell {args.workload} needs {chips} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"device_count() {torch.cuda.device_count()}")
        return 2
    torch.set_num_threads(4)
    line, checks = measure(ROOT, args, device="cuda")
    found = bench.forbidden_modules()
    if found:
        log(f"modules of JAX or of the JAX package were loaded: {found}")
        return 3
    for c in checks:
        print(c, file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
