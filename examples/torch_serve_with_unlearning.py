"""Serving example on the PyTorch/CUDA port: batched requests against
gemma3-1b (reduced config), with a forget request applied IN PLACE between
batches — no retraining, no weight reload; the server keeps serving on the
edited weights.

Serving drives unlearning through the ``repro_torch.api.Unlearner`` facade
with one typed ``UnlearnSpec`` (echoed into the result for auditability),
and ``--cache-dir`` keeps the port's kernel build cache on disk (the nvcc
libraries are the port's only compiled programs): the second run below
loads every library it uses from there instead of building it again.

``--fisher-refresh 1`` keeps the global importance I_D fresh: after every
drain edits the weights, retain microbatches are folded — at the now-edited
parameters — into an EMA of I_D (one refresh program in the same warm
session), so later forget requests dampen against an importance map that
still describes the weights being served. The same arguments as
``examples/serve_with_unlearning.py``, with ``--device`` passed through.

    PYTHONPATH=src python examples/torch_serve_with_unlearning.py               # card
    PYTHONPATH=src python examples/torch_serve_with_unlearning.py --device cpu  # host
"""
import argparse
import tempfile

from repro_torch.launch import serve

ARGS = ["--arch", "gemma3-1b", "--requests", "4", "--prompt-len", "12",
        "--gen-len", "6", "--unlearn-after", "1", "--forget-domain", "1",
        "--fisher-refresh", "1"]


def run(device="cuda", *, cache_dir=None) -> dict:
    """One serving run on ``device``; with ``cache_dir``, against that
    kernel build cache, then a second run against the now warm cache under
    ``--check``. The build cache is process-wide: a process that loaded a
    kernel library before passes no ``cache_dir``. Returns what the script
    prints."""
    args = ARGS + ["--device", str(device)]
    if cache_dir is not None:
        args += ["--cache-dir", str(cache_dir)]
    res = serve.main(args)
    refresh = res["fisher_refresh"]
    out = {"unlearned": res["unlearned"],
           "latency_s": [r["latency_s"] for r in res["served"]],
           **res["unlearn_stats"],
           "unlearn_spec": res["unlearn_spec"],
           "refreshes": refresh["refreshes"],
           "staleness": refresh["staleness"]}
    if cache_dir is not None:
        out["cache_entries_new"] = res["compilation_cache"]["entries_new"]
        res2 = serve.main(args + ["--check"])
        out["warm_cache_entries_new"] = \
            res2["compilation_cache"]["entries_new"]
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args().device
    with tempfile.TemporaryDirectory() as cache_dir:
        res = run(device, cache_dir=cache_dir)
    assert res["unlearned"]
    print("served batches:", res["latency_s"])
    print("unlearning stopped at layer:", res["stopped_at_l"])
    print("unlearn spec:", res["unlearn_spec"])
    stale = res["staleness"]
    assert res["refreshes"] >= 1
    assert stale["improved"]
    print(f"fisher refresh: {res['refreshes']} refresh(es), I_D rel err "
          f"{stale['stale_rel_err']:.4f} -> {stale['refreshed_rel_err']:.4f}"
          " vs a from-scratch recompute at the edited weights")
    print(f"compilation cache: {res['cache_entries_new']} kernel libraries "
          f"persisted to disk")
    assert res["warm_cache_entries_new"] == 0
    print("warm-cache rerun compiled nothing new")
