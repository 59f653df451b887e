"""A closed loop of forget requests with one client: an operator working
through a backlog of deletion requests against a served LM.

Set-up makes the weights on the device from the seed, the cell's token
streams, the retain sequences' labels and the global Fisher I_D
(``Unlearner.ensure_fisher``), and runs one warm-up request of the cell's
shape that sweeps every layer (tau = -1, so every step and checkpoint
runner is built), whose result is dropped.

In the window, request k + 1 is submitted when request k's edited weights
are returned and synchronised. Each request forgets a domain no earlier
request of the run forgot, and edits the weights the previous request
published. Its labels are the served model's own argmax tokens, taken at
submission with the weights then served. A request's latency runs from
submission to its edited weights returned and synchronised; the window
runs from the first submission to the last completion, and requests are
submitted until ``seconds`` have passed.

The whole run serves under the port's ``device.deterministic``, so one
seed's requests halt at the same depth in every run.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from portbench.lib import check, peaks, traffic, weights
from portbench.lib.bench import Cell, Reading
from portbench.lib.trace import Tracer, load_classes, reduce_ops

# the nvcc build cache of the port's kernels, at a fixed path inside the
# checkout: only a checkout's first run builds
CACHE = Path(__file__).resolve().parents[2] / ".portbench_cache" / "kernels"
# the port's RMSNorm takes no eps; it runs at this one
PORT_RMS_EPS = 1e-6


class Program:
    """The system under test: ``repro_torch``'s LM and its ``Unlearner``,
    configured from the cell. ``precision="int8"`` switches on the port's
    own int8 path (the correctness control): the requests run it, and the
    labels come from the int8 weights the deployment would serve."""

    def __init__(self, cell: Cell, device, precision: str = "fp32"):
        from repro_torch.api import QuantSpec, Unlearner, UnlearnSpec
        from repro_torch.core import adapters
        from repro_torch.models import lm as LM

        d, s = cell.dims, cell.spec
        if d.rms_norm_eps != PORT_RMS_EPS:
            raise ValueError(f"{cell.entry['config']}: the port runs RMSNorm "
                             f"at eps {PORT_RMS_EPS}, the configuration "
                             f"states {d.rms_norm_eps}")
        self.LM = LM
        self.cfg = LM.LMConfig(
            name=cell.entry["config"], n_layers=d.n_layers,
            d_model=d.d_model, n_heads=d.n_heads, n_kv_heads=d.n_kv_heads,
            d_ff=d.d_ff, vocab=d.vocab, head_dim=d.head_dim,
            qkv_bias=d.qkv_bias, rope_theta=d.rope_theta,
            param_dtype=d.dtype)
        self.adapter = adapters.lm_adapter(self.cfg, int(s["seq_len"]),
                                           device=device)
        int8 = precision == "int8"
        self.spec = UnlearnSpec.for_mode(
            s["mode"], alpha=float(s["alpha"]), lam=float(s["lam"]),
            tau=float(s["tau"]), checkpoint_every=int(s["checkpoint_every"]),
            b_r=float(s.get("b_r", 10.0)), chunk_size=int(s["chunk_size"]),
            use_kernel=bool(s["use_kernel"]), sweep_mode=s["sweep_mode"],
            precision=precision, quant=QuantSpec() if int8 else None)
        self.unl = Unlearner(self.adapter, spec=self.spec, device=device)
        self.int8 = int8

    def labels(self, params, tokens: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            if self.int8:
                from repro_torch.optim.compression import q8_fakequant_tree
                params = q8_fakequant_tree(params)
            return self.LM.forward(params, self.cfg, tokens)[0].argmax(-1)

    def global_fisher(self, params, tokens, labels) -> None:
        cfg = self.cfg
        self.unl.ensure_fisher(
            lambda p, b: self.LM.lm_loss(p, cfg, b[0], b[1]), params,
            (tokens, labels), chunk_size=self.spec.exec.chunk_size)

    def forget(self, params, tokens, labels, *, tau: Optional[float] = None
               ) -> Tuple[Any, Dict]:
        from repro_torch.api import ForgetRequest
        cfg = self.spec.to_config()
        if tau is not None:
            cfg = dataclasses.replace(cfg, tau=tau)
        return self.unl.forget(ForgetRequest(tokens, labels), params=params,
                               cfg=cfg)


def _slim(st: Dict) -> Dict:
    keep = ("stopped_at_l", "checkpoints_hit", "forget_acc_trace",
            "selected_per_layer", "macs_vs_ssd_pct")
    out = {k: st[k] for k in keep}
    out["engine"] = {k: st["engine"][k] for k in ("compiles", "sweep_mode")}
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cell: Cell, *, seed: int, seconds: float, trace: bool, device,
        t_start: float, precision: str = "fp32",
        program: Callable[..., Program] = Program,
        log: Callable[[str], None] = lambda s: None) -> Dict[str, Any]:
    """One run of the cell: set-up, the window, the check. Returns the
    reading, the counts, the memory peak, the trace's reduction and the
    check's verdict."""
    from repro_torch.device import deterministic

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    s = cell.spec
    B, S = int(s["seqs_per_request"]), int(s["seq_len"])
    with deterministic(dev):
        if cuda:
            from repro_torch.api import enable_compilation_cache
            enable_compilation_cache(str(CACHE))
            torch.cuda.reset_peak_memory_stats(dev)
        params0 = weights.make_params(cell.dims, seed, dev)
        data = traffic.run_data(s, seed)
        retain = torch.as_tensor(data.retain, device=dev)
        warm = torch.as_tensor(data.warmup, device=dev)
        pool = torch.as_tensor(data.pool, device=dev)
        prog = program(cell, dev, precision=precision)
        retain_labels = prog.labels(params0, retain)
        prog.global_fisher(params0, retain, retain_labels)
        prog.forget(params0, warm, prog.labels(params0, warm), tau=-1.0)
        _sync(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.3f} s")

        k_cmp = check.sample_request(seed)
        kept: Dict[int, Tuple[Any, Any, torch.Tensor]] = {}
        reqs: List[Dict[str, Any]] = []
        attempted = failed = 0
        tracer = Tracer() if trace else None
        if tracer is not None:
            tracer.__enter__()
        phase = tracer.phase if tracer is not None else (lambda n: None)
        params, new = params0, None
        t0 = time.perf_counter()
        deadline = t0 + seconds
        t_end = t0
        try:
            while time.perf_counter() < deadline:
                i = attempted
                if i >= pool.shape[0]:
                    raise RuntimeError(
                        f"the cell's forget pool of {pool.shape[0]} domains "
                        f"ran out inside the window")
                attempted += 1
                t_sub = time.perf_counter()
                phase("labels")
                x = pool[i]
                labels = prog.labels(params, x)
                phase("forget")
                new, st = prog.forget(params, x, labels)
                phase("sync")
                _sync(dev)
                t_end = time.perf_counter()
                phase("between requests")
                reqs.append({"latency_s": t_end - t_sub, "tokens": B * S,
                             "stats": _slim(st)})
                if i in (0, k_cmp):
                    kept[i] = (params, new, labels)
                params = new
        except Exception as e:  # a request that raises fails the run
            failed += 1
            log(f"request {attempted - 1} failed: {type(e).__name__}: {e}")
        finally:
            if tracer is not None:
                tracer.__exit__(None, None, None)
        window_s = t_end - t0
        peak_window = torch.cuda.max_memory_allocated(dev) if cuda else 0
        memory_peak = max(setup_peak, peak_window)
        log(f"window {window_s:.3f} s: {len(reqs)} requests, halts "
            f"{[r['stats']['stopped_at_l'] for r in reqs]}")

        breakdown = None
        if tracer is not None:
            red = reduce_ops(tracer.device_ops(), t0, t_end, tracer.phases,
                             load_classes())
            breakdown = {"device_ops": red["device_ops"],
                         "idle_gaps": red["idle_gaps"]}
        else:
            red = None
        name = torch.cuda.get_device_name(dev) if cuda else "cpu"
        reading = Reading(cell=cell, setup_s=setup_s, window_s=window_s,
                          requests=reqs, peak_window_bytes=peak_window,
                          peaks=peaks.peaks(name) if cuda else {},
                          trace=red)

        # the program's state goes before the reference runs; the compared
        # requests' weights wait on the host
        t_chk = time.perf_counter()
        stats_of = {i: reqs[i]["stats"] for i in kept}
        moved: Dict[int, torch.Tensor] = {}
        kept = {i: (weights.tree_to(a, "cpu", moved),
                    weights.tree_to(b, "cpu", moved), c)
                for i, (a, b, c) in kept.items()}
        params0 = weights.tree_to(params0, "cpu", moved)
        del prog, params, new, moved
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        judge = check.Judge(cell.dims, s, dev)
        deepest = max([st["stopped_at_l"] for st in stats_of.values()],
                      default=0)
        log(f"check: weights to the host in "
            f"{time.perf_counter() - t_chk:.3f} s")
        fisher_g = judge.global_fisher(params0, retain, retain_labels,
                                       deepest)
        log(f"check: global Fisher at {time.perf_counter() - t_chk:.3f} s")
        for i in sorted(kept):
            t_in, t_out, lbl = kept.pop(i)
            judge.request(i, t_in, t_out, pool[i], lbl, stats_of[i],
                          fisher_g)
            del t_in, t_out, lbl
            log(f"check: request {i} at {time.perf_counter() - t_chk:.3f} s")
        del fisher_g
        ok, checks = judge.verdict(s["limits"])
        log(f"check of requests {judge.compared} in "
            f"{time.perf_counter() - t_chk:.3f} s: {judge.values}")
        for why in judge.reasons[:20]:
            log(f"mismatch: {why}")
    return {"reading": reading, "attempted": attempted, "failed": failed,
            "correct": ok and failed == 0 and bool(reqs)
            and 0 in judge.compared,
            "checks": checks, "values": dict(judge.values),
            "leaves": judge.leaves, "accs": judge.accs,
            "memory_peak_bytes": memory_peak,
            "device_name": name, "breakdown": breakdown}
