"""The dry run (port of ``repro.launch.dryrun``): every (architecture x
input-shape) cell reckoned on the production mesh, with no card and no
allocation, and read against a card's peaks.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
      --shape train_4k --device cpu --card "NVIDIA H100 80GB HBM3"
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --device cpu --card "NVIDIA H100 80GB HBM3"

The reference lowers each cell with XLA for a forced 512-device mesh and
reads ``memory_analysis``, ``cost_analysis`` and the post-SPMD HLO. The
port has no such compiler pass, so a cell is what ONE rank of the mesh
runs (``README.md``, "What a cell is in the port"): the cell's step
function on its share of the batch (the batch axis divided by the extent
of the axes its spec shards it over; the whole batch where the spec
replicates it) and on whole, gathered weights, as ``dist/execute.py``
runs a sharded request. That program runs once under ``FakeTensorMode``:
``FlopCounterMode`` gives the FLOPs (the products: mm, bmm, addmm,
einsum's, convolutions), a dispatch mode the eager program's bytes (each
op's tensor inputs and outputs, views excluded) and the peak of the bytes
its results hold alive (``temp_size_in_bytes``). Its collectives are what
the port's sharded execution would issue, reckoned from the specs: the
entry all-gather of every sharded parameter leaf and, for ``train``, the
gradients' all-reduce over the batch axes; ``roofline.collective_stats``
sums their bytes. Beside the terms, ``data_floor_s``: the rank's
arguments (weights, optimizer state, cache, tokens) each read once over
the HBM rate, the least any program of the cell could move; the eager
program's op-level bytes (the memory term) lie above it by the traffic of
its intermediates.

The program is eager, so the count holds every step of every loop:
``scan_correction_flops`` (the reference's closed form for the scans XLA
counts once) is recorded and never added. Two kinds of cell count a loop
at two lengths and extrapolate affinely, as the reference extrapolates its
probes over the periods: a model with an sLSTM block on a train or
prefill cell (its time loop, S steps of Python; at S multiples of the
mLSTM chunk every term is affine in S from the second chunk on), counted
at two and three chunks; and a chunked prefill that steps token by token
(a cache that can wrap, or an MoE), counted at one and two tokens. A
model of more than two pattern periods is counted at one and two periods
and extrapolated over its P, as the reference's probes are.

``--unlearn-session`` and ``--fisher-refresh`` run the engine on a real
("data", "model") mesh of ``--sweep-mesh RxC`` ranks, spawned here (gloo on
the host with ``--device cpu``, one card per rank with ``cuda``): the
reference's session cells, every gate kept.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import tempfile
import time
import traceback
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import configs
from repro_torch.configs import SHAPES
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import P, _axis_size, spec_paths
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import abstract_production_mesh
from repro_torch.launch.specs import CellSpec, build_cell, n_periods_of
from repro_torch.models.module import (flatten_with_paths, map_with_paths,
                                       tree_leaves, tree_map)


def card_of(card: Optional[str], device) -> str:
    """The card whose peaks a record reads: ``card`` when given, else the
    card ``device`` names (raises without one, and for the host)."""
    if card is not None:
        return card
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the roofline terms need a card's peaks: pass "
                         "card= (e.g. 'NVIDIA H100 80GB HBM3') with "
                         "device='cpu'")
    return torch.cuda.get_device_name(dev)


# ---------------------------------------------------------------------------
# One rank's program, counted
# ---------------------------------------------------------------------------
def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _counter_mode():
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class Counter(TorchDispatchMode):
        """Each op's FLOPs (``torch.utils.flop_counter``'s formulas, as
        ``FlopCounterMode`` counts them: the products), its bytes (its
        tensor inputs and outputs; views and metadata queries, which move
        nothing, excluded), and the live bytes of the tensors the ops
        make, freed when a tensor is: their peak."""

        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes = 0
            self.ops = 0
            self.live = 0
            self.peak = 0

        def _free(self, n):
            self.live -= n

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            alias = [r.alias_info for r in func._schema.returns]
            if alias and all(a is not None and not a.is_write
                             for a in alias):
                return out
            outs = _tensors(out)
            if not outs and not any(a is not None for a in alias):
                return out       # a metadata query (a device, a size)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
            self.ops += 1
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in outs)
            if not any(a is not None for a in alias):
                for t in outs:
                    n = _nbytes(t)
                    self.live += n
                    self.peak = max(self.peak, self.live)
                    weakref.finalize(t, self._free, n)
            return out

    return Counter()


_KEYS = ("flops", "bytes", "ops", "temp_size_in_bytes",
         "argument_size_in_bytes", "output_size_in_bytes")


def count_program(fn: Callable, args: Sequence) -> Dict[str, float]:
    """``fn(*args)`` on fake tensors (``args``: meta tensors, shapes and
    dtypes only; a 0-d integer argument, a position, is passed as the int
    0),
    counted: FLOPs,
    bytes accessed, ops, the peak of live result bytes, the arguments' and
    outputs' bytes, and the seconds it took."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def fake(t):
        return (torch.empty(t.shape, dtype=t.dtype)
                if isinstance(t, torch.Tensor) else t)

    def arg(a):    # a position is a Python int: the port reads it so
        if isinstance(a, torch.Tensor) and a.dim() == 0 \
                and not a.is_floating_point():
            return 0
        return tree_map(fake, a)

    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        local = [arg(a) for a in args]
        counter = _counter_mode()
        with counter:
            out = fn(*local)
        res = {"flops": counter.flops, "bytes": counter.bytes,
               "ops": counter.ops, "temp_size_in_bytes": counter.peak,
               "argument_size_in_bytes": sum(
                   _nbytes(t) for t in _tensors(local)),
               "output_size_in_bytes": sum(_nbytes(t) for t in
                                           _tensors(out))}
        del out, local
    res["seconds"] = time.perf_counter() - t0
    return res


def _n_weight_args(kind: str) -> int:
    """Leading arguments that are weights (whole on every rank): the
    parameters, and for train the optimizer state."""
    return 2 if kind == "train" else 1


def batch_split(cell: CellSpec, mesh, kind: str) -> int:
    """The ways the cell's batch is split over the mesh: the extent behind
    its token argument's batch dimension (1 where the spec replicates
    it)."""
    i = _n_weight_args(kind)
    spec = cell.in_shardings[i]
    if kind == "train":
        spec = spec["tokens"]
    elif kind in ("decode", "long_decode", "prefill_chunked"):
        spec = cell.in_shardings[i + 1]     # the token, after the cache
    return _axis_size(mesh, spec[0]) if len(spec) else 1


def rank_args(cell: CellSpec, kind: str, split: int) -> Tuple:
    """The arguments of one rank: the weights whole (gathered), every other
    argument's batch dimension (a cache's second under a layer stack,
    ``period_stack`` or the decoder's, else the first) cut to the rank's
    share of a batch split ``split`` ways."""
    B = SHAPES[cell.name.split(":", 1)[1]].global_batch

    def local(path, t):
        bd = 1 if path.split("/")[0] in ("period_stack", "decoder") else 0
        shape = list(t.shape)
        if split > 1 and t.dim() > bd and shape[bd] == B:
            shape[bd] = B // split
        return torch.empty(shape, dtype=t.dtype, device="meta")

    n_w = _n_weight_args(kind)
    return tuple(a if i < n_w else map_with_paths(local, a)
                 for i, a in enumerate(cell.args))


def cell_collectives(cell: CellSpec, mesh, kind: str) -> List[Tuple]:
    """What one rank's sharded execution issues: an all-gather of every
    parameter leaf its spec shards (over more than one rank), and for
    train an all-reduce of every gradient where the batch is split."""
    specs = spec_paths(cell.in_shardings[0])
    recs = []
    split = batch_split(cell, mesh, kind) > 1
    for path, leaf in flatten_with_paths(cell.args[0]):
        spec = specs[path]
        result = (RL.dtype_name(leaf.dtype), tuple(leaf.shape))
        if any(_axis_size(mesh, e) > 1 for e in spec):
            recs.append(("all-gather", result))
        if kind == "train" and split:
            recs.append(("all-reduce", result))
    return recs


def _loop_probe(cfg, kind: str, S: int):
    """(L1, L2) of a cell counted at two loop lengths, or None: an sLSTM
    model's train / prefill (its time loop over the tokens, probed at two
    and three mLSTM chunks: the first chunk's and step's carried state
    holds no gradient, so the count is affine from the second on), a
    chunked prefill that steps token by token (a cache that can wrap over
    the prompt, or an MoE; probed at one and two tokens)."""
    types = getattr(cfg, "layer_types", ())
    if kind in ("train", "prefill") and "slstm" in types:
        c = cfg.mlstm_chunk if "mlstm" in types else 1
        return (2 * c, 3 * c)
    if kind == "prefill_chunked":
        attn = [S if bt == "attn" else min(S, cfg.window)
                for bt in types if bt in ("attn", "local")]
        wide = (S <= min(attn) if attn else True) and cfg.moe is None
        if not wide:
            return (1, 2)
    return None


def _cut_tokens(args: Tuple, kind: str, n: int) -> Tuple:
    """``args`` with the token (and label) arguments cut to ``n``
    positions."""
    def cut(t):
        return torch.empty((t.shape[0], n) + tuple(t.shape[2:]),
                           dtype=t.dtype, device="meta")

    args = list(args)
    if kind == "train":
        args[2] = dict(args[2], tokens=cut(args[2]["tokens"]),
                       labels=cut(args[2]["labels"]))
    elif kind == "prefill":
        args[1] = cut(args[1])
    else:                                    # prefill_chunked
        args[2] = cut(args[2])
    return tuple(args)


def _tokens(args: Tuple, kind: str) -> torch.Tensor:
    return (args[2]["tokens"] if kind == "train" else
            args[1] if kind == "prefill" else args[2])


def count_cell(spec, shape_name: str, mesh, overrides=None
               ) -> Tuple[CellSpec, Dict[str, Any]]:
    """The cell (global arguments) and the count of one rank's program.

    A model of P > 2 pattern periods is counted at one and two periods
    (the reference's probe1 / probe2 cells) and extrapolated affinely to P,
    Cost(P) = probe1 + (P - 1) * (probe2 - probe1), exact since every
    period runs the same ops; a model with a loop over the tokens
    (``_loop_probe``) at two lengths as well, extrapolated the same way in
    the length. Every count holds each step of its loops."""
    if overrides:
        spec = dataclasses.replace(spec, full=spec.full.with_(**overrides))
    shape = SHAPES[shape_name]
    kind = shape.kind
    cell = build_cell(spec, shape_name, mesh)
    split = batch_split(cell, mesh, kind)
    moe = spec.kind == "lm" and spec.full.moe is not None
    P = max(1, n_periods_of(spec))
    variants = ("full",) if P <= 2 else ("probe1", "probe2")
    probe = _loop_probe(spec.full, kind, shape.seq_len)
    counts = []
    L = None
    for v in variants:
        vc = build_cell(spec, shape_name, mesh, variant=v,
                        batch_split=split if moe else 1)
        local = rank_args(vc, kind, split)
        rows = int(_tokens(local, kind).shape[0])
        if probe is None:
            counts.append([count_program(vc.fn, local)])
        else:
            L = int(_tokens(local, kind).shape[1])
            counts.append([count_program(vc.fn, _cut_tokens(local, kind, n))
                           for n in probe])

    def extrap(c1, c2, k):
        return {key: c1[key] + k * (c2[key] - c1[key]) for key in _KEYS}

    if len(variants) == 2:
        per_len = [extrap(a, b, P - 1) for a, b in zip(*counts)]
    else:
        per_len = counts[0]
    if probe is None:
        res = dict(per_len[0])
    else:
        l1, l2 = probe
        if (L - l1) % (l2 - l1):
            raise ValueError(f"{cell.name}: {L} positions are not a whole "
                             f"number of probe steps of {l2 - l1}")
        res = extrap(per_len[0], per_len[1], (L - l1) // (l2 - l1))
    res["seconds"] = sum(c["seconds"] for cs in counts for c in cs)
    method = []
    if len(variants) == 2:
        method.append(f"1 and 2 of {P} periods, extrapolated affinely")
    else:
        method.append(f"all {P} periods")
    if probe is not None:
        method.append(f"{probe[0]} and {probe[1]} of {L} token positions, "
                      f"extrapolated affinely")
    res["method"] = "; ".join(method)
    res["rows_per_rank"] = rows
    res["batch_split"] = split
    res["counts"] = len(variants) * (1 if probe is None else 2)
    return cell, res


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             overrides: Optional[dict] = None, *, card: Optional[str] = None,
             device="cuda") -> dict:
    """The reference's record of one cell, at ``card``'s peaks (the card
    of ``device`` unless ``card`` is given; the multi-pod pass, a
    shard-proof without terms, needs none)."""
    spec = configs.get(arch_id)
    mesh = abstract_production_mesh(multi_pod)
    n_chips = mesh.size
    mesh_name = "x".join(str(s) for s in mesh.shape.values())
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
           "chips": n_chips}
    if shape_name in spec.skip_shapes:
        rec["status"] = "skipped"
        rec["reason"] = spec.skip_shapes[shape_name]
        return rec
    if not multi_pod:
        card = card_of(card, device)
    cell, c = count_cell(spec, shape_name, mesh, overrides)
    memory = RL.memory_summary(c)
    count = {"method": c["method"], "ops": c["ops"], "runs": c["counts"],
             "rows_per_rank": c["rows_per_rank"],
             "batch_split": c["batch_split"],
             "scan_correction_flops_not_added": cell.scan_correction_flops}
    if multi_pod:
        rec.update({
            "status": "ok", "compile_full_s": round(c["seconds"], 2),
            "n_params": cell.n_params,
            "n_active_params": cell.n_active_params,
            "memory": memory, "count": count,
        })
        print(f"[dryrun] {arch_id} x {shape_name} @ {mesh_name}: "
              f"counted={c['seconds']:.1f}s (multi-pod shard-proof)",
              flush=True)
        return rec

    kind = SHAPES[shape_name].kind
    P = n_periods_of(dataclasses.replace(
        spec, full=spec.full.with_(**overrides)) if overrides else spec)
    cost = {"flops": float(c["flops"]), "bytes accessed": float(c["bytes"])}
    st = RL.collective_stats(cell_collectives(cell, mesh, kind))
    coll = {"bytes_per_device": st["bytes_per_device"],
            "by_op_bytes": st["by_op_bytes"],
            "by_op_counts_probe2": st["by_op_counts"],
            "extrapolated_periods": P}
    terms = RL.roofline_terms(cost, st["bytes_per_device"], n_chips,
                              cell.model_flops, card=card)
    terms["data_floor_s"] = (memory["argument_size_in_bytes"]
                             / RL.peaks(card)["hbm"])
    rec.update({
        "status": "ok",
        "compile_full_s": round(c["seconds"], 2),
        "compile_probes_s": round(c["seconds"] if c["counts"] > 1 else 0.0,
                                  2),
        "n_params": cell.n_params,
        "n_active_params": cell.n_active_params,
        "memory": memory,
        "cost": cost,
        "collectives": coll,
        "roofline": terms,
        "count": count,
    })
    print(f"[dryrun] {arch_id} x {shape_name} @ {mesh_name}: "
          f"counted={c['seconds']:.1f}s dom={terms['dominant']} "
          f"frac={terms['roofline_fraction']:.3f} "
          f"bound={terms['step_time_bound_s'] * 1e3:.3f}ms "
          f"data_floor={terms['data_floor_s'] * 1e3:.3f}ms "
          f"bytes/dev={memory.get('temp_size_in_bytes', 0) / 2**30:.2f}GiB "
          f"at {card}'s peaks", flush=True)
    return rec


# ---------------------------------------------------------------------------
# Session cells on a real mesh of spawned ranks
# ---------------------------------------------------------------------------
def _session_setup(arch_id: str, device, refresh: bool):
    from repro_torch.api import ExecSpec, RefreshSpec, UnlearnSpec
    from repro_torch.core import adapters
    from repro_torch.data import synthetic as syn
    from repro_torch.models import lm as LM

    cfg = configs.get(arch_id).smoke
    spec = UnlearnSpec(
        mode="ficabu",
        dampen={"alpha": 8.0, "lam": 1.0},
        # tau=-1: never stop early, so the sweep walks EVERY layer kind
        # (head, blocks, embedding) through the sharded fused step
        halt={"tau": -1.0, "checkpoint_every": 2},
        exec=ExecSpec(chunk_size=4, donate=True,
                      mesh_axes=("data", "model"), sharding="tp"),
        **({"refresh": RefreshSpec(every_drains=1, max_batches=2,
                                   decay=0.5)} if refresh else {}))
    seq = 17
    toks, doms = syn.make_lm_domains(syn.LMDataConfig(
        vocab=cfg.vocab, n_domains=4, seq_len=seq, n_per_domain=8, seed=0))
    toks = torch.as_tensor(toks, device=device).long()
    doms = torch.as_tensor(doms, device=device)
    params = LM.init_lm(torch.Generator().manual_seed(0), cfg, device=device)
    adapter = adapters.lm_adapter(cfg, seq - 1, device=device)
    loss_fn = lambda p, b: LM.lm_loss(p, cfg, b[0], b[1],  # noqa: E731
                                      aux_weight=0.0)
    return cfg, spec, toks, doms, params, adapter, loss_fn


def _requests(toks, doms, n_domains):
    from repro_torch.api import ForgetRequest
    return [ForgetRequest(toks[doms == d][:8, :-1], toks[doms == d][:8, 1:],
                          tag=int(d)) for d in range(n_domains)]


def _replicated(t) -> bool:
    """Every rank holds the whole tensor (JAX's ``is_fully_replicated``):
    not a DTensor, or sharded over mesh dimensions of one rank only."""
    from torch.distributed.tensor import DTensor, Replicate
    return not isinstance(t, DTensor) or all(
        isinstance(p, Replicate) or t.device_mesh.size(i) == 1
        for i, p in enumerate(t.placements))


def _whole(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _sharded_leaves(tree) -> Tuple[int, int]:
    leaves = tree_leaves(tree)
    return sum(1 for x in leaves if not _replicated(x)), len(leaves)


def _session_cell(arch_id: str, mesh, mesh_shape, n_domains: int,
                  device) -> dict:
    """Body of ``run_unlearn_session`` on one rank of ``mesh``."""
    import dataclasses as _dc

    from repro_torch.api import Unlearner
    from repro_torch.engine import TRACE_LOG

    cfg, spec, toks, doms, params, adapter, loss_fn = _session_setup(
        arch_id, device, refresh=False)
    unl = Unlearner(adapter, spec=spec, device=device).shard(mesh)
    # the Fisher from the whole tree (the facade places it; the port's
    # losses run on whole tensors), the requests on the placed one
    unl.ensure_fisher(loss_fn, params, (toks[:16, :-1], toks[:16, 1:]))
    params = unl.place_params(params)
    reqs = _requests(toks, doms, n_domains)
    t0 = time.time()
    p1, _, g1 = unl.forget_group(reqs, params=params)
    t_cold = time.time() - t0
    t0 = time.time()
    _, _, g2 = unl.forget_group(reqs, params=params)  # warm: no builds
    t_warm = time.time() - t0

    n_sharded, n_leaves = _sharded_leaves(p1)
    fi_sharded, fi_leaves = _sharded_leaves(unl.fisher_global)
    finite = all(bool(torch.isfinite(_whole(x)).all())
                 for x in tree_leaves(p1))

    # the scanned whole-sweep program on the mesh: a sibling spec with
    # sweep_mode="scanned" on the SAME entry params as the layerwise
    # drain, identical halting and edits required, then a warm repeat
    spec_scanned = _dc.replace(
        spec, exec=_dc.replace(spec.exec, sweep_mode="scanned"))
    scanned = unl.with_spec(spec_scanned)
    ps1, _, sg1 = scanned.forget_group(reqs, params=params)
    TRACE_LOG.clear()
    t0 = time.time()
    _, _, sg2 = scanned.forget_group(reqs, params=params)
    t_scan_warm = time.time() - t0
    scan_retraces = list(TRACE_LOG)
    scanned_equal = all(torch.equal(_whole(a), _whole(b)) for a, b in
                        zip(tree_leaves(p1), tree_leaves(ps1)))

    # the donating family: group sweeps pin the snapshot and never donate,
    # so donation runs through a single-request sweep on p1 (consumed)
    comp0 = unl.stats["fused_compiles"]
    _, st_single = unl.forget(reqs[0], params=p1)
    donated_compiles = unl.stats["fused_compiles"] - comp0

    rec = {
        "arch": arch_id, "cell": "unlearn_session",
        "mesh": "x".join(str(s) for s in mesh_shape),
        "spec": spec.to_dict(),
        "domains": [r.tag for r in reqs],
        "stopped_at_l": g1["stopped_at_l"],
        "sweeps": g1["sweeps"],
        "params_leaves_sharded": [n_sharded, n_leaves],
        "fisher_leaves_sharded": [fi_sharded, fi_leaves],
        "donating_single_request": {
            "fused_compiles": donated_compiles,
            "stopped_at_l": st_single["stopped_at_l"],
        },
        "engine_cold": g1["engine"], "engine_warm": g2["engine"],
        "t_cold_s": round(t_cold, 3), "t_warm_s": round(t_warm, 3),
        "scanned_sweep": {
            "mode": sg1["engine"].get("sweep_mode"),
            "stopped_at_l": sg1["stopped_at_l"],
            "matches_layerwise": scanned_equal,
            "warm_compiles": sg2["engine"]["compiles"],
            "warm_retraces": len(scan_retraces),
            "t_warm_s": round(t_scan_warm, 3),
        },
        "status": "ok",
    }
    errors = []
    if g2["engine"]["compiles"] != 0:
        errors.append(f"warm drain recompiled {g2['engine']['compiles']} "
                      "programs on the mesh")
    if sg1["engine"].get("sweep_mode") != "scanned":
        errors.append("the scanned megaprogram fell back to the layerwise "
                      "loop on the mesh")
    if not scanned_equal:
        errors.append("scanned mesh drain diverged from the layerwise "
                      "drain on identical inputs")
    if sg1["stopped_at_l"] != g1["stopped_at_l"]:
        errors.append(f"scanned mesh drain halted at {sg1['stopped_at_l']}, "
                      f"layerwise at {g1['stopped_at_l']}")
    if sg2["engine"]["compiles"] != 0 or scan_retraces:
        errors.append(f"warm scanned drain recompiled "
                      f"{sg2['engine']['compiles']} / retraced "
                      f"{len(scan_retraces)} on the mesh")
    if donated_compiles == 0:
        errors.append("the donating single-request family compiled "
                      "nothing — donation path not exercised")
    if n_sharded == 0:
        errors.append("no edited parameter leaf ended up sharded")
    if not finite:
        errors.append("non-finite parameters after the mesh sweep")
    if errors:
        rec["status"] = "error"
        rec["error"] = "; ".join(errors)
    print(f"[dryrun] unlearn_session {arch_id} @ {rec['mesh']}: "
          f"stop_l={rec['stopped_at_l']} "
          f"sharded={n_sharded}/{n_leaves} params, "
          f"{fi_sharded}/{fi_leaves} fisher, "
          f"donating family compiles={donated_compiles}, "
          f"cold {t_cold:.1f}s warm {t_warm:.2f}s "
          f"(warm compiles={g2['engine']['compiles']}); "
          f"scanned megaprogram: match={scanned_equal} "
          f"warm {t_scan_warm:.2f}s "
          f"retraces={len(scan_retraces)}", flush=True)
    return rec


def _refresh_cell(arch_id: str, mesh, mesh_shape, n_domains: int,
                  device) -> dict:
    """Body of ``run_fisher_refresh`` on one rank of ``mesh``."""
    import numpy as np

    from repro_torch.api import Unlearner
    from repro_torch.core import fisher as fisher_mod
    from repro_torch.engine import TRACE_LOG, tree_rel_err

    cfg, spec, toks, doms, params, adapter, loss_fn = _session_setup(
        arch_id, device, refresh=True)
    unl = Unlearner(adapter, spec=spec, device=device).shard(mesh)
    whole_params = params
    params = unl.place_params(params)
    # one-shot I_D, the refresh folds and the reference recompute share
    # the SAME retain stream, so the staleness metric isolates the drift
    retain = [(toks[16:24, :-1], toks[16:24, 1:]),
              (toks[24:32, :-1], toks[24:32, 1:])]
    unl.set_fisher(fisher_mod.diag_fisher_streaming(
        loss_fn, whole_params, retain, chunk_size=4, device=device))
    unl.enable_fisher_refresh(None, retain, loss_fn)
    stale = tree_map(lambda x: _whole(x).clone(), unl.fisher_global)

    reqs = _requests(toks, doms, n_domains)
    # drain 1 -> refresh 1 (builds the refresh program) -> drain 2 ->
    # refresh 2 (must replay it: no retrace, no build)
    params, _, g1 = unl.forget_group(reqs, params=params)
    t0 = time.time()
    r1 = unl.refresh_if_due(params)
    t_cold = time.time() - t0
    params, _, g2 = unl.forget_group(reqs, params=params)
    TRACE_LOG.clear()
    t0 = time.time()
    r2 = unl.refresh_if_due(params)
    t_warm = time.time() - t0
    warm_retraces = list(TRACE_LOG)

    recompute = fisher_mod.diag_fisher_streaming(
        loss_fn, tree_map(_whole, params), retain, chunk_size=4,
        device=device)
    refreshed = tree_map(_whole, unl.fisher_global)
    stale_err = tree_rel_err(stale, recompute)
    refreshed_err = tree_rel_err(refreshed, recompute)
    fi_sharded, fi_leaves = _sharded_leaves(unl.fisher_global)
    finite = all(bool(torch.isfinite(x).all())
                 for x in tree_leaves(refreshed))

    rec = {
        "arch": arch_id, "cell": "fisher_refresh",
        "mesh": "x".join(str(s) for s in mesh_shape),
        "spec": spec.to_dict(),
        "refresh_cold": r1, "refresh_warm": r2,
        "t_refresh_cold_s": round(t_cold, 3),
        "t_refresh_warm_s": round(t_warm, 3),
        "warm_retraces": warm_retraces,
        "drain_warm_compiles": g2["engine"]["compiles"],
        "fisher_leaves_sharded": [fi_sharded, fi_leaves],
        "stale_rel_err": float(np.float64(stale_err)),
        "refreshed_rel_err": float(np.float64(refreshed_err)),
        "status": "ok",
    }
    errors = []
    if r1 is None or r1["engine"]["refresh_compiles"] == 0:
        errors.append("first refresh did not compile the refresh program")
    if r2 is None or r2["engine"]["refresh_compiles"] != 0:
        errors.append("warm refresh recompiled the refresh program")
    if warm_retraces:
        errors.append(f"warm refresh retraced: {warm_retraces}")
    if g2["engine"]["compiles"] != 0:
        errors.append(f"warm drain recompiled {g2['engine']['compiles']} "
                      "programs after a refresh replaced I_D")
    if fi_sharded == 0:
        errors.append("no refreshed Fisher leaf ended up sharded")
    if not finite:
        errors.append("non-finite refreshed Fisher")
    if refreshed_err >= stale_err:
        errors.append(f"refresh did not reduce I_D staleness "
                      f"({stale_err:.4f} -> {refreshed_err:.4f})")
    if errors:
        rec["status"] = "error"
        rec["error"] = "; ".join(errors)
    print(f"[dryrun] fisher_refresh {arch_id} @ {rec['mesh']}: "
          f"refresh cold {t_cold:.2f}s warm {t_warm:.3f}s "
          f"(warm compiles="
          f"{r2['engine']['refresh_compiles'] if r2 else '-'}, "
          f"retraces={len(warm_retraces)}), "
          f"fisher sharded {fi_sharded}/{fi_leaves}, "
          f"rel err {stale_err:.4f} -> {refreshed_err:.4f}", flush=True)
    return rec


_CELLS = {"unlearn_session": _session_cell, "fisher_refresh": _refresh_cell}


def _rank_main(rank: int, world: int, rdv: str, cell: str, arch_id: str,
               mesh_shape, n_domains: int, device: str, out: str) -> None:
    """One spawned rank: a process group of ``world`` ranks, the
    ("data", "model") mesh over it, the cell; its record to ``out.rank``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{rdv}", world_size=world,
                            rank=rank)
    try:
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // world))
        mesh = make_mesh(mesh_shape, ("data", "model"), device=dev)
        try:
            rec = _CELLS[cell](arch_id, mesh, mesh_shape, n_domains, dev)
        except Exception as e:  # the record carries the failure
            traceback.print_exc()
            rec = {"arch": arch_id, "cell": cell, "status": "error",
                   "error": repr(e)}
        with open(f"{out}.{rank}", "w") as f:
            json.dump(rec, f, default=str)
    finally:
        dist.destroy_process_group()


def _spawn_cell(cell: str, arch_id: str, mesh_shape, n_domains: int,
                device, timeout_s: float) -> dict:
    import torch.multiprocessing as mp

    mesh_shape = tuple(int(n) for n in mesh_shape)
    world = 1
    for n in mesh_shape:
        world *= n
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < world:
        raise ValueError(f"a {mesh_shape} mesh on cards needs {world} "
                         f"cards, this host has {torch.cuda.device_count()}")
    tmp = tempfile.mkdtemp(prefix="ficabu-dryrun-")
    try:
        out = os.path.join(tmp, "rec")
        ctx = mp.start_processes(
            _rank_main, args=(world, os.path.join(tmp, "rdv"), cell,
                              arch_id, mesh_shape, n_domains, dev.type, out),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{cell} on a {mesh_shape} mesh took "
                                   f"more than {timeout_s} s")
        recs = []
        for r in range(world):
            with open(f"{out}.{r}") as f:
                recs.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = recs[0]
    keys = [k for k in ("stopped_at_l", "sweeps", "params_leaves_sharded",
                        "fisher_leaves_sharded", "status") if k in rec]
    differ = [k for k in keys if any(r.get(k) != rec[k] for r in recs)]
    if differ and rec["status"] == "ok":
        rec["status"] = "error"
        rec["error"] = f"ranks disagree on {differ}"
    rec["ranks"] = world
    return rec


def run_unlearn_session(arch_id: str, mesh_shape=(2, 2),
                        n_domains: int = 2, *, device="cuda",
                        timeout_s: float = 900.0) -> dict:
    """A coalesced forget-sweep session through the ``Unlearner`` facade on
    a ("data", "model") mesh of ``mesh_shape`` ranks, spawned here: sharded
    params and Fisher, split forget batches, donated fused-step buffers,
    the scanned program on the mesh; rank 0's record (every rank must
    agree on the halting and the sharded-leaf counts)."""
    return _spawn_cell("unlearn_session", arch_id, mesh_shape, n_domains,
                       device, timeout_s)


def run_fisher_refresh(arch_id: str, mesh_shape=(2, 2),
                       n_domains: int = 2, *, device="cuda",
                       timeout_s: float = 900.0) -> dict:
    """The ``fisher_refresh`` cell: drains interleaved with streamed I_D
    refreshes on a ("data", "model") mesh of spawned ranks, through one
    warm facade: the refresh program built once and replayed with no
    retrace, and the refreshed I_D closer than the stale one to a
    recompute at the edited weights."""
    return _spawn_cell("fisher_refresh", arch_id, mesh_shape, n_domains,
                       device, timeout_s)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--unlearn-session", action="store_true",
                    help="run the facade-driven forget-sweep session on a "
                         "mesh of spawned ranks instead of counting cells")
    ap.add_argument("--fisher-refresh", action="store_true",
                    help="run the fisher_refresh session cell: drains "
                         "interleaved with streamed I_D refreshes on the "
                         "mesh")
    ap.add_argument("--sweep-mesh", default="2x2",
                    help="data x model mesh shape for --unlearn-session / "
                         "--fisher-refresh (one rank each)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; the card's peaks, one card "
                         "per session rank) or cpu (gloo ranks)")
    ap.add_argument("--card", default=None,
                    help="the card whose peaks the terms read (default: "
                         "the card of --device)")
    ap.add_argument("--out", default="experiments/torch_dryrun")
    args = ap.parse_args(argv)

    if args.unlearn_session or args.fisher_refresh:
        arch = args.arch or "gemma3-1b"
        cell_name = ("fisher_refresh" if args.fisher_refresh
                     else "unlearn_session")
        runner = (run_fisher_refresh if args.fisher_refresh
                  else run_unlearn_session)
        shape = tuple(int(s) for s in args.sweep_mesh.split("x"))
        os.makedirs(args.out, exist_ok=True)
        try:
            rec = runner(arch, shape, device=args.device)
        except Exception as e:
            traceback.print_exc()
            rec = {"arch": arch, "cell": cell_name,
                   "status": "error", "error": repr(e)}
        tag = f"{cell_name}__{arch.replace('.', '_')}__{args.sweep_mesh}"
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1, default=str)
        print(f"[dryrun] {cell_name} done: {rec['status']}", flush=True)
        raise SystemExit(0 if rec["status"] == "ok" else 1)

    cells = []
    if args.all:
        for aid in sorted(configs.all_archs()):
            for sname in SHAPES:
                cells.append((aid, sname))
    else:
        if not (args.arch and args.shape):
            raise ValueError(
                "dryrun needs either --arch AND --shape, or --all")
        cells = [(args.arch, args.shape)]
    os.makedirs(args.out, exist_ok=True)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = 0
    for aid, sname in cells:
        for mp_ in meshes:
            tag = (f"{aid.replace('.', '_')}__{sname}__"
                   f"{'pod2' if mp_ else 'pod1'}")
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"[dryrun] skip existing {tag}", flush=True)
                continue
            try:
                rec = run_cell(aid, sname, mp_, card=args.card,
                               device=args.device)
            except Exception as e:  # a failing cell is a bug: surface it
                traceback.print_exc()
                rec = {"arch": aid, "shape": sname,
                       "mesh": "2x16x16" if mp_ else "16x16",
                       "status": "error", "error": repr(e)}
                failures += 1
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
    print(f"[dryrun] done, {failures} failures", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
