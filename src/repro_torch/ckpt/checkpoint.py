"""Fault-tolerant checkpointing (port of ``repro.ckpt.checkpoint``).

The file format is the reference's, leaf for leaf, so that a checkpoint
either package writes restores in the other:

  * every host writes its own shard file ``step_<N>/host_<i>.npz`` holding
    each leaf under its path with ``/`` spelt ``__`` (here one host, the
    whole leaf);
  * a leaf numpy's npz cannot hold (bf16) is stored as its lossless f32
    upcast, and the manifest keeps its own dtype; restore casts back;
  * conv weights are stored in the reference's HWIO layout and restored to
    the port's OIHW (``bridge.is_conv_weight``);
  * a ``step_<N>/META.json`` manifest is written LAST and atomically
    (tmp + rename) — a step directory without META is incomplete and
    ignored, so a crash mid-write is never resumed from; the
    ``ckpt_crash`` fault dies between the shard and META;
  * ``latest_step`` scans for the newest COMPLETE step;
  * ``restore`` places the leaves on ``device`` in the dtypes of ``like``.
    Elastic placement on a mesh (``sharding_fn``) needs the distribution
    layer and raises "not ported yet".

The train loop's unlearn journal (``journal_append`` / ``journal_read``)
is here too. Serving durability lives in ``repro_torch.robust.wal``
(per-tenant forget WALs, replayed by ``Fleet.recover``).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.api.specs import MESH_ITEM, _not_ported
from repro_torch.bridge import (_HWIO_TO_OIHW, _OIHW_TO_HWIO,
                                is_conv_weight)
from repro_torch.device import resolve_device
from repro_torch.models.module import flatten_with_paths, tree_unflatten

Params = Any


def _leaf_key(path: str) -> str:
    return path.replace("/", "__")


# dtypes numpy's npz holds as they are; any other (bf16) is stored as its
# lossless f32 upcast, as the reference stores what numpy cannot hold
_NUMPY_DTYPES = (torch.float16, torch.float32, torch.float64, torch.int8,
                 torch.int16, torch.int32, torch.int64, torch.uint8,
                 torch.bool)


def _to_host(path: str, leaf):
    """(array as stored, the leaf's dtype name) in the reference's layout."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        arr = (t if t.dtype in _NUMPY_DTYPES else t.float()).cpu().numpy()
        if is_conv_weight(path, arr.ndim):
            arr = np.ascontiguousarray(arr.transpose(_OIHW_TO_HWIO))
        # numpy's name of the dtype ('bfloat16', as ml_dtypes names it)
        return arr, str(t.dtype).replace("torch.", "")
    arr = np.asarray(leaf)
    name = str(arr.dtype)
    if arr.dtype.kind not in "fiub" or name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr, name


def save(ckpt_dir: str, step: int, tree: Params, *, host_id: int = 0,
         n_hosts: int = 1, extra_meta: Optional[Dict] = None) -> str:
    """Write one checkpoint step atomically. Returns the step directory."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(step_dir, exist_ok=True)
    arrays = {}
    manifest: List[Dict] = []
    for path, leaf in flatten_with_paths(tree):
        arr, dtype_name = _to_host(path, leaf)
        arrays[_leaf_key(path)] = arr
        manifest.append({"path": path, "shape": list(arr.shape),
                         "dtype": dtype_name})
    shard_path = os.path.join(step_dir, f"host_{host_id}.npz")
    with tempfile.NamedTemporaryFile(dir=step_dir, suffix=".tmp",
                                     delete=False) as f:
        np.savez(f, **arrays)
        tmp = f.name
    os.replace(tmp, shard_path)

    from repro_torch.robust import faults as _faults
    if _faults.fire("ckpt_crash"):
        # chaos: die between the shard write and the META commit point —
        # the step dir is incomplete and latest_step must skip it
        raise RuntimeError(
            f"injected ckpt_crash: shard written but META.json withheld "
            f"for step {step} ({step_dir})")

    if host_id == 0:
        meta = {"step": step, "n_hosts": n_hosts, "time": time.time(),
                "manifest": manifest, **(extra_meta or {})}
        with tempfile.NamedTemporaryFile("w", dir=step_dir, suffix=".tmp",
                                         delete=False) as f:
            json.dump(meta, f)
            tmp = f.name
        os.replace(tmp, os.path.join(step_dir, "META.json"))  # commit point
    return step_dir


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest step with a committed META.json (incomplete steps skipped)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, name, "META.json")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _torch_dtype(leaf) -> torch.dtype:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    return torch.from_numpy(np.zeros((), np.asarray(leaf).dtype)).dtype


def restore(ckpt_dir: str, step: int, like: Params, *,
            sharding_fn: Optional[Callable[[str], Any]] = None,
            host_id: int = 0, device="cuda"):
    """Restore into the structure and dtypes of ``like`` as tensors on
    ``device`` (raises without a card unless device="cpu"). Returns
    ``(tree, meta)``."""
    if sharding_fn is not None:
        raise _not_ported("restore(sharding_fn=...) (elastic placement on a "
                          "mesh)", MESH_ITEM)
    dev = resolve_device(device)
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(step_dir, "META.json")) as f:
        meta = json.load(f)
    out = []
    with np.load(os.path.join(step_dir, f"host_{host_id}.npz")) as data:
        for path, leaf in flatten_with_paths(like):
            arr = data[_leaf_key(path)]
            if is_conv_weight(path, arr.ndim):
                arr = arr.transpose(_HWIO_TO_OIHW)
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"checkpoint leaf {path!r} has shape {tuple(arr.shape)} "
                    f"but the model expects {tuple(leaf.shape)} — the "
                    "checkpoint was written for a different "
                    "architecture/shape")
            t = torch.from_numpy(arr).contiguous()
            out.append(t.to(_torch_dtype(leaf)).to(dev))
    # flatten_with_paths and tree_unflatten share the sorted-key order
    return tree_unflatten(like, out), meta


def gc_old(ckpt_dir: str, keep: int = 3) -> None:
    """Keep the newest ``keep`` complete steps; delete the rest."""
    if not os.path.isdir(ckpt_dir):
        return
    complete = sorted(
        n for n in os.listdir(ckpt_dir)
        if n.startswith("step_") and os.path.exists(
            os.path.join(ckpt_dir, n, "META.json")))
    for name in complete[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


# ---------------------------------------------------------------------------
# Train-loop unlearn journal (the train launcher's restart record).  NOT the
# serving stack's durability story: forget requests go through the
# per-tenant ``repro_torch.robust.wal.ForgetWAL`` (accept/apply/dead ops +
# Fleet.recover).
# ---------------------------------------------------------------------------
def journal_append(ckpt_dir: str, record: Dict) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "unlearn_journal.jsonl")
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
        f.flush()
        os.fsync(f.fileno())


def journal_read(ckpt_dir: str) -> List[Dict]:
    path = os.path.join(ckpt_dir, "unlearn_journal.jsonl")
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
