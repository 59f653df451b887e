"""Per-cell specs of the dry run (port of ``repro.launch.specs``): for every
(architecture x input-shape) pair, the step function, its abstract
arguments and their layouts on the production mesh.

A cell's arguments are meta tensors (shape and dtype, no storage) with the
reference's global shapes and dtypes; ``eval_shape`` builds them as
``jax.eval_shape`` does, by running the init function under
``FakeTensorMode`` (no draw, no allocation: the initialisers' ``gen=None``
form). Layouts are the port's ``P`` trees from ``repro_torch.dist.
sharding``, where the reference has ``NamedSharding``s. The step functions
are the port's own: ``optim.make_train_step`` over ``lm_loss``,
``LM.forward(..., last_only=True)``, ``LM.prefill_block``,
``LM.decode_step`` and their ``models.encdec`` counterparts.

``launch.dryrun`` runs a cell's function on one rank's share of the batch
and counts what it does.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import SHAPES, ArchSpec, ShapeCell
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import P
from repro_torch.models import encdec as ED
from repro_torch.models import lm as LM
from repro_torch.models.module import flatten_with_paths, tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, init_adamw, make_train_step

I32 = torch.int32
BF16 = torch.bfloat16

# Tokens per serving-prefill dispatch (the block LM.prefill consumes); the
# prefill_chunked cell runs exactly one such block against the full cache.
CHUNKED_PREFILL_BLOCK = 512


@dataclasses.dataclass
class CellSpec:
    name: str
    fn: Callable
    args: Tuple[Any, ...]          # meta tensors (trees), global shapes
    in_shardings: Tuple[Any, ...]  # P trees
    out_shardings: Any
    donate_argnums: Tuple[int, ...]
    model_flops: float             # 6*N*D (dense) / 6*N_active*D (MoE) per step
    n_params: int
    n_active_params: int
    # the reference's global FLOPs that XLA's cost analysis misses inside
    # sequential scans (the sLSTM's time loop, the mLSTM's chunk loop).
    # Kept for the record: the port's eager program runs every step, so its
    # count already holds them and the dry run never adds this.
    scan_correction_flops: float = 0.0


# ---------------------------------------------------------------------------
# The abstract build
# ---------------------------------------------------------------------------
def _meta_like(tree):
    """Every tensor of ``tree`` as a meta tensor of its shape and dtype."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta")
                    if isinstance(t, torch.Tensor) else t, tree)


def eval_shape(fn: Callable, *args, **kw):
    """``fn(*args, **kw)`` run under ``FakeTensorMode`` on the host, its
    result as meta tensors: the tree it builds, shape for shape and dtype
    for dtype, with nothing allocated (``jax.eval_shape``). Init functions
    take ``gen=None`` here (no draw) and ``device="cpu"``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        out = fn(*args, **kw)
    return _meta_like(out)


@functools.lru_cache(maxsize=32)
def _abstract_params_cached(cfg):
    if isinstance(cfg, ED.EncDecConfig):
        return eval_shape(ED.init_encdec, None, cfg, device="cpu")
    return eval_shape(LM.init_lm, None, cfg, device="cpu")


def abstract_params(cfg) -> Dict:
    """The parameter tree ``init_lm`` / ``init_encdec`` builds for ``cfg``,
    as meta tensors (cached by config; a new dict tree every call)."""
    return _meta_like(_abstract_params_cached(cfg))


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _slstm_correction(cfg: LM.LMConfig, cell: ShapeCell) -> float:
    """The reference's global FLOPs inside sequential scans that XLA's cost
    analysis counts only once: the sLSTM time recurrence and the mLSTM
    inter-chunk state scan."""
    B = cell.global_batch
    S = cell.seq_len if cell.kind in ("train", "prefill") else 1
    if cell.kind == "prefill_chunked":
        S = CHUNKED_PREFILL_BLOCK
    if S <= 1:
        return 0.0
    mult = 3.0 if cell.kind == "train" else 1.0
    D = cfg.d_model
    total = 0.0

    n_slstm = sum(1 for t in cfg.layer_types if t == "slstm")
    if n_slstm:
        dh = D // cfg.n_heads
        step_flops = 2 * B * (4 * D * D + 4 * D * dh + D * D)
        total += n_slstm * (S - 1) * step_flops * mult

    n_mlstm = sum(1 for t in cfg.layer_types if t == "mlstm")
    if n_mlstm:
        H, Dh, Ck = cfg.n_heads, cfg.dh, cfg.mlstm_chunk
        nC = -(-S // Ck)
        trip = 2 * B * H * (2 * Ck * Ck * Dh + 2 * Ck * Dh * Dh + Dh * Dh)
        total += n_mlstm * max(0, nC - 1) * trip * mult
    return total


def _param_counts(cfg) -> Tuple[int, int]:
    """(total params, activated params per token) from abstract shapes."""
    shapes = _abstract_params_cached(cfg)
    total = sum(x.numel() for x in tree_leaves(shapes))
    if isinstance(cfg, ED.EncDecConfig) or cfg.moe is None:
        return total, total
    expert = sum(leaf.numel() for key, leaf in flatten_with_paths(shapes)
                 if "ffn/w_" in key and "shared" not in key)
    active = total - expert + expert * cfg.moe.top_k / cfg.moe.num_experts
    return total, int(active)


def _model_flops(cfg, cell: ShapeCell, n_active: int) -> float:
    """MODEL_FLOPS = 6*N_active*D for train; 2*N_active*D for inference."""
    if cell.kind == "prefill_chunked":
        tokens = cell.global_batch * CHUNKED_PREFILL_BLOCK  # one block
    else:
        tokens = cell.global_batch * (cell.seq_len
                                      if cell.kind in ("train", "prefill")
                                      else 1)
    mult = 6.0 if cell.kind == "train" else 2.0
    return mult * n_active * tokens


def _adam_specs(p_specs) -> Any:
    from repro_torch.optim.adamw import AdamState
    return AdamState(step=P(), mu=p_specs, nu=p_specs)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------
def _lm_cell(spec: ArchSpec, cell: ShapeCell, mesh, unroll: bool = False,
             batch_split: int = 1) -> CellSpec:
    cfg: LM.LMConfig = spec.full
    B, S = cell.global_batch, cell.seq_len
    dp = shd.dp_size(mesh)
    if unroll:
        cfg = cfg.with_(unroll_layers=True)

    if cfg.moe is not None:
        tokens = B * (S if cell.kind in ("train", "prefill") else 1)
        # blocks: a multiple of the token-sharding device count (a local
        # cumsum per shard) and small enough that the [Tb*K, E] position
        # tensor stays ~100 MB a block (the reference's rule)
        shards = dp * mesh.shape["model"] if cfg.parallelism == "fsdp" \
            else dp
        nb = shards if tokens % shards == 0 and tokens >= shards else \
            (dp if tokens % dp == 0 and tokens >= dp else 1)
        while tokens // nb > 8192 and tokens % (nb * 2) == 0:
            nb *= 2
        # one rank of a batch split batch_split ways holds its share of
        # the blocks
        if batch_split > 1:
            nb = nb // batch_split if nb % batch_split == 0 else 1
        cfg = cfg.with_(dispatch_blocks=nb)
    if cell.kind == "train":
        cfg = cfg.with_(remat=True)

    p_shapes = abstract_params(cfg)
    p_specs = shd.param_pspecs(p_shapes, mesh, mode=cfg.parallelism)
    n_total, n_active = _param_counts(spec.full)
    mflops = _model_flops(cfg, cell, n_active)

    S_tok = S - cfg.prefix_len if cfg.prefix_len else S
    tok_spec = shd.batch_pspec(mesh, B, 2, mode=cfg.parallelism)
    prefix_sds = prefix_spec = None
    if cfg.prefix_len:
        prefix_sds = _sds((B, cfg.prefix_len, cfg.d_model), BF16)
        prefix_spec = shd.batch_pspec(mesh, B, 3, mode=cfg.parallelism)
    name = f"{spec.arch_id}:{cell.name}"

    if cell.kind == "train":
        ocfg = AdamWConfig(state_dtype=torch.float32)
        o_shapes = eval_shape(init_adamw, ocfg, p_shapes)

        if cfg.prefix_len:
            def loss_fn(p, batch):
                return LM.lm_loss(p, cfg, batch["tokens"], batch["labels"],
                                  prefix=batch["prefix"])
        else:
            def loss_fn(p, batch):
                return LM.lm_loss(p, cfg, batch["tokens"], batch["labels"])
        step = make_train_step(loss_fn, ocfg)

        batch_sds = {"tokens": _sds((B, S_tok), I32),
                     "labels": _sds((B, S_tok), I32)}
        batch_sh = {"tokens": tok_spec, "labels": tok_spec}
        if prefix_sds is not None:
            batch_sds["prefix"] = prefix_sds
            batch_sh["prefix"] = prefix_spec
        o_sh = _adam_specs(p_specs)
        return CellSpec(
            name=name, fn=step, args=(p_shapes, o_shapes, batch_sds),
            in_shardings=(p_specs, o_sh, batch_sh),
            out_shardings=(p_specs, o_sh, None),
            donate_argnums=(0, 1), model_flops=mflops,
            n_params=n_total, n_active_params=n_active,
            scan_correction_flops=_slstm_correction(cfg, cell))

    if cell.kind == "prefill":
        def prefill(p, tokens, prefix=None):
            logits, _ = LM.forward(p, cfg, tokens, prefix, last_only=True)
            return logits[:, 0]

        args = [p_shapes, _sds((B, S_tok), I32)]
        in_sh = [p_specs, tok_spec]
        if prefix_sds is not None:
            fn = lambda p, t, px: prefill(p, t, px)  # noqa: E731
            args.append(prefix_sds)
            in_sh.append(prefix_spec)
        else:
            fn = lambda p, t: prefill(p, t)  # noqa: E731
        return CellSpec(
            name=name, fn=fn, args=tuple(args), in_shardings=tuple(in_sh),
            out_shardings=None, donate_argnums=(), model_flops=mflops,
            n_params=n_total, n_active_params=n_active,
            scan_correction_flops=_slstm_correction(cfg, cell))

    if cell.kind == "prefill_chunked":
        # the serving prefill program (launch/serve.py::generate): ONE
        # LM.prefill_block chunk of C tokens against the full decode cache
        C = min(CHUNKED_PREFILL_BLOCK, S)
        cache_shapes = eval_shape(LM.init_cache, cfg, B, S, device="cpu")
        cache_specs = shd.cache_pspecs(cache_shapes, mesh, B)
        # LM.prefill's mode choice: wide when no attention cache can wrap
        # over the full prompt, token by token otherwise
        attn_sizes = [S if bt == "attn" else min(S, cfg.window)
                      for bt in cfg.layer_types if bt in ("attn", "local")]
        wide = S <= min(attn_sizes) if attn_sizes else True

        def prefill_chunk(p, cache, tokens, pos0):
            return LM.prefill_block(p, cfg, tokens, cache, pos0, wide, True)

        return CellSpec(
            name=name, fn=prefill_chunk,
            args=(p_shapes, cache_shapes, _sds((B, C), I32), _sds((), I32)),
            in_shardings=(p_specs, cache_specs, tok_spec, P()),
            out_shardings=(None, cache_specs), donate_argnums=(1,),
            model_flops=mflops, n_params=n_total, n_active_params=n_active,
            scan_correction_flops=_slstm_correction(cfg, cell))

    # decode / long_decode: one new token against a seq_len cache
    cache_shapes = eval_shape(LM.init_cache, cfg, B, S, device="cpu")
    cache_specs = shd.cache_pspecs(cache_shapes, mesh, B)
    tok1_spec = shd.batch_pspec(mesh, B, 2)

    def decode(p, cache, token, pos):
        return LM.decode_step(p, cfg, token, cache, pos)

    return CellSpec(
        name=name, fn=decode,
        args=(p_shapes, cache_shapes, _sds((B, 1), I32), _sds((), I32)),
        in_shardings=(p_specs, cache_specs, tok1_spec, P()),
        out_shardings=(None, cache_specs), donate_argnums=(1,),
        model_flops=mflops, n_params=n_total, n_active_params=n_active)


# ---------------------------------------------------------------------------
# Encoder-decoder cells (whisper)
# ---------------------------------------------------------------------------
def _encdec_cell(spec: ArchSpec, cell: ShapeCell, mesh,
                 unroll: bool = False) -> CellSpec:
    cfg: ED.EncDecConfig = spec.full
    B, S = cell.global_batch, cell.seq_len
    if unroll:
        cfg = cfg.with_(unroll_layers=True)
    p_shapes = abstract_params(cfg)
    p_specs = shd.param_pspecs(p_shapes, mesh)
    n_total, n_active = _param_counts(cfg)
    mflops = _model_flops(cfg, cell, n_active)
    name = f"{spec.arch_id}:{cell.name}"

    if cell.kind == "prefill_chunked":
        raise ValueError(f"{spec.arch_id} skips {cell.name}: "
                         "chunked prefill cell is LM-only")
    tok_spec = shd.batch_pspec(mesh, B, 2)
    frames_sds = _sds((B, cfg.n_frames, cfg.d_model), BF16)
    frames_sh = shd.batch_pspec(mesh, B, 3)

    if cell.kind == "train":
        ocfg = AdamWConfig(state_dtype=torch.float32)
        o_shapes = eval_shape(init_adamw, ocfg, p_shapes)

        def loss_fn(p, batch):
            return ED.lm_loss(p, cfg, batch["tokens"], batch["labels"],
                              batch["frames"])
        step = make_train_step(loss_fn, ocfg)
        batch_sds = {"tokens": _sds((B, S), I32),
                     "labels": _sds((B, S), I32), "frames": frames_sds}
        batch_sh = {"tokens": tok_spec, "labels": tok_spec,
                    "frames": frames_sh}
        o_sh = _adam_specs(p_specs)
        return CellSpec(
            name=name, fn=step, args=(p_shapes, o_shapes, batch_sds),
            in_shardings=(p_specs, o_sh, batch_sh),
            out_shardings=(p_specs, o_sh, None),
            donate_argnums=(0, 1), model_flops=mflops,
            n_params=n_total, n_active_params=n_active)

    if cell.kind == "prefill":
        def prefill(p, tokens, frames):
            return ED.forward(p, cfg, tokens, frames)[:, -1]
        return CellSpec(
            name=name, fn=prefill,
            args=(p_shapes, _sds((B, S), I32), frames_sds),
            in_shardings=(p_specs, tok_spec, frames_sh),
            out_shardings=None, donate_argnums=(),
            model_flops=mflops, n_params=n_total, n_active_params=n_active)

    cache_shapes = eval_shape(ED.init_cache, cfg, B, S, device="cpu")
    cache_specs = shd.cache_pspecs(cache_shapes, mesh, B)

    def decode(p, cache, token, pos, memory):
        return ED.decode_step(p, cfg, token, cache, pos, memory)

    tok1_spec = shd.batch_pspec(mesh, B, 2)
    return CellSpec(
        name=name, fn=decode,
        args=(p_shapes, cache_shapes, _sds((B, 1), I32), _sds((), I32),
              _sds((B, cfg.n_frames, cfg.d_model), BF16)),
        in_shardings=(p_specs, cache_specs, tok1_spec, P(), frames_sh),
        out_shardings=(None, cache_specs), donate_argnums=(1,),
        model_flops=mflops, n_params=n_total, n_active_params=n_active)


def build_cell(spec: ArchSpec, shape_name: str, mesh,
               variant: str = "full", overrides: Optional[Dict] = None, *,
               batch_split: int = 1) -> CellSpec:
    """variant:
      "full"    the production program;
      "probe1"  1 pattern period (+ the tail);
      "probe2"  2 pattern periods (+ the tail).
    The reference extrapolates its probes' cost affinely over the periods,
    Cost(P) = probe1 + (P - 1) * (probe2 - probe1); the port's dry run
    counts the full program directly (its loops are eager) and builds the
    probes for the same record. ``mesh`` needs only ``.shape`` (axis name
    -> extent). ``batch_split``: the program of one rank of a batch split
    that many ways (an MoE's dispatch blocks are the rank's share); the
    arguments stay global.
    """
    cell = SHAPES[shape_name]
    if shape_name in spec.skip_shapes:
        raise ValueError(f"{spec.arch_id} skips {shape_name}: "
                         f"{spec.skip_shapes[shape_name]}")
    if overrides:
        spec = dataclasses.replace(spec, full=spec.full.with_(**overrides))
    if variant != "full":
        k = 1 if variant == "probe1" else 2
        spec = dataclasses.replace(spec, full=_shrink(spec.full, k))
    unroll = variant != "full"
    if spec.kind == "encdec":
        return _encdec_cell(spec, cell, mesh, unroll)
    return _lm_cell(spec, cell, mesh, unroll, batch_split)


def _shrink(cfg, k: int):
    """Config with k pattern periods (+ the full config's tail layers)."""
    if isinstance(cfg, ED.EncDecConfig):
        return cfg.with_(n_enc_layers=k, n_dec_layers=k)
    period = len(cfg.block_pattern)
    return cfg.with_(n_layers=k * period + cfg.n_tail)


def n_periods_of(spec: ArchSpec) -> int:
    """The P of the reference's affine extrapolation."""
    if spec.kind == "encdec":
        return spec.full.n_dec_layers   # enc and dec scale together
    return spec.full.n_periods
