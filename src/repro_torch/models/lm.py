"""Causal decoder LM of the port: ``repro.models.lm``.

Layer pattern
-------------
``LMConfig.block_pattern`` is a tuple of block types cycled over the depth,
e.g. ``("local",) * 5 + ("attn",)`` for gemma3's 5:1 local:global mix, or
``("rglru", "rglru", "local")`` for RecurrentGemma. Block types:

  attn        full causal GQA self-attention + FFN
  local       sliding-window causal attention + FFN
  mlstm       xLSTM matrix-memory block (+ FFN when d_ff > 0)
  slstm       xLSTM scalar-memory block (+ FFN when d_ff > 0)
  rglru       Griffin RG-LRU recurrent block (+ FFN when d_ff > 0)

The FFN is the dense SwiGLU unless ``moe`` is set; then every block's FFN
is the token-choice top-k mixture of experts (``layers.moe_ffn``), whose
load-balancing aux loss ``forward`` sums over the blocks and ``lm_loss``
adds at ``aux_weight``. With ``prefix_len > 0`` a stub modality prefix
(precomputed frame or patch embeddings [B, P, d_model]) goes ahead of the
token embeddings, and ``lm_loss`` scores the token positions only.

Execution modes
---------------
* ``forward``      the whole sequence (training, the forget request);
* ``decode_step``  one token per row against per-block caches
  (``init_cache``: KV caches, ring buffers for sliding windows, the
  recurrent blocks' O(1) states), at one position or a position per row;
  ``scatter_cache_rows`` writes a smaller batch's caches into a pool;
* ``prefill``      a prompt [B, P] in chunks against the same caches: an
  attention block with a dense FFN takes a chunk in one wide product when
  no cache can wrap (``attention_prefill``), every other block steps
  through the chunk token by token with ``block_decode``.

Context-parallel attention and the MoE's expert-parallel sharding
constraints are not ported yet: a config that asks for one raises a
``ValueError`` that says so. ``LMConfig`` keeps every field of the
reference, so that configs copy over unchanged.

Parameters keep the reference's layout and keys: ``period_stack`` holds the
blocks of the ``n_periods`` whole pattern periods, each leaf stacked
``[n_periods, ...]`` (an MoE block's expert stacks [n_periods, E, d, f]);
``tail`` the blocks past them; then ``embed``, ``final_norm`` and, without
tied embeddings, ``lm_head``. A cache tree has the same ``period_stack`` /
``tail`` layout (its stacked leaves [n_periods, B, ...]). ``forward``,
``decode_step`` and ``prefill_block`` walk the periods in a Python loop
where the reference scans them.

The unlearn-layer view (``get_layer`` / ``set_layer`` / ``apply_layer``) is
what the FiCABU engine edits: depth j = 0 is the embedding, j = 1..n_layers
the blocks, j = n_layers + 1 the head (the final norm, and ``lm_head``
unless tied). ``get_layer`` of a stacked block returns views into the
stacked leaves; ``set_layer`` returns a new tree whose stacked leaves are
new tensors, leaving the caller's dicts and tensors untouched, as the
reference's ``.at[i].set`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.device import resolve_device

from . import layers as L
from . import recurrent as R
from .module import (Params, dense_init, embed_init, index_tree, tree_leaves,
                     tree_map, tree_unflatten)
from .vision import _logsumexp

F32 = torch.float32
PORTED_BLOCKS = ("attn", "local", "mlstm", "slstm", "rglru")


def _not_ported(what: str) -> ValueError:
    return ValueError(f"{what} is not ported yet: the port builds the "
                      f"decoder LM's block types {PORTED_BLOCKS} with the "
                      f"SwiGLU or MoE FFN; see ROADMAP.md Queue 1")


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    shared_ff: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0
    block_pattern: Tuple[str, ...] = ("attn",)
    window: int = 1024
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    moe: Optional[MoESpec] = None
    d_rnn: int = 0                 # RG-LRU recurrence width (0 -> 4*d_model//3)
    mlstm_chunk: int = 128
    prefix_len: int = 0            # stub modality tokens (VLM / audio)
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    sub_quadratic: bool = False    # eligible for long_500k
    dispatch_blocks: int = 1       # MoE local-capacity blocks
    remat: bool = False            # activation checkpointing (no numeric effect)
    cp_attention: int = 0          # context-parallel attention segments
    moe_shard_constraints: bool = False
    parallelism: str = "tp"
    unroll_layers: bool = False    # the port always walks the periods in Python

    # ---- derived ----
    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def layer_types(self) -> Tuple[str, ...]:
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def n_tail(self) -> int:
        return self.n_layers % len(self.block_pattern)

    def attn_cfg(self, btype: str) -> L.AttnConfig:
        if self.cp_attention > 1:
            raise _not_ported(f"{self.name}: context-parallel attention "
                              f"(cp_attention={self.cp_attention})")
        return L.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.dh,
            qkv_bias=self.qkv_bias, rope_theta=self.rope_theta,
            use_rope=True, causal=True,
            window=self.window if btype == "local" else 0)

    def mlstm_cfg(self) -> R.MLSTMConfig:
        return R.MLSTMConfig(self.d_model, self.n_heads, self.dh,
                             self.mlstm_chunk)

    def slstm_cfg(self) -> R.SLSTMConfig:
        return R.SLSTMConfig(self.d_model, self.n_heads)

    def rglru_cfg(self) -> R.RGLRUConfig:
        d_rnn = self.d_rnn or (4 * self.d_model) // 3
        d_rnn = -(-d_rnn // 8) * 8
        return R.RGLRUConfig(self.d_model, d_rnn)

    def moe_cfg(self) -> L.MoEConfig:
        if self.moe is None:
            raise ValueError(
                f"{self.name}: moe_cfg() called but this LMConfig has no "
                "MoE spec (moe=None)")
        return L.MoEConfig(
            d_model=self.d_model, d_ff=self.d_ff,
            num_experts=self.moe.num_experts, top_k=self.moe.top_k,
            capacity_factor=self.moe.capacity_factor,
            shared_ff=self.moe.shared_ff,
            dispatch_blocks=self.dispatch_blocks,
            shard_constraints=self.moe_shard_constraints)

    def with_(self, **kw) -> "LMConfig":
        return dataclasses.replace(self, **kw)


def _check_block(cfg: LMConfig, btype: str) -> None:
    if btype not in PORTED_BLOCKS:
        raise _not_ported(f"{cfg.name}: block type {btype!r}")
    if btype in ("attn", "local"):
        cfg.attn_cfg(btype)
    if cfg.moe is not None and cfg.moe_shard_constraints:
        raise L._moe_not_ported()


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def init_block(gen: torch.Generator, cfg: LMConfig, btype: str, *,
               device) -> Params:
    _check_block(cfg, btype)
    kw = dict(device=device, dtype=cfg.dtype)
    p: Params = {"ln1": L.init_rmsnorm(cfg.d_model, **kw)}
    if btype in ("attn", "local"):
        p["mixer"] = L.init_attention(gen, cfg.attn_cfg(btype), **kw)
    elif btype == "mlstm":
        p["mixer"] = R.init_mlstm(gen, cfg.mlstm_cfg(), **kw)
    elif btype == "slstm":
        p["mixer"] = R.init_slstm(gen, cfg.slstm_cfg(), **kw)
    else:
        p["mixer"] = R.init_rglru(gen, cfg.rglru_cfg(), **kw)
    if cfg.d_ff > 0:
        p["ln2"] = L.init_rmsnorm(cfg.d_model, **kw)
        p["ffn"] = (L.init_moe(gen, cfg.moe_cfg(), **kw) if cfg.moe
                    else L.init_mlp(gen, cfg.d_model, cfg.d_ff, **kw))
    return p


def block_forward(p: Params, cfg: LMConfig, btype: str, x: torch.Tensor,
                  positions: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x_out, moe_aux_loss); the aux loss is 0 without MoE."""
    _check_block(cfg, btype)
    h = L.rmsnorm(p["ln1"], x)
    if btype in ("attn", "local"):
        m = L.attention(p["mixer"], cfg.attn_cfg(btype), h, positions)
    elif btype == "mlstm":
        m = R.mlstm_forward(p["mixer"], cfg.mlstm_cfg(), h)
    elif btype == "slstm":
        m = R.slstm_forward(p["mixer"], cfg.slstm_cfg(), h)
    else:
        m = R.rglru_forward(p["mixer"], cfg.rglru_cfg(), h)
    x = x + m
    aux = torch.zeros((), dtype=F32, device=x.device)
    if cfg.d_ff > 0:
        h = L.rmsnorm(p["ln2"], x)
        if cfg.moe:
            f, aux = L.moe_ffn(p["ffn"], cfg.moe_cfg(), h)
        else:
            f = L.mlp(p["ffn"], h)
        x = x + f
    return x, aux


def init_block_cache(cfg: LMConfig, btype: str, batch: int, seq_len: int,
                     *, device) -> Any:
    """A block's decode cache: the KV cache of an attention block, the
    state of a recurrent one."""
    _check_block(cfg, btype)
    if btype in ("attn", "local"):
        return L.init_kv_cache(cfg.attn_cfg(btype), batch, seq_len,
                               cfg.dtype, device=device)
    if btype == "mlstm":
        return R.init_mlstm_state(cfg.mlstm_cfg(), batch, device=device)
    if btype == "slstm":
        return R.init_slstm_state(cfg.slstm_cfg(), batch, device=device)
    return R.init_rglru_state(cfg.rglru_cfg(), batch, cfg.dtype,
                              device=device)


def block_decode(p: Params, cfg: LMConfig, btype: str, x: torch.Tensor,
                 cache: Any, pos) -> Tuple[torch.Tensor, Any]:
    """One token per row, x [B, 1, D], at ``pos`` (a scalar or [B]) ->
    (x_out, the block's new cache)."""
    _check_block(cfg, btype)
    h = L.rmsnorm(p["ln1"], x)
    if btype in ("attn", "local"):
        m, cache = L.attention_decode(p["mixer"], cfg.attn_cfg(btype), h,
                                      cache, pos)
    elif btype == "mlstm":
        m, cache = R.mlstm_decode(p["mixer"], cfg.mlstm_cfg(), h, cache)
    elif btype == "slstm":
        m, cache = R.slstm_decode(p["mixer"], cfg.slstm_cfg(), h, cache)
    else:
        m, cache = R.rglru_decode(p["mixer"], cfg.rglru_cfg(), h, cache)
    x = x + m
    if cfg.d_ff > 0:
        h = L.rmsnorm(p["ln2"], x)
        if cfg.moe:
            f, _ = L.moe_ffn(p["ffn"], cfg.moe_cfg(), h)
        else:
            f = L.mlp(p["ffn"], h)
        x = x + f
    return x, cache


def _stack(trees: List[Any]) -> Any:
    """Trees of one structure -> one tree of their leaves stacked on a new
    leading axis."""
    return tree_unflatten(trees[0], [
        torch.stack(xs) for xs in zip(*(tree_leaves(t) for t in trees))])


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------
def init_lm(gen: torch.Generator, cfg: LMConfig, *, device="cuda") -> Params:
    """Random parameters drawn from ``gen`` on its own device and placed on
    ``device`` (raises without a card unless device="cpu"), in the
    reference's layout."""
    device = resolve_device(device)
    for bt in cfg.layer_types:
        _check_block(cfg, bt)
    dt = cfg.dtype
    pat = cfg.block_pattern
    periods = [{str(i): init_block(gen, cfg, bt, device=device)
                for i, bt in enumerate(pat)} for _ in range(cfg.n_periods)]
    tail = [init_block(gen, cfg, cfg.layer_types[cfg.n_periods * len(pat) + i],
                       device=device) for i in range(cfg.n_tail)]
    p: Params = {
        "embed": {"w": embed_init(gen, cfg.vocab, cfg.d_model, device=device,
                                  dtype=dt)},
        "final_norm": L.init_rmsnorm(cfg.d_model, device=device, dtype=dt),
    }
    if periods:
        p["period_stack"] = _stack(periods)
    if tail:
        p["tail"] = {str(i): t for i, t in enumerate(tail)}
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": dense_init(gen, cfg.d_model, cfg.vocab,
                                        device=device, dtype=dt)}
    return p


def _embed(params: Params, cfg: LMConfig, tokens: torch.Tensor,
           prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings, after the stub modality prefix [B, P, d_model]
    when ``prefix_len > 0`` (a prefix is ignored otherwise, as in the
    reference)."""
    x = params["embed"]["w"].to(cfg.dtype)[tokens]
    if cfg.prefix_len > 0:
        if prefix is None:
            raise ValueError(
                f"{cfg.name} has prefix_len={cfg.prefix_len} and requires a "
                "stub modality prefix; got prefix=None")
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
    return x


def _head(params: Params, cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    """f32 logits: the product runs on f32 copies, as the reference asks
    XLA for an f32 result of its bf16 operands."""
    x = L.rmsnorm(params["final_norm"], x)
    w = (params["embed"]["w"].t() if cfg.tie_embeddings
         else params["lm_head"]["w"])
    return x.to(F32) @ w.to(x.dtype).to(F32)


def _positions(x: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[0], x.shape[1]
    return torch.arange(S, device=x.device)[None].expand(B, S)


def forward(params: Params, cfg: LMConfig, tokens: torch.Tensor,
            prefix: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S', V] f32, moe_aux scalar); S' = S
    plus the prefix's positions when ``prefix_len > 0``."""
    x = _embed(params, cfg, tokens, prefix)
    positions = _positions(x)
    aux_total = torch.zeros((), dtype=F32, device=x.device)
    pat = cfg.block_pattern
    if "period_stack" in params:
        for pi in range(cfg.n_periods):
            period_p = index_tree(params["period_stack"], pi)
            for i, bt in enumerate(pat):
                x, aux = block_forward(period_p[str(i)], cfg, bt, x,
                                       positions)
                aux_total = aux_total + aux
    if "tail" in params:
        base = cfg.n_periods * len(pat)
        for i in range(cfg.n_tail):
            x, aux = block_forward(params["tail"][str(i)], cfg,
                                   cfg.layer_types[base + i], x, positions)
            aux_total = aux_total + aux
    return _head(params, cfg, x), aux_total


# ---------------------------------------------------------------------------
# Decode: caches and one token per row
# ---------------------------------------------------------------------------
def init_cache(cfg: LMConfig, batch: int, seq_len: int, *,
               device="cuda") -> Params:
    """Zeroed decode caches of every block for ``batch`` rows of up to
    ``seq_len`` positions, in the parameters' layout (raises without a
    card unless device="cpu")."""
    device = resolve_device(device)
    pat = cfg.block_pattern
    cache: Params = {}
    if cfg.n_periods > 0:
        period = {str(i): init_block_cache(cfg, bt, batch, seq_len,
                                           device=device)
                  for i, bt in enumerate(pat)}
        cache["period_stack"] = tree_map(
            lambda x: x[None].expand(cfg.n_periods, *x.shape).clone(),
            period)
    if cfg.n_tail:
        base = cfg.n_periods * len(pat)
        cache["tail"] = {str(i): init_block_cache(
            cfg, cfg.layer_types[base + i], batch, seq_len, device=device)
            for i in range(cfg.n_tail)}
    return cache


def _walk(params: Params, cfg: LMConfig, x: torch.Tensor, cache: Params,
          step) -> Tuple[torch.Tensor, Params]:
    """``step(block_p, btype, x, block_cache) -> (x, new block cache)``
    over every block, front to back: the new cache tree."""
    pat = cfg.block_pattern
    new_cache: Params = {}
    if "period_stack" in params:
        outs = []
        for pi in range(cfg.n_periods):
            period_p = index_tree(params["period_stack"], pi)
            period_c = index_tree(cache["period_stack"], pi)
            new_c = {}
            for i, bt in enumerate(pat):
                x, new_c[str(i)] = step(period_p[str(i)], bt, x,
                                        period_c[str(i)])
            outs.append(new_c)
        new_cache["period_stack"] = _stack(outs)
    if "tail" in params:
        base = cfg.n_periods * len(pat)
        new_cache["tail"] = {}
        for i in range(cfg.n_tail):
            x, new_cache["tail"][str(i)] = step(
                params["tail"][str(i)], cfg.layer_types[base + i], x,
                cache["tail"][str(i)])
    return x, new_cache


def decode_step(params: Params, cfg: LMConfig, token: torch.Tensor,
                cache: Params, pos) -> Tuple[torch.Tensor, Params]:
    """token [B, 1]; pos a scalar (every row at one position) or [B] (a
    position per row) -> (logits [B, 1, V] f32, the new cache)."""
    x = params["embed"]["w"].to(cfg.dtype)[token]
    x, new_cache = _walk(params, cfg, x, cache,
                         lambda p, bt, h, c: block_decode(p, cfg, bt, h, c,
                                                          pos))
    return _head(params, cfg, x), new_cache


def scatter_cache_rows(pool: Params, sub: Params,
                       rows: torch.Tensor) -> Params:
    """``sub``'s batch rows written into a copy of ``pool`` at the row
    indices ``rows``; both are ``init_cache`` trees of one config,
    ``sub`` of a smaller batch. ``period_stack`` leaves hold the batch on
    axis 1, ``tail`` leaves on axis 0. A row index past the pool's batch
    is dropped (continuous batching pads its prefill batch with such
    rows), as the reference's scatter in mode "drop"; a negative index
    counts from the end, as there."""
    rows = torch.as_tensor(rows, dtype=torch.int64)

    def put(c, s, axis):
        n = c.shape[axis]
        r = rows.to(c.device)
        r = torch.where(r < 0, r + n, r)
        # a dropped row lands on one extra slot past the pool, cut off after
        r = torch.where((r < 0) | (r > n), n, r)
        pad = list(c.shape)
        pad[axis] = 1
        out = torch.cat([c, c.new_zeros(pad)], dim=axis).index_copy(
            axis, r, s.to(c.dtype))
        return out.narrow(axis, 0, n)

    out: Params = {}
    if "period_stack" in pool:
        out["period_stack"] = tree_map(lambda c, s: put(c, s, 1),
                                       pool["period_stack"],
                                       sub["period_stack"])
    if "tail" in pool:
        out["tail"] = tree_map(lambda c, s: put(c, s, 0), pool["tail"],
                               sub["tail"])
    return out


# ---------------------------------------------------------------------------
# Chunked prefill: a prompt [B, P] in blocks against the decode caches
# ---------------------------------------------------------------------------
# Two forms of a block, both the decode step's arithmetic per token:
#   * wide: an attention block takes the whole chunk in one product
#     against its cache (layers.attention_prefill), and a dense FFN the
#     chunk as one product; only with no ring wrap (P <= every attention
#     cache's slots) and no MoE (capacity couples a dispatch's tokens);
#   * stepwise: block_decode over the chunk's tokens, one after another.
# The reference holds both bit-exact against decode_step token by token;
# the port holds them within a tolerance (ROADMAP Queue 3).
def block_prefill(p: Params, cfg: LMConfig, btype: str, x: torch.Tensor,
                  cache: Any, pos0: int, wide: bool
                  ) -> Tuple[torch.Tensor, Any]:
    """x [B, C, D] for positions pos0..pos0+C-1 -> (x_out, new cache)."""
    if wide and btype in ("attn", "local") and cfg.moe is None:
        _check_block(cfg, btype)
        h = L.rmsnorm(p["ln1"], x)
        m, cache = L.attention_prefill(p["mixer"], cfg.attn_cfg(btype), h,
                                       cache, pos0)
        x = x + m
        if cfg.d_ff > 0:
            x = x + L.mlp(p["ffn"], L.rmsnorm(p["ln2"], x))
        return x, cache
    ys = []
    for t in range(x.shape[1]):
        y, cache = block_decode(p, cfg, btype, x[:, t:t + 1], cache,
                                pos0 + t)
        ys.append(y)
    return torch.cat(ys, dim=1), cache


def prefill_block(params: Params, cfg: LMConfig, tokens: torch.Tensor,
                  cache: Params, pos0: int, wide: bool = True,
                  last_only: bool = True) -> Tuple[torch.Tensor, Params]:
    """One prefill chunk, tokens [B, C] at positions pos0.. -> (logits,
    new cache). ``last_only`` applies the head to the chunk's last
    position only (all a serving prefill needs); False gives [B, C, V]."""
    pos0 = int(pos0)
    x = params["embed"]["w"].to(cfg.dtype)[tokens]
    x, new_cache = _walk(params, cfg, x, cache,
                         lambda p, bt, h, c: block_prefill(p, cfg, bt, h, c,
                                                           pos0, wide))
    if last_only:
        x = x[:, -1:]
    return _head(params, cfg, x), new_cache


def _min_attn_cache(cfg: LMConfig, cache: Params) -> int:
    """The fewest slots of any attention cache: the no-wrap bound of the
    wide prefill (a window's ring buffer wraps past it)."""
    sizes = []
    pat = cfg.block_pattern
    if "period_stack" in cache:
        for i, bt in enumerate(pat):
            if bt in ("attn", "local"):
                sizes.append(cache["period_stack"][str(i)]["k"].shape[2])
    if "tail" in cache:
        base = cfg.n_periods * len(pat)
        for i in range(cfg.n_tail):
            if cfg.layer_types[base + i] in ("attn", "local"):
                sizes.append(cache["tail"][str(i)]["k"].shape[1])
    return min(sizes) if sizes else (1 << 30)


def prefill(params: Params, cfg: LMConfig, tokens: torch.Tensor,
            cache: Params, *, block: int = 32,
            last_only: bool = True) -> Tuple[torch.Tensor, Params]:
    """Prompts [B, P] in chunks of ``block`` tokens -> (logits, the cache
    positioned for decode at P). The wide form is taken when no attention
    cache can wrap (P <= its slots)."""
    P = tokens.shape[1]
    wide = P <= _min_attn_cache(cfg, cache)
    outs = []
    for p0 in range(0, P, block):
        logits, cache = prefill_block(params, cfg, tokens[:, p0:p0 + block],
                                      cache, p0, wide, last_only)
        outs.append(logits)
    return (outs[-1] if last_only else torch.cat(outs, dim=1)), cache


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 z_loss: float = 1e-4) -> torch.Tensor:
    """Mean token cross-entropy with z-loss. logits [.., V] f32, labels
    [..]; the log-sum-exp in the reference's gradient form."""
    lse = _logsumexp(logits)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    loss = lse - ll + z_loss * lse ** 2
    return loss.mean()


def lm_loss(params: Params, cfg: LMConfig, tokens: torch.Tensor,
            labels: torch.Tensor, prefix: Optional[torch.Tensor] = None,
            aux_weight: float = 0.01) -> torch.Tensor:
    logits, aux = forward(params, cfg, tokens, prefix)
    if cfg.prefix_len > 0:
        logits = logits[:, cfg.prefix_len:]
    return softmax_xent(logits, labels) + aux_weight * aux


# ---------------------------------------------------------------------------
# Unrolled per-layer view (the FiCABU engine)
# ---------------------------------------------------------------------------
# Depth index j = 0..n_layers+1, front to back: j = 0 the embedding,
# j = 1..n_layers the blocks, j = n_layers + 1 the head (+ final norm).
# Back-to-front paper index l = L_u - j (l = 1 is the head).
def n_unlearn_layers(cfg: LMConfig) -> int:
    return cfg.n_layers + 2


def get_layer(params: Params, cfg: LMConfig, j: int) -> Params:
    """Depth index j (front-to-back): the layer's param subtree (views into
    the stacked leaves for a block of ``period_stack``)."""
    if j == 0:
        return params["embed"]
    if j == cfg.n_layers + 1:
        head = {"final_norm": params["final_norm"]}
        if not cfg.tie_embeddings:
            head["lm_head"] = params["lm_head"]
        return head
    i = j - 1
    period = len(cfg.block_pattern)
    if i < cfg.n_periods * period:
        return index_tree(params["period_stack"][str(i % period)],
                          i // period)
    return params["tail"][str(i - cfg.n_periods * period)]


def _set_row(full: torch.Tensor, i: int, s: torch.Tensor) -> torch.Tensor:
    out = full.clone()
    out[i] = s.to(full.dtype)
    return out


def set_layer(params: Params, cfg: LMConfig, j: int, sub: Params) -> Params:
    """A new tree with layer j replaced by ``sub``; the caller's dicts and
    tensors are left as they were."""
    params = dict(params)
    if j == 0:
        params["embed"] = sub
        return params
    if j == cfg.n_layers + 1:
        params["final_norm"] = sub["final_norm"]
        if not cfg.tie_embeddings:
            params["lm_head"] = sub["lm_head"]
        return params
    i = j - 1
    period = len(cfg.block_pattern)
    if i < cfg.n_periods * period:
        stack = dict(params["period_stack"])
        key = str(i % period)
        stack[key] = tree_map(lambda full, s: _set_row(full, i // period, s),
                              stack[key], sub)
        params["period_stack"] = stack
    else:
        tail = dict(params["tail"])
        tail[str(i - cfg.n_periods * period)] = sub
        params["tail"] = tail
    return params


def apply_layer(params: Params, cfg: LMConfig, j: int, layer_p: Params,
                x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Forward of unlearn-layer j with parameters ``layer_p``; x is its
    input."""
    if j == 0:
        raise ValueError("use the embed path of the adapter for j=0")
    if j == cfg.n_layers + 1:
        p2 = dict(params)
        p2.update(layer_p)
        return _head(p2, cfg, x)
    out, _ = block_forward(layer_p, cfg, cfg.layer_types[j - 1], x, positions)
    return out
