"""Transformer layers of the port: the part of ``repro.models.layers`` that
the ViT classifier and the decoder LM run.

  * LayerNorm (eps 1e-5, population variance, ``rsqrt``) and RMSNorm (eps
    1e-6); both take their statistics in f32 and cast back;
  * rotary position embedding on split halves (not interleaved), angles in
    f32;
  * grouped-query attention, bidirectional or causal, with an optional
    sliding window (``ik > iq - window``): three projections (``wq``, ``wk``,
    ``wv``, three leaves, never one fused weight) with optional biases, the
    score divided by sqrt(Dh) AFTER the q.k product, masked scores set to
    -1e30, softmax, the product with v and the output projection ``wo`` (no
    bias);
  * the SiLU-gated MLP (``w_gate``, ``w_up``, ``w_down``);
  * the token-choice top-k mixture of experts (``moe_ffn``): an f32 router,
    per-block expert capacity, dispatch into ``[nb, E, C, D]`` buffers
    through an overflow slot, SiLU-gated experts, the load-balancing aux
    loss, and an optional always-on shared expert.

Every product and the softmax run in f32, written out as the reference
writes them: not ``F.scaled_dot_product_attention``, whose fused backends
sum in another order and would move the Fisher for nothing. A bf16 weight
is upcast before its product, where the reference asks XLA for an f32
result (``preferred_element_type``), and the result is rounded once. Dense
weights keep the JAX layout [d_in, d_out].

Past ``2 * Q_CHUNK`` queries (a multiple of ``Q_CHUNK``) attention runs
the reference's query-chunked path: blocks of ``Q_CHUNK`` queries against
the whole of k/v, each rematerialised in the backward, so the S x S score
matrix is never stored.

Cross attention (``AttnConfig.cross``) takes its keys and values from
``kv_src`` (an encoder's memory) with neither RoPE nor a causal mask. The
keys and values are reshaped by the QUERY's batch, as the reference writes
it: a query batch smaller than the memory's makes each row attend to the
frames of several memory rows (ROADMAP Queue 3). The serving forms keep
the reference's caches: ``attention_decode`` (one token against a KV cache,
at one position for every row or at a position per row, a sliding window
as a ring buffer), ``attention_prefill`` (a chunk of tokens against the
cache, no ring wrap) and ``init_kv_cache``. (Context-parallel attention and
the MoE's expert-parallel sharding constraints need the distribution layer
and raise "not ported yet".)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .module import dense_init, ones, zeros

F32 = torch.float32
# queries per block of the query-chunked attention (``_sdpa``): at most
# [B, H, Q_CHUNK, Sk] scores exist at a time; sequences longer than
# 2 * Q_CHUNK (and a multiple of it) take that path, as in the reference
Q_CHUNK = 512


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def init_rmsnorm(d: int, *, device, dtype=F32) -> Dict:
    return {"scale": ones((d,), device=device, dtype=dtype)}


def rmsnorm(p: Dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(F32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"].to(F32)
    return out.to(x.dtype)


def init_layernorm(d: int, *, device, dtype=F32) -> Dict:
    return {"scale": ones((d,), device=device, dtype=dtype),
            "bias": zeros((d,), device=device, dtype=dtype)}


def layernorm(p: Dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(F32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * p["scale"].to(F32) + p["bias"].to(F32)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float = 10000.0, *,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=F32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [B, S, H, Dh]; positions: [B, S] (int)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)     # [Dh/2]
    ang = positions.to(F32)[..., None] * freqs                  # [B, S, Dh/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA; bidirectional, causal, sliding-window causal, cross)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # the port's defaults are the ViT's bidirectional attention without
    # RoPE (the reference defaults to causal with RoPE); the LM's attn_cfg
    # sets both explicitly
    use_rope: bool = False
    causal: bool = False
    window: int = 0          # 0: full attention; > 0: sliding window
    cross: bool = False      # cross attention (k/v from an encoder's memory)
    d_kv_in: int = 0         # input width of the k/v projections when cross
    cp: int = 0              # context-parallel segments: not ported


def _cp_not_ported(cp: int) -> ValueError:
    return ValueError(f"context-parallel attention (cp={cp}) is not ported "
                      f"yet: it shards the queries over a mesh; see "
                      f"ROADMAP.md Queue 1")


def init_attention(gen: torch.Generator, cfg: AttnConfig, *, device,
                   dtype=F32) -> Dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    d_kv_in = cfg.d_kv_in or d
    p = {
        "wq": dense_init(gen, d, h * dh, device=device, dtype=dtype),
        "wk": dense_init(gen, d_kv_in, kv * dh, device=device, dtype=dtype),
        "wv": dense_init(gen, d_kv_in, kv * dh, device=device, dtype=dtype),
        "wo": dense_init(gen, h * dh, d, device=device, dtype=dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros((h * dh,), device=device, dtype=dtype)
        p["bk"] = zeros((kv * dh,), device=device, dtype=dtype)
        p["bv"] = zeros((kv * dh,), device=device, dtype=dtype)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = x.to(F32) @ w.to(F32)
    if b is not None:
        y = y + b.to(F32)
    return y.to(x.dtype)


def _qkv(p: Dict, cfg: AttnConfig, x: torch.Tensor,
         kv_src: Optional[torch.Tensor] = None):
    """q from x, k and v from ``kv_src`` (x itself when None), each
    reshaped by x's batch B (the reference's reshape, also for a memory of
    another batch)."""
    B = x.shape[0]
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    src = x if kv_src is None else kv_src
    q = _proj(x, p["wq"], p.get("bq")).reshape(B, -1, h, dh)
    k = _proj(src, p["wk"], p.get("bk")).reshape(B, -1, kv, dh)
    v = _proj(src, p["wv"], p.get("bv")).reshape(B, -1, kv, dh)
    return q, k, v


def _sdpa_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                dtype, causal: bool = False, window: int = 0,
                q_offset: int = 0,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over one block of queries, the first at position
    ``q_offset`` of the keys' sequence.
    q [B, Sq, H, Dh]; k, v [B, Sk, KV, Dh] (H a multiple of KV).
    ``valid``: an optional bool mask of the keys, [Sk] (a decode cache's
    filled slots) or [B, Sk] (each row at its own position)."""
    B, Sq, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    qf = q.to(F32).reshape(B, Sq, KV, G, Dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k.to(F32)) / math.sqrt(Dh)
    if causal:
        iq = torch.arange(Sq, device=q.device) + q_offset
        ik = torch.arange(k.shape[1], device=q.device)
        m = ik[None, :] <= iq[:, None]
        if window > 0:
            m = m & (ik[None, :] > iq[:, None] - window)
        # a Python scalar, not a tensor made on the host: no copy to the
        # card (the scanned program runs without a host sync)
        scores = torch.where(m, scores, -1e30)
    if valid is not None:
        vmask = valid[:, None, None, None, :] if valid.dim() == 2 else valid
        scores = torch.where(vmask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(F32))
    return out.reshape(B, Sq, H, Dh).to(dtype)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          dtype, causal: bool = False, window: int = 0) -> torch.Tensor:
    """Attention over all of q's queries. Past 2 * Q_CHUNK queries, a
    multiple of Q_CHUNK, one ``_sdpa_block`` per block of Q_CHUNK queries
    against the whole of k/v, each under a non-reentrant checkpoint: the
    backward recomputes a block's scores instead of keeping them, as the
    reference's ``jax.checkpoint`` does."""
    Sq = q.shape[1]
    if Sq <= Q_CHUNK * 2 or Sq % Q_CHUNK != 0:
        return _sdpa_block(q, k, v, dtype, causal, window)
    return torch.cat([
        checkpoint(_sdpa_block, q_i, k, v, dtype, causal, window, i * Q_CHUNK,
                   use_reentrant=False, preserve_rng_state=False)
        for i, q_i in enumerate(q.split(Q_CHUNK, dim=1))], dim=1)


def attention(p: Dict, cfg: AttnConfig, x: torch.Tensor,
              positions: Optional[torch.Tensor] = None,
              kv_src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention (train / prefill), x [B, S, D]; ``positions``
    [B, S] default to 0..S-1 in every row. With ``cross`` the keys and
    values come from ``kv_src``, with no RoPE and no causal mask."""
    B, S = x.shape[0], x.shape[1]
    if cfg.cp > 1 and S % cfg.cp == 0 and kv_src is None and S > 1:
        raise _cp_not_ported(cfg.cp)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    q, k, v = _qkv(p, cfg, x, kv_src)
    if cfg.use_rope and not cfg.cross:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    causal = cfg.causal and not cfg.cross
    out = _sdpa(q, k, v, x.dtype, causal, cfg.window if causal else 0)
    return _proj(out.reshape(B, S, -1), p["wo"])


def attention_decode(p: Dict, cfg: AttnConfig, x: torch.Tensor, cache: Dict,
                     pos) -> Tuple[torch.Tensor, Dict]:
    """One token per row against a KV cache.

    x [B, 1, D]; cache {"k", "v"}: [B, S_max, KV, Dh] (a window cache is a
    ring buffer of ``window`` slots); pos: the current position, a scalar
    for every row or a [B] vector, a position per row (the slot pool of
    continuous batching). The token's k/v are written at slot ``pos``
    (``pos % S_max`` in a ring), and the query attends to the filled
    slots. Returns (out [B, 1, D], the new cache); the caller's cache is
    left as it was."""
    B = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
    per_row = pos.dim() == 1
    q, k_new, v_new = _qkv(p, cfg, x)
    if cfg.use_rope:
        pvec = pos[:, None] if per_row else pos.expand(B, 1)
        q = apply_rope(q, pvec, cfg.rope_theta)
        k_new = apply_rope(k_new, pvec, cfg.rope_theta)
    S_max = cache["k"].shape[1]
    slot = pos % S_max if cfg.window > 0 else pos
    kd, vd = cache["k"].dtype, cache["v"].dtype
    if per_row:
        rows = torch.arange(B, device=x.device)
        k = cache["k"].index_put((rows, slot), k_new[:, 0].to(kd))
        v = cache["v"].index_put((rows, slot), v_new[:, 0].to(vd))
    else:
        # the reference's dynamic_update_slice clamps the start into range
        at = slot.clamp(max=S_max - 1).reshape(1)
        k = cache["k"].index_copy(1, at, k_new.to(kd))
        v = cache["v"].index_copy(1, at, v_new.to(vd))
    ik = torch.arange(S_max, device=x.device)
    if per_row:
        if cfg.window > 0:
            age = torch.remainder(slot[:, None] - ik[None, :], S_max)
            valid = age < torch.clamp_max(pos[:, None] + 1, S_max)
        else:
            valid = ik[None, :] <= pos[:, None]
    elif cfg.window > 0:
        # a ring buffer: the valid slots hold the last ``window`` positions
        age = torch.remainder(slot - ik, S_max)
        valid = age < torch.clamp_max(pos + 1, S_max)
    else:
        valid = ik <= pos
    out = _sdpa_block(q, k, v, x.dtype, valid=valid)
    out = _proj(out.reshape(B, 1, -1), p["wo"])
    return out, {"k": k, "v": v}


def attention_prefill(p: Dict, cfg: AttnConfig, x: torch.Tensor, cache: Dict,
                      pos0: int) -> Tuple[torch.Tensor, Dict]:
    """A chunk of C tokens at positions pos0..pos0+C-1 against the KV
    cache, x [B, C, D]: writes the chunk's k/v at those slots and attends
    each query to its causal prefix in one block, the decode step's mask
    values over the same key axis. Needs pos0 + C <= the cache's slots (no
    ring wrap); ``lm.prefill`` checks it and otherwise steps token by
    token. Returns (out [B, C, D], the new cache)."""
    B, C = x.shape[0], x.shape[1]
    pos0 = int(pos0)
    q, k_new, v_new = _qkv(p, cfg, x)
    if cfg.use_rope:
        pvec = (pos0 + torch.arange(C, device=x.device))[None].expand(B, C)
        q = apply_rope(q, pvec, cfg.rope_theta)
        k_new = apply_rope(k_new, pvec, cfg.rope_theta)
    k, v = cache["k"].clone(), cache["v"].clone()
    k[:, pos0:pos0 + C] = k_new.to(k.dtype)
    v[:, pos0:pos0 + C] = v_new.to(v.dtype)
    # no wrap: the window never binds inside the cache, so the mask is
    # causal only, as attention_decode's slot mask
    out = _sdpa_block(q, k, v, x.dtype, causal=True, q_offset=pos0)
    out = _proj(out.reshape(B, C, -1), p["wo"])
    return out, {"k": k, "v": v}


def init_kv_cache(cfg: AttnConfig, batch: int, seq_len: int, dtype, *,
                  device) -> Dict:
    """Zeroed k/v caches [batch, size, KV, Dh]: ``seq_len`` slots, or
    ``min(seq_len, window)`` for a sliding window's ring buffer."""
    size = min(seq_len, cfg.window) if cfg.window > 0 else seq_len
    shape = (batch, size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Dense MLP (SiLU-gated)
# ---------------------------------------------------------------------------
def init_mlp(gen: torch.Generator, d: int, d_ff: int, *, device,
             dtype=F32) -> Dict:
    return {
        "w_gate": dense_init(gen, d, d_ff, device=device, dtype=dtype),
        "w_up": dense_init(gen, d, d_ff, device=device, dtype=dtype),
        "w_down": dense_init(gen, d_ff, d, device=device, dtype=dtype),
    }


def mlp(p: Dict, x: torch.Tensor) -> torch.Tensor:
    xf = x.to(F32)
    g = xf @ p["w_gate"].to(F32)
    u = xf @ p["w_up"].to(F32)
    h = (F.silu(g) * u).to(x.dtype)
    return (h.to(F32) @ p["w_down"].to(F32)).to(x.dtype)


# ---------------------------------------------------------------------------
# Mixture of experts (token choice, per-block capacity)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                 # per-expert hidden
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    shared_ff: int = 0        # hidden dim of the always-on shared expert (0: none)
    dispatch_blocks: int = 1  # data-parallel blocks for local-capacity dispatch
    shard_constraints: bool = False  # expert-parallel shardings: not ported


def _moe_not_ported() -> ValueError:
    return ValueError("the MoE's expert-parallel sharding constraints "
                      "(shard_constraints=True) are not ported yet: they "
                      "need the distribution layer; see ROADMAP.md Queue 1")


def init_moe(gen: torch.Generator, cfg: MoEConfig, *, device,
             dtype=F32) -> Dict:
    """The router stays f32 beside experts in ``dtype``; expert stacks are
    [E, d, f] (``w_gate``, ``w_up``) and [E, f, d] (``w_down``)."""
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, dtype=F32, device=gen.device)
        return (w * scale).to(device=device, dtype=dtype)

    p = {
        "router": dense_init(gen, d, E, device=device, dtype=F32),
        "w_gate": normal((E, d, f), 1.0 / math.sqrt(d)),
        "w_up": normal((E, d, f), 1.0 / math.sqrt(d)),
        "w_down": normal((E, f, d), 1.0 / math.sqrt(f)),
    }
    if cfg.shared_ff:
        p["shared"] = init_mlp(gen, d, cfg.shared_ff, device=device,
                               dtype=dtype)
    return p


def moe_capacity(cfg: MoEConfig, tokens_per_block: int) -> int:
    """Slots per expert and dispatch block, rounded up to a multiple of 8
    (at least 8), as the reference sizes them."""
    cap = int(math.ceil(tokens_per_block * cfg.top_k * cfg.capacity_factor
                        / cfg.num_experts))
    return max(8, -(-cap // 8) * 8)


def moe_dispatch(p: Dict, cfg: MoEConfig, xt: torch.Tensor):
    """The router and the dispatch on tokens ``xt`` [nb, Tb, D]: (probs
    [nb, Tb, E] f32, gate [nb, Tb, K] renormalised, expert ids [nb, Tb, K],
    in_cap [nb, Tb, K] (the choice got a slot), the slot of each choice in
    the flat [E * C + 1] buffer [nb, Tb * K], capacity C). Top-k is a
    stable descending sort, so equal probabilities go to the lower expert
    id first, as ``lax.top_k`` breaks ties; each (token, k) choice takes
    the next slot of its expert in token-major order, and a choice past C
    goes to the overflow slot E * C."""
    nb, Tb, _ = xt.shape
    E, K = cfg.num_experts, cfg.top_k
    C = moe_capacity(cfg, Tb)
    logits = xt.to(F32) @ p["router"].to(F32)
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = gate[..., :K], eidx[..., :K]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    sel = (eidx[..., None] == torch.arange(E, device=xt.device)
           ).to(torch.int64)                                # [nb,Tb,K,E]
    pos_in_e = sel.reshape(nb, Tb * K, E).cumsum(1) - 1
    pos = pos_in_e.reshape(nb, Tb, K, E).gather(-1, eidx[..., None])[..., 0]
    in_cap = pos < C
    flat_dst = torch.where(in_cap, eidx * C + pos, E * C).reshape(nb, Tb * K)
    return probs, gate, eidx, in_cap, flat_dst, C


def moe_ffn(p: Dict, cfg: MoEConfig, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k MoE with per-block capacity and slot dispatch.

    x [B, S, D]: the tokens are cut into ``dispatch_blocks`` blocks of Tb
    and dispatched (``moe_dispatch``); the overflow slot is discarded, so
    every kept slot has one source. The experts' SiLU-gated products run in
    f32 on ``[nb, E, C, D]`` buffers in x's dtype, and each token gathers
    its kept slots weighted by its gate. Returns (output [B, S, D], aux):
    the load-balancing loss, E times the block mean of dot(mean router
    probabilities, top-1 fractions)."""
    if cfg.shard_constraints:
        raise _moe_not_ported()
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    nb = cfg.dispatch_blocks
    T = B * S
    if T % nb != 0:
        raise ValueError(
            f"MoE dispatch needs batch*seq tokens ({T}) divisible by "
            f"dispatch_blocks ({nb})")
    Tb = T // nb

    xt = x.reshape(nb, Tb, D)
    probs, gate, eidx, in_cap, flat_dst, C = moe_dispatch(p, cfg, xt)
    top1 = eidx[..., 0, None] == torch.arange(E, device=x.device)
    aux = (probs.mean(1) * top1.to(F32).mean(1)).sum(-1).mean() * E

    rows = torch.arange(nb, device=x.device)[:, None].expand(nb, Tb * K)
    src = xt[:, :, None].expand(nb, Tb, K, D).reshape(nb, Tb * K, D)
    # only the discarded overflow row receives more than one addition
    buf = torch.zeros((nb, E * C + 1, D), dtype=x.dtype, device=x.device
                      ).index_put((rows, flat_dst), src, accumulate=True)
    buf = buf[:, :E * C].reshape(nb, E, C, D).to(F32)

    g = torch.einsum("necd,edf->necf", buf, p["w_gate"].to(F32))
    u = torch.einsum("necd,edf->necf", buf, p["w_up"].to(F32))
    h = (F.silu(g) * u).to(x.dtype)
    out_e = torch.einsum("necf,efd->necd", h.to(F32),
                         p["w_down"].to(F32)).to(x.dtype)

    out_flat = torch.cat([out_e.reshape(nb, E * C, D),
                          out_e.new_zeros((nb, 1, D))], dim=1)
    gathered = out_flat[rows, flat_dst].reshape(nb, Tb, K, D)
    w = (gate * in_cap.to(F32)).to(x.dtype)
    y = torch.einsum("ntkd,ntk->ntd", gathered.to(F32), w.to(F32)
                     ).to(x.dtype)
    if "shared" in p:
        y = y + mlp(p["shared"], xt)
    return y.reshape(B, S, D), aux
