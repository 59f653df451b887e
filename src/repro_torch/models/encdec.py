"""Whisper-style encoder-decoder of the port: ``repro.models.encdec``.

The audio frontend is a stub: the caller supplies precomputed mel-frame
embeddings [B, n_frames, d_model] in place of the conv1d stem.

Encoder: bidirectional self-attention blocks (RoPE), then ``enc_norm``.
Decoder: causal self-attention, cross attention on the encoder's memory,
and the SiLU-gated MLP; then ``final_norm`` and the untied ``lm_head``
(f32 logits). Decode steps the decoder one token per row against a KV
cache of its self attention; the cross attention reads the memory whole.

Parameters keep the reference's layout and keys: ``embed``, ``encoder``
and ``decoder`` (each block leaf stacked [n_layers, ...]; no leaf has four
axes), ``enc_norm``, ``final_norm`` and ``lm_head`` [d_model, vocab]. The
reference scans (or unrolls) the stacks; the port walks them in a Python
loop.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.device import resolve_device

from . import layers as L
from .lm import _positions, _stack, softmax_xent
from .module import Params, dense_init, embed_init, index_tree

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    n_enc_layers: int
    n_dec_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    n_frames: int = 1500          # encoder memory length (stub frontend output)
    param_dtype: str = "float32"
    unroll_layers: bool = False   # the port always walks the stacks in Python

    @property
    def dh(self) -> int:
        return self.d_model // self.n_heads

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def self_cfg(self, causal: bool) -> L.AttnConfig:
        return L.AttnConfig(self.d_model, self.n_heads, self.n_kv_heads,
                            self.dh, causal=causal, use_rope=True)

    def cross_cfg(self) -> L.AttnConfig:
        return L.AttnConfig(self.d_model, self.n_heads, self.n_kv_heads,
                            self.dh, causal=False, cross=True, use_rope=False)

    def with_(self, **kw) -> "EncDecConfig":
        return dataclasses.replace(self, **kw)


def _init_enc_block(gen: torch.Generator, cfg: EncDecConfig, *,
                    device) -> Params:
    kw = dict(device=device, dtype=cfg.dtype)
    return {"ln1": L.init_rmsnorm(cfg.d_model, **kw),
            "attn": L.init_attention(gen, cfg.self_cfg(False), **kw),
            "ln2": L.init_rmsnorm(cfg.d_model, **kw),
            "ffn": L.init_mlp(gen, cfg.d_model, cfg.d_ff, **kw)}


def _init_dec_block(gen: torch.Generator, cfg: EncDecConfig, *,
                    device) -> Params:
    kw = dict(device=device, dtype=cfg.dtype)
    return {"ln1": L.init_rmsnorm(cfg.d_model, **kw),
            "self_attn": L.init_attention(gen, cfg.self_cfg(True), **kw),
            "ln_x": L.init_rmsnorm(cfg.d_model, **kw),
            "cross_attn": L.init_attention(gen, cfg.cross_cfg(), **kw),
            "ln2": L.init_rmsnorm(cfg.d_model, **kw),
            "ffn": L.init_mlp(gen, cfg.d_model, cfg.d_ff, **kw)}


def init_encdec(gen: torch.Generator, cfg: EncDecConfig, *,
                device="cuda") -> Params:
    """Random parameters drawn from ``gen`` on its own device and placed on
    ``device`` (raises without a card unless device="cpu"), in the
    reference's layout."""
    device = resolve_device(device)
    kw = dict(device=device, dtype=cfg.dtype)
    return {
        "embed": {"w": embed_init(gen, cfg.vocab, cfg.d_model, **kw)},
        "encoder": _stack([_init_enc_block(gen, cfg, device=device)
                           for _ in range(cfg.n_enc_layers)]),
        "decoder": _stack([_init_dec_block(gen, cfg, device=device)
                           for _ in range(cfg.n_dec_layers)]),
        "enc_norm": L.init_rmsnorm(cfg.d_model, **kw),
        "final_norm": L.init_rmsnorm(cfg.d_model, **kw),
        "lm_head": {"w": dense_init(gen, cfg.d_model, cfg.vocab, **kw)},
    }


def enc_block(p: Params, cfg: EncDecConfig, x: torch.Tensor,
              pos: torch.Tensor) -> torch.Tensor:
    x = x + L.attention(p["attn"], cfg.self_cfg(False), L.rmsnorm(p["ln1"], x),
                        pos)
    return x + L.mlp(p["ffn"], L.rmsnorm(p["ln2"], x))


def dec_block(p: Params, cfg: EncDecConfig, x: torch.Tensor,
              memory: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    x = x + L.attention(p["self_attn"], cfg.self_cfg(True),
                        L.rmsnorm(p["ln1"], x), pos)
    x = x + L.attention(p["cross_attn"], cfg.cross_cfg(),
                        L.rmsnorm(p["ln_x"], x), kv_src=memory)
    return x + L.mlp(p["ffn"], L.rmsnorm(p["ln2"], x))


def encode(params: Params, cfg: EncDecConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """frames [B, n_frames, d_model] stub embeddings -> the memory."""
    x = frames.to(cfg.dtype)
    pos = _positions(x)
    for i in range(cfg.n_enc_layers):
        x = enc_block(index_tree(params["encoder"], i), cfg, x, pos)
    return L.rmsnorm(params["enc_norm"], x)


def _logits(params: Params, cfg: EncDecConfig,
            x: torch.Tensor) -> torch.Tensor:
    """f32 logits of the final norm through ``lm_head`` (the product on
    f32 copies, as the reference asks XLA for an f32 result)."""
    x = L.rmsnorm(params["final_norm"], x)
    return x.to(F32) @ params["lm_head"]["w"].to(x.dtype).to(F32)


def forward(params: Params, cfg: EncDecConfig, tokens: torch.Tensor,
            frames: torch.Tensor) -> torch.Tensor:
    """tokens [B, S]; frames [B, n_frames, D] -> logits [B, S, V] f32."""
    memory = encode(params, cfg, frames)
    x = params["embed"]["w"].to(cfg.dtype)[tokens]
    pos = _positions(x)
    for i in range(cfg.n_dec_layers):
        x = dec_block(index_tree(params["decoder"], i), cfg, x, memory, pos)
    return _logits(params, cfg, x)


def init_cache(cfg: EncDecConfig, batch: int, seq_len: int, *,
               device="cuda") -> Params:
    """The decoder's self-attention KV caches, stacked [n_dec_layers, B,
    seq_len, KV, Dh] (raises without a card unless device="cpu")."""
    device = resolve_device(device)
    self_c = L.init_kv_cache(cfg.self_cfg(True), batch, seq_len, cfg.dtype,
                             device=device)
    return {"decoder": {"self": {
        k: v[None].expand(cfg.n_dec_layers, *v.shape).clone()
        for k, v in self_c.items()}}}


def decode_step(params: Params, cfg: EncDecConfig, token: torch.Tensor,
                cache: Params, pos, memory: torch.Tensor
                ) -> Tuple[torch.Tensor, Params]:
    """token [B, 1] at ``pos`` (a scalar or [B]) against the decoder's
    caches and the encoder's ``memory`` -> (logits [B, 1, V] f32, the new
    cache)."""
    x = params["embed"]["w"].to(cfg.dtype)[token]
    outs = []
    for i in range(cfg.n_dec_layers):
        p = index_tree(params["decoder"], i)
        c = index_tree(cache["decoder"], i)
        m, new_self = L.attention_decode(p["self_attn"], cfg.self_cfg(True),
                                         L.rmsnorm(p["ln1"], x), c["self"],
                                         pos)
        x = x + m
        x = x + L.attention(p["cross_attn"], cfg.cross_cfg(),
                            L.rmsnorm(p["ln_x"], x), kv_src=memory)
        x = x + L.mlp(p["ffn"], L.rmsnorm(p["ln2"], x))
        outs.append({"self": new_self})
    return _logits(params, cfg, x), {"decoder": _stack(outs)}


def lm_loss(params: Params, cfg: EncDecConfig, tokens: torch.Tensor,
            labels: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
    return softmax_xent(forward(params, cfg, tokens, frames), labels)


# The reference's unlearn-layer count: j = 0 the embedding, the encoder
# blocks, the decoder blocks, then the head. (The engine's adapter,
# ``core.adapters.encdec_adapter``, sweeps the decoder chain only: the
# embedding, the decoder blocks and the head.)
def n_unlearn_layers(cfg: EncDecConfig) -> int:
    return cfg.n_enc_layers + cfg.n_dec_layers + 2
