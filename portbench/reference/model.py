"""A float32 dense decoder LM, written from the published description of
the Llama / Qwen2 block: RMSNorm (eps from the configuration), rotary
position embedding on the two halves of each head (``rotate_half``),
causal grouped-query attention with optional q/k/v biases, the SiLU-gated
MLP, an untied head.

Weights are read from a tree in the port's layout (``lib.weights``) and
used in float32. ``get(path, index)`` supplies a leaf: the unedited
weights or a layer's edit, so the same forward serves the sweep's
checkpoints. ``set_rounding`` turns the reference into a witness for
calibration (``calibrate.py``'s ``round`` job): values rounded to the
served type where the port rounds them; no benchmark run sets it.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.lib.config import Dims

F32 = torch.float32
Get = Callable[[str, Optional[int]], torch.Tensor]
_ROUND: Optional[torch.dtype] = None


def set_rounding(dtype: Optional[torch.dtype]) -> None:
    """Round (to ``dtype``, None: never) each norm's, projection's,
    attention's and MLP's output, the residual stream, each edit and each
    leaf's gradient, as the port does in its served type."""
    global _ROUND
    _ROUND = dtype


def rd(x: torch.Tensor) -> torch.Tensor:
    return x if _ROUND is None else x.to(_ROUND).to(F32)


def no_tf32() -> None:
    """Float32 products in float32: TF32 and reduced-precision reductions
    off, process-wide."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope_tables(dims: Dims, seq_len: int, device):
    inv = 1.0 / (dims.rope_theta ** (torch.arange(
        0, dims.head_dim, 2, dtype=torch.float64, device=device)
        / dims.head_dim))
    ang = torch.arange(seq_len, dtype=torch.float64, device=device)[:, None] \
        * inv[None, :]
    return torch.cos(ang).to(F32), torch.sin(ang).to(F32)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [B, S, heads, dh]: (x1, x2) -> (x1 cos - x2 sin, x2 cos + x1 sin)
    on the two halves of each head."""
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def block(get: Get, i: int, dims: Dims, x: torch.Tensor, rope) -> torch.Tensor:
    B, S, _ = x.shape
    H, KV, dh = dims.n_heads, dims.n_kv_heads, dims.head_dim
    p = "period_stack/0/"

    def lin(name, inp, bias=None):
        y = inp @ get(p + name, i)
        return y if bias is None else y + get(p + bias, i)

    h = rd(rms_norm(x, get(p + "ln1/scale", i), dims.rms_norm_eps))
    bias = dims.qkv_bias
    q = rd(lin("mixer/wq", h, "mixer/bq" if bias else None)).view(
        B, S, H, dh)
    k = rd(lin("mixer/wk", h, "mixer/bk" if bias else None)).view(
        B, S, KV, dh)
    v = rd(lin("mixer/wv", h, "mixer/bv" if bias else None)).view(
        B, S, KV, dh)
    q, k = rd(rotate(q, *rope)), rd(rotate(k, *rope))
    rep = H // KV
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))        # [B, H, S, dh]
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
    future = torch.ones(S, S, dtype=torch.bool, device=x.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
    att = rd((probs @ v).transpose(1, 2).reshape(B, S, H * dh))
    x = rd(x + rd(att @ get(p + "mixer/wo", i)))
    h = rd(rms_norm(x, get(p + "ln2/scale", i), dims.rms_norm_eps))
    up = rd(F.silu(h @ get(p + "ffn/w_gate", i))
            * (h @ get(p + "ffn/w_up", i)))
    return rd(x + rd(up @ get(p + "ffn/w_down", i)))


def head(get: Get, dims: Dims, x: torch.Tensor) -> torch.Tensor:
    h = rd(rms_norm(x, get("final_norm/scale", None), dims.rms_norm_eps))
    return h @ get("lm_head/w", None)


def apply_layer(get: Get, dims: Dims, j: int, x: torch.Tensor, rope
                ) -> torch.Tensor:
    """The paper's layer at depth j: 0 the embedding (x: token ids), 1..n
    the blocks, n + 1 the head (returns logits)."""
    if j == 0:
        return get("embed/w", None)[x]
    if j == dims.n_layers + 1:
        return head(get, dims, x)
    return block(get, j - 1, dims, x, rope)


def forward(get: Get, dims: Dims, tokens: torch.Tensor, rope,
            collect: bool = False
            ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """tokens [B, S] -> (logits [B, S, V], each layer's input if
    ``collect``: acts[j] for j = 1..n + 1, acts[0] the token ids)."""
    acts = [tokens]
    x = tokens
    for j in range(dims.n_unlearn_layers):
        x = apply_layer(get, dims, j, x, rope)
        if collect and j < dims.n_unlearn_layers - 1:
            acts.append(x)
    return x, acts


def token_loss(logits: torch.Tensor, labels: torch.Tensor,
               z_loss: float) -> torch.Tensor:
    """Mean over tokens of -log p(label) + z_loss * logsumexp^2."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels[..., None])[..., 0]
    return (lse - ll + z_loss * lse * lse).mean()
