"""Paper-faithful vision models on PyTorch: ResNet-18 (CIFAR stem) and the
ViT classifier.

Port of ``repro.models.vision``. Unlearn layers, front-to-back:

  ResNet-18: j=0 stem conv | j=1..8 basic blocks (2 convs each -> "16 conv
  layers") | j=9 fc classifier
  ViT: j=0 patch embedding | j=1..n_layers encoder blocks | j=n_layers+1
  head

Layout. Images enter as [B, H, W, 3], as in the JAX package, so the same
data pipeline feeds both. The ResNet stem turns them channels-first and
every later activation is [B, C, H, W], PyTorch's native convolution
layout; conv weights are OIHW ([cout, cin, kh, kw]) and
``repro_torch.bridge`` converts the reference's HWIO weights. The ViT cuts
the NHWC image into patches exactly as the reference does, so a patch
vector runs (p_h, p_w, c) and the ``patch/w`` leaf [P*P*3, D] is shared
unchanged; its activations are [B, T, D] tokens. Dense weights keep the
JAX layout [d_in, d_out].

Padding. JAX's ``"SAME"`` padding is asymmetric where the total is odd:
the stride-2 3x3 convs pad (0, 1), not (1, 1). ``conv2d`` reproduces that
rule for every conv.

Norms are GroupNorm in the ResNet (the reference's documented deviation
from BatchNorm) and LayerNorm in the ViT.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device

from . import layers as L
from .module import Params, dense_init, ones, zeros

F32 = torch.float32
RESNET_N_LAYERS = 10


# ---------------------------------------------------------------------------
# Conv / norm primitives
# ---------------------------------------------------------------------------
def conv_init(gen: torch.Generator, kh, kw, cin, cout, *, device,
              dtype=F32) -> torch.Tensor:
    fan_in = kh * kw * cin
    w = torch.randn(cout, cin, kh, kw, generator=gen, dtype=F32)
    return (w * math.sqrt(2.0 / fan_in)).to(device=device, dtype=dtype)


def same_padding(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of XLA's "SAME" rule: the output has
    ceil(size / stride) positions and an odd total pads one more on the
    high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(w: torch.Tensor, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x [B, C, H, W], w [cout, cin, kh, kw], JAX "SAME" padding."""
    ph = same_padding(x.shape[2], w.shape[2], stride)
    pw = same_padding(x.shape[3], w.shape[3], stride)
    w = w.to(x.dtype)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=stride)


def init_groupnorm(c, *, device, dtype=F32) -> Params:
    return {"scale": ones((c,), device=device, dtype=dtype),
            "bias": zeros((c,), device=device, dtype=dtype)}


def groupnorm(p: Params, x: torch.Tensor, groups: int = 8,
              eps: float = 1e-5) -> torch.Tensor:
    C = x.shape[1]
    g = min(groups, C)
    while C % g:           # largest group count <= groups dividing C
        g -= 1
    y = F.group_norm(x.to(F32), g, p["scale"].to(F32), p["bias"].to(F32),
                     eps)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# ResNet-18 (CIFAR variant)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str = "resnet18"
    n_classes: int = 20
    width: int = 64                  # stage widths: w, 2w, 4w, 8w
    img_size: int = 32
    param_dtype: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def stage_widths(self):
        return (self.width, 2 * self.width, 4 * self.width, 8 * self.width)


def _init_basic_block(gen, cin, cout, device, dtype) -> Params:
    p = {
        "conv1": conv_init(gen, 3, 3, cin, cout, device=device, dtype=dtype),
        "gn1": init_groupnorm(cout, device=device, dtype=dtype),
        "conv2": conv_init(gen, 3, 3, cout, cout, device=device, dtype=dtype),
        "gn2": init_groupnorm(cout, device=device, dtype=dtype),
    }
    if cin != cout:
        p["proj"] = conv_init(gen, 1, 1, cin, cout, device=device,
                              dtype=dtype)
    return p


def init_resnet(gen: torch.Generator, cfg: ResNetConfig, *,
                device="cuda") -> Params:
    """Random ResNet-18 parameters drawn from ``gen`` (a CPU generator) and
    placed on ``device`` (raises without a card unless device="cpu")."""
    dev = resolve_device(device)
    dt = cfg.dtype
    ws = cfg.stage_widths
    blocks = {}
    cin = ws[0]
    bi = 0
    for w in ws:
        for _ in range(2):
            blocks[str(bi)] = _init_basic_block(gen, cin, w, dev, dt)
            cin = w
            bi += 1
    return {
        "stem": {"conv": conv_init(gen, 3, 3, 3, ws[0], device=dev, dtype=dt),
                 "gn": init_groupnorm(ws[0], device=dev, dtype=dt)},
        "blocks": blocks,
        "fc": {"w": dense_init(gen, ws[3], cfg.n_classes, device=dev,
                               dtype=dt),
               "b": zeros((cfg.n_classes,), device=dev, dtype=dt)},
    }


def _basic_block(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    h = F.relu(groupnorm(p["gn1"], conv2d(p["conv1"], x, stride)))
    h = groupnorm(p["gn2"], conv2d(p["conv2"], h))
    sc = x
    if "proj" in p:
        sc = conv2d(p["proj"], x, stride)
    return F.relu(h + sc)


def _block_stride(bi: int) -> int:
    return 2 if bi in (2, 4, 6) else 1


def resnet_apply_layer(p_layer: Params, j: int, x: torch.Tensor
                       ) -> torch.Tensor:
    """Unlearn layer j: 0=stem (takes [B, H, W, 3] images), 1..8 basic
    blocks, 9=fc (returns f32 logits)."""
    if j == 0:
        x = x.permute(0, 3, 1, 2).contiguous()
        return F.relu(groupnorm(p_layer["gn"], conv2d(p_layer["conv"], x)))
    if j == RESNET_N_LAYERS - 1:
        pooled = x.mean(dim=(2, 3))
        return pooled.to(F32) @ p_layer["w"].to(F32) + p_layer["b"].to(F32)
    return _basic_block(p_layer, x, _block_stride(j - 1))


def resnet_forward(params: Params, cfg: ResNetConfig, images: torch.Tensor,
                   collect: bool = False):
    """images [B,H,W,3] -> logits [B,n_classes] (f32); optionally the input
    activation of every layer (acts[0] is the image batch)."""
    acts: List[torch.Tensor] = []
    x = images.to(cfg.dtype)
    for j in range(RESNET_N_LAYERS):
        if collect:
            acts.append(x)
        x = resnet_apply_layer(resnet_layer_params(params, j), j, x)
    return (x, acts) if collect else x


def resnet_layer_params(params: Params, j: int) -> Params:
    if j == 0:
        return params["stem"]
    if j == RESNET_N_LAYERS - 1:
        return params["fc"]
    return params["blocks"][str(j - 1)]


def resnet_set_layer(params: Params, j: int, sub: Params) -> Params:
    """A new tree with layer j replaced; the caller's dicts are untouched."""
    params = dict(params)
    if j == 0:
        params["stem"] = sub
    elif j == RESNET_N_LAYERS - 1:
        params["fc"] = sub
    else:
        blocks = dict(params["blocks"])
        blocks[str(j - 1)] = sub
        params["blocks"] = blocks
    return params


# ---------------------------------------------------------------------------
# ViT classifier
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ViTConfig:
    name: str = "vit"
    n_classes: int = 20
    n_layers: int = 12
    d_model: int = 192
    n_heads: int = 3
    d_ff: int = 768
    patch: int = 4
    img_size: int = 32
    param_dtype: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def n_tokens(self) -> int:
        return (self.img_size // self.patch) ** 2 + 1  # + cls

    def attn_cfg(self) -> L.AttnConfig:
        return L.AttnConfig(self.d_model, self.n_heads, self.n_heads,
                            self.d_model // self.n_heads, qkv_bias=True)


def _init_vit_block(gen, cfg: ViTConfig, device, dtype) -> Params:
    return {"ln1": L.init_layernorm(cfg.d_model, device=device, dtype=dtype),
            "attn": L.init_attention(gen, cfg.attn_cfg(), device=device,
                                     dtype=dtype),
            "ln2": L.init_layernorm(cfg.d_model, device=device, dtype=dtype),
            "ffn": L.init_mlp(gen, cfg.d_model, cfg.d_ff, device=device,
                              dtype=dtype)}


def init_vit(gen: torch.Generator, cfg: ViTConfig, *,
             device="cuda") -> Params:
    """Random ViT parameters drawn from ``gen`` (a CPU generator) and placed
    on ``device`` (raises without a card unless device="cpu")."""
    dev = resolve_device(device)
    dt = cfg.dtype
    D = cfg.d_model
    pdim = cfg.patch * cfg.patch * 3

    def small_normal(*shape):
        w = torch.randn(*shape, generator=gen, dtype=F32) * 0.02
        return w.to(device=dev, dtype=dt)

    return {
        "patch": {"w": dense_init(gen, pdim, D, device=dev, dtype=dt),
                  "b": zeros((D,), device=dev, dtype=dt),
                  "cls": small_normal(1, 1, D),
                  "pos": small_normal(1, cfg.n_tokens, D)},
        "blocks": {str(i): _init_vit_block(gen, cfg, dev, dt)
                   for i in range(cfg.n_layers)},
        "head": {"ln": L.init_layernorm(D, device=dev, dtype=dt),
                 "w": dense_init(gen, D, cfg.n_classes, device=dev,
                                 dtype=dt),
                 "b": zeros((cfg.n_classes,), device=dev, dtype=dt)},
    }


def vit_apply_layer(p_layer: Params, j: int, x: torch.Tensor,
                    cfg: ViTConfig) -> torch.Tensor:
    """Unlearn layer j: 0 = patch embedding (takes [B, H, W, 3] images,
    returns [B, T, D] with the cls token first), 1..n_layers encoder
    blocks, n_layers+1 = head (the cls token's LayerNorm, then a dense
    layer; returns f32 logits)."""
    if j == 0:
        B, H, W, C = x.shape
        P = cfg.patch
        patches = x.reshape(B, H // P, P, W // P, P, C).permute(
            0, 1, 3, 2, 4, 5).reshape(B, (H // P) * (W // P), P * P * C)
        t = (patches.to(F32) @ p_layer["w"].to(F32)
             + p_layer["b"].to(F32)).to(cfg.dtype)
        cls = p_layer["cls"].to(cfg.dtype).expand(B, 1, cfg.d_model)
        return torch.cat([cls, t], dim=1) + p_layer["pos"].to(cfg.dtype)
    if j == cfg.n_layers + 1:
        h = L.layernorm(p_layer["ln"], x)[:, 0]
        return h.to(F32) @ p_layer["w"].to(F32) + p_layer["b"].to(F32)
    p = p_layer
    h = L.layernorm(p["ln1"], x)
    x = x + L.attention(p["attn"], cfg.attn_cfg(), h)
    h = L.layernorm(p["ln2"], x)
    return x + L.mlp(p["ffn"], h)


def vit_forward(params: Params, cfg: ViTConfig, images: torch.Tensor,
                collect: bool = False):
    """images [B,H,W,3] -> logits [B,n_classes] (f32); optionally the input
    activation of every layer (acts[0] is the image batch)."""
    acts: List[torch.Tensor] = []
    x = images
    for j in range(cfg.n_layers + 2):
        if collect:
            acts.append(x)
        x = vit_apply_layer(vit_layer_params(params, j, cfg), j, x, cfg)
    return (x, acts) if collect else x


def vit_layer_params(params: Params, j: int, cfg: ViTConfig) -> Params:
    if j == 0:
        return params["patch"]
    if j == cfg.n_layers + 1:
        return params["head"]
    return params["blocks"][str(j - 1)]


def vit_set_layer(params: Params, j: int, sub: Params,
                  cfg: ViTConfig) -> Params:
    """A new tree with layer j replaced; the caller's dicts are untouched."""
    params = dict(params)
    if j == 0:
        params["patch"] = sub
    elif j == cfg.n_layers + 1:
        params["head"] = sub
    else:
        blocks = dict(params["blocks"])
        blocks[str(j - 1)] = sub
        params["blocks"] = blocks
    return params


# ---------------------------------------------------------------------------
# Classification loss / accuracy
# ---------------------------------------------------------------------------
def _logsumexp(x: torch.Tensor) -> torch.Tensor:
    """log-sum-exp over the last axis in jax.nn.logsumexp's form: the max is
    held constant, so the gradient is exp(x - max) / sum, not
    exp(x - lse). On a confident model the loss gradient p - 1 cancels
    almost to nothing, and torch.logsumexp's form moves the Fisher by
    about 1e-3 relative to the reference's."""
    amax = x.detach().amax(dim=-1, keepdim=True)
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    return torch.log(torch.exp(x - amax).sum(dim=-1)) + amax[..., 0]


def cls_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lse = _logsumexp(logits)
    ll = logits.gather(-1, labels.long()[:, None])[:, 0]
    return (lse - ll).mean()


def cls_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).to(F32).mean()
