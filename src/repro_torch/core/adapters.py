"""ModelAdapter constructors: uniform per-layer views over the port's models.

MAC formulas are per-sample forward multiply-accumulates — the hardware
proxy the paper reports. The paper's two vision models, ResNet-18 and ViT,
are served. (The LM and encoder-decoder adapters come with the LM slice.)
"""
from __future__ import annotations

from typing import List

from repro_torch.device import resolve_device
from repro_torch.models import vision as V

from .cau import ModelAdapter
from .metrics import accuracy


# ---------------------------------------------------------------------------
# ResNet-18
# ---------------------------------------------------------------------------
def _resnet_macs(cfg: V.ResNetConfig) -> List[int]:
    ws = cfg.stage_widths
    hw = cfg.img_size
    macs = [hw * hw * 3 * ws[0] * 9]                      # stem
    cin = ws[0]
    for bi in range(8):
        stride = V._block_stride(bi)
        cout = ws[bi // 2]
        if stride == 2:
            hw //= 2
        m = hw * hw * cin * cout * 9 + hw * hw * cout * cout * 9
        if cin != cout:
            m += hw * hw * cin * cout
        macs.append(m)
        cin = cout
    macs.append(ws[3] * cfg.n_classes)                    # fc
    return macs


def resnet_adapter(cfg: V.ResNetConfig, *, device="cuda") -> ModelAdapter:
    """The per-layer view of ResNet-18 whose parameters live on ``device``
    (raises without a card unless device="cpu")."""
    dev = resolve_device(device)

    def fc(params, images):
        return V.resnet_forward(params, cfg, images, collect=True)

    def apply_layer(params, j, layer_p, act):
        return V.resnet_apply_layer(layer_p, j, act)

    def layer_key(j):
        # blocks of equal stride AND equal shapes share one fused step
        # (shape equality is enforced by the engine's cache signature).
        if j == 0:
            return ("stem",)
        if j == V.RESNET_N_LAYERS - 1:
            return ("fc",)
        return ("blk", V._block_stride(j - 1))

    return ModelAdapter(
        name=cfg.name, n_layers=V.RESNET_N_LAYERS,
        forward_collect=fc,
        apply_layer=apply_layer,
        get_layer=V.resnet_layer_params,
        set_layer=V.resnet_set_layer,
        loss=V.cls_loss, acc=accuracy,
        layer_fwd_macs=_resnet_macs(cfg),
        layer_key=layer_key, layer_ctx=lambda p, j: None,
        device=dev)


# ---------------------------------------------------------------------------
# ViT
# ---------------------------------------------------------------------------
def _vit_macs(cfg: V.ViTConfig) -> List[int]:
    T, D, F = cfg.n_tokens, cfg.d_model, cfg.d_ff
    pdim = cfg.patch * cfg.patch * 3
    block = 4 * T * D * D + 2 * T * T * D + 3 * T * D * F
    return ([(T - 1) * pdim * D] + [block] * cfg.n_layers
            + [D * cfg.n_classes])


def vit_adapter(cfg: V.ViTConfig, *, device="cuda") -> ModelAdapter:
    """The per-layer view of the ViT whose parameters live on ``device``
    (raises without a card unless device="cpu")."""
    dev = resolve_device(device)

    def fc(params, images):
        return V.vit_forward(params, cfg, images, collect=True)

    def apply_layer(params, j, layer_p, act):
        return V.vit_apply_layer(layer_p, j, act, cfg)

    def layer_key(j):
        if j == 0:
            return ("patch",)
        if j == cfg.n_layers + 1:
            return ("head",)
        return ("blk",)  # every encoder block shares one fused step

    return ModelAdapter(
        name=cfg.name, n_layers=cfg.n_layers + 2,
        forward_collect=fc,
        apply_layer=apply_layer,
        get_layer=lambda p, j: V.vit_layer_params(p, j, cfg),
        set_layer=lambda p, j, s: V.vit_set_layer(p, j, s, cfg),
        loss=V.cls_loss, acc=accuracy,
        layer_fwd_macs=_vit_macs(cfg),
        layer_key=layer_key, layer_ctx=lambda p, j: None,
        device=dev)
