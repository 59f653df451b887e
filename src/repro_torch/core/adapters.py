"""ModelAdapter constructors: uniform per-layer views over the port's models.

MAC formulas are per-sample forward multiply-accumulates — the hardware
proxy the paper reports. (The ViT, LM and encoder-decoder adapters come
with later slices.)
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
