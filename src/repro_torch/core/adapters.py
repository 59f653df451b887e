"""ModelAdapter constructors: uniform per-layer views over the port's models.

MAC formulas are per-sample forward multiply-accumulates — the hardware
proxy the paper reports. The paper's two vision models, ResNet-18 and ViT,
the decoder LM (attention and recurrent blocks, dense or MoE FFN) and the
encoder-decoder (its decoder chain) are served. An LM with a stub modality
prefix gets its per-layer view, but the engine's layer sweep refuses it,
as the reference's cannot run it (``lm_adapter``).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec as ED
from repro_torch.models import lm as LM
from repro_torch.models.module import index_tree, tree_map
from repro_torch.models import vision as V

from .cau import ModelAdapter
from .metrics import accuracy, token_accuracy


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


# ---------------------------------------------------------------------------
# Causal LM (attention and recurrent blocks, dense or MoE FFN)
# ---------------------------------------------------------------------------
def _lm_block_macs(cfg: LM.LMConfig, btype: str, S: int) -> int:
    D, H, KV, dh, F = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh, cfg.d_ff
    if btype in ("attn", "local"):
        ctx = min(S, cfg.window) if btype == "local" else S
        m = S * D * (H + 2 * KV) * dh + S * H * dh * D + 2 * S * ctx * H * dh
    elif btype == "mlstm":
        m = (4 * S * D * H * dh + 2 * S * cfg.mlstm_chunk * H * dh
             + 2 * S * D * H)
    elif btype == "slstm":
        m = 4 * S * D * D + 4 * S * D * (D // H) + S * D * D
    elif btype == "rglru":
        dr = cfg.rglru_cfg().d_rnn
        m = 2 * S * D * dr + 2 * S * dr * dr + S * dr * D
    else:
        raise LM._not_ported(f"{cfg.name}: the MACs of block type {btype!r}")
    if cfg.d_ff > 0:
        if cfg.moe:
            mo = cfg.moe
            m += S * D * mo.num_experts + S * mo.top_k * 3 * D * F
            if mo.shared_ff:
                m += 3 * S * D * mo.shared_ff
        else:
            m += 3 * S * D * F
    return m


def lm_layer_macs(cfg: LM.LMConfig, S: int) -> List[int]:
    macs = [0]  # embedding gather
    for bt in cfg.layer_types:
        macs.append(_lm_block_macs(cfg, bt, S))
    macs.append(S * cfg.d_model * cfg.vocab)  # head
    return macs


def lm_adapter(cfg: LM.LMConfig, seq_len: int,
               prefix: Optional[torch.Tensor] = None,
               exclude_router: bool = True, *,
               device="cuda") -> ModelAdapter:
    """inputs = tokens [N, S] (integer ids, never cast); labels [N, S]
    (next-token targets). The per-layer view of the LM whose parameters
    live on ``device`` (raises without a card unless device="cpu").

    With MoE and ``exclude_router`` the routers are excluded from every
    edit (``exclude``), as in the reference. With ``prefix_len > 0`` the
    embedding layer puts ``prefix`` ahead of the tokens, and the forward's
    logits, the loss and the accuracy drop its positions, as the
    reference's do; the adapter then carries ``sweep_refusal``: the
    reference's layer sweep cannot run such a model (the head's output
    keeps the prefix positions that the loss cotangent lacks), so the
    port's engine refuses it rather than serve what the reference cannot."""
    dev = resolve_device(device)
    for bt in cfg.layer_types:
        LM._check_block(cfg, bt)
    Lu = LM.n_unlearn_layers(cfg)
    P = cfg.prefix_len

    def apply_layer(params, j, layer_p, act):
        # ``params`` may be the full tree or the engine's minimal context
        # from layer_ctx below (None, or embed-only for the tied head):
        # LM.apply_layer reads it only for the head
        if j == 0:
            return LM._embed({"embed": layer_p}, cfg, act, prefix)
        return LM.apply_layer(params or {}, cfg, j, layer_p, act,
                              LM._positions(act))

    def layer_key(j):
        if j == 0:
            return ("embed",)
        if j == Lu - 1:
            return ("head",)
        return ("blk", cfg.layer_types[j - 1])  # same btype => same step

    def layer_ctx(p, j):
        # the head under tied embeddings reads the embedding matrix; every
        # other layer is self-contained
        if j == Lu - 1 and cfg.tie_embeddings:
            return {"embed": p["embed"]}
        return None

    def tokens_only(logits, labels):
        # the prefix's positions carry no label
        if P > 0 and logits.shape[1] != labels.shape[1]:
            return logits[:, P:]
        return logits

    def fc(params, tokens):
        acts = [tokens]
        x = apply_layer(params, 0, params["embed"], tokens)
        for j in range(1, Lu):
            acts.append(x)
            x = apply_layer(params, j, LM.get_layer(params, cfg, j), x)
        if P > 0:
            x = x[:, P:]
        return x, acts

    def loss(logits, labels):
        return LM.softmax_xent(tokens_only(logits, labels), labels,
                               z_loss=0.0)

    def acc(logits, labels):
        return token_accuracy(tokens_only(logits, labels), labels)

    exclude = ((lambda path: "router" in path)
               if (cfg.moe and exclude_router) else None)
    refusal = None
    if P > 0:
        refusal = (
            f"{cfg.name} has a stub modality prefix (prefix_len={P}); the "
            f"reference's layer sweep cannot run such a model: the head's "
            f"output keeps the {P} prefix positions that the loss "
            f"cotangent, taken on the token positions, lacks")
    return ModelAdapter(
        name=cfg.name, n_layers=Lu,
        forward_collect=fc,
        apply_layer=apply_layer,
        get_layer=lambda p, j: LM.get_layer(p, cfg, j),
        set_layer=lambda p, j, s: LM.set_layer(p, cfg, j, s),
        loss=loss, acc=acc,
        layer_fwd_macs=lm_layer_macs(cfg, seq_len),
        int_input_layer0=True,
        exclude=exclude,
        layer_key=layer_key, layer_ctx=layer_ctx,
        device=dev, sweep_refusal=refusal)


# ---------------------------------------------------------------------------
# Encoder-decoder (whisper): the sweep walks the DECODER chain; the encoder
# is the front end (DESIGN.md §5), reached only by a whole-tree edit
# ---------------------------------------------------------------------------
def encdec_adapter(cfg: ED.EncDecConfig, seq_len: int,
                   frames: torch.Tensor, *, device="cuda") -> ModelAdapter:
    """inputs = decoder tokens [N, S] (integer ids, never cast); labels
    [N, S]; ``frames`` [N_f, n_frames, d_model] the stub frontend's
    embeddings, fixed for the adapter. Layers: j = 0 the embedding, the
    decoder blocks, then the head (``final_norm`` and ``lm_head``).

    A decoder block re-encodes ``frames`` with the full tree it is given,
    on every call, as the reference does; the memory takes no part in any
    gradient, so the encoder is never edited. With no ``layer_ctx`` the
    engine hands every layer the full tree, and the scanned planner
    declines the model (the reference's too). The cross attention
    reshapes the memory's keys by the query's batch: a vjp chunk smaller
    than ``frames``' batch attends each row to several rows' frames, as
    in the reference (ROADMAP Queue 3)."""
    dev = resolve_device(device)
    Lu = cfg.n_dec_layers + 2  # embed + decoder blocks + head
    D, F, V_ = cfg.d_model, cfg.d_ff, cfg.vocab
    S, M = seq_len, cfg.n_frames
    block = (S * D * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.dh * 2
             + 2 * S * S * D + 2 * S * M * D + 3 * S * D * F)
    macs = [0] + [block] * cfg.n_dec_layers + [S * D * V_]

    def apply_layer(params, j, layer_p, act):
        if j == 0:
            return layer_p["w"].to(cfg.dtype)[act]
        if j == Lu - 1:
            return ED._logits(layer_p, cfg, act)
        with torch.no_grad():
            memory = ED.encode(params, cfg, frames)
        return ED.dec_block(layer_p, cfg, act, memory, LM._positions(act))

    def get_layer(p, j):
        if j == 0:
            return p["embed"]
        if j == Lu - 1:
            return {"final_norm": p["final_norm"], "lm_head": p["lm_head"]}
        return index_tree(p["decoder"], j - 1)

    def set_layer(p, j, s):
        p = dict(p)
        if j == 0:
            p["embed"] = s
        elif j == Lu - 1:
            p["final_norm"] = s["final_norm"]
            p["lm_head"] = s["lm_head"]
        else:
            p["decoder"] = tree_map(
                lambda full, sub: LM._set_row(full, j - 1, sub),
                p["decoder"], s)
        return p

    def fc(params, tokens):
        acts = [tokens]
        x = apply_layer(params, 0, params["embed"], tokens)
        for j in range(1, Lu):
            acts.append(x)
            x = apply_layer(params, j, get_layer(params, j), x)
        return x, acts

    def loss(logits, labels):
        return LM.softmax_xent(logits, labels, z_loss=0.0)

    def layer_key(j):
        # the decoder blocks share one fused step; no layer_ctx: the
        # engine passes the full tree, which apply_layer re-encodes from
        if j == 0:
            return ("embed",)
        if j == Lu - 1:
            return ("head",)
        return ("blk",)

    return ModelAdapter(
        name=cfg.name, n_layers=Lu,
        forward_collect=fc,
        apply_layer=apply_layer,
        get_layer=get_layer, set_layer=set_layer,
        loss=loss, acc=token_accuracy,
        layer_fwd_macs=macs, int_input_layer0=True,
        layer_key=layer_key, device=dev)
