"""The dry run's counts (``repro_torch.launch.dryrun``): the counted FLOPs
of two FULL-width cells against a count made by hand from the model's
shapes, the data floor of the decode cell, and the count from one and two
periods (and two loop lengths) against the count of the whole program."""
import dataclasses

import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.configs import SHAPES, ShapeCell
from repro_torch.launch import dryrun as DR
from repro_torch.launch import specs as TS
from repro_torch.launch.mesh import AbstractMesh

torch.set_num_threads(2)
CARD = "NVIDIA H100 80GB HBM3"
QWEN2 = {"n_layers": 2}


def _qwen_products(cfg):
    """(weights of one block's products, of the MLP's down projection, of
    the unembedding) of a dense decoder with no MoE."""
    d, H, KV, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    block = d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * F
    return block, F * d, d * cfg.vocab


def test_decode_flops_and_data_floor_by_hand():
    """qwen1.5-32b x decode_32k at full width and 2 blocks, one rank of
    16 x 16 (8 of 128 rows): 2 FLOPs per weight of every product per row,
    and QK^T and PV over the whole 32,768-slot cache, exactly. The data
    floor reads the bf16 weights and the cache once."""
    rec = DR.run_cell("qwen1.5-32b", "decode_32k", False, QWEN2, card=CARD,
                      device="cpu")
    cfg = tconfigs.get("qwen1.5-32b").full.with_(**QWEN2)
    r, S, L = rec["count"]["rows_per_rank"], SHAPES["decode_32k"].seq_len, 2
    assert r == 8
    block, _, head = _qwen_products(cfg)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    want = 2 * r * (L * block + head) + L * 2 * (2 * r * H * hd * S)
    assert rec["cost"]["flops"] == want
    cache = 2 * L * r * S * KV * hd * 2          # k and v, bf16
    args = rec["memory"]["argument_size_in_bytes"]
    assert 0 <= args - (2 * rec["n_params"] + cache) <= 8 * r   # the token
    assert rec["roofline"]["data_floor_s"] == pytest.approx(args / 3.35e12)
    assert rec["roofline"]["memory_s"] > rec["roofline"]["data_floor_s"]


def test_train_flops_by_hand():
    """qwen1.5-32b x train_4k at full width and 2 blocks, one rank of
    16 x 16 (16 of 256 rows, T = 16 x 4096 tokens), remat on: each
    product's forward 2 FLOPs per weight and token, its backward 4, the
    period's recompute 2 for every product but the down projection (the
    non-reentrant checkpoint stops at the last tensor the backward saved,
    and the down projection's output only enters the residual sum); the
    unembedding 6, outside any checkpoint. Attention per layer in units of
    one product 2 r H hd S^2: QK^T three times (the forward, the period's
    recompute, its query block's recompute), PV twice (the query block's
    recompute stops before it), their backward four: 9. Exactly."""
    rec = DR.run_cell("qwen1.5-32b", "train_4k", False, QWEN2, card=CARD,
                      device="cpu")
    cfg = tconfigs.get("qwen1.5-32b").full.with_(**QWEN2)
    r, S, L = rec["count"]["rows_per_rank"], SHAPES["train_4k"].seq_len, 2
    assert r == 16 and S > 2 * 512
    T = r * S
    block, down, head = _qwen_products(cfg)
    mm = 6 * L * block * T + 2 * L * (block - down) * T + 6 * head * T
    attn = L * 9 * (2 * r * cfg.n_heads * cfg.head_dim * S * S)
    assert rec["cost"]["flops"] == mm + attn


def _whole_count(spec, shape, mesh):
    cell = TS.build_cell(spec, shape, mesh)
    kind = SHAPES[shape].kind
    return DR.count_program(cell.fn, DR.rank_args(cell, kind, 1))


KEYS = ("flops", "bytes", "ops", "argument_size_in_bytes",
        "output_size_in_bytes")


@pytest.mark.parametrize("arch,shape,cut", [
    ("xlstm-125m", "train_4k", ShapeCell("train_4k", 16, 2, "train")),
    ("xlstm-125m", "prefill_32k", ShapeCell("prefill_32k", 16, 2,
                                            "prefill")),
    ("gemma3-1b", "prefill_chunked_32k",
     ShapeCell("prefill_chunked_32k", 20, 2, "prefill_chunked")),
    ("whisper-tiny", "train_4k", ShapeCell("train_4k", 16, 2, "train"))])
def test_extrapolated_count_equals_the_whole_count(monkeypatch, arch, shape,
                                                   cut):
    """At a small S the count from one and two periods (and, for an sLSTM
    model's time loop or a token-by-token prefill, two loop lengths)
    equals the count of the whole program, exactly. The loops run past
    their probes: four mLSTM chunks of 4 against probes at two and three,
    20 tokens through a 16-token window against probes at one and two."""
    smoke = tconfigs.get(arch).smoke
    if arch == "xlstm-125m":
        smoke = smoke.with_(n_layers=12, mlstm_chunk=4)
    elif arch == "gemma3-1b":
        smoke = smoke.with_(n_layers=3 * len(smoke.block_pattern))
    else:
        smoke = smoke.with_(n_enc_layers=3, n_dec_layers=3)
    spec = dataclasses.replace(tconfigs.get(arch), full=smoke)
    monkeypatch.setitem(SHAPES, shape, cut)
    mesh = AbstractMesh((1, 1), ("data", "model"))
    assert TS.n_periods_of(spec) == 3
    _, c = DR.count_cell(spec, shape, mesh)
    assert c["counts"] == (2 if arch == "whisper-tiny" else 4)
    whole = _whole_count(spec, shape, mesh)
    assert {k: c[k] for k in KEYS} == {k: whole[k] for k in KEYS}
