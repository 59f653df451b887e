"""A configuration file (``configs/<name>.json``) as the harness reads it:
the published ``config.json`` keys of a dense decoder LM, with the keys
cut from the source (depth) listed under ``reduced`` and those the port
cannot run as published under ``departures``; ``BENCHMARK.json``'s
``reduced`` lists both, as every key changed from the source."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict


@dataclasses.dataclass(frozen=True)
class Dims:
    """The sizes the model, the reference and the counts need."""
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float
    rms_norm_eps: float
    qkv_bias: bool
    dtype: str

    @property
    def n_unlearn_layers(self) -> int:
        """The paper's layers: the embedding, every block, the head."""
        return self.n_layers + 2


def dims_of(cfg: Dict[str, Any]) -> Dims:
    heads = int(cfg["num_attention_heads"])
    return Dims(
        n_layers=int(cfg["num_hidden_layers"]),
        d_model=int(cfg["hidden_size"]),
        n_heads=heads,
        n_kv_heads=int(cfg["num_key_value_heads"]),
        head_dim=int(cfg.get("head_dim") or cfg["hidden_size"] // heads),
        d_ff=int(cfg["intermediate_size"]),
        vocab=int(cfg["vocab_size"]),
        rope_theta=float(cfg["rope_theta"]),
        rms_norm_eps=float(cfg["rms_norm_eps"]),
        qkv_bias=bool(cfg.get("qkv_bias", False)),
        dtype=str(cfg["torch_dtype"]))


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)
