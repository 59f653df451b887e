"""RecurrentGemma-9B — Griffin: RG-LRU recurrent blocks + local attention,
2:1 recurrent:attention. [arXiv:2402.19427; unverified]"""
from repro_torch.models.lm import LMConfig

from .base import ArchSpec, register

# 38 layers: twelve (rglru, rglru, local) periods + 2 tail rglru layers.
FULL = LMConfig(
    name="recurrentgemma-9b", n_layers=38, d_model=4096, n_heads=16,
    n_kv_heads=1, d_ff=12288, vocab=256000, head_dim=256,
    block_pattern=("rglru", "rglru", "local"), window=2048,
    d_rnn=5464, sub_quadratic=True, param_dtype="bfloat16")

SMOKE = LMConfig(
    name="recurrentgemma-9b-smoke", n_layers=8, d_model=64, n_heads=4,
    n_kv_heads=1, d_ff=160, vocab=256, head_dim=16,
    block_pattern=("rglru", "rglru", "local"), window=16, d_rnn=88,
    sub_quadratic=True)

SPEC = register(ArchSpec(
    arch_id="recurrentgemma-9b", kind="lm", full=FULL, smoke=SMOKE,
    source="arXiv:2402.19427; unverified"))
