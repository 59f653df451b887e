"""Gemma3-1B — 5:1 local:global attention, 262k vocab, tied embeddings.
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.models.lm import LMConfig

from .base import ArchSpec, register

# 26 layers: four (local x5, global x1) periods + 2 tail local layers.
FULL = LMConfig(
    name="gemma3-1b", n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1,
    d_ff=6912, vocab=262144, head_dim=256,
    block_pattern=("local", "local", "local", "local", "local", "attn"),
    window=512, rope_theta=1_000_000.0, tie_embeddings=True,
    sub_quadratic=True,  # long decode: local windows dominate
    param_dtype="bfloat16")

SMOKE = LMConfig(
    name="gemma3-1b-smoke", n_layers=8, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=160, vocab=256, head_dim=16,
    block_pattern=("local", "local", "local", "local", "local", "attn"),
    window=16, tie_embeddings=True, sub_quadratic=True)

SPEC = register(ArchSpec(
    arch_id="gemma3-1b", kind="lm", full=FULL, smoke=SMOKE,
    source="hf:google/gemma-3-1b-pt; unverified"))
