"""Qwen1.5-32B — dense GQA (kv=40 == MHA at this size) with QKV bias.
[hf:Qwen/Qwen1.5-0.5B family scaling; hf]"""
from repro_torch.models.lm import LMConfig

from .base import FULL_ATTENTION_SKIP, ArchSpec, register

FULL = LMConfig(
    name="qwen1.5-32b", n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=27392, vocab=152064, head_dim=128, qkv_bias=True,
    rope_theta=1_000_000.0, param_dtype="bfloat16")

SMOKE = LMConfig(
    name="qwen1.5-32b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=160, vocab=256, head_dim=16, qkv_bias=True)

SPEC = register(ArchSpec(
    arch_id="qwen1.5-32b", kind="lm", full=FULL, smoke=SMOKE,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP}))
