"""Llama-4 Scout 17B-A16E — MoE 16 experts top-1 (+shared), early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.models.lm import LMConfig, MoESpec

from .base import FULL_ATTENTION_SKIP, ArchSpec, register

FULL = LMConfig(
    name="llama4-scout-17b-a16e", n_layers=48, d_model=5120, n_heads=40,
    n_kv_heads=8, d_ff=8192, vocab=202048, head_dim=128,
    moe=MoESpec(num_experts=16, top_k=1, shared_ff=8192,
                capacity_factor=1.25),
    rope_theta=500_000.0, param_dtype="bfloat16")

SMOKE = LMConfig(
    name="llama4-scout-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=64, vocab=256, head_dim=16,
    moe=MoESpec(num_experts=4, top_k=1, shared_ff=64))

SPEC = register(ArchSpec(
    arch_id="llama4-scout-17b-a16e", kind="lm", full=FULL, smoke=SMOKE,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP}))
