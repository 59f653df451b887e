"""Kimi K2 — trillion-param MoE, 384 experts top-8 (+1 shared), GQA kv=8.
[arXiv:2501.kimi2; unverified, paper-table]"""
from repro_torch.models.lm import LMConfig, MoESpec

from .base import FULL_ATTENTION_SKIP, ArchSpec, register

FULL = LMConfig(
    name="kimi-k2-1t-a32b", n_layers=61, d_model=7168, n_heads=64,
    n_kv_heads=8, d_ff=2048, vocab=163840, head_dim=128,
    moe=MoESpec(num_experts=384, top_k=8, shared_ff=2048,
                capacity_factor=1.25),
    rope_theta=1_000_000.0, param_dtype="bfloat16")

SMOKE = LMConfig(
    name="kimi-k2-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=32, vocab=256, head_dim=16,
    moe=MoESpec(num_experts=8, top_k=2, shared_ff=32))

SPEC = register(ArchSpec(
    arch_id="kimi-k2-1t-a32b", kind="lm", full=FULL, smoke=SMOKE,
    source="arXiv:2501.kimi2; unverified",
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP}))
