"""InternVL2-1B — InternViT frontend (STUB: precomputed patch embeddings)
+ InternLM2/Qwen2-0.5B-class LM backbone. [arXiv:2404.16821; hf]"""
from repro_torch.models.lm import LMConfig

from .base import (FULL_ATTENTION_SKIP, PREFIX_CHUNKED_SKIP, ArchSpec,
                   register)

FULL = LMConfig(
    name="internvl2-1b", n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151655, head_dim=64, qkv_bias=True,
    rope_theta=1_000_000.0, prefix_len=256,   # 256 stub vision tokens
    param_dtype="bfloat16")

SMOKE = LMConfig(
    name="internvl2-1b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=160, vocab=256, head_dim=16, qkv_bias=True, prefix_len=8)

SPEC = register(ArchSpec(
    arch_id="internvl2-1b", kind="lm", full=FULL, smoke=SMOKE,
    source="arXiv:2404.16821; hf",
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP,
                 "prefill_chunked_32k": PREFIX_CHUNKED_SKIP}))
