"""Yi-6B — llama-arch dense GQA. [arXiv:2403.04652; hf]"""
from repro_torch.models.lm import LMConfig

from .base import FULL_ATTENTION_SKIP, ArchSpec, register

FULL = LMConfig(
    name="yi-6b", n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab=64000, head_dim=128, rope_theta=5_000_000.0,
    param_dtype="bfloat16")

SMOKE = LMConfig(
    name="yi-6b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=160, vocab=256, head_dim=16)

SPEC = register(ArchSpec(
    arch_id="yi-6b", kind="lm", full=FULL, smoke=SMOKE,
    source="arXiv:2403.04652; hf",
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP}))
