"""xLSTM-125M — mLSTM + sLSTM blocks (3:1 ratio), no FFN (d_ff=0).
[arXiv:2405.04517; unverified]"""
from repro_torch.models.lm import LMConfig

from .base import ArchSpec, register

FULL = LMConfig(
    name="xlstm-125m", n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, head_dim=192,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    mlstm_chunk=128, sub_quadratic=True, param_dtype="bfloat16")

SMOKE = LMConfig(
    name="xlstm-125m-smoke", n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
    d_ff=0, vocab=256, head_dim=32,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    mlstm_chunk=8, sub_quadratic=True)

SPEC = register(ArchSpec(
    arch_id="xlstm-125m", kind="lm", full=FULL, smoke=SMOKE,
    source="arXiv:2405.04517; unverified"))
