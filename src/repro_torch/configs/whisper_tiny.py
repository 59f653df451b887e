"""Whisper-tiny — encoder-decoder; the conv/mel frontend is a stub supplying
precomputed frame embeddings. [arXiv:2212.04356; unverified]"""
from repro_torch.models.encdec import EncDecConfig

from .base import ENCDEC_CHUNKED_SKIP, ArchSpec, register

FULL = EncDecConfig(
    name="whisper-tiny", n_enc_layers=4, n_dec_layers=4, d_model=384,
    n_heads=6, n_kv_heads=6, d_ff=1536, vocab=51865, n_frames=1500,
    param_dtype="bfloat16")

SMOKE = EncDecConfig(
    name="whisper-tiny-smoke", n_enc_layers=2, n_dec_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=160, vocab=256, n_frames=32)

SPEC = register(ArchSpec(
    arch_id="whisper-tiny", kind="encdec", full=FULL, smoke=SMOKE,
    source="arXiv:2212.04356; unverified",
    skip_shapes={"long_500k": "enc-dec audio arch: 500k-token decode is out "
                              "of family scope (448-token decoder ceiling)",
                 "prefill_chunked_32k": ENCDEC_CHUNKED_SKIP}))
