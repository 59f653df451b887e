"""Architecture registry of the port (``repro.configs.base``): an arch is a
selectable config carrying its FULL published config, a REDUCED smoke
config (CPU-runnable) and its input-shape cells.

The port registers the archs it builds (all ten of the reference's since
the encoder-decoder came); ``get`` of any other name raises a ``KeyError``
that names them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode" | "long_decode"


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    # the serving prefill program: one chunked-prefill block against a 32k
    # decode cache
    "prefill_chunked_32k": ShapeCell("prefill_chunked_32k", 32_768, 32,
                                     "prefill_chunked"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "long_decode"),
}

ENCDEC_CHUNKED_SKIP = ("enc-dec serving prefills the short decoder prompt "
                       "full-sequence; chunked prefill targets LM prompts")
PREFIX_CHUNKED_SKIP = ("stub modality prefix is injected ahead of the token "
                       "stream; chunked prefill covers the token path only")


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    kind: str                    # "lm" | "encdec"
    full: Any                    # LMConfig | EncDecConfig (the published config)
    smoke: Any                   # reduced same-family config
    source: str                  # provenance tag
    skip_shapes: Dict[str, str] = dataclasses.field(default_factory=dict)

    def shapes(self) -> Tuple[str, ...]:
        return tuple(s for s in SHAPES if s not in self.skip_shapes)


_REGISTRY: Dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    if spec.arch_id in _REGISTRY:
        raise ValueError(
            f"duplicate arch registration: {spec.arch_id!r} is already in "
            "the registry")
    _REGISTRY[spec.arch_id] = spec
    return spec


def get(arch_id: str) -> ArchSpec:
    archs = all_archs()
    if arch_id not in archs:
        raise KeyError(f"arch {arch_id!r} is not ported (or unknown); the "
                       f"port builds {sorted(archs)}")
    return archs[arch_id]


def all_archs() -> Dict[str, ArchSpec]:
    if not _REGISTRY:
        from . import _load_all  # lazy: populate on first access
        _load_all()
    return dict(_REGISTRY)


FULL_ATTENTION_SKIP = "pure full-attention arch: 500k decode cache/compute is O(S) per token with no sub-quadratic path; skipped per assignment"
