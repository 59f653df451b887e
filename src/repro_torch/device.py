"""Explicit device selection for the port's entry points.

``resolve_device("cuda")`` raises when there is no card: the port never
quietly runs on the host. Pass ``device="cpu"`` to run the plain PyTorch
path (the tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names an absent card.

    On the CUDA path this also turns TF32 off for cuDNN convolutions and
    cuBLAS matmuls, process-wide. The JAX reference computes in full f32,
    and cuDNN convolutions default to TF32, which keeps about three decimal
    digits: that would move the Fisher, and with it the selection masks and
    the halting decision. cuBLAS may also reduce a bf16 product in reduced
    precision (``allow_bf16_reduced_precision_reduction``, on by default);
    the reference accumulates bf16 products in f32, so that goes off too."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} asks for a CUDA card, but "
                f"torch.cuda.is_available() is False; pass device='cpu' to "
                f"run the plain PyTorch path on the host")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        if dev.index is None:  # "cuda" and "cuda:<current>" are one device
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev
