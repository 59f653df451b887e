"""Explicit device selection for the port's entry points.

``resolve_device("cuda")`` raises when there is no card: the port never
quietly runs on the host. Pass ``device="cpu"`` to run the plain PyTorch
path (the tests do).
"""
from __future__ import annotations

import contextlib
import os

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


@contextlib.contextmanager
def deterministic(device):
    """Deterministic algorithms while the block runs on a CUDA ``device``,
    the process's setting restored after; on the host, nothing.

    On the card the embedding's gradient accumulates by atomics otherwise,
    so two Fishers of the same weights and data differ in their last bits,
    and with them a gate that holds one run bit for bit against another
    (``serve --fleet --check``'s solo replay, the load harness's
    fingerprint). cuBLAS needs ``CUBLAS_WORKSPACE_CONFIG`` before its first
    use in the process: it is set here where the caller left it unset.
    Without a card this does nothing either: ``resolve_device`` raises."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        yield
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
