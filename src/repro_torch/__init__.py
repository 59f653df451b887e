"""FiCABU on PyTorch and CUDA: the port of the JAX package ``repro``.

Module names mirror ``repro`` so each module's counterpart is easy to find.
Parameters are plain nested dicts of tensors with the same keys as the JAX
trees; the code is plain functions on tensors. Every entry point takes
``device=`` and defaults to ``"cuda"``; without a card it raises instead of
running on the host (see ``repro_torch.device``).

This package imports ``torch``, numpy and the standard library only — never
``jax`` and never ``repro`` (tests/test_torch_isolation.py holds that).
"""
