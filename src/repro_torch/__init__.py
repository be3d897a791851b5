"""PyTorch/CUDA port of the OTA federated-learning system for NVIDIA Hopper.

A second package beside the JAX reference ``repro``: the same module tree,
PyTorch inside, hand-written Hopper kernels for the FL round's hot path.  It
imports neither ``jax`` nor ``repro``.  Entry points take ``device`` and
default to ``"cuda"``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
