"""Plain PyTorch versions of the Hopper kernels (the allclose targets).

Ported from ``repro/kernels/ref.py``.  The kernel wrappers run these for
tensors on the CPU; ``chip_smoke.py`` holds each CUDA kernel against them on
the card.  Nothing on the GPU path calls them.
"""
from __future__ import annotations

import torch


def grad_norm_ref(x: torch.Tensor) -> torch.Tensor:
    """Global L2 norm of a flat (or any-shape) gradient vector."""
    return torch.sqrt(torch.sum(torch.square(x.float())))


def batched_moments_ref(g: torch.Tensor):
    """Per-device (sum of squares, sum) of [K, N] stacked flat gradients."""
    gf = g.float()
    return torch.sum(gf * gf, dim=1), torch.sum(gf, dim=1)


def ota_superpose_ref(g: torch.Tensor, scale: torch.Tensor,
                      noise: torch.Tensor, a, pre: str = "identity"
                      ) -> torch.Tensor:
    """y = a * (sum_k scale_k pre(g_k) + z) with pre in {identity, sign}."""
    gf = g.float()
    if pre == "sign":
        gf = torch.sign(gf)
    acc = torch.einsum("k,kn->n", scale.float(), gf)
    return a * (acc + noise.float())
