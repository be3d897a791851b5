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


def blocked_sumsq_ref(x: torch.Tensor, block_rows: int) -> torch.Tensor:
    """Per-block sums of squares of a [rows, cols] view of a flat vector
    (``block_rows`` rows a block; the reference's ``blocked_sumsq``)."""
    rows, cols = x.shape
    br = min(block_rows, rows)
    xb = x.reshape(rows // br, br * cols).float()
    return torch.sum(xb * xb, dim=1)


def k_block_size(k: int, k_block: int) -> int:
    """The effective K-block size (as the reference: at most K); raises
    ``ValueError`` unless it is positive and divides K."""
    if k_block < 1:
        raise ValueError(f"k_block must be >= 1, got {k_block}")
    kb = min(k_block, k)
    if k % kb != 0:
        raise ValueError(f"k_block {kb} must divide K {k}")
    return kb


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


def streaming_moments_ref(g: torch.Tensor, k_block: int):
    """Per-device (sum of squares, sum) of [K, N] stacked flat gradients,
    computed K-block by K-block (only one [k_block, N] block is read at a
    time).  Returns ([K], [K]) fp32."""
    k = g.shape[0]
    kb = k_block_size(k, k_block)
    sq, s = [], []
    for lo in range(0, k, kb):
        bf = g[lo:lo + kb].float()
        sq.append(torch.sum(bf * bf, dim=1))
        s.append(torch.sum(bf, dim=1))
    return torch.cat(sq), torch.cat(s)


def ota_superpose_streaming_ref(g: torch.Tensor, scale: torch.Tensor,
                                noise: torch.Tensor, a,
                                pre: str = "identity", *,
                                k_block: int) -> torch.Tensor:
    """y = a * (sum_k scale_k pre(g_k) + z) with the K-way sum folded
    K-block by K-block, in order, into one fp32 accumulator:
    acc = ((p_0 + p_1) + p_2) + ..., p_b the block's partial sum (the
    association order of the reference's streaming kernel)."""
    k, n = g.shape
    kb = k_block_size(k, k_block)
    sf = scale.float()
    acc = torch.zeros((n,), dtype=torch.float32, device=g.device)
    for lo in range(0, k, kb):
        bf = g[lo:lo + kb].float()
        if pre == "sign":
            bf = torch.sign(bf)
        acc = acc + torch.einsum("k,kn->n", sf[lo:lo + kb], bf)
    return a * (acc + noise.float())
