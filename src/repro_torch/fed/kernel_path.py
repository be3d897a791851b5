"""Kernel-accelerated aggregation: the ``kernels`` backend of
``repro_torch.core.ota.aggregate`` (port of ``repro/fed/kernel_path.py``).

The round's hot loop on the card is two memory-bound sweeps over the stacked
[K, N] fp32 gradient:

1. ONE moments launch (``ops.batched_moments``) gives every device's sum of
   squares and sum -- the norms of ``normalized``/``clipped``/``benchmark1``
   and the mean/std of ``benchmark2`` from one pass.
2. ONE fused superposition launch (``ops.ota_superpose``) takes the
   per-device composite scale ``h_k b_k * scheme.device_scale(stats)`` and
   the in-register pre-transform (``sign`` for onebit).  A per-device shift
   (benchmark2's ``-mean``) folds into one scalar correction after the
   kernel.  ``normalized_per_tensor`` runs one moments launch per leaf (a
   loop over tensors, never over devices).

With ``k_block`` both launches are the streamed kernels: the moments tile
the devices into K-blocks, and the superposition folds the K-way sum
K-block by K-block in order (``ops.*(k_block=)``).

On CUDA tensors the ops launch the Hopper kernels; on CPU tensors they run
the plain versions (the tests).  ``mean`` is the ideal non-OTA baseline and
is a plain average.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import schemes
from repro_torch.core.ota import device_template, unravel
from repro_torch.core.schemes import Tree
from repro_torch.kernels import ops


def aggregate_kernels(cfg, stacked_grads: Tree, h: torch.Tensor,
                      b: torch.Tensor, noise: Optional[torch.Tensor] = None,
                      *, h_hat: Optional[torch.Tensor] = None,
                      k_block: Optional[int] = None) -> Tree:
    """Kernel implementation of ``aggregate`` for any registered scheme.
    stacked_grads: tree of [K, ...] leaves; ``noise``: the flat channel
    noise z [N] in sorted-key leaf order (None: noiseless).  ``h`` is the
    true channel folded into the superposition scale; ``h_hat`` the server's
    estimate, used only by the side-info fold.  Returns the update
    direction y with the single-device tree structure.  ``k_block`` routes
    both launches through the streamed kernels; it must divide K."""
    if h_hat is None:
        h_hat = h
    sch = schemes.validate_config(cfg.scheme, cfg.grad_bound)
    if sch.baseline:
        return schemes.tree_map(lambda l: torch.mean(l, dim=0), stacked_grads)

    leaves = schemes.leaves(stacked_grads)
    k = leaves[0].shape[0]
    flat2d = [l.float().reshape(k, -1) for l in leaves]
    hb = (h * b).float()

    shift = None
    kernel_pre = sch.pre
    if sch.per_tensor:
        # per-(device, tensor) scales: one moments launch per LEAF covering
        # all K devices; pre must apply BEFORE the tensor scales (matching
        # schemes.transform), so it runs here and the kernel sees identity
        pre_fn = schemes.PRE_TRANSFORMS[sch.pre]
        kernel_pre = "identity"
        tensor_sq = tuple(
            ops.batched_moments(l2.contiguous(), k_block=k_block)[0]
            for l2 in flat2d)
        stats = schemes.DeviceStats(
            count=sum(l2.shape[1] for l2 in flat2d),
            sq_norm=sum(tensor_sq), tensor_sq_norms=tensor_sq)
        scales = sch.tensor_scale(stats, cfg.grad_bound)
        flat = torch.cat(
            [pre_fn(l2) * s[:, None] for l2, s in zip(flat2d, scales)], dim=1)
        scale = hb
    else:
        flat = torch.cat(flat2d, dim=1)
        sumsq, total = ops.batched_moments(flat, k_block=k_block)
        stats = schemes.DeviceStats(
            count=flat.shape[1], sq_norm=sumsq,
            total=total if sch.needs_moments else None)
        scale = sch.device_scale(stats, cfg.grad_bound)
        if sch.device_shift is not None:
            shift = sch.device_shift(stats, cfg.grad_bound)
        scale = scale * hb

    n = flat.shape[1]
    if noise is None:
        noise = torch.zeros((n,), dtype=torch.float32, device=flat.device)
    y_flat = ops.ota_superpose(flat, scale.float().contiguous(),
                               noise.contiguous(), cfg.a, pre=kernel_pre,
                               k_block=k_block)
    if shift is not None:
        # sum_k scale_k (g_k + shift_k) = kernel result + a sum_k scale_k shift_k
        y_flat = y_flat + cfg.a * torch.sum(scale * shift)

    y = unravel(y_flat, device_template(stacked_grads))
    if sch.server_post is not None:
        folded = {}
        if sch.collect_side is not None:
            folded = schemes.fold_side_stacked(sch.collect_side(stats),
                                               h_hat, b)
        y = sch.server_post(y, folded)
    return y
