"""Public wrappers around the Hopper kernels (the port of
``repro/kernels/ops.py``'s flat-reduction, OTA, flash-attention and
selective-scan entry points).

Dispatch (``impl``):

* ``"auto"`` (default) -- a CUDA tensor launches the hand-written kernel (or
  raises: there is no fallback); a CPU tensor runs the plain version of
  ``repro_torch.kernels.ref``.  The device of the input decides, nothing else.
* ``"kernel"`` -- launch the kernel; raises for a tensor that is not on CUDA.
* ``"plain"`` -- run the plain version on whatever device the input is on
  (``chip_smoke.py`` compares the two on the card with it).

``k_block`` selects the streamed kernels (the K-way work tiled into K-blocks
of that many devices, which must divide K).  ``LAUNCH_COUNTS`` counts kernel
launches per kernel; plain calls do not count.  A wrapper called while a
CUDA graph is captured launches nothing: ``capture_counts`` takes back what
such calls counted and ``replay_counts`` adds it again at each replay, so the
counts hold the launches the card ran under either driver.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (check_heads, check_window,
                                                 flash_attention_cuda)
from repro_torch.kernels.grad_norm import (batched_moments_cuda, norm_cuda,
                                           streaming_moments_cuda)
from repro_torch.kernels.ota_aggregate import (ota_superpose_cuda,
                                               ota_superpose_streaming_cuda)
from repro_torch.kernels.selective_scan import (check_scan_shapes,
                                                selective_scan_cuda)

IMPLS = ("auto", "kernel", "plain")

LAUNCH_COUNTS: Dict[str, int] = {
    "batched_moments": 0, "ota_superpose": 0, "streaming_moments": 0,
    "ota_superpose_streaming": 0, "sumsq": 0, "flash_attention": 0,
    "selective_scan": 0}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


@contextlib.contextmanager
def capture_counts() -> Iterator[Dict[str, int]]:
    """Around a CUDA-graph capture: yields a dict that, on exit, holds the
    launches each replay of the graph makes, and takes them back out of
    ``LAUNCH_COUNTS`` (the capture itself ran nothing)."""
    before = dict(LAUNCH_COUNTS)
    per_replay: Dict[str, int] = {}
    try:
        yield per_replay
    finally:
        for name, n in before.items():
            per_replay[name] = LAUNCH_COUNTS[name] - n
            LAUNCH_COUNTS[name] = n


def replay_counts(per_replay: Dict[str, int], replays: int = 1) -> None:
    """Count the launches of ``replays`` replays of a captured graph."""
    for name, n in per_replay.items():
        LAUNCH_COUNTS[name] += n * replays


def _use_kernel(t: torch.Tensor, impl: str) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {IMPLS}")
    if impl == "plain":
        return False
    if impl == "kernel" or t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain route for device {t.device}")


def grad_norm(x: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """Global L2 norm (0-d fp32) of a gradient vector of any shape (on the
    card one launch: the sum of squares and its root)."""
    if _use_kernel(x, impl):
        norm = norm_cuda(x.reshape(-1).contiguous())
        LAUNCH_COUNTS["sumsq"] += 1
        return norm
    return ref.grad_norm_ref(x)


def batched_moments(g: torch.Tensor, *, impl: str = "auto",
                    k_block: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-device (sum of squares, sum) of stacked flat gradients g [K, N].
    Returns ([K], [K]) fp32.  ``k_block`` streams the devices K-block by
    K-block (the streamed kernel)."""
    if k_block is not None:
        kb = ref.k_block_size(g.shape[0], k_block)
        if _use_kernel(g, impl):
            out = streaming_moments_cuda(g, kb)
            LAUNCH_COUNTS["streaming_moments"] += 1
            return out
        return ref.streaming_moments_ref(g, kb)
    if _use_kernel(g, impl):
        out = batched_moments_cuda(g)
        LAUNCH_COUNTS["batched_moments"] += 1
        return out
    return ref.batched_moments_ref(g)


def batched_grad_norms(g: torch.Tensor, *, impl: str = "auto"
                       ) -> torch.Tensor:
    """[K] global L2 norms of stacked flat gradients."""
    sumsq, _ = batched_moments(g, impl=impl)
    return torch.sqrt(sumsq)


def _gain(a, g: torch.Tensor) -> torch.Tensor:
    """The gain as the 0-d fp32 tensor on ``g``'s device that K2 and K4
    read: a python float is written there by a fill (no host copy, so the
    call can be captured in a CUDA graph, which then keeps the value)."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.full((), float(a), dtype=torch.float32, device=g.device)


def ota_superpose(g: torch.Tensor, scale: torch.Tensor, noise: torch.Tensor,
                  a, *, pre: str = "identity", impl: str = "auto",
                  k_block: Optional[int] = None) -> torch.Tensor:
    """Fused superposition y = a (sum_k scale_k pre(g_k) + z) (paper eq. 10).

    g: [K, N]; scale: [K] composite per-device scale; noise: [N]; a: scalar
    receiver gain, a python float or a 0-d fp32 tensor on g's device (the
    kernels read it there, never on the host); pre: 'identity' | 'sign'.
    ``k_block`` folds the K-way sum K-block by K-block in order (the
    streamed kernel).  Returns y [N] fp32."""
    if k_block is not None:
        kb = ref.k_block_size(g.shape[0], k_block)
        if _use_kernel(g, impl):
            y = ota_superpose_streaming_cuda(g, scale, noise, _gain(a, g), kb,
                                             pre=pre)
            LAUNCH_COUNTS["ota_superpose_streaming"] += 1
            return y
        return ref.ota_superpose_streaming_ref(g, scale, noise, a, pre=pre,
                                               k_block=kb)
    if _use_kernel(g, impl):
        y = ota_superpose_cuda(g, scale, noise, _gain(a, g), pre=pre)
        LAUNCH_COUNTS["ota_superpose"] += 1
        return y
    return ref.ota_superpose_ref(g, scale, noise, a, pre=pre)


def ota_aggregate(g: torch.Tensor, hb: torch.Tensor, norms: torch.Tensor,
                  noise: torch.Tensor, a, *, impl: str = "auto"
                  ) -> torch.Tensor:
    """Fused normalize-amplify-superpose (eq. 10 with eq. 12): the
    ``normalized``-scheme specialization of ``ota_superpose`` for callers
    that already hold per-device norms."""
    scale = hb.float() / (norms.float() + 1e-12)
    return ota_superpose(g, scale, noise, a, impl=impl)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    impl: str = "auto") -> torch.Tensor:
    """Flash attention over q [B, H, S, d] and k, v [B, Hkv, S, d]: the
    reference's signature (there kv is head-expanded, Hkv = H), which the
    port widens to grouped-query kv (Hkv dividing H), read without an
    expanded copy.  fp32 scores and softmax; returns [B, H, S, d] in
    q.dtype.  The output does not depend on any tiling."""
    check_heads(q, k, v)
    check_window(window)
    if _use_kernel(q, impl):
        o = flash_attention_cuda(q, k, v, causal=causal, window=window)
        LAUNCH_COUNTS["flash_attention"] += 1
        return o
    return ref.attention_ref(q, k, v, causal=causal, window=window)


def selective_scan(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   bmat: torch.Tensor, cmat: torch.Tensor, *,
                   return_state: bool = False, impl: str = "auto"):
    """The Mamba selective scan: y_t = <h_t, C_t> with
    h_t = exp(dt_t a) h_{t-1} + dt_t u_t B_t, h_0 = 0.

    u: [B, S, D] bf16 or fp32; dt: [B, S, D] fp32; a: [D, N] fp32 (the
    discretized -exp(A_log)); bmat, cmat: [B, S, N] of u's type.  Returns y
    [B, S, D] fp32, and with ``return_state=True`` (y, h_S [B, D, N] fp32).
    The kernel (K7) takes N up to 16 and any S and D."""
    check_scan_shapes(u, dt, a, bmat, cmat)
    if _use_kernel(u, impl):
        out = selective_scan_cuda(u, dt, a, bmat, cmat,
                                  return_state=return_state)
        LAUNCH_COUNTS["selective_scan"] += 1
        return out
    return ref.selective_scan_ref(u, dt, a, bmat, cmat,
                                  return_state=return_state)
