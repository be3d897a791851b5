"""Fused OTA superposition on the card: the wrappers of
``csrc/ota_superpose.cu``'s two entry points, the Hopper ports of
``repro/kernels/ota_aggregate.py``'s ``ota_aggregate_blocked`` and
``ota_aggregate_streaming``.

``ota_superpose_cuda(g, scale, noise, a, pre)`` computes the paper's eq. 10,
``y = a (sum_k scale_k pre(g_k) + z)``, in one pass over the [K, N] fp32
stack, with the gain ``a`` a 0-d fp32 tensor that the kernel reads from
device memory (so a CUDA graph replays it with each round's value); ``ota_superpose_streaming_cuda(..., k_block, pre)`` computes the same
with the K-way sum folded K-block by K-block in order.  Ragged N is masked
in the kernels, not padded.  ``superpose_split(k, n)`` is the number of
K-chunks the first kernel splits its sum into (folded in chunk order);
``stream_split(k, n, k_block)`` the number of chunks of whole K-blocks the
streamed one does (its block partials folded in block order).
Public callers go through ``repro_torch.kernels.ops``, which counts the
launches and serves CPU tensors with the plain versions.
"""
from __future__ import annotations

import ctypes
import torch

from repro_torch.kernels import _launch

PRE_KINDS = ("identity", "sign")

SUPERPOSE_THREADS = 256      # columns a CTA (kThreads, csrc/ota_superpose.cu)
SUPERPOSE_CTAS_PER_SM = 8    # such CTAs an SM holds at once (2,048 threads)
SUPERPOSE_MIN_ROWS = 32      # rows a K-chunk holds at least

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# library -> {entry point: (argtypes, restype)}
_ENTRY_POINTS = {
    "ota_superpose": {
        "ota_superpose_launch": (
            [_P, _P, _P, _P, _LL, _LL, _I, _I, _P, _P, _P], _I),
        "ota_superpose_stream_launch": (
            [_P, _P, _P, _P, _LL, _LL, _LL, _I, _I, _P, _P, _P], _I),
    },
}


def superpose_split(k: int, n: int) -> int:
    """S, the number of K-chunks ``csrc/ota_superpose.cu`` sums apart and
    then folds in chunk order, from (K, N) alone: as many as a grid of
    ceil(N / 256) x S CTAs holds in one wave (SUPERPOSE_CTAS_PER_SM on each
    SM), but with at least SUPERPOSE_MIN_ROWS rows a chunk, so that the
    [S, N] partials stay a small share of the bytes moved.  A small K (the
    FL round's 20) or a grid that fills a wave already keeps S = 1: one
    launch.  The chunks hold ceil(K / S) rows each, and none is empty."""
    tiles = -(-n // SUPERPOSE_THREADS)
    s = max(1, min(_launch.SMS * SUPERPOSE_CTAS_PER_SM // tiles,
                   k // SUPERPOSE_MIN_ROWS))
    rows = -(-k // s)
    return -(-k // rows)


def stream_split(k: int, n: int, k_block: int) -> int:
    """S, the number of chunks of whole K-blocks that the streamed kernel
    sums apart, from (K, N, k_block) alone.  Where ``superpose_split``
    keeps one pass (the FL round's K = 20; a grid that fills a wave, as
    N = 1,000,003), S = 1: one launch folds the blocks in registers.
    Otherwise as many chunks as it gives, but at most one a block; each
    chunk holds ceil(nb / S) blocks, none is empty, and the grid stays
    within one wave.  The partials are per block, [nb, N], whatever S."""
    nb = k // k_block
    s = min(nb, superpose_split(k, n))
    per = -(-nb // s)
    return -(-nb // per)


def _library(name: str) -> ctypes.CDLL:
    return _launch.bind(name, _ENTRY_POINTS[name])


def _check(g, scale, noise, a, pre):
    if pre not in PRE_KINDS:
        raise ValueError(f"unknown pre-transform {pre!r}; one of {PRE_KINDS}")
    _launch.check(g, 2, "g")
    _launch.check(scale, 1, "scale")
    _launch.check(noise, 1, "noise")
    _launch.check(a, 0, "a")
    k, n = g.shape
    if scale.shape[0] != k:
        raise ValueError(f"scale has {scale.shape[0]} entries for K={k}")
    if noise.shape[0] != n:
        raise ValueError(f"noise has {noise.shape[0]} entries for N={n}")
    if any(t.device != g.device for t in (scale, noise, a)):
        raise ValueError("g, scale, noise and a must be on one device")
    return k, n


def ota_superpose_cuda(g: torch.Tensor, scale: torch.Tensor,
                       noise: torch.Tensor, a: torch.Tensor,
                       pre: str = "identity") -> torch.Tensor:
    """y [N] fp32 from g [K, N], scale [K], noise [N] and the 0-d gain
    ``a`` (contiguous fp32, one CUDA device); launched on the current
    stream."""
    k, n = _check(g, scale, noise, a, pre)
    lib = _library("ota_superpose")
    s = superpose_split(k, n)
    with torch.cuda.device(g.device):
        y = torch.empty((n,), dtype=torch.float32, device=g.device)
        part = (torch.empty((s, n), dtype=torch.float32, device=g.device)
                if s > 1 else y)
        err = lib.ota_superpose_launch(
            g.data_ptr(), scale.data_ptr(), noise.data_ptr(), a.data_ptr(), k,
            n, s, PRE_KINDS.index(pre), part.data_ptr(), y.data_ptr(),
            torch.cuda.current_stream(g.device).cuda_stream)
    _launch.raise_on(err, lib.ota_superpose_error_string, "ota_superpose")
    return y


def ota_superpose_streaming_cuda(g: torch.Tensor, scale: torch.Tensor,
                                 noise: torch.Tensor, a: torch.Tensor,
                                 k_block: int, pre: str = "identity"
                                 ) -> torch.Tensor:
    """As ``ota_superpose_cuda``, with the K-way sum folded K-block by
    K-block (``k_block`` must divide K) in block order; launched on the
    current stream."""
    k, n = _check(g, scale, noise, a, pre)
    if not 1 <= k_block <= k or k % k_block:
        raise ValueError(f"k_block {k_block} must divide K {k}")
    lib = _library("ota_superpose")
    s = stream_split(k, n, k_block)
    with torch.cuda.device(g.device):
        y = torch.empty((n,), dtype=torch.float32, device=g.device)
        part = (torch.empty((k // k_block, n), dtype=torch.float32,
                            device=g.device) if s > 1 else y)
        err = lib.ota_superpose_stream_launch(
            g.data_ptr(), scale.data_ptr(), noise.data_ptr(), a.data_ptr(), k,
            n, k_block, s, PRE_KINDS.index(pre), part.data_ptr(), y.data_ptr(),
            torch.cuda.current_stream(g.device).cuda_stream)
    _launch.raise_on(err, lib.ota_superpose_error_string,
                     "ota_superpose_streaming")
    return y
