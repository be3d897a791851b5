"""Fused OTA superposition on the card: the wrappers of
``csrc/ota_superpose.cu`` and ``csrc/ota_superpose_stream.cu``, the Hopper
ports of ``repro/kernels/ota_aggregate.py``'s ``ota_aggregate_blocked`` and
``ota_aggregate_streaming``.

``ota_superpose_cuda(g, scale, noise, a, pre)`` computes the paper's eq. 10,
``y = a (sum_k scale_k pre(g_k) + z)``, in one pass over the [K, N] fp32
stack; ``ota_superpose_streaming_cuda(..., k_block, pre)`` computes the same
with the K-way sum folded K-block by K-block in order.  Ragged N is masked
in the kernels, not padded.  Public callers go through
``repro_torch.kernels.ops``, which counts the launches and serves CPU
tensors with the plain versions.
"""
from __future__ import annotations

import ctypes
import torch

from repro_torch.kernels import _launch

PRE_KINDS = ("identity", "sign")

_P, _LL, _I, _F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
# library -> {entry point: (argtypes, restype)}
_ENTRY_POINTS = {
    "ota_superpose": {
        "ota_superpose_launch": ([_P, _P, _P, _F, _LL, _LL, _I, _P, _P], _I),
    },
    "ota_superpose_stream": {
        "ota_superpose_stream_launch": (
            [_P, _P, _P, _F, _LL, _LL, _LL, _I, _P, _P, _P], _I),
    },
}


def _library(name: str) -> ctypes.CDLL:
    return _launch.bind(name, _ENTRY_POINTS[name])


def _check(g, scale, noise, pre):
    if pre not in PRE_KINDS:
        raise ValueError(f"unknown pre-transform {pre!r}; one of {PRE_KINDS}")
    _launch.check(g, 2, "g")
    _launch.check(scale, 1, "scale")
    _launch.check(noise, 1, "noise")
    k, n = g.shape
    if scale.shape[0] != k:
        raise ValueError(f"scale has {scale.shape[0]} entries for K={k}")
    if noise.shape[0] != n:
        raise ValueError(f"noise has {noise.shape[0]} entries for N={n}")
    if scale.device != g.device or noise.device != g.device:
        raise ValueError("g, scale and noise must be on one device")
    return k, n


def ota_superpose_cuda(g: torch.Tensor, scale: torch.Tensor,
                       noise: torch.Tensor, a: float,
                       pre: str = "identity") -> torch.Tensor:
    """y [N] fp32 from g [K, N], scale [K], noise [N] (contiguous fp32, one
    CUDA device) and the host gain ``a``; launched on the current stream."""
    k, n = _check(g, scale, noise, pre)
    lib = _library("ota_superpose")
    with torch.cuda.device(g.device):
        y = torch.empty((n,), dtype=torch.float32, device=g.device)
        err = lib.ota_superpose_launch(
            g.data_ptr(), scale.data_ptr(), noise.data_ptr(), float(a), k, n,
            PRE_KINDS.index(pre), y.data_ptr(),
            torch.cuda.current_stream(g.device).cuda_stream)
    _launch.raise_on(err, lib.ota_superpose_error_string, "ota_superpose")
    return y


def ota_superpose_streaming_cuda(g: torch.Tensor, scale: torch.Tensor,
                                 noise: torch.Tensor, a: float,
                                 k_block: int, pre: str = "identity"
                                 ) -> torch.Tensor:
    """As ``ota_superpose_cuda``, with the K-way sum folded K-block by
    K-block (``k_block`` must divide K) in block order; launched on the
    current stream."""
    k, n = _check(g, scale, noise, pre)
    if not 1 <= k_block <= k or k % k_block:
        raise ValueError(f"k_block {k_block} must divide K {k}")
    lib = _library("ota_superpose_stream")
    with torch.cuda.device(g.device):
        part = torch.empty((k // k_block, n), dtype=torch.float32,
                           device=g.device)
        y = torch.empty((n,), dtype=torch.float32, device=g.device)
        err = lib.ota_superpose_stream_launch(
            g.data_ptr(), scale.data_ptr(), noise.data_ptr(), float(a), k, n,
            k_block, PRE_KINDS.index(pre), part.data_ptr(), y.data_ptr(),
            torch.cuda.current_stream(g.device).cuda_stream)
    _launch.raise_on(err, lib.ota_superpose_stream_error_string,
                     "ota_superpose_stream")
    return y
