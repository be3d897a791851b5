"""Per-device moments of stacked flat gradients on the card: the wrapper of
``csrc/moments.cu``, the Hopper port of
``repro/kernels/grad_norm.py::batched_blocked_moments``.

``batched_moments_cuda(g)`` reads the [K, N] fp32 stack in place (no padding
copy) and returns ``(sumsq, sums)``, each [K] fp32, summed in a fixed order.
Public callers go through ``repro_torch.kernels.ops.batched_moments``, which
counts the launches and serves CPU tensors with the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _launch, build

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("moments")
        lib.moments_num_chunks.argtypes = [ctypes.c_longlong]
        lib.moments_num_chunks.restype = ctypes.c_int
        lib.moments_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.moments_launch.restype = ctypes.c_int
        lib.moments_error_string.argtypes = [ctypes.c_int]
        lib.moments_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def batched_moments_cuda(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of squares, sum) per row of a contiguous fp32 CUDA [K, N] stack,
    launched on the current stream (no synchronisation)."""
    _launch.check(g, 2, "g")
    lib = _library()
    k, n = g.shape
    nchunks = lib.moments_num_chunks(n)
    with torch.cuda.device(g.device):
        part = torch.empty((2, k, nchunks), dtype=torch.float32,
                           device=g.device)
        out = torch.empty((2, k), dtype=torch.float32, device=g.device)
        err = lib.moments_launch(
            g.data_ptr(), k, n, nchunks, part[0].data_ptr(),
            part[1].data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            torch.cuda.current_stream(g.device).cuda_stream)
    _launch.raise_on(err, lib.moments_error_string, "moments")
    return out[0], out[1]
