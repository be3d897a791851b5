"""Fused OTA superposition on the card: the wrapper of
``csrc/ota_superpose.cu``, the Hopper port of
``repro/kernels/ota_aggregate.py::ota_aggregate_blocked``.

``ota_superpose_cuda(g, scale, noise, a, pre)`` computes the paper's eq. 10,
``y = a (sum_k scale_k pre(g_k) + z)``, in one pass over the [K, N] fp32
stack; ragged N is masked in the kernel, not padded.  Public callers go
through ``repro_torch.kernels.ops.ota_superpose``, which counts the launches
and serves CPU tensors with the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _launch, build

PRE_KINDS = ("identity", "sign")

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("ota_superpose")
        lib.ota_superpose_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.ota_superpose_launch.restype = ctypes.c_int
        lib.ota_superpose_error_string.argtypes = [ctypes.c_int]
        lib.ota_superpose_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def ota_superpose_cuda(g: torch.Tensor, scale: torch.Tensor,
                       noise: torch.Tensor, a: float,
                       pre: str = "identity") -> torch.Tensor:
    """y [N] fp32 from g [K, N], scale [K], noise [N] (contiguous fp32, one
    CUDA device) and the host gain ``a``; launched on the current stream."""
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
    lib = _library()
    with torch.cuda.device(g.device):
        y = torch.empty((n,), dtype=torch.float32, device=g.device)
        err = lib.ota_superpose_launch(
            g.data_ptr(), scale.data_ptr(), noise.data_ptr(), float(a), k, n,
            PRE_KINDS.index(pre), y.data_ptr(),
            torch.cuda.current_stream(g.device).cuda_stream)
    _launch.raise_on(err, lib.ota_superpose_error_string, "ota_superpose")
    return y
