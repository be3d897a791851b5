"""The Mamba selective scan on the card: the wrapper of
``csrc/selective_scan.cu``, the Hopper port of
``repro/kernels/selective_scan.py``'s ``selective_scan_blocked``.

``selective_scan_cuda(u, dt, a, bmat, cmat, return_state=)`` takes u
[B, S, D] and bmat, cmat [B, S, N] contiguous, all bf16 or all fp32, dt
[B, S, D] and a [D, N] contiguous fp32, on one CUDA device, any S and D
(the kernel masks the ragged edges) and 1 <= N <= ``MAX_STATE``.  It
returns y [B, S, D] fp32 and, with ``return_state=True``, also the final
state h_S [B, D, N] fp32, in one launch over the whole sequence (two
threads a channel).  Public callers go through
``repro_torch.kernels.ops``, which counts the launches and serves CPU
tensors with the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch

DTYPES = (torch.float32, torch.bfloat16)
MAX_STATE = 16                   # kMaxN in csrc/selective_scan.cu

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRY_POINTS = {
    "selective_scan_launch": ([_P] * 7 + [_I] * 5 + [_P], _I),
}
_GRID_Y_MAX = 65_535
_INT_MAX = 2 ** 31 - 1


def check_scan_shapes(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      bmat: torch.Tensor, cmat: torch.Tensor) -> None:
    """Raise unless u, dt [B, S, D], a [D, N] and bmat, cmat [B, S, N] fit
    together: what both the kernel and its plain version take."""
    if u.dim() != 3 or a.dim() != 2:
        raise ValueError(f"u must be [B, S, D] and a [D, N], got "
                         f"{tuple(u.shape)} and {tuple(a.shape)}")
    b, s, d = u.shape
    n = a.shape[1]
    want = {"dt": (dt, (b, s, d)), "a": (a, (d, n)),
            "bmat": (bmat, (b, s, n)), "cmat": (cmat, (b, s, n))}
    for what, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{what} must be {list(shape)} for u "
                             f"{tuple(u.shape)} and a {tuple(a.shape)}, got "
                             f"{tuple(t.shape)}")


def selective_scan_cuda(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                        bmat: torch.Tensor, cmat: torch.Tensor, *,
                        return_state: bool = False):
    """y_t = <h_t, C_t>, h_t = exp(dt_t a) h_{t-1} + dt_t u_t B_t, launched
    on the current stream (no synchronisation); see the module docstring
    for what it takes."""
    _launch.check(u, 3, "u", DTYPES)
    _launch.check(dt, 3, "dt")
    _launch.check(a, 2, "a")
    _launch.check(bmat, 3, "bmat", DTYPES)
    _launch.check(cmat, 3, "cmat", DTYPES)
    check_scan_shapes(u, dt, a, bmat, cmat)
    if bmat.dtype != u.dtype or cmat.dtype != u.dtype:
        raise ValueError(f"u, bmat and cmat must share one dtype, got "
                         f"{u.dtype}, {bmat.dtype}, {cmat.dtype}")
    if any(t.device != u.device for t in (dt, a, bmat, cmat)):
        raise ValueError("u, dt, a, bmat and cmat must be on one device")
    b, s, d = u.shape
    n = a.shape[1]
    if n > MAX_STATE:
        raise ValueError(f"d_state {n} exceeds the kernel's maximum "
                         f"{MAX_STATE}")
    if b > _GRID_Y_MAX or max(s, d) > _INT_MAX:
        raise ValueError(f"shape {tuple(u.shape)} exceeds the kernel's grid")
    lib = _launch.bind("selective_scan", _ENTRY_POINTS)
    with torch.cuda.device(u.device):
        y = torch.empty((b, s, d), dtype=torch.float32, device=u.device)
        h = (torch.empty((b, d, n), dtype=torch.float32, device=u.device)
             if return_state else None)
        err = lib.selective_scan_launch(
            u.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
            cmat.data_ptr(), y.data_ptr(), None if h is None else h.data_ptr(),
            b, s, d, n, int(u.dtype == torch.bfloat16),
            torch.cuda.current_stream(u.device).cuda_stream)
    _launch.raise_on(err, lib.selective_scan_error_string, "selective_scan")
    return (y, h) if return_state else y
