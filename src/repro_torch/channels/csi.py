"""Imperfect channel-state information (port of ``repro/channels/csi.py``):
the true ``h`` of the air against the server's estimate ``h_hat``.

The air superposes with the true amplitudes (eq. 10); the server sees only
its estimate, so Algorithm 1, the receiver gain, the participation rescale
and the side-info folding all run on ``h_hat``.  The gap between the
designed gain ``a sum h_hat_k b_k`` and the realized ``a sum h_k b_k`` is
the ``csi_gain_err`` diagnostic.

``additive``         h_hat = |h + csi_error * scale * e|,  e ~ N(0, I)
``multiplicative``   h_hat = h * |1 + csi_error * e|

Both are exactly ``h`` at ``csi_error = 0``.
"""
from __future__ import annotations

import torch

CSI_ERROR_MODELS = ("additive", "multiplicative")


def estimate(h: torch.Tensor, e: torch.Tensor, csi_error, scale,
             model: str = "additive") -> torch.Tensor:
    """The server's estimate of the true draw ``h`` [K] (fp32) from the [K]
    standard normals ``e`` (drawn by the caller on its generator).
    ``scale`` is the amplitude scale, a scalar or a per-device [K]
    vector."""
    if model not in CSI_ERROR_MODELS:
        raise ValueError(f"unknown csi_error_model {model!r}; "
                         f"one of {CSI_ERROR_MODELS}")
    e = torch.as_tensor(e, dtype=h.dtype)
    if e.shape != h.shape:
        raise ValueError(f"estimation normals have shape {tuple(e.shape)}, "
                         f"expected {tuple(h.shape)}")
    err = torch.tensor(csi_error, dtype=h.dtype)
    if model == "additive":
        return torch.abs(h + err * torch.as_tensor(scale, dtype=h.dtype) * e)
    return h * torch.abs(1.0 + err * e)
