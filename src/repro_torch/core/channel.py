"""Wireless channel substrate (port of ``repro/core/channel.py``).

The paper (Sec. V) models the uplink between each of the K devices and the
edge server as an i.i.d. Rayleigh-fading coefficient ``h_k`` and AWGN with
variance ``sigma^2`` at the receiver.  The channel is simulated from a
``torch.Generator`` on the CPU (so a CPU and a GPU run from one seed see the
same draw).

``ChannelConfig`` keeps every field of the reference and validates it the
same way.  Only the i.i.d. Rayleigh model with a fixed channel and perfect
CSI is ported; the other values of ``model``, ``block_fading``,
``csi_error`` and ``geometry`` raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from repro_torch._config import config

# Paper Sec. V defaults.
DEFAULT_CHANNEL_MEAN = 1e-5
DEFAULT_NOISE_VAR = 1e-7
DEFAULT_B_MAX = math.sqrt(5.0)
DEFAULT_THETA_TH = math.pi / 3.0
DEFAULT_MODEL = "rayleigh"
MODELS = ("rayleigh", "rician", "ar1")
CSI_ERROR_MODELS = ("additive", "multiplicative")


@config
class ChannelConfig:
    """Static description of the MAC channel between K devices and the ES."""

    num_devices: int
    channel_mean: float = DEFAULT_CHANNEL_MEAN
    noise_var: float = DEFAULT_NOISE_VAR
    # per-device transmit-amplification cap b_k^max (paper: sqrt(5) for all k)
    b_max: float = DEFAULT_B_MAX
    # redraw the channel every round (not ported)
    block_fading: bool = False
    # small-scale fading process: only 'rayleigh' is ported
    model: str = DEFAULT_MODEL
    rician_k: float = 0.0
    rho: float = 0.0
    # CSI estimation error (only perfect CSI, 0, is ported)
    csi_error: float = 0.0
    csi_error_model: str = "additive"
    # per-device geometry (not ported; None keeps the scalar channel_mean)
    geometry: Optional[Any] = None

    def __post_init__(self):
        if self.num_devices < 1:
            raise ValueError(f"num_devices must be >= 1, got "
                             f"{self.num_devices}")
        if self.channel_mean <= 0.0:
            raise ValueError(f"channel_mean must be positive, got "
                             f"{self.channel_mean}")
        if self.noise_var < 0.0:
            raise ValueError(f"noise_var must be >= 0, got {self.noise_var}")
        if self.b_max <= 0.0:
            raise ValueError(f"b_max must be positive, got {self.b_max}")
        if self.rician_k < 0.0:
            raise ValueError(f"rician_k must be >= 0, got {self.rician_k}")
        if not 0.0 <= self.rho < 1.0:
            raise ValueError(f"rho must lie in [0, 1), got {self.rho}")
        if self.csi_error < 0.0:
            raise ValueError(f"csi_error must be >= 0, got {self.csi_error}")
        if self.model not in MODELS:
            raise ValueError(f"unknown channel model {self.model!r}; one of "
                             f"{MODELS}")
        if self.csi_error_model not in CSI_ERROR_MODELS:
            raise ValueError(
                f"unknown csi_error_model {self.csi_error_model!r}; "
                f"one of {CSI_ERROR_MODELS}")
        if self.model != "rayleigh":
            raise NotImplementedError(
                f"channel model {self.model!r} is not ported yet: ROADMAP "
                "queue 1 item 11")
        if self.geometry is not None:
            raise NotImplementedError(
                "channel geometry is not ported yet: ROADMAP queue 1 item 11")
        if self.csi_error > 0.0:
            raise NotImplementedError(
                "imperfect CSI (csi_error > 0) is not ported yet: ROADMAP "
                "queue 1 item 11")
        if self.block_fading:
            raise NotImplementedError(
                "block fading (in-round Problem-3 re-solve) is not ported "
                "yet: ROADMAP queue 1 item 5")

    def rayleigh_scale(self) -> float:
        # Rayleigh(sigma) has mean sigma * sqrt(pi/2).
        return self.channel_mean / math.sqrt(math.pi / 2.0)


def draw_channel(generator: torch.Generator,
                 cfg: ChannelConfig) -> torch.Tensor:
    """Draw ``h_k`` for k = 1..K, i.i.d. Rayleigh with the configured mean:
    ``|CN(0, 2 sigma_r^2)| = sigma_r * sqrt(x1^2 + x2^2)``, x_i ~ N(0, 1).
    Returns [K] fp32 on the CPU."""
    iq = torch.randn((cfg.num_devices, 2), generator=generator,
                     dtype=torch.float32)
    return cfg.rayleigh_scale() * torch.sqrt(torch.sum(iq * iq, dim=-1))
