"""Wireless channel substrate (port of ``repro/core/channel.py``).

The paper (Sec. V) models the uplink between each of the K devices and the
edge server as an i.i.d. Rayleigh-fading coefficient ``h_k`` and AWGN with
variance ``sigma^2`` at the receiver.  The channel is simulated from a
``torch.Generator`` on the CPU (so a CPU and a GPU run from one seed see the
same draw).

Beyond the paper, ``ChannelConfig`` describes the radio environment of the
``repro_torch.channels`` subsystem, as in the reference:

* ``model`` picks the small-scale fading process from the registry
  (``'rayleigh'``, the default; ``'rician'`` with K-factor ``rician_k``;
  ``'ar1'``, Gauss-Markov fading with per-round correlation ``rho``);
* ``geometry`` (``channels.geometry.GeometryConfig``) gives every device its
  own mean from drawn distances, path loss and shadowing;
* ``csi_error`` / ``csi_error_model`` split the true ``h`` of the air from
  the server's estimate ``h_hat`` (``channels.csi``);
* ``block_fading`` redraws the channel every round.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Union

import torch

from repro_torch import rng
from repro_torch._config import config

# Paper Sec. V defaults.
DEFAULT_CHANNEL_MEAN = 1e-5
DEFAULT_NOISE_VAR = 1e-7
DEFAULT_B_MAX = math.sqrt(5.0)
DEFAULT_THETA_TH = math.pi / 3.0
DEFAULT_MODEL = "rayleigh"

Scale = Union[float, torch.Tensor]


@config
class ChannelConfig:
    """Static description of the MAC channel between K devices and the ES."""

    num_devices: int
    channel_mean: float = DEFAULT_CHANNEL_MEAN
    noise_var: float = DEFAULT_NOISE_VAR
    # per-device transmit-amplification cap b_k^max (paper: sqrt(5) for all k)
    b_max: float = DEFAULT_B_MAX
    # redraw the channel every round (the paper holds h_k fixed)
    block_fading: bool = False
    # small-scale fading process, from the channel-model registry
    model: str = DEFAULT_MODEL
    # Rician K-factor (LOS power / scattered power); 0 == Rayleigh
    rician_k: float = 0.0
    # AR(1) per-round correlation of 'ar1'; rho = 0 IS block fading
    rho: float = 0.0
    # CSI estimation error (0 = perfect CSI: h_hat is h) and its model
    csi_error: float = 0.0
    csi_error_model: str = "additive"
    # per-device geometry (None keeps the scalar channel_mean)
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
        # registry-backed validation (lazy: repro_torch.channels builds on
        # this module)
        from repro_torch import channels as _chl
        _chl.get(self.model)    # raises ValueError naming the registry
        if self.csi_error_model not in _chl.CSI_ERROR_MODELS:
            raise ValueError(
                f"unknown csi_error_model {self.csi_error_model!r}; "
                f"one of {_chl.CSI_ERROR_MODELS}")

    def rayleigh_scale(self) -> float:
        # Rayleigh(sigma) has mean sigma * sqrt(pi/2).
        return self.channel_mean / math.sqrt(math.pi / 2.0)

    def amplitude_scale(self) -> float:
        """The envelope scale that makes ``E[h_k] == channel_mean``: the
        Rayleigh ``mean / sqrt(pi/2)`` (also AR(1)'s, whose stationary
        marginal is that Rayleigh), divided for Rician by the Laguerre
        factor ``(1+K) I0e(K/2) + K I1e(K/2)``."""
        base = self.rayleigh_scale()
        if self.model == "rician" and self.rician_k > 0.0:
            from scipy import special
            k = self.rician_k
            laguerre = float((1.0 + k) * special.i0e(k / 2.0)
                             + k * special.i1e(k / 2.0))
            return base / laguerre
        return base

    def time_varying(self) -> bool:
        """True when the channel changes every round: block fading, or a
        model (AR(1)) that is a per-round process."""
        if self.block_fading:
            return True
        from repro_torch import channels as _chl
        return _chl.get(self.model).time_varying


def draw_fading_state(source, num_devices: int) -> torch.Tensor:
    """[K, 2] standard-normal I/Q pair under one envelope draw, fp32 on the
    CPU: drawn on ``source`` when it is a ``torch.Generator``; a tensor is
    taken as those normals themselves (the runtime's ``fading_provider``
    seam hands the reference's draws in this way)."""
    if isinstance(source, torch.Generator):
        return torch.randn((num_devices, 2), generator=source,
                           dtype=torch.float32)
    w = torch.as_tensor(source, dtype=torch.float32)
    if w.shape != (num_devices, 2):
        raise ValueError(f"fading normals must have shape ({num_devices}, "
                         f"2), got {tuple(w.shape)}")
    return w


def envelope(state: torch.Tensor, scale: Scale) -> torch.Tensor:
    """Amplitude envelope ``scale * |state|`` of a [K, 2] I/Q state;
    ``scale`` a scalar or a per-device [K] vector."""
    return scale * torch.sqrt(torch.sum(state * state, dim=-1))


def _check_scale(scale: Scale, k: int) -> None:
    if isinstance(scale, torch.Tensor) and scale.dim() > 0 \
            and tuple(scale.shape) != (k,):
        raise ValueError(f"per-device scale must have shape ({k},), got "
                         f"{tuple(scale.shape)}")


def draw_channel(generator, cfg: ChannelConfig,
                 scale: Optional[Scale] = None) -> torch.Tensor:
    """Draw ``h_k`` for k = 1..K, i.i.d. Rayleigh with the configured mean:
    ``|CN(0, 2 sigma_r^2)| = sigma_r * sqrt(x1^2 + x2^2)``, x_i ~ N(0, 1).
    ``scale`` overrides ``cfg.rayleigh_scale()`` with a scalar or a
    per-device [K] vector (geometry).  Returns [K] fp32 on the CPU."""
    sigma_r = cfg.rayleigh_scale() if scale is None else scale
    _check_scale(sigma_r, cfg.num_devices)
    return envelope(draw_fading_state(generator, cfg.num_devices), sigma_r)


def draw_fading_state_block(seed: int, dev_idx) -> torch.Tensor:
    """[len(dev_idx), 2] fp32 I/Q pairs on the device-indexed schedule
    (``rng.block_normals``): device i's pair depends on ``seed`` and i
    alone, so any blocking of ``[0, K)`` concatenates to the same state (the
    100,000-device path draws one K-block at a time).  A different stream
    from ``draw_fading_state``'s [K, 2] draw, as in the reference."""
    return rng.block_normals(seed, dev_idx).float()


def draw_channel_block(seed: int, cfg: ChannelConfig, dev_idx,
                       scale: Optional[Scale] = None) -> torch.Tensor:
    """Rayleigh ``h`` of the devices ``dev_idx`` on the block schedule;
    ``scale`` a scalar or the already-gathered [len(dev_idx)] scales."""
    sigma_r = cfg.rayleigh_scale() if scale is None else scale
    return envelope(draw_fading_state_block(seed, dev_idx), sigma_r)


def channel_for_round(seed: int, cfg: ChannelConfig, round_idx: int,
                      scale: Optional[Scale] = None) -> torch.Tensor:
    """The Rayleigh draw of a round under the block-fading switch: round t
    draws on ``rng.generator(seed, t)`` (the reference's ``fold_in(key,
    t)``) when ``block_fading``, else every round is the draw on
    ``rng.generator(seed)``."""
    gen = (rng.generator(seed, int(round_idx)) if cfg.block_fading
           else rng.generator(seed))
    return draw_channel(gen, cfg, scale)


def draw_noise(generator: torch.Generator, shape, noise_var: float,
               dtype=torch.float32) -> torch.Tensor:
    """AWGN ``z ~ N(0, sigma^2 I)`` at the edge server (on the CPU)."""
    std = torch.sqrt(torch.tensor(noise_var, dtype=dtype))
    return std * torch.randn(shape, generator=generator, dtype=dtype)


def mean_snr_db(cfg: ChannelConfig, b=None) -> float:
    """Diagnostic: mean received SNR (dB) of a unit-norm signal per
    device."""
    b_val = float(torch.as_tensor(b).double().mean()) if b is not None \
        else cfg.b_max
    sig = (cfg.channel_mean * b_val) ** 2
    return 10.0 * math.log10(sig / cfg.noise_var)
