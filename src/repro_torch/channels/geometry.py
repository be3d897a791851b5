"""Large-scale channel structure (port of ``repro/channels/geometry.py``):
device geometry to per-device mean gains.

Each device k sits at its own distance ``d_k`` from the server, so its mean
amplitude is

    mean_k = channel_mean * (d_k / ref_distance)^(-path_loss_exp / 2)
                          * 10^(X_k / 20),     X_k ~ N(0, shadowing_std_db^2)

Distances are uniform by area over the annulus [min_distance, cell_radius].
``relative_gains`` draws them at ``setup()`` (float64 on the host); the
scale vector lives on ``FLState.scale``.  ``relative_gains_block`` is the
device-indexed twin for the 100,000-device path.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import rng
from repro_torch._config import config


@config
class GeometryConfig:
    """Static cell geometry behind heterogeneous per-device channel means."""

    cell_radius: float = 500.0       # outer annulus radius [m]
    min_distance: float = 50.0       # closest a device can sit to the ES [m]
    ref_distance: float = 300.0      # distance at which mean == channel_mean
    path_loss_exp: float = 3.0       # power path-loss exponent gamma
    shadowing_std_db: float = 0.0    # log-normal shadowing sigma (dB); 0 = off

    def __post_init__(self):
        if not 0.0 < self.min_distance <= self.cell_radius:
            raise ValueError(
                "need 0 < min_distance <= cell_radius, got "
                f"min_distance={self.min_distance}, "
                f"cell_radius={self.cell_radius}")
        if self.ref_distance <= 0.0:
            raise ValueError(f"ref_distance must be positive, got "
                             f"{self.ref_distance}")
        if self.path_loss_exp < 0.0:
            raise ValueError(f"path_loss_exp must be >= 0, got "
                             f"{self.path_loss_exp}")
        if self.shadowing_std_db < 0.0:
            raise ValueError(f"shadowing_std_db must be >= 0, got "
                             f"{self.shadowing_std_db}")


def _f64(v) -> np.ndarray:
    return np.asarray(torch.as_tensor(v).cpu(), dtype=np.float64)


def distances(u, geo: GeometryConfig) -> torch.Tensor:
    """Distances from uniforms ``u`` in [0, 1): uniform by area over the
    annulus (float64)."""
    r2 = geo.min_distance ** 2 + _f64(u) * (geo.cell_radius ** 2
                                            - geo.min_distance ** 2)
    return torch.from_numpy(np.sqrt(r2))


def gains(u, x, geo: GeometryConfig) -> torch.Tensor:
    """Per-device gains relative to ``channel_mean`` from the distance
    uniforms ``u`` and the shadowing standard normals ``x`` (unused when
    shadowing is off), float64.  The powers are numpy's, which give an
    element the same bits at any array length (the block schedule's
    invariance rests on it)."""
    d = distances(u, geo).numpy()
    g = (d / geo.ref_distance) ** (-geo.path_loss_exp / 2.0)
    if geo.shadowing_std_db > 0.0:
        g = g * 10.0 ** (geo.shadowing_std_db * _f64(x) / 20.0)
    return torch.from_numpy(g)


def draw_distances(gen: torch.Generator, geo: GeometryConfig,
                   num_devices: int) -> torch.Tensor:
    """[K] device-to-ES distances (float64), uniform by area."""
    u = torch.rand(num_devices, generator=gen, dtype=torch.float32)
    return distances(u, geo)


def relative_gains(gen: torch.Generator, geo: GeometryConfig,
                   num_devices: int) -> torch.Tensor:
    """[K] float64 gains relative to ``channel_mean``: path loss at the
    distances drawn on ``gen`` (fp32 uniforms), shadowing from the separate
    stream ``rng.generator(gen.initial_seed(), 1)`` (the reference's
    ``fold_in(key, 1)``)."""
    u = torch.rand(num_devices, generator=gen, dtype=torch.float32)
    x = None
    if geo.shadowing_std_db > 0.0:
        x = torch.randn(num_devices, generator=rng.generator(
            gen.initial_seed(), 1), dtype=torch.float32)
    return gains(u, x, geo)


def relative_gains_block(seed: int, geo: GeometryConfig,
                         dev_idx) -> torch.Tensor:
    """``relative_gains`` of the devices ``dev_idx`` on the device-indexed
    schedule (``rng.block_uniforms``): device i's distance uniform is
    counter 2 of its seed and its shadowing normal counters 3 and 4 (the
    fading pair of ``core.channel.draw_fading_state_block`` takes 0 and 1),
    so any blocking of ``[0, K)`` concatenates to the same gains.  float64;
    a different stream from ``relative_gains``."""
    u = rng.block_uniforms(seed, dev_idx, (2,))[:, 0]
    x = rng.block_normals(seed, dev_idx, counter=3)[:, 0]
    return gains(u, x, geo)
