"""The registered small-scale fading processes (port of
``repro/channels/models.py``).

All three draw the amplitude as the envelope of a 2-component Gaussian
through ``core.channel``'s primitives, so ``rayleigh`` is bitwise the
default draw, ``rician`` at K = 0 is bitwise ``rayleigh``, and ``ar1`` at
``rho = 0`` is bitwise block fading:

``rayleigh``   h = scale * |x|,            x ~ N(0, I_2)   (the paper)
``rician``     h = scale * |x + nu e_1|,   nu = sqrt(2 K)  (LOS + scatter;
               ``ChannelConfig.amplitude_scale`` keeps E[h] at
               ``channel_mean`` for every K-factor)
``ar1``        x_t = rho x_{t-1} + sqrt(1 - rho^2) w_t,  h_t = scale * |x_t|
               (its [K, 2] state persists in ``FLState.fad_state``; the
               stationary marginal is the Rayleigh of the same scale)

Everything is fp32 on the CPU, as the reference computes it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.channels.base import ChannelModel, register
from repro_torch.core import channel as chan


def _rayleigh_init(cfg, scale, gen):
    return chan.draw_channel(gen, cfg, scale), None


def _rayleigh_step(cfg, scale, gen_t, state, rho):
    return chan.draw_channel(gen_t, cfg, scale), None


register(ChannelModel(
    name="rayleigh",
    doc="i.i.d. Rayleigh envelope (the paper's model; the default draw)",
    init=_rayleigh_init,
    step=_rayleigh_step,
))


def _rician_draw(cfg, scale, gen):
    x = chan.draw_fading_state(gen, cfg.num_devices)
    # K-factor K = nu^2 / (2 sigma^2) with unit per-component variance
    x = x + torch.tensor([math.sqrt(2.0 * cfg.rician_k), 0.0],
                         dtype=x.dtype)
    return chan.envelope(x, scale), None


register(ChannelModel(
    name="rician",
    doc="Rician envelope with K-factor cfg.rician_k (LOS component); "
        "K = 0 is Rayleigh",
    init=lambda cfg, scale, gen: _rician_draw(cfg, scale, gen),
    step=lambda cfg, scale, gen_t, state, rho: _rician_draw(cfg, scale,
                                                            gen_t),
))


def _ar1_init(cfg, scale, gen):
    x = chan.draw_fading_state(gen, cfg.num_devices)
    return chan.envelope(x, scale), x


def _ar1_step(cfg, scale, gen_t, state, rho):
    w = chan.draw_fading_state(gen_t, cfg.num_devices)
    rho = torch.tensor(rho, dtype=w.dtype)
    x = rho * torch.as_tensor(state, dtype=w.dtype) \
        + torch.sqrt(1.0 - rho * rho) * w
    return chan.envelope(x, scale), x


register(ChannelModel(
    name="ar1",
    doc="time-correlated Rayleigh: Gauss-Markov AR(1) on the complex tap, "
        "correlation cfg.rho a round; rho = 0 is block fading (bitwise)",
    time_varying=True,
    has_state=True,
    init=_ar1_init,
    step=_ar1_step,
))
