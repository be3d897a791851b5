"""The channel-model registry (port of ``repro/channels/base.py``): every
radio environment the FL runtime can run over is one ``ChannelModel``
record here, read by ``setup()`` and by the runtime's host staging.

A model describes the small-scale fading of the uplink amplitudes ``h_k``
through two functions of a CPU generator (or, for ``step``, the round's
[K, 2] standard normals themselves: ``core.channel.draw_fading_state``) and
an amplitude scale (a scalar, or a per-device [K] vector from the
geometry):

* ``init(cfg, scale, gen) -> (h0, state0 | None)`` draws the round-0
  channel at ``setup()``;
* ``step(cfg, scale, gen_t, state, rho) -> (h_t, state_t | None)`` draws
  round t's channel on the host, in ``runtime._stage``, when the channel is
  time-varying.

Large-scale structure enters through ``scale`` (``channels.geometry``),
imperfect CSI after the draw (``channels.csi``), and the redraw schedule is
the runtime's: a model with ``time_varying=True`` (AR(1)) steps every
round, else ``ChannelConfig.block_fading`` decides.  ``has_state`` models
thread a [K, 2] state through the rounds and ``FLState.fad_state``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

InitFn = Callable[..., Tuple[torch.Tensor, Optional[torch.Tensor]]]
StepFn = Callable[..., Tuple[torch.Tensor, Optional[torch.Tensor]]]


@dataclasses.dataclass(frozen=True)
class ChannelModel:
    """One small-scale fading process."""

    name: str
    init: InitFn
    step: StepFn
    doc: str = ""
    # True: the channel changes every round whatever block_fading says
    time_varying: bool = False
    # True: step() consumes and produces a [K, 2] persistent state
    has_state: bool = False


_REGISTRY: Dict[str, ChannelModel] = {}


def register(model: ChannelModel) -> ChannelModel:
    if not isinstance(model, ChannelModel):
        raise TypeError(f"expected a ChannelModel, got {type(model)}")
    _REGISTRY[model.name] = model
    return model


def get(name: str) -> ChannelModel:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown channel model {name!r}; "
                         f"registered: {names()}") from None


def names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
