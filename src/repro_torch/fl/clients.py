"""The client-algorithm registry (port of ``repro/fl/clients.py``): what each
device optimizes locally during its H local steps, and what it transmits.
One ``ClientAlgorithm`` record is a local-objective correction, optional
per-client state ``[K, ...]`` (threaded by the runtime through ``FLState``
and the round body), and one or two transmitted statistics: the algorithms
whose server state is itself learned from the cohort (SCAFFOLD's control
variate ``c``, FedDyn's correction mean ``hbar``) declare a SECOND OTA
transmission slot, which the runtime runs after the gradient slot with its
own scheme (``ClientConfig.variate_scheme``), its own noise and its own
eq.-8 energy.

Registered algorithms (see the reference module for the derivations):

``sgd``      the paper's round: no correction, no state, one slot; the
             runtime's sgd round is the round as it was before the registry.
``fedprox``  the proximal term ``mu/2 ||w - w_t||^2``: the local gradient
             becomes ``g + mu (w - w_t)`` (stateless).
``feddyn``   per-client correction state ``h_k``: local gradient
             ``g + alpha (w - w_t) - h_k + hbar``, then ``h_k <- h_k -
             alpha (w_k^H - w_t)``; the refreshed ``h_k`` ride slot 2 and
             teach the server ``hbar``.
``scaffold`` control variates: local gradient ``g - c_k + c``, option-II
             refresh ``c_k <- c_k - c + (w_t - w_k^H)/(H lr)``; the refreshed
             variates ride slot 2 and the server tracks ``c`` from the
             de-gained aggregate.

The callables take flat parameter trees (``{name: Tensor}``).  The
correction runs on the stacked ``[K, ...]`` local weights and gradients
(the round's broadcast model and the server state broadcast against them),
the state transitions on stacked ``[K, ...]`` trees.  ``mu`` and ``alpha``
reach them as ``ClientParams`` of 0-d fp32 tensors on the run's device (a
CUDA graph of the round reads them from device memory, so a batched lane's
value is its own), never as Python floats.

This module is imported by ``repro_torch.fed.runtime`` and must not import
the runtime or its ``repro_torch.fl`` siblings.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch._config import config

Tree = Dict[str, torch.Tensor]

# the ClientConfig fields a sweep may vary per lane, and the ones that
# change the round body (the reference's tables; repro_torch.fed.runtime's
# hold FLConfig's and ChannelConfig's)
BATCHED_CLIENT_FIELDS = ("mu", "alpha")
STRUCTURAL_CLIENT_FIELDS = ("algo", "variate_scheme")


class ClientParams(NamedTuple):
    """The batchable client numerics the callables read.  The runtime
    holds a lane's as 0-d fp32 tensors on the run's device for the fields
    its algorithm reads (None for the others), and the round body resolves
    them (``resolve_params``)."""

    mu: Any = None       # fedprox proximal strength
    alpha: Any = None    # feddyn regularization strength


@config
class ClientConfig:
    """Which client algorithm runs on the devices, and its constants."""

    algo: str = "sgd"
    mu: float = 0.0          # fedprox: proximal term mu/2 ||w - w_t||^2
    alpha: float = 0.01      # feddyn: dynamic-regularization strength
    # transmit scheme of the second OTA slot; normalized_restored keeps the
    # unit-norm power discipline per slot while the server folds the
    # magnitude back from side info
    variate_scheme: str = "normalized_restored"

    def __post_init__(self):
        get(self.algo)       # raises ValueError naming the registry
        if self.mu < 0.0:
            raise ValueError(f"mu must be >= 0, got {self.mu}")
        if self.alpha < 0.0:
            raise ValueError(f"alpha must be >= 0, got {self.alpha}")


# correction(cp, w_now, w_round, dev_state, srv_state, g) -> corrected g
CorrectionFn = Callable[..., Tree]
# update_state(cp, hlr, dev_state, srv_state, delta) -> new dev_state, with
# delta the round's transmitted statistic (w_t - w_k^H)/(H local_lr) and
# hlr the product H * local_lr
UpdateStateFn = Callable[..., Tree]
# variate_stat(cp, dev_old, dev_new, srv_state, delta) -> slot-2 stack
VariateStatFn = Callable[..., Tree]
# apply_variate(cp, srv_state, y2, part_frac) -> new srv_state (y2 the
# de-gained slot-2 aggregate)
ApplyVariateFn = Callable[..., Tree]


@dataclasses.dataclass(frozen=True)
class ClientAlgorithm:
    """One client-side FL algorithm (see the module docstring).
    ``uses_mu`` / ``uses_alpha`` declare which ``ClientConfig`` numerics
    the callables read: a batched run makes exactly those lanes
    (``BatchAxes.client_mu`` / ``client_alpha``)."""

    name: str
    doc: str = ""
    correction: Optional[CorrectionFn] = None
    # per-device state [K, <param shapes>] threaded by the runtime
    has_state: bool = False
    update_state: Optional[UpdateStateFn] = None
    # server-side state (one param-shaped tree) and the second OTA slot
    has_server_state: bool = False
    num_slots: int = 1
    variate_stat: Optional[VariateStatFn] = None
    apply_variate: Optional[ApplyVariateFn] = None
    uses_mu: bool = False
    uses_alpha: bool = False

    def __post_init__(self):
        if self.num_slots not in (1, 2):
            raise ValueError(f"algorithm {self.name!r}: num_slots must be 1 "
                             f"or 2, got {self.num_slots}")
        if self.has_state and self.update_state is None:
            raise ValueError(f"algorithm {self.name!r} threads per-client "
                             "state but has no update_state transition")
        if self.num_slots == 2:
            if self.variate_stat is None or self.apply_variate is None:
                raise ValueError(
                    f"algorithm {self.name!r} declares a second OTA slot; "
                    "it needs variate_stat (what the devices transmit) and "
                    "apply_variate (how the server consumes the aggregate)")
            if not self.has_server_state:
                raise ValueError(
                    f"algorithm {self.name!r}: a second slot exists to learn "
                    "server-side state; set has_server_state")
        elif self.has_server_state:
            raise ValueError(
                f"algorithm {self.name!r} carries server state with no slot "
                "to learn it from (num_slots must be 2)")

    @property
    def stateful(self) -> bool:
        return self.has_state or self.has_server_state


_REGISTRY: Dict[str, ClientAlgorithm] = {}


def register(alg: ClientAlgorithm) -> ClientAlgorithm:
    if alg.name in _REGISTRY:
        raise ValueError(f"client algorithm {alg.name!r} already registered")
    _REGISTRY[alg.name] = alg
    return alg


def get(name: str) -> ClientAlgorithm:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown client algorithm {name!r}; one of {names()}") from None


def names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def init_state(ccfg: ClientConfig, params0: Tree,
               num_devices: int) -> Optional[Dict[str, Any]]:
    """The zero client state of ``setup()``: ``{"dev": [K, ...] tree or
    None, "srv": param-shaped tree or None}`` in fp32 on the params'
    device, or None for the stateless algorithms (sgd, fedprox)."""
    alg = get(ccfg.algo)
    if not alg.stateful:
        return None

    def zeros(leading=()):
        return {k: torch.zeros(leading + tuple(p.shape), dtype=torch.float32,
                               device=p.device)
                for k, p in sorted(params0.items())}

    return {"dev": zeros((num_devices,)) if alg.has_state else None,
            "srv": zeros() if alg.has_server_state else None}


def resolve_params(ccfg: ClientConfig, over_mu=None,
                   over_alpha=None) -> ClientParams:
    """The numerics the algorithm callables see: the config's values, each
    replaced by its lane's tensor when given.  The runtime's round body
    passes a tensor for every field its algorithm reads, so a value baked
    into the body's (collapsed) config is never read."""
    return ClientParams(
        mu=ccfg.mu if over_mu is None else over_mu,
        alpha=ccfg.alpha if over_alpha is None else over_alpha)


# ---------------------------------------------------------------------------
# the registered algorithms


def _tmap(fn, *trees) -> Tree:
    return {k: fn(*(t[k] for t in trees)) for k in sorted(trees[0])}


register(ClientAlgorithm(
    name="sgd",
    doc="plain local SGD (the paper's round)",
))


register(ClientAlgorithm(
    name="fedprox",
    doc="proximal local objective f_k(w) + mu/2 ||w - w_t||^2 "
        "(stateless; mu = ClientConfig.mu)",
    uses_mu=True,
    correction=lambda cp, w, w0, dev, srv, g: _tmap(
        lambda gl, wl, w0l: gl + cp.mu * (wl - w0l), g, w, w0),
))


def _variate_refreshed(cp, dev_old, dev_new, srv, delta):
    # slot 2 carries the REFRESHED per-client state itself, not the
    # increment: the server's tracking error then takes the round's noise
    # once instead of integrating it (the reference's derivation)
    return dev_new


def _apply_tracking(cp, srv, y2, part_frac):
    # srv <- (1 - m/K) srv + (m/K) mean_{k in S} state_k^+, the participant
    # mean read off the de-gained slot-2 aggregate; an empty round (m = 0)
    # holds srv
    return _tmap(lambda sl, yl: (1.0 - part_frac) * sl + part_frac * yl,
                 srv, y2)


def _feddyn_correction(cp, w, w0, dev, srv, g):
    # grad of f_k(w) - <h_k - hbar, w> + alpha/2 ||w - w_t||^2: hbar enters
    # the local objective as the tilt +<hbar, w> (the paper's eq.-11 step has
    # no slot for the textbook server shift -hbar/alpha)
    return _tmap(
        lambda gl, wl, w0l, hl, sl: gl + cp.alpha * (wl - w0l) - hl + sl,
        g, w, w0, dev, srv)


def _feddyn_update(cp, hlr, dev, srv, delta):
    # h_k <- h_k - alpha (w_k^H - w_t) = h_k + alpha * H * local_lr * delta
    return _tmap(lambda hl, dl: hl + cp.alpha * hlr * dl, dev, delta)


register(ClientAlgorithm(
    name="feddyn",
    doc="dynamic regularization (FedDyn): per-client gradient-correction "
        "state h_k, local gradient g + alpha (w - w_t) - h_k + hbar; the "
        "refreshed h_k ride a second OTA slot to teach the server hbar",
    uses_alpha=True,
    has_state=True,
    has_server_state=True,
    num_slots=2,
    correction=_feddyn_correction,
    update_state=_feddyn_update,
    variate_stat=_variate_refreshed,
    apply_variate=_apply_tracking,
))


def _scaffold_update(cp, hlr, dev, srv, delta):
    # option-II variate refresh: c_k^+ = c_k - c + (w_t - w_k^H)/(H lr)
    # (srv broadcasts against the stacked [K, ...] dev leaves)
    return _tmap(lambda ck, cl, dl: ck - cl + dl, dev, srv, delta)


register(ClientAlgorithm(
    name="scaffold",
    doc="control variates (SCAFFOLD): local gradient g - c_k + c; the "
        "refreshed variates ride a second OTA slot and the server variate "
        "c is learned from its de-gained aggregate",
    has_state=True,
    has_server_state=True,
    num_slots=2,
    correction=lambda cp, w, w0, dev, srv, g: _tmap(
        lambda gl, ck, cl: gl - ck + cl, g, dev, srv),
    update_state=_scaffold_update,
    variate_stat=_variate_refreshed,
    apply_variate=_apply_tracking,
))
