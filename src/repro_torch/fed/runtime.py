"""Federated-learning runtime (port of ``repro/fed/runtime.py``; paper
Sec. II, Steps 1-3, iterated).

One round: every device computes its local gradient (``torch.func.vmap`` of
``torch.func.grad`` over the stacked [K, B] index batches, the gather inside),
the gradients superpose over the air (``core.ota.aggregate`` on the
``vmap`` or ``kernels`` backend), and the server steps ``w <- w - eta_t y``
(eq. 11) through a pluggable optimizer, recording ``DIAG_KEYS``.

Two rounds:

* the dense round (``_round_math``), with partial participation
  (``participation`` < 1, ``bernoulli`` or ``fixed``) and the fixed-mode
  active-set gather (``active_gather``: only the m scheduled devices compute
  gradients; the round is bitwise the dense masked round);
* the streaming round (``k_block``, ``_round_math_streaming``): gradients
  are computed and folded into the OTA accumulator ``k_block`` devices at a
  time through ``core.ota``'s carry API, so the [K, ...] gradient stack
  never exists; with ``run(block_batch_provider=)`` neither does a [K, ...]
  batch stack (the 100,000-device path).  ``device_mesh = D`` cuts its
  blocks into D contiguous shards, each folded from a zero carry, and
  combines the shards' carries with one fixed left fold
  (``_combine_shard_carries``, ``distribution.ota_collectives.
  fold_shards``): on a group of D ranks (``distribution.sharding.
  device_mesh``) each rank folds its own shard and the carries are
  gathered, else the shards run in turn in one process; both give the same
  bits, so a checkpoint moves between the two.

The ``mesh`` backend runs the dense round on a group of K ranks, one rank
an FL device: ``core.ota.aggregate`` -> ``distribution.ota_collectives.
aggregate_mesh``, whose one all-reduce is the superposition.

Each round is split in two.  The host work (``_stage``) draws a chunk of
rounds' inputs on the CPU generators: the channel noise, the participation
mask and its fold into ``b_eff`` and ``a_eff``, ``eta_t``, the empty-round
flag, the masked-baseline weights, the participant count and the fixed-mode
active set, as [T, ...] tensors copied to the device once.  The device work
(``RoundBody``) reads round i's inputs at a device-side cursor, writes its
``DIAG_KEYS`` to row i of a [T, 8] history and advances the cursor, with no
host sync and no CPU tensor in it.  Two drivers run that one body
(``run(..., driver=...)``):

``scan``   (default) the chunked engine: on a CUDA device one round is
           captured in a CUDA graph and replayed once per round of a chunk
           (up to ``chunk_size`` rounds, each eval round ending one), the
           host draws the next chunk's inputs while the card runs the
           replays, and the history is read back once per chunk; on the
           CPU the same body runs eagerly, chunk by chunk.
``python`` the body run eagerly, one round at a time, with its history read
           back every round.  The two drivers give the same bits.

``local_steps`` H > 1 runs H local SGD steps on every device inside the
round body (``_local_transmit``), on the dense, active-gather and streaming
rounds alike.

``run_batched`` runs E structurally identical configs (equal
``structural_config``) as lanes of one engine: on the card one CUDA graph
holds one round of every lane, lane after lane, and each lane gives the bits
of its own ``run``.  ``repro_torch.fl.sweep`` groups a grid into such runs.

The radio environment is the ``repro_torch.channels`` subsystem's
(``ChannelConfig``): a fading model, geometry and imperfect CSI, the true
``h`` for the air and the server's estimate ``h_hat`` for everything the
server computes.  A time-varying channel (block fading, or the AR(1) model)
is host work too: for every staged round ``_stage`` steps the model,
estimates ``h_hat_t``, re-solves Problem 3 on it for the whole chunk at once
(``amplification.solve_problem3_torch``), sets ``a_t = eff_gain /
sum h_hat_t b_t`` and stages ``h_t`` and ``h_hat_t`` beside the folded
gains (the reference's in-scan ``_fading_refresh``).

The client algorithm (``FLConfig.client``, the ``repro_torch.fl.clients``
registry) corrects every local gradient of the H steps (``_local_transmit``)
and threads its state ``{"dev": [K, ...], "srv": ...}`` through
``FLState.client_state`` and the round body beside the params.  FedDyn and
SCAFFOLD run a SECOND OTA slot after the gradient slot, on every round: the
refreshed per-device states go through the air with the scheme
``client.variate_scheme``, the same channel and gains, and their own staged
noise; their eq.-8 energy is added to ``tx_energy``, and the server tracks
its state from the aggregate de-gained by ``a_eff sum h_hat b_eff``.  ``mu``
and ``alpha`` reach the round as 0-d fp32 tensors in device memory (a lane's
own in a batched run).

``run`` and ``run_batched`` take a flight recorder (``recorder=``, a
``repro_torch.obs.Recorder``): each chunk's ``chunk`` and ``round`` events
and the eval events, built on the host after ``engine.rows()`` has copied
the chunk's history back; ``RoundBody``, the staged inputs and the
captured graph never see it, so recorder on or off gives the same bits.

A round that holds a collective (a physical ``device_mesh`` group, or the
``mesh`` backend) cannot be captured in a CUDA graph under ``gloo``, so the
scan driver runs it eagerly on the card too (``_EagerChunks``, counted as
``cache_info()["eager_on_card"]``); the bits are the python driver's.

Random streams (``repro_torch.rng``): the setup's channel draw uses
``rng.generator(cfg.seed)``, round t's channel ``rng.generator(cfg.seed + 2,
t)`` and its estimate ``rng.generator(cfg.seed + 2, rng.CSI_SALT, t)``,
round t's channel noise ``rng.generator(cfg.seed + 1, t)`` (slot 2's
``rng.generator(cfg.seed + 1, rng.SLOT_SALT, t)``) and its participation
mask ``rng.generator(cfg.seed + 1, rng.MASK_SALT, t)``, all on the CPU, so a
CPU and a GPU run from one seed see the same channel, masks and noise, and
``run(5); run(5)`` continues ``run(10)``.  ``run(noise_provider=...)``,
``run(slot2_noise_provider=...)``, ``run(mask_provider=...)`` and
``run(fading_provider=...)`` inject the flat noise vector of either slot,
the [K] mask and the round's fading and estimation normals instead (the
parity tests' seams).  The participation fold runs on the CPU copies of the
channel.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import math
import os
import time
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)
import numpy as np
import torch

from repro_torch._config import config
from repro_torch import channels as chl
from repro_torch import rng
from repro_torch.core import amplification as amp
from repro_torch.core import channel as chan
from repro_torch.core import ota
from repro_torch.core import schemes
from repro_torch.fl import clients
from repro_torch.fl.clients import ClientConfig
from repro_torch.kernels import ops
from repro_torch.obs import profiling
from repro_torch.optim import optimizers as optim

Tree = Dict[str, torch.Tensor]
GradFn = Callable[[Tree, Any], Tree]   # (params, device_batch) -> grads

DRIVERS = ("scan", "python")
SERVER_OPTS = ("sgd", "adamw")
PARTICIPATION_MODES = ("bernoulli", "fixed")
# per-round scalar diagnostics (the reference's key set)
DIAG_KEYS = ("grad_norm_mean", "grad_norm_min", "grad_norm_max", "eta",
             "update_norm", "tx_energy", "num_participants", "csi_gain_err")

# Engines cached on (config, grad_fn, ...) by the builders below, each
# holding a captured CUDA graph on the card (the graphs of a device share one
# memory pool, ``_graph_pool``); sized for sweeps, and settable without a
# code change, as in the reference
ENGINE_CACHE_SIZE = int(os.environ.get("REPRO_ENGINE_CACHE_SIZE", "64"))
# Counted where a builder makes its engine: ``round_step`` for the python
# driver's round body, ``run_chunk`` for each CUDA-graph capture of the scan
# driver and ``run_chunk_batched`` for each capture of a batched run's lanes
# (on the CPU: each engine built).  ``fading_refresh`` stays 0: the refresh
# of a time-varying channel is host code in ``_stage``, and nothing is built
# or captured for it (the key stays for the reference's cache_info()).
TRACE_KINDS = ("round_step", "run_chunk", "run_chunk_batched",
               "fading_refresh")
TRACE_COUNTS: collections.Counter = collections.Counter()
# scan-driver engines built eagerly on a CUDA device because their round
# runs a collective (a physical device_mesh group, or the mesh backend)
EAGER_ON_CARD: collections.Counter = collections.Counter()
# per-kind counts at the last cache_info() call, for the delta report
_TRACE_SNAPSHOT: Dict[str, int] = {}


def _count_trace(kind: str) -> None:
    if kind not in TRACE_KINDS:
        raise ValueError(f"unknown trace kind {kind!r}; one of {TRACE_KINDS}")
    TRACE_COUNTS[kind] += 1


def trace_deltas(since: Dict[str, int]) -> Dict[str, int]:
    """Per-builder build/capture deltas against a ``dict(TRACE_COUNTS)``
    snapshot."""
    return {k: int(TRACE_COUNTS[k]) - int(since.get(k, 0))
            for k in TRACE_KINDS}


def cache_info() -> Dict[str, Any]:
    """The engine caches: per-builder ``lru_cache`` statistics, cumulative
    counts (``TRACE_COUNTS``, keyed by ``TRACE_KINDS``) and
    ``traces_delta``, the counts since the previous ``cache_info()`` call
    (reset by ``clear_compile_caches``), and ``eager_on_card``, the scan
    engines that run eagerly on a card because their round holds a
    collective.  A second identical ``run`` adds no capture: its
    ``traces_delta`` is all 0."""
    delta = trace_deltas(_TRACE_SNAPSHOT)
    _TRACE_SNAPSHOT.update({k: int(TRACE_COUNTS[k]) for k in TRACE_KINDS})
    return {
        "cache_size": ENGINE_CACHE_SIZE,
        "builders": {name: fn.cache_info()._asdict()
                     for name, fn in _CACHED_BUILDERS.items()},
        "traces": dict(TRACE_COUNTS),
        "traces_delta": delta,
        "eager_on_card": int(EAGER_ON_CARD["run_chunk"]),
    }


def clear_compile_caches() -> None:
    """Drop every cached engine (its CUDA graph and the graph's memory pool
    with it) and reset the counters."""
    for fn in _CACHED_BUILDERS.values():
        fn.cache_clear()
    TRACE_COUNTS.clear()
    EAGER_ON_CARD.clear()
    _TRACE_SNAPSHOT.clear()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


# FLConfig fields a batched run may vary per lane (the reference's tables).
# In the port they act on the host only -- ``setup``, and the staged
# ``eta_t``, ``a_eff``, ``b_eff`` and noise of ``_stage`` -- except
# ``grad_bound``, which the round body reads from device memory
# (``BatchAxes.grad_bound``, one value a lane).  Everything else changes the
# round body and is *structural*: vary it across engines, not lanes.
BATCHED_FL_FIELDS = ("seed", "eta", "s_target", "epsilon_target",
                     "grad_bound", "smoothness_L", "strong_convexity_M",
                     "expected_loss_drop", "theta_th")
BATCHED_CHANNEL_FIELDS = ("noise_var", "channel_mean", "b_max", "rho",
                          "csi_error")
# The structural complement: every FLConfig / ChannelConfig field is claimed
# by exactly one of the tables
STRUCTURAL_FL_FIELDS = (
    "num_devices", "scheme", "backend", "case", "p", "channel",
    "amplification", "server_opt", "server_momentum", "server_b1",
    "server_b2", "server_eps", "server_weight_decay", "local_steps",
    "local_lr", "participation", "participation_mode", "k_block",
    "active_gather", "device_mesh", "client")
STRUCTURAL_CHANNEL_FIELDS = ("num_devices", "block_fading", "model",
                             "rician_k", "csi_error_model", "geometry")


class BatchAxes(NamedTuple):
    """Per-lane numerics of a batched run, each [E] (the reference's
    fields).  The port carries ``grad_bound`` and the client's ``mu`` and
    ``alpha`` (where the algorithm reads them) on the run's device: each
    lane's round body reads its own values there.  ``noise_var``,
    ``b_max``, the channel mean and the channel's ``rho`` and ``csi_error``
    act on the host (``setup`` and ``_stage``; the group's noise gate is
    ``_noisy`` of the configs)."""

    noise_var: Optional[torch.Tensor] = None
    grad_bound: Optional[torch.Tensor] = None
    b_max: Optional[torch.Tensor] = None
    rayleigh_scale: Optional[torch.Tensor] = None
    rho: Optional[torch.Tensor] = None
    csi_error: Optional[torch.Tensor] = None
    client_mu: Optional[torch.Tensor] = None
    client_alpha: Optional[torch.Tensor] = None


@config
class FLConfig:
    num_devices: int = 20
    scheme: str = "normalized"
    backend: str = "vmap"             # 'vmap' | 'kernels' | 'mesh' (see core.ota)
    case: str = "I"                   # 'I' (eta_t = 1/t^p) or 'II' (constant eta)
    p: float = 0.75                   # Case-I schedule exponent (paper: 0.75)
    eta: float = 0.01                 # Case-II constant learning rate
    theta_th: float = chan.DEFAULT_THETA_TH
    channel: chan.ChannelConfig = None
    seed: int = 0
    # 'optimal' (Algorithm 1 / Problem 3) or 'bmax' (every b_k = b_k^max)
    amplification: str = "optimal"
    grad_bound: Optional[float] = None   # G, needed by benchmark1 + Case II
    # Case-II target: pick exactly one (s wins if both set)
    s_target: Optional[float] = None
    epsilon_target: Optional[float] = None
    # Case-I optimal-S inputs
    smoothness_L: float = 1.0
    strong_convexity_M: float = 1.0
    expected_loss_drop: float = 1.0
    # --- scenario axes ------------------------------------------------------
    server_opt: str = "sgd"
    server_momentum: float = 0.0
    server_b1: float = 0.9
    server_b2: float = 0.95
    server_eps: float = 1e-8
    server_weight_decay: float = 0.0
    # H local SGD steps per device a round; for H > 1 a device transmits
    # (w - w_H) / (H local_lr)
    local_steps: int = 1
    local_lr: float = 0.01
    participation: float = 1.0
    participation_mode: str = "bernoulli"
    # --- K-scale axes -------------------------------------------------------
    k_block: Optional[int] = None        # the streaming round
    active_gather: bool = False          # fixed-mode active-set gather
    # the sharded streaming round (needs k_block): the round's K-blocks in
    # this many contiguous shards, each folded from a zero carry, then one
    # fixed left fold of the shards' carries.  The value fixes the order of
    # the sums, not a placement: a group of that many ranks and the
    # emulated single-process path give the same bits
    device_mesh: Optional[int] = None
    # --- client-algorithm axis (repro_torch.fl.clients) ---------------------
    client: ClientConfig = None

    def __post_init__(self):
        if self.channel is None:
            object.__setattr__(self, "channel",
                               chan.ChannelConfig(num_devices=self.num_devices))
        if self.client is None:
            object.__setattr__(self, "client", ClientConfig())
        if clients.get(self.client.algo).num_slots > 1:
            # the slot-2 scheme must exist and go through the air: a
            # baseline scheme has no superposition to de-gain
            if schemes.get(self.client.variate_scheme).baseline:
                raise ValueError(
                    f"variate_scheme {self.client.variate_scheme!r} is a "
                    "baseline (channel-bypassing) scheme; the second OTA "
                    "slot is a genuine transmission")
        if self.backend not in ota.BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"one of {ota.BACKENDS}")
        schemes.get(self.scheme)   # raises ValueError naming the registry
        if self.case not in ("I", "II"):
            raise ValueError(f"unknown case {self.case!r}; one of ('I', 'II')")
        if self.amplification not in ("optimal", "bmax"):
            raise ValueError(f"unknown amplification {self.amplification!r}; "
                             "one of ('optimal', 'bmax')")
        if self.server_opt not in SERVER_OPTS:
            raise ValueError(f"unknown server_opt {self.server_opt!r}; "
                             f"one of {SERVER_OPTS}")
        if self.local_steps < 1:
            raise ValueError(f"local_steps must be >= 1, got {self.local_steps}")
        if not 0.0 < self.participation <= 1.0:
            raise ValueError("participation must lie in (0, 1], got "
                             f"{self.participation}")
        if self.participation_mode not in PARTICIPATION_MODES:
            raise ValueError(
                f"unknown participation_mode {self.participation_mode!r}; "
                f"one of {PARTICIPATION_MODES}")
        if self.active_gather:
            if self.participation_mode != "fixed":
                raise ValueError(
                    "active_gather needs a static active-set size: use "
                    "participation_mode='fixed' (bernoulli draws a random "
                    "count per round)")
            if self.participation >= 1.0:
                raise ValueError(
                    "active_gather requires participation < 1 (at p = 1 the "
                    "dense round is the right tool)")
        if self.k_block is not None:
            if self.k_block < 1:
                raise ValueError(f"k_block must be >= 1, got {self.k_block}")
            if self.backend == "mesh":
                raise ValueError("the mesh backend's device axis IS the mesh "
                                 "-- k_block streaming applies to the stacked "
                                 "(vmap/kernels) backends")
            s = self.stream_length()
            if s % min(self.k_block, s) != 0:
                raise ValueError(
                    f"k_block {self.k_block} must divide the streamed device "
                    f"axis ({s} = "
                    f"{'the active set' if self.active_gather else 'num_devices'})")
        if self.device_mesh is not None:
            if self.device_mesh < 1:
                raise ValueError(
                    f"device_mesh must be >= 1, got {self.device_mesh}")
            if self.k_block is None:
                raise ValueError(
                    "device_mesh shards the K-block stream -- set k_block "
                    "(the dense round has no block axis to partition)")
            s = self.stream_length()
            nb = s // min(self.k_block, s)
            if nb % self.device_mesh != 0:
                raise ValueError(
                    f"device_mesh {self.device_mesh} must divide the "
                    f"stream's block count {nb} (= streamed axis {s} / "
                    f"k_block {min(self.k_block, s)}) -- pick a k_block so "
                    "the block count is a multiple of the mesh size")

    def sharded(self) -> bool:
        """Whether the streaming round is cut into shards (device_mesh
        > 1)."""
        return self.device_mesh is not None and self.device_mesh > 1

    def stream_length(self) -> int:
        """Length of the streamed device axis: the fixed active-set size
        ``round(p K)`` under ``active_gather``, else the full cohort K."""
        if self.active_gather:
            return max(1, int(round(self.participation * self.num_devices)))
        return self.num_devices


def _structural_collapse(cfg: FLConfig) -> FLConfig:
    """The structural signature of a config: every batchable field
    (``BATCHED_FL_FIELDS`` / ``BATCHED_CHANNEL_FIELDS``) collapsed to a
    fixed sentinel.  Configs with equal signatures run as lanes of one
    engine, which ``run_batched`` caches on the signature.  ``grad_bound``
    keeps its None-ness (present or absent changes the round body), not its
    value."""
    channel = dataclasses.replace(cfg.channel, noise_var=0.0,
                                  channel_mean=1.0, b_max=1.0, rho=0.0,
                                  csi_error=0.0)
    client = dataclasses.replace(cfg.client, mu=0.0, alpha=0.01)
    return dataclasses.replace(
        cfg, seed=0, eta=0.01, s_target=None, epsilon_target=None,
        grad_bound=None if cfg.grad_bound is None else 1.0,
        smoothness_L=1.0, strong_convexity_M=1.0, expected_loss_drop=1.0,
        theta_th=chan.DEFAULT_THETA_TH, channel=channel, client=client)


# Bound under another name than the reference's ``def structural_config``:
# the JAX package's lint rule TL005 holds the config tables to the collapse
# of the ``structural_config`` function it reads, which must stay the
# reference's.
structural_config = _structural_collapse


@dataclasses.dataclass
class FLState:
    params: Tree
    h: np.ndarray
    b: np.ndarray
    a: float
    eta0: float                       # eta for case II; eta_t = eta0/t^p for case I
    round: int = 0
    model_dim: int = 0
    opt_state: Optional[optim.OptState] = None
    # the server's channel estimate (None: perfect CSI, h itself)
    h_hat: Optional[np.ndarray] = None
    # the fading process's [K, 2] state ('ar1'; None for stateless models)
    fad_state: Optional[np.ndarray] = None
    # per-device amplitude scales from the geometry ([K]; None keeps the
    # scalar ChannelConfig.amplitude_scale())
    scale: Optional[np.ndarray] = None
    # a time-varying channel's designed effective gain a sum h_hat_k b_k,
    # fixed by the first run from setup()'s values and kept, so a resumed
    # run re-solves against the same fp32 gain (the reference re-derives it
    # from the last round's a and b at every run)
    eff_gain: Optional[float] = None
    # the client algorithm's state (repro_torch.fl.clients.init_state):
    # {"dev": [K, ...] tree or None, "srv": param-shaped tree or None} on
    # the params' device; None for the stateless algorithms.  run() sets a
    # stateful algorithm's zero state when a state was built without it
    client_state: Optional[Dict[str, Any]] = None


def server_optimizer(cfg: FLConfig) -> optim.Optimizer:
    """The server-side optimizer of ``cfg.server_opt`` (the rate is passed
    per call: the paper's eta_t lives in ``_eta_t``)."""
    if cfg.server_opt == "adamw":
        return optim.adamw(0.0, b1=cfg.server_b1, b2=cfg.server_b2,
                           eps=cfg.server_eps,
                           weight_decay=cfg.server_weight_decay)
    return optim.sgd(0.0, momentum=cfg.server_momentum)


def _setup_channel(cfg: FLConfig):
    """The round-0 radio environment on the host: the per-device amplitude
    scales (geometry, on ``rng.generator(seed, GEOM_SALT)``), the model's
    first draw and state (``rng.generator(seed)``, the default draw's
    bits), and the server's estimate under imperfect CSI (normals from
    ``rng.generator(seed, CSI_SALT)``).  Returns ``(h, h_hat, fad_state,
    scale_vec)``, ``h`` and ``h_hat`` float64 [K]; ``h_hat`` is ``h`` under
    perfect CSI."""
    ccfg = cfg.channel
    model = chl.get(ccfg.model)
    scale = ccfg.amplitude_scale()
    scale_vec = None
    if ccfg.geometry is not None:
        rel = chl.relative_gains(rng.generator(cfg.seed, rng.GEOM_SALT),
                                 ccfg.geometry, cfg.num_devices)
        scale_vec = (scale * rel).numpy()
        scale = torch.as_tensor(scale_vec, dtype=torch.float32)
    h32, fad0 = model.init(ccfg, scale, rng.generator(cfg.seed))
    h = h32.double().numpy()
    fad_state = None if fad0 is None else fad0.double().numpy()
    h_hat = h
    if ccfg.csi_error > 0.0:
        e = torch.randn(cfg.num_devices,
                        generator=rng.generator(cfg.seed, rng.CSI_SALT))
        h_hat = chl.estimate(h32, e, ccfg.csi_error, scale,
                             ccfg.csi_error_model).double().numpy()
    return h, h_hat, fad_state, scale_vec


def setup(cfg: FLConfig, params0: Tree, model_dim: int) -> FLState:
    """Draw the radio environment and run the paper's parameter
    optimization (Algorithm 1 and the receiver gain) on the host in
    float64, on the server's estimate ``h_hat`` (``h`` under perfect
    CSI)."""
    h, h_hat, fad_state, scale_vec = _setup_channel(cfg)
    b_max = np.full(cfg.num_devices, cfg.channel.b_max)
    extra = dict(model_dim=model_dim, h_hat=h_hat, fad_state=fad_state,
                 scale=scale_vec,
                 client_state=clients.init_state(cfg.client, params0,
                                                 cfg.num_devices))

    if cfg.amplification == "bmax":
        b = b_max.copy()
        # comparison method of Fig. 1(a): same a * sum(h_hat b) as the
        # optimized run
        sol = amp.solve_problem3(h_hat, cfg.channel.noise_var, model_dim,
                                 b_max)
        if cfg.case == "I":
            s_opt = amp.optimal_S(sol.Z, cfg.smoothness_L, cfg.p,
                                  cfg.expected_loss_drop)
            a = 1.0 / (s_opt * float(np.sum(h_hat * sol.b)))
            a = a * float(np.sum(h_hat * sol.b)) / float(np.sum(h_hat * b))
            eta0 = 1.0
        else:
            c2 = amp.optimize_case2(h_hat, cfg.channel.noise_var, model_dim,
                                    b_max, cfg.smoothness_L,
                                    cfg.strong_convexity_M, cfg.grad_bound,
                                    cfg.theta_th, s=cfg.s_target,
                                    epsilon=cfg.epsilon_target)
            a_eta = (c2.a_eta * float(np.sum(h_hat * c2.b))
                     / float(np.sum(h_hat * b)))
            a, eta0 = a_eta / cfg.eta, cfg.eta
        return FLState(params0, h, b, a, eta0, **extra)

    if cfg.case == "I":
        c1 = amp.optimize_case1(h_hat, cfg.channel.noise_var, model_dim,
                                b_max, cfg.smoothness_L, cfg.p,
                                cfg.expected_loss_drop)
        return FLState(params0, h, c1.b, c1.a, 1.0, **extra)
    c2 = amp.optimize_case2(h_hat, cfg.channel.noise_var, model_dim, b_max,
                            cfg.smoothness_L, cfg.strong_convexity_M,
                            cfg.grad_bound, cfg.theta_th,
                            s=cfg.s_target, epsilon=cfg.epsilon_target)
    return FLState(params0, h, c2.b, c2.a_eta / cfg.eta, cfg.eta, **extra)


def _eta_t(cfg: FLConfig, eta0: float, t: int) -> float:
    """The round's step size in fp32 (as the reference computes it),
    returned as the python float of that fp32 value."""
    eta0 = torch.tensor(eta0, dtype=torch.float32)
    if cfg.case == "I":
        tt = torch.clamp(torch.tensor(float(t), dtype=torch.float32), min=1.0)
        return float(eta0 / tt ** cfg.p)
    return float(eta0)


def _participation_mask(cfg: FLConfig, t: int) -> torch.Tensor:
    """Round t's [K] 0/1 participation draw (fp32, on the CPU).
    ``bernoulli`` keeps each device with probability p; ``fixed`` schedules
    exactly ``round(p K)`` devices uniformly at random."""
    gen = rng.generator(cfg.seed + 1, rng.MASK_SALT, t)
    k = cfg.num_devices
    if cfg.participation_mode == "bernoulli":
        return (torch.rand(k, generator=gen) < cfg.participation).float()
    m = max(1, int(round(cfg.participation * k)))
    mask = torch.zeros(k)
    mask[torch.randperm(k, generator=gen)[:m]] = 1.0
    return mask


def _active_indices(cfg: FLConfig, mask: torch.Tensor) -> torch.Tensor:
    """Sorted [m] indices of the round's fixed-mode participants: the
    mask's nonzeros, so ``mask[idx] == 1`` by construction, and ascending
    order keeps the gathered K-way sums in the dense round's order."""
    idx = torch.nonzero(mask).reshape(-1)
    if idx.shape[0] != cfg.stream_length():
        raise ValueError(f"the round's mask schedules {idx.shape[0]} "
                         f"devices; participation_mode='fixed' needs "
                         f"{cfg.stream_length()}")
    return idx


def _map_batch(fn: Callable[[torch.Tensor], torch.Tensor], batch):
    """Apply ``fn`` to every tensor of a batch (a tensor, or a tuple, list
    or dict of them)."""
    if isinstance(batch, torch.Tensor):
        return fn(batch)
    if isinstance(batch, dict):
        return {k: _map_batch(fn, v) for k, v in batch.items()}
    return type(batch)(_map_batch(fn, v) for v in batch)


def _local_transmit(cfg: FLConfig, grad_fn: GradFn, params: Tree,
                    batch, corr: Optional[Callable] = None,
                    dev_state: Optional[Tree] = None) -> Tree:
    """What every device hands to the scheme's transform: its local
    gradient for ``local_steps == 1`` (the paper), ``grad_fn`` vmapped over
    the leading K axis of the batch; for H = ``local_steps`` > 1 the
    accumulated model delta of H local SGD steps on its round batch,
    ``w <- w - local_lr g``, transmitted as ``(w_0 - w_H) / (H local_lr)``
    (the reference's ``_local_transmit``, its fp32 casts and operation
    order).  The H steps are a fixed-length loop, so one CUDA graph holds
    them all.

    ``corr(w, g, dev_state)`` is the client algorithm's correction, applied
    to every local gradient of the H steps on the stacked [K, ...] local
    weights ``w`` and gradients ``g``; ``dev_state`` is the per-device
    state it reads ([K, ...] rows of the devices in the batch, or None).
    ``corr=None`` (sgd) is the uncorrected round.

    The params are expanded along the device axis (a view, no copy), and
    after the first local step each device holds its own [K, ...] params, so
    each matrix product runs as a batched product with one matrix per
    device: a device's result is then bitwise the same whichever devices
    share the call, which the active-set gather relies on (a plain product
    over the stacked rows splits its work, and its sums, by the row
    count)."""
    first = batch
    while not isinstance(first, torch.Tensor):
        first = next(iter(first.values() if isinstance(first, dict)
                          else first))
    k = first.shape[0]
    per_device = {n: p.expand((k,) + p.shape) for n, p in params.items()}
    vmapped = torch.func.vmap(grad_fn, in_dims=(0, 0))
    local_grads = (vmapped if corr is None else
                   lambda w, b: corr(w, vmapped(w, b), dev_state))
    if cfg.local_steps == 1:
        return local_grads(per_device, batch)
    w = per_device
    for _ in range(cfg.local_steps):
        g = local_grads(w, batch)
        w = {n: w[n] - cfg.local_lr * g[n].to(w[n].dtype) for n in w}
    inv = 1.0 / (cfg.local_steps * cfg.local_lr)
    return {n: (per_device[n] - w[n]) * inv for n in w}


class RoundInputs(NamedTuple):
    """What the host makes for one round of one run, or, with leading
    [T, E] axes on every tensor but the batch, for a chunk of T rounds of E
    lanes (the staged buffers the round body reads at its cursor; lane e's
    view is ``_lane(staged, e)``).  The batch is shared by the lanes: [T, K,
    ...] for a chunk.  A field that the config does not use is None in
    every round."""
    t: torch.Tensor                          # int64, the round index
    eta: torch.Tensor                        # fp32 eta_t
    a_eff: torch.Tensor                      # fp32 receiver gain, folded
    b_eff: torch.Tensor                      # [K] fp32 amplification, folded
    participants: torch.Tensor               # fp32 num_participants
    noise: Optional[torch.Tensor] = None     # [N] fp32 flat channel noise
    noise2: Optional[torch.Tensor] = None    # [N] fp32, the second slot's
    mask: Optional[torch.Tensor] = None      # [K] fp32 0/1 participation
    empty: Optional[torch.Tensor] = None     # bool: nobody participates
    weights: Optional[torch.Tensor] = None   # [K] masked-baseline weights
    active: Optional[torch.Tensor] = None    # [m] int64 fixed-mode set
    # a time-varying channel's round: the true h and the estimate h_hat
    h: Optional[torch.Tensor] = None         # [K] fp32
    h_hat: Optional[torch.Tensor] = None     # [K] fp32
    batch: Any = None                        # per-device batch (None: lazy)


def _map_inputs(fn: Callable[[torch.Tensor], torch.Tensor],
                r: RoundInputs) -> RoundInputs:
    return RoundInputs(*(None if v is None else _map_batch(fn, v)
                         for v in r))


def _lane(staged: RoundInputs, e: int) -> RoundInputs:
    """Lane e's [T, ...] view of a [T, E, ...] staged chunk (the batch is
    the lanes' own, shared)."""
    return staged._replace(**{
        name: v[:, e] for name, v in zip(RoundInputs._fields, staged)
        if v is not None and name != "batch"})


def _scatter_rows(tree: Tree, idx: torch.Tensor, k: int) -> Tree:
    """A [K, ...] zero stack with the [m, ...] rows of ``tree`` at the
    devices ``idx``."""
    return {name: l.new_zeros((k,) + l.shape[1:]).index_copy_(0, idx, l)
            for name, l in tree.items()}


def _keep_rows(mask: torch.Tensor, new: Tree, old: Tree) -> Tree:
    """``new``'s rows where ``mask`` is 1, ``old``'s where it is 0: a
    masked device keeps its client state."""
    keep = mask.bool()
    return {n: torch.where(keep.reshape((-1,) + (1,) * (l.ndim - 1)), l,
                           old[n]) for n, l in new.items()}


def _client_round(cfg: FLConfig, alg: clients.ClientAlgorithm,
                  grad_fn: GradFn, params: Tree, cstate,
                  cp: clients.ClientParams):
    """The round's client state and numerics: ``(dev_state, srv_state, cp,
    transmit)``, where ``transmit(batch, dev_rows)`` is ``_local_transmit``
    with the algorithm's correction (the broadcast ``params`` as w_t).
    ``cp`` holds the lane's 0-d fp32 ``mu``/``alpha`` tensors, resolved
    against the config here as the reference resolves its lanes."""
    cp = clients.resolve_params(cfg.client, cp.mu, cp.alpha)
    dev_state = cstate["dev"] if cstate is not None else None
    srv_state = cstate["srv"] if cstate is not None else None
    if alg.correction is None:
        def transmit(batch, rows):
            return _local_transmit(cfg, grad_fn, params, batch)
    else:
        def corr(w, g, rows):
            return alg.correction(cp, w, params, rows, srv_state, g)

        def transmit(batch, rows):
            return _local_transmit(cfg, grad_fn, params, batch, corr, rows)
    return dev_state, srv_state, cp, transmit


def _put_rows(dev_state: Tree, idx: Optional[torch.Tensor],
              rows: Tree) -> Tree:
    """The new [K, ...] client state from the round's rows: ``rows`` itself,
    or under ``active_gather`` the participants' rows put back at ``idx``
    (an absent device's state holds)."""
    if idx is None:
        return rows
    return {n: l.index_copy(0, idx, rows[n]) for n, l in dev_state.items()}


def _client_block(cfg: FLConfig, cp, rows, srv_state: Tree, g: Tree,
                  b_air: torch.Tensor, gb: Optional[torch.Tensor],
                  mask: Optional[torch.Tensor]):
    """A block of devices' client-state transition and slot-2 statistic,
    from their state ``rows`` and transmitted statistic ``g`` (the
    gradient for H = 1, the model delta otherwise): ``(kept, x2, stats2,
    tx2)``.  ``kept`` is the new state, with a masked device's row held
    (``mask``; the raw transition still feeds slot 2, where b_eff = 0
    silences that row); ``x2``, its stats and eq.-8 energies are None for
    a one-slot algorithm."""
    alg = clients.get(cfg.client.algo)      # static: the config's
    raw_new = kept = rows
    if alg.has_state:
        raw_new = alg.update_state(cp, cfg.local_steps * cfg.local_lr, rows,
                                   srv_state, g)
        kept = raw_new if mask is None else _keep_rows(mask, raw_new, rows)
    if alg.num_slots != 2:
        return kept, None, None, None
    # the second OTA slot: the same channel realization, its own scheme,
    # noise and eq.-8 energy
    sch2 = schemes.get(cfg.client.variate_scheme)
    x2 = alg.variate_stat(cp, rows, raw_new, srv_state, g)
    stats2 = schemes.compute_stats(x2, sch2, batched=True)
    tx2 = schemes.transmit_energy(sch2, stats2, b_air, gb, mask)
    return kept, x2, stats2, tx2


def _track_server(alg: clients.ClientAlgorithm, cp, srv_state: Tree,
                  y2: Tree, r: RoundInputs, h_hat: torch.Tensor,
                  k: int, ksum=torch.sum) -> Tree:
    """The server's state step from the slot-2 aggregate: ``y2`` de-gained
    by ``a_eff sum h_hat b_eff`` (clamped at EPS) is about the participant
    mean of the transmitted states, tracked with ``frac = m / K``.  An
    empty round has ``a_eff = 0``, a finite ``y2 = 0`` and ``frac = 0``:
    the state holds.  ``ksum`` is the K-way sum (``ota.pinned_sum`` in the
    sharded round, as the reference)."""
    gain = r.a_eff * ksum(h_hat * r.b_eff)
    y2_hat = schemes.tree_map(
        lambda l: l / torch.clamp(gain, min=schemes.EPS), y2)
    return alg.apply_variate(cp, srv_state, y2_hat, r.participants / k)


def _round_math(cfg: FLConfig, sch: schemes.Scheme, opt: optim.Optimizer,
                grad_fn: GradFn, ocfg: ota.OTAConfig, params: Tree, opt_state,
                r: RoundInputs, h: torch.Tensor,
                gb: Optional[torch.Tensor] = None,
                h_hat: Optional[torch.Tensor] = None, *, cstate=None,
                cp: clients.ClientParams = clients.ClientParams(),
                ocfg2: Optional[ota.OTAConfig] = None):
    """One dense FL round (local computation -> OTA aggregate(s) -> server
    step) plus the ``DIAG_KEYS`` diagnostics, from the round's inputs ``r``
    on the device.  ``gb`` is the run's grad_bound G as a 0-d fp32 tensor on
    the device (None where the config has none).  ``h_hat=None`` is perfect
    CSI (the estimate IS ``h``, so ``csi_gain_err`` is a hard 0).  The
    round's participation mask is already folded into ``r.b_eff`` and
    ``r.a_eff`` (``ota.participation_fold``).

    ``cstate`` is the client state (``{"dev", "srv"}`` or None) and ``cp``
    the lane's client numerics; a two-slot algorithm runs its second OTA
    slot on ``ocfg2`` after the gradient slot (the same ``h``, ``b_eff``
    and ``a_eff``, the noise ``r.noise2``), adds its eq.-8 energy to
    ``tx_energy`` and steps the server state from the de-gained aggregate.
    Returns ``(params, opt_state, cstate, diag)`` with diag values as 0-d
    tensors."""
    if h_hat is None:
        h_hat = h
    k = cfg.num_devices
    # the algorithm is static (the config's); its state and numerics are
    # the lane's tensors
    alg = clients.get(cfg.client.algo)
    dev_state, srv_state, cp, transmit = _client_round(
        cfg, alg, grad_fn, params, cstate, cp)
    if cfg.active_gather:
        # gather the scheduled participants' batches (and client states)
        # BEFORE the local computation, so its cost scales with m =
        # round(p K), then scatter the m results back into a zero [K, ...]
        # stack and run the unchanged dense aggregation: a masked device's
        # terms are exact zeros either way (b_eff = 0), so the round is
        # bitwise the dense masked round
        idx = r.active
        dev_active = (None if dev_state is None else
                      {n: l[idx] for n, l in dev_state.items()})
        active = transmit(_map_batch(lambda l: l[idx], r.batch), dev_active)
        stacked = _scatter_rows(active, idx, k)
        b_air = r.b_eff[idx]
    else:
        idx = None
        dev_active = dev_state
        active = stacked = transmit(r.batch, dev_state)
        b_air = r.b_eff
    if r.mask is not None and sch.baseline:
        # the baseline bypasses the channel, so the mask cannot reach it
        # through b_eff: average over the participants only
        y = schemes.tree_map(
            lambda l: torch.tensordot(r.weights, l.float(), dims=([0], [0])),
            stacked)
    else:
        y = ota.aggregate(ocfg, stacked, h, r.b_eff, h_hat=h_hat,
                          noise=r.noise, a=r.a_eff, grad_bound=gb)
    # one stats pass feeds both diagnostics (grad norms and the eq.-8
    # transmit energy); the aggregate above keeps its own internal stats.
    # Under active_gather the stats cover the participants only, and their
    # energies are scattered back to the [K] layout (masked devices spent 0)
    stats = schemes.compute_stats(active, sch, batched=True)
    norms = torch.sqrt(stats.sq_norm)
    tx = schemes.transmit_energy(sch, stats, b_air, gb,
                                 None if idx is not None else r.mask)
    if idx is not None:
        tx = tx.new_zeros((k,)).index_copy_(0, idx, tx)
    tx_energy = torch.sum(tx)

    if alg.stateful:
        dev_new, x2, _, tx2 = _client_block(
            cfg, cp, dev_active, srv_state, active, b_air, gb,
            None if idx is not None else r.mask)
        if alg.has_state:
            dev_new = _put_rows(dev_state, idx, dev_new)
        if x2 is not None and idx is not None:
            # an absent device's slot-2 row and energy are 0
            x2 = _scatter_rows(x2, idx, k)
            tx2 = tx2.new_zeros((k,)).index_copy_(0, idx, tx2)
        srv_new = srv_state
        if x2 is not None:
            tx_energy = tx_energy + torch.sum(tx2)
            y2 = ota.aggregate(ocfg2, x2, h, r.b_eff, h_hat=h_hat,
                               noise=r.noise2, a=r.a_eff, grad_bound=gb)
            srv_new = _track_server(alg, cp, srv_state, y2, r, h_hat, k)
        cstate = {"dev": dev_new, "srv": srv_new}
    diag_core = {
        "grad_norm_mean": torch.mean(norms),
        "grad_norm_min": torch.min(norms),
        "grad_norm_max": torch.max(norms),
        "tx_energy": tx_energy,
    }
    return _round_tail(sch, opt, params, opt_state, y, r, diag_core, h,
                       h_hat) + (cstate,)


def _combine_shard_carries(stacked: tuple) -> tuple:
    """Close the sharded streaming round: fold the D stacked per-shard
    carries ``(ota_carry, norm_sum, norm_min, norm_max, tx_sum[,
    ota_carry_2])`` into one, each field through ``fold_shards`` with its
    own op (the sums with add, the diagnostics with min and max): the one
    combine both execution paths share."""
    from repro_torch.distribution import ota_collectives as coll
    ops_ = (torch.add, torch.add, torch.minimum, torch.maximum, torch.add,
            torch.add)
    return tuple(coll.fold_shards(part, op)
                 for part, op in zip(stacked, ops_))


def _round_math_streaming(cfg: FLConfig, sch: schemes.Scheme,
                          opt: optim.Optimizer, grad_fn: GradFn,
                          ocfg: ota.OTAConfig, params: Tree, opt_state,
                          r: RoundInputs, h: torch.Tensor,
                          gb: Optional[torch.Tensor] = None,
                          h_hat: Optional[torch.Tensor] = None, *,
                          block_batch_fn: Optional[Callable] = None,
                          cstate=None,
                          cp: clients.ClientParams = clients.ClientParams(),
                          ocfg2: Optional[ota.OTAConfig] = None,
                          mesh=None):
    """The flat-memory round (``cfg.k_block``): each device's local
    computation (``_local_transmit``, H local steps included) is made and
    folded into the OTA accumulator ``k_block`` devices at a time through
    the carry API (``ota.streaming_carry/_block/_finish``), so the [K, ...]
    stack never exists; the working set is O(k_block N) plus O(K) channel
    vectors.  On the kernels backend each block is one launch of the dense
    superposition kernel.

    ``r.batch`` is the dense per-device batch over all K devices (cut into
    blocks here, and gathered to the active set under ``active_gather``),
    or None: then ``block_batch_fn(r.t, dev_idx)`` makes one block's
    [k_block, ...] batch from the round index (a 0-d int64 tensor on the
    device) and its [k_block] device indices.  The client state goes
    through the blocks as the batch does (its refreshed rows gathered back
    after the last block), and a second OTA slot folds into its own carry
    beside slot 1's, block by block, closed with its own noise.  Arguments
    and result are ``_round_math``'s.  Versus the dense round every
    per-device term is the same; the K-way sums associate K-block by
    K-block, and the channel noise is the same draw.

    ``cfg.device_mesh = D > 1`` cuts the nb blocks into D contiguous runs:
    each shard folds its run from the zero carry, and
    ``_combine_shard_carries`` closes the round; the refreshed client-state
    rows come back in the flat block order.  ``mesh`` (a
    ``distribution.sharding.DeviceMesh`` of D ranks) runs only this rank's
    shard and gathers the carries and rows over the group; None runs every
    shard here in turn.  The carries' values are the same either way, and
    everything after the combine is replicated."""
    if h_hat is None:
        h_hat = h
    device = h.device
    batch = r.batch
    # the algorithm is static (the config's); its state and numerics are
    # the lane's tensors
    alg = clients.get(cfg.client.algo)
    dev_state, srv_state, cp, transmit = _client_round(
        cfg, alg, grad_fn, params, cstate, cp)
    dev_str = dev_state
    if cfg.active_gather:
        idx = r.active
        if batch is not None:
            batch = _map_batch(lambda l: l[idx], batch)
        if dev_state is not None:
            dev_str = {n: l[idx] for n, l in dev_state.items()}
        h_air, h_srv, b_air, dev = h[idx], h_hat[idx], r.b_eff[idx], idx
        block_mask = None
    else:
        idx = None
        h_air, h_srv, b_air = h, h_hat, r.b_eff
        dev = torch.arange(cfg.num_devices, device=device)
        block_mask = r.mask
    s = cfg.stream_length()
    kb = ocfg.k_block
    ha = (h_air * b_air).float()
    hs = (h_srv * b_air).float()
    weighted = r.mask is not None and sch.baseline
    if weighted:
        # masked baseline: the participant mean, accumulated as the same
        # hb-free weighted sum the dense round takes
        w = r.weights if not cfg.active_gather else r.weights[idx]
    template = {k: torch.zeros(p.shape, dtype=torch.float32, device=device)
                for k, p in sorted(params.items())}
    two_slot = alg.num_slots == 2

    def fold(lo_block: int, hi_block: int):
        """The left fold of the blocks [lo_block, hi_block) from the zero
        carry: ``(carry, rows)``, rows the blocks' refreshed client-state
        rows of a stateful algorithm."""
        oc = ota.streaming_carry(ocfg, template)
        oc2 = ota.streaming_carry(ocfg2, template) if two_slot else None
        zero = torch.zeros((), dtype=torch.float32, device=device)
        nsum, txsum = zero, zero
        nmin = torch.full((), float("inf"), device=device)
        nmax = torch.full((), float("-inf"), device=device)
        rows_out = []
        for j in range(lo_block, hi_block):
            blk = slice(j * kb, (j + 1) * kb)
            bat = (_map_batch(lambda l: l[blk], batch) if batch is not None
                   else block_batch_fn(r.t, dev[blk]))
            rows = (None if dev_str is None else
                    {n: l[blk] for n, l in dev_str.items()})
            g_blk = transmit(bat, rows)
            stats = schemes.compute_stats(g_blk, sch, batched=True)
            norms = torch.sqrt(stats.sq_norm)
            mask_blk = None if block_mask is None else block_mask[blk]
            tx = schemes.transmit_energy(sch, stats, b_air[blk], gb,
                                         mask_blk)
            oc = ota.streaming_block(
                ocfg, oc, g_blk, ha[blk], hs[blk], stats=stats,
                grad_bound=gb, baseline_weights=w[blk] if weighted else None)
            txsum = txsum + torch.sum(tx)
            nsum = nsum + torch.sum(norms)
            nmin = torch.minimum(nmin, torch.min(norms))
            nmax = torch.maximum(nmax, torch.max(norms))
            if alg.stateful:
                kept, x2_blk, stats2, tx2 = _client_block(
                    cfg, cp, rows, srv_state, g_blk, b_air[blk], gb,
                    mask_blk)
                rows_out.append(kept)
                if two_slot:
                    oc2 = ota.streaming_block(ocfg2, oc2, x2_blk, ha[blk],
                                              hs[blk], stats=stats2,
                                              grad_bound=gb)
                    txsum = txsum + torch.sum(tx2)
        carry = (oc, nsum, nmin, nmax, txsum) + ((oc2,) if two_slot else ())
        return carry, rows_out

    nb = s // kb
    ksum = torch.sum
    if not cfg.sharded():
        carry, new_rows = fold(0, nb)
    else:
        from repro_torch.distribution import ota_collectives as coll
        ksum = ota.pinned_sum
        per = nb // cfg.device_mesh
        if mesh is None:
            parts = [fold(d * per, (d + 1) * per)
                     for d in range(cfg.device_mesh)]
            stacked = coll.stack_shards([c for c, _ in parts])
            new_rows = [rows for _, rs in parts for rows in rs]
        else:
            local, rows = fold(mesh.rank * per, (mesh.rank + 1) * per)
            stacked = coll.gather_shards(local, mesh.group)
            new_rows = []
            if alg.has_state:
                # the shards' rows, gathered in rank order: the flat
                # block order
                mine = {n: torch.cat([b[n] for b in rows]) for n in dev_state}
                new_rows = [{n: l.reshape((s,) + l.shape[2:]) for n, l in
                             coll.gather_shards(mine, mesh.group).items()}]
        carry = _combine_shard_carries(stacked)
    oc, nsum, nmin, nmax, txsum = carry[:5]
    y = ota.streaming_finish(ocfg, oc, template, r.a_eff, r.noise,
                             num_devices=1.0 if weighted else float(s))
    if alg.stateful:
        dev_new = dev_state
        if alg.has_state:
            dev_new = _put_rows(dev_state, idx, {
                n: torch.cat([b[n] for b in new_rows]) for n in dev_state})
        srv_new = srv_state
        if two_slot:
            y2 = ota.streaming_finish(ocfg2, carry[5], template, r.a_eff,
                                      r.noise2, num_devices=float(s))
            srv_new = _track_server(alg, cp, srv_state, y2, r, h_hat,
                                    cfg.num_devices, ksum)
        cstate = {"dev": dev_new, "srv": srv_new}
    diag_core = {
        "grad_norm_mean": nsum / s,
        "grad_norm_min": nmin,
        "grad_norm_max": nmax,
        "tx_energy": txsum,
    }
    return _round_tail(sch, opt, params, opt_state, y, r, diag_core, h,
                       h_hat, ksum) + (cstate,)


def _keep_if(empty: torch.Tensor, old, new):
    """``old`` where the round is empty, else ``new``: an exact selection,
    leaf by leaf, of params or an optimizer state."""
    if isinstance(new, torch.Tensor):
        return torch.where(empty, old, new)
    if isinstance(new, dict):
        return {k: _keep_if(empty, old[k], new[k]) for k in new}
    return _rebuild(new, (_keep_if(empty, o, n) for o, n in zip(old, new)))


def _round_tail(sch, opt, params, opt_state, y, r: RoundInputs, diag_core,
                h, h_hat, ksum=torch.sum):
    """Post-aggregation tail shared by the dense and streaming rounds:
    empty-round gating, the server-optimizer step and the ``DIAG_KEYS``
    assembly.  A round in which nobody participates (possible under
    ``bernoulli`` draws) applies no update: params and the optimizer state
    stay as they were, selected on the device by the round's flag.
    ``ksum`` is the K-way sum of the gain diagnostic (``ota.pinned_sum`` in
    the sharded round, as the reference)."""
    if r.empty is not None:
        y = schemes.tree_map(lambda l: torch.where(r.empty, l * 0.0, l), y)
    new_params, new_opt_state = opt.update(y, opt_state, params, lr=r.eta)
    if r.empty is not None:
        new_params = _keep_if(r.empty, params, new_params)
        new_opt_state = _keep_if(r.empty, opt_state, new_opt_state)
    if sch.baseline:
        # the ideal reference bypasses the channel; no gain to misalign
        csi_gain_err = torch.zeros((), dtype=torch.float32, device=h.device)
    else:
        # relative effective-gain misalignment, through the DIFFERENCE
        # (h - h_hat) so equal estimates give a hard 0
        designed = r.a_eff * ksum(h_hat * r.b_eff)
        gap = r.a_eff * ksum((h - h_hat) * r.b_eff)
        csi_gain_err = (gap / torch.clamp(torch.abs(designed),
                                          min=schemes.EPS)).float()
    diag = {
        **diag_core,
        "eta": r.eta,
        # the single-vector norm kernel on the card (K5)
        "update_norm": ops.grad_norm(ota.ravel(y)),
        "num_participants": r.participants,
        "csi_gain_err": csi_gain_err,
    }
    return new_params, new_opt_state, diag


class Lane(NamedTuple):
    """One run's device side, as a round body reads it: the state a round
    rewrites (params, the server optimizer's state, the client state) and
    the run's constants (the fixed channel ``h`` and the server's estimate
    ``h_hat``, the same tensor under perfect CSI; grad_bound as a 0-d fp32
    tensor or None; the client numerics as ``ClientParams`` of 0-d fp32
    tensors).  A batched run has one a lane."""
    params: Tree
    opt_state: Any
    cstate: Optional[Dict[str, Any]]
    h: torch.Tensor
    h_hat: torch.Tensor
    gb: Optional[torch.Tensor]
    cp: clients.ClientParams


class RoundBody:
    """The device work of one round of one (config, grad_fn,
    block_batch_fn): ``body(lane, staged, cursor, hist)`` reads the round's
    inputs at row ``cursor`` of the staged chunk, runs the dense or the
    streaming round on the lane (``Lane``), writes its ``DIAG_KEYS`` to the
    same row of ``hist`` [T, 8] and advances ``cursor`` (a [1] int64
    tensor).  A time-varying channel's staged ``h``/``h_hat`` take the place
    of the lane's.  Both rounds get ``h_hat``: the air uses ``h``, every
    server-side quantity ``h_hat``.  It makes no host sync and reads no CPU
    tensor, so a CUDA graph can capture it.  Returns the new ``(params,
    opt_state, cstate)``.

    The body reads nothing of the batchable fields but the noise gate:
    ``noisy`` says whether the staged chunks carry channel noise (default:
    ``_noisy([cfg])``; a batched run passes its group's gate), so the body
    of ``structural_config(cfg)`` is the body of ``cfg``: grad_bound, mu
    and alpha come from the lane, in device memory.

    ``mesh`` is the sharded round's group of ``device_mesh`` ranks, taken
    when the body is built (``distribution.sharding.device_mesh``; None:
    the emulated shards), and ``collective`` says whether a round runs a
    collective (that group, or the ``mesh`` backend's K ranks)."""

    def __init__(self, cfg: FLConfig, grad_fn: GradFn,
                 block_batch_fn: Optional[Callable] = None, *,
                 noisy: Optional[bool] = None):
        self.cfg, self.grad_fn, self.block_batch_fn = cfg, grad_fn, \
            block_batch_fn
        self.sch = schemes.get(cfg.scheme)
        self.opt = server_optimizer(cfg)
        if noisy is None:
            noisy = _noisy([cfg])
        kb = (None if cfg.k_block is None
              else min(cfg.k_block, cfg.stream_length()))
        # noise_var only gates the staged noise here (the values come
        # staged); grad_bound only passes validation (the body takes G as
        # ``gb``)
        self.ocfg = ota.OTAConfig(scheme=cfg.scheme,
                                  noise_var=1.0 if noisy else 0.0,
                                  grad_bound=cfg.grad_bound,
                                  backend=cfg.backend, k_block=kb)
        # the second OTA slot of a two-slot client algorithm
        self.ocfg2 = None
        if clients.get(cfg.client.algo).num_slots == 2:
            self.ocfg2 = dataclasses.replace(
                self.ocfg, scheme=cfg.client.variate_scheme)
        self.mesh = None
        if cfg.sharded():
            from repro_torch.distribution import sharding
            self.mesh = sharding.device_mesh(cfg.device_mesh)
        self.collective = self.mesh is not None or cfg.backend == "mesh"

    def __call__(self, lane: Lane, staged: RoundInputs,
                 cursor: torch.Tensor, hist: torch.Tensor):
        r = _map_inputs(lambda v: v.index_select(0, cursor)[0], staged)
        h, h_hat = (lane.h, lane.h_hat) if r.h is None else (r.h, r.h_hat)
        args = (self.cfg, self.sch, self.opt, self.grad_fn, self.ocfg,
                lane.params, lane.opt_state, r, h, lane.gb)
        client = dict(cstate=lane.cstate, cp=lane.cp, ocfg2=self.ocfg2)
        if self.cfg.k_block is not None:
            params, opt_state, diag, cstate = _round_math_streaming(
                *args, h_hat=h_hat, block_batch_fn=self.block_batch_fn,
                mesh=self.mesh, **client)
        else:
            params, opt_state, diag, cstate = _round_math(
                *args, h_hat=h_hat, **client)
        row = torch.stack([diag[k].float() for k in DIAG_KEYS])
        hist.index_copy_(0, cursor, row[None])
        cursor.add_(1)
        return params, opt_state, cstate


@dataclasses.dataclass
class _LaneHost:
    """One run's (a lane's) host side: its config, the CPU fp32 channel of
    its participation fold (the estimate ``h_hat``, ``b``, the gain ``a``)
    and step size.  Under a time-varying channel ``_stage`` advances ``h``,
    ``h_hat``, ``b`` and ``a`` to the last staged round, with the fading
    state ``fad``; ``scale`` is the amplitude scale (a float, or the
    geometry's [K] fp32 vector) and ``eff_gain`` the designed effective
    gain (0-d fp32)."""
    cfg: FLConfig
    h_hat: torch.Tensor
    b: torch.Tensor
    a: float
    eta0: float
    model_dim: int = 0
    h: Optional[torch.Tensor] = None
    fad: Optional[torch.Tensor] = None
    scale: Any = None
    eff_gain: Optional[torch.Tensor] = None


def _zero_noise(cfg: FLConfig) -> float:
    """The noise a lane with sigma^2 = 0 stages in a group whose other lanes
    have noise: what its own run adds.  The dense round on the kernels
    backend hands K2 zeros (+0.0) where it has no noise; the other rounds
    add nothing, and x + (-0.0) == x for every fp32 x."""
    return 0.0 if cfg.backend == "kernels" and cfg.k_block is None else -0.0


def _draw_row(row: torch.Tensor, gen: torch.Generator,
              shapes: Dict[str, torch.Size], std: float) -> None:
    """One round's noise of one lane into ``row`` [N]: one draw a leaf in
    sorted-key order, each into its slice, then scaled in place."""
    off = 0
    for k in sorted(shapes):
        m = math.prod(shapes[k])
        torch.randn(shapes[k], generator=gen,
                    out=row[off:off + m].view(shapes[k]))
        off += m
    row.mul_(std)


def _stage_noise(lanes: Sequence[_LaneHost], shapes: Dict[str, torch.Size],
                 ts: Sequence[int],
                 noise_provider: Optional[Callable] = None,
                 salts: Tuple[int, ...] = ()) -> torch.Tensor:
    """The [T, E, N] fp32 channel noise of the rounds ``ts`` of the lanes,
    drawn straight into one CPU buffer: round t of a lane draws on
    ``rng.generator(seed + 1, *salts, t)`` (``salts`` empty for slot 1,
    ``(rng.SLOT_SALT,)`` for slot 2) one leaf at a time in sorted-key
    order, each into its slice, and is scaled in place by
    ``sqrt(noise_var)`` (``_draw_row``); the values are bitwise
    ``ota.resolve_noise``'s, with no zeros, add, concatenation or stack on
    the way.  ``noise_provider(t)`` gives a single run's flat noise
    instead."""
    n = sum(math.prod(s) for s in shapes.values())
    buf = torch.empty((len(ts), len(lanes), n), dtype=torch.float32)
    for e, lane in enumerate(lanes):
        noise_var = lane.cfg.channel.noise_var
        if noise_var <= 0.0:
            buf[:, e].fill_(_zero_noise(lane.cfg))
            continue
        for i, t in enumerate(ts):
            if noise_provider is None:
                _draw_row(buf[i, e],
                          rng.generator(lane.cfg.seed + 1, *salts, t),
                          shapes, math.sqrt(noise_var))
                continue
            z = noise_provider(t)
            if tuple(z.shape) != (n,):
                raise ValueError(f"injected noise has shape "
                                 f"{tuple(z.shape)}, expected ({n},)")
            buf[i, e].copy_(z)
    return buf


def _noisy(cfgs: Sequence[FLConfig]) -> bool:
    """The noise gate of a group of lanes, from the configs' own values:
    whether any lane carries channel noise.  The round body and the staging
    both take it from here."""
    return any(schemes.maybe_positive(c.channel.noise_var) for c in cfgs)


def _refresh(lanes: Sequence[_LaneHost], ts: Sequence[int],
             fading_provider: Optional[Callable] = None):
    """A time-varying channel's rounds ``ts`` of the lanes on the host (the
    reference's ``_fading_refresh``): round t of a lane steps its model on
    ``rng.generator(seed + 2, t)`` from its running fading state, estimates
    ``h_hat_t`` on ``rng.generator(seed + 2, rng.CSI_SALT, t)`` when
    ``csi_error > 0``, then every round of every lane re-solves Problem 3
    on ``h_hat_t`` in one batched call (or takes ``b_max`` under
    ``amplification='bmax'``) and sets ``a_t = eff_gain / sum h_hat_t b_t``
    in fp32.  ``fading_provider(t)`` gives a single run's ``(w, e)``
    instead: the [K, 2] innovation normals and the [K] estimation normals
    (or None under perfect CSI).  Advances each lane to the last round and
    returns ``h, h_hat, b`` [T, E, K] and ``a`` [T, E], fp32 on the CPU."""
    cfg0 = lanes[0].cfg
    rounds, num, k = len(ts), len(lanes), cfg0.num_devices
    model = chl.get(cfg0.channel.model)
    hs, h_hats = [], []
    for t in ts:
        for lane in lanes:
            ccfg = lane.cfg.channel
            seed = lane.cfg.seed + 2
            w, e = ((rng.generator(seed, t), None) if fading_provider is None
                    else fading_provider(t))
            h, lane.fad = model.step(ccfg, lane.scale, w, lane.fad, ccfg.rho)
            h_hat = h
            if ccfg.csi_error > 0.0:
                if e is None:
                    e = torch.randn(k, generator=rng.generator(
                        seed, rng.CSI_SALT, t))
                h_hat = chl.estimate(h, e, ccfg.csi_error, lane.scale,
                                     ccfg.csi_error_model)
            hs.append(h)
            h_hats.append(h_hat)
    h, h_hat = torch.stack(hs), torch.stack(h_hats)           # [T E, K]
    b_max = torch.tensor([lane.cfg.channel.b_max for lane in lanes],
                         dtype=torch.float32).repeat(rounds)
    if cfg0.amplification == "optimal":
        noise_var = torch.tensor([lane.cfg.channel.noise_var
                                  for lane in lanes]).repeat(rounds)
        b = amp.solve_problem3_torch(h_hat, noise_var, lanes[0].model_dim,
                                     b_max).b
    else:
        b = b_max[:, None].expand(h.shape).contiguous()
    eff = torch.stack([lane.eff_gain for lane in lanes]).repeat(rounds)
    if cfg0.sharded():
        # the sharded round's gain sums are pinned, as the reference's
        a = eff / torch.stack([ota.pinned_sum(v) for v in h_hat * b])
    else:
        a = eff / torch.sum(h_hat * b, dim=1)
    h, h_hat, b = (v.reshape(rounds, num, k) for v in (h, h_hat, b))
    a = a.reshape(rounds, num)
    for e, lane in enumerate(lanes):
        lane.h, lane.h_hat, lane.b = h[-1, e], h_hat[-1, e], b[-1, e]
        lane.a = a[-1, e]
    return h, h_hat, b, a


def _stage(lanes: Sequence[_LaneHost], sch: schemes.Scheme,
           shapes: Dict[str, torch.Size], ts: Sequence[int],
           noise_provider: Optional[Callable] = None,
           mask_provider: Optional[Callable] = None,
           fading_provider: Optional[Callable] = None,
           slot2_noise_provider: Optional[Callable] = None, *,
           noisy: bool) -> RoundInputs:
    """The host work of the rounds ``ts`` of E structurally identical
    lanes: each round's inputs drawn on the lane's CPU generators (or taken
    from the providers) exactly as a round of its own run would draw them,
    as [T, E, ...] CPU tensors (``batch`` left None).  ``shapes`` are the
    single-device leaf shapes.  The noise is staged for every lane when the
    group is ``noisy`` (``_noisy``, the gate its round body was built
    with); a lane without noise stages zeros (``_zero_noise``).  A
    two-slot client algorithm stages its second slot's noise as ``noise2``
    (its own stream, ``rng.SLOT_SALT``; ``slot2_noise_provider(t)``
    replaces it as ``noise_provider`` does slot 1's).  A time-varying
    channel is refreshed first (``_refresh``) and staged as ``h``/``h_hat``;
    the participation fold then runs on each round's ``(h_hat_t, b_t,
    a_t)``."""
    cfg0 = lanes[0].cfg
    rounds, num, k = len(ts), len(lanes), cfg0.num_devices
    noise = noise2 = None
    if not sch.baseline and noisy:
        noise = _stage_noise(lanes, shapes, ts, noise_provider)
    if noisy and clients.get(cfg0.client.algo).num_slots == 2:
        noise2 = _stage_noise(lanes, shapes, ts, slot2_noise_provider,
                              salts=(rng.SLOT_SALT,))
    t = torch.tensor(list(ts), dtype=torch.int64)[:, None].expand(rounds, num)
    eta = torch.tensor([[_eta_t(lane.cfg, lane.eta0, s) for lane in lanes]
                        for s in ts], dtype=torch.float32)
    chan_in: Dict[str, torch.Tensor] = {}
    if cfg0.channel.time_varying():
        h, h_hat, b, a = _refresh(lanes, ts, fading_provider)
        chan_in = dict(h=h, h_hat=h_hat)
    else:
        h_hat = torch.stack([lane.h_hat for lane in lanes]).expand(rounds,
                                                                   num, k)
        b = torch.stack([lane.b for lane in lanes]).expand(rounds, num, k)
        a = torch.tensor([lane.a for lane in lanes],
                         dtype=torch.float32).expand(rounds, num)
    if cfg0.participation >= 1.0:
        return RoundInputs(
            t=t, eta=eta, a_eff=a, b_eff=b,
            participants=torch.full((rounds, num), float(k)), noise=noise,
            noise2=noise2, **chan_in)
    fields = collections.defaultdict(list)
    ksum = ota.pinned_sum if cfg0.sharded() else torch.sum
    for i, s in enumerate(ts):
        for e, lane in enumerate(lanes):
            cfg = lane.cfg
            mask = (mask_provider(s) if mask_provider is not None
                    else _participation_mask(cfg, s))
            mask = mask.to(device="cpu", dtype=torch.float32)
            if mask.shape != (k,):
                raise ValueError(f"round {s}'s mask has shape "
                                 f"{tuple(mask.shape)}, expected ({k},)")
            b_eff, a_eff = ota.participation_fold(h_hat[i, e], b[i, e],
                                                  a[i, e], mask, ksum)
            count = float(mask.sum())
            fields["a_eff"].append(a_eff)
            fields["b_eff"].append(b_eff)
            fields["participants"].append(torch.tensor(count))
            fields["mask"].append(mask)
            fields["empty"].append(torch.tensor(count == 0.0))
            if sch.baseline:
                fields["weights"].append(mask / max(count, 1.0))
            if cfg.active_gather:
                fields["active"].append(_active_indices(cfg, mask))
    staged = {name: torch.stack(v).reshape((rounds, num) + v[0].shape)
              for name, v in fields.items()}
    return RoundInputs(t=t, eta=eta, noise=noise, noise2=noise2, **staged,
                       **chan_in)


def _batch_leaves(batch) -> List[torch.Tensor]:
    if isinstance(batch, torch.Tensor):
        return [batch]
    values = batch.values() if isinstance(batch, dict) else batch
    return [l for v in values for l in _batch_leaves(v)]


def _stack_batches(batch_provider: Callable[[int], Any],
                   ts: Sequence[int]):
    """One [T, K, ...] batch of the rounds ``ts`` from ``batch_provider``
    (the default when the task has no ``chunk_batch_provider``)."""
    per_round = [batch_provider(t) for t in ts]

    def stack(*xs):
        first = xs[0]
        if isinstance(first, torch.Tensor):
            return torch.stack(xs)
        if isinstance(first, dict):
            return {k: stack(*(x[k] for x in xs)) for k in first}
        return type(first)(stack(*parts) for parts in zip(*xs))
    return stack(*per_round)


def _copy_into(dst, src) -> None:
    """Copy params, an optimizer state, a client state or a lane (a tensor,
    or a dict, tuple or list of them, None left alone) into buffers of the
    same structure."""
    if dst is None:
        return
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    else:
        for d, s_ in zip(dst, src):
            _copy_into(d, s_)


def _rebuild(like, values):
    """A tuple or a NamedTuple (an optimizer state) of ``values``, as
    ``like``."""
    values = list(values)
    return type(like)(*values) if hasattr(like, "_fields") else tuple(values)


def _clone(tree):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return _rebuild(tree, (_clone(v) for v in tree))


def _run_eager(body: RoundBody, lane: Lane, staged: RoundInputs):
    """The body over every round of one lane's staged chunk, launched from
    the host round by round; returns the lane with its new state and the
    [T, 8] history (one device-to-host copy)."""
    rounds = staged.t.shape[0]
    cursor = torch.zeros((1,), dtype=torch.int64, device=lane.h.device)
    hist = torch.empty((rounds, len(DIAG_KEYS)), dtype=torch.float32,
                       device=lane.h.device)
    for _ in range(rounds):
        lane = lane._replace(**dict(zip(
            ("params", "opt_state", "cstate"),
            body(lane, staged, cursor, hist))))
    return lane, hist.cpu()


def _lane_state(lane: Lane) -> tuple:
    """What a round rewrites: ``(params, opt_state, cstate)``."""
    return lane.params, lane.opt_state, lane.cstate


class _EagerChunks:
    """The scan driver's engine on the CPU: each lane's round body run
    eagerly, chunk by chunk.  ``launch`` takes a [T, E, ...] staged chunk,
    ``rows`` gives the [E, T, 8] history and ``state`` each lane's
    ``(params, opt_state, cstate)``."""

    def __init__(self, body: RoundBody, kind: str = "run_chunk"):
        self.body = body
        self.lanes: List[Lane] = []
        self.hist = None
        # round bodies the last launch ran (rounds x lanes)
        self.dispatches = 0
        _count_trace(kind)

    def start(self, lanes: Sequence[Lane]) -> None:
        self.lanes = list(lanes)

    def launch(self, staged: RoundInputs) -> None:
        device = self.lanes[0].h.device
        staged = _map_inputs(lambda v: v.to(device), staged)
        rows = []
        for e, lane in enumerate(self.lanes):
            self.lanes[e], hist = _run_eager(self.body, lane,
                                             _lane(staged, e))
            rows.append(hist)
        self.hist = torch.stack(rows)
        self.dispatches = staged.t.shape[0] * len(self.lanes)

    def rows(self) -> torch.Tensor:
        return self.hist

    def state(self) -> List[tuple]:
        return [_lane_state(lane) for lane in self.lanes]


# device index -> the stream every graph of the scan driver is captured on
# (the eager warm-up runs there first, so that its cuBLAS workspace and
# K1's and K5's arrival counters exist before the capture; graphs captured
# on one stream share those counters, and are replayed one at a time)
_CAPTURE_STREAMS: Dict[int, torch.cuda.Stream] = {}
# device index -> the one memory pool every graph of the device is captured
# into.  A graph's allocations are all temporaries of its round (the state,
# the staged buffers, the cursor and the history live outside the pool), so
# graphs may share them: safe because every capture and every replay runs on
# one stream, one at a time, never concurrently
_GRAPH_POOLS: Dict[int, Any] = {}
GRAPH_WARMUP_ROUNDS = 2


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    if device.index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device.index] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device.index]


def _graph_pool(device: torch.device):
    if device.index not in _GRAPH_POOLS:
        _GRAPH_POOLS[device.index] = torch.cuda.graph_pool_handle()
    return _GRAPH_POOLS[device.index]


class _GraphChunks:
    """The scan driver's engine on a CUDA device: one round of every lane
    captured in one CUDA graph over fixed buffers (each ``Lane``: params,
    optimizer and client state, channel and estimate, grad_bound and client
    numerics; each lane's cursor and [chunk_size, 8] history; the
    [chunk_size, E, ...] staged inputs), and replayed once per round of a
    chunk.  The round's new state is copied into the lane's buffers in
    place (``_copy_into``), since a replay reads fixed addresses.  A single run is one lane.  The lanes run one after
    another on the capture stream, so they share K1's and K5's arrival
    counters (``grad_norm._arrivals``, one set a stream) safely; spreading
    lanes over streams would need a set of counters for each stream."""

    def __init__(self, body: RoundBody, device: torch.device,
                 chunk_size: int, lanes: int = 1, kind: str = "run_chunk"):
        self.body, self.device, self.chunk_size = body, device, chunk_size
        self.kind = kind
        self.graph = None
        self.rounds = 0
        self.per_replay: Dict[str, int] = {}
        self.static = self.staged = self.pending = None
        self.cursor = torch.zeros((lanes, 1), dtype=torch.int64,
                                  device=device)
        self.hist = torch.zeros((lanes, chunk_size, len(DIAG_KEYS)),
                                dtype=torch.float32, device=device)

    def start(self, lanes: Sequence[Lane]) -> None:
        self.pending = list(lanes)

    def _stage(self, staged: RoundInputs) -> None:
        rounds = staged.t.shape[0]
        if self.staged is None:
            self.staged = _map_inputs(
                lambda v: torch.zeros((self.chunk_size,) + v.shape[1:],
                                      dtype=v.dtype, device=self.device),
                staged)
        for buf, v in zip(_batch_leaves([x for x in self.staged
                                         if x is not None]),
                          _batch_leaves([x for x in staged
                                         if x is not None])):
            buf[:rounds].copy_(v)

    def _step(self) -> None:
        for e, lane in enumerate(self.static):
            new = self.body(lane, _lane(self.staged, e), self.cursor[e],
                            self.hist[e])
            _copy_into(_lane_state(lane), new)

    def _warm_up(self) -> "torch.cuda.Stream":
        """Run the body eagerly on the capture stream, on scratch copies of
        the run's state (the run's own are loaded after the capture), so
        that what it sets up at first use exists before the capture."""
        self.static = _clone(self.pending)
        stream = _capture_stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            for _ in range(GRAPH_WARMUP_ROUNDS):
                self.cursor.zero_()
                self._step()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        return stream

    def _capture(self) -> None:
        """Warm up, then capture one round of every lane.  A capture that
        fails raises: the run never falls back to eager rounds on the
        card."""
        stream = self._warm_up()
        graph = torch.cuda.CUDAGraph()
        with ops.capture_counts() as self.per_replay:
            with torch.cuda.graph(graph, pool=_graph_pool(self.device),
                                  stream=stream):
                self._step()
        self.graph = graph
        _count_trace(self.kind)

    @property
    def dispatches(self) -> int:
        """The graph replays the last launch queued."""
        return self.rounds

    def launch(self, staged: RoundInputs) -> None:
        """Copy a chunk's inputs in and replay the graph once a round;
        returns as soon as the replays are queued."""
        self.rounds = staged.t.shape[0]
        self._stage(staged)
        if self.graph is None:
            self._capture()
        if self.pending is not None:
            _copy_into(self.static, self.pending)
            self.pending = None
        self.cursor.zero_()
        for _ in range(self.rounds):
            self.graph.replay()
        ops.replay_counts(self.per_replay, self.rounds)

    def rows(self) -> torch.Tensor:
        """The last chunk's [E, T, 8] history: one device-to-host copy."""
        return self.hist[:, :self.rounds].cpu()

    def state(self) -> List[tuple]:
        return [_clone(_lane_state(lane)) for lane in self.static]


@functools.lru_cache(maxsize=ENGINE_CACHE_SIZE)
def make_round_step(cfg: FLConfig, grad_fn: GradFn, block_batch_fn=None):
    """The python driver's round body, cached on (cfg, grad_fn,
    block_batch_fn)."""
    _count_trace("round_step")
    return RoundBody(cfg, grad_fn, block_batch_fn)


@functools.lru_cache(maxsize=ENGINE_CACHE_SIZE)
def _make_run_chunk(cfg: FLConfig, grad_fn: GradFn, block_batch_fn,
                    device: torch.device, chunk_size: int, batch_spec):
    """The scan driver's engine, cached on (cfg, grad_fn, block_batch_fn,
    device, chunk_size, the batch's leaf shapes and types): on a CUDA
    device one CUDA graph of the round, captured at the first chunk; on
    the CPU the same body run eagerly.  A round that runs a collective
    (``RoundBody.collective``) runs eagerly on the card too, counted in
    ``EAGER_ON_CARD``: a ``gloo`` collective cannot be captured."""
    body = RoundBody(cfg, grad_fn, block_batch_fn)
    if device.type == "cuda":
        if not body.collective:
            return _GraphChunks(body, device, chunk_size)
        EAGER_ON_CARD["run_chunk"] += 1
    return _EagerChunks(body)


@functools.lru_cache(maxsize=ENGINE_CACHE_SIZE)
def _make_run_chunk_batched(sig: FLConfig, grad_fn: GradFn,
                            device: torch.device, chunk_size: int,
                            batch_spec, lanes: int, noisy: bool):
    """A batched run's engine, cached on (the structural config, grad_fn,
    device, chunk_size, the batch spec, the lane count and the group's
    noise gate): on a CUDA device one CUDA graph of one round of every
    lane, on the CPU the lanes' bodies run eagerly.  Each lane runs the
    body of its own config (the body reads no batchable field), so a lane
    gives its own run's bits."""
    body = RoundBody(sig, grad_fn, noisy=noisy)
    if device.type == "cuda":
        return _GraphChunks(body, device, chunk_size, lanes,
                            kind="run_chunk_batched")
    return _EagerChunks(body, kind="run_chunk_batched")


# name -> lru-cached builder, for cache_info()/clear_compile_caches()
_CACHED_BUILDERS = {"round_step": make_round_step,
                    "run_chunk": _make_run_chunk,
                    "run_chunk_batched": _make_run_chunk_batched}


def _plan_chunks(t0: int, num_rounds: int, eval_every: Optional[int],
                 chunk_size: int) -> List[List[int]]:
    """Group rounds ``t0+1 .. t0+num_rounds`` into scan chunks.  Every round
    the python driver would eval on (t == 1 or t % eval_every == 0) ends a
    chunk, so the scan driver observes params at identical rounds."""
    chunks: List[List[int]] = []
    cur: List[int] = []
    for t in range(t0 + 1, t0 + num_rounds + 1):
        cur.append(t)
        if (len(cur) >= chunk_size
                or (eval_every is not None
                    and (t == 1 or t % eval_every == 0))):
            chunks.append(cur)
            cur = []
    if cur:
        chunks.append(cur)
    return chunks


def _locked_eval_keys(metrics: Dict[str, float],
                      eval_keys: Optional[Tuple[str, ...]],
                      t, where: str = "") -> Tuple[str, ...]:
    """The metric key set is locked on the first eval, so per-round metric
    lists stay aligned with ``hist['eval_round']``."""
    if eval_keys is None:
        return tuple(metrics)
    if set(metrics) != set(eval_keys):
        raise ValueError(
            f"eval_fn returned metric keys {sorted(metrics)} at round {t}"
            f"{where}, but the history locked {sorted(eval_keys)} on the "
            "first eval -- per-round metric lists must stay aligned with "
            "hist['eval_round']")
    return eval_keys


def designed_gain(state: FLState) -> float:
    """A time-varying channel's designed effective gain ``a sum h_hat_k
    b_k``: what the server set on its estimate (the reference's float64
    sum, cast to fp32), from the state's ``a``, ``b`` and ``h_hat``."""
    h_hat = state.h if state.h_hat is None else state.h_hat
    return float(np.float32(state.a * float(np.sum(
        np.asarray(h_hat, np.float64) * np.asarray(state.b, np.float64)))))


def _lane_inputs(cfg: FLConfig, state: FLState,
                 device: torch.device) -> Tuple[_LaneHost, tuple]:
    """A run's host side (``_LaneHost``) and its channel on the device
    ``(h, h_hat)``: the fp32 channel and the server's estimate (``h`` itself
    under perfect CSI, as the reference's ``h_hat = None``), as the
    reference holds them (a and eta0 as fp32 scalars).  Checks what a
    time-varying channel needs of the state and fixes its designed gain
    ``state.eff_gain`` on the first run."""
    ccfg = cfg.channel
    model = chl.get(ccfg.model)
    fad = None
    if model.has_state:
        if state.fad_state is None:
            raise ValueError(
                f"channel model {ccfg.model!r} threads a persistent fading "
                "state; FLState.fad_state is unset -- build the state via "
                "setup()")
        fad = torch.as_tensor(state.fad_state, dtype=torch.float32)
    h_cpu = torch.as_tensor(state.h, dtype=torch.float32)
    h_hat_np = state.h if state.h_hat is None else state.h_hat
    h_hat_cpu = (h_cpu if ccfg.csi_error == 0.0
                 else torch.as_tensor(h_hat_np, dtype=torch.float32))
    eff_gain = None
    if ccfg.time_varying():
        if state.model_dim <= 0:
            raise ValueError("a time-varying channel re-solves Problem 3 "
                             "with the real model dimension; "
                             "FLState.model_dim is unset -- build the state "
                             "via setup()")
        if state.eff_gain is None:
            state.eff_gain = designed_gain(state)
        eff_gain = torch.tensor(state.eff_gain, dtype=torch.float32)
    scale = (ccfg.amplitude_scale() if state.scale is None
             else torch.as_tensor(state.scale, dtype=torch.float32))
    host = _LaneHost(cfg, h_hat_cpu,
                     torch.as_tensor(state.b, dtype=torch.float32),
                     float(np.float32(state.a)), float(np.float32(state.eta0)),
                     model_dim=state.model_dim, h=h_cpu, fad=fad,
                     scale=scale, eff_gain=eff_gain)
    h_dev = h_cpu.to(device)
    h_hat_dev = h_dev if h_hat_cpu is h_cpu else h_hat_cpu.to(device)
    return host, (h_dev, h_hat_dev)


def _batch_axes(cfgs: Sequence[FLConfig], device: torch.device) -> BatchAxes:
    """The per-lane numerics the round body reads from device memory, each
    [E] fp32 on ``device``: grad_bound where the configs have one, and the
    client's ``mu`` / ``alpha`` where the algorithm reads them (the
    reference's lanes).  A single run is one lane."""
    alg = clients.get(cfgs[0].client.algo)

    def lanes(values, present):
        return (torch.tensor(values, dtype=torch.float32, device=device)
                if present else None)
    return BatchAxes(
        grad_bound=lanes([c.grad_bound for c in cfgs],
                         cfgs[0].grad_bound is not None),
        client_mu=lanes([c.client.mu for c in cfgs], alg.uses_mu),
        client_alpha=lanes([c.client.alpha for c in cfgs], alg.uses_alpha))


def _make_lane(state: FLState, h: torch.Tensor, h_hat: torch.Tensor,
               over: BatchAxes, e: int) -> Lane:
    """Lane e of a run: the state's params, optimizer and client state,
    the channel, and the lane's entries of ``over``."""
    pick = lambda v: None if v is None else v[e]
    return Lane(state.params, state.opt_state, state.client_state, h, h_hat,
                pick(over.grad_bound),
                clients.ClientParams(pick(over.client_mu),
                                     pick(over.client_alpha)))


def _write_back(state: FLState, host: _LaneHost) -> None:
    """A time-varying channel's last round into the state (the reference's
    write-back): ``h``, ``h_hat``, ``b``, ``a`` and the fading state, so a
    second ``run`` resumes from it."""
    if not host.cfg.channel.time_varying():
        return
    state.h = host.h.double().numpy()
    state.h_hat = host.h_hat.double().numpy()
    state.b = host.b.double().numpy()
    state.a = float(host.a)
    if host.fad is not None:
        state.fad_state = host.fad.double().numpy()


def _init_missing_state(cfg: FLConfig, state: FLState,
                        device: torch.device) -> None:
    """The server optimizer's state, and a stateful client algorithm's zero
    state, where a state was built without them (as the reference)."""
    if state.opt_state is None:
        # step = rounds already taken, so Adam bias correction matches an
        # unbroken run
        init = server_optimizer(cfg).init(state.params)
        state.opt_state = init._replace(
            step=torch.tensor(state.round, dtype=torch.int32, device=device))
    if (clients.get(cfg.client.algo).stateful
            and state.client_state is None):
        state.client_state = clients.init_state(cfg.client, state.params,
                                                cfg.num_devices)


def _params_device(params: Tree) -> torch.device:
    return params[sorted(params)[0]].device


def _drive_chunks(make_engine: Callable[[RoundInputs], Any],
                  chunks: List[List[int]], staged_chunk: Callable,
                  record: Callable):
    """The scan driver's loop: each chunk's replays are queued, the next
    chunk's host work runs while the card replays, then the chunk's
    history is read back and recorded.  ``make_engine(staged)`` gives the
    engine from the first staged chunk.  ``record(i, ts, rows, engine,
    info)`` gets chunk i's history with its attribution ``info``: the wall
    time from ``launch`` to the return of ``rows()`` (a span that holds the
    next chunk's staging, which overlaps the replays), the round launches
    the engine queued, and the ``TRACE_COUNTS`` delta (chunk 0's holds the
    engine's build or capture).  Each chunk runs inside
    ``profiling.annotate_chunk``.  Returns the engine."""
    traces = dict(TRACE_COUNTS)
    staged = staged_chunk(chunks[0])
    engine = make_engine(staged)
    for i, ts in enumerate(chunks):
        with profiling.annotate_chunk(i):
            start = time.perf_counter()
            engine.launch(staged)
            if i + 1 < len(chunks):
                staged = staged_chunk(chunks[i + 1])
            rows = engine.rows()
            info = dict(wall_time_s=time.perf_counter() - start,
                        dispatches=engine.dispatches,
                        retraces=trace_deltas(traces))
        traces = dict(TRACE_COUNTS)
        record(i, ts, rows, engine, info)
    return engine


def _emit_chunk(recorder, i: int, ts: Sequence[int], rows: torch.Tensor,
                info: Dict[str, Any]) -> None:
    """Chunk i's ``chunk`` and ``round`` events from its history on the
    host (``rows`` [T, 8], or [E, T, 8] for a batched run)."""
    if recorder is not None:
        recorder.on_chunk(i, list(ts), {k: rows[..., j].numpy()
                                        for j, k in enumerate(DIAG_KEYS)},
                          rss_mb=profiling.rss_mb(), **info)


def _batch_spec(staged: RoundInputs):
    """The leaf shapes (past the round axis) and types of a staged batch."""
    return tuple((tuple(l.shape[1:]), l.dtype) for l in
                 _batch_leaves(() if staged.batch is None else staged.batch))


def run(cfg: FLConfig, state: FLState, grad_fn: GradFn,
        batch_provider: Callable[[int], Any], num_rounds: int,
        eval_fn: Optional[Callable[[Tree], Dict[str, float]]] = None,
        eval_every: int = 10, *, driver: str = "scan",
        chunk_size: int = 16,
        chunk_batch_provider: Optional[Callable[[Sequence[int]], Any]] = None,
        noise_provider: Optional[Callable[[int], torch.Tensor]] = None,
        mask_provider: Optional[Callable[[int], torch.Tensor]] = None,
        block_batch_provider: Optional[Callable[[torch.Tensor, torch.Tensor],
                                                Any]] = None,
        fading_provider: Optional[Callable[[int], Tuple[
            torch.Tensor, Optional[torch.Tensor]]]] = None,
        slot2_noise_provider: Optional[Callable[[int], torch.Tensor]] = None,
        recorder=None) -> Tuple[FLState, Dict[str, List]]:
    """Run ``num_rounds`` FL rounds on the selected driver.

    ``batch_provider(t)`` returns the per-device batch (leading K axis) for
    round t on the params' device.  ``driver='scan'`` (default) runs the
    chunked engine (a CUDA graph of the round on the card), ``'python'``
    the round body one round at a time; both give the same bits.  Both
    evaluate ``eval_fn`` at t == 1 and every ``eval_every``-th round, the
    scan driver at chunk ends (``_plan_chunks`` ends a chunk at every eval
    round).  ``chunk_size`` bounds the scan driver's rounds a chunk, and
    ``chunk_batch_provider(ts)``, when given, supplies a chunk's batches as
    one [T, K, ...] batch instead of T ``batch_provider`` calls stacked.

    ``noise_provider(t)``, when given, returns round t's flat channel noise
    z [N] (sorted-key leaf order) instead of the draw from
    ``rng.generator(cfg.seed + 1, t)``, and ``slot2_noise_provider(t)``
    the second OTA slot's (a two-slot client algorithm) instead of the draw
    from ``rng.generator(cfg.seed + 1, rng.SLOT_SALT, t)``;
    ``mask_provider(t)`` returns round
    t's [K] 0/1 participation mask (``participation`` < 1) instead of
    ``_participation_mask``'s draw.  Under a time-varying channel
    ``fading_provider(t)`` returns round t's standard normals ``(w, e)``:
    the [K, 2] innovation pair of the model's step and the [K] estimation
    error under imperfect CSI (else None), in place of the draws on
    ``rng.generator(cfg.seed + 2, ...)``; the model step, the estimate, the
    Problem-3 re-solve and the gain stay the port's own.

    ``block_batch_provider(t, dev_idx)`` is the streaming round's lazy-batch
    hook (requires ``cfg.k_block``): it returns one K-block's [k_block, ...]
    batch on the params' device from the round index ``t`` and the block's
    [k_block] device indices, so no [K, ...] batch stack ever exists;
    ``batch_provider`` may then be None.  ``t`` is a 0-d int64 tensor on the
    device (the reference passes a traced int): the hook runs inside the
    round body, which a CUDA graph replays, so it must compute on the
    device and never read ``t`` on the host.

    ``recorder`` (a ``repro_torch.obs.Recorder``) gets one ``chunk`` event
    and its ``round`` events for every chunk (under ``python``: every
    round), after the chunk's history is back on the host, and an ``eval``
    event at every eval round.  It never reaches the round body, the staged
    inputs or the captured graph: on or off, the bits are the same.

    The params, server optimizer state, client state, round counter and a
    time-varying channel (``h``, ``h_hat``, ``b``, ``a``, ``fad_state``, as
    of the last round) persist in ``state``, so a second ``run`` resumes
    where the first stopped."""
    if driver not in DRIVERS:
        raise ValueError(f"unknown driver {driver!r}; one of {DRIVERS}")
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    if block_batch_provider is not None and cfg.k_block is None:
        raise ValueError("block_batch_provider streams per-K-block batches "
                         "inside the round; set cfg.k_block")
    if mask_provider is not None and cfg.participation >= 1.0:
        raise ValueError("mask_provider replaces the participation draw; "
                         "set cfg.participation < 1")
    if fading_provider is not None and not cfg.channel.time_varying():
        raise ValueError("fading_provider replaces the per-round channel "
                         "draws; the channel is fixed")
    if (slot2_noise_provider is not None
            and clients.get(cfg.client.algo).num_slots != 2):
        raise ValueError("slot2_noise_provider replaces the second OTA "
                         f"slot's noise; client algorithm "
                         f"{cfg.client.algo!r} has one slot")
    sch = schemes.get(cfg.scheme)
    params = state.params
    device = _params_device(params)
    _init_missing_state(cfg, state, device)
    host, (h, h_hat) = _lane_inputs(cfg, state, device)
    lane = _make_lane(state, h, h_hat, _batch_axes([cfg], device), 0)
    shapes = {k: params[k].shape for k in sorted(params)}
    noisy = _noisy([cfg])

    def staged_chunk(ts: Sequence[int]) -> RoundInputs:
        r = _stage([host], sch, shapes, ts, noise_provider, mask_provider,
                   fading_provider, slot2_noise_provider, noisy=noisy)
        if block_batch_provider is not None:
            return r
        batch = (chunk_batch_provider(ts) if chunk_batch_provider is not None
                 else _stack_batches(batch_provider, ts))
        return r._replace(batch=batch)

    hist: Dict[str, List] = {"round": [], "eval_round": []}
    for k in DIAG_KEYS:
        hist[k] = []
    eval_keys: Optional[Tuple[str, ...]] = None

    def record(i, ts, rows, current_params, info):
        nonlocal eval_keys
        hist["round"].extend(ts)
        for k, col in zip(DIAG_KEYS, rows.t().tolist()):
            hist[k].extend(col)
        _emit_chunk(recorder, i, ts, rows, info)
        t = ts[-1]
        if eval_fn is not None and (t % eval_every == 0 or t == 1):
            metrics = eval_fn(current_params())
            eval_keys = _locked_eval_keys(metrics, eval_keys, t)
            for mk in eval_keys:
                hist.setdefault(mk, []).append(metrics[mk])
            hist["eval_round"].append(t)
            if recorder is not None:
                recorder.on_eval(t, {mk: float(metrics[mk])
                                     for mk in eval_keys})

    t0 = state.round
    if driver == "python":
        traces = dict(TRACE_COUNTS)
        body = make_round_step(cfg, grad_fn, block_batch_provider)
        for i, t in enumerate(range(t0 + 1, t0 + num_rounds + 1)):
            with profiling.annotate_chunk(i):
                start = time.perf_counter()
                staged = _map_inputs(lambda v: v.to(device),
                                     staged_chunk([t]))
                lane, rows = _run_eager(body, lane, _lane(staged, 0))
                info = dict(wall_time_s=time.perf_counter() - start,
                            dispatches=1, retraces=trace_deltas(traces))
            traces = dict(TRACE_COUNTS)
            record(i, [t], rows, lambda: lane.params, info)
        new_state = _lane_state(lane)
    else:
        chunks = _plan_chunks(t0, num_rounds,
                              eval_every if eval_fn is not None else None,
                              chunk_size)

        def make_engine(staged):
            engine = _make_run_chunk(cfg, grad_fn, block_batch_provider,
                                     device, chunk_size, _batch_spec(staged))
            engine.start([lane])
            return engine

        new_state = _lane_state(lane)
        if chunks:
            engine = _drive_chunks(
                make_engine, chunks, staged_chunk,
                lambda i, ts, rows, eng, info: record(
                    i, ts, rows[0], lambda: eng.state()[0][0], info))
            new_state = engine.state()[0]

    state.params, state.opt_state, state.client_state = new_state
    _write_back(state, host)
    state.round += num_rounds
    return state, hist


def run_batched(cfgs: Sequence[FLConfig], states: Sequence[FLState],
                grad_fn: GradFn, batch_provider: Callable[[int], Any],
                num_rounds: int,
                eval_fn: Optional[Callable[[Tree], Dict[str, float]]] = None,
                eval_every: int = 10, *, chunk_size: int = 16,
                chunk_batch_provider: Optional[
                    Callable[[Sequence[int]], Any]] = None,
                recorder=None) -> Tuple[List[FLState], Dict[str, Any]]:
    """Run E experiments as lanes of one engine: the batched twin of
    ``run(driver='scan')``, on the device of the states' params.

    The configs must be structurally identical (equal
    ``structural_config``), differing only in the batchable fields
    (``BATCHED_FL_FIELDS`` / ``BATCHED_CHANNEL_FIELDS`` /
    ``clients.BATCHED_CLIENT_FIELDS``: each lane has its own client state,
    and its own ``mu``/``alpha`` in device memory).  The host stages
    every lane's chunk ([T, E, ...]: noise, eta_t, the folded gains) and
    copies it once (a time-varying channel's refresh and Problem-3 re-solve
    included, every lane with its own ``rho``, ``csi_error``, channel mean
    and geometry); on the card one CUDA graph holds one round of every
    lane, lane after lane, replayed once a round, and the [E, T, 8] history
    comes back once a chunk.  Each lane runs its own config's round body on
    its own state and launches every kernel at its own shape, so lane e is
    bitwise ``run(cfgs[e], states[e], ...)``.  All lanes share ``grad_fn``
    and the batch providers (one task), the round counter and the eval
    schedule.

    Returns ``(states, hist)``: every ``DIAG_KEYS`` entry of ``hist`` an
    ``np.ndarray`` [E, num_rounds], eval metrics [E, num_evals], and
    ``hist['round']`` / ``hist['eval_round']`` flat lists shared by the
    lanes.  ``states`` are updated in place as ``run`` updates its one.
    ``recorder`` gets ``run``'s events, each value an [E] list (one entry a
    lane)."""
    if len(cfgs) != len(states) or not cfgs:
        raise ValueError("need equal, nonzero numbers of configs and states")
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    cfg0 = cfgs[0]
    if cfg0.backend == "mesh":
        raise ValueError("the mesh backend reserves the device axis for the "
                         "FL devices; run mesh experiments sequentially")
    if cfg0.device_mesh is not None:
        raise ValueError(
            "device_mesh (the sharded streaming engine) owns the ranks for "
            "the FL-device axis -- a batched run cannot also spread its "
            "experiment axis over them; run device_mesh experiments "
            "sequentially (repro_torch.fl.sweep falls back automatically)")
    sig = structural_config(cfg0)
    for c in cfgs[1:]:
        if structural_config(c) != sig:
            raise ValueError(
                "configs in a batched run must be structurally identical "
                "(they may differ only in "
                f"{BATCHED_FL_FIELDS + BATCHED_CHANNEL_FIELDS}"
                f" and client {clients.BATCHED_CLIENT_FIELDS}); got "
                f"{structural_config(c)} vs {sig}")
    t0s = {s.round for s in states}
    if len(t0s) != 1:
        raise ValueError(f"states disagree on the round counter: {t0s}")
    t0 = t0s.pop()
    dims = {s.model_dim for s in states}
    if len(dims) != 1:
        raise ValueError(f"states disagree on model_dim: {dims} -- a batched "
                         "run shares one task")
    devices = {_params_device(s.params) for s in states}
    if len(devices) != 1:
        raise ValueError(f"states live on different devices: {devices}")
    device = devices.pop()
    sch = schemes.get(cfg0.scheme)
    for c, s in zip(cfgs, states):
        _init_missing_state(c, s, device)
    hosts, chans = zip(*(_lane_inputs(c, s, device)
                         for c, s in zip(cfgs, states)))
    over = _batch_axes(cfgs, device)
    lanes = [_make_lane(s, h, h_hat, over, e)
             for e, (s, (h, h_hat)) in enumerate(zip(states, chans))]
    noisy = _noisy(cfgs)
    params0 = states[0].params
    shapes = {k: params0[k].shape for k in sorted(params0)}

    def staged_chunk(ts: Sequence[int]) -> RoundInputs:
        # the host's own work first: a provider's copy to the card may wait
        # for the replays queued before it
        r = _stage(hosts, sch, shapes, ts, noisy=noisy)
        batch = (chunk_batch_provider(ts) if chunk_batch_provider is not None
                 else _stack_batches(batch_provider, ts))
        return r._replace(batch=batch)

    def make_engine(staged):
        engine = _make_run_chunk_batched(sig, grad_fn, device, chunk_size,
                                         _batch_spec(staged), len(cfgs),
                                         noisy)
        engine.start(lanes)
        return engine

    hist: Dict[str, Any] = {"round": [], "eval_round": []}
    diag_chunks: List[np.ndarray] = []
    eval_cols: Dict[str, List[List[float]]] = {}
    eval_keys: Optional[Tuple[str, ...]] = None

    def record(i, ts, rows, engine, info):
        nonlocal eval_keys
        hist["round"].extend(ts)
        diag_chunks.append(rows.double().numpy())
        # [E, T, 8]: each round event carries one value a lane
        _emit_chunk(recorder, i, ts, rows, info)
        t = ts[-1]
        if eval_fn is not None and (t % eval_every == 0 or t == 1):
            per_lane: Dict[str, List[float]] = {}
            for e, (params, *_) in enumerate(engine.state()):
                metrics = eval_fn(params)
                eval_keys = _locked_eval_keys(metrics, eval_keys, t,
                                              where=f" (experiment {e})")
                for mk in eval_keys:
                    per_lane.setdefault(mk, []).append(metrics[mk])
            for mk in eval_keys:
                eval_cols.setdefault(mk, []).append(per_lane[mk])
            hist["eval_round"].append(t)
            if recorder is not None:
                recorder.on_eval(t, {mk: [float(v) for v in per_lane[mk]]
                                     for mk in eval_keys})

    chunks = _plan_chunks(t0, num_rounds,
                          eval_every if eval_fn is not None else None,
                          chunk_size)
    if chunks:
        engine = _drive_chunks(make_engine, chunks, staged_chunk, record)
        for s, new_state in zip(states, engine.state()):
            s.params, s.opt_state, s.client_state = new_state
        rows = np.concatenate(diag_chunks, axis=1)          # [E, T, 8]
    else:
        rows = np.zeros((len(cfgs), 0, len(DIAG_KEYS)))
    for i, k in enumerate(DIAG_KEYS):
        hist[k] = rows[:, :, i].copy()
    for mk, cols in eval_cols.items():
        hist[mk] = np.asarray(cols, np.float64).T            # [E, evals]
    for s, host in zip(states, hosts):
        _write_back(s, host)
        s.round += num_rounds
    return list(states), hist
