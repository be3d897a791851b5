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
  batch stack (the 100,000-device path).

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

Config values of unported paths raise ``NotImplementedError`` naming their
ROADMAP item: ``device_mesh``, ``local_steps > 1``, the ``mesh`` backend,
the two-slot client round, and (through ``ChannelConfig``/``ClientConfig``)
block fading, non-Rayleigh models, imperfect CSI, geometry and non-sgd
clients.

Random streams: the channel draw uses ``rng.generator(cfg.seed)``, round t's
channel noise ``rng.generator(cfg.seed + 1, t)`` and its participation mask
``rng.generator(cfg.seed + 1, rng.MASK_SALT, t)``, all on the CPU, so a CPU
and a GPU run from one seed see the same channel, masks and noise, and
``run(5); run(5)`` continues ``run(10)``.  ``run(noise_provider=...)`` and
``run(mask_provider=...)`` inject the flat noise vector and the [K] mask
instead (the parity tests' seams).  The participation fold runs on the
CPU copies of the channel.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)
import numpy as np
import torch

from repro_torch._config import config
from repro_torch import rng
from repro_torch.core import amplification as amp
from repro_torch.core import channel as chan
from repro_torch.core import ota
from repro_torch.core import schemes
from repro_torch.fl.clients import ClientConfig
from repro_torch.kernels import ops
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
# holding a captured CUDA graph (and its memory pool) on the card
ENGINE_CACHE_SIZE = 64
# Counted where a builder makes its engine: ``round_step`` for the python
# driver's round body, ``run_chunk`` for each CUDA-graph capture of the scan
# driver (on the CPU: each body it builds).  ``run_chunk_batched`` (sweeps,
# ROADMAP queue 1 item 13) and ``fading_refresh`` (block fading, item 11)
# stay 0 until those items land.
TRACE_KINDS = ("round_step", "run_chunk", "run_chunk_batched",
               "fading_refresh")
TRACE_COUNTS: collections.Counter = collections.Counter()
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
    (reset by ``clear_compile_caches``).  A second identical ``run`` adds
    no capture: its ``traces_delta`` is all 0."""
    delta = trace_deltas(_TRACE_SNAPSHOT)
    _TRACE_SNAPSHOT.update({k: int(TRACE_COUNTS[k]) for k in TRACE_KINDS})
    return {
        "cache_size": ENGINE_CACHE_SIZE,
        "builders": {name: fn.cache_info()._asdict()
                     for name, fn in _CACHED_BUILDERS.items()},
        "traces": dict(TRACE_COUNTS),
        "traces_delta": delta,
    }


def clear_compile_caches() -> None:
    """Drop every cached engine (its CUDA graph and the graph's memory pool
    with it) and reset the counters."""
    for fn in _CACHED_BUILDERS.values():
        fn.cache_clear()
    TRACE_COUNTS.clear()
    _TRACE_SNAPSHOT.clear()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


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
    local_steps: int = 1                 # > 1 not ported
    local_lr: float = 0.01
    participation: float = 1.0
    participation_mode: str = "bernoulli"
    # --- K-scale axes -------------------------------------------------------
    k_block: Optional[int] = None        # the streaming round
    active_gather: bool = False          # fixed-mode active-set gather
    device_mesh: Optional[int] = None    # not ported
    # --- client-algorithm axis (only 'sgd' is ported) -----------------------
    client: ClientConfig = None

    def __post_init__(self):
        if self.channel is None:
            object.__setattr__(self, "channel",
                               chan.ChannelConfig(num_devices=self.num_devices))
        if self.client is None:
            object.__setattr__(self, "client", ClientConfig())
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
        if self.device_mesh is not None and self.device_mesh < 1:
            raise ValueError(
                f"device_mesh must be >= 1, got {self.device_mesh}")
        unported = (
            (self.backend == "mesh",
             "the mesh backend", "queue 1 item 15"),
            (self.local_steps > 1,
             "local_steps > 1", "queue 1 item 7 (local-step round)"),
            (self.device_mesh is not None, "device_mesh", "queue 1 item 15"),
        )
        for hit, what, item in unported:
            if hit:
                raise NotImplementedError(
                    f"{what} is not ported yet: ROADMAP {item}")

    def stream_length(self) -> int:
        """Length of the streamed device axis: the fixed active-set size
        ``round(p K)`` under ``active_gather``, else the full cohort K."""
        if self.active_gather:
            return max(1, int(round(self.participation * self.num_devices)))
        return self.num_devices


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
    h_hat: Optional[np.ndarray] = None   # the server's estimate (== h here)


def server_optimizer(cfg: FLConfig) -> optim.Optimizer:
    """The server-side optimizer of ``cfg.server_opt`` (the rate is passed
    per call: the paper's eta_t lives in ``_eta_t``)."""
    if cfg.server_opt == "adamw":
        return optim.adamw(0.0, b1=cfg.server_b1, b2=cfg.server_b2,
                           eps=cfg.server_eps,
                           weight_decay=cfg.server_weight_decay)
    return optim.sgd(0.0, momentum=cfg.server_momentum)


def setup(cfg: FLConfig, params0: Tree, model_dim: int) -> FLState:
    """Draw the channel and run the paper's parameter optimization
    (Algorithm 1 and the receiver gain) on the host in float64."""
    h = chan.draw_channel(rng.generator(cfg.seed),
                          cfg.channel).double().numpy()
    h_hat = h
    b_max = np.full(cfg.num_devices, cfg.channel.b_max)
    extra = dict(model_dim=model_dim, h_hat=h_hat)

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
                    batch) -> Tree:
    """Every device's local gradient (``local_steps == 1``, the paper):
    ``grad_fn`` vmapped over the leading K axis of the batch.  The params
    are expanded along that axis (a view, no copy), so each matrix product
    runs as a batched product with one matrix per device: a device's
    gradient is then bitwise the same whichever devices share the call,
    which the active-set gather relies on (a plain product over the
    stacked rows splits its work, and its sums, by the row count)."""
    first = batch
    while not isinstance(first, torch.Tensor):
        first = next(iter(first.values() if isinstance(first, dict)
                          else first))
    k = first.shape[0]
    per_device = {n: p.expand((k,) + p.shape) for n, p in params.items()}
    return torch.func.vmap(grad_fn, in_dims=(0, 0))(per_device, batch)


class RoundInputs(NamedTuple):
    """What the host makes for one round, or, with a leading [T] axis on
    every tensor, for a chunk of T rounds (the staged buffers the round
    body reads at its cursor).  A field that the config does not use is
    None in every round."""
    t: torch.Tensor                          # int64, the round index
    eta: torch.Tensor                        # fp32 eta_t
    a_eff: torch.Tensor                      # fp32 receiver gain, folded
    b_eff: torch.Tensor                      # [K] fp32 amplification, folded
    participants: torch.Tensor               # fp32 num_participants
    noise: Optional[torch.Tensor] = None     # [N] fp32 flat channel noise
    mask: Optional[torch.Tensor] = None      # [K] fp32 0/1 participation
    empty: Optional[torch.Tensor] = None     # bool: nobody participates
    weights: Optional[torch.Tensor] = None   # [K] masked-baseline weights
    active: Optional[torch.Tensor] = None    # [m] int64 fixed-mode set
    batch: Any = None                        # per-device batch (None: lazy)


def _map_inputs(fn: Callable[[torch.Tensor], torch.Tensor],
                r: RoundInputs) -> RoundInputs:
    return RoundInputs(*(None if v is None else _map_batch(fn, v)
                         for v in r))


def _round_math(cfg: FLConfig, sch: schemes.Scheme, opt: optim.Optimizer,
                grad_fn: GradFn, ocfg: ota.OTAConfig, params: Tree, opt_state,
                r: RoundInputs, h: torch.Tensor,
                h_hat: Optional[torch.Tensor] = None):
    """One dense FL round (local gradients -> OTA aggregate -> server step)
    plus the ``DIAG_KEYS`` diagnostics, from the round's inputs ``r`` on
    the device.  ``h_hat=None`` is perfect CSI (the estimate IS ``h``, so
    ``csi_gain_err`` is a hard 0).  The round's participation mask is
    already folded into ``r.b_eff`` and ``r.a_eff``
    (``ota.participation_fold``).  Returns ``(params, opt_state, diag)``
    with diag values as 0-d tensors."""
    if h_hat is None:
        h_hat = h
    k = cfg.num_devices
    if cfg.active_gather:
        # gather the scheduled participants' batches BEFORE the local
        # computation, so gradient compute scales with m = round(p K), then
        # scatter the m gradients back into a zero [K, ...] stack and run the
        # unchanged dense aggregation: a masked device's terms are exact
        # zeros either way (b_eff = 0), so the round is bitwise the dense
        # masked round
        idx = r.active
        active = _local_transmit(cfg, grad_fn, params,
                                 _map_batch(lambda l: l[idx], r.batch))
        stacked = {name: l.new_zeros((k,) + l.shape[1:]).index_copy_(0, idx, l)
                   for name, l in active.items()}
        b_air = r.b_eff[idx]
    else:
        idx = None
        active = stacked = _local_transmit(cfg, grad_fn, params, r.batch)
        b_air = r.b_eff
    if r.mask is not None and sch.baseline:
        # the baseline bypasses the channel, so the mask cannot reach it
        # through b_eff: average over the participants only
        y = schemes.tree_map(
            lambda l: torch.tensordot(r.weights, l.float(), dims=([0], [0])),
            stacked)
    else:
        y = ota.aggregate(ocfg, stacked, h, r.b_eff, h_hat=h_hat,
                          noise=r.noise, a=r.a_eff)
    # one stats pass feeds both diagnostics (grad norms and the eq.-8
    # transmit energy); the aggregate above keeps its own internal stats.
    # Under active_gather the stats cover the participants only, and their
    # energies are scattered back to the [K] layout (masked devices spent 0)
    stats = schemes.compute_stats(active, sch, batched=True)
    norms = torch.sqrt(stats.sq_norm)
    tx = schemes.transmit_energy(sch, stats, b_air, cfg.grad_bound,
                                 None if idx is not None else r.mask)
    if idx is not None:
        tx = tx.new_zeros((k,)).index_copy_(0, idx, tx)
    diag_core = {
        "grad_norm_mean": torch.mean(norms),
        "grad_norm_min": torch.min(norms),
        "grad_norm_max": torch.max(norms),
        "tx_energy": torch.sum(tx),
    }
    return _round_tail(sch, opt, params, opt_state, y, r, diag_core, h,
                       h_hat)


def _round_math_streaming(cfg: FLConfig, sch: schemes.Scheme,
                          opt: optim.Optimizer, grad_fn: GradFn,
                          ocfg: ota.OTAConfig, params: Tree, opt_state,
                          r: RoundInputs, h: torch.Tensor,
                          h_hat: Optional[torch.Tensor] = None, *,
                          block_batch_fn: Optional[Callable] = None):
    """The flat-memory round (``cfg.k_block``): local gradients are
    computed and folded into the OTA accumulator ``k_block`` devices at a
    time through the carry API (``ota.streaming_carry/_block/_finish``), so
    the [K, ...] gradient stack never exists; the working set is
    O(k_block N) plus O(K) channel vectors.  On the kernels backend each
    block is one launch of the dense superposition kernel.

    ``r.batch`` is the dense per-device batch over all K devices (cut into
    blocks here, and gathered to the active set under ``active_gather``),
    or None: then ``block_batch_fn(r.t, dev_idx)`` makes one block's
    [k_block, ...] batch from the round index (a 0-d int64 tensor on the
    device) and its [k_block] device indices.  Arguments and result are
    ``_round_math``'s.  Versus the dense round every per-device term is the
    same; the K-way sums associate K-block by K-block, and the channel
    noise is the same draw."""
    if h_hat is None:
        h_hat = h
    device = h.device
    batch = r.batch
    if cfg.active_gather:
        idx = r.active
        if batch is not None:
            batch = _map_batch(lambda l: l[idx], batch)
        h_air, h_srv, b_air, dev = h[idx], h_hat[idx], r.b_eff[idx], idx
        block_mask = None
    else:
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
    oc = ota.streaming_carry(ocfg, template)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    nsum, txsum = zero, zero
    nmin = torch.full((), float("inf"), device=device)
    nmax = torch.full((), float("-inf"), device=device)
    for lo in range(0, s, kb):
        blk = slice(lo, lo + kb)
        bat = (_map_batch(lambda l: l[blk], batch) if batch is not None
               else block_batch_fn(r.t, dev[blk]))
        g_blk = _local_transmit(cfg, grad_fn, params, bat)
        stats = schemes.compute_stats(g_blk, sch, batched=True)
        norms = torch.sqrt(stats.sq_norm)
        tx = schemes.transmit_energy(
            sch, stats, b_air[blk], cfg.grad_bound,
            None if block_mask is None else block_mask[blk])
        oc = ota.streaming_block(ocfg, oc, g_blk, ha[blk], hs[blk],
                                 stats=stats,
                                 baseline_weights=w[blk] if weighted else None)
        txsum = txsum + torch.sum(tx)
        nsum = nsum + torch.sum(norms)
        nmin = torch.minimum(nmin, torch.min(norms))
        nmax = torch.maximum(nmax, torch.max(norms))
    y = ota.streaming_finish(ocfg, oc, template, r.a_eff, r.noise,
                             num_devices=1.0 if weighted else float(s))
    diag_core = {
        "grad_norm_mean": nsum / s,
        "grad_norm_min": nmin,
        "grad_norm_max": nmax,
        "tx_energy": txsum,
    }
    return _round_tail(sch, opt, params, opt_state, y, r, diag_core, h,
                       h_hat)


def _keep_if(empty: torch.Tensor, old, new):
    """``old`` where the round is empty, else ``new``: an exact selection,
    leaf by leaf, of params or an optimizer state."""
    if isinstance(new, torch.Tensor):
        return torch.where(empty, old, new)
    if isinstance(new, dict):
        return {k: _keep_if(empty, old[k], new[k]) for k in new}
    return _rebuild(new, (_keep_if(empty, o, n) for o, n in zip(old, new)))


def _round_tail(sch, opt, params, opt_state, y, r: RoundInputs, diag_core,
                h, h_hat):
    """Post-aggregation tail shared by the dense and streaming rounds:
    empty-round gating, the server-optimizer step and the ``DIAG_KEYS``
    assembly.  A round in which nobody participates (possible under
    ``bernoulli`` draws) applies no update: params and the optimizer state
    stay as they were, selected on the device by the round's flag."""
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
        designed = r.a_eff * torch.sum(h_hat * r.b_eff)
        gap = r.a_eff * torch.sum((h - h_hat) * r.b_eff)
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


class RoundBody:
    """The device work of one round of one (config, grad_fn,
    block_batch_fn): ``body(params, opt_state, h, staged, cursor, hist)``
    reads the round's inputs at row ``cursor`` of the staged chunk, runs the
    dense or the streaming round, writes its ``DIAG_KEYS`` to the same row
    of ``hist`` [T, 8] and advances ``cursor`` (a [1] int64 tensor).  It
    makes no host sync and reads no CPU tensor, so a CUDA graph can capture
    it.  Returns the new ``(params, opt_state)``."""

    def __init__(self, cfg: FLConfig, grad_fn: GradFn,
                 block_batch_fn: Optional[Callable] = None):
        self.cfg, self.grad_fn, self.block_batch_fn = cfg, grad_fn, \
            block_batch_fn
        self.sch = schemes.get(cfg.scheme)
        self.opt = server_optimizer(cfg)
        kb = (None if cfg.k_block is None
              else min(cfg.k_block, cfg.stream_length()))
        self.ocfg = ota.OTAConfig(scheme=cfg.scheme,
                                  noise_var=cfg.channel.noise_var,
                                  grad_bound=cfg.grad_bound,
                                  backend=cfg.backend, k_block=kb)

    def __call__(self, params: Tree, opt_state, h: torch.Tensor,
                 staged: RoundInputs, cursor: torch.Tensor,
                 hist: torch.Tensor):
        r = _map_inputs(lambda v: v.index_select(0, cursor)[0], staged)
        args = (self.cfg, self.sch, self.opt, self.grad_fn, self.ocfg,
                params, opt_state, r, h)
        if self.cfg.k_block is not None:
            params, opt_state, diag = _round_math_streaming(
                *args, block_batch_fn=self.block_batch_fn)
        else:
            params, opt_state, diag = _round_math(*args)
        row = torch.stack([diag[k].float() for k in DIAG_KEYS])
        hist.index_copy_(0, cursor, row[None])
        cursor.add_(1)
        return params, opt_state


def _stage(cfg: FLConfig, sch: schemes.Scheme, h_hat: torch.Tensor,
           b: torch.Tensor, a: float, eta0: float,
           shapes: Dict[str, torch.Size], ts: Sequence[int],
           noise_provider: Optional[Callable] = None,
           mask_provider: Optional[Callable] = None) -> RoundInputs:
    """The host work of the rounds ``ts``: each round's inputs drawn on the
    CPU generators (or taken from the providers) exactly as a round of its
    own would draw them, stacked into [T, ...] CPU tensors (``batch``
    left None).  ``h_hat`` and ``b`` are the CPU fp32 channel of the
    participation fold; ``shapes`` the single-device leaf shapes."""
    ocfg = ota.OTAConfig(scheme=cfg.scheme, noise_var=cfg.channel.noise_var,
                         grad_bound=cfg.grad_bound)
    k = cfg.num_devices
    fields = collections.defaultdict(list)
    for t in ts:
        fields["t"].append(torch.tensor(t, dtype=torch.int64))
        fields["eta"].append(torch.tensor(_eta_t(cfg, eta0, t),
                                          dtype=torch.float32))
        if not sch.baseline:
            if noise_provider is not None:
                noise = ota.resolve_noise(ocfg, shapes, "cpu",
                                          noise=noise_provider(t))
            else:
                noise = ota.resolve_noise(ocfg, shapes, "cpu",
                                          rng.generator(cfg.seed + 1, t))
            if noise is not None:
                fields["noise"].append(noise)
        if cfg.participation >= 1.0:
            fields["a_eff"].append(torch.tensor(a, dtype=torch.float32))
            fields["b_eff"].append(b)
            fields["participants"].append(torch.tensor(float(k)))
            continue
        mask = (mask_provider(t) if mask_provider is not None
                else _participation_mask(cfg, t))
        mask = mask.to(device="cpu", dtype=torch.float32)
        if mask.shape != (k,):
            raise ValueError(f"round {t}'s mask has shape "
                             f"{tuple(mask.shape)}, expected ({k},)")
        b_eff, a_eff = ota.participation_fold(h_hat, b, a, mask)
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
    return RoundInputs(**{name: torch.stack(v) for name, v in fields.items()})


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
    """Copy params or an optimizer state (a tensor, dict or tuple of them)
    into buffers of the same structure."""
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
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return _rebuild(tree, (_clone(v) for v in tree))


def _run_eager(body: RoundBody, params, opt_state, h, staged: RoundInputs):
    """The body over every round of a staged chunk, launched from the host
    round by round; returns the new state and the [T, 8] history (one
    device-to-host copy)."""
    rounds = staged.t.shape[0]
    cursor = torch.zeros((1,), dtype=torch.int64, device=h.device)
    hist = torch.empty((rounds, len(DIAG_KEYS)), dtype=torch.float32,
                       device=h.device)
    for _ in range(rounds):
        params, opt_state = body(params, opt_state, h, staged, cursor, hist)
    return params, opt_state, hist.cpu()


class _EagerChunks:
    """The scan driver's engine on the CPU: the round body run eagerly,
    chunk by chunk."""

    def __init__(self, body: RoundBody):
        self.body = body
        self.params = self.opt_state = self.h = self.hist = None
        _count_trace("run_chunk")

    def start(self, params: Tree, opt_state, h: torch.Tensor) -> None:
        self.params, self.opt_state, self.h = params, opt_state, h

    def launch(self, staged: RoundInputs) -> None:
        staged = _map_inputs(lambda v: v.to(self.h.device), staged)
        self.params, self.opt_state, self.hist = _run_eager(
            self.body, self.params, self.opt_state, self.h, staged)

    def rows(self) -> torch.Tensor:
        return self.hist

    def state(self):
        return self.params, self.opt_state


# device index -> the stream every graph of the scan driver is captured on
# (the eager warm-up runs there first, so that its cuBLAS workspace and
# K1's and K5's arrival counters exist before the capture; graphs captured
# on one stream share those counters, and are replayed one at a time)
_CAPTURE_STREAMS: Dict[int, torch.cuda.Stream] = {}
GRAPH_WARMUP_ROUNDS = 2


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    if device.index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device.index] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device.index]


class _GraphChunks:
    """The scan driver's engine on a CUDA device: one round captured in a
    CUDA graph over fixed buffers (the params, the optimizer state, the
    channel, the [chunk_size, ...] staged inputs, the cursor and the
    [chunk_size, 8] history), and replayed once per round of a chunk.  The
    graph's private memory pool lives as long as the engine."""

    def __init__(self, body: RoundBody, device: torch.device,
                 chunk_size: int):
        self.body, self.device, self.chunk_size = body, device, chunk_size
        self.graph = None
        self.rounds = 0
        self.per_replay: Dict[str, int] = {}
        self.static = self.staged = self.pending = None
        self.cursor = torch.zeros((1,), dtype=torch.int64, device=device)
        self.hist = torch.zeros((chunk_size, len(DIAG_KEYS)),
                                dtype=torch.float32, device=device)

    def start(self, params: Tree, opt_state, h: torch.Tensor) -> None:
        self.pending = (params, opt_state, h)

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
        params, opt_state, h = self.static
        new = self.body(params, opt_state, h, self.staged, self.cursor,
                        self.hist)
        _copy_into((params, opt_state), new)

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
        """Warm up, then capture one round.  A capture that fails raises:
        the run never falls back to eager rounds on the card."""
        stream = self._warm_up()
        graph = torch.cuda.CUDAGraph()
        with ops.capture_counts() as self.per_replay:
            with torch.cuda.graph(graph, stream=stream):
                self._step()
        self.graph = graph
        _count_trace("run_chunk")

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
        """The last chunk's [T, 8] history: one device-to-host copy."""
        return self.hist[:self.rounds].cpu()

    def state(self):
        params, opt_state, _ = self.static
        return _clone(params), _clone(opt_state)


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
    the CPU the same body run eagerly."""
    body = RoundBody(cfg, grad_fn, block_batch_fn)
    if device.type == "cuda":
        return _GraphChunks(body, device, chunk_size)
    return _EagerChunks(body)


# name -> lru-cached builder, for cache_info()/clear_compile_caches()
_CACHED_BUILDERS = {"round_step": make_round_step,
                    "run_chunk": _make_run_chunk}


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
                      t) -> Tuple[str, ...]:
    """The metric key set is locked on the first eval, so per-round metric
    lists stay aligned with ``hist['eval_round']``."""
    if eval_keys is None:
        return tuple(metrics)
    if set(metrics) != set(eval_keys):
        raise ValueError(
            f"eval_fn returned metric keys {sorted(metrics)} at round {t}, "
            f"but the history locked {sorted(eval_keys)} on the first eval "
            "-- per-round metric lists must stay aligned with "
            "hist['eval_round']")
    return eval_keys


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
        ) -> Tuple[FLState, Dict[str, List]]:
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
    ``rng.generator(cfg.seed + 1, t)``; ``mask_provider(t)`` returns round
    t's [K] 0/1 participation mask (``participation`` < 1) instead of
    ``_participation_mask``'s draw.

    ``block_batch_provider(t, dev_idx)`` is the streaming round's lazy-batch
    hook (requires ``cfg.k_block``): it returns one K-block's [k_block, ...]
    batch on the params' device from the round index ``t`` and the block's
    [k_block] device indices, so no [K, ...] batch stack ever exists;
    ``batch_provider`` may then be None.  ``t`` is a 0-d int64 tensor on the
    device (the reference passes a traced int): the hook runs inside the
    round body, which a CUDA graph replays, so it must compute on the
    device and never read ``t`` on the host.

    The params, server optimizer state and round counter persist in
    ``state``, so a second ``run`` resumes where the first stopped."""
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
    sch = schemes.get(cfg.scheme)
    params = state.params
    device = params[sorted(params)[0]].device
    if state.opt_state is None:
        # step = rounds already taken, so Adam bias correction matches an
        # unbroken run
        init = server_optimizer(cfg).init(params)
        state.opt_state = init._replace(
            step=torch.tensor(state.round, dtype=torch.int32, device=device))
    # fp32 channel vectors on the CPU (the participation fold) and on the
    # device; the reference holds a and eta0 as fp32 scalars
    h_cpu = torch.as_tensor(state.h, dtype=torch.float32)
    h_hat_cpu = (h_cpu if state.h_hat is None
                 else torch.as_tensor(state.h_hat, dtype=torch.float32))
    b_cpu = torch.as_tensor(state.b, dtype=torch.float32)
    h = h_cpu.to(device)
    a = float(np.float32(state.a))
    eta0 = float(np.float32(state.eta0))
    shapes = {k: params[k].shape for k in sorted(params)}

    def staged_chunk(ts: Sequence[int]) -> RoundInputs:
        r = _stage(cfg, sch, h_hat_cpu, b_cpu, a, eta0, shapes, ts,
                   noise_provider, mask_provider)
        if block_batch_provider is not None:
            return r
        batch = (chunk_batch_provider(ts) if chunk_batch_provider is not None
                 else _stack_batches(batch_provider, ts))
        return r._replace(batch=batch)

    hist: Dict[str, List] = {"round": [], "eval_round": []}
    for k in DIAG_KEYS:
        hist[k] = []
    eval_keys: Optional[Tuple[str, ...]] = None

    def record(ts, rows, current_params):
        nonlocal eval_keys
        hist["round"].extend(ts)
        for k, col in zip(DIAG_KEYS, rows.t().tolist()):
            hist[k].extend(col)
        t = ts[-1]
        if eval_fn is not None and (t % eval_every == 0 or t == 1):
            metrics = eval_fn(current_params())
            eval_keys = _locked_eval_keys(metrics, eval_keys, t)
            for mk in eval_keys:
                hist.setdefault(mk, []).append(metrics[mk])
            hist["eval_round"].append(t)

    t0 = state.round
    if driver == "python":
        body = make_round_step(cfg, grad_fn, block_batch_provider)
        opt_state = state.opt_state
        for t in range(t0 + 1, t0 + num_rounds + 1):
            staged = _map_inputs(lambda v: v.to(device), staged_chunk([t]))
            params, opt_state, rows = _run_eager(body, params, opt_state, h,
                                                 staged)
            record([t], rows, lambda: params)
    else:
        engine = None
        chunks = _plan_chunks(t0, num_rounds,
                              eval_every if eval_fn is not None else None,
                              chunk_size)
        staged = staged_chunk(chunks[0]) if chunks else None
        for i, ts in enumerate(chunks):
            if engine is None:
                spec = tuple((tuple(l.shape[1:]), l.dtype) for l in
                             _batch_leaves(() if staged.batch is None
                                           else staged.batch))
                engine = _make_run_chunk(cfg, grad_fn, block_batch_provider,
                                         device, chunk_size, spec)
                engine.start(params, state.opt_state, h)
            engine.launch(staged)
            if i + 1 < len(chunks):
                # the next chunk's host work, while the card runs this one
                staged = staged_chunk(chunks[i + 1])
            record(ts, engine.rows(), lambda: engine.state()[0])
        if engine is not None:
            params, opt_state = engine.state()
        else:
            opt_state = state.opt_state

    state.params = params
    state.opt_state = opt_state
    state.round += num_rounds
    return state, hist
