"""Federated-learning runtime (port of ``repro/fed/runtime.py``; paper
Sec. II, Steps 1-3, iterated).

One round: every device computes its local gradient (``torch.func.vmap`` of
``torch.func.grad`` over the stacked [K, B] index batches, the gather inside),
the gradients superpose over the air (``core.ota.aggregate`` on the
``vmap`` or ``kernels`` backend), and the server steps ``w <- w - eta_t y``
(eq. 11) through a pluggable optimizer, recording ``DIAG_KEYS``.

Two rounds, driven by the ``python`` host loop:

* the dense round (``_round_math``), with partial participation
  (``participation`` < 1, ``bernoulli`` or ``fixed``) and the fixed-mode
  active-set gather (``active_gather``: only the m scheduled devices compute
  gradients; the round is bitwise the dense masked round);
* the streaming round (``k_block``, ``_round_math_streaming``): gradients
  are computed and folded into the OTA accumulator ``k_block`` devices at a
  time through ``core.ota``'s carry API, so the [K, ...] gradient stack
  never exists; with ``run(block_batch_provider=)`` neither does a [K, ...]
  batch stack (the 100,000-device path).

Config values of unported paths raise ``NotImplementedError`` naming their
ROADMAP item: ``driver='scan'``, ``device_mesh``, ``local_steps > 1``, the
``mesh`` backend, the two-slot client round, and (through
``ChannelConfig``/``ClientConfig``) block fading, non-Rayleigh models,
imperfect CSI, geometry and non-sgd clients.

Random streams: the channel draw uses ``rng.generator(cfg.seed)``, round t's
channel noise ``rng.generator(cfg.seed + 1, t)`` and its participation mask
``rng.generator(cfg.seed + 1, rng.MASK_SALT, t)``, all on the CPU, so a CPU
and a GPU run from one seed see the same channel, masks and noise, and
``run(5); run(5)`` continues ``run(10)``.  ``run(noise_provider=...)`` and
``run(mask_provider=...)`` inject the flat noise vector and the [K] mask
instead (the parity tests' seams).  The participation fold runs on the
CPU copies of the channel, so a masked round needs no device sync for it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

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


def _round_math(cfg: FLConfig, sch: schemes.Scheme, opt: optim.Optimizer,
                grad_fn: GradFn, params: Tree, opt_state, batch,
                h: torch.Tensor, h_hat: Optional[torch.Tensor],
                b_eff: torch.Tensor, a_eff: float, eta0: float, t: int, *,
                mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
    """One dense FL round (local gradients -> OTA aggregate -> server step)
    plus the ``DIAG_KEYS`` diagnostics.  ``h_hat=None`` is perfect CSI (the
    estimate IS ``h``, so ``csi_gain_err`` is a hard 0).  ``mask`` is the
    round's [K] 0/1 participation draw on the CPU (None: everyone), already
    folded into ``b_eff`` and ``a_eff`` (``ota.participation_fold``).
    Returns ``(params, opt_state, diag)`` with diag values as 0-d tensors
    or floats."""
    if h_hat is None:
        h_hat = h
    k = cfg.num_devices
    mask_d = None if mask is None else mask.to(h.device)
    if cfg.active_gather:
        # gather the scheduled participants' batches BEFORE the local
        # computation, so gradient compute scales with m = round(p K), then
        # scatter the m gradients back into a zero [K, ...] stack and run the
        # unchanged dense aggregation: a masked device's terms are exact
        # zeros either way (b_eff = 0), so the round is bitwise the dense
        # masked round
        idx = _active_indices(cfg, mask).to(h.device)
        active = _local_transmit(cfg, grad_fn, params,
                                 _map_batch(lambda l: l[idx], batch))
        stacked = {name: l.new_zeros((k,) + l.shape[1:]).index_copy_(0, idx, l)
                   for name, l in active.items()}
        b_air = b_eff[idx]
    else:
        idx = None
        active = stacked = _local_transmit(cfg, grad_fn, params, batch)
        b_air = b_eff
    if mask is not None and sch.baseline:
        # the baseline bypasses the channel, so the mask cannot reach it
        # through b_eff: average over the participants only
        w = mask_d / max(float(mask.sum()), 1.0)
        y = schemes.tree_map(
            lambda l: torch.tensordot(w, l.float(), dims=([0], [0])), stacked)
    else:
        ocfg = ota.OTAConfig(scheme=cfg.scheme, a=a_eff,
                             noise_var=cfg.channel.noise_var,
                             grad_bound=cfg.grad_bound, backend=cfg.backend)
        y = ota.aggregate(ocfg, stacked, h, b_eff, generator, h_hat=h_hat,
                          noise=noise)
    # one stats pass feeds both diagnostics (grad norms and the eq.-8
    # transmit energy); the aggregate above keeps its own internal stats.
    # Under active_gather the stats cover the participants only, and their
    # energies are scattered back to the [K] layout (masked devices spent 0)
    stats = schemes.compute_stats(active, sch, batched=True)
    norms = torch.sqrt(stats.sq_norm)
    tx = schemes.transmit_energy(sch, stats, b_air, cfg.grad_bound,
                                 None if idx is not None else mask_d)
    if idx is not None:
        tx = tx.new_zeros((k,)).index_copy_(0, idx, tx)
    diag_core = {
        "grad_norm_mean": torch.mean(norms),
        "grad_norm_min": torch.min(norms),
        "grad_norm_max": torch.max(norms),
        "tx_energy": torch.sum(tx),
    }
    return _round_tail(cfg, sch, opt, params, opt_state, y, mask, eta0, t,
                       diag_core, a_eff, h, h_hat, b_eff)


def _round_math_streaming(cfg: FLConfig, sch: schemes.Scheme,
                          opt: optim.Optimizer, grad_fn: GradFn,
                          params: Tree, opt_state, batch, h: torch.Tensor,
                          h_hat: Optional[torch.Tensor], b_eff: torch.Tensor,
                          a_eff: float, eta0: float, t: int, *,
                          mask: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None,
                          noise: Optional[torch.Tensor] = None,
                          block_batch_fn: Optional[Callable] = None):
    """The flat-memory round (``cfg.k_block``): local gradients are
    computed and folded into the OTA accumulator ``k_block`` devices at a
    time through the carry API (``ota.streaming_carry/_block/_finish``), so
    the [K, ...] gradient stack never exists; the working set is
    O(k_block N) plus O(K) channel vectors.  On the kernels backend each
    block is one launch of the dense superposition kernel.

    ``batch`` is the dense per-device batch over all K devices (cut into
    blocks here, and gathered to the active set under ``active_gather``),
    or None: then ``block_batch_fn(t, dev_idx)`` makes one block's
    [k_block, ...] batch from its [k_block] device indices.  Arguments and
    result are ``_round_math``'s.  Versus the dense round every per-device
    term is the same; the K-way sums associate K-block by K-block, and the
    channel noise is the same draw."""
    if h_hat is None:
        h_hat = h
    device = h.device
    mask_d = None if mask is None else mask.to(device)
    if cfg.active_gather:
        idx = _active_indices(cfg, mask).to(device)
        if batch is not None:
            batch = _map_batch(lambda l: l[idx], batch)
        h_air, h_srv, b_air, dev = h[idx], h_hat[idx], b_eff[idx], idx
        block_mask = None
    else:
        h_air, h_srv, b_air = h, h_hat, b_eff
        dev = torch.arange(cfg.num_devices, device=device)
        block_mask = mask_d
    if batch is None and block_batch_fn is None:
        raise ValueError("streaming round got batch=None and no "
                         "block_batch_fn -- pass run(..., "
                         "block_batch_provider=...) for the lazy-batch path")
    s = cfg.stream_length()
    kb = min(cfg.k_block, s)
    ha = (h_air * b_air).float()
    hs = (h_srv * b_air).float()
    weighted = mask is not None and sch.baseline
    if weighted:
        # masked baseline: the participant mean, accumulated as the same
        # hb-free weighted sum the dense round takes
        w = mask_d / max(float(mask.sum()), 1.0)
        w = w if not cfg.active_gather else w[idx]
    ocfg = ota.OTAConfig(scheme=cfg.scheme, a=a_eff,
                         noise_var=cfg.channel.noise_var,
                         grad_bound=cfg.grad_bound, backend=cfg.backend,
                         k_block=kb)
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
               else block_batch_fn(t, dev[blk]))
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
    z = None if sch.baseline else ota.resolve_noise(
        ocfg, {k: v.shape for k, v in template.items()}, device, generator,
        noise)
    y = ota.streaming_finish(ocfg, oc, template, a_eff, z,
                             num_devices=1.0 if weighted else float(s))
    diag_core = {
        "grad_norm_mean": nsum / s,
        "grad_norm_min": nmin,
        "grad_norm_max": nmax,
        "tx_energy": txsum,
    }
    return _round_tail(cfg, sch, opt, params, opt_state, y, mask, eta0, t,
                       diag_core, a_eff, h, h_hat, b_eff)


def _round_tail(cfg, sch, opt, params, opt_state, y, mask, eta0, t,
                diag_core, a_eff, h, h_hat, b_eff):
    """Post-aggregation tail shared by the dense and streaming rounds:
    empty-round gating, the server-optimizer step and the ``DIAG_KEYS``
    assembly.  A round in which nobody participates (possible under
    ``bernoulli`` draws) applies no update: params and the optimizer state
    stay as they were.  The mask lies on the CPU, so the gate costs no
    device sync."""
    eta = _eta_t(cfg, eta0, t)
    if mask is not None and float(mask.sum()) == 0.0:
        y = schemes.tree_map(lambda l: l * 0.0, y)
        new_params, new_opt_state = params, opt_state
    else:
        new_params, new_opt_state = opt.update(y, opt_state, params, lr=eta)
    if sch.baseline:
        # the ideal reference bypasses the channel; no gain to misalign
        csi_gain_err = torch.zeros((), dtype=torch.float32, device=h.device)
    else:
        # relative effective-gain misalignment, through the DIFFERENCE
        # (h - h_hat) so equal estimates give a hard 0
        designed = a_eff * torch.sum(h_hat * b_eff)
        gap = a_eff * torch.sum((h - h_hat) * b_eff)
        csi_gain_err = (gap / torch.clamp(torch.abs(designed),
                                          min=schemes.EPS)).float()
    diag = {
        **diag_core,
        "eta": eta,
        # the single-vector norm kernel on the card (K5)
        "update_norm": ops.grad_norm(ota.ravel(y)),
        "num_participants": (float(mask.sum()) if mask is not None
                             else float(cfg.num_devices)),
        "csi_gain_err": csi_gain_err,
    }
    return new_params, new_opt_state, diag


def _diag_floats(diag: Dict[str, Any]) -> Dict[str, float]:
    """Host floats of a round's diagnostics, with one device-to-host copy."""
    tensor_keys = [k for k in DIAG_KEYS if isinstance(diag[k], torch.Tensor)]
    out = {k: float(diag[k]) for k in DIAG_KEYS if k not in tensor_keys}
    if tensor_keys:
        vals = torch.stack([diag[k].float() for k in tensor_keys]).tolist()
        out.update(zip(tensor_keys, vals))
    return out


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
        eval_every: int = 10, *, driver: str = "python",
        noise_provider: Optional[Callable[[int], torch.Tensor]] = None,
        mask_provider: Optional[Callable[[int], torch.Tensor]] = None,
        block_batch_provider: Optional[Callable[[int, torch.Tensor], Any]]
        = None,
        ) -> Tuple[FLState, Dict[str, List]]:
    """Run ``num_rounds`` FL rounds on the host-loop driver.

    ``batch_provider(t)`` returns the per-device batch (leading K axis) for
    round t on the params' device.  ``eval_fn`` runs at t == 1 and every
    ``eval_every``-th round.  ``noise_provider(t)``, when given, returns
    round t's flat channel noise z [N] (sorted-key leaf order) instead of
    the draw from ``rng.generator(cfg.seed + 1, t)``; ``mask_provider(t)``
    returns round t's [K] 0/1 participation mask (``participation`` < 1)
    instead of ``_participation_mask``'s draw.

    ``block_batch_provider(t, dev_idx)`` is the streaming round's lazy-batch
    hook (requires ``cfg.k_block``): it returns one K-block's [k_block, ...]
    batch on the params' device from its [k_block] device indices, so no
    [K, ...] batch stack ever exists; ``batch_provider`` may then be None.

    The params, server optimizer state and round counter persist in
    ``state``, so a second ``run`` resumes where the first stopped."""
    if driver not in DRIVERS:
        raise ValueError(f"unknown driver {driver!r}; one of {DRIVERS}")
    if driver == "scan":
        raise NotImplementedError(
            "the compiled (scan) driver is not ported yet: ROADMAP queue 1 "
            "item 8; use driver='python'")
    if block_batch_provider is not None and cfg.k_block is None:
        raise ValueError("block_batch_provider streams per-K-block batches "
                         "inside the round; set cfg.k_block")
    if mask_provider is not None and cfg.participation >= 1.0:
        raise ValueError("mask_provider replaces the participation draw; "
                         "set cfg.participation < 1")
    sch = schemes.get(cfg.scheme)
    opt = server_optimizer(cfg)
    params = state.params
    device = params[sorted(params)[0]].device
    if state.opt_state is None:
        # step = rounds already taken, so Adam bias correction matches an
        # unbroken run
        init = opt.init(params)
        state.opt_state = init._replace(
            step=torch.tensor(state.round, dtype=torch.int32, device=device))
    opt_state = state.opt_state
    # fp32 channel vectors on the CPU (the participation fold) and on the
    # device; the reference holds a and eta0 as fp32 scalars
    h_cpu = torch.as_tensor(state.h, dtype=torch.float32)
    h_hat_cpu = (h_cpu if state.h_hat is None
                 else torch.as_tensor(state.h_hat, dtype=torch.float32))
    b_cpu = torch.as_tensor(state.b, dtype=torch.float32)
    h, b = h_cpu.to(device), b_cpu.to(device)
    a = float(np.float32(state.a))
    eta0 = float(np.float32(state.eta0))

    hist: Dict[str, List] = {"round": [], "eval_round": []}
    for k in DIAG_KEYS:
        hist[k] = []
    eval_keys: Optional[Tuple[str, ...]] = None

    for t in range(state.round + 1, state.round + num_rounds + 1):
        if noise_provider is not None:
            gen, noise = None, noise_provider(t)
        else:
            gen, noise = rng.generator(cfg.seed + 1, t), None
        mask, b_eff, a_eff = None, b, a
        if cfg.participation < 1.0:
            mask = (mask_provider(t) if mask_provider is not None
                    else _participation_mask(cfg, t))
            mask = mask.to(device="cpu", dtype=torch.float32)
            if mask.shape != (cfg.num_devices,):
                raise ValueError(f"round {t}'s mask has shape "
                                 f"{tuple(mask.shape)}, expected "
                                 f"({cfg.num_devices},)")
            b_eff_cpu, a_eff_t = ota.participation_fold(h_hat_cpu, b_cpu, a,
                                                        mask)
            b_eff, a_eff = b_eff_cpu.to(device), float(a_eff_t)
        kw = dict(mask=mask, generator=gen, noise=noise)
        if cfg.k_block is not None:
            params, opt_state, diag = _round_math_streaming(
                cfg, sch, opt, grad_fn, params, opt_state,
                None if block_batch_provider is not None
                else batch_provider(t),
                h, None, b_eff, a_eff, eta0, t,
                block_batch_fn=block_batch_provider, **kw)
        else:
            params, opt_state, diag = _round_math(
                cfg, sch, opt, grad_fn, params, opt_state, batch_provider(t),
                h, None, b_eff, a_eff, eta0, t, **kw)
        hist["round"].append(t)
        for k, v in _diag_floats(diag).items():
            hist[k].append(v)
        if eval_fn is not None and (t % eval_every == 0 or t == 1):
            metrics = eval_fn(params)
            eval_keys = _locked_eval_keys(metrics, eval_keys, t)
            for mk in eval_keys:
                hist.setdefault(mk, []).append(metrics[mk])
            hist["eval_round"].append(t)

    state.params = params
    state.opt_state = opt_state
    state.round += num_rounds
    return state, hist
