"""Federated-learning runtime (port of ``repro/fed/runtime.py``; paper
Sec. II, Steps 1-3, iterated).

One round: every device computes its local gradient (``torch.func.vmap`` of
``torch.func.grad`` over the stacked [K, B] index batches, the gather inside),
the gradients superpose over the air (``core.ota.aggregate`` on the
``vmap`` or ``kernels`` backend), and the server steps ``w <- w - eta_t y``
(eq. 11) through a pluggable optimizer, recording ``DIAG_KEYS``.

This slice ports the full-participation round with one local step and the
``sgd`` client on a fixed Rayleigh channel, driven by the ``python`` host
loop.  Config values of unported paths raise ``NotImplementedError`` naming
their ROADMAP item: ``driver='scan'``, ``k_block``, ``active_gather``,
``device_mesh``, ``participation < 1``, ``local_steps > 1``, the ``mesh``
backend, and (through ``ChannelConfig``/``ClientConfig``) block fading,
non-Rayleigh models, imperfect CSI, geometry and non-sgd clients.

Random streams: the channel draw uses ``rng.generator(cfg.seed)`` and round
t's channel noise ``rng.generator(cfg.seed + 1, t)``, all on the CPU, so a
CPU and a GPU run from one seed see the same channel and noise and
``run(5); run(5)`` continues ``run(10)``.  ``run(noise_provider=...)``
injects the flat noise vector instead (the parity tests' seam).
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
    participation: float = 1.0           # < 1 not ported
    participation_mode: str = "bernoulli"
    # --- K-scale axes (not ported) -----------------------------------------
    k_block: Optional[int] = None
    active_gather: bool = False
    device_mesh: Optional[int] = None
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
        if self.k_block is not None and self.k_block < 1:
            raise ValueError(f"k_block must be >= 1, got {self.k_block}")
        if self.device_mesh is not None and self.device_mesh < 1:
            raise ValueError(
                f"device_mesh must be >= 1, got {self.device_mesh}")
        unported = (
            (self.backend == "mesh",
             "the mesh backend", "queue 1 item 15"),
            (self.local_steps > 1,
             "local_steps > 1", "queue 1 item 7 (local-step round)"),
            (self.participation < 1.0,
             "participation < 1", "queue 1 item 10"),
            (self.k_block is not None, "k_block streaming", "queue 1 item 10"),
            (self.active_gather, "active_gather", "queue 1 item 10"),
            (self.device_mesh is not None, "device_mesh", "queue 1 item 15"),
        )
        for hit, what, item in unported:
            if hit:
                raise NotImplementedError(
                    f"{what} is not ported yet: ROADMAP {item}")


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


def _local_transmit(cfg: FLConfig, grad_fn: GradFn, params: Tree,
                    batch) -> Tree:
    """Every device's local gradient (``local_steps == 1``, the paper):
    ``grad_fn`` vmapped over the leading K axis of the batch."""
    return torch.func.vmap(grad_fn, in_dims=(None, 0))(params, batch)


def _round_math(cfg: FLConfig, sch: schemes.Scheme, opt: optim.Optimizer,
                grad_fn: GradFn, params: Tree, opt_state, batch,
                h: torch.Tensor, h_hat: Optional[torch.Tensor],
                b: torch.Tensor, a: float, eta0: float, t: int, *,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
    """One FL round (local gradients -> OTA aggregate -> server step) plus
    the ``DIAG_KEYS`` diagnostics.  ``h_hat=None`` is perfect CSI (the
    estimate IS ``h``, so ``csi_gain_err`` is a hard 0).  Returns
    ``(params, opt_state, diag)`` with diag values as 0-d tensors or
    floats."""
    if h_hat is None:
        h_hat = h
    stacked = _local_transmit(cfg, grad_fn, params, batch)
    ocfg = ota.OTAConfig(scheme=cfg.scheme, a=a,
                         noise_var=cfg.channel.noise_var,
                         grad_bound=cfg.grad_bound, backend=cfg.backend)
    y = ota.aggregate(ocfg, stacked, h, b, generator, h_hat=h_hat,
                      noise=noise)
    # one stats pass feeds both diagnostics (grad norms and the eq.-8
    # transmit energy); the aggregate above keeps its own internal stats
    stats = schemes.compute_stats(stacked, sch, batched=True)
    norms = torch.sqrt(stats.sq_norm)
    tx = schemes.transmit_energy(sch, stats, b, cfg.grad_bound)
    diag_core = {
        "grad_norm_mean": torch.mean(norms),
        "grad_norm_min": torch.min(norms),
        "grad_norm_max": torch.max(norms),
        "tx_energy": torch.sum(tx),
    }
    return _round_tail(cfg, sch, opt, params, opt_state, y, eta0, t,
                       diag_core, a, h, h_hat, b)


def _round_tail(cfg, sch, opt, params, opt_state, y, eta0, t, diag_core,
                a_eff, h, h_hat, b_eff):
    """Post-aggregation tail: the server-optimizer step and the
    ``DIAG_KEYS`` assembly."""
    eta = _eta_t(cfg, eta0, t)
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
        "update_norm": torch.sqrt(sum(torch.sum(torch.square(l))
                                      for l in schemes.leaves(y))),
        "num_participants": float(cfg.num_devices),
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
        ) -> Tuple[FLState, Dict[str, List]]:
    """Run ``num_rounds`` FL rounds on the host-loop driver.

    ``batch_provider(t)`` returns the per-device batch (leading K axis) for
    round t on the params' device.  ``eval_fn`` runs at t == 1 and every
    ``eval_every``-th round.  ``noise_provider(t)``, when given, returns
    round t's flat channel noise z [N] (sorted-key leaf order) instead of
    the draw from ``rng.generator(cfg.seed + 1, t)``.  The params, server
    optimizer state and round counter persist in ``state``, so a second
    ``run`` resumes where the first stopped."""
    if driver not in DRIVERS:
        raise ValueError(f"unknown driver {driver!r}; one of {DRIVERS}")
    if driver == "scan":
        raise NotImplementedError(
            "the compiled (scan) driver is not ported yet: ROADMAP queue 1 "
            "item 8; use driver='python'")
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
    h = torch.as_tensor(state.h, dtype=torch.float32).to(device)
    b = torch.as_tensor(state.b, dtype=torch.float32).to(device)
    # the reference holds a and eta0 as fp32 scalars
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
        params, opt_state, diag = _round_math(
            cfg, sch, opt, grad_fn, params, opt_state, batch_provider(t),
            h, None, b, a, eta0, t, generator=gen, noise=noise)
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
