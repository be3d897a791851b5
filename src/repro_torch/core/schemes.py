"""The scheme registry (port of ``repro/core/schemes.py``): every OTA
aggregation scheme is defined once here and consumed unchanged by the
port's backends (``vmap`` in ``core.ota``, ``kernels`` in
``fed.kernel_path``).

A scheme describes the device-side transmit transform

    x_k = ( pre(g_k) + shift_k ) * scale_k                       (per device)

with ``pre`` an element-wise transform (identity, or sign for one-bit),
``shift_k``/``scale_k`` per-device scalars derived from per-device
statistics, plus an optional server-side post-transform of the superposed
signal and the error-free side information it needs.  See the reference
module for the full contract; the callables here take [K] tensors.

Gradient pytrees are plain ``dict[str, Tensor]``; leaves are always visited
in sorted-key order, the order ``jax.tree_util`` gives a dict, so a flat
[N] vector means the same coordinates in both packages.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

Tree = Dict[str, torch.Tensor]
EPS = 1e-12

# element-wise pre-transforms the fused kernel knows how to apply in-register
PRE_TRANSFORMS = {
    "identity": lambda x: x,
    "sign": torch.sign,
}


def leaves(tree: Tree) -> List[torch.Tensor]:
    """The tree's leaves in sorted-key order (``jax.tree_util``'s order)."""
    return [tree[k] for k in sorted(tree)]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    return {k: fn(tree[k], *(r[k] for r in rest)) for k in sorted(tree)}


@dataclasses.dataclass(frozen=True)
class DeviceStats:
    """Per-device gradient statistics: [K] tensors, ``count`` = N."""

    count: int
    sq_norm: torch.Tensor                                # ||g_k||^2, global
    total: Optional[torch.Tensor] = None                 # sum_j g_k[j]
    tensor_sq_norms: Optional[Tuple[torch.Tensor, ...]] = None

    @property
    def norm(self) -> torch.Tensor:
        return torch.sqrt(self.sq_norm)

    @property
    def mean(self) -> torch.Tensor:
        return self.total / self.count

    @property
    def var(self) -> torch.Tensor:
        return torch.clamp(self.sq_norm / self.count - torch.square(self.mean),
                           min=0.0)

    @property
    def std(self) -> torch.Tensor:
        return torch.sqrt(self.var)


ScaleFn = Callable[[DeviceStats, Optional[float]], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Scheme:
    """One OTA aggregation scheme."""

    name: str
    doc: str = ""
    pre: str = "identity"
    per_tensor: bool = False
    needs_moments: bool = False
    requires_grad_bound: bool = False
    # ideal (non-OTA) reference that bypasses the channel entirely
    baseline: bool = False
    side_info: Tuple[str, ...] = ()
    device_scale: Optional[ScaleFn] = None
    device_shift: Optional[ScaleFn] = None
    tensor_scale: Optional[Callable[[DeviceStats, Optional[float]],
                                    Tuple[torch.Tensor, ...]]] = None
    collect_side: Optional[Callable[[DeviceStats], Dict[str, Any]]] = None
    server_post: Optional[Callable[[Tree, Dict[str, Any]], Tree]] = None
    transmit_sq_norm: Optional[ScaleFn] = None

    def __post_init__(self):
        if self.pre not in PRE_TRANSFORMS:
            raise ValueError(f"unknown pre-transform {self.pre!r}")
        if self.transmit_sq_norm is None:
            raise ValueError(f"scheme {self.name!r} needs transmit_sq_norm "
                             "(eq. 8 energy accounting)")
        if self.baseline:
            return
        if self.per_tensor:
            if self.tensor_scale is None:
                raise ValueError(
                    f"per_tensor scheme {self.name!r} needs tensor_scale")
            if self.device_shift is not None:
                raise ValueError(
                    f"per_tensor scheme {self.name!r} cannot use device_shift "
                    "(unsupported by the backends)")
        elif self.device_scale is None:
            raise ValueError(f"scheme {self.name!r} needs device_scale "
                             "(or per_tensor + tensor_scale, or baseline=True)")


_REGISTRY: Dict[str, Scheme] = {}


def register(scheme: Scheme) -> Scheme:
    if scheme.name in _REGISTRY:
        raise ValueError(f"scheme {scheme.name!r} already registered")
    _REGISTRY[scheme.name] = scheme
    return scheme


def get(name: str) -> Scheme:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown scheme {name!r}; one of {names()}") from None


def names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def validate_config(name: str, grad_bound: Optional[float]) -> Scheme:
    sch = get(name)
    if sch.requires_grad_bound and grad_bound is None:
        raise ValueError(f"{name} requires grad_bound (the max-norm G)")
    return sch


# ---------------------------------------------------------------------------
# backend-shared math


def compute_stats(tree: Tree, scheme: Scheme, *, batched: bool) -> DeviceStats:
    """Per-device statistics; ``batched=True`` treats leaves' leading axis as
    the device axis K, ``batched=False`` reduces the whole tree."""
    ls = leaves(tree)
    if batched:
        k = ls[0].shape[0]
        flat = [l.float().reshape(k, -1) for l in ls]
        axis = 1
    else:
        flat = [l.float().reshape(-1) for l in ls]
        axis = 0
    count = sum(l.shape[axis] for l in flat)
    tensor_sq = tuple(torch.sum(torch.square(l), dim=axis) for l in flat)
    sq_norm = sum(tensor_sq)
    total = (sum(torch.sum(l, dim=axis) for l in flat)
             if scheme.needs_moments else None)
    return DeviceStats(count=count, sq_norm=sq_norm, total=total,
                       tensor_sq_norms=tensor_sq if scheme.per_tensor else None)


def _bcast(v, leaf: torch.Tensor, batched: bool) -> torch.Tensor:
    v = torch.as_tensor(v, device=leaf.device)
    if batched:
        return v.reshape((leaf.shape[0],) + (1,) * (leaf.dim() - 1))
    return v


def transform(scheme: Scheme, tree: Tree, stats: DeviceStats,
              grad_bound: Optional[float] = None, *, batched: bool,
              extra_scale=None, out_dtype: Optional[torch.dtype] = None
              ) -> Tree:
    """Apply ``x_k = (pre(g_k) + shift_k) * scale_k`` over a gradient tree.

    ``extra_scale`` is one more per-device factor folded into the scale:
    the mesh backend passes ``h_k b_k``, so that its one all-reduce IS the
    over-the-air superposition.  ``out_dtype=None`` keeps each leaf's dtype
    (the stacked backends); the mesh backend passes fp32."""
    pre = PRE_TRANSFORMS[scheme.pre]
    if scheme.per_tensor:
        scales = scheme.tensor_scale(stats, grad_bound)
        out = {}
        for name, s in zip(sorted(tree), scales):
            if extra_scale is not None:
                s = s * extra_scale
            out[name] = pre(tree[name].float()) * _bcast(s, tree[name],
                                                         batched)
        return out

    scale = scheme.device_scale(stats, grad_bound)
    if extra_scale is not None:
        scale = scale * extra_scale
    shift = (scheme.device_shift(stats, grad_bound)
             if scheme.device_shift is not None else None)

    def one(l):
        if out_dtype is not None:
            l = l.to(out_dtype)
        x = pre(l)
        if shift is not None:
            x = x + _bcast(shift, l, batched).to(l.dtype)
        return x * _bcast(scale, l, batched).to(l.dtype)

    return tree_map(one, tree)


def fold_side(side: Dict[str, Any], weighted_mean: Callable) -> Dict[str, Any]:
    """Reduce per-device side info to the server's view; python numbers
    (dimension constants like sqrt_n) pass through unreduced."""
    return {k: (weighted_mean(v) if isinstance(v, torch.Tensor) else v)
            for k, v in side.items()}


def fold_side_stacked(side: Dict[str, Any], h: torch.Tensor,
                      b: torch.Tensor) -> Dict[str, Any]:
    """The [K] side-info fold both stacked backends use (one definition, so
    their server post-transforms agree)."""
    hb = (h * b).float()
    w = hb / (torch.sum(hb) + EPS)
    return fold_side(side, lambda v: torch.sum(w * v))


def transmit_energy(scheme: Scheme, stats: DeviceStats, b: torch.Tensor,
                    grad_bound: Optional[float] = None,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-device transmit energies ``b_k^2 ||x_k||^2`` (the paper's eq. 8
    budget) via the scheme's analytic ``transmit_sq_norm``.  ``mask`` is an
    optional 0/1 per-device participation vector: a masked device transmits
    nothing that round, so its energy is exactly zero."""
    e = torch.square(b.float()) * scheme.transmit_sq_norm(stats, grad_bound)
    if mask is not None:
        e = e * mask.float()
    return e


def maybe_positive(noise_var: float) -> bool:
    """Whether a round carries channel noise: sigma^2 > 0.  A batched run
    gates its group on any lane's (``runtime._noisy``); a lane with
    sigma^2 = 0 in a noisy group stages exact zeros, so the gate preserves
    its values."""
    return noise_var > 0.0


def add_channel_noise(tree: Tree, generator: torch.Generator,
                      noise_var: float) -> Tree:
    """Add the ES receiver noise z ~ N(0, sigma^2 I) to a single-device
    tree: one draw per leaf in sorted-key order (the reference's one split
    per leaf), made on the CPU ``generator`` and moved to the leaf's device,
    so a CPU and a GPU run from one seed see the same noise."""
    if generator.device.type != "cpu":
        raise ValueError("channel noise is drawn on a CPU generator")
    std = math.sqrt(noise_var)
    return {k: tree[k] + (std * torch.randn(
                tree[k].shape, generator=generator,
                dtype=torch.float32)).to(tree[k].device)
            for k in sorted(tree)}


# ---------------------------------------------------------------------------
# the registered schemes


def _ones(st: DeviceStats) -> torch.Tensor:
    return torch.ones_like(st.sq_norm)


register(Scheme(
    name="normalized",
    doc="x_k = g_k / ||g_k||  (the paper, eq. 12)",
    device_scale=lambda st, gb: 1.0 / (st.norm + EPS),
    transmit_sq_norm=lambda st, gb: _ones(st),
))

register(Scheme(
    name="normalized_restored",
    doc="x_k = g_k / ||g_k|| with the hb-weighted mean norm folded back by "
        "the server from error-free side info",
    side_info=("norm",),
    device_scale=lambda st, gb: 1.0 / (st.norm + EPS),
    collect_side=lambda st: {"norm": st.norm},
    server_post=lambda y, folded: tree_map(lambda l: l * folded["norm"], y),
    transmit_sq_norm=lambda st, gb: _ones(st),
))

register(Scheme(
    name="normalized_per_tensor",
    doc="each tensor normalized by its own norm, scaled 1/sqrt(#tensors) so "
        "the total transmit norm is 1",
    per_tensor=True,
    tensor_scale=lambda st, gb: tuple(
        1.0 / ((torch.sqrt(t) + EPS) * math.sqrt(len(st.tensor_sq_norms)))
        for t in st.tensor_sq_norms),
    transmit_sq_norm=lambda st, gb: _ones(st),
))

register(Scheme(
    name="raw",
    doc="x_k = g_k (no power discipline; diagnostic)",
    device_scale=lambda st, gb: _ones(st),
    transmit_sq_norm=lambda st, gb: st.sq_norm,
))

register(Scheme(
    name="benchmark1",
    doc="x_k = g_k / G -- raw gradient under the max-norm assumption of [7]",
    requires_grad_bound=True,
    device_scale=lambda st, gb: _ones(st) / gb,
    transmit_sq_norm=lambda st, gb: st.sq_norm / (gb * gb),
))


def _benchmark2_post(y: Tree, folded: Dict[str, Any]) -> Tree:
    std_bar = folded["std"] * folded["sqrt_n"]
    mean_bar = folded["mean"]
    return tree_map(lambda l: l * std_bar + mean_bar, y)


register(Scheme(
    name="benchmark2",
    doc="x_k = (g_k - mean_k) / (std_k sqrt(N)) -- standardization of [13], "
        "energy-fair; the server folds sqrt(N) back in",
    needs_moments=True,
    side_info=("mean", "std", "sqrt_n"),
    device_scale=lambda st, gb: 1.0 / ((st.std + EPS) * math.sqrt(st.count)),
    device_shift=lambda st, gb: -st.mean,
    collect_side=lambda st: {"mean": st.mean, "std": st.std,
                             "sqrt_n": math.sqrt(st.count)},
    server_post=_benchmark2_post,
    transmit_sq_norm=lambda st, gb: st.var / torch.square(st.std + EPS),
))

register(Scheme(
    name="onebit",
    doc="x_k = sign(g_k)/sqrt(N) ([12]; over-the-air signSGD-MV -- the "
        "server takes the sign of the aggregate)",
    pre="sign",
    device_scale=lambda st, gb: _ones(st) / math.sqrt(st.count),
    server_post=lambda y, folded: tree_map(torch.sign, y),
    transmit_sq_norm=lambda st, gb: _ones(st),
))

register(Scheme(
    name="mean",
    doc="ideal noiseless FedSGD mean (upper-bound reference; bypasses the "
        "channel entirely)",
    baseline=True,
    transmit_sq_norm=lambda st, gb: st.sq_norm,
))

register(Scheme(
    name="clipped",
    doc="x_k = g_k / max(||g_k||, G) -- truncated-norm transmit",
    requires_grad_bound=True,
    device_scale=lambda st, gb: 1.0 / torch.clamp(st.norm, min=gb),
    transmit_sq_norm=lambda st, gb: torch.clamp(st.sq_norm / (gb * gb),
                                                max=1.0),
))
