"""Over-the-air gradient aggregation (port of ``repro/core/ota.py``):

    y = a * ( sum_k h_k b_k x_k + z ),      z ~ N(0, sigma^2 I)      (eq. 10)

followed by ``w <- w - eta * y`` (eq. 11).  The schemes are defined once in
``repro_torch.core.schemes``.  Backends (``OTAConfig.backend``):

``vmap``     plain PyTorch on stacked trees (leading device axis K):
             ``device_transform`` -> ``superpose`` -> ``server_post``.
``kernels``  the same stacked layout through the Hopper kernels
             (``repro_torch.fed.kernel_path``): one moments launch and one
             fused superposition launch per round.

Both draw the channel noise the same way (``schemes.add_channel_noise``), or
take it injected as a flat [N] vector in sorted-key leaf order.  The
``mesh`` backend, ``k_block`` streaming and ``device_mesh`` are not ported
yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch._config import config
from repro_torch.core import schemes
from repro_torch.core.schemes import Tree

BACKENDS = ("vmap", "kernels", "mesh")


@config
class OTAConfig:
    """Per-round aggregation parameters."""

    scheme: str = "normalized"
    a: float = 1.0                       # receiver gain (server side)
    noise_var: float = 0.0               # sigma^2 of the AWGN at the ES
    grad_bound: Optional[float] = None   # G, required by benchmark1/clipped
    noiseless: bool = False              # omit the noise term (ideal channel)
    backend: str = "vmap"
    k_block: Optional[int] = None        # streaming superposition (not ported)
    device_mesh: Optional[int] = None    # sharded streaming (not ported)

    def __post_init__(self):
        schemes.validate_config(self.scheme, self.grad_bound)
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; one of {BACKENDS}")
        if self.noise_var < 0.0:
            raise ValueError(f"noise_var must be >= 0, got {self.noise_var}")
        if self.backend == "mesh":
            raise NotImplementedError(
                "the mesh backend is not ported yet: ROADMAP queue 1 item 15")
        if self.k_block is not None:
            raise NotImplementedError(
                "k_block streaming is not ported yet: ROADMAP queue 1 item 10")
        if self.device_mesh is not None:
            raise NotImplementedError(
                "device_mesh is not ported yet: ROADMAP queue 1 item 15")


# ---------------------------------------------------------------------------
# flat-vector helpers (sorted-key leaf order, as jax.flatten_util.ravel_pytree)


def device_template(stacked: Tree) -> Dict[str, torch.Size]:
    """Single-device leaf shapes of a stacked tree."""
    return {k: stacked[k].shape[1:] for k in sorted(stacked)}


def ravel(tree: Tree) -> torch.Tensor:
    """Flatten a single-device tree to [N] fp32 in sorted-key order."""
    return torch.cat([tree[k].float().reshape(-1) for k in sorted(tree)])


def unravel(flat: torch.Tensor, shapes: Dict[str, torch.Size]) -> Tree:
    """Inverse of ``ravel`` for the given single-device shapes."""
    out, i = {}, 0
    for k in sorted(shapes):
        n = math.prod(shapes[k])
        out[k] = flat[i:i + n].reshape(shapes[k])
        i += n
    if i != flat.shape[0]:
        raise ValueError(f"flat vector has {flat.shape[0]} entries, the "
                         f"template {i}")
    return out


def resolve_noise(cfg: OTAConfig, shapes: Dict[str, torch.Size],
                  device: torch.device,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None
                  ) -> Optional[torch.Tensor]:
    """The round's flat channel noise z [N] on ``device``, or None for a
    noiseless round (``cfg.noiseless``, sigma^2 = 0, or neither a generator
    nor an injected vector).  An injected ``noise`` replaces the draw."""
    if cfg.noiseless or cfg.noise_var <= 0.0:
        return None
    if noise is not None:
        n = sum(math.prod(s) for s in shapes.values())
        if noise.shape != (n,):
            raise ValueError(f"injected noise has shape {tuple(noise.shape)}, "
                             f"expected ({n},)")
        return noise.to(device=device, dtype=torch.float32)
    if generator is None:
        return None
    zeros = {k: torch.zeros(s, device=device) for k, s in shapes.items()}
    return ravel(schemes.add_channel_noise(zeros, generator, cfg.noise_var))


# ---------------------------------------------------------------------------
# the vmap backend


def device_transform(scheme: str, stacked_grads: Tree,
                     grad_bound: Optional[float] = None) -> Tuple[Tree, dict]:
    """Apply a scheme's device-side transform.  Returns (x_k stack, side)."""
    sch = schemes.get(scheme)
    if sch.baseline:
        return stacked_grads, {}
    stats = schemes.compute_stats(stacked_grads, sch, batched=True)
    x = schemes.transform(sch, stacked_grads, stats, grad_bound, batched=True)
    side = sch.collect_side(stats) if sch.collect_side else {}
    return x, side


def superpose(stacked_x: Tree, h: torch.Tensor, b: torch.Tensor, a,
              noise: Optional[torch.Tensor]) -> Tree:
    """The MAC channel: y = a (sum_k h_k b_k x_k + z), one fp32 reduction per
    leaf; ``noise`` is the flat z (None: noiseless)."""
    hb = (h * b).float()
    summed = schemes.tree_map(
        lambda l: torch.tensordot(hb, l.float(), dims=([0], [0])), stacked_x)
    if noise is not None:
        z = unravel(noise, {k: v.shape for k, v in summed.items()})
        summed = schemes.tree_map(lambda l, zl: l + zl, summed, z)
    return schemes.tree_map(lambda l: a * l, summed)


def server_post(scheme: str, y: Tree, side: dict, h: torch.Tensor,
                b: torch.Tensor) -> Tree:
    """Server-side reconstruction after the receiver gain; ``h`` is the
    channel as the server knows it (the CSI estimate)."""
    sch = schemes.get(scheme)
    if sch.server_post is None:
        return y
    return sch.server_post(y, schemes.fold_side_stacked(side, h, b))


def aggregate(cfg: OTAConfig, stacked_grads: Tree, h: torch.Tensor,
              b: torch.Tensor, generator: Optional[torch.Generator] = None,
              h_hat: Optional[torch.Tensor] = None, *,
              noise: Optional[torch.Tensor] = None) -> Tree:
    """Full OTA aggregation: device transform -> superpose -> server post,
    on the backend of ``cfg.backend``.  ``h`` is the true channel (the air),
    ``h_hat`` the server's estimate (None: perfect CSI).  The noise is drawn
    from the CPU ``generator`` or injected as ``noise`` [N].  Returns the
    update direction y with ``w <- w - eta * y``."""
    if h_hat is None:
        h_hat = h
    sch = schemes.get(cfg.scheme)
    if sch.baseline:
        return schemes.tree_map(lambda l: torch.mean(l, dim=0), stacked_grads)
    first = stacked_grads[sorted(stacked_grads)[0]]
    z = resolve_noise(cfg, device_template(stacked_grads), first.device,
                      generator, noise)
    if cfg.backend == "kernels":
        from repro_torch.fed.kernel_path import aggregate_kernels
        return aggregate_kernels(cfg, stacked_grads, h, b, z, h_hat=h_hat)
    x, side = device_transform(cfg.scheme, stacked_grads, cfg.grad_bound)
    y = superpose(x, h, b, cfg.a, z)
    return server_post(cfg.scheme, y, side, h_hat, b)


def apply_update(params: Tree, y: Tree, eta) -> Tree:
    """w <- w - eta y  (eq. 11)."""
    return schemes.tree_map(lambda w, u: w - eta * u.to(w.dtype), params, y)

