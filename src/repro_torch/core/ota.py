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
receiver gain is ``OTAConfig.a``, or ``aggregate(a=)``: a 0-d fp32 tensor on
the gradients' device, as the FL runtime passes each round's gain (a CUDA
graph of the round then reads it from device memory).

``mesh``     each rank of a ``torch.distributed`` group of K ranks is one
             device; the superposition is one all-reduce
             (``repro_torch.distribution.ota_collectives.aggregate_mesh``).

``OTAConfig.k_block`` streams the device axis K-block by K-block: the
kernels backend launches the streamed kernels (``aggregate_kernels``), the
vmap backend folds the blocks through the carry API below
(``streaming_carry`` / ``streaming_block`` / ``streaming_finish``), which
the FL runtime's streaming round also drives.  ``OTAConfig.device_mesh = D``
(on either stacked backend) cuts the blocks into D contiguous shards: each
shard folds its own blocks from a zero carry, and one fixed left fold
(``distribution.ota_collectives.fold_shards``) combines the D carries, on
a group of D ranks (a rank a shard) or, without one, the shards in turn in
this process, bitwise the same.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch._config import config
from repro_torch.core import schemes
from repro_torch.core.schemes import Tree
from repro_torch.kernels.ref import k_block_size

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
    k_block: Optional[int] = None        # streaming superposition
    # sharded streaming (needs k_block): the K-blocks cut into this many
    # contiguous shards, each folded from its own zero carry, the carries
    # combined by one fixed left fold.  The value fixes the order of the
    # sums, not a placement: a group of that many ranks and the emulated
    # single-process path give the same bits.  None keeps the flat fold
    device_mesh: Optional[int] = None

    def __post_init__(self):
        schemes.validate_config(self.scheme, self.grad_bound)
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; one of {BACKENDS}")
        if self.noise_var < 0.0:
            raise ValueError(f"noise_var must be >= 0, got {self.noise_var}")
        if self.k_block is not None:
            if self.k_block < 1:
                raise ValueError(f"k_block must be >= 1, got {self.k_block}")
            if self.backend == "mesh":
                raise ValueError("the mesh backend's device axis IS the mesh "
                                 "-- k_block streaming applies to the stacked "
                                 "(vmap/kernels) backends; to parallelize a "
                                 "streamed round over ranks use device_mesh "
                                 "(the sharded streaming engine)")
        if self.device_mesh is not None:
            if self.device_mesh < 1:
                raise ValueError(
                    f"device_mesh must be >= 1, got {self.device_mesh}")
            if self.k_block is None:
                raise ValueError(
                    "device_mesh shards the K-block stream -- set k_block "
                    "(the dense path has no block axis to partition)")


# every OTAConfig field is structural (the sweep batches FLConfig and
# ChannelConfig fields and derives each round's OTA parameters)
STRUCTURAL_OTA_FIELDS = ("scheme", "a", "noise_var", "grad_bound",
                         "noiseless", "backend", "k_block", "device_mesh")


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
    if cfg.noiseless:
        return None
    return channel_noise(cfg.noise_var, shapes, device, generator, noise)


def channel_noise(noise_var: float, shapes: Dict[str, torch.Size],
                  device: torch.device,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None
                  ) -> Optional[torch.Tensor]:
    """``resolve_noise`` for a bare sigma^2 (the mesh backend's
    ``ota_psum``): the flat noise z [N], or None without noise."""
    if not schemes.maybe_positive(noise_var):
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
    return ravel(schemes.add_channel_noise(zeros, generator, noise_var))


# ---------------------------------------------------------------------------
# per-device helpers (leading axis = device)


def tree_num_elements(tree: Tree) -> int:
    """Total number of scalar coordinates in one device's gradient (= N)."""
    return sum(l.numel() // l.shape[0] for l in schemes.leaves(tree))


def per_device_sq_norm(stacked: Tree) -> torch.Tensor:
    """[K] squared global L2 norms, one a device."""
    return sum(torch.sum(torch.square(l.float()).reshape(l.shape[0], -1),
                         dim=1) for l in schemes.leaves(stacked))


def per_device_norm(stacked: Tree) -> torch.Tensor:
    return torch.sqrt(per_device_sq_norm(stacked))


def per_device_mean_std(stacked: Tree) -> Tuple[torch.Tensor, torch.Tensor]:
    """[K] global mean and std over each device's full gradient vector."""
    ls = schemes.leaves(stacked)
    n = tree_num_elements(stacked)
    s1 = sum(torch.sum(l.float().reshape(l.shape[0], -1), dim=1) for l in ls)
    mean = s1 / n
    s2 = sum(torch.sum(torch.square(l.float()).reshape(l.shape[0], -1),
                       dim=1) for l in ls)
    var = torch.clamp(s2 / n - torch.square(mean), min=0.0)
    return mean, torch.sqrt(var)


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


# ---------------------------------------------------------------------------
# fixed-order sums


def _pairwise_fold(x: torch.Tensor) -> torch.Tensor:
    """Fixed-association pairwise (binary-tree) sum of a 1-D fp32 tensor,
    built from elementwise adds only."""
    tail = torch.zeros((), dtype=torch.float32, device=x.device)
    while x.shape[0] > 1:
        n = x.shape[0]
        if n % 2:
            tail = tail + x[n - 1]
            x = x[:n - 1]
        x = x[0::2] + x[1::2]
    return x[0] + tail


def pinned_sum(v: torch.Tensor) -> torch.Tensor:
    """Full-array fp32 sum in one fixed association, whatever surrounds the
    call: the array is cut into at least two chunks, each is summed by
    ``_pairwise_fold``, and the chunk sums are added left to right (the
    reference's ``core/ota.py::pinned_sum``, whose value this reproduces;
    it may differ from ``torch.sum`` by ulps)."""
    v = v.float().reshape(-1)
    n = v.shape[0]
    if n == 0:
        return torch.zeros((), dtype=torch.float32, device=v.device)
    if n == 1:
        return v[0]
    chunk = max(1, 1 << max((n - 1).bit_length() - 2, 0))
    rows = -(-n // chunk)
    # zero padding is exact: x + 0.0 == x for every fp32 x
    v = torch.nn.functional.pad(v, (0, rows * chunk - n))
    total = torch.zeros((), dtype=torch.float32, device=v.device)
    for row in v.reshape(rows, chunk):
        total = total + _pairwise_fold(row)
    return total


# ---------------------------------------------------------------------------
# streaming superposition (K-blocked accumulation; OTAConfig.k_block)
#
# The carry API is the single definition of "accumulate one K-block of
# transmit signals into a running fp32 aggregate": ``aggregate`` drives it
# over a stacked tree cut into blocks, and the FL runtime's streaming round
# drives it with per-block gradient computation, so a [K, N] stack never
# exists.  On the kernels backend each block is one launch of the dense
# superposition kernel (zero noise, a = 1); the noise and the gain are
# applied once, at the finish.


def _device_template(stacked: Tree) -> Tree:
    """Single-device fp32 zeros with the stacked tree's per-device shapes."""
    return {k: torch.zeros(stacked[k].shape[1:], dtype=torch.float32,
                           device=stacked[k].device) for k in sorted(stacked)}


def _side_parts(sch: schemes.Scheme, count: int):
    """Split a scheme's side info into (tensor-valued names, number-valued
    dict), using dummy stats: the tensor parts are hb-weighted running sums
    in the carry, the numbers (dimension constants) pass through."""
    if sch.collect_side is None:
        return (), {}
    z = torch.zeros((1,), dtype=torch.float32)
    dummy = schemes.DeviceStats(count=count, sq_norm=z,
                                total=z if sch.needs_moments else None)
    side = sch.collect_side(dummy)
    arrays = tuple(k for k, v in side.items() if isinstance(v, torch.Tensor))
    numbers = {k: v for k, v in side.items()
               if not isinstance(v, torch.Tensor)}
    return arrays, numbers


def streaming_carry(cfg: OTAConfig, template: Tree) -> dict:
    """Zero carry of a K-blocked aggregation.  ``template`` is a
    single-device tree of fp32 zeros on the run's device.  The carry holds
    the running fp32 superposition (a tree on the vmap backend, the flat
    [N] vector on the kernels backend), the hb-weighted side-info sums, the
    running server-side hb mass and the kernels path's shift correction."""
    sch = schemes.get(cfg.scheme)
    n = sum(v.numel() for v in template.values())
    device = next(iter(template.values())).device
    if cfg.backend == "kernels" and not sch.baseline:
        acc = torch.zeros((n,), dtype=torch.float32, device=device)
    else:
        acc = {k: torch.zeros_like(v) for k, v in template.items()}
    side_names, _ = _side_parts(sch, n)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {"acc": acc, "hb_srv": zero, "shift": zero,
            "side": {name: zero for name in side_names}}


def streaming_block(cfg: OTAConfig, carry: dict, block_tree: Tree,
                    hb_air: torch.Tensor, hb_srv: torch.Tensor, *,
                    stats: Optional[schemes.DeviceStats] = None,
                    grad_bound=None,
                    baseline_weights: Optional[torch.Tensor] = None) -> dict:
    """Accumulate one K-block of device gradients into the carry.

    ``hb_air`` is the block's true-channel weight h_k b_k (the air),
    ``hb_srv`` the server-known weight h_hat_k b_k (side-info folding).
    ``stats`` lets a caller that already has the block's per-device
    statistics share them.  ``grad_bound`` overrides ``cfg.grad_bound``
    (the FL round passes its G as a 0-d tensor on the device).
    ``baseline_weights`` (baseline schemes only) turns the running plain
    sum into a weighted one -- the runtime's masked participant mean -- and
    the caller then finishes with ``num_devices=1``."""
    sch = schemes.get(cfg.scheme)
    if grad_bound is None:
        grad_bound = cfg.grad_bound
    if stats is None:
        stats = schemes.compute_stats(block_tree, sch, batched=True)
    hb_air = hb_air.float()
    hb_srv = hb_srv.float()

    if sch.baseline:
        if baseline_weights is None:
            acc = schemes.tree_map(
                lambda A, l: A + torch.sum(l.float(), dim=0), carry["acc"],
                block_tree)
        else:
            w = baseline_weights.float()
            acc = schemes.tree_map(
                lambda A, l: A + torch.tensordot(w, l.float(),
                                                 dims=([0], [0])),
                carry["acc"], block_tree)
        return {**carry, "acc": acc,
                "hb_srv": carry["hb_srv"] + torch.sum(hb_srv)}

    shift = carry["shift"]
    if cfg.backend == "kernels":
        from repro_torch.kernels import ops
        leaves = schemes.leaves(block_tree)
        kb = leaves[0].shape[0]
        flat2d = [l.float().reshape(kb, -1) for l in leaves]
        if sch.per_tensor:
            pre_fn = schemes.PRE_TRANSFORMS[sch.pre]
            scales = sch.tensor_scale(stats, grad_bound)
            flat = torch.cat([pre_fn(l2) * s[:, None]
                              for l2, s in zip(flat2d, scales)], dim=1)
            scale = hb_air
            kernel_pre = "identity"
        else:
            flat = torch.cat(flat2d, dim=1)
            scale = sch.device_scale(stats, grad_bound) * hb_air
            if sch.device_shift is not None:
                shift = shift + torch.sum(
                    scale * sch.device_shift(stats, grad_bound))
            kernel_pre = sch.pre
        zeros = torch.zeros((flat.shape[1],), dtype=torch.float32,
                            device=flat.device)
        partial = ops.ota_superpose(flat, scale.float().contiguous(), zeros,
                                    1.0, pre=kernel_pre)
        acc = carry["acc"] + partial
    else:
        x = schemes.transform(sch, block_tree, stats, grad_bound,
                              batched=True)
        acc = schemes.tree_map(
            lambda A, l: A + torch.tensordot(hb_air, l.float(),
                                             dims=([0], [0])),
            carry["acc"], x)

    side = carry["side"]
    # side is a dict of tensors: the branch asks whether there is side info
    # tracelint: disable=TL003 a dict's emptiness, not a tensor's value
    if side:
        collected = sch.collect_side(stats)
        side = {name: side[name] + torch.sum(hb_srv * collected[name])
                for name in side}
    return {"acc": acc, "hb_srv": carry["hb_srv"] + torch.sum(hb_srv),
            "shift": shift, "side": side}


def streaming_finish(cfg: OTAConfig, carry: dict, template: Tree, a,
                     noise: Optional[torch.Tensor], *,
                     num_devices: Optional[float] = None) -> Tree:
    """Close a K-blocked aggregation: add the flat channel noise ``noise``
    [N] once (None: noiseless), apply the receiver gain ``a`` (a float or a
    0-d tensor) and the scheme's server post-transform with the accumulated
    side-info fold.  For baseline schemes ``num_devices`` divides the
    running sum into the mean."""
    sch = schemes.get(cfg.scheme)
    if sch.baseline:
        inv = 1.0 / num_devices
        return schemes.tree_map(lambda l: l * inv, carry["acc"])

    shapes = {k: v.shape for k, v in template.items()}
    if cfg.backend == "kernels":
        acc = carry["acc"]
        if noise is not None:
            acc = acc + noise
        y = unravel(a * acc + a * carry["shift"], shapes)
    else:
        summed = carry["acc"]
        if noise is not None:
            summed = schemes.tree_map(lambda l, zl: l + zl, summed,
                                      unravel(noise, shapes))
        y = schemes.tree_map(lambda l: a * l, summed)

    if sch.server_post is None:
        return y
    n = sum(v.numel() for v in template.values())
    _, numbers = _side_parts(sch, n)
    folded = dict(numbers)
    denom = carry["hb_srv"] + schemes.EPS
    for name, total in carry["side"].items():
        folded[name] = total / denom
    return sch.server_post(y, folded)


def _aggregate_streaming(cfg: OTAConfig, stacked_grads: Tree,
                         h: torch.Tensor, b: torch.Tensor,
                         noise: Optional[torch.Tensor],
                         h_hat: torch.Tensor, a, grad_bound=None) -> Tree:
    """The K-blocked aggregation behind ``aggregate`` (the vmap backend, and
    either stacked backend under ``device_mesh``): the stacked tree is cut
    into [k_block, ...] blocks, folded in order through the carry API.

    With ``cfg.device_mesh = D`` the nb blocks are cut further into D
    contiguous runs of nb/D: each shard folds its own run from a zero
    carry, and the D carries combine through ``fold_shards`` (every carry
    field is a sum).  On a group of D ranks each rank folds only its own run
    and the carries are gathered; otherwise the shards run one after
    another here and are stacked.  Both paths run the same per-shard fold at
    the same shapes and the same combine, so they give the same bits."""
    first = stacked_grads[sorted(stacked_grads)[0]]
    k = first.shape[0]
    kb = k_block_size(k, cfg.k_block)
    nb = k // kb
    template = _device_template(stacked_grads)
    hb_air = (h * b).float()
    hb_srv = (h_hat * b).float()

    def fold(lo_block: int, hi_block: int) -> dict:
        """One shard's left fold over the blocks [lo_block, hi_block)."""
        carry = streaming_carry(cfg, template)
        for j in range(lo_block, hi_block):
            blk = slice(j * kb, (j + 1) * kb)
            block = {name: l[blk] for name, l in stacked_grads.items()}
            carry = streaming_block(cfg, carry, block, hb_air[blk],
                                    hb_srv[blk], grad_bound=grad_bound)
        return carry

    d = cfg.device_mesh
    if d is not None and d > 1:
        from repro_torch.distribution import ota_collectives as coll
        from repro_torch.distribution import sharding
        if nb % d != 0:
            raise ValueError(
                f"device_mesh {d} must divide the block count {nb} "
                f"(= K {k} / k_block {kb}) -- pick a k_block so that "
                "K / k_block is a multiple of the mesh size")
        per = nb // d
        mesh = sharding.device_mesh(d)
        if mesh is None:
            stacked = coll.stack_shards([fold(s * per, (s + 1) * per)
                                         for s in range(d)])
        else:
            stacked = coll.gather_shards(
                fold(mesh.rank * per, (mesh.rank + 1) * per), mesh.group)
        carry = coll.fold_shards(stacked)
    else:
        carry = fold(0, nb)
    return streaming_finish(cfg, carry, template, a, noise,
                            num_devices=float(k))


def aggregate(cfg: OTAConfig, stacked_grads: Tree, h: torch.Tensor,
              b: torch.Tensor, generator: Optional[torch.Generator] = None,
              h_hat: Optional[torch.Tensor] = None, *,
              noise: Optional[torch.Tensor] = None, a=None,
              grad_bound=None) -> Tree:
    """Full OTA aggregation: device transform -> superpose -> server post,
    on the backend of ``cfg.backend``.  ``h`` is the true channel (the air),
    ``h_hat`` the server's estimate (None: perfect CSI).  The noise is drawn
    from the CPU ``generator`` or injected as ``noise`` [N].  ``a`` replaces
    ``cfg.a`` as the receiver gain (a float, or a 0-d fp32 tensor on the
    gradients' device), ``grad_bound`` replaces ``cfg.grad_bound`` (as
    ``a``).  Returns the update direction y with ``w <- w - eta * y``.

    ``cfg.k_block`` streams the device axis: the kernels backend launches
    the streamed kernels, the vmap backend folds the carry API over the
    blocks.  ``cfg.device_mesh > 1`` (either stacked backend) folds the
    carry API shard by shard (on the kernels backend one superposition
    launch a K-block of a shard) and combines the shards' carries with one
    fixed fold.  The ``mesh`` backend runs ``aggregate_mesh`` on a group of
    K ranks, one rank a device."""
    if h_hat is None:
        h_hat = h
    if a is None:
        a = cfg.a
    if grad_bound is None:
        grad_bound = cfg.grad_bound
    if cfg.backend == "mesh":
        from repro_torch.distribution.ota_collectives import aggregate_mesh
        return aggregate_mesh(cfg, stacked_grads, h, b, generator, h_hat,
                              noise=noise, a=a, grad_bound=grad_bound)
    sch = schemes.get(cfg.scheme)
    sharded = cfg.device_mesh is not None and cfg.device_mesh > 1
    streamed = cfg.k_block is not None and (cfg.backend == "vmap" or sharded)
    if sch.baseline and not streamed:
        return schemes.tree_map(lambda l: torch.mean(l, dim=0), stacked_grads)
    first = stacked_grads[sorted(stacked_grads)[0]]
    z = None if sch.baseline else resolve_noise(
        cfg, device_template(stacked_grads), first.device, generator, noise)
    if streamed:
        return _aggregate_streaming(cfg, stacked_grads, h, b, z, h_hat, a,
                                    grad_bound)
    if cfg.backend == "kernels":
        from repro_torch.fed.kernel_path import aggregate_kernels
        return aggregate_kernels(cfg, stacked_grads, h, b, z, h_hat=h_hat,
                                 k_block=cfg.k_block, a=a,
                                 grad_bound=grad_bound)
    x, side = device_transform(cfg.scheme, stacked_grads, grad_bound)
    y = superpose(x, h, b, a, z)
    return server_post(cfg.scheme, y, side, h_hat, b)


def apply_update(params: Tree, y: Tree, eta) -> Tree:
    """w <- w - eta y  (eq. 11)."""
    return schemes.tree_map(lambda w, u: w - eta * u.to(w.dtype), params, y)



# ---------------------------------------------------------------------------
# partial participation


def participation_fold(h: torch.Tensor, b: torch.Tensor, a,
                       mask: torch.Tensor,
                       sum_fn=torch.sum) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """Fold a round's 0/1 participation mask into the channel parameters.

    A device that sits the round out transmits nothing, which on every
    backend is exactly ``b_k = 0``.  The server schedules the round, so it
    rescales its receiver gain to hold the effective gain
    ``a * sum_k h_k b_k`` at the full-cohort design value (pass the CSI
    estimate for ``h``: this is a server computation).  If nobody
    participates the gain is zeroed.  ``sum_fn`` is the K-way sum of the
    gain folds (``torch.sum``; the sharded round passes ``pinned_sum``, as
    the reference does).  Returns ``(b_eff, a_eff)``, the latter a 0-d fp32
    tensor."""
    mask = mask.float()
    b_eff = b * mask
    hb_full = sum_fn(h * b)
    hb_eff = sum_fn(h * b_eff)
    a_eff = torch.where(hb_eff > schemes.EPS * torch.clamp(hb_full, min=1.0),
                        a * hb_full / torch.clamp(hb_eff, min=schemes.EPS),
                        torch.zeros_like(hb_eff))
    return b_eff, a_eff.float()


# ---------------------------------------------------------------------------
# power accounting


def transmit_norms(scheme: str, stacked_grads: Tree,
                   grad_bound: Optional[float] = None) -> torch.Tensor:
    """[K] transmit-signal norms ||x_k||: exactly 1 for ``normalized``,
    ||g_k|| / G <= 1 for ``benchmark1``, sqrt(N) for ``benchmark2``."""
    x, _ = device_transform(scheme, stacked_grads, grad_bound)
    return per_device_norm(x)


def transmit_energy(scheme: str, stacked_grads: Tree, b: torch.Tensor,
                    grad_bound: Optional[float] = None,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[K] per-round transmit energies b_k^2 ||x_k||^2 (the paper's eq. 8
    budget), from each scheme's analytic ``transmit_sq_norm`` (no second
    pass over the gradients); ``mask`` zeroes the energy of devices that sat
    the round out."""
    sch = schemes.get(scheme)
    stats = schemes.compute_stats(stacked_grads, sch, batched=True)
    return schemes.transmit_energy(sch, stats, b, grad_bound, mask)
