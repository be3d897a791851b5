"""The paper's aggregation as a collective over the FL devices (port of
``repro/distribution/ota_collectives.py``): ``ota_psum``, the ``mesh``
backend of ``repro_torch.core.ota.aggregate``, and the cross-shard combine
of the sharded streaming round.

Each rank of a ``torch.distributed`` group plays one mobile device:

    g_k  --scheme transform-->  x_k h_k b_k  --[all_reduce SUM]-->  +z, *a

The one ``all_reduce`` is the over-the-air superposition (eq. 10): the
scheme's transform (``repro_torch.core.schemes``) takes ``h_k b_k`` into
the per-device scale, so the sum needs no second pass.  The channel noise
is added after the sum, once, from a stream every rank holds the same (a
CPU generator from one seed, or one injected vector), so every rank ends
with the same update, as Step 3's broadcast requires.  The side
information of a scheme's server post-transform folds with one more
all-reduce of a few scalars.

The sharded streaming round (``device_mesh``) closes eq. (10) by folding D
per-shard partial carries into one.  fp32 addition is not associative, so
the order of that fold is part of the result: ``fold_shards`` is a fixed
left fold over the leading (shard) axis, and both execution paths, the
physical one (``gather_shards`` over the group: a rank a shard) and the
emulated one (``stack_shards`` of the shards run in turn), reduce through
it, which makes them bitwise equal.
"""
from __future__ import annotations

import functools
from typing import Any, Optional, Sequence

import torch

from repro_torch.core import schemes
from repro_torch.core.schemes import Tree

STATS_IMPLS = ("plain", "kernels")


def _tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of a tree of dicts, tuples and lists
    (None passes through), with ``rest`` of the same structure."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    raise TypeError(f"unsupported tree node {type(tree).__name__}")


def _tree_leaves(tree) -> list:
    """Tensor leaves in ``jax.tree_util`` order (dict keys sorted)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _tree_leaves(tree[k])]
    return [l for v in tree for l in _tree_leaves(v)]


# ---------------------------------------------------------------------------
# the cross-shard combine of the sharded streaming round


def fold_shards(stacked: Any, op=torch.add) -> Any:
    """Left fold of a stacked tree over its leading (shard) axis, leaf by
    leaf: ``((s_0 op s_1) op s_2) op ...``.  ``op`` is ``torch.add`` for the
    sums; pass ``torch.minimum`` / ``torch.maximum`` for the diagnostics, so
    the combine stays one code path."""
    def one(leaf):
        return functools.reduce(op, [leaf[d] for d in range(leaf.shape[0])])

    return _tree_map(one, stacked)


def stack_shards(trees: Sequence[Any]) -> Any:
    """The emulated path's counterpart of ``gather_shards``: the shards'
    trees, run one after another in this process, stacked in shard order
    along a new leading axis."""
    return _tree_map(lambda *ls: torch.stack(ls), trees[0], *trees[1:])


def gather_shards(tree: Any, group) -> Any:
    """``all_gather`` of every leaf of a shard-local tree over the
    ``torch.distributed`` group, stacked in rank order (new leading axis =
    shard).  Gather, then ``fold_shards``, is the sharded round's one
    cross-shard collective: the bytes of a sum's all-reduce, with the order
    of the sum fixed by the fold instead of the collective's algorithm."""
    dist = torch.distributed
    n = dist.get_world_size(group)

    def one(leaf):
        flat = leaf.reshape(-1).contiguous()
        parts = [torch.empty_like(flat) for _ in range(n)]
        dist.all_gather(parts, flat, group=group)
        return torch.stack(parts).reshape((n,) + tuple(leaf.shape))

    return _tree_map(one, tree)


# ---------------------------------------------------------------------------
# the mesh backend


def client_index(group) -> int:
    """This rank's FL-device index: its rank in the group."""
    return torch.distributed.get_rank(group)


def tree_sq_norm(tree: Any) -> torch.Tensor:
    """Squared global L2 norm of a (per-rank) gradient tree, summed in fp32
    leaf by leaf: the one helper for shard-local norms."""
    return sum(torch.sum(torch.square(l.float())) for l in _tree_leaves(tree))


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    out = t.clone()
    torch.distributed.all_reduce(out, op=torch.distributed.ReduceOp.SUM,
                                 group=group)
    return out


def _local_stats_kernels(grads: Tree, sch: schemes.Scheme
                         ) -> schemes.DeviceStats:
    """This rank's statistics through the moments kernel (K1 on the card,
    its plain version on the CPU) on a one-row stack of the flat gradient;
    a per-tensor scheme adds one launch a leaf."""
    from repro_torch.kernels import ops
    leaves = schemes.leaves(grads)
    flat = torch.cat([l.float().reshape(1, -1) for l in leaves], dim=1)
    sumsq, total = ops.batched_moments(flat.contiguous())
    tensor_sq = None
    if sch.per_tensor:
        tensor_sq = tuple(
            ops.batched_moments(l.float().reshape(1, -1).contiguous())[0][0]
            for l in leaves)
    return schemes.DeviceStats(
        count=flat.shape[1], sq_norm=sumsq[0],
        total=total[0] if sch.needs_moments else None,
        tensor_sq_norms=tensor_sq)


def ota_psum(grads: Tree, *, scheme: str, group, h: torch.Tensor,
             b: torch.Tensor, a, noise_var: float,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None,
             grad_bound=None, reduce_dtype: Optional[torch.dtype] = None,
             stats_impl: str = "plain",
             h_hat: Optional[torch.Tensor] = None) -> Tree:
    """Aggregate this rank's gradient with every other rank's, over the
    air.  ``h``/``b`` are the full [K] per-device tensors (the same on every
    rank); each rank takes its own ``h_k``, ``b_k`` by its rank.  ``h_hat``
    is the server's estimate (None: perfect CSI): the true ``h`` rides the
    sum (the air), the estimate weighs the side-info fold.  The noise is
    drawn from the CPU ``generator`` (seeded alike on every rank) or
    injected as the flat ``noise`` [N] in sorted-key leaf order; with
    ``noise_var`` 0 there is none.  ``a`` is a float or a 0-d tensor on the
    gradients' device.  ``stats_impl='kernels'`` takes the statistics from
    the moments kernel.  ``reduce_dtype`` superposes in that dtype (the
    side information stays fp32).

    Returns the update direction y, the same on every rank."""
    from repro_torch.core import ota
    sch = schemes.validate_config(scheme, grad_bound)
    if stats_impl not in STATS_IMPLS:
        raise ValueError(f"unknown stats_impl {stats_impl!r}; one of "
                         f"{STATS_IMPLS}")
    if sch.baseline:
        inv = 1.0 / torch.distributed.get_world_size(group)
        return schemes.tree_map(lambda l: _all_reduce(l.float() * inv, group),
                                grads)

    me = client_index(group)
    hk = h[me].float()
    bk = b[me].float()
    hk_hat = hk if h_hat is None else h_hat[me].float()
    stats = (_local_stats_kernels(grads, sch) if stats_impl == "kernels"
             else schemes.compute_stats(grads, sch, batched=False))
    # h_k b_k in the per-device scale: the sum below IS eq. (10)
    x = schemes.transform(sch, grads, stats, grad_bound, batched=False,
                          extra_scale=hk * bk, out_dtype=torch.float32)
    if reduce_dtype is not None:
        x = schemes.tree_map(lambda l: l.to(reduce_dtype), x)
    y = schemes.tree_map(lambda l: _all_reduce(l, group).float(), x)
    first = next(iter(y.values()))
    z = ota.channel_noise(noise_var, {k: v.shape for k, v in y.items()},
                          first.device, generator, noise)
    if z is not None:
        y = schemes.tree_map(lambda l, zl: l + zl, y,
                             ota.unravel(z, {k: v.shape
                                             for k, v in y.items()}))
    y = schemes.tree_map(lambda l: a * l, y)

    if sch.server_post is None:
        return y
    folded = {}
    if sch.collect_side is not None:
        side = sch.collect_side(stats)
        names = [k for k, v in side.items() if isinstance(v, torch.Tensor)]
        w = hk_hat * bk
        # the server's hb mass and each weighted side sum: one all-reduce
        sums = _all_reduce(torch.stack([w] + [w * side[k].float()
                                              for k in names]), group)
        folded = {k: v for k, v in side.items() if k not in names}
        for i, k in enumerate(names):
            folded[k] = sums[i + 1] / (sums[0] + schemes.EPS)
    return sch.server_post(y, folded)


def aggregate_mesh(cfg, stacked_grads: Tree, h: torch.Tensor,
                   b: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   h_hat: Optional[torch.Tensor] = None, *,
                   noise: Optional[torch.Tensor] = None, a=None,
                   grad_bound=None, group=None) -> Tree:
    """The mesh backend behind ``core.ota.aggregate``: every rank of a group
    of K ranks holds the same stacked [K, ...] tree, takes its own row (one
    rank an FL device) and calls ``ota_psum``.  ``group`` defaults to the
    default process group, which must then hold exactly K ranks.  ``a`` and
    ``grad_bound`` replace the config's, as in ``aggregate``."""
    first = stacked_grads[sorted(stacked_grads)[0]]
    k = first.shape[0]
    dist = torch.distributed
    if group is None:
        have = (dist.get_world_size()
                if dist.is_available() and dist.is_initialized() else 0)
        if have != k:
            raise ValueError(
                f"mesh backend needs a group of {k} ranks for {k} FL "
                f"clients, have {have}; start K ranks "
                f"(torch.distributed.init_process_group with world_size="
                f"{k}), or use the 'vmap'/'kernels' backend")
        group = dist.group.WORLD
    rank = dist.get_rank(group)
    g = {name: l[rank] for name, l in stacked_grads.items()}
    return ota_psum(g, scheme=cfg.scheme, group=group, h=h, b=b,
                    a=cfg.a if a is None else a,
                    noise_var=0.0 if cfg.noiseless else cfg.noise_var,
                    generator=generator, noise=noise,
                    grad_bound=cfg.grad_bound if grad_bound is None
                    else grad_bound, h_hat=h_hat)
