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
CPU generator from one seed, or one injected vector; on a training mesh
the step's seed, each rank drawing its own piece of each leaf on its
device: ``kernels.ops.channel_noise``), so every rank ends with the same
update, as Step 3's broadcast requires.  The side
information of a scheme's server post-transform folds with one more
all-reduce of a few scalars.  On a training mesh (``ctx=``, a
``RankContext``: the FL clients are the ``data`` ranks) both sums are
``ctx.fold`` instead, the fixed left fold in rank order, so a train step
gives the same bits on an emulated mesh and over physical ranks.

The sharded streaming round (``device_mesh``) closes eq. (10) by folding D
per-shard partial carries into one.  fp32 addition is not associative, so
the order of that fold is part of the result: ``fold_shards`` is a fixed
left fold over the leading (shard) axis, and both execution paths, the
physical one (``gather_shards`` over the group: a rank a shard) and the
emulated one (``stack_shards`` of the shards run in turn), reduce through
it, which makes them bitwise equal.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Optional, Sequence

import torch

from repro_torch.core import schemes
from repro_torch.core.schemes import Tree
from repro_torch.tree import tree_leaves, tree_map

STATS_IMPLS = ("plain", "kernels")


# ---------------------------------------------------------------------------
# the collectives' bytes

# per-rank output bytes of every collective this process makes, by kind
# (the reference's HLO convention, ``repro/analysis/roofline.py``), while
# ``counting_collectives()`` is open: the dry run's collective term
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
COLLECTIVE_BYTES: Optional[dict] = None


def _count(kind: str, nbytes: int) -> None:
    if COLLECTIVE_BYTES is not None:
        COLLECTIVE_BYTES[kind] += nbytes


@contextlib.contextmanager
def counting_collectives():
    """Count the collectives' output bytes into a fresh dict (yielded),
    one key a kind of ``COLLECTIVES``."""
    global COLLECTIVE_BYTES
    outer, COLLECTIVE_BYTES = COLLECTIVE_BYTES, {k: 0 for k in COLLECTIVES}
    try:
        yield COLLECTIVE_BYTES
    finally:
        COLLECTIVE_BYTES = outer


# ---------------------------------------------------------------------------
# the cross-shard combine of the sharded streaming round


def fold_shards(stacked: Any, op=torch.add) -> Any:
    """Left fold of a stacked tree over its leading (shard) axis, leaf by
    leaf: ``((s_0 op s_1) op s_2) op ...``.  ``op`` is ``torch.add`` for the
    sums; pass ``torch.minimum`` / ``torch.maximum`` for the diagnostics, so
    the combine stays one code path."""
    def one(leaf):
        return functools.reduce(op, [leaf[d] for d in range(leaf.shape[0])])

    return tree_map(one, stacked)


def stack_shards(trees: Sequence[Any]) -> Any:
    """The emulated path's counterpart of ``gather_shards``: the shards'
    trees, run one after another in this process, stacked in shard order
    along a new leading axis."""
    return tree_map(lambda *ls: torch.stack(ls), trees[0], *trees[1:])


def gather_shards(tree: Any, group) -> Any:
    """``all_gather`` of every leaf of a shard-local tree over the
    ``torch.distributed`` group, stacked in rank order (new leading axis =
    shard).  Gather, then ``fold_shards``, is the sharded round's one
    cross-shard collective, with the order of the sum fixed by the fold
    instead of the collective's algorithm.  It is an all-gather: over n
    ranks its output is n parts, n times the bytes of a sum's all-reduce
    of one part (``COLLECTIVE_BYTES``' "all-gather")."""
    dist = torch.distributed
    n = dist.get_world_size(group)

    def one(leaf):
        flat = leaf.reshape(-1).contiguous()
        parts = [torch.empty_like(flat) for _ in range(n)]
        _count("all-gather", n * flat.numel() * flat.element_size())
        dist.all_gather(parts, flat, group=group)
        return torch.stack(parts).reshape((n,) + tuple(leaf.shape))

    return tree_map(one, tree)


def fold_scatter(send: torch.Tensor, group, op=torch.add,
                 sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """This rank's chunk of the rank-order fold over the group: ``send``
    (flat) holds chunk j for rank j, of ``sizes[j]`` elements (None: n
    equal chunks); one all-to-all hands each rank every rank's chunk for
    it, stacked in rank order, and ``fold_shards`` folds the stack.  A
    reduce-scatter whose order is the fold's: 1 part of output a rank on
    average (``COLLECTIVE_BYTES``' "all-to-all", counted as ``send``'s
    bytes, so that the count is linear in the size)."""
    dist = torch.distributed
    n, me = dist.get_world_size(group), dist.get_rank(group)
    sizes = [send.numel() // n] * n if sizes is None else list(sizes)
    recv = send.new_empty(n * sizes[me])
    _count("all-to-all", send.numel() * send.element_size())
    dist.all_to_all_single(recv, send, output_split_sizes=[sizes[me]] * n,
                           input_split_sizes=sizes, group=group)
    return fold_shards(recv.view(n, sizes[me]), op)


def fold_over(x: torch.Tensor, group, op=torch.add) -> torch.Tensor:
    """The left fold of every rank's ``x`` over the group, in rank order:
    ``fold_shards(gather_shards(x, group), op)`` to the bit, moving 2 parts
    a rank instead of n.  ``x`` flat in n chunks (the first numel % n one
    element longer); ``fold_scatter`` folds this rank's chunk; a second
    all-to-all hands every rank every folded chunk (an all-gather of
    uneven chunks, counted as one).  Each element is folded from the same
    operands in the same order as the gather's fold (a chunk may be
    empty where ``x`` has fewer elements than the group has ranks)."""
    dist = torch.distributed
    n, me = dist.get_world_size(group), dist.get_rank(group)
    flat = x.reshape(-1).contiguous()
    q, r = divmod(flat.numel(), n)
    sizes = [q + (j < r) for j in range(n)]
    mine = fold_scatter(flat, group, op, sizes)
    out = torch.empty_like(flat)
    _count("all-gather", out.numel() * out.element_size())
    dist.all_to_all_single(out, mine.repeat(n), output_split_sizes=sizes,
                           input_split_sizes=[sizes[me]] * n, group=group)
    return out.view(x.shape)


# ---------------------------------------------------------------------------
# the mesh backend


def client_index(group) -> int:
    """This rank's FL-device index: its rank in the group."""
    return torch.distributed.get_rank(group)


def tree_sq_norm(tree: Any) -> torch.Tensor:
    """Squared global L2 norm of a (per-rank) gradient tree, summed in fp32
    leaf by leaf: the one helper for shard-local norms."""
    return sum(torch.sum(torch.square(l.float())) for l in tree_leaves(tree))


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    out = t.clone()
    _count("all-reduce", out.numel() * out.element_size())
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


def _part_stats(grads: Tree, sch: schemes.Scheme, impl: str, device
                ) -> schemes.DeviceStats:
    """``impl``'s statistics of a part of a gradient (zeros where it holds
    no leaf)."""
    # grads is a dict of tensors: the branch asks whether it holds a leaf
    # tracelint: disable=TL003 a dict's emptiness, not a tensor's value
    if not grads:
        zero = torch.zeros((), dtype=torch.float32, device=device)
        return schemes.DeviceStats(0, zero, zero, ())
    if impl == "kernels":
        return _local_stats_kernels(grads, sch)
    return schemes.compute_stats(grads, sch, batched=False)


def cut_stats(grads: Tree, sch: schemes.Scheme, impl: str, ctx, cut
              ) -> schemes.DeviceStats:
    """The whole client's statistics from one model rank's cut gradient
    (``cut``: a ``sharding.CutLayout``): the cut leaves' sums (one K1 row,
    with ``impl='kernels'``) folded over ``model``, plus the replicated
    leaves' (one more row), counted once; the count is the whole tree's.
    Every model rank ends with the same bits."""
    names = sorted(grads)
    dev = grads[names[0]].device
    mine, rep = (_part_stats({k: grads[k] for k in names if cut.cut[k] == c},
                             sch, impl, dev) for c in (True, False))
    sums = ([mine.sq_norm] + ([mine.total] if sch.needs_moments else [])
            + (list(mine.tensor_sq_norms) if sch.per_tensor else []))
    folded = iter(ctx.fold(torch.stack([v.float() for v in sums]), "model"))
    sq_norm = next(folded) + rep.sq_norm
    total = next(folded) + rep.total if sch.needs_moments else None
    tensor_sq = None
    if sch.per_tensor:
        reps = iter(rep.tensor_sq_norms)
        tensor_sq = tuple(next(folded) if cut.cut[k] else next(reps)
                          for k in names)
    return schemes.DeviceStats(
        count=sum(math.prod(cut.full[k]) for k in names), sq_norm=sq_norm,
        total=total, tensor_sq_norms=tensor_sq)


def tree_sq_norm_cut(grads: Tree, ctx, cut) -> torch.Tensor:
    """``tree_sq_norm`` of the whole client's gradient from one model
    rank's cut gradient: the cut leaves' part folded over ``model``, plus
    the replicated leaves' once."""
    names = sorted(grads)
    zero = torch.zeros((), dtype=torch.float32,
                       device=grads[names[0]].device)
    mine = zero + tree_sq_norm([grads[k] for k in names if cut.cut[k]])
    rep = zero + tree_sq_norm([grads[k] for k in names if not cut.cut[k]])
    return ctx.fold(mine, "model") + rep


def ota_psum(grads: Tree, *, scheme: str, group=None, ctx=None,
             h: torch.Tensor, b: torch.Tensor, a, noise_var: float,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None,
             grad_bound=None, reduce_dtype: Optional[torch.dtype] = None,
             stats_impl: str = "plain",
             h_hat: Optional[torch.Tensor] = None, cut=None,
             axis="data", noise_seed: Optional[int] = None) -> Tree:
    """Aggregate this rank's gradient with every other rank's, over the
    air.  The ranks are a ``torch.distributed`` ``group`` (the mesh
    backend: each rank an FL device, the sums all-reduces) or, with
    ``ctx`` (a ``RankContext``), the ranks along ``axis`` of a training
    mesh (``data``; on a mesh with a pod axis ``("pod", "data")`` or
    ``pod``; the sums ``ctx.fold``, in rank order; its leaves are freed as
    they fold).
    ``h``/``b`` are the full [K] per-device tensors (the same on every
    rank); each rank takes its own ``h_k``, ``b_k`` by its rank.  ``h_hat``
    is the server's estimate (None: perfect CSI): the true ``h`` rides the
    sum (the air), the estimate weighs the side-info fold.  The noise is
    drawn from the CPU ``generator`` (seeded alike on every rank) or
    injected as the flat ``noise`` [N] in sorted-key leaf order; with
    ``noise_var`` 0 there is none.  On a training mesh (``ctx``) the noise
    may come from ``noise_seed`` instead: each rank draws its piece of
    each leaf l on its device, fused with the gain ``a``
    (``kernels.ops.channel_noise`` with ``rng.noise_key(noise_seed, l)``,
    l the leaf's place in sorted-key order), the whole draw's slice to
    the bit.  ``a`` is a float or a 0-d tensor on the
    gradients' device.  ``stats_impl='kernels'`` takes the statistics from
    the moments kernel.  ``reduce_dtype`` superposes in that dtype (the
    side information stays fp32).

    ``cut`` (a ``sharding.CutLayout``; with ``ctx`` on a mesh of model > 1)
    says which leaves of ``grads`` are this model rank's shards of a cut
    leaf: the statistics are then the whole client's (``cut_stats``), and
    the noise is the whole tree's (drawn or injected at the whole leaves'
    shapes), each leaf's shard taken by ``cut.piece``; from
    ``noise_seed``, each rank draws its shard's regions alone
    (``cut.regions``).  Each shard folds
    over ``data`` as a whole leaf does.

    Returns the update direction y, the same on every rank (of a model
    rank's shard: the same on every data rank)."""
    from repro_torch.core import ota
    sch = schemes.validate_config(scheme, grad_bound)
    if stats_impl not in STATS_IMPLS:
        raise ValueError(f"unknown stats_impl {stats_impl!r}; one of "
                         f"{STATS_IMPLS}")
    if group is not None and ctx is not None:
        raise ValueError("ota_psum takes a group or a ctx, not both")
    if noise_seed is not None and (ctx is None or noise is not None
                                   or generator is not None):
        raise ValueError("noise_seed is a training mesh's stream: it takes "
                         "a ctx, and no generator or injected noise")
    if ctx is not None:
        k_total, me = ctx.size(axis), ctx.coord(axis)

        def psum(t):
            return ctx.fold(t, axis)
    else:
        k_total, me = (torch.distributed.get_world_size(group),
                       client_index(group))

        def psum(t):
            return _all_reduce(t, group)

    def psum_tree(tree):
        """The sum of every leaf, each leaf dropped from ``tree`` as it is
        summed (a fold's stack is the size of one leaf's)."""
        return {k: psum(tree.pop(k)).float() for k in sorted(tree)}

    if sch.baseline:
        inv = 1.0 / k_total
        return psum_tree(schemes.tree_map(lambda l: l.float() * inv, grads))

    hk = h[me].float()
    bk = b[me].float()
    hk_hat = hk if h_hat is None else h_hat[me].float()
    if cut is not None:
        stats = cut_stats(grads, sch, stats_impl, ctx, cut)
    elif stats_impl == "kernels":
        stats = _local_stats_kernels(grads, sch)
    else:
        stats = schemes.compute_stats(grads, sch, batched=False)
    # h_k b_k in the per-device scale: the sum below IS eq. (10)
    x = schemes.transform(sch, grads, stats, grad_bound, batched=False,
                          extra_scale=hk * bk, out_dtype=torch.float32)
    if reduce_dtype is not None:
        x = schemes.tree_map(lambda l: l.to(reduce_dtype), x)
    y = psum_tree(x)
    if noise_seed is not None and schemes.maybe_positive(noise_var):
        y = _seeded_noise(y, noise_seed, math.sqrt(noise_var), a, cut,
                          inplace=not ctx.shares_folds)
    else:
        first = next(iter(y.values()))
        shapes = (cut.full if cut is not None
                  else {k: v.shape for k, v in y.items()})
        z = ota.channel_noise(noise_var, shapes, first.device, generator,
                              noise)
        if z is not None:
            zt = ota.unravel(z, shapes)
            if cut is not None:
                zt = {k: cut.piece(k, v) for k, v in zt.items()}
            y = schemes.tree_map(lambda l, zl: l + zl, y, zt)
        y = schemes.tree_map(lambda l: a * l, y)

    if sch.server_post is None:
        return y
    folded = {}
    if sch.collect_side is not None:
        side = sch.collect_side(stats)
        names = [k for k, v in side.items() if isinstance(v, torch.Tensor)]
        w = hk_hat * bk
        # the server's hb mass and each weighted side sum: one all-reduce
        sums = psum(torch.stack([w] + [w * side[k].float() for k in names]))
        folded = {k: v for k, v in side.items() if k not in names}
        for i, k in enumerate(names):
            folded[k] = sums[i + 1] / (sums[0] + schemes.EPS)
    return sch.server_post(y, folded)


def _seeded_noise(y: dict, seed: int, sigma: float, a, cut, inplace: bool
                  ) -> dict:
    """``a (y + sigma z)`` leaf by leaf, z each leaf's draw from ``seed``
    (``kernels.ops.channel_noise``: leaf l keyed ``rng.noise_key(seed,
    l)``, the rank's piece of the whole leaf drawn alone); in place unless
    the folded leaves are shared with other ranks."""
    from repro_torch import rng
    from repro_torch.kernels import ops
    from repro_torch.kernels.channel_noise import piece_map
    out = {}
    for leaf, k in enumerate(sorted(y)):
        pmap = (piece_map(cut.full[k], cut.regions(k)) if cut is not None
                else piece_map(y[k].shape))
        out[k] = ops.channel_noise(y[k], rng.noise_key(seed, leaf), sigma,
                                   a, pmap, inplace=inplace)
    return out


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
