"""Mesh train-step builder (the port of ``repro/launch/train.py``): the
paper's OTA aggregation as the data-parallel gradient collective of a
transformer training step.

Two paths, as the reference's:

* ``scheme='mean'`` (or no aggregation axes) -- plain data parallelism:
  the gradient of the whole batch's mean loss.  Each data rank takes its
  rows, and its loss is its share of the whole batch's (its NLL sum over
  the folded mask count, its share of the MoE's aux losses; the MoE's
  dispatch is the whole batch's, as GSPMD's), so the ranks' gradients fold
  (``RankContext.fold``, in rank order) into the whole batch's.
* OTA schemes -- each data rank is one FL client: ``forward_loss`` and its
  gradient on the client's rows, then ``ota_psum`` over the ``data`` ranks
  (``ctx=``: the superposition a fold in rank order, the channel noise added
  once after it), its statistics from the moments kernel (K1, one launch a
  client; ``ota_stats_impl='kernels'``, the default), then the optimizer.

Each data rank's model is cut over the ``model`` ranks of its row
(``distribution.sharding.tp_plan`` / ``shard_params``), as the reference's
GSPMD cuts it inside each client: ``forward_loss`` runs one rank's shard,
its folds differentiable (``RankContext.enter``/``fold``), so a rank's
gradient is the gradient of its shard, and of a replicated leaf the whole
gradient, the same bits on every model rank.  The OTA statistics are the
whole client's (``ota_collectives.cut_stats``: the cut leaves' K1 row
folded over ``model``, the replicated leaves' row once), the noise the
whole tree's, each rank drawing its shard's piece (``sharding.
CutLayout``); a cut leaf's shard then folds over ``data`` as a whole leaf
does.  The mean path folds over ``data`` only.  So a ``(D, M)`` step is
the ``(D, 1)`` step up to the rounding of the model folds.

The pod axis (a ``(pod, data, model)`` mesh, ``launch.mesh``): the
batch's rows are cut over the flattened ``("pod", "data")`` axis (rank
``p * data + d``'s rows).  ``aggregation_axes=("pod", "data")`` makes
each (p, d) rank a client, its fold over the flattened axis: bitwise the
``(pod * data, model)`` mesh's step over ``data``.
``aggregation_axes=("pod",)`` makes each pod a client: its data ranks
split the pod's rows and fold its gradient over ``data`` in rank order
(as the mean path folds), then ``ota_psum`` runs over ``pod``.  The mean
path folds over ``("pod", "data")``, and FSDP cuts over it
(``fsdp_axis=("pod", "data")``), bitwise the flattened mesh's.

The builder returns ``(train_step, place)``, as the port's serving builders
do.  ``place(params, opt_state, batch)`` gives per-rank lists: each rank's
shard of the params and of the optimizer state, leaf for leaf (views of
the whole tensors; with ``model == 1`` the same tree on every rank), and
the batch's rows cut over ``data`` where they divide.  ``train_step(params,
opt_state, batch, gen_or_seed) -> (params, opt_state, metrics)`` runs
every rank this process holds (``distribution.tensor_parallel.run_ranks``:
physical ranks, or an emulated mesh in turn on one card, the same bits)
and takes and returns such lists; ``sharding.gather_params(params, mesh,
cfg, like)`` rebuilds the whole tree from them.  ``gen_or_seed`` seeds the
step's channel noise: an int is the step's seed, a ``torch.Generator``
gives it by one draw.  Each rank draws its own piece of each leaf on its
device, fused with the receiver gain (``ota_psum(noise_seed=)``, the
kernel ``kernels/csrc/channel_noise.cu``): element w of leaf l (in
sorted-key order) is ``sigma n(rng.noise_key(seed, l), w)``, w its flat
index in the whole leaf, so a piece is the whole draw's slice to the bit
and no rank holds the whole tree's noise.  ``noise=`` injects the noise
instead (the flat [N] vector of the whole leaves, in leaf order, each
rank taking its piece): ``draw_noise`` draws one on the host from a CPU
generator, and ``seeded_noise`` is the seeded stream's whole draw.

The metrics are 0-d device tensors: ``loss`` (the OTA path: the mean of the
clients' losses; the mean path: the whole batch's), ``nll`` and ``aux``
(the OTA path: the first local rank's client; the mean path: the whole
batch's) and, on the OTA path, ``grad_norm``, the first local rank's
client's whole gradient norm (on an emulated mesh client 0's; the
reference's ``P()`` out-spec returns one shard's).

FSDP (``fsdp_axis="data"``, the mean path): ``place`` cuts every leaf with
an ``F`` rule over ``data`` as well (``sharding.fsdp_dim``), params and
optimizer state alike (``sgd`` and ``adamw`` are elementwise, so a leaf's
state follows its slice).  A superblock gathers its cut leaves at its
entry, inside its checkpoint (``RankContext.unshard``); the gather's
backward folds their gradients over ``data`` in rank order and keeps the
rank's slice, so the step folds only the other leaves' gradients.  The
same operands fold in the same order and the update is elementwise, so
the step is bitwise the step without FSDP, slice for slice.  The
reference's plans never pair FSDP with an OTA scheme, which raises.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import schemes
from repro_torch.device import resolve_device
from repro_torch.distribution import ota_collectives as oc
from repro_torch.distribution import sharding as SH
from repro_torch.distribution.tensor_parallel import run_ranks
from repro_torch.launch.mesh import DP, ServingMesh
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import Optimizer, sgd
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten

PyTree = Any


@dataclasses.dataclass(frozen=True)
class OTARunParams:
    """Concrete per-run OTA parameters (from ``repro_torch.core.
    amplification``)."""
    h: Any                       # [K] channel draws
    b: Any                       # [K] amplification factors
    a: float = 1.0
    noise_var: float = 0.0
    grad_bound: Optional[float] = None
    # dtype of the superposition's sum ("bfloat16"; None: fp32, faithful)
    reduce_dtype: Optional[str] = None


def noise_seed(gen_or_seed) -> Optional[int]:
    """The step's noise seed: an int as it is, one draw of a
    ``torch.Generator`` (63 bits), None for none."""
    if gen_or_seed is None:
        return None
    if isinstance(gen_or_seed, torch.Generator):
        return int(torch.randint(0, 2 ** 63 - 1, (), generator=gen_or_seed,
                                 device=gen_or_seed.device))
    return int(gen_or_seed)


def seeded_noise(gen_or_seed, like: PyTree, noise_var: float,
                 device="cpu") -> torch.Tensor:
    """The whole tree's channel noise z [N] fp32 that a step seeded with
    ``gen_or_seed`` adds (``noise_seed``), in leaf order: the plain
    version of each leaf's draw (``kernels.ref.noise_draw_ref``), scaled
    by sqrt(noise_var) as the kernel scales it.  ``step(seed)`` is
    ``step(noise=seeded_noise(seed, ...))`` to the bit."""
    from repro_torch import rng
    from repro_torch.kernels import ref
    from repro_torch.kernels.channel_noise import piece_map
    seed = noise_seed(gen_or_seed)
    sigma = math.sqrt(noise_var)
    return torch.cat([
        ref.noise_draw_ref(rng.noise_key(seed, i), piece_map(l.shape))
        * sigma for i, l in enumerate(tree_leaves(like))]).to(device)


def draw_noise(gen: torch.Generator, like: PyTree, noise_var: float,
               device) -> torch.Tensor:
    """The step's channel noise z [N] fp32 on ``device``: one N(0,
    noise_var) draw a leaf of ``like`` in leaf order, on the CPU generator
    (the values ``schemes.add_channel_noise`` gives a zero tree of the
    flattened leaves), drawn into one host buffer and copied over once."""
    leaves = tree_leaves(like)
    buf = torch.empty((sum(l.numel() for l in leaves),), dtype=torch.float32)
    i = 0
    for l in leaves:
        torch.randn(l.shape, generator=gen, out=buf[i:i + l.numel()]
                    .view(l.shape))
        i += l.numel()
    return buf.mul_(math.sqrt(noise_var)).to(device)


def _cut(batch: dict, index: int, parts: int) -> dict:
    """Part ``index`` of ``parts`` of every tensor of a batch dict, cut
    along its rows."""
    per = next(iter(batch.values())).shape[0] // parts
    return {k: v[index * per:(index + 1) * per] for k, v in batch.items()}


def _divides(mesh: ServingMesh, axis, rows: int) -> bool:
    return mesh.axis_size(axis) > 1 and rows % mesh.axis_size(axis) == 0


def _rows(mesh: ServingMesh, batch: dict, rank: int, outer, inner
          ) -> Tuple[dict, bool]:
    """A rank's rows of a batch dict and whether they were cut over
    ``inner``: first its client's rows, cut over the ``outer`` (client)
    axis, then its part of those over ``inner`` (the ranks that split a
    client's rows and fold its gradient), each cut where it divides the
    rows (else every rank along it takes them all, as the reference's
    sanitized batch spec).  Both cut on a (pod, data, model) mesh is the
    cut over the flattened ``("pod", "data")``."""
    rows = dict(batch)
    if outer is not None and _divides(mesh, outer, _n_rows(rows)):
        rows = _cut(rows, mesh.axis_index(rank, outer),
                    mesh.axis_size(outer))
    split = inner is not None and _divides(mesh, inner, _n_rows(rows))
    if split:
        rows = _cut(rows, mesh.axis_index(rank, inner),
                    mesh.axis_size(inner))
    return rows, split


def _n_rows(batch: dict) -> int:
    return next(iter(batch.values())).shape[0]


class RankBatches(list):
    """``place``'s per-rank batches, and whether their rows were cut over
    the ranks that fold a gradient (else each holds its client's whole
    rows)."""

    def __init__(self, rows, split: bool):
        super().__init__(rows)
        self.split = split


def _with_grad(params: PyTree) -> PyTree:
    """The params as fresh leaves that require grad (storage shared)."""
    return tree_map(lambda t: t.detach().requires_grad_(), params)


def _value_and_grad(loss_fn, params: PyTree):
    """(loss, metrics, gradient leaves in ``jax.tree_util`` order) of
    ``loss_fn(params)``; a leaf the loss does not read gets zeros, as
    ``jax.grad`` gives (seamless's encoder: its decoder never reads it)."""
    leaves = _with_grad(params)
    loss, metrics = loss_fn(leaves)
    flat = tree_leaves(leaves)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = tuple(torch.zeros_like(l) if g is None else g
                  for l, g in zip(flat, grads))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _client_grads(cfg, ctx, params, rows, count=None):
    """One rank's (loss, metrics, gradient leaves) of ``forward_loss`` on
    its rows: over its model shard where the model is cut, the MoE's
    dispatch the whole batch's where the rows are (``ctx.batch_split``);
    the forward's collectives recorded for the checkpoints' recomputes."""
    tp = (ctx if ctx.model > 1 or ctx.batch_split or ctx.fsdp_axis
          else None)
    with ctx.recorded():
        return _value_and_grad(lambda q: T.forward_loss(
            q, cfg, rows, count=count, tp=tp), params)


def build_train_step(cfg: ModelConfig, mesh: Optional[ServingMesh], *,
                     scheme: str = "normalized",
                     aggregation_axes: Optional[Sequence[str]] = None,
                     fsdp_axis: Optional[str] = None,
                     ota: Optional[OTARunParams] = None,
                     optimizer: Optional[Optimizer] = None,
                     ota_stats_impl: str = "kernels", device="cuda"):
    """Returns ``(train_step, place)`` (module doc).  ``mesh`` is a
    ``launch.mesh`` mesh of ``(data, model)`` or ``(pod, data, model)``
    ranks (None: one rank).  The FL clients are the ranks along
    ``aggregation_axes`` (module doc: ``("data",)``, or on a mesh with a
    pod axis ``("pod", "data")`` or ``("pod",)``), each cut over its
    ``model`` ranks.  The params must be on ``device``; the step moves each
    rank's rows there."""
    dev = resolve_device(device)
    mesh = mesh if mesh is not None else ServingMesh(1, 1)
    opt = optimizer or sgd(1e-2)
    mean = scheme == "mean" or not aggregation_axes
    fsdp = _check_fsdp(mesh, fsdp_axis, mean)
    outer, inner = row_axes(mesh, scheme, aggregation_axes)
    if mean:
        return (_mean_step(cfg, mesh, opt, dev, fsdp),
                _placer(mesh, cfg, fsdp, outer, inner))
    if ota is None:
        raise ValueError("OTA schemes need OTARunParams")
    schemes.validate_config(scheme, ota.grad_bound)
    return (_ota_step(cfg, mesh, opt, dev, scheme, ota, ota_stats_impl,
                      outer, inner),
            _placer(mesh, cfg, None, outer, inner))


def row_axes(mesh: ServingMesh, scheme: str, aggregation_axes):
    """(outer, inner): the axes a train step cuts its batch's rows over
    (``_rows``).  The mean path: no clients, every rank along the batch
    axes (``data``, or ``("pod", "data")``) splits the rows and folds the
    gradient.  An OTA scheme: the clients' axis (``_client_axis``), and
    under ``("pod",)`` the pod's ``data`` ranks, which split its rows."""
    if scheme == "mean" or not aggregation_axes:
        return None, mesh.canonical(DP)
    clients = _client_axis(mesh, tuple(aggregation_axes))
    return clients, "data" if clients == "pod" else None


def _client_axis(mesh: ServingMesh, axes: tuple):
    """The FL clients' axis of ``aggregation_axes``: ``data`` on a mesh
    without a pod axis; ``("pod", "data")`` (a client a (p, d)) or
    ``pod`` (a client a pod, its data ranks splitting its rows) on one
    with a pod axis."""
    allowed = ((("pod", "data"), ("pod",)) if mesh.pod > 1
               else (("data",),))
    if axes not in allowed:
        raise ValueError(
            f"aggregation_axes {axes}: the FL clients are the data ranks, "
            "pass ('data',); on a mesh with a pod axis ('pod', 'data') or "
            f"('pod',) (this mesh: {mesh.axis_names})")
    return mesh.canonical(axes)


def _check_fsdp(mesh: ServingMesh, fsdp_axis, mean: bool):
    """FSDP runs over the batch's axes on the mean path: ``data``, or
    ``("pod", "data")`` on a mesh with a pod axis; the rest raises.
    Returns the axis as the mesh names it (None without FSDP)."""
    if fsdp_axis is None:
        return None
    axis = tuple(fsdp_axis) if isinstance(fsdp_axis, (tuple, list)) \
        else fsdp_axis
    want = DP if mesh.pod > 1 else "data"
    if axis != want:
        raise ValueError(
            f"fsdp_axis={axis!r}: FSDP cuts over the 'data' axis, or over "
            "('pod', 'data') on a mesh with a pod axis (this mesh: "
            f"{mesh.axis_names})")
    if not mean:
        raise NotImplementedError(
            "fsdp_axis with an OTA scheme: the reference's plans never pair "
            "them (XLA cannot partition FSDP under the client shard_map: "
            "src/repro/launch/dryrun.py:53-60, tests/test_distribution.py:"
            "269); FSDP runs on the mean path (scheme='mean')")
    return mesh.canonical(axis)


def _placer(mesh: ServingMesh, cfg: ModelConfig, fsdp_axis=None,
            outer=None, inner=None):
    def shard(tree, rank):
        if (mesh.model == 1 and fsdp_axis is None) or tree is None \
                or isinstance(tree, torch.Tensor):
            return tree
        return SH.shard_params(tree, mesh, rank, cfg, fsdp_axis)

    def place(params=None, opt_state=None, batch=None):
        """Per-rank lists of the ranks this process runs: each rank's shard
        of the params and of the optimizer state, leaf for leaf (updates
        are functional; with FSDP also cut over ``data``), the batch's rows
        cut over the clients and the ranks that split them
        (``_rows``)."""
        ranks = mesh.local_ranks
        rows = None
        if batch is not None:
            cut = [_rows(mesh, batch, r, outer, inner) for r in ranks]
            rows = RankBatches([c[0] for c in cut], cut[0][1])
        return ([shard(params, r) for r in ranks],
                None if opt_state is None else
                [type(opt_state)(*(shard(f, r) for f in opt_state))
                 for r in ranks],
                rows)
    return place


def _rank_batches(mesh, place, batch, inner) -> RankBatches:
    """The step's per-rank batches: a whole batch dict is cut as ``place``
    cuts it (a plain list of per-rank batches counts as cut over
    ``inner``)."""
    if isinstance(batch, dict):
        return place(batch=batch)[2]
    if not isinstance(batch, RankBatches):
        return RankBatches(batch, inner is not None
                           and mesh.axis_size(inner) > 1)
    return batch


def _split_grads(ctx, rows, split: bool, inner, dev, cfg, params,
                 folded=None):
    """(loss, metrics, gradient leaves) of the rows of the ranks along
    ``inner`` (with ``split``: each rank's own rows, its loss its share of
    theirs, the mask count, the loss, the metrics and every gradient leaf
    but the ``folded`` ones folded over ``inner`` in rank order)."""
    ctx.batch_split = split
    if inner is not None:
        ctx.batch_axis = inner
    count = None
    if split:
        mask = rows.get("loss_mask")
        mine = (torch.sum(mask.float()) if mask is not None else
                torch.full((), float(rows["labels"].numel()), device=dev))
        count = ctx.fold(mine, inner)
    loss, metrics, grads = _client_grads(cfg, ctx, params, rows, count)
    if split:
        grads = [g if folded is not None and folded[f"{i:05d}"] is not None
                 else ctx.fold(g, inner) for i, g in enumerate(grads)]
        loss = ctx.fold(loss, inner)
        metrics = {k: ctx.fold(v, inner) for k, v in metrics.items()}
    return loss, metrics, grads


def _layout(cfg, mesh, params, rank):
    """The ``CutLayout`` of a rank's shard (None on one model rank)."""
    return (SH.CutLayout(params, cfg, mesh, rank) if mesh.model > 1
            else None)


def _ota_step(cfg, mesh, opt, dev, scheme, ota, stats_impl, clients, inner):
    h = torch.as_tensor(np.asarray(ota.h, np.float32), device=dev)
    b = torch.as_tensor(np.asarray(ota.b, np.float32), device=dev)
    reduce_dtype = (getattr(torch, ota.reduce_dtype)
                    if isinstance(ota.reduce_dtype, str) else ota.reduce_dtype)
    place = _placer(mesh, cfg, None, clients, inner)

    def train_step(params, opt_state, batch, gen_or_seed=None, *,
                   noise: Optional[torch.Tensor] = None):
        batch = _rank_batches(mesh, place, batch, inner)
        seed = None if noise is not None else noise_seed(gen_or_seed)

        def program(ctx):
            p, o = params[ctx.index], opt_state[ctx.index]
            rows = {k: v.to(dev) for k, v in batch[ctx.index].items()}
            lay = _layout(cfg, mesh, p, ctx.rank)
            loss, metrics, grads = _split_grads(ctx, rows, batch.split,
                                                inner, dev, cfg, p)
            flat = tree_flatten(grads)
            del grads
            grad_norm = torch.sqrt(oc.tree_sq_norm(flat) if lay is None
                                   else oc.tree_sq_norm_cut(flat, ctx, lay))
            y = oc.ota_psum(flat, scheme=scheme, ctx=ctx, axis=clients,
                            h=h, b=b, a=ota.a,
                            noise_var=ota.noise_var, noise=noise,
                            noise_seed=seed,
                            grad_bound=ota.grad_bound,
                            reduce_dtype=reduce_dtype, stats_impl=stats_impl,
                            cut=lay)
            del flat
            new_p, new_o = opt.update(tree_unflatten(p, y), o, p)
            del y
            loss_all = ctx.fold(loss, clients) / ctx.size(clients)
            return new_p, new_o, dict(metrics, loss=loss_all,
                                      grad_norm=grad_norm)

        outs = run_ranks(mesh, program)
        return ([o[0] for o in outs], [o[1] for o in outs], outs[0][2])

    return train_step


def _mean_step(cfg, mesh, opt, dev, fsdp_axis=None):
    dp = mesh.canonical(DP)
    place = _placer(mesh, cfg, fsdp_axis, None, dp)

    def train_step(params, opt_state, batch, gen_or_seed=None):
        batch = _rank_batches(mesh, place, batch, dp)
        # which leaves the gather's backward has folded over ``data``
        gathered = None
        if fsdp_axis is not None:
            gathered = SH.CutLayout(params[0], cfg, mesh, mesh.local_ranks[0],
                                    fsdp_axis).fsdp

        def program(ctx):
            p, o = params[ctx.index], opt_state[ctx.index]
            rows = {k: v.to(dev) for k, v in batch[ctx.index].items()}
            ctx.fsdp_axis = fsdp_axis
            loss, metrics, grads = _split_grads(ctx, rows, batch.split, dp,
                                                dev, cfg, p, gathered)
            new_p, new_o = opt.update(
                tree_unflatten(p, tree_flatten(grads)), o, p)
            return new_p, new_o, dict(metrics, loss=loss)

        outs = run_ranks(mesh, program)
        return ([o[0] for o in outs], [o[1] for o in outs], outs[0][2])

    return train_step


def instrument_train_step(step_fn, recorder, *, manifest=None):
    """Wrap a built ``train_step`` with host-side flight recording.

    Returns a drop-in replacement with the same signature.  Each call is
    timed, annotated for the profiler (``obs.profiling.annotate_chunk``)
    and emitted to ``recorder`` as one chunk and one round event carrying
    the step's metrics as host floats.  Recording happens strictly after
    the step returns, on host copies: params and optimizer state pass
    through untouched, so the trajectory is bitwise the same with or
    without the wrapper.  The metrics' transfer synchronises the host with
    the card every step; leave the wrapper off for pure-throughput runs."""
    from repro_torch.obs import profiling as obsprof

    if manifest is not None:
        recorder.on_manifest(manifest)
    counter = [0]

    def instrumented(params, opt_state, batch, gen_or_seed=None, **kw):
        i = counter[0]
        counter[0] += 1
        t0 = time.perf_counter()
        with obsprof.annotate_chunk(i):
            params, opt_state, metrics = step_fn(params, opt_state, batch,
                                                 gen_or_seed, **kw)
            host = {k: np.asarray(torch.as_tensor(v).detach().double()
                                  .reshape(-1)[:1].cpu())
                    for k, v in metrics.items()}
        recorder.on_chunk(i, [i], host,
                          wall_time_s=time.perf_counter() - t0,
                          dispatches=1, rss_mb=obsprof.rss_mb())
        return params, opt_state, metrics

    return instrumented


def make_batch_from_specs(specs, cfg: ModelConfig) -> dict:
    """Turn concrete model inputs (``configs.registry.input_specs``
    layout) into a loss-ready batch dict.

    When ``labels`` are absent they default to the shifted-token convention
    ``forward_loss`` expects for next-token training: position i predicts
    token i+1, and the final position (which has no target) is excluded
    through ``loss_mask``.  A caller's ``loss_mask`` is combined with the
    shift mask rather than overwritten."""
    batch = dict(specs)
    if "labels" not in batch and "tokens" in batch:
        tokens = torch.as_tensor(batch["tokens"])
        batch["labels"] = torch.cat(
            [tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
        shift = torch.cat(
            [torch.ones(tokens[:, 1:].shape, dtype=torch.float32,
                        device=tokens.device),
             torch.zeros(tokens[:, :1].shape, dtype=torch.float32,
                         device=tokens.device)], dim=1)
        prior = batch.get("loss_mask")
        batch["loss_mask"] = (shift if prior is None else
                              shift * torch.as_tensor(prior).float())
    return batch
