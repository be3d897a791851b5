"""Placement: the parameter, batch and cache specs of the serving mesh,
the cut of a full tensor into one rank's shard, the experiment axis of the
batched sweep engine, and the FL-device mesh of the sharded streaming
engine (the port of ``repro/distribution/sharding.py``).

**Specs.**  A spec (``Spec``) is a tuple with one entry a dim: a mesh axis
name, a tuple of them, or None (the port's counterpart of
``PartitionSpec``).  ``param_specs`` gives one for every parameter leaf by
its name (``_RULES``; the expert stacks under ``moe`` by ``_MOE_RULES``), a
``None`` put in front where a leaf carries the leading superblock-stack
axis; ``sanitize_spec`` drops an axis from a dim it does not divide;
``batch_specs`` and ``cache_specs`` do the same for a batch and a decode
cache.  They are the reference's specs, leaf for leaf.

**The cut.**  Where the reference hands the specs to GSPMD
(``jax.device_put(params, named_shardings(...))``), the port cuts each full
tensor to one rank's shard (``shard_params``, ``shard_cache``) and its
model code runs on the shards (``repro_torch.distribution.tensor_parallel``).
A hand-written tensor-parallel model cannot take every cut that GSPMD could
make blindly, so the cut follows the specs with these changes
(``tp_plan``):

* ``in_proj`` holds ``[u | z]`` (the mixer splits its output in two halves),
  so a rank's shard is its slice of each half, not a contiguous slice of
  the 2 d_inner columns;
* the attention projections are cut by head.  Where the kv heads do not
  divide over the model axis, ``wk``/``wv`` (and ``bk``/``bv``) stay whole
  on every rank even where their column count divides (reduced qwen2:
  Hkv dh = 128 over 4 ranks would cut a head in two), and each rank takes
  the kv heads of its own q heads; where the q heads do not divide, the
  whole attention stays replicated;
* a module whose cut dim does not divide over the model axis (d_ff, the
  experts, d_inner, the vocabulary) stays whole on every rank;
* the xLSTM cell (``cell``: mLSTM and sLSTM) is cut with the heads, and
  its ``up`` holds ``[u | z]`` as ``in_proj`` does (``HALVES``).

**FSDP.**  With ``fsdp_axis`` (the train step's ``data``, or ``("pod",
"data")`` on the multi-pod mesh) a leaf whose rule
has ``F`` is cut along that dim over the axis as well, on top of its model
cut, where the axis divides the whole dim (``fsdp_dim``: ``sanitize_spec``'s
rule, read from the config, so that it holds for a shard too); ``tok``
keeps the reference's rule and is not cut.  A plain cut: ``in_proj`` and
``up`` are cut in halves on the model axis only.

A rank of a ``(data, model)`` mesh is ``d * model + m``, of a ``(pod,
data, model)`` mesh ``(p * data + d) * model + m``; a spec entry that is a
tuple of axes (``("pod", "data")``: FSDP and the batch on the multi-pod
mesh) cuts its dim over their product, row-major.

**The experiment axis.**  ``experiment_mesh`` / ``shard_experiment_axis``
serve ``repro_torch.fed.runtime.run_batched(shard=True)``: a batched grid of
experiments is parallel over its leading E axis, so where several local
devices exist each takes E / n whole experiments, with no collective.

**The FL-device mesh.**  ``device_mesh`` / ``shard_device_axis`` serve
``FLConfig.device_mesh`` and ``OTAConfig.device_mesh``: the K-blocked round
partitions its blocks over D shards, each shard left-folds its own
contiguous run of blocks, and one deterministic cross-shard combine
(``ota_collectives.fold_shards``) closes eq. (10).  A shard is one rank of
a ``torch.distributed`` process group, each rank on the device its caller
puts it on (one card a rank, or the CPU under ``gloo``); the mesh never
picks a device itself.  ``device_mesh(D)`` hands out the default process
group when it holds exactly D ranks, and None otherwise: the caller then
runs the same shards one after another in one process (the emulated
path), bitwise the same result.  The reference asks for at least D local
devices instead; one rank a shard is what ``torch.distributed`` gives.
"""
from __future__ import annotations

import functools
import os
import warnings
from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch

EXPERIMENT_AXIS = "exp"
FL_DEVICE_AXIS = "fldev"

# REPRO_FL_MESH=emulate forces the emulated path even where a group of D
# ranks exists (the parity tests' lever).  Read when a round body or an
# aggregate is built: flip it before a config's first run, or call
# ``runtime.clear_compile_caches()`` after
_EMULATE_ENV = "REPRO_FL_MESH"


# ---------------------------------------------------------------------------
# the experiment axis


class ExperimentMesh(NamedTuple):
    """A 1-D mesh over the local devices of one process: E / n experiments
    a device."""
    devices: tuple
    axis_name: str = EXPERIMENT_AXIS


def experiment_mesh(num_experiments: int, *, axis_name: str = EXPERIMENT_AXIS,
                    devices=None, require: bool = False
                    ) -> Optional[ExperimentMesh]:
    """The mesh over the local devices (``torch.cuda.device_count()`` cards,
    or an explicit ``devices`` list) for spreading a batched run's
    experiment axis, or None where it would not help: one device, or a grid
    the device count does not divide (uneven shards).  None means the
    caller runs the whole batch on one device, as it would unsharded.

    ``require=True`` turns the fallback into a ``ValueError`` that says
    which precondition failed and how to fix it."""
    if num_experiments < 1:
        raise ValueError(
            f"num_experiments must be >= 1, got {num_experiments}")
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if len(devices) <= 1:
        if require:
            raise ValueError(
                f"experiment-axis sharding needs > 1 local device, have "
                f"{len(devices)} -- force host devices with devices=[...] "
                "(e.g. two 'cpu' entries) or drop require=True to run on "
                "one device")
        return None
    if num_experiments % len(devices) != 0:
        if require:
            raise ValueError(
                f"experiment count {num_experiments} does not divide over "
                f"{len(devices)} local devices (uneven shards would force "
                "padding) -- pad the grid to a multiple of the device count, "
                "pass a dividing subset as devices=, or drop require=True to "
                "run on one device")
        return None
    return ExperimentMesh(tuple(torch.device(d) for d in devices), axis_name)


def shard_experiment_axis(tree: Any, mesh: ExperimentMesh) -> list:
    """One tree a device of ``mesh``: every leaf's leading (experiment) axis
    cut in n contiguous runs, run i moved to device i; 0-d leaves are
    replicated.  The leaves must all carry E as their leading axis."""
    n = len(mesh.devices)

    def one(leaf, i):
        if leaf.dim() == 0:
            return leaf.to(mesh.devices[i])
        per = leaf.shape[0] // n
        return leaf[i * per:(i + 1) * per].to(mesh.devices[i])

    return [_map_leaves(lambda leaf, i=i: one(leaf, i), tree)
            for i in range(n)]


def _map_leaves(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


# ---------------------------------------------------------------------------
# the FL-device mesh


class DeviceMesh(NamedTuple):
    """A 1-D mesh of D ranks over the FL-device axis: the process group,
    its size and this process's rank in it."""
    group: Any
    size: int
    rank: int
    axis_name: str = FL_DEVICE_AXIS


def _world_size() -> int:
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    return dist.get_world_size()


def device_mesh(num_shards: int, *,
                axis_name: str = FL_DEVICE_AXIS) -> Optional[DeviceMesh]:
    """The mesh of the default process group when it holds exactly
    ``num_shards`` ranks, else None (one shard, no group, a group of another
    size, or ``REPRO_FL_MESH=emulate``): the caller then runs the emulated
    path, bitwise the same."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if os.environ.get(_EMULATE_ENV, "") == "emulate":
        return None
    if num_shards == 1 or _world_size() != num_shards:
        return None
    dist = torch.distributed
    return DeviceMesh(dist.group.WORLD, num_shards, dist.get_rank(),
                      axis_name)


def shard_device_axis(tree: Any, mesh: DeviceMesh) -> Any:
    """This rank's shard of every leaf of ``tree``: row ``mesh.rank`` of the
    leading (shard) axis, which every leaf carries (the [D, nb/D, ...]
    blocked inputs of the sharded round); 0-d leaves are replicated and
    pass as they are."""
    return _map_leaves(lambda t: t if t.dim() == 0 else t[mesh.rank], tree)


# ---------------------------------------------------------------------------
# specs


class Spec(tuple):
    """One entry a dim: a mesh axis name, a tuple of names (the dim cut over
    their product), or None (replicated).  ``Spec()`` replicates a leaf.
    As ``PartitionSpec`` does, a one-name tuple is kept as the name and an
    empty one as None."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            (e[0] if len(e) == 1 else e or None) if isinstance(e, tuple)
            else e for e in entries))

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


# name -> spec WITHOUT the stack axis; 'M' = model axis, 'F' = fsdp axis
_RULES = {
    # embeddings.  The token table is not fsdp-sharded (the reference works
    # around an XLA partitioner failure there; the rule is kept as it is)
    "tok": ("M", None),           # vocab-sharded embedding table
    "unemb": ("F", "M"),
    "modal_proj": (None, "M"),
    # attention
    "wq": ("F", "M"), "wk": ("F", "M"), "wv": ("F", "M"),
    "bq": ("M",), "bk": ("M",), "bv": ("M",),
    "wo": ("M", "F"),
    # dense mlp (rank-2) / moe experts (rank-3) share names; see _spec_for
    "w_gate": ("F", "M"), "w_up": ("F", "M"), "w_down": ("M", "F"),
    "router": (None, None),
    # mamba
    "in_proj": ("F", "M"), "out_proj": ("M", "F"),
    "conv_w": (None, "M"), "conv_b": ("M",),
    "x_proj": ("M", None), "dt_proj_w": (None, "M"), "dt_proj_b": ("M",),
    "A_log": ("M", None), "D": ("M",),
    # xlstm
    "up": ("F", "M"), "down": ("M", "F"),
    "ogate": (None, "M"),
    "wi": ("M", None), "wf": ("M", None), "bi": (None,), "bf": (None,),
    "w_gates": ("M", None),
    "r_gates": (None, None, None, None),
    "b_gates": (None,),
    # norms
    "scale": (None,),
}

_MOE_RULES = {  # rank-3 expert-stacked weights: experts over the model axis
    "w_gate": ("M", "F", None), "w_up": ("M", "F", None),
    "w_down": ("M", None, "F"),
}


def _ndim(leaf) -> int:
    return len(leaf.shape)


def _resolve(symbolic, model_axis, fsdp_axis) -> tuple:
    return tuple(model_axis if s == "M" else fsdp_axis if s == "F" else None
                 for s in symbolic)


def _spec_for(name: str, parents: tuple, ndim: int, model_axis: str,
              fsdp_axis: Optional[str]) -> Spec:
    rule = _RULES.get(name)
    if name in _MOE_RULES and "moe" in parents:   # expert-stacked weights
        rule = _MOE_RULES[name]
    if rule is None:
        return Spec()
    spec = _resolve(rule, model_axis, fsdp_axis)
    if ndim == len(spec) + 1:      # leading superblock-stack axis
        spec = (None,) + spec
    elif ndim != len(spec):
        return Spec()              # unknown layout: replicate (safe default)
    return Spec(*spec)


def _map_named(fn: Callable, tree, names: tuple = ()):
    """``fn(names, leaf)`` over the leaves of a tree of dicts, tuples and
    lists; ``names`` are the dict keys on the path (a tuple's index is not
    one, as the reference reads only its ``DictKey`` entries)."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, names + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, Spec):
        return type(tree)(_map_named(fn, v, names) for v in tree)
    return fn(names, tree)


def param_specs(params, *, model_axis: str = "model",
                fsdp_axis: Optional[str] = None):
    """The spec tree of a model parameter tree (its leaves anything with a
    ``shape``: tensors, arrays)."""
    def one(names, leaf):
        name = names[-1] if names else ""
        return _spec_for(name, tuple(names[:-1]), _ndim(leaf), model_axis,
                         fsdp_axis)
    return _map_named(one, params)


# (axes, size, dim) drops sanitize_spec has already warned about: each
# distinct drop is reported once a process, not once a leaf a call
_SANITIZE_WARNED: set = set()


def sanitize_spec(mesh, spec: Spec, shape) -> Spec:
    """Drop mesh axes from dims they do not divide (e.g. vocab 256206 on a
    16-way model axis): replicating such a dim is always legal.  Each
    distinct drop warns once a process (``UserWarning``)."""
    out = []
    for d, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        if d < len(shape) and shape[d] % size == 0:
            out.append(entry)
        else:
            dim = shape[d] if d < len(shape) else None
            sig = (axes, size, dim)
            if sig not in _SANITIZE_WARNED:
                _SANITIZE_WARNED.add(sig)
                what = (f"dim {d} of size {dim}" if dim is not None
                        else f"dim {d} (beyond the leaf's rank {len(shape)})")
                warnings.warn(
                    f"sanitize_spec: mesh axes {axes} (size {size}) do not "
                    f"divide {what}; replicating that dim instead. "
                    "Expected for known-ragged dims (e.g. an odd vocab); if "
                    "this dim was meant to shard, fix the rule or pad the "
                    "dim. (warned once per distinct drop)",
                    UserWarning, stacklevel=2)
            out.append(None)
    return Spec(*out)


def named_shardings(mesh, spec_tree, like_tree=None):
    """The placement of a spec tree: with ``like_tree`` given, each spec
    sanitized against its leaf's shape (the specs that ``shard_params`` and
    ``shard_cache`` cut by).  The counterpart of the reference's
    ``NamedSharding`` tree."""
    if like_tree is None:
        return spec_tree
    leaves = []
    _map_named(lambda n, leaf: leaves.append(leaf), like_tree)
    it = iter(leaves)
    return _map_named(lambda n, s: sanitize_spec(mesh, s, next(it).shape),
                      spec_tree)


def batch_specs(batch_like, axes):
    """Shard the leading (batch) dim of every batch leaf over ``axes``;
    scalars (e.g. ``pos``) replicate."""
    def one(names, leaf):
        if _ndim(leaf) == 0:
            return Spec()
        return Spec(tuple(axes))
    return _map_named(one, batch_like)


def cache_specs(cache_like, *, batch_axes, model_axis: str, num_kv_heads: int,
                model_size: int, seq_axis: Optional[str] = None):
    """Decode-cache specs, name-keyed like ``param_specs``.

    KV caches [n_sb,B,S,Hkv,dh] shard batch over ``batch_axes``, kv heads
    over ``model_axis`` when they divide (and the sequence over
    ``seq_axis``, the context-parallel long-decode path); recurrent states
    shard batch and their big feature dim over the model axis."""
    kv_ok = num_kv_heads % model_size == 0
    b_ax = tuple(batch_axes) if batch_axes else None

    def spec_for(name: str, nd: int) -> Spec:
        if name in ("k", "v") and nd == 5:
            return Spec(None, b_ax, seq_axis, model_axis if kv_ok else None,
                        None)
        if name == "ssm" and nd == 4:       # [n_sb, B, di, N]
            return Spec(None, b_ax, model_axis, None)
        if name == "conv" and nd == 4:      # [n_sb, B, K-1, di]
            return Spec(None, b_ax, None, model_axis)
        if name == "C" and nd == 5:         # [n_sb, B, H, dh, dh] mlstm memory
            return Spec(None, b_ax, None, model_axis, None)
        if name == "n" and nd == 4:         # [n_sb, B, H, dh] mlstm normalizer
            return Spec(None, b_ax, None, model_axis)
        if nd == 3:                         # [n_sb, B, di] slstm states
            return Spec(None, b_ax, model_axis)
        return Spec()

    return _map_named(lambda names, leaf: spec_for(
        names[-1] if names else "", _ndim(leaf)), cache_like)


# ---------------------------------------------------------------------------
# the tensor-parallel cut


class TPPlan(NamedTuple):
    """Which modules a model of ``cfg`` cuts over a model axis of ``model``
    ranks; a module that is not cut runs whole on every rank."""
    model: int
    heads: bool      # attention: q heads (wq, bq, wo rows); the xLSTM cell
    kv: bool         # attention: kv heads (wk, wv, bk, bv and the kv cache)
    mlp: bool        # dense MLP: d_ff
    experts: bool    # MoE: the expert stacks
    mamba: bool      # Mamba: d_inner
    vocab: bool      # tok rows, unemb columns


@functools.lru_cache(maxsize=None)
def tp_plan(cfg, model: int) -> TPPlan:
    heads = cfg.num_heads % model == 0
    return TPPlan(
        model=model, heads=heads,
        kv=heads and cfg.num_kv_heads % model == 0,
        mlp=cfg.d_ff > 0 and cfg.d_ff % model == 0,
        experts=cfg.num_experts > 0 and cfg.num_experts % model == 0,
        mamba=cfg.mamba_d_inner % model == 0,
        vocab=cfg.vocab_size % model == 0)


# the module whose plan entry decides a leaf's cut, by (parent, name)
_MODULE_OF = {
    "attn": {"wq": "heads", "bq": "heads", "wo": "heads",
             "wk": "kv", "wv": "kv", "bk": "kv", "bv": "kv"},
    "mlp": {"w_gate": "mlp", "w_up": "mlp", "w_down": "mlp"},
    "moe": {"w_gate": "experts", "w_up": "experts", "w_down": "experts"},
    "mamba": {n: "mamba" for n in ("in_proj", "conv_w", "conv_b", "x_proj",
                                   "dt_proj_w", "dt_proj_b", "A_log", "D",
                                   "out_proj")},
    "emb": {"tok": "vocab", "unemb": "vocab"},
    # the xLSTM cells: the mLSTM's heads (and their features of u, z, h),
    # the sLSTM's features of u, z and h
    "cell": {n: "heads" for n in ("up", "wq", "wk", "wv", "ogate", "wi",
                                  "wf", "down", "w_gates")},
}

# leaves whose last dim holds two halves, each cut alone over the model axis
HALVES = ("in_proj", "up")


def _halves(names: tuple) -> bool:
    return bool(names) and names[-1] in HALVES


def fsdp_dim(names: tuple, ndim: int, cfg, data: int) -> Optional[int]:
    """The dim of a parameter leaf (``names`` its dict keys, ``ndim`` its
    rank) that FSDP cuts over a ``data`` axis of ``data`` ranks: its rule's
    ``F`` entry where ``data`` divides the whole dim (``sanitize_spec``'s
    rule), else None.  The whole dim is ``d_model`` for every ``F`` rule
    but the xLSTM cell's q/k/v, whose rows are its inner dim, 2 d_model."""
    name = names[-1] if names else ""
    spec = _spec_for(name, tuple(names[:-1]), ndim, "M", "F")
    if "F" not in spec:
        return None
    whole = (2 * cfg.d_model if len(names) > 1 and names[-2] == "cell"
             and name in ("wq", "wk", "wv") else cfg.d_model)
    return spec.index("F") if whole % data == 0 else None


def leaf_cut(names: tuple, spec: Spec, plan: TPPlan) -> Spec:
    """The spec a parameter leaf is cut by: its sanitized spec where the
    plan cuts its module, whole otherwise."""
    parent = names[-2] if len(names) > 1 else ""
    module = _MODULE_OF.get(parent, {}).get(names[-1] if names else "")
    if module is None or not getattr(plan, module):
        return Spec(*([None] * len(spec)))
    return spec


def with_fsdp(names: tuple, spec: Spec, cfg, mesh,
              fsdp_axis: Optional[str]) -> Spec:
    """A leaf's model cut ``spec`` with its ``fsdp_dim`` cut over
    ``fsdp_axis`` added (no ``fsdp_axis``: ``spec`` itself)."""
    if fsdp_axis is None:
        return spec
    dim = fsdp_dim(names, len(spec), cfg, axis_size(mesh, fsdp_axis))
    if dim is None:
        return spec
    return Spec(*(fsdp_axis if d == dim else e for d, e in enumerate(spec)))


def tp_param_specs(params, cfg, mesh, fsdp_axis: Optional[str] = None):
    """The cut of every parameter leaf on ``mesh``: ``param_specs``, whole
    where ``tp_plan`` keeps the module whole, and with ``fsdp_axis`` each
    leaf's ``fsdp_dim`` cut over it.  Within a module the plan cuts, every
    cut dim divides over the model axis (the plan asks it of the heads, kv
    heads, d_ff, experts, d_inner and vocabulary), so ``sanitize_spec``
    would drop nothing there, and the cut is read from the leaves' names
    and ranks alone: it holds for a full parameter tree and for one rank's
    shard of it alike."""
    plan = tp_plan(cfg, mesh.shape["model"])

    def one(names, leaf):
        spec = _spec_for(names[-1] if names else "", tuple(names[:-1]),
                         _ndim(leaf), "model", None)
        return with_fsdp(names, leaf_cut(names, spec, plan), cfg, mesh,
                         fsdp_axis)
    return _map_named(one, params)


def _named_leaves(tree, names: tuple = ()) -> list:
    """(names, leaf) of every leaf in ``repro_torch.tree.tree_leaves``'
    order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [nl for k in sorted(tree)
                for nl in _named_leaves(tree[k], names + (str(k),))]
    if isinstance(tree, (tuple, list)) and not isinstance(tree, Spec):
        return [nl for v in tree for nl in _named_leaves(v, names)]
    return [(names, tree)]


class CutLayout:
    """How one rank's shard of a parameter tree (or of a gradient, leaf for
    leaf) sits in the whole tree, by ``tree_flatten``'s names ("00000",
    ...): ``cut[name]`` whether the leaf is cut over the model axis,
    ``fsdp[name]`` its dim cut over ``fsdp_axis`` (or None), ``full[name]``
    the whole leaf's shape, ``piece(name, t)`` the rank's shard of a whole
    leaf ``t``.  Read from any rank's shard (its names and shapes: a cut
    dim's whole size is the shard's times its axis)."""

    def __init__(self, shard, cfg, mesh, rank: int,
                 fsdp_axis: Optional[str] = None):
        self.mesh, self.rank = mesh, rank
        specs = _named_leaves(tp_param_specs(shard, cfg, mesh, fsdp_axis))
        self.spec, self.halves, self.cut, self.full = {}, {}, {}, {}
        self.fsdp = {}
        for i, ((names, leaf), (_, spec)) in enumerate(
                zip(_named_leaves(shard), specs)):
            key = f"{i:05d}"
            self.spec[key] = spec
            self.halves[key] = _halves(names)
            self.cut[key] = "model" in spec
            self.fsdp[key] = (spec.index(fsdp_axis) if fsdp_axis
                              and fsdp_axis in spec else None)
            self.full[key] = tuple(n * (1 if e is None else
                                        axis_size(mesh, e))
                                   for n, e in zip(leaf.shape, spec))

    def piece(self, key: str, t: torch.Tensor) -> torch.Tensor:
        return cut_leaf(t, self.spec[key], self.mesh, self.rank,
                        halves=self.halves[key])

    def regions(self, key: str) -> list:
        """The index tuples of the whole leaf that the rank's shard holds,
        in the shard's order (``_regions``: one, or two for a halves
        leaf)."""
        return _regions(self.full[key], self.spec[key], self.mesh,
                        self.rank, self.halves[key])


def rank_coords(mesh, rank: int) -> dict:
    """Axis name -> this rank's index, row-major over the mesh's axes:
    rank = d * model + m, or (p * data + d) * model + m."""
    coords, rest = {}, rank
    for a in reversed(tuple(mesh.shape)):
        coords[a], rest = rest % mesh.shape[a], rest // mesh.shape[a]
    return coords


def axis_size(mesh, entry) -> int:
    """Ranks along a spec entry: one axis, or a tuple (their product)."""
    n = 1
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        n *= mesh.shape[a]
    return n


def _part(entry, mesh, coords) -> tuple:
    """(index, count) of a rank along a spec entry (one axis or several,
    row-major as the reference's meshes)."""
    axes = entry if isinstance(entry, tuple) else (entry,)
    index, count = 0, 1
    for a in axes:
        index = index * mesh.shape[a] + coords[a]
        count *= mesh.shape[a]
    return index, count


def _regions(shape, spec: Spec, mesh, rank: int, halves: bool) -> list:
    """The index tuples of the full tensor (of ``shape``) that rank
    ``rank``'s shard holds, in the order the shard holds them: one region,
    or two with ``halves`` (the rank's slice of each half of the last
    dim)."""
    coords = rank_coords(mesh, rank)
    region = [slice(None)] * len(shape)
    split = None
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        index, count = _part(entry, mesh, coords)
        if halves and d == len(shape) - 1:
            size = shape[d] // 2 // count
            split = (d, [slice(h * shape[d] // 2 + index * size,
                               h * shape[d] // 2 + (index + 1) * size)
                         for h in (0, 1)])
        else:
            size = shape[d] // count
            region[d] = slice(index * size, (index + 1) * size)
    if split is None:
        return [tuple(region)]
    d, parts = split
    return [tuple(region[:d] + [p] + region[d + 1:]) for p in parts]


def cut_leaf(t: torch.Tensor, spec: Spec, mesh, rank: int,
             halves: bool = False) -> torch.Tensor:
    """Rank ``rank``'s shard of the full tensor ``t`` under ``spec``: each
    cut dim in equal contiguous parts, part ``index`` kept (a view).
    ``halves=True`` cuts the last dim as two halves, each alone, and puts
    the rank's two slices side by side (``in_proj``'s ``[u | z]``)."""
    parts = [t[r] for r in _regions(t.shape, spec, mesh, rank, halves)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def gather_leaf(shards: Sequence[torch.Tensor], spec: Spec, mesh,
                halves: bool = False) -> torch.Tensor:
    """The full tensor from every rank's shard (rank order): the inverse of
    ``cut_leaf``, for the tests."""
    coords = rank_coords(mesh, 0)
    shape = list(shards[0].shape)
    for d, entry in enumerate(spec):
        if entry is not None:
            shape[d] *= _part(entry, mesh, coords)[1]
    full = shards[0].new_empty(shape)
    for r, shard in enumerate(shards):
        regions = _regions(shape, spec, mesh, r, halves)
        pieces = ([shard] if len(regions) == 1
                  else torch.chunk(shard, 2, dim=-1))
        for region, piece in zip(regions, pieces):
            full[region] = piece
    return full


def _zip_named(fn, tree, specs, names: tuple = ()):
    if isinstance(tree, dict):
        return {k: _zip_named(fn, v, specs[k], names + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_zip_named(fn, v, s, names)
                          for v, s in zip(tree, specs))
    return fn(names, tree, specs)


def shard_params(params, mesh, rank: int, cfg,
                 fsdp_axis: Optional[str] = None):
    """Rank ``rank``'s shard of a full parameter tree, cut by
    ``tp_param_specs`` (with ``fsdp_axis``: also over it): the counterpart
    of ``jax.device_put(params, named_shardings(...))``.  A contiguous cut
    is a view of the full tensor."""
    return _zip_named(
        lambda names, t, s: cut_leaf(t, s, mesh, rank,
                                     halves=_halves(names)),
        params, tp_param_specs(params, cfg, mesh, fsdp_axis))


def gather_params(shards: Sequence, mesh, cfg, like,
                  fsdp_axis: Optional[str] = None):
    """The full parameter tree from every rank's shard (rank order);
    ``like`` is a tree of the full shapes (its leaves anything with a
    ``shape``)."""
    specs = tp_param_specs(like, cfg, mesh, fsdp_axis)

    def walk(parts, spec, names=()):
        first = parts[0]
        if isinstance(first, dict):
            return {k: walk([p[k] for p in parts], spec[k], names + (k,))
                    for k in first}
        if isinstance(first, (tuple, list)):
            return type(first)(walk([p[i] for p in parts], spec[i], names)
                               for i in range(len(first)))
        return gather_leaf(parts, spec, mesh, halves=_halves(names))
    return walk(list(shards), specs)


def shard_cache(cache, mesh, rank: int, specs):
    """Rank ``rank``'s shard of a full decode cache under ``specs`` (the
    serve builders' cache cut; each leaf a copy, since decode writes into
    it in place)."""
    return _zip_named(
        lambda names, t, s: cut_leaf(t, s, mesh, rank).clone(), cache, specs)


def gather_cache(shards: Sequence, mesh, specs):
    """The full decode cache from every rank's shard (rank order)."""
    def walk(parts, spec):
        first = parts[0]
        if isinstance(first, dict):
            return {k: walk([p[k] for p in parts], spec[k]) for k in first}
        if isinstance(first, (tuple, list)):
            return type(first)(walk([p[i] for p in parts], spec[i])
                               for i in range(len(first)))
        return gather_leaf(parts, spec, mesh)
    return walk(list(shards), specs)
