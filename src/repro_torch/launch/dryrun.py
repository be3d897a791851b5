"""The dry run (the port of ``repro/launch/dryrun.py``): every
(architecture x input shape) on the production mesh, 16x16 = 256 H100s or
2x16x16 = 512, planned, run and counted with no card and no allocation.

For each pair this process plays **rank 0** of the production mesh: it
joins a fake process group of 256 or 512 ranks (``torch.distributed``'s
``fake`` backend, whose collectives move nothing), builds the mesh's
subgroups (``launch.mesh.make_production_mesh``: a physical mesh), cuts
the full-width parameters, optimizer state and batch to rank 0's shards
(the builders' own ``place``) and runs rank 0's train, prefill or decode
step on **meta tensors** (shapes and dtypes, no data).  Rank 0's program
is every rank's program up to the rank's coordinates (the port's cut is
even: a module whose dim does not divide over ``model`` stays whole on
every rank), so its counts are a rank's.  Meta tensors are on no card, so
every op takes its plain route (the kernels' wrappers take them on any
device but CUDA), and the counts are the same on a machine with a card.
The reference lowers and compiles its steps with XLA on 512 placeholder
devices instead; the port has no compiler to ask, so it counts what its
eager program dispatches:

* FLOPs: ``torch.utils.flop_counter``'s formulas (``flop_registry``, the
  ones ``FlopCounterMode`` sums) over every aten op;
* bytes accessed: the summed input and output bytes of every aten op that
  is not a view (what eager PyTorch touches; a fused program touches no
  more, so this bounds one from above);
* collective bytes: the per-rank output bytes of every collective the port
  makes (``distribution.ota_collectives.counting_collectives``: the
  all-gathers of ``RankContext.fold``, ``gather`` and ``unshard`` and the
  OTA path's), the reference's HLO convention;
* peak memory: the peak of the live bytes of the storages the step's ops
  create (a weak reference a storage), over the rank's resident bytes,
  and how many of them the recorded forward collectives hold there
  (the running ``RankContext``'s ``recorded_bytes`` at the peak).

The counting mode (``_Counter``, a ``TorchDispatchMode``) remembers each
functional op's output shapes and counts by its input signature and
answers a repeat without running the op's meta function: the counts are
the same, and a time-step loop (Mamba's and the sLSTM's plain scans) runs
several times faster.  FakeTensorMode would run the same step, but it runs
each op's decomposition through the modes above it, so a counting mode
would count those ops again (3.7x the bytes on reduced granite), and it is
~3x slower.

An eager count sees every step of every loop, so no correction is added
(the reference's ``analyze_one`` and its sLSTM correction make up for XLA
counting a loop body once).  ``analyze_one`` (depths 1 and 2 superblocks,
extrapolated to full depth) is the cheap mode, and it equals
``lower_one`` at full depth exactly (``tests/test_torch_dryrun.py``).

The fake group is private to torch (``torch.testing._internal.
distributed.fake_pg``), imported in ``fake_group`` alone.  It is the
default process group while a step is counted, and a group left behind
would make every later ``make_host_mesh`` physical: ``fake_group`` tears
it down in a ``finally``, and the CLI runs each pair in a process of its
own with ``--isolate``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --analysis --isolate
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod --out dryrun.json
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
import weakref
from typing import Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis import roofline as rl
from repro_torch.configs import registry as reg
from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.core import amplification as amp
from repro_torch.core import channel as chan
from repro_torch.distribution import ota_collectives as oc
from repro_torch.distribution import sharding as sh
from repro_torch.distribution import tensor_parallel as tp_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve as serve_lib
from repro_torch.launch import train as train_lib
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import sgd
from repro_torch.tree import tree_leaves

META = torch.device("meta")


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def plan_for(cfg: ModelConfig, shape: InputShape, mesh, scheme: str):
    """Aggregation axes, FSDP and context parallelism for one pair (the
    reference's plan, its DESIGN.md §5)."""
    multi_pod = "pod" in mesh.axis_names
    plan = dict(scheme=scheme, aggregation_axes=None, fsdp_axis=None,
                context_parallel=False)
    if shape.kind == "train":
        if cfg.name.startswith("llama3-405b"):
            # a client's params and gradients overflow 16 cards: mean + FSDP
            # (the reference cannot put FSDP inside an OTA client); the
            # OTA-over-pod plan is scheme='normalized' on the multi-pod mesh
            if scheme == "mean" or not multi_pod:
                plan.update(scheme="mean",
                            fsdp_axis=("pod", "data") if multi_pod else "data")
            else:
                plan.update(aggregation_axes=("pod",), fsdp_axis=None)
        else:
            plan.update(aggregation_axes=("pod", "data") if multi_pod
                        else ("data",))
    elif shape.kind == "decode" and shape.name == "long_500k":
        # the context-parallel KV cache for the hybrids only: a sliding
        # window's and a recurrence's state do not grow with the context
        if cfg.is_hybrid:
            plan.update(context_parallel=True)
    return plan


def ota_params_for(cfg: ModelConfig, mesh, axes, h=None
                   ) -> train_lib.OTARunParams:
    """The run's OTA parameters for the clients along ``axes``: ``h``
    (drawn from the port's generator, seed 0, where None) and Problem 3's
    ``b`` for it."""
    k = 1
    for a in axes:
        k *= mesh.shape[a]
    ch = chan.ChannelConfig(num_devices=k, channel_mean=1e-3)
    if h is None:
        h = chan.draw_channel(torch.Generator().manual_seed(0), ch).numpy()
    h = np.asarray(h, np.float64)
    sol = amp.solve_problem3(h, ch.noise_var, min(cfg.param_count(), 10 ** 9),
                             ch.b_max, tol=1e-8)
    a_gain = 1.0 / float(np.sum(h * sol.b))
    return train_lib.OTARunParams(h=h, b=sol.b, a=a_gain,
                                  noise_var=ch.noise_var)


# ---------------------------------------------------------------------------
# the fake group and the counting mode


@contextlib.contextmanager
def fake_group(world_size: int):
    """This process as rank 0 of a fake process group of ``world_size``
    ranks (collectives move nothing), torn down on the way out."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as err:      # pragma: no cover - torch-version guard
        raise RuntimeError(
            "the dry run needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg), which this "
            f"torch {torch.__version__} does not have") from err
    dist = torch.distributed
    if dist.is_initialized():
        raise RuntimeError(
            "the dry run plays rank 0 of its own fake process group: a "
            "process group is already initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _sig(x):
    """A hashable signature of an op's argument (TypeError if none)."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), tuple(x.stride()), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple(_sig(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _sig(v)) for k, v in sorted(x.items()))
    hash(x)
    return x


# ops that alias their input without saying so in their schema
_VIEWS = (torch.ops.aten._unsafe_view.default,)
# ops that write their output and read nothing
_FILLS = ("zeros", "ones", "full", "zeros_like", "ones_like", "full_like",
          "new_zeros", "new_ones", "new_full", "scalar_tensor", "arange")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    """FLOPs, bytes accessed and live bytes of every aten op run under it
    (module doc); a functional op on meta tensors seen before with the same
    signature is answered from its first outputs' shapes."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self.peak_recorded = 0      # recorded bytes when ``peak`` was set
        self._seen = set()
        self._kind = {}
        self._cache = {}
        self._atomic = set()

    def _free(self, sid, n: int) -> None:
        self._seen.discard(sid)
        self.live -= n

    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            sid = st._cdata
            if sid not in self._seen:
                self._seen.add(sid)
                n = st.nbytes()
                self.live += n
                weakref.finalize(st, self._free, sid, n)
        if self.live > self.peak:
            self.peak = self.live
            ctx = tp_lib.running_context()
            self.peak_recorded = 0 if ctx is None else ctx.recorded_bytes

    def _classify(self, func) -> str:
        """'view' (an output aliases an input), 'mut' (writes an input) or
        'fn' (fresh outputs); and whether the op's bytes count: not a
        view's, not an allocation's (``empty*``), not a collective's (its
        own term); a fill (``zeros_like``, ``new_zeros``, ...) counts its
        output only."""
        got = self._kind.get(func)
        if got is None:
            schema = func._schema
            alias = any(r.alias_info is not None for r in schema.returns)
            kind = ("view" if alias and not schema.is_mutable
                    or func in _VIEWS else
                    "mut" if schema.is_mutable or alias else "fn")
            name = func._overloadpacket.__name__
            moves = ("none" if kind == "view" or name.startswith("empty")
                     or name == "new_empty" or name.startswith("new_empty")
                     or func.namespace == "c10d" else
                     "out" if name in _FILLS else "all")
            got = self._kind[func] = (kind, moves)
        return got

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in self._atomic:
            # a composite op (einsum, matmul, softmax under inference
            # mode) is counted by the ops it decomposes into, as
            # FlopCounterMode counts it
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
            self._atomic.add(func)
        self.ops += 1
        kind, moves = self._classify(func)
        memo = None
        if kind == "fn":
            try:
                memo = (func, _sig(args), _sig(kwargs))
            except TypeError:
                memo = None
            hit = None if memo is None else self._cache.get(memo)
            if hit is not None:
                spec, metas, flops, nbytes = hit
                outs = [torch.empty_strided(s, st, dtype=dt, device=META)
                        for s, st, dt in metas]
                self.flops += flops
                self.bytes += nbytes
                self._track(outs)
                return tree_unflatten(outs, spec)
        out = func(*args, **kwargs)
        flat, spec = tree_flatten(out)
        outs = [t for t in flat if isinstance(t, torch.Tensor)]
        packet = func._overloadpacket
        flops = (int(flop_registry[packet](*args, **kwargs, out_val=out))
                 if packet in flop_registry else 0)
        nbytes = 0
        if moves != "none":
            ins = tree_flatten((args, kwargs))[0] if moves == "all" else []
            nbytes = sum(_nbytes(t) for t in ins + outs
                         if isinstance(t, torch.Tensor))
        self.flops += flops
        self.bytes += nbytes
        if kind == "fn":        # a view or a write allocates nothing
            self._track(outs)
        if memo is not None and len(outs) == len(flat) \
                and all(t.device.type == "meta" for t in outs):
            self._cache[memo] = (spec, [(tuple(t.shape), tuple(t.stride()),
                                        t.dtype) for t in outs],
                                flops, nbytes)
        return out


# ---------------------------------------------------------------------------
# the bytes a rank holds


def _tree_bytes(tree) -> int:
    if tree is None:
        return 0
    return sum(_nbytes(t) for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _emulated(multi_pod: bool) -> mesh_lib.ServingMesh:
    """The production mesh's shape, with no process group (the cut needs
    the shape alone)."""
    return mesh_lib.ServingMesh(16, 16, pod=2 if multi_pod else 1)


def _state_bytes(cfg, shape, mesh, plan, params, opt_state, batch,
                 cache=None) -> dict:
    """The resident bytes of the largest rank: its params, optimizer state,
    batch rows and decode cache (each rank's cut by the builders' rules,
    on meta tensors), and which rank that is."""
    train = shape.kind == "train"
    fsdp = None
    outer, inner = None, mesh.canonical(mesh_lib.DP)
    if train:
        fsdp = (None if plan["fsdp_axis"] is None
                else mesh.canonical(plan["fsdp_axis"]))
        outer, inner = train_lib.row_axes(mesh, plan["scheme"],
                                          plan["aggregation_axes"])
    cache_leaves = None
    if cache is not None:
        specs = serve_lib._decode_cache_specs(
            cfg, mesh, cache, context_parallel=plan["context_parallel"])
        cache_leaves = list(zip([t for _, t in sh._named_leaves(cache)],
                                [s for _, s in sh._named_leaves(specs)]))
    split = serve_lib._split_batch(mesh, shape.global_batch)
    best = None
    for r in range(mesh.size):
        c = mesh.axis_coords(r)
        if train:
            p = sh.shard_params(params, mesh, r, cfg, fsdp)
            o = [sh.shard_params(f, mesh, r, cfg, fsdp)
                 if not isinstance(f, torch.Tensor) else f
                 for f in opt_state]
            rows = train_lib._rows(mesh, batch, r, outer, inner)[0]
        else:
            p = sh.shard_params(params, mesh, c["model"], cfg)
            o = None
            rows = batch
            if split and not plan["context_parallel"]:
                i, n = mesh.axis_index(r, inner), mesh.axis_size(inner)
                rows = {k: v if v.dim() == 0 else
                        v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
                        for k, v in batch.items()}
        got = {"params": _tree_bytes(p), "opt_state": _tree_bytes(o),
               "batch": _tree_bytes(rows),
               "cache": 0 if cache is None else sum(
                   _nbytes(sh.cut_leaf(t, spec, mesh, r))
                   for t, spec in cache_leaves)}
        got["total"] = sum(got.values())
        got["rank"] = r
        if best is None or got["total"] > best["total"]:
            best = got
    return best


# ---------------------------------------------------------------------------
# one pair


def _meta_batch(cfg, shape) -> dict:
    out = {}
    for name, spec in reg.input_specs(cfg, shape).items():
        out[name] = torch.zeros(spec.shape, dtype=spec.dtype, device=META)
    return out


def _patched(cfg, overrides):
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def lower_one(arch: str, shape_name: str, *, multi_pod: bool = False,
              scheme: str = "normalized",
              overrides: Optional[dict] = None) -> dict:
    """Plan, run and count rank 0's step of one (arch, shape, mesh) pair;
    returns a record.  ``overrides`` patches ModelConfig fields."""
    cfg = _patched(reg.get_config(arch), overrides)
    shape = INPUT_SHAPES[shape_name]
    skip = reg.applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod),
           "scheme": scheme, "status": "skip", "skip_reason": skip}
    if skip:
        return rec
    chips = 512 if multi_pod else 256
    t0 = time.time()
    with fake_group(chips):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
        plan = plan_for(cfg, shape, mesh, scheme)
        rec["plan"] = {k: (list(v) if isinstance(v, tuple) else v)
                       for k, v in plan.items()}
        params = T.init_params(cfg, torch.Generator(), device=META)
        batch = _meta_batch(cfg, shape)
        opt_state = cache = None
        if shape.kind == "train":
            run, opt_state, batch = _train_run(cfg, mesh, plan, params,
                                               batch)
        elif shape.kind == "prefill":
            run = _prefill_run(cfg, mesh, params, batch)
        else:
            run, cache = _decode_run(cfg, shape, mesh, plan, params, batch)
        got = count(run)
        del run
    state = _state_bytes(cfg, shape, _emulated(multi_pod), plan, params,
                         opt_state, batch, cache)
    n_active = cfg.active_param_count()
    mem = (f"peak live bytes of the step's storages {got['peak']} over "
           f"rank {state['rank']}'s resident {state['total']} (dispatch "
           "mode, weak references a storage)")
    report = rl.from_counts(f"{arch}/{shape_name}", chips, got["flops"],
                            got["bytes"], got["collectives"],
                            rl.model_flops_for(cfg, shape, n_active), mem)
    rec.update(status="ok", dry_run_s=round(time.time() - t0, 1),
               roofline=report.to_dict(), flops_rank=0, ops=got["ops"],
               params=cfg.param_count(), active_params=n_active,
               bytes_per_rank=state, peak_step_bytes=got["peak"],
               recorded_bytes_at_peak=got["peak_recorded"],
               fits=bool(state["total"] <= rl.HBM_BYTES),
               fits_with_step_peak=bool(state["total"] + got["peak"]
                                        <= rl.HBM_BYTES))
    return rec


def _train_run(cfg, mesh, plan, params, batch):
    opt = sgd(1e-2)
    opt_state = opt.init(params)
    ota = None
    if plan["aggregation_axes"]:
        ota = ota_params_for(cfg, mesh, plan["aggregation_axes"])
    step, place = train_lib.build_train_step(
        cfg, mesh, scheme=plan["scheme"],
        aggregation_axes=plan["aggregation_axes"],
        fsdp_axis=plan["fsdp_axis"], ota=ota, optimizer=opt, device=META)
    batch = train_lib.make_batch_from_specs(batch, cfg)
    p, o, rows = place(params, opt_state, batch)

    def run():
        # a seeded step: each rank's noise and gain, one pass of its
        # pieces (``ops.channel_noise``' meta route)
        step(p, o, rows, 0)
    return run, opt_state, batch


def _prefill_run(cfg, mesh, params, batch):
    step, place = serve_lib.build_prefill_step(cfg, META, mesh=mesh)
    p, _ = place(params)
    return lambda: step(p, batch)


def _decode_run(cfg, shape, mesh, plan, params, batch):
    b, s = shape.global_batch, shape.seq_len
    cp = plan["context_parallel"]
    cache = T.init_cache(cfg, b, s, cp_shards=mesh.data if cp else 1,
                         device=META)
    step, place = serve_lib.build_decode_step(
        cfg, META, context_parallel=cp, cache_len=s, mesh=mesh)
    p, c = place(params, cache)
    enc = None
    if cfg.is_encoder_decoder:
        src = batch.pop("src_embeds")
        enc = torch.empty((b, src.shape[1], cfg.d_model),
                          dtype=L.dtype_of(cfg), device=META)
        batch["enc_out"] = enc
    tokens, pos = batch["tokens"], s - 1
    return (lambda: step(p, c, tokens, pos, enc_out=enc)), cache


def count(run) -> dict:
    """The counts of ``run()`` (rank 0's step): FLOPs, bytes accessed,
    collective bytes by kind, aten ops, the step's peak live bytes, the
    recorded collectives' bytes at that peak and the seconds the count
    took."""
    t0 = time.time()
    counter = _Counter()
    with oc.counting_collectives() as coll, counter:
        run()
    return {"flops": counter.flops, "bytes": counter.bytes,
            "collectives": dict(coll), "ops": counter.ops,
            "peak": counter.peak, "peak_recorded": counter.peak_recorded,
            "seconds": time.time() - t0}


def count_mean_step(cfg: ModelConfig, rows: int, seq: int) -> dict:
    """``count`` of one mean train step (sgd) of ``cfg`` on one card (no
    mesh, no collective) at ``rows`` x ``seq`` tokens, on meta tensors."""
    params = T.init_params(cfg, torch.Generator(), device=META)
    opt = sgd(1e-2)
    step, place = train_lib.build_train_step(cfg, None, scheme="mean",
                                             optimizer=opt, device=META)
    toks = torch.zeros((rows, seq), dtype=torch.long, device=META)
    p, o, batch = place(params, opt.init(params), {
        "tokens": toks, "labels": toks,
        "loss_mask": torch.zeros((rows, seq), device=META)})
    return count(lambda: step(p, o, batch))


def _depth_overrides(cfg: ModelConfig, mult: int) -> dict:
    """A config of ``mult`` superblocks (an encoder of ``mult`` layers
    alongside).  Nothing else changes: an eager count sees every chunk and
    every time step, so the counts are linear in the depth."""
    ov = {"num_layers": len(cfg.block_pattern) * mult}
    if cfg.is_encoder_decoder:
        ov["num_encoder_layers"] = mult
    return ov


def analyze_one(arch: str, shape_name: str, *, multi_pod: bool = False,
                scheme: str = "normalized",
                overrides: Optional[dict] = None,
                depths=(1, 2)) -> dict:
    """The cheap mode: ``lower_one`` at ``depths`` superblocks, each count
    extrapolated along the line through them to the full depth (exact:
    every count is linear in the depth), and the bytes a rank at the full
    depth."""
    cfg = _patched(reg.get_config(arch), overrides)
    shape = INPUT_SHAPES[shape_name]
    skip = reg.applicable(cfg, shape)
    mesh_name = _mesh_name(multi_pod)
    if skip:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "mode": "analysis", "status": "skip", "skip_reason": skip}
    chips = 512 if multi_pod else 256
    t0 = time.time()
    meas = []
    for mult in depths:
        ov = dict(overrides or {})
        ov.update(_depth_overrides(cfg, mult))
        rec = lower_one(arch, shape_name, multi_pod=multi_pod, scheme=scheme,
                        overrides=ov)
        if rec["status"] != "ok":
            rec["mode"] = "analysis"
            return rec
        meas.append(rec)

    n_full = cfg.num_superblocks
    d1, d2 = depths

    def extrap(v1, v2):
        step, rest = divmod((v2 - v1) * (n_full - d1), d2 - d1)
        return v1 + step + (rest / (d2 - d1) if rest else 0)

    r1, r2 = meas[0]["roofline"], meas[1]["roofline"]
    breakdown = {k: extrap(r1["coll_breakdown"][k], r2["coll_breakdown"][k])
                 for k in r1["coll_breakdown"]}
    plan = meas[0]["plan"]
    plan_t = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in plan.items()}
    params = T.init_params(cfg, torch.Generator(), device=META)
    batch = _meta_batch(cfg, shape)
    mesh = _emulated(multi_pod)
    opt_state = cache = None
    if shape.kind == "train":
        opt_state = sgd(1e-2).init(params)
        batch = train_lib.make_batch_from_specs(batch, cfg)
    elif shape.kind == "decode":
        cache = T.init_cache(cfg, shape.global_batch, shape.seq_len,
                             cp_shards=mesh.data
                             if plan["context_parallel"] else 1, device=META)
        if cfg.is_encoder_decoder:
            src = batch.pop("src_embeds")
            batch["enc_out"] = torch.empty(
                (shape.global_batch, src.shape[1], cfg.d_model),
                dtype=L.dtype_of(cfg), device=META)
    state = _state_bytes(cfg, shape, mesh, plan_t, params, opt_state, batch,
                         cache)
    peak = extrap(meas[0]["peak_step_bytes"], meas[1]["peak_step_bytes"])
    recorded = extrap(meas[0]["recorded_bytes_at_peak"],
                      meas[1]["recorded_bytes_at_peak"])
    rep = rl.from_counts(
        f"{arch}/{shape_name}", chips,
        extrap(r1["flops_per_chip"], r2["flops_per_chip"]),
        extrap(r1["bytes_per_chip"], r2["bytes_per_chip"]), breakdown,
        rl.model_flops_for(cfg, shape, cfg.active_param_count()),
        f"peak live bytes of the step's storages ~{peak:.0f} (the line "
        "through depths 1 and 2: an estimate, a peak is not a sum)")
    return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "mode": "analysis", "scheme": scheme, "status": "ok",
            "plan": plan,
            "depth_points": [r1["flops_per_chip"], r2["flops_per_chip"]],
            "n_superblocks": n_full, "roofline": rep.to_dict(),
            "flops_rank": 0, "dry_run_s": round(time.time() - t0, 1),
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "bytes_per_rank": state, "peak_step_bytes": peak,
            "recorded_bytes_at_peak": recorded,
            "fits": bool(state["total"] <= rl.HBM_BYTES),
            "fits_with_step_peak": bool(state["total"] + peak
                                        <= rl.HBM_BYTES)}


# ---------------------------------------------------------------------------
# the CLI


def _src_dir() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def run_isolated(pairs, args) -> list:
    """Each pair in a process of its own (nothing of one pair's group or
    caches reaches the next) and the records merged."""
    records = []
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_src_dir()] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    for arch, shape in pairs:
        with tempfile.NamedTemporaryFile(suffix=".json", delete=False) as tf:
            tmp = tf.name
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--scheme", args.scheme, "--out", tmp]
        if args.multi_pod:
            cmd.append("--multi-pod")
        if args.analysis:
            cmd.append("--analysis")
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=3000, env=env)
            recs = []
            if os.path.exists(tmp) and os.path.getsize(tmp):
                with open(tmp) as f:
                    recs = json.load(f)
            if recs:
                records.extend(recs)
            else:
                records.append({
                    "arch": arch, "shape": shape,
                    "mesh": _mesh_name(args.multi_pod), "status": "error",
                    "error": f"subprocess exit {r.returncode}",
                    "stderr_tail": r.stderr[-1200:]})
        except subprocess.TimeoutExpired:
            records.append({"arch": arch, "shape": shape,
                            "mesh": _mesh_name(args.multi_pod),
                            "status": "error", "error": "timeout"})
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        print(_line(records[-1]) + " (isolated)", flush=True)
    return records


def _line(rec: dict) -> str:
    ok = rec["status"]
    extra = ""
    if ok == "ok":
        r = rec["roofline"]
        extra = (f" compute={r['compute_s'] * 1e3:.2f}ms "
                 f"mem={r['memory_s'] * 1e3:.2f}ms "
                 f"coll={r['collective_s'] * 1e3:.2f}ms "
                 f"bottleneck={r['bottleneck']} "
                 f"rank_GB={rec['bytes_per_rank']['total'] / 1e9:.2f} "
                 f"peak_GB={rec['peak_step_bytes'] / 1e9:.2f} "
                 f"recorded_GB={rec['recorded_bytes_at_peak'] / 1e9:.2f} "
                 f"fits={rec['fits']}/{rec['fits_with_step_peak']} "
                 f"s={rec['dry_run_s']}")
    elif ok == "skip":
        extra = f" ({rec['skip_reason']})"
    elif ok == "error":
        extra = f" {rec['error'][:120]}"
    return f"[{ok:5s}] {rec['arch']} x {rec['shape']} on {rec['mesh']}{extra}"


def _write(path: Optional[str], records) -> None:
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(records, f, indent=2)
        print(f"wrote {path}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--isolate", action="store_true",
                    help="run every pair in a process of its own")
    ap.add_argument("--analysis", action="store_true",
                    help="depths 1 and 2 superblocks, extrapolated")
    ap.add_argument("--scheme", default="normalized")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    pairs = []
    if args.all:
        pairs = [(a, s) for a in reg.ARCH_IDS for s in INPUT_SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape (or --all) required")
        pairs.append((args.arch, args.shape))

    if args.isolate:
        _write(args.out, run_isolated(pairs, args))
        return

    records = []
    for arch, shape in pairs:
        try:
            fn = analyze_one if args.analysis else lower_one
            rec = fn(arch, shape, multi_pod=args.multi_pod,
                     scheme=args.scheme)
        except Exception as e:  # noqa: BLE001 - recorded, the sweep goes on
            rec = {"arch": arch, "shape": shape,
                   "mesh": _mesh_name(args.multi_pod), "status": "error",
                   "error": repr(e),
                   "traceback": traceback.format_exc()[-2000:]}
        records.append(rec)
        print(_line(rec), flush=True)
    _write(args.out, records)


if __name__ == "__main__":
    main()
