"""The sweep engine's front door (port of ``repro/fl/sweep.py``): expand an
``ExperimentSpec`` over named axes, classify each axis as *batchable* (a
lane of one engine) or *structural* (an engine of its own), and run the grid
in as few engines as the structure allows.

    sweep = SweepSpec(base_spec, {"s_target": (0.98, 0.99, 0.995),
                                  "seed": (0, 1, 2, 3)})
    result = run_sweep(sweep, num_rounds=400)          # device="cuda"
    mean, std = result.band("gap", over="seed")        # [3, num_evals]

Axis names address the nested spec through one flat namespace
(``repro_torch.fl.spec.resolve_axis``).  Which fields are batchable is the
runtime's (``BATCHED_FL_FIELDS`` / ``BATCHED_CHANNEL_FIELDS``) and the
client registry's (``clients.BATCHED_CLIENT_FIELDS``: ``client.mu`` and
``client.alpha`` reach each lane's round from device memory); everything
else -- scheme, case, backend, amplification, the scenario axes,
``client.algo``, any data or model field -- is structural.

Grid points are grouped by structural signature (the runtime's
``structural_config`` of the point's config, with its data and model
specs); each group is one ``runtime.run_batched`` call: on the card one
CUDA graph of one round of all its lanes, replayed once a round, each lane
bitwise its own sequential run.  Groups share the cached ``Task`` of their
data and model specs, so a repeated sweep captures nothing.  Groups on the
``mesh`` backend or with ``device_mesh > 1`` run point by point instead:
their rounds own the ranks of the FL-device axis.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import itertools
import json
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.fed import runtime
from repro_torch.fl import clients
from repro_torch.fl.experiment import Experiment
from repro_torch.fl.spec import (ExperimentSpec, apply_axes, apply_axis,
                                 resolve_axis)
from repro_torch.fl.tasks import build_task

BATCHABLE = "batchable"
STRUCTURAL = "structural"


def classify_field(name: str) -> str:
    """``batchable`` or ``structural`` for one resolved spec field."""
    scope, field = resolve_axis(name)
    if scope == "fl" and field in runtime.BATCHED_FL_FIELDS:
        return BATCHABLE
    if scope == "channel" and field in runtime.BATCHED_CHANNEL_FIELDS:
        return BATCHABLE
    if scope == "client" and field in clients.BATCHED_CLIENT_FIELDS:
        return BATCHABLE
    return STRUCTURAL


def _is_composite(value: Any) -> bool:
    """Composite axis values bundle several field assignments under one
    label: ``("caseI", {"case": "I", "p": 0.75})``."""
    return (isinstance(value, tuple) and len(value) == 2
            and isinstance(value[0], str) and isinstance(value[1], Mapping))


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One grid point: its N-D index, its coordinates (axis name -> value;
    a composite axis gives its label), and the fully applied spec."""

    index: Tuple[int, ...]
    coords: Tuple[Tuple[str, Any], ...]
    spec: ExperimentSpec


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A base ``ExperimentSpec`` plus named axes (a mapping, or a sequence
    of ``(name, values)`` pairs; the values' order defines the grid's
    C-order).  Axis values are field values, or ``(label, mapping)``
    composites that set several fields at once (batchable only if every
    field of them is)."""

    base: ExperimentSpec
    axes: Any

    def __post_init__(self):
        items = (tuple((k, tuple(v)) for k, v in self.axes.items())
                 if isinstance(self.axes, Mapping)
                 else tuple((k, tuple(v)) for k, v in self.axes))
        object.__setattr__(self, "axes", items)
        seen = set()
        for name, values in items:
            if name in seen:
                raise ValueError(f"duplicate sweep axis {name!r}")
            seen.add(name)
            if not values:
                raise ValueError(f"sweep axis {name!r} has no values")
            composite = [_is_composite(v) for v in values]
            if any(composite) and not all(composite):
                raise ValueError(
                    f"axis {name!r} mixes composite (label, mapping) values "
                    "with plain values")
            if all(composite):
                for _, mapping in values:
                    for field in mapping:
                        resolve_axis(field)
            else:
                resolve_axis(name)
        # expanded once: every grid point is validated at declaration
        object.__setattr__(self, "_points", tuple(self._expand()))

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(name for name, _ in self.axes)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(len(values) for _, values in self.axes)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.axes else 1

    def values(self, name: str) -> Tuple[Any, ...]:
        """The coordinate values of one axis (labels for composites)."""
        for axis, vals in self.axes:
            if axis == name:
                return tuple(v[0] if _is_composite(v) else v for v in vals)
        raise ValueError(f"no sweep axis named {name!r}; one of {self.names}")

    def classification(self) -> Dict[str, str]:
        """axis name -> ``batchable`` | ``structural``: a batchable axis
        multiplies the lanes of one engine, a structural one the engines."""
        out = {}
        for name, values in self.axes:
            if _is_composite(values[0]):
                fields = set()
                for _, mapping in values:
                    fields.update(mapping)
                out[name] = (BATCHABLE if all(classify_field(f) == BATCHABLE
                                              for f in fields)
                             else STRUCTURAL)
            else:
                out[name] = classify_field(name)
        return out

    def points(self) -> List[SweepPoint]:
        """The full grid in C-order (last axis fastest)."""
        return list(self._points)

    def _expand(self) -> List[SweepPoint]:
        if not self.axes:
            return [SweepPoint((), (), self.base)]
        pts = []
        ranges = [range(len(values)) for _, values in self.axes]
        for index in itertools.product(*ranges):
            spec = self.base
            coords = []
            for (name, values), i in zip(self.axes, index):
                value = values[i]
                if _is_composite(value):
                    label, mapping = value
                    spec = apply_axes(spec, mapping)
                    coords.append((name, label))
                else:
                    spec = apply_axis(spec, name, value)
                    coords.append((name, value))
            pts.append(SweepPoint(tuple(index), tuple(coords), spec))
        return pts


@dataclasses.dataclass
class SweepResult:
    """Per-point histories of a sweep, flat over the grid: ``history[key]``
    is [G, T] for the runtime's ``DIAG_KEYS`` and [G, num_evals] for eval
    metrics, G the grid size in the C-order of ``points``; ``rounds`` and
    ``eval_rounds`` are shared by every point."""

    sweep: SweepSpec
    num_rounds: int
    rounds: List[int]
    eval_rounds: List[int]
    history: Dict[str, np.ndarray]
    points: List[SweepPoint]
    # each point's final-params digest (obs.params_sha256), grid C-order
    params_digests: Optional[List[str]] = None

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.sweep.shape

    def grid(self, key: str) -> np.ndarray:
        """``history[key]`` reshaped to the grid: [*axis lengths, T]."""
        arr = self.history[key]
        return arr.reshape(self.shape + arr.shape[1:])

    def band(self, key: str, over: str = "seed") -> Tuple[np.ndarray,
                                                          np.ndarray]:
        """(mean, std) of ``history[key]`` over one named axis (the seed
        replicates' error band); the other grid axes stay."""
        if over not in self.sweep.names:
            raise ValueError(f"no sweep axis named {over!r}; one of "
                             f"{self.sweep.names}")
        axis = self.sweep.names.index(over)
        g = self.grid(key)
        return g.mean(axis=axis), g.std(axis=axis)

    def point_index(self, **coords) -> int:
        """Flat index of the point at the given coordinates (every axis
        pinned)."""
        if set(coords) != set(self.sweep.names):
            raise ValueError(f"pin every axis {self.sweep.names}, got "
                             f"{tuple(coords)}")
        index = []
        for name in self.sweep.names:
            values = self.sweep.values(name)
            if coords[name] not in values:
                raise ValueError(f"{coords[name]!r} is not a value of axis "
                                 f"{name!r} ({values})")
            index.append(values.index(coords[name]))
        return int(np.ravel_multi_index(tuple(index), self.shape))

    def params_sha256(self) -> Optional[str]:
        """sha-256 over the per-point digests in C-order (None without
        digests)."""
        if not self.params_digests:
            return None
        h = hashlib.sha256()
        for d in self.params_digests:
            h.update(d.encode())
        return h.hexdigest()

    def curves(self, axis: str, metric: str, over: str = "seed",
               ) -> Dict[str, Dict[str, Any]]:
        """A figure's curves for an (``axis`` x ``over``) sweep: for each
        ``axis`` value the eval rounds, the ``metric`` mean over the
        ``over`` replicates, its std band and the replicate count."""
        mean, std = self.band(metric, over=over)
        n_over = len(self.sweep.values(over))
        out: Dict[str, Dict[str, Any]] = {}
        for i, value in enumerate(self.sweep.values(axis)):
            out[str(value)] = {
                "round": list(self.eval_rounds),
                metric: np.asarray(mean[i]).tolist(),
                f"{metric}_std": np.asarray(std[i]).tolist(),
                "seeds": n_over,
            }
        return out

    def manifest(self) -> Dict[str, Any]:
        """The base spec's identity block, the grid geometry and the
        combined final-params digest."""
        return obs.run_manifest(
            spec=self.sweep.base, params_digest=self.params_sha256(),
            extra={
                "num_rounds": int(self.num_rounds),
                "sweep_axes": {name: [str(v) for v in self.sweep.values(name)]
                               for name in self.sweep.names},
                "sweep_shape": list(self.shape),
                "axis_classification": self.sweep.classification(),
            })

    def dump(self, path: str, over: Optional[str] = "seed") -> str:
        """Write the result as one JSON file: manifest, grid geometry,
        per-point histories and, when ``over`` names an axis, the ``band``
        of every history key."""
        payload: Dict[str, Any] = {
            "manifest": self.manifest(),
            "num_rounds": int(self.num_rounds),
            "rounds": [int(t) for t in self.rounds],
            "eval_rounds": [int(t) for t in self.eval_rounds],
            "axes": {name: [str(v) for v in self.sweep.values(name)]
                     for name in self.sweep.names},
            "shape": list(self.shape),
            "history": {k: np.asarray(v).tolist()
                        for k, v in self.history.items()},
        }
        if self.params_digests:
            payload["params_digests"] = list(self.params_digests)
        if over is not None and over in self.sweep.names:
            payload["bands"] = {
                k: {"over": over,
                    "mean": self.band(k, over=over)[0].tolist(),
                    "std": self.band(k, over=over)[1].tolist()}
                for k in self.history}
        with open(path, "w") as f:
            json.dump(payload, f, default=str)
        return path


def _structural_signature(spec: ExperimentSpec):
    """The key under which grid points share one engine: the runtime's
    structural config plus the data and model specs (they make the task:
    its arrays, ``grad_fn`` and eval metrics)."""
    return (runtime.structural_config(spec.fl_config()), spec.data,
            spec.model)


def _run_group_sequential(specs, task, num_rounds, evaluate, eval_every,
                          device="cuda", recorder=None):
    """One group point by point (``vectorized=False``, the python driver):
    independent ``Experiment.run`` trajectories sharing the group's cached
    ``Task``, in the batched history layout.  Returns ``(hist, digests)``."""
    rows, digests = [], []
    for spec in specs:
        e = Experiment(spec, task=task, device=device)
        rows.append(e.run(num_rounds, evaluate=evaluate,
                          eval_every=eval_every, recorder=recorder))
        digests.append(obs.params_sha256(e.state.params))
    out: Dict[str, Any] = {"round": rows[0]["round"],
                           "eval_round": rows[0]["eval_round"]}
    for key in rows[0]:
        if key not in out:
            out[key] = np.stack([np.asarray(r[key], np.float64)
                                 for r in rows])
    return out, digests


def run_sweep(sweep: SweepSpec, num_rounds: int, *, vectorized: bool = True,
              shard: bool = True, evaluate: Optional[bool] = None,
              recorder: Optional[obs.Recorder] = None,
              device="cuda", devices=None) -> SweepResult:
    """Run every grid point of ``sweep`` for ``num_rounds`` rounds on
    ``device``.

    Points are grouped by structural signature; each group runs as one
    ``runtime.run_batched`` call (on the card: one CUDA graph of a round of
    all its lanes).  ``vectorized=False`` and the ``python`` driver run each
    group point by point (``_run_group_sequential``), the baseline a
    batched sweep is held to.

    Eval scheduling comes from ``sweep.base.eval`` (``evaluate`` overrides
    the switch) and is the same for every point, so histories align across
    the grid; all groups must give the same eval-metric keys.

    ``shard`` (with ``devices``) goes to ``run_batched``: a group's lanes
    spread over the local cards (or the ``devices`` given), each card with
    its own copy of the group's task (``build_task`` on that device).

    ``recorder`` gets the grid's manifest first, then every group's engine
    events through the one sink (a batched group's values one a lane; a
    sequential point's run adds its own manifest)."""
    pts = sweep.points()
    base = sweep.base
    enabled = base.eval.enabled if evaluate is None else evaluate
    eval_every = base.eval.every
    vectorized = vectorized and base.driver == "scan"

    groups: Dict[Any, List[int]] = {}
    for i, pt in enumerate(pts):
        groups.setdefault(_structural_signature(pt.spec), []).append(i)

    if recorder is not None:
        # the grid's identity first (the points' digests land on the
        # SweepResult once the trajectories exist)
        recorder.on_manifest(obs.run_manifest(spec=base, extra={
            "num_rounds": int(num_rounds),
            "sweep_axes": {name: [str(v) for v in sweep.values(name)]
                           for name in sweep.names},
            "sweep_shape": list(sweep.shape)}))

    flat: Dict[str, np.ndarray] = {}
    digests: List[Optional[str]] = [None] * len(pts)
    rounds: Optional[List[int]] = None
    eval_rounds: Optional[List[int]] = None
    metric_keys: Optional[frozenset] = None
    for idxs in groups.values():
        gspecs = [pts[i].spec for i in idxs]
        cfgs = [s.fl_config() for s in gspecs]
        task = build_task(gspecs[0].data, gspecs[0].model,
                          cfgs[0].num_devices, device)
        # the mesh backend and device_mesh groups run point by point: their
        # rounds own the ranks of the FL-device axis (run_batched rejects
        # both, as the reference's)
        if (vectorized and cfgs[0].backend != "mesh"
                and (cfgs[0].device_mesh is None
                     or cfgs[0].device_mesh <= 1)):
            states = [runtime.setup(cfg, task.params0, task.model_dim)
                      for cfg in cfgs]
            _, hist = runtime.run_batched(
                cfgs, states, task.grad_fn, task.batch_provider, num_rounds,
                eval_fn=task.eval_fn if enabled else None,
                eval_every=eval_every, chunk_size=base.chunk_size,
                chunk_batch_provider=task.chunk_batch_provider,
                shard=shard, devices=devices,
                task_on=functools.partial(build_task, gspecs[0].data,
                                          gspecs[0].model,
                                          cfgs[0].num_devices),
                recorder=recorder)
            gdigests = [obs.params_sha256(s.params) for s in states]
        else:
            hist, gdigests = _run_group_sequential(
                gspecs, task, num_rounds, enabled, eval_every, device,
                recorder)
        for i, d in zip(idxs, gdigests):
            digests[i] = d
        keys = frozenset(k for k in hist if k not in ("round", "eval_round"))
        if rounds is None:
            rounds, eval_rounds = list(hist["round"]), list(hist["eval_round"])
            metric_keys = keys
        elif keys != metric_keys:
            raise ValueError(
                "sweep groups disagree on history keys "
                f"({sorted(keys ^ metric_keys)} differ) -- split a sweep "
                "that spans tasks with different eval metrics")
        for key in keys:
            arr = np.asarray(hist[key], np.float64)
            buf = flat.get(key)
            if buf is None:
                buf = np.zeros((len(pts),) + arr.shape[1:])
                flat[key] = buf
            buf[idxs] = arr
    return SweepResult(sweep=sweep, num_rounds=num_rounds, rounds=rounds,
                       eval_rounds=eval_rounds, history=flat, points=pts,
                       params_digests=digests)
