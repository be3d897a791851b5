"""The declarative experiment spec (port of ``repro/fl/spec.py``): one frozen
object describes a full OTA-FL experiment -- channel/scheme/schedule
(``FLConfig``), data (task, split, batch size), model/loss, eval policy,
and the scenario-axis overrides.

``driver`` defaults to ``"scan"``, the chunked engine (a CUDA graph of the
round on the card), as in the reference; ``"python"`` runs the same round
body one round at a time and gives the same bits.

``resolve_axis`` / ``apply_axis`` / ``apply_axes`` address the nested spec
through one flat namespace of sweep axes (``repro_torch.fl.sweep``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

from repro_torch.core.channel import ChannelConfig
from repro_torch.fed.runtime import DRIVERS, FLConfig
from repro_torch.fl.clients import ClientConfig

DATASETS = ("synthetic_mnist", "ridge")
SPLITS = ("iid", "dirichlet")
MODEL_KINDS = ("auto", "mlp", "ridge")
# dataset -> model kind resolved by ModelSpec(kind='auto')
_AUTO_MODEL = {"synthetic_mnist": "mlp", "ridge": "ridge"}


@dataclasses.dataclass(frozen=True)
class DataSpec:
    """What the devices train on and how it is partitioned across them."""

    dataset: str = "synthetic_mnist"   # 'synthetic_mnist' | 'ridge'
    split: str = "dirichlet"           # 'iid' | 'dirichlet'
    alpha: float = 1.0                 # dirichlet concentration (non-IID skew)
    batch_size: int = 50
    num_train: int = 4000
    num_test: int = 1000
    dim: int = 30                      # ridge feature dimension
    seed: int = 0                      # data/split/init/provider seed root

    def __post_init__(self):
        if self.dataset not in DATASETS:
            raise ValueError(f"unknown dataset {self.dataset!r}; "
                             f"one of {DATASETS}")
        if self.split not in SPLITS:
            raise ValueError(f"unknown split {self.split!r}; one of {SPLITS}")


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Model + loss; ``kind='auto'`` picks the paper's model for the dataset
    (the MLP classifier for synthetic MNIST, ridge for the ridge task)."""

    kind: str = "auto"
    hidden: int = 64                   # MLP hidden width
    lam: float = 0.1                   # ridge regularization

    def __post_init__(self):
        if self.kind not in MODEL_KINDS:
            raise ValueError(f"unknown model kind {self.kind!r}; "
                             f"one of {MODEL_KINDS}")

    def resolve(self, dataset: str) -> str:
        return _AUTO_MODEL[dataset] if self.kind == "auto" else self.kind


@dataclasses.dataclass(frozen=True)
class EvalSpec:
    """Held-out metrics at t == 1 and every ``every``-th round."""

    every: int = 10
    enabled: bool = True

    def __post_init__(self):
        if self.every < 1:
            raise ValueError(f"eval every must be >= 1, got {self.every}")


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One declarative OTA-FL experiment.  The optional top-level fields
    override the ``FLConfig`` fields of the same name when set."""

    fl: FLConfig = dataclasses.field(default_factory=FLConfig)
    data: DataSpec = dataclasses.field(default_factory=DataSpec)
    model: ModelSpec = dataclasses.field(default_factory=ModelSpec)
    eval: EvalSpec = dataclasses.field(default_factory=EvalSpec)
    server_opt: Optional[str] = None
    local_steps: Optional[int] = None
    local_lr: Optional[float] = None
    participation: Optional[float] = None
    participation_mode: Optional[str] = None
    k_block: Optional[int] = None
    active_gather: Optional[bool] = None
    device_mesh: Optional[int] = None
    driver: str = "scan"
    chunk_size: int = 16

    def __post_init__(self):
        if self.driver not in DRIVERS:
            raise ValueError(f"unknown driver {self.driver!r}; "
                             f"one of {DRIVERS}")
        self.fl_config()   # fail on an invalid axis override at spec time

    def fl_config(self) -> FLConfig:
        """The effective ``FLConfig`` with the spec's overrides folded in."""
        over = {k: v for k, v in (
            ("server_opt", self.server_opt),
            ("local_steps", self.local_steps),
            ("local_lr", self.local_lr),
            ("participation", self.participation),
            ("participation_mode", self.participation_mode),
            ("k_block", self.k_block),
            ("active_gather", self.active_gather),
            ("device_mesh", self.device_mesh),
        ) if v is not None}
        return dataclasses.replace(self.fl, **over) if over else self.fl


# ---------------------------------------------------------------------------
# sweep axes: one flat namespace over the nested spec
#
# A bare name resolves to the first scope, in this order, that has the
# field: "seed" -> fl.seed, "noise_var" -> channel.noise_var, "alpha" ->
# data.alpha (the dirichlet concentration; the feddyn strength is
# "client.alpha"), and bare "model" to the CHANNEL model (the model spec is
# reachable dotted only: "model.hidden").  Dotted names pick the scope.

_SCOPE_ORDER: Tuple[Tuple[str, type], ...] = (
    ("fl", FLConfig),
    ("channel", ChannelConfig),
    ("data", DataSpec),
    ("model", ModelSpec),
    ("client", ClientConfig),
)
_SCOPE_FIELDS = {scope: tuple(f.name for f in dataclasses.fields(cls))
                 for scope, cls in _SCOPE_ORDER}
# execution knobs are owned by the sweep engine; the scenario-axis
# overrides sweep through their FLConfig name (apply_axis writes the
# spec-level override, so a base-spec override cannot shadow the axis)
_UNSWEEPABLE = ("eval", "driver", "chunk_size")
_OVERRIDE_FIELDS = ("server_opt", "local_steps", "local_lr",
                    "participation", "participation_mode", "k_block",
                    "active_gather", "device_mesh")


def resolve_axis(name: str) -> Tuple[str, str]:
    """A sweep-axis name as ``(scope, field)``, scope one of ``fl``,
    ``channel``, ``data``, ``model``, ``client``.  Raises ``ValueError`` for
    unknown or unsweepable names."""
    if "." in name:
        scope, _, field = name.partition(".")
        if scope not in _SCOPE_FIELDS:
            raise ValueError(f"unknown sweep scope {scope!r} in {name!r}; "
                             f"one of {tuple(_SCOPE_FIELDS)}")
        if field not in _SCOPE_FIELDS[scope]:
            raise ValueError(f"{scope!r} spec has no field {field!r}; "
                             f"one of {_SCOPE_FIELDS[scope]}")
        return scope, field
    for scope, fields in _SCOPE_FIELDS.items():
        if name in fields:
            return scope, name
    if name in _UNSWEEPABLE or name in {
            f.name for f in dataclasses.fields(ExperimentSpec)}:
        raise ValueError(f"{name!r} is not sweepable (execution/eval knobs "
                         "are owned by the sweep engine; scenario-axis "
                         "overrides sweep via their FLConfig field)")
    known = sorted(set().union(*_SCOPE_FIELDS.values()))
    raise ValueError(f"unknown sweep axis {name!r}; known fields: {known}")


def apply_axis(spec: ExperimentSpec, name: str, value: Any) -> ExperimentSpec:
    """``spec`` with one resolved axis field replaced (the dataclasses'
    ``__post_init__`` validate the result)."""
    scope, field = resolve_axis(name)
    if scope == "fl":
        if field in _OVERRIDE_FIELDS:
            return dataclasses.replace(spec, **{field: value})
        if field == "num_devices":
            # K lives in FLConfig and in its ChannelConfig: move them
            # together, or setup draws a channel of the old length
            channel = dataclasses.replace(spec.fl.channel, num_devices=value)
            return dataclasses.replace(
                spec, fl=dataclasses.replace(spec.fl, num_devices=value,
                                             channel=channel))
        return dataclasses.replace(
            spec, fl=dataclasses.replace(spec.fl, **{field: value}))
    if scope == "channel":
        if field == "num_devices":
            raise ValueError("sweep the cohort size via 'num_devices' (the "
                             "FLConfig field) -- it keeps the channel length "
                             "in sync")
        channel = dataclasses.replace(spec.fl.channel, **{field: value})
        return dataclasses.replace(
            spec, fl=dataclasses.replace(spec.fl, channel=channel))
    if scope == "client":
        client = dataclasses.replace(spec.fl.client, **{field: value})
        return dataclasses.replace(
            spec, fl=dataclasses.replace(spec.fl, client=client))
    if scope == "data":
        return dataclasses.replace(
            spec, data=dataclasses.replace(spec.data, **{field: value}))
    return dataclasses.replace(
        spec, model=dataclasses.replace(spec.model, **{field: value}))


def apply_axes(spec: ExperimentSpec,
               coords: Mapping[str, Any]) -> ExperimentSpec:
    """Fold a mapping of axis name -> value into a spec: one grid point."""
    for name, value in coords.items():
        spec = apply_axis(spec, name, value)
    return spec
