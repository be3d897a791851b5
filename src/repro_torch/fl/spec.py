"""The declarative experiment spec (port of ``repro/fl/spec.py``): one frozen
object describes a full OTA-FL experiment -- channel/scheme/schedule
(``FLConfig``), data (task, split, batch size), model/loss, eval policy,
and the scenario-axis overrides.

``driver`` defaults to ``"scan"``, the chunked engine (a CUDA graph of the
round on the card), as in the reference; ``"python"`` runs the same round
body one round at a time and gives the same bits.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.fed.runtime import DRIVERS, FLConfig

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
