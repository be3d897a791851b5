"""TL005: an unclassified field, a stale table entry, a batched field the
collapse misses and a structural field it collapses."""
import dataclasses

config = dataclasses.dataclass(frozen=True)

BATCHED_FL_FIELDS = ("seed", "eta")
STRUCTURAL_FL_FIELDS = ("num_devices", "scheme", "retired_knob")


@config
class FLConfig:
    num_devices: int = 20
    scheme: str = "normalized"
    seed: int = 0
    eta: float = 0.01
    new_knob: float = 1.0


def _structural_collapse(cfg: FLConfig) -> FLConfig:
    return dataclasses.replace(cfg, seed=0, scheme="normalized")
