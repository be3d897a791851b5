"""TL005: every field claimed once, the batched ones collapsed."""
import dataclasses

config = dataclasses.dataclass(frozen=True)

BATCHED_FL_FIELDS = ("seed", "eta")
STRUCTURAL_FL_FIELDS = ("num_devices", "scheme")


@config
class FLConfig:
    num_devices: int = 20
    scheme: str = "normalized"
    seed: int = 0
    eta: float = 0.01


def _structural_collapse(cfg: FLConfig) -> FLConfig:
    return dataclasses.replace(cfg, seed=0, eta=0.01)
