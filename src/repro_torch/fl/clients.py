"""Client-algorithm configuration (the ``FLConfig.client`` field; port of
``repro/fl/clients.py``'s ``ClientConfig``).  Only ``sgd`` -- the paper's
round -- is ported; the other registered algorithms raise
``NotImplementedError``."""
from __future__ import annotations

from repro_torch._config import config

ALGOS = ("sgd", "fedprox", "feddyn", "scaffold")


@config
class ClientConfig:
    """Which client algorithm runs on the devices, and its constants."""

    algo: str = "sgd"
    mu: float = 0.0          # fedprox: proximal term mu/2 ||w - w_t||^2
    alpha: float = 0.01      # feddyn: dynamic-regularization strength
    variate_scheme: str = "normalized_restored"

    def __post_init__(self):
        if self.algo not in ALGOS:
            raise ValueError(f"unknown client algorithm {self.algo!r}; "
                             f"one of {ALGOS}")
        if self.algo != "sgd":
            raise NotImplementedError(
                f"client algorithm {self.algo!r} is not ported yet: ROADMAP "
                "queue 1 item 12")
