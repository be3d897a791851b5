"""Roofline terms of one rank's step (the port of
``repro/analysis/roofline.py``):

    compute term    = FLOPs a rank / peak FLOP/s
    memory term     = bytes a rank / HBM bytes/s
    collective term = collective bytes a rank / link bytes/s

The counts are one rank's, so dividing by one card's peaks is the global
form (the totals over ``chips`` cards) divided by ``chips`` cards' peaks.
They come from the dry run (``launch.dryrun``), which plays one rank of the
production mesh on meta tensors: FLOPs from ``torch.utils.flop_counter``'s
formulas, bytes accessed the summed input and output bytes of every aten
op the rank dispatches (what eager PyTorch touches; a fused program
touches no more, so it bounds one from above), and the collectives' bytes
where the port makes them (``distribution.ota_collectives``), one key a
kind.  The convention is the reference's: a collective's per-rank output
bytes (an all-gather's output is the gathered buffer, so a fold in rank
order over n ranks, the port's all-gather and fold, counts n parts).

Hardware model: one NVIDIA H100 SXM (H100 datasheet): 989 TFLOP/s dense
bf16 on the tensor cores, 3.35 TB/s of HBM3, and NVLink 4 at 900 GB/s a
card in both directions, 450 GB/s a direction.  These are predictions from
the datasheet's constants, not measurements.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict

from repro_torch.distribution.ota_collectives import COLLECTIVES

# H100 SXM per-card constants (NVIDIA H100 Tensor Core GPU datasheet)
PEAK_FLOPS = 989e12          # bf16 dense, FLOP/s
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # NVLink 4, bytes/s a direction (900 GB/s both)
HBM_BYTES = 80e9             # the card's memory, bytes ("80 GB")



@dataclasses.dataclass
class RooflineReport:
    name: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: int
    coll_breakdown: Dict[str, int]
    model_flops: float                 # 6*N*D (train) or 2*N_active*tokens
    memory_analysis: str = ""
    # derived
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    useful_flops_ratio: float = 0.0

    def finalize(self) -> "RooflineReport":
        self.compute_s = self.flops_per_chip / PEAK_FLOPS
        self.memory_s = self.bytes_per_chip / HBM_BW
        self.collective_s = self.coll_bytes_per_chip / LINK_BW
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bottleneck = max(terms, key=terms.get)
        total_flops = self.flops_per_chip * self.chips
        self.useful_flops_ratio = (self.model_flops / total_flops
                                   if total_flops else 0.0)
        return self

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def from_counts(name: str, chips: int, flops: float, nbytes: float,
                coll: Dict[str, int], model_flops: float,
                memory_analysis: str = "") -> RooflineReport:
    """The report of one rank's counts (``collective_bytes`` by kind)."""
    breakdown = {k: int(coll.get(k, 0)) for k in COLLECTIVES}
    return RooflineReport(
        name=name, chips=chips, flops_per_chip=flops, bytes_per_chip=nbytes,
        coll_bytes_per_chip=sum(breakdown.values()),
        coll_breakdown=breakdown, model_flops=model_flops,
        memory_analysis=memory_analysis).finalize()


def model_flops_for(cfg, shape, n_params_active: int) -> float:
    """6*N*D for training (fwd+bwd), 2*N*D for inference; D = tokens."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_params_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_params_active * tokens
    # decode: one token per sequence per step
    return 2.0 * n_params_active * shape.global_batch


def save_report(path: str, reports) -> None:
    with open(path, "w") as f:
        json.dump([r.to_dict() if isinstance(r, RooflineReport) else r
                   for r in reports], f, indent=2)
