"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on: ``"cuda"`` by default.
    Raises ``RuntimeError`` when CUDA is asked for and is not available --
    the port never carries on quietly on the CPU; callers that want the CPU
    (the tests) pass ``device="cpu"``.  ``"meta"`` computes shapes only
    (the dry run, ``launch.dryrun``: nothing is drawn or allocated, and
    every op takes its plain route, as on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r}; 'cuda', 'cpu' "
                         "or 'meta'")
    return dev
