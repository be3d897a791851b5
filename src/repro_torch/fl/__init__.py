"""The declarative experiment API of the port: spec -> ``Experiment``, and
a grid of specs -> ``run_sweep``.

Names resolve on first access (PEP 562): ``repro_torch.fed.runtime``
imports ``repro_torch.fl.clients``, and an eager import of the runtime here
would close that cycle."""
import importlib

_EXPORTS = {
    "ChannelConfig": "repro_torch.core.channel",
    "ClientConfig": "repro_torch.fl.clients",
    "FLConfig": "repro_torch.fed.runtime",
    "Experiment": "repro_torch.fl.experiment",
    "DataSpec": "repro_torch.fl.spec",
    "EvalSpec": "repro_torch.fl.spec",
    "ExperimentSpec": "repro_torch.fl.spec",
    "ModelSpec": "repro_torch.fl.spec",
    "apply_axes": "repro_torch.fl.spec",
    "apply_axis": "repro_torch.fl.spec",
    "resolve_axis": "repro_torch.fl.spec",
    "SweepPoint": "repro_torch.fl.sweep",
    "SweepResult": "repro_torch.fl.sweep",
    "SweepSpec": "repro_torch.fl.sweep",
    "run_sweep": "repro_torch.fl.sweep",
    "Task": "repro_torch.fl.tasks",
    "build_task": "repro_torch.fl.tasks",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
