"""The flight recorder of the port (port of ``repro/obs``): streaming
telemetry, profiling hooks and run manifests, all on the host.

* **Engine streaming**: ``repro_torch.fed.runtime.run`` / ``run_batched``
  take a ``recorder`` and emit each chunk's ``DIAG_KEYS`` rows, the eval
  metrics, the chunk's wall clock, its round launches and its build and
  capture deltas, after the chunk's history has come back to the host.
* **Profiling hooks** (:mod:`repro_torch.obs.profiling`):
  ``REPRO_OBS_PROFILE`` turns ``Experiment.run`` into a ``torch.profiler``
  trace with one range per chunk; /proc RSS readers.
* **Run manifests** (:mod:`repro_torch.obs.manifest`): spec JSON, config
  hash, structural signature, params digest and the torch/CUDA/GPU
  identity.

Telemetry is trajectory-invisible: recorder on against off, with any sink,
gives the same bits in params, client state and history on both drivers,
the streamed round and a batched sweep (``tests/test_torch_obs.py``).
"""
from .base import Recorder, get, make, names, register  # noqa: F401

# importing the sink module fills the registry
from .recorders import (CsvRecorder, JsonlRecorder,  # noqa: F401
                        MemoryRecorder, NullRecorder)

from . import manifest  # noqa: F401
from . import profiling  # noqa: F401
from .manifest import (config_sha256, params_sha256,  # noqa: F401
                       run_manifest, spec_json, structural_signature)
