"""Run manifests of the port (port of ``repro/obs``'s ``manifest`` layer):
spec JSON, config hash, structural signature, params digest, and the
torch/CUDA/GPU identity.  The recorders and the profiling hooks wait for
ROADMAP queue 1 item 14."""
from . import manifest  # noqa: F401
from .manifest import (config_sha256, params_sha256,  # noqa: F401
                       run_manifest, spec_json, structural_signature)
