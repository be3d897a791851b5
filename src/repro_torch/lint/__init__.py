"""tracelint for the port: static checks of the port's own contracts.

Run as ``PYTHONPATH=src python -m repro_torch.lint`` (default paths: the
port's package, ``chip_smoke.py``, ``tools/`` and ``tests/test_torch_*.py``;
the CUDA sources under ``kernels/csrc`` are read too).

The port's contracts -- a round body a CUDA graph can capture (no host
sync), configs that share an engine only when their structure is equal, the
history's key set, draws from seeded generators, fp32 accumulation in a
fixed order in the kernels, no register spills -- are held at run time by
tests with given inputs, or only on the card.  These rules check them on
every line.  The engine (registry, suppressions, TL000, ``--json``,
``--self-test``, ``--fix``) is the JAX package's ``repro.lint``; the rules
are the port's, numbered as the reference rule each stands for.
"""
from .base import Finding, Rule, all_rules, get, names, register  # noqa: F401

# importing the rule modules populates the registry
from . import rules_trace      # noqa: F401  TL001-TL003
from . import rules_kernels    # noqa: F401  TL004, TL010
from . import rules_contracts  # noqa: F401  TL005-TL006
from . import rules_buffers    # noqa: F401  TL007
from . import rules_obs        # noqa: F401  TL009

from .engine import (apply_fixes, build_project, lint,  # noqa: F401
                     render_human, render_json, self_test)
