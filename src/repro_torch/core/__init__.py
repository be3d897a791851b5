"""The paper's core: scheme registry, channel, amplification, OTA aggregate.

Re-exports the names of ``repro/core/__init__.py`` that the port has; the
others (the block-fading and noise draws, the per-device norm helpers, the
in-graph Problem-3 solver, ``convergence``) wait for their ROADMAP items."""
from repro_torch.core.channel import (ChannelConfig, draw_channel,
                                      DEFAULT_B_MAX, DEFAULT_CHANNEL_MEAN,
                                      DEFAULT_MODEL, DEFAULT_NOISE_VAR,
                                      DEFAULT_THETA_TH)
from repro_torch.core.ota import (OTAConfig, BACKENDS, aggregate,
                                  apply_update, device_transform, superpose,
                                  server_post, participation_fold)
from repro_torch.core.schemes import (Scheme, DeviceStats,
                                      register as register_scheme,
                                      get as get_scheme)
from repro_torch.core.amplification import (Problem3Solution, solve_problem3,
                                            problem3_objective, optimal_S,
                                            case1_receiver_gain,
                                            optimize_case1, optimize_case2,
                                            Case1Parameters, Case2Parameters)


def __getattr__(name):
    # a live view of the scheme registry (PEP 562), as the reference's
    if name == "SCHEMES":
        from repro_torch.core import schemes as _schemes
        return _schemes.names()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
