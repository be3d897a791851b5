"""The paper's core: scheme registry, channel, amplification, OTA aggregate
and the convergence bounds.

Re-exports the names of ``repro/core/__init__.py`` (the in-round Problem-3
solver under its own name, ``solve_problem3_torch``)."""
from repro_torch.core.channel import (ChannelConfig, draw_channel,
                                      channel_for_round, draw_fading_state,
                                      draw_noise, envelope,
                                      DEFAULT_B_MAX, DEFAULT_CHANNEL_MEAN,
                                      DEFAULT_MODEL, DEFAULT_NOISE_VAR,
                                      DEFAULT_THETA_TH)
from repro_torch.core.ota import (OTAConfig, BACKENDS, aggregate,
                                  apply_update, device_transform, superpose,
                                  server_post, participation_fold,
                                  per_device_norm, per_device_sq_norm,
                                  per_device_mean_std, tree_num_elements,
                                  transmit_norms, transmit_energy)
from repro_torch.core.schemes import (Scheme, DeviceStats,
                                      register as register_scheme,
                                      get as get_scheme)
from repro_torch.core.amplification import (Problem3Solution,
                                            Problem3SolutionTorch,
                                            solve_problem3,
                                            solve_problem3_torch,
                                            solve_problem6,
                                            problem3_objective, optimal_S,
                                            case1_receiver_gain,
                                            optimize_case1, optimize_case2,
                                            Case1Parameters, Case2Parameters)
from repro_torch.core.convergence import (case1_bound, case2_bound, q_max,
                                          case2_bias_floor, s_for_epsilon,
                                          variance_term, rounds_to_reach,
                                          fit_rate, RateFit)


def __getattr__(name):
    # a live view of the scheme registry (PEP 562), as the reference's
    if name == "SCHEMES":
        from repro_torch.core import schemes as _schemes
        return _schemes.names()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
