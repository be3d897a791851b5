"""Convergence theory of the paper (Sec. III) as executable bounds (port of
``repro/core/convergence.py``, plain numpy, the same code).

The exact right-hand sides of Lemma 1 (eq. (13)) and Lemma 2 (eq. (15));
tests hold empirical trajectories of the runtime to them (the bounds must
hold and show the claimed rates).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np


def _sum_hb(h, b) -> float:
    return float(np.sum(np.asarray(h, np.float64) * np.asarray(b, np.float64)))


def variance_term(h, b, noise_var: float, n: int) -> float:
    """The recurring term: sum_k 4 h_k^2 b_k^2 + (sum_k h_k b_k)^2 + n sigma^2."""
    h = np.asarray(h, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sum(4.0 * h * h * b * b) + _sum_hb(h, b) ** 2 + n * noise_var)


def case1_bound(T: int, p: float, a: float, h, b, L: float, theta_th: float,
                noise_var: float, n: int, expected_loss_drop: float) -> float:
    """Lemma 1, eq. (13): bound on min_{t<=T} ||grad F(w_t)|| with eta_t = 1/t^p.

    Sub-linear: both terms scale as 1/T^{1-p}.
    """
    if not (0.5 < p < 1.0):
        raise ValueError("p must lie in (1/2, 1)")
    shb = _sum_hb(h, b)
    if a <= 0 or shb <= 0:
        raise ValueError("need a > 0 and sum h_k b_k > 0")
    cos_th = math.cos(theta_th)
    t1 = expected_loss_drop / (T ** (1.0 - p) * cos_th * a * shb)
    t2 = (2.0 * p / (T ** (1.0 - p) * (2.0 * p - 1.0))) \
        * (a * L / (2.0 * cos_th * shb)) * variance_term(h, b, noise_var, n)
    return t1 + t2


def q_max(eta: float, a: float, h, b, M: float, G: float, theta_th: float) -> float:
    """Eq. (14): contraction factor of the strongly-convex case."""
    val = 1.0 - 2.0 * M * math.cos(theta_th) * eta * a * _sum_hb(h, b) / G
    return max(val, 0.0)


def case2_bound(T: int, eta: float, a: float, h, b, L: float, M: float, G: float,
                theta_th: float, noise_var: float, n: int,
                w1_dist_sq: float) -> float:
    """Lemma 2, eq. (15): bound on F(w_T) - F(w*) under constant eta.

    Linear rate (q_max)^{T-1} toward a bias floor.
    """
    q = q_max(eta, a, h, b, M, G, theta_th)
    shb = _sum_hb(h, b)
    first = 0.5 * L * (q ** (T - 1)) * w1_dist_sq
    coeff = max(a * eta * G / (2.0 * M * math.cos(theta_th) * shb), (a * eta) ** 2)
    second = 0.5 * L * coeff * variance_term(h, b, noise_var, n)
    return first + second


def case2_bias_floor(Z: float, L: float, G: float, M: float, theta_th: float,
                     s: float) -> float:
    """Minimized second term of (15) for q_max = s in (0,1):
    C2(s) = (Z+1) L G^2 (1-s) / (8 M^2 cos^2 th)."""
    return (Z + 1.0) * L * G * G * (1.0 - s) / (8.0 * M * M * math.cos(theta_th) ** 2)


def s_for_epsilon(epsilon: float, Z: float, L: float, G: float, M: float,
                  theta_th: float) -> float:
    """Paper Sec. IV-B: s = 1 - 8 M^2 cos^2(th) eps / ((Z+1) L G^2)."""
    return 1.0 - 8.0 * M * M * math.cos(theta_th) ** 2 * epsilon / ((Z + 1.0) * L * G * G)


def rounds_to_reach(epsilon_extra: float, q: float, w1_dist_sq: float, L: float) -> int:
    """Rounds needed for the linear term (L/2) q^{T-1} ||w1-w*||^2 <= epsilon_extra."""
    if not (0.0 < q < 1.0):
        return 1
    lhs = 0.5 * L * w1_dist_sq
    if lhs <= epsilon_extra:
        return 1
    return 1 + math.ceil(math.log(epsilon_extra / lhs) / math.log(q))


@dataclasses.dataclass(frozen=True)
class RateFit:
    """Least-squares rate fit of a trajectory, for validating claimed rates."""
    exponent: float     # fit of log(err) ~ exponent * log(t)  (sub-linear check)
    ratio: float        # geometric mean of err_{t+1}/err_t     (linear check)


def fit_rate(errors: Sequence[float], burn_in: int = 2) -> RateFit:
    e = np.asarray(errors, np.float64)[burn_in:]
    e = np.maximum(e, 1e-30)
    t = np.arange(burn_in + 1, burn_in + 1 + e.shape[0], dtype=np.float64)
    slope = float(np.polyfit(np.log(t), np.log(e), 1)[0])
    ratios = e[1:] / e[:-1]
    return RateFit(exponent=slope, ratio=float(np.exp(np.mean(np.log(ratios)))))
