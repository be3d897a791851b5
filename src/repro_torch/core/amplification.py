"""System-parameter optimization (port of ``repro/core/amplification.py``:
paper Sec. IV, Problem 3, Algorithm 1, Cases I and II).

Everything reduces to **Problem 3**:

    Z = min_b  ( sum_k 4 h_k^2 b_k^2 + n sigma^2 ) / ( sum_k h_k b_k )^2
        s.t.   0 <= b_k <= b_k^max

solved optimally by a bisection over ``r`` with an inner convex feasibility
program ``min_{b in box} sqrt(sum 4 h^2 b^2 + c) - r sum h b`` (L-BFGS-B
from the upper corner).  This is host-side float64 NumPy/SciPy code, the
same as the reference's, so both packages give the same ``b`` and ``a`` on
the same ``h``.  The in-round JAX solver (``solve_problem3_jax``, block
fading) and the literal Problem 6 are not ported yet (ROADMAP queue 1
item 5).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
from scipy import optimize as sopt


@dataclasses.dataclass(frozen=True)
class Problem3Solution:
    b: np.ndarray          # optimal per-device amplification factors
    Z: float               # optimal objective of Problem 3
    r_star: float          # optimal r from the bisection (Z = r_star^2)
    iterations: int        # bisection iterations used


def problem3_objective(b: np.ndarray, h: np.ndarray, noise_var: float,
                       n: int) -> float:
    """Objective of Problem 3: (sum 4 h^2 b^2 + n sigma^2) / (sum h b)^2."""
    b = np.asarray(b, dtype=np.float64)
    h = np.asarray(h, dtype=np.float64)
    num = float(np.sum(4.0 * h * h * b * b) + n * noise_var)
    den = float(np.sum(h * b)) ** 2
    return num / den


def _phi(b: np.ndarray, r: float, h: np.ndarray,
         c: float) -> Tuple[float, np.ndarray]:
    """phi_r(b) = sqrt(sum 4 h^2 b^2 + c) - r sum h b, with gradient."""
    q = np.sqrt(np.sum(4.0 * h * h * b * b) + c)
    val = q - r * float(np.sum(h * b))
    grad = (4.0 * h * h * b) / q - r * h
    return val, grad


def _min_phi_over_box(r: float, h: np.ndarray, c: float,
                      b_max: np.ndarray) -> Tuple[float, np.ndarray]:
    """Inner convex feasibility program of the bisection: (min phi, argmin)."""
    res = sopt.minimize(
        _phi, x0=b_max.copy(), args=(r, h, c), jac=True,
        method="L-BFGS-B", bounds=[(0.0, bm) for bm in b_max],
        options={"maxiter": 500, "ftol": 1e-16, "gtol": 1e-14},
    )
    return float(res.fun), np.asarray(res.x)


def solve_problem3(h: Sequence[float], noise_var: float, n: int,
                   b_max: Sequence[float] | float, tol: float = 1e-10,
                   max_iters: int = 200) -> Problem3Solution:
    """Algorithm 1 Part I: bisection on r + convex feasibility check.
    ``n`` is the model dimension N.  Memoized on the exact inputs."""
    h = np.asarray(h, dtype=np.float64)
    if np.isscalar(b_max):
        b_max = np.full_like(h, float(b_max))
    else:
        b_max = np.asarray(b_max, dtype=np.float64)
        if b_max.shape != h.shape:
            raise ValueError(f"b_max shape {b_max.shape} must match h shape "
                             f"{h.shape}")
    sol = _solve_problem3_cached(h.tobytes(), h.shape[0], float(noise_var),
                                 int(n), b_max.tobytes(), float(tol),
                                 int(max_iters))
    return dataclasses.replace(sol, b=sol.b.copy())


@functools.lru_cache(maxsize=512)
def _solve_problem3_cached(h_bytes: bytes, k: int, noise_var: float, n: int,
                           b_max_bytes: bytes, tol: float,
                           max_iters: int) -> Problem3Solution:
    h = np.frombuffer(h_bytes, np.float64, count=k)
    b_max = np.frombuffer(b_max_bytes, np.float64, count=k)
    if np.any(h < 0):
        raise ValueError("channel coefficients must be non-negative magnitudes")
    if not np.any(h * b_max > 0):
        raise ValueError("sum h_k b_k^max must be positive for feasibility")
    c = float(n) * float(noise_var)
    # noiseless edge: a vanishing floor keeps the bisection well-posed
    c = max(c, 1e-12 * float(np.sum(4.0 * h * h * b_max * b_max)))

    r_hi = math.sqrt(problem3_objective(b_max, h, noise_var, n))
    r_lo = 0.0
    b_best = b_max.copy()
    iters = 0
    while (r_hi - r_lo) > tol * max(1.0, r_hi) and iters < max_iters:
        r_mid = 0.5 * (r_lo + r_hi)
        val, b_arg = _min_phi_over_box(r_mid, h, c, b_max)
        if val <= 0.0:
            r_hi = r_mid
            b_best = b_arg
        else:
            r_lo = r_mid
        iters += 1

    Z = problem3_objective(b_best, h, noise_var, n)
    return Problem3Solution(b=b_best, Z=Z, r_star=math.sqrt(Z),
                            iterations=iters)


def optimal_S(Z: float, L: float, p: float, expected_loss_drop: float) -> float:
    """Case I, eq. (26): S* = sqrt( L (Z+1) p / ((2p-1) E{F(w1)-F(wT+1)}) )."""
    if not (0.5 < p < 1.0):
        raise ValueError("p must lie in (1/2, 1)")
    if expected_loss_drop <= 0:
        raise ValueError("expected loss drop must be positive")
    return math.sqrt(L * (Z + 1.0) * p / ((2.0 * p - 1.0) * expected_loss_drop))


def case1_receiver_gain(S: float, h: np.ndarray, b: np.ndarray) -> float:
    """Case I: a = 1 / (S * sum_k h_k b_k), from constraint (18a)."""
    denom = S * float(np.sum(h * b))
    if denom <= 0:
        raise ValueError("S * sum h_k b_k must be positive")
    return 1.0 / denom


@dataclasses.dataclass(frozen=True)
class Case1Parameters:
    b: np.ndarray
    a: float
    S: float
    Z: float
    p: float


def optimize_case1(h, noise_var, n, b_max, L, p, expected_loss_drop,
                   tol: float = 1e-10) -> Case1Parameters:
    """Full Algorithm 1: Problem 3 then eq. (26) then a = 1/(S sum h b)."""
    sol = solve_problem3(h, noise_var, n, b_max, tol=tol)
    S = optimal_S(sol.Z, L, p, expected_loss_drop)
    a = case1_receiver_gain(S, np.asarray(h, dtype=np.float64), sol.b)
    return Case1Parameters(b=sol.b, a=a, S=S, Z=sol.Z, p=p)


@dataclasses.dataclass(frozen=True)
class Case2Parameters:
    b: np.ndarray
    a_eta: float           # the product a*eta fixed by eq. (30)
    s: float               # chosen contraction factor q_max in (0, 1)
    Z: float
    bias_bound: float      # (Z+1) L G^2 (1-s) / (8 M^2 cos^2 th)


def optimize_case2(h, noise_var, n, b_max, L, M, G, theta_th,
                   s: Optional[float] = None, epsilon: Optional[float] = None,
                   tol: float = 1e-10) -> Case2Parameters:
    """Case II (Sec. IV-B, q_max in (0,1) branch): exactly one of ``s``
    (target contraction) or ``epsilon`` (target bias); a*eta from eq. (30)."""
    if (s is None) == (epsilon is None):
        raise ValueError("specify exactly one of s / epsilon")
    sol = solve_problem3(h, noise_var, n, b_max, tol=tol)
    cos2 = math.cos(theta_th) ** 2
    if s is None:
        s = 1.0 - 8.0 * M * M * cos2 * epsilon / ((sol.Z + 1.0) * L * G * G)
        if s <= 0.0:
            s = 1e-6
    if not (0.0 < s < 1.0):
        raise ValueError(f"target contraction s must lie in (0,1), got {s}")
    h_arr = np.asarray(h, dtype=np.float64)
    sum_hb = float(np.sum(h_arr * sol.b))
    a_eta = G * (1.0 - s) / (2.0 * M * math.cos(theta_th) * sum_hb)
    bias = (sol.Z + 1.0) * L * G * G * (1.0 - s) / (8.0 * M * M * cos2)
    return Case2Parameters(b=sol.b, a_eta=a_eta, s=s, Z=sol.Z, bias_bound=bias)
