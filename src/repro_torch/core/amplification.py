"""System-parameter optimization (port of ``repro/core/amplification.py``:
paper Sec. IV, Problem 3, Algorithm 1, Cases I and II).

Everything reduces to **Problem 3**:

    Z = min_b  ( sum_k 4 h_k^2 b_k^2 + n sigma^2 ) / ( sum_k h_k b_k )^2
        s.t.   0 <= b_k <= b_k^max

solved optimally by a bisection over ``r`` with an inner convex feasibility
program ``min_{b in box} sqrt(sum 4 h^2 b^2 + c) - r sum h b`` (L-BFGS-B
from the upper corner).  This is host-side float64 NumPy/SciPy code, the
same as the reference's, so both packages give the same ``b`` and ``a`` on
the same ``h``.  The reference's in-round solver (``solve_problem3_jax``,
block fading) is ``solve_problem3_torch`` here: a batched fp32 re-solve
that a time-varying channel's refresh runs on the host once a chunk; the
literal Problem 6 is ``solve_problem6``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
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


class Problem3SolutionTorch(NamedTuple):
    """``solve_problem3_torch``'s result: [R, K] (or [K]) ``b`` and [R] (or
    0-d) ``Z``, ``r_star`` and ``iterations``."""

    b: torch.Tensor
    Z: torch.Tensor
    r_star: torch.Tensor
    iterations: torch.Tensor


EPS_DENOM = 1e-20


def _waterfill(r: np.ndarray, u_max: np.ndarray, q: np.ndarray,
               lo: np.ndarray, d_cap: np.ndarray, m: np.ndarray,
               c: np.ndarray):
    """Closed-form inner feasibility program of [R] rows at once (the
    reference's ``_phi_min_waterfill``): the minimum over the box of
    ``phi_r(u) = sqrt(4 ||u||^2 + c) - r 1'u`` in received-signal
    coordinates ``u_k = h_k b_k`` lies on the water-filling path
    ``u_k(t) = min(t, u_max_k)``, piecewise affine in t between the sorted
    caps ``q``; on each piece the stationary point solves
    ``16 t^2 = r^2 (4 m t^2 + 4 D + c)`` (m uncapped coordinates, D the
    squared caps below).  Evaluating phi_r at every clamped stationary
    point is exact.  ``q``, ``lo``, ``d_cap`` and ``m`` depend on the caps
    alone and come sorted once a solve.  fp32 throughout; returns ``(min
    phi_r, argmin t)``, each [R]."""
    r1 = r[:, None]
    denom = np.float32(16.0) - np.float32(4.0) * m * r1 * r1
    t_star = r1 * np.sqrt((np.float32(4.0) * d_cap + c[:, None])
                          / np.maximum(denom, np.float32(EPS_DENOM)))
    # denom <= 0: phi_r falls over the whole piece -> its right end
    t_star = np.where(denom > 0.0, t_star, q[:, -1:])
    cand = np.concatenate([np.minimum(np.maximum(t_star, lo), q),
                           q[:, -1:]], axis=1)                # [R, K+1]
    u = np.minimum(cand[:, :, None], u_max[:, None, :])      # [R, K+1, K]
    vals = (np.sqrt(np.float32(4.0) * np.sum(u * u, axis=2) + c[:, None])
            - r1 * np.sum(u, axis=2))
    i = np.argmin(vals, axis=1)[:, None]
    return (np.take_along_axis(vals, i, 1)[:, 0],
            np.take_along_axis(cand, i, 1)[:, 0])


def _f32(v) -> np.ndarray:
    return np.asarray(torch.as_tensor(v).detach().cpu(), dtype=np.float32)


def solve_problem3_torch(h, noise_var, n: int, b_max, tol: float = 1e-6,
                         max_iters: int = 100) -> Problem3SolutionTorch:
    """Algorithm 1 Part I in fp32 on the host: bisection on r with the
    closed-form water-filling feasibility check, the counterpart of the
    reference's ``solve_problem3_jax`` (``repro/core/amplification.py``)
    with its arithmetic: fp32, relative ``tol`` on r, ``max_iters``, the
    noiseless floor ``c = max(n sigma^2, 1e-12 sum 4 u_max^2)`` and the
    polish (the true objective at the argmin).

    ``h`` is [K] or a stack [R, K] of rows (rounds x lanes); ``noise_var``
    and ``b_max`` are scalars or [R] vectors a row (``b_max`` also [R, K],
    or [K] with a [K] ``h``).  Every row bisects until its own condition
    fails and is frozen after, as the reference's vmapped ``while_loop``
    masks its finished lanes: each step computes every row and keeps the
    live rows' results, so a row's bits do not depend on the rows beside
    it.  The arithmetic runs in numpy fp32 (at these sizes a torch call's
    fixed cost would set the pace); returns fp32 CPU tensors, squeezed to
    ``h``'s rank."""
    h = _f32(h)
    solo = h.ndim == 1
    if solo:
        h = h[None]
    rows = h.shape[0]
    b_max = _f32(b_max)
    if b_max.ndim == 1 and not solo:
        b_max = b_max[:, None]
    u_max = h * np.broadcast_to(b_max, h.shape)
    noise = np.broadcast_to(_f32(noise_var).reshape(-1), (rows,))
    four = np.float32(4.0)
    c = np.float32(n) * noise
    c = np.maximum(c, np.float32(1e-12) * np.sum(four * u_max * u_max,
                                                   axis=1))
    r_hi = (np.sqrt(four * np.sum(u_max * u_max, axis=1) + c)
            / np.sum(u_max, axis=1))
    r_lo = np.zeros(rows, np.float32)
    t_best = np.max(u_max, axis=1)             # upper corner: feasible
    it = np.zeros(rows, np.int32)
    # the caps do not change inside a solve: sort once a row
    q = np.sort(u_max, axis=1)
    k = q.shape[1]
    zero = np.zeros((rows, 1), np.float32)
    lo = np.concatenate([zero, q[:, :-1]], axis=1)
    d_cap = np.concatenate([zero, np.cumsum(q * q, axis=1)[:, :-1]], axis=1)
    m = (k - np.arange(k)).astype(np.float32)[None, :]
    tol = np.float32(tol)
    while True:
        live = ((r_hi - r_lo) > tol * np.maximum(np.float32(1.0), r_hi)) \
            & (it < max_iters)
        if not live.any():
            break
        r_mid = np.float32(0.5) * (r_lo + r_hi)
        val, t_arg = _waterfill(r_mid, u_max, q, lo, d_cap, m, c)
        feas = val <= 0.0
        r_lo = np.where(live & ~feas, r_mid, r_lo)
        r_hi = np.where(live & feas, r_mid, r_hi)
        t_best = np.where(live & feas, t_arg, t_best)
        it = it + live.astype(np.int32)
    u = np.minimum(t_best[:, None], u_max)
    pos = h > 0
    b = np.where(pos, u / np.where(pos, h, np.float32(1.0)), np.float32(0.0))
    Z = (four * np.sum(u * u, axis=1) + c) / np.square(np.sum(u, axis=1))
    sol = Problem3SolutionTorch(*(torch.from_numpy(np.ascontiguousarray(v))
                                  for v in (b, Z, np.sqrt(Z), it)))
    if solo:
        return Problem3SolutionTorch(*(v[0] for v in sol))
    return sol


def solve_problem6(r: float, h: np.ndarray, noise_var: float, n: int,
                   b_max: np.ndarray) -> Tuple[float, np.ndarray]:
    """Literal Problem 6 (paper eq. (25)): min v s.t. the cone constraint
    and 0 <= b_k <= b_k^max + v; a cross-check of the value-form
    feasibility test (V(r) <= 0 iff min_b phi_r(b) <= 0).  SciPy SLSQP
    (convex, Lemma 3), the reference's code."""
    K = h.shape[0]
    c = float(n) * float(noise_var)

    def obj(x):
        return x[-1]

    def obj_jac(x):
        g = np.zeros_like(x)
        g[-1] = 1.0
        return g

    def cone(x):
        b = x[:K]
        return r * float(np.sum(h * b)) - math.sqrt(
            float(np.sum(4 * h * h * b * b)) + c)

    cons = [{"type": "ineq", "fun": cone}]
    # 0 <= b_k <= b_max_k + v  ->  b_max_k + v - b_k >= 0
    for k in range(K):
        cons.append({"type": "ineq",
                     "fun": (lambda x, k=k: b_max[k] + x[-1] - x[k])})
        cons.append({"type": "ineq", "fun": (lambda x, k=k: x[k])})

    def solve_from(x0):
        return sopt.minimize(obj, x0, jac=obj_jac, constraints=cons,
                             method="SLSQP",
                             options={"maxiter": 500, "ftol": 1e-12})

    def accepted(res):
        return (res.success and cone(res.x) >= -1e-8
                and float(np.min(res.x[:K])) >= -1e-10)

    res = solve_from(np.concatenate([b_max, [0.0]]))
    if not accepted(res):
        # SLSQP can fail from the cone-infeasible b_max start.  The cone is
        # satisfiable at some scale iff r > 2/sqrt(K); if it is, retry from
        # a strictly feasible interior point, else the feasible set is empty
        # at any v and the minimum is +inf
        gap = r * r * K * K - 4.0 * K
        if gap <= 1e-12 * max(1.0, c):
            if c <= 0.0:
                # noiseless edge: b = 0 meets the cone with equality
                return -float(np.min(b_max)), np.zeros(K)
            return math.inf, np.asarray(res.x[:K])
        t = 1.1 * math.sqrt(c / gap)
        b0 = t / h
        v0 = max(float(np.max(b0 - b_max)), 0.0) + 1e-6
        res = solve_from(np.concatenate([b0, [v0]]))
        if not accepted(res):
            # a conservative upper bound from the feasible start itself
            return v0, b0
    return float(res.x[-1]), np.asarray(res.x[:K])


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
