"""The port's host-side Algorithm 1 (``repro_torch.core.amplification``)
against the JAX package's on the same channel: both are the same float64
NumPy/SciPy code, so they agree to 1e-12."""
import numpy as np
import pytest

from repro.core import amplification as jamp
from repro_torch.core import amplification as amp

CASES = [
    # (K, noise_var, N, channel mean) -- the Case-I cell's shape, a small
    # model where noise matters, and a noisy channel that caps some b_k
    (20, 1e-7, 55_050, 1e-3),
    (5, 1e-3, 100, 1e-2),
    (8, 1e-2, 13_002, 3e-3),
]


def _h(k, mean, seed):
    rng = np.random.default_rng(seed)
    sigma = mean / np.sqrt(np.pi / 2.0)
    return sigma * np.hypot(rng.standard_normal(k), rng.standard_normal(k))


@pytest.mark.parametrize("k,noise_var,n,mean", CASES)
def test_case1_matches_reference(k, noise_var, n, mean):
    h = _h(k, mean, seed=k)
    b_max = np.full(k, np.sqrt(5.0))
    got = amp.optimize_case1(h, noise_var, n, b_max, 5.0, 0.75, 2.0)
    want = jamp.optimize_case1(h, noise_var, n, b_max, 5.0, 0.75, 2.0)
    np.testing.assert_allclose(got.b, want.b, rtol=1e-12, atol=1e-12)
    for f in ("a", "S", "Z"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-12)


@pytest.mark.parametrize("k,noise_var,n,mean", CASES)
@pytest.mark.parametrize("target", [{"s": 0.995}, {"epsilon": 0.5}])
def test_case2_matches_reference(k, noise_var, n, mean, target):
    h = _h(k, mean, seed=k + 1)
    b_max = np.full(k, np.sqrt(5.0))
    args = (h, noise_var, n, b_max, 4.0, 0.2, 25.0, np.pi / 3.0)
    got = amp.optimize_case2(*args, **target)
    want = jamp.optimize_case2(*args, **target)
    np.testing.assert_allclose(got.b, want.b, rtol=1e-12, atol=1e-12)
    for f in ("a_eta", "s", "Z", "bias_bound"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-12)


def test_problem3_iterations_and_errors_match():
    h = _h(6, 1e-3, seed=3)
    got = amp.solve_problem3(h, 1e-4, 500, np.sqrt(5.0))
    want = jamp.solve_problem3(h, 1e-4, 500, np.sqrt(5.0))
    assert got.iterations == want.iterations
    assert got.Z == pytest.approx(want.Z, rel=1e-12)
    with pytest.raises(ValueError, match="b_max shape"):
        amp.solve_problem3(h, 1e-4, 500, np.ones(3))
    with pytest.raises(ValueError, match="p must lie"):
        amp.optimal_S(1.0, 1.0, 0.4, 1.0)
