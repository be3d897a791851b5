"""The port's kernel wrappers (``repro_torch.kernels.ops``) against the JAX
package's Pallas kernels, run in interpret mode as the reference's own
kernel tests run them.

On the CPU the port's wrappers take the plain versions (the input lies on
the CPU), so these tests pin the arithmetic the Hopper kernels must match;
tests/test_torch_on_card.py holds the CUDA kernels themselves to the plain
versions where a card is present.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _launch, ops
from repro_torch.kernels.grad_norm import (batched_moments_cuda, sumsq_cuda,
                                           streaming_moments_cuda)
from repro_torch.kernels.ota_aggregate import (ota_superpose_cuda,
                                               ota_superpose_streaming_cuda)

EPS32 = float(np.finfo(np.float32).eps)


def _stack(k, n, seed, zeros_every=None, edges=False):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((k, n)).astype(np.float32)
    if zeros_every:
        g[:, ::zeros_every] = 0.0          # exact zeros: sign(0) must be 0
    if edges:
        # large values at each row's head and tail: a dropped or doubled
        # edge element (unaligned head, ragged tail) shows at once
        g[:, :5] = 100.0
        g[:, -5:] = -50.0
    return g


def _sum_tol(terms_abs_sum, n):
    """Bound on the gap between two blocked fp32 sums of the same n terms.

    A sum of tree depth d is within d eps sum|terms| of the exact value; a
    blocked sum of n terms has depth of order log2 n, and two of them differ
    by at most twice that.  So the bound grows with the depth, not with n,
    and stays under one element of the stack: a dropped element fails."""
    return 2.0 * math.ceil(math.log2(n)) * EPS32 * terms_abs_sum


# N values: ragged against the reference's 1024-lane packing, and a K of 1
SHAPES = [(1, 1000), (5, 1000), (1, 3001), (5, 3001)]


class TestMomentsParity:
    @pytest.mark.parametrize("k,n", SHAPES)
    def test_matches_pallas_interpret(self, k, n):
        g = _stack(k, n, seed=k * 10_000 + n, edges=True)
        want_sq, want_s = jops.batched_moments(jnp.asarray(g), interpret=True)
        got_sq, got_s = ops.batched_moments(torch.from_numpy(g))
        # both are blocked fp32 sums of n terms in different orders; the
        # bound is per device, from that device's sum of |terms| (fp64)
        g64 = g.astype(np.float64)
        np.testing.assert_array_less(
            np.abs(got_sq.numpy() - np.asarray(want_sq)),
            _sum_tol(np.sum(g64 * g64, 1), n))
        np.testing.assert_array_less(
            np.abs(got_s.numpy() - np.asarray(want_s)),
            _sum_tol(np.sum(np.abs(g64), 1), n))

    @pytest.mark.parametrize("k,n", [(5, 3001)])
    def test_grad_norms(self, k, n):
        g = _stack(k, n, seed=3)
        want = jops.batched_grad_norms(jnp.asarray(g), interpret=True)
        got = ops.batched_grad_norms(torch.from_numpy(g))
        # the sums of squares differ by at most _sum_tol relative (all terms
        # positive); sqrt halves that and each side rounds once more
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=(math.ceil(math.log2(n)) + 1) * EPS32)


class TestSuperposeParity:
    @pytest.mark.parametrize("k,n", SHAPES)
    @pytest.mark.parametrize("pre", ["identity", "sign"])
    def test_matches_pallas_interpret(self, k, n, pre):
        g = _stack(k, n, seed=k + n, zeros_every=7 if pre == "sign" else None)
        rng = np.random.default_rng(n)
        scale = rng.uniform(0.1, 2.0, k).astype(np.float32)
        noise = (0.05 * rng.standard_normal(n)).astype(np.float32)
        a = 1.3
        want = jops.ota_superpose(jnp.asarray(g), jnp.asarray(scale),
                                  jnp.asarray(noise), a, pre=pre,
                                  interpret=True)
        got = ops.ota_superpose(torch.from_numpy(g), torch.from_numpy(scale),
                                torch.from_numpy(noise), a, pre=pre)
        x = np.sign(g) if pre == "sign" else g
        # per coordinate: two K-term sums plus the noise add and the gain
        bound = a * (np.abs(scale) @ np.abs(x) + np.abs(noise))
        np.testing.assert_array_less(np.abs(got.numpy() - np.asarray(want)),
                                     2 * (k + 2) * EPS32 * bound + 1e-30)

    def test_sign_of_zero_is_zero(self):
        g = np.zeros((3, 50), np.float32)
        g[1, ::2] = -2.0
        got = ops.ota_superpose(torch.from_numpy(g), torch.ones(3),
                                torch.zeros(50), 1.0, pre="sign")
        want = np.where(np.arange(50) % 2 == 0, -1.0, 0.0)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_ota_aggregate_normalized(self):
        k, n = 5, 3001
        g = _stack(k, n, seed=5)
        rng = np.random.default_rng(0)
        hb = rng.uniform(0.5, 2.0, k).astype(np.float32)
        norms = np.linalg.norm(g, axis=1).astype(np.float32)
        noise = (0.01 * rng.standard_normal(n)).astype(np.float32)
        want = jops.ota_aggregate(jnp.asarray(g), jnp.asarray(hb),
                                  jnp.asarray(norms), jnp.asarray(noise), 0.7,
                                  interpret=True)
        got = ops.ota_aggregate(torch.from_numpy(g), torch.from_numpy(hb),
                                torch.from_numpy(norms),
                                torch.from_numpy(noise), 0.7)
        # K-term fp32 sums in different orders; entries are O(1e-2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)


class TestDispatch:
    def test_cpu_tensor_takes_plain_and_counts_nothing(self):
        ops.reset_launch_counts()
        ops.batched_moments(torch.ones(2, 9))
        ops.ota_superpose(torch.ones(2, 9), torch.ones(2), torch.zeros(9), 1.0)
        ops.batched_moments(torch.ones(2, 9), k_block=1)
        ops.ota_superpose(torch.ones(2, 9), torch.ones(2), torch.zeros(9), 1.0,
                          k_block=2)
        ops.grad_norm(torch.ones(9))
        ops.flash_attention(torch.ones(1, 2, 8, 8), torch.ones(1, 1, 8, 8),
                            torch.ones(1, 1, 8, 8))
        ops.selective_scan(torch.ones(1, 4, 3), torch.ones(1, 4, 3),
                           -torch.ones(3, 2), torch.ones(1, 4, 2),
                           torch.ones(1, 4, 2))
        assert set(ops.LAUNCH_COUNTS) == {
            "batched_moments", "ota_superpose", "streaming_moments",
            "ota_superpose_streaming", "sumsq", "flash_attention",
            "selective_scan"}
        assert set(ops.LAUNCH_COUNTS.values()) == {0}

    @pytest.mark.parametrize("call", [
        lambda: ops.batched_moments(torch.ones(2, 9), impl="kernel"),
        lambda: ops.ota_superpose(torch.ones(2, 9), torch.ones(2),
                                  torch.zeros(9), 1.0, impl="kernel"),
        lambda: batched_moments_cuda(torch.ones(2, 9)),
        lambda: ota_superpose_cuda(torch.ones(2, 9), torch.ones(2),
                                   torch.zeros(9), 1.0),
        lambda: ops.batched_moments(torch.ones(2, 9), k_block=1,
                                    impl="kernel"),
        lambda: ops.ota_superpose(torch.ones(2, 9), torch.ones(2),
                                  torch.zeros(9), 1.0, k_block=1,
                                  impl="kernel"),
        lambda: ops.grad_norm(torch.ones(9), impl="kernel"),
        lambda: streaming_moments_cuda(torch.ones(2, 9), 1),
        lambda: ota_superpose_streaming_cuda(torch.ones(2, 9), torch.ones(2),
                                             torch.zeros(9), 1.0, 1),
        lambda: sumsq_cuda(torch.ones(9)),
    ])
    def test_kernel_request_on_cpu_raises(self, call):
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            call()

    def test_cuda_tensor_cannot_be_made_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises((RuntimeError, AssertionError)):
            ops.batched_moments(torch.ones(2, 9, device="cuda"))

    def test_unknown_impl_and_streaming_raise(self):
        """An unknown impl raises; the streamed kernels run, and raise
        ValueError for a k_block that does not divide K (as the reference's
        ops do)."""
        with pytest.raises(ValueError, match="unknown impl"):
            ops.batched_moments(torch.ones(2, 9), impl="fast")
        with pytest.raises(ValueError, match="divide"):
            ops.batched_moments(torch.ones(6, 9), k_block=4)
        with pytest.raises(ValueError, match="divide"):
            ops.ota_superpose(torch.ones(6, 9), torch.ones(6),
                              torch.zeros(9), 1.0, k_block=4)
        with pytest.raises(ValueError, match="divide"):
            jops.ota_superpose(jnp.ones((6, 9)), jnp.ones(6), jnp.zeros(9),
                               1.0, k_block=4)
        sq, s = ops.batched_moments(torch.ones(6, 9), k_block=3)
        assert torch.equal(sq, torch.full((6,), 9.0))
        assert torch.equal(s, torch.full((6,), 9.0))

    @pytest.mark.parametrize("bad,match", [
        (torch.ones(2, 9, dtype=torch.float64), "float32"),
        (torch.ones(9), "2-D"),
        (torch.ones(9, 2).T, "contiguous"),
        (torch.ones(0, 9), "empty"),
        (torch.ones(2, 9), "needs a CUDA tensor"),
    ])
    def test_layout_checks(self, bad, match):
        with pytest.raises(ValueError, match=match):
            _launch.check(bad, 2, "g")
