"""The Hopper kernels against their plain versions on the card (marked
``cuda``; they skip without one).  This file imports neither ``jax`` nor
``repro``, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_on_card.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops

EPS32 = float(np.finfo(np.float32).eps)


def _stack(k, n, seed, zeros_every=None):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((k, n)).astype(np.float32)
    if zeros_every:
        g[:, ::zeros_every] = 0.0          # exact zeros: sign(0) must be 0
    # large values at each row's head and tail: a dropped or doubled edge
    # element (unaligned head, ragged tail) shows at once
    g[:, :5] = 100.0
    g[:, -5:] = -50.0
    return g


# chip_smoke.py's rule: |kernel - plain| <= 1e-5 sum|terms| per device (the
# moments) or per column (the superposition).  Both are blocked fp32 sums
# whose gap stays far below that (84 eps) at these shapes, while one dropped
# chunk, K-block, head or tail element breaks it.
TERMS_RTOL = 1e-5


def _superpose_tol(k):
    """Per-column rtol of the superposition against sum|terms|: 1e-5, or
    the rigorous fp32 bound of two K-term sums, 2 (K+2) eps, where that is
    tighter (small K)."""
    return min(2 * (k + 2) * EPS32, TERMS_RTOL)


@pytest.mark.cuda
class TestOnCard:
    """The CUDA kernels against their plain versions on the card."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                        "False)")

    @pytest.mark.parametrize("k,n", [(1, 7), (20, 55_050), (7, 1_000_003)])
    def test_kernels_match_plain(self, k, n):
        g = torch.from_numpy(_stack(k, n, seed=n, zeros_every=5)).cuda()
        sq, s = ops.batched_moments(g, impl="kernel")
        sq_p, s_p = ops.batched_moments(g, impl="plain")
        gg = g.double()
        assert bool(((sq - sq_p).abs().double()
                     <= TERMS_RTOL * (gg * gg).sum(1)).all())
        assert bool(((s - s_p).abs().double()
                     <= TERMS_RTOL * gg.abs().sum(1)).all())
        scale = torch.linspace(0.5, 1.5, k, device="cuda")
        noise = 0.01 * torch.ones(n, device="cuda")
        for pre in ("identity", "sign"):
            y = ops.ota_superpose(g, scale, noise, 0.9, pre=pre, impl="kernel")
            yp = ops.ota_superpose(g, scale, noise, 0.9, pre=pre, impl="plain")
            x = torch.sign(g) if pre == "sign" else g
            bound = 0.9 * (scale.abs() @ x.abs() + noise.abs())
            assert bool(((y - yp).abs() <= _superpose_tol(k) * bound).all())

    @pytest.mark.parametrize("k,n,kb", [
        (1, 7, 1), (20, 55_050, 4), (1000, 55_050, 100), (7, 1_000_003, 1),
        (100_000, 2_048, 1_000)])
    def test_streamed_kernels_match_plain(self, k, n, kb):
        g = torch.from_numpy(_stack(k, n, seed=n + kb, zeros_every=5)).cuda()
        sq, s = ops.batched_moments(g, k_block=kb, impl="kernel")
        sq_p, s_p = ops.batched_moments(g, k_block=kb, impl="plain")
        gg = g.double()
        assert bool(((sq - sq_p).abs().double()
                     <= TERMS_RTOL * (gg * gg).sum(1)).all())
        assert bool(((s - s_p).abs().double()
                     <= TERMS_RTOL * gg.abs().sum(1)).all())
        scale = torch.linspace(0.5, 1.5, k, device="cuda")
        noise = 0.01 * torch.ones(n, device="cuda")
        for pre in ("identity", "sign"):
            y = ops.ota_superpose(g, scale, noise, 0.9, pre=pre, k_block=kb,
                                  impl="kernel")
            yp = ops.ota_superpose(g, scale, noise, 0.9, pre=pre, k_block=kb,
                                   impl="plain")
            x = torch.sign(g) if pre == "sign" else g
            tol = _superpose_tol(k) * 0.9 * (scale.abs() @ x.abs()
                                             + noise.abs())
            assert bool(((y - yp).abs() <= tol).all())
            if k > kb:
                # the rule rejects a result that lacks K-block 1: off by
                # that block's term, about sqrt(kb) a column here
                dropped = 0.9 * (scale[kb:2 * kb] @ x[kb:2 * kb])
                assert not bool((dropped.abs() <= tol).all())
        # the norm kernel on the whole stack flattened, and on a view that
        # starts off the 16-byte grid (a scalar head of 3 elements)
        for x in (g.reshape(-1), g.reshape(-1)[1:]):
            got = ops.grad_norm(x, impl="kernel").double() ** 2
            want = ops.grad_norm(x, impl="plain").double() ** 2
            assert abs(got - want) <= TERMS_RTOL * float((x.double() ** 2)
                                                           .sum())

    def test_tiny_round_on_card_matches_cpu(self):
        from repro_torch.core.channel import ChannelConfig
        from repro_torch.fl import (DataSpec, Experiment, ExperimentSpec,
                                    FLConfig, ModelSpec)
        spec = ExperimentSpec(
            fl=FLConfig(num_devices=4, backend="kernels", smoothness_L=5.0,
                        expected_loss_drop=2.0,
                        channel=ChannelConfig(num_devices=4,
                                              channel_mean=1e-3)),
            data=DataSpec(num_train=200, num_test=50, batch_size=10),
            model=ModelSpec(hidden=8))
        ops.reset_launch_counts()
        gpu = Experiment(spec, device="cuda")
        gpu.run(3)
        assert ops.LAUNCH_COUNTS == {
            "batched_moments": 3, "ota_superpose": 3, "streaming_moments": 0,
            "ota_superpose_streaming": 0, "sumsq": 3}
        cpu = Experiment(spec, device="cpu")
        cpu.run(3)
        for k, v in cpu.params.items():
            # same CPU-drawn inputs; fp32 sums in other orders on the card
            torch.testing.assert_close(gpu.params[k].cpu(), v, rtol=0,
                                       atol=1e-5)
