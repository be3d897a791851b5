"""The Hopper kernels against their plain versions on the card (marked
``cuda``; they skip without one).  This file imports neither ``jax`` nor
``repro``, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_on_card.py
"""
import math

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
            "ota_superpose_streaming": 0, "sumsq": 3, "flash_attention": 0,
            "selective_scan": 0}
        cpu = Experiment(spec, device="cpu")
        cpu.run(3)
        for k, v in cpu.params.items():
            # same CPU-drawn inputs; fp32 sums in other orders on the card
            torch.testing.assert_close(gpu.params[k].cpu(), v, rtol=0,
                                       atol=1e-5)


def _attention_inputs(b, h, hkv, s, d, dtype, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, s, d))
                                .astype(np.float32)).cuda().to(dtype)
               for n in (h, hkv, hkv))
    return q, k, v


def attention_tol(want, dtype):
    """chip_smoke.py's rule for K6 against its plain version (computed in
    fp32 from the same inputs): fp32 |d| <= 1e-5 + 1e-5 |o| (the
    reference's kernel test bound); bf16 |d| <= 2^-8 |o| + 1e-5, one bf16
    rounding of the output."""
    if dtype == torch.bfloat16:
        return 2.0 ** -8 * want.abs() + 1e-5
    return 1e-5 + 1e-5 * want.abs()


@pytest.mark.cuda
class TestFlashAttentionOnCard:
    """K6 against its plain version at chip_smoke.py's shapes, with the
    checks that its tolerance rejects a result that lacks the last kv tile
    or has the window off by one."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                        "False)")

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("b,h,hkv,s,d,causal,window", [
        (4, 32, 8, 8192, 80, True, 4096),      # the serving layer's prefill
        (1, 32, 8, 8192, 80, True, 4096),
        (4, 32, 8, 8192, 128, True, None),     # Jamba's attention prefill
        (1, 32, 8, 8192, 128, True, None),
        (2, 8, 8, 1000, 128, True, None),      # ragged S
        (2, 8, 8, 1000, 128, False, None),
        (1, 4, 2, 333, 80, True, 16),          # window < the 64-key tile
    ])
    def test_flash_attention_matches_plain(self, b, h, hkv, s, d, causal,
                                           window, dtype):
        q, k, v = _attention_inputs(b, h, hkv, s, d, dtype, seed=s + d)
        got = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  impl="kernel")
        qf, kf, vf = q.float(), k.float(), v.float()
        want = ops.flash_attention(qf, kf, vf, causal=causal, window=window,
                                   impl="plain")
        assert got.dtype == dtype and got.shape == q.shape
        tol = attention_tol(want, dtype)
        assert bool(((got.float() - want).abs() <= tol).all())
        cut = (s - 1) // 64 * 64          # the kernel's last kv tile starts
        dropped = ops.flash_attention(qf, kf[:, :, :cut], vf[:, :, :cut],
                                      causal=causal, window=window,
                                      impl="plain")
        assert not bool(((dropped - want).abs() <= tol).all())
        off = ops.flash_attention(qf, kf, vf, causal=causal,
                                  window=(window or s) - 1, impl="plain")
        assert not bool(((off - want).abs() <= tol).all())


# chip_smoke.py's rule for K7 against its plain version: per element,
# |d| <= SCAN_RTOL * Y_abs, where Y_abs is the plain scan of |u|, dt, a,
# |B|, |C| -- the recurrence on the absolute terms, an upper bound of
# sum_n |h_t,n C_t,n| -- and likewise for h_S against the final state of
# that scan.  The kernel and the plain version round differently (expf
# against torch.exp, fused multiply-adds, the order of the N-way sum):
# a few fp32 eps a step, compounded over the memory 1 / (dt |a|) of the
# slowest state, ~1e2 steps for the "test" draw and ~1e3 for the "jamba"
# draw.  A result that drops one time step or resets the carried state at
# a tile boundary is off by a sizeable share of Y_abs there.
SCAN_RTOL = 1e-4
SCAN_TILE = 64                    # time steps per staged tile (kT in the .cu)


def scan_inputs(b, s, d, n, dtype, seed, draw="test"):
    """Drawn on the card: u, B, C normal in ``dtype``.  Draw "test", the
    reference's kernel-test inputs (tests/test_kernels.py): dt =
    softplus(normal) and a = -exp(normal) in fp32.  Draw "jamba", the
    operands as models/mamba.py's init_mamba sets them up: a = -(1..N) in
    every channel, each channel's dt log-uniform in [1e-3, 0.1] and held
    over all steps (a memory of ~1e3 steps at dt 1e-3, a -1)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    u = normal(b, s, d).to(dtype)
    if draw == "jamba":
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt_init = torch.exp(lo + (hi - lo) * torch.rand(
            (d,), generator=gen, device="cuda"))
        dt = dt_init.expand(b, s, d).contiguous()
        a = -torch.arange(1, n + 1, dtype=torch.float32,
                          device="cuda").expand(d, n).contiguous()
    else:
        dt = torch.nn.functional.softplus(normal(b, s, d))
        a = -torch.exp(normal(d, n))
    return u, dt, a, normal(b, s, n).to(dtype), normal(b, s, n).to(dtype)


def scan_abs(u, dt, a, bm, cm):
    """(Y_abs, H_abs): the plain scan on the absolute terms."""
    return ops.selective_scan(u.abs(), dt, a, bm.abs(), cm.abs(),
                              return_state=True, impl="plain")


def scan_reset_at(u, dt, a, bm, cm, cut):
    """The plain scan with the carried state reset to 0 at step ``cut``."""
    halves = [ops.selective_scan(*(x[:, sl].contiguous()
                                   for x in (u, dt)), a,
                                 *(x[:, sl].contiguous() for x in (bm, cm)),
                                 impl="plain")
              for sl in (slice(0, cut), slice(cut, None))]
    return torch.cat(halves, dim=1)


@pytest.mark.cuda
class TestSelectiveScanOnCard:
    """K7 against its plain version at chip_smoke.py's shapes, with the
    checks that its rule rejects a result that drops one time step or
    resets the state at a tile boundary."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                        "False)")

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("b,s,d,n,draw", [
        (4, 8192, 8192, 16, "test"),      # the Jamba prefill's scan
        (1, 8192, 8192, 16, "test"),
        (2, 1000, 1000, 16, "test"),      # ragged S and D
        (1, 333, 77, 5, "test"),          # ragged, N below the kernel's 16
        (4, 8192, 8192, 16, "jamba"),     # with Jamba's own a and dt
    ])
    def test_selective_scan_matches_plain(self, b, s, d, n, draw, dtype):
        u, dt, a, bm, cm = scan_inputs(b, s, d, n, dtype, seed=s + d + n,
                                       draw=draw)
        y, h = ops.selective_scan(u, dt, a, bm, cm, return_state=True,
                                  impl="kernel")
        yp, hp = ops.selective_scan(u, dt, a, bm, cm, return_state=True,
                                    impl="plain")
        assert y.dtype == h.dtype == torch.float32
        assert y.shape == (b, s, d) and h.shape == (b, d, n)
        y_abs, h_abs = scan_abs(u, dt, a, bm, cm)
        tol = SCAN_RTOL * y_abs
        assert bool(((y - yp).abs() <= tol).all())
        assert bool(((h - hp).abs() <= SCAN_RTOL * h_abs).all())
        assert torch.equal(ops.selective_scan(u, dt, a, bm, cm,
                                              impl="kernel"), y)
        t = s // 2                         # dt = 0 skips the update
        dt_drop = dt.clone()
        dt_drop[:, t] = 0.0
        dropped = ops.selective_scan(u, dt_drop, a, bm, cm, impl="plain")
        assert not bool(((dropped - yp).abs() <= tol).all())
        cut = max(1, s // 2 // SCAN_TILE) * SCAN_TILE
        reset = scan_reset_at(u, dt, a, bm, cm, cut)
        assert not bool(((reset - yp).abs() <= tol).all())
