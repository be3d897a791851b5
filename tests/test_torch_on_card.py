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
from repro_torch.kernels.ota_aggregate import superpose_split

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

    @pytest.mark.parametrize("k,n", [(1, 7), (20, 55_050), (7, 1_000_003),
                                     (1000, 2048)])
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

    @pytest.mark.parametrize("k,n,kb", [
        (20, 55_050, 4), (1000, 2048, 100), (1000, 55_050, 100),
        (7, 1_000_003, 1), (100_000, 2_048, 1_000)])
    def test_two_launches_bitwise(self, k, n, kb):
        """K2 (split or not), K4 (one pass or chunks of K-blocks) and K3
        give the same bits from launch to launch."""
        g = torch.from_numpy(_stack(k, n, seed=k + n, zeros_every=5)).cuda()
        scale = torch.linspace(0.5, 1.5, k, device="cuda")
        noise = 0.01 * torch.ones(n, device="cuda")
        for pre in ("identity", "sign"):
            for k_block in (None, kb):
                y = ops.ota_superpose(g, scale, noise, 0.9, pre=pre,
                                      k_block=k_block, impl="kernel")
                assert torch.equal(ops.ota_superpose(
                    g, scale, noise, 0.9, pre=pre, k_block=k_block,
                    impl="kernel"), y)
        sq, s = ops.batched_moments(g, k_block=kb, impl="kernel")
        sq2, s2 = ops.batched_moments(g, k_block=kb, impl="kernel")
        assert torch.equal(sq, sq2) and torch.equal(s, s2)

    @pytest.mark.parametrize("n", [7, 2048, 2049, 55_050])
    def test_stream_moments_rows_ignore_k_and_k_block(self, n):
        """A device's K3 sums are the same bits in stacks of other K and
        k_block (each row at the same place, so at the same alignment)."""
        g = torch.from_numpy(_stack(24, n, seed=n, zeros_every=5)).cuda()
        want = ops.batched_moments(g, k_block=4, impl="kernel")
        for k, kb in ((24, 24), (24, 1), (12, 3), (8, 8), (5, 5)):
            got = ops.batched_moments(g[:k].contiguous(), k_block=kb,
                                      impl="kernel")
            for a, b in zip(got, want):
                assert torch.equal(a, b[:k]), (k, kb)

    @pytest.mark.parametrize("k,n,kb", [(20, 55_050, None),
                                        (7, 1_000_003, None),
                                        (24, 55_050, 4)])
    def test_moments_graph_replays_bitwise(self, k, n, kb):
        """K1 (and K3's long rows, on K1's kernel) replayed twice inside one
        CUDA graph gives the eager launch's bits both times: the block that
        folds a row sets its arrival counter back to 0.  The graph is
        captured on a stream that already ran the kernel, so it holds the
        stream's counters and no zeroing of its own."""
        g = torch.from_numpy(_stack(k, n, seed=k + n, zeros_every=5)).cuda()
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            eager = ops.batched_moments(g, k_block=kb, impl="kernel")
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = ops.batched_moments(g, k_block=kb, impl="kernel")
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            for a, b in zip(out, eager):
                assert torch.equal(a, b)

    @pytest.mark.parametrize("k,n,kb", [(7, 1_000_003, None),
                                        (20, 55_050, None),
                                        (24, 55_050, 4)])
    def test_moments_on_two_streams_at_once(self, k, n, kb):
        """K1 (and K3's long rows) launched on two streams that run at once
        gives each launch the bits it gets alone: each stream has arrival
        counters of its own, so no launch counts another's blocks.  Every
        launch reads a stack of its own, so a fold of another launch's
        partials, or a row left unfolded, shows.  Both streams wait on one
        event that a sleeping third stream records, so that their queues
        fill first and then drain side by side from the same instant."""
        reps = 16
        gs = [[torch.from_numpy(_stack(k, n, seed=k + n + 10 * i + r,
                                       zeros_every=5)).cuda()
               for r in range(reps)] for i in range(2)]
        want = [[ops.batched_moments(g, k_block=kb, impl="kernel")
                 for g in row] for row in gs]
        torch.cuda.synchronize()
        streams = [torch.cuda.Stream() for _ in gs]
        gate, opened = torch.cuda.Stream(), torch.cuda.Event()
        with torch.cuda.stream(gate):
            torch.cuda._sleep(50_000_000)
            opened.record()
        for s in streams:
            s.wait_event(opened)
        outs = [[], []]
        for r in range(reps):
            for i, s in enumerate(streams):
                with torch.cuda.stream(s):
                    outs[i].append(ops.batched_moments(
                        gs[i][r], k_block=kb, impl="kernel"))
        torch.cuda.synchronize()
        for got_row, want_row in zip(outs, want):
            for (q, r_), (sq, s_) in zip(got_row, want_row):
                assert torch.equal(q, sq) and torch.equal(r_, s_)

    @pytest.mark.parametrize("k,n", [(1000, 2048), (1000, 55_050)])
    def test_superpose_rule_rejects_a_dropped_chunk(self, k, n):
        """Where K2 splits its sum (S > 1), the rule rejects the plain
        result less one K-chunk's term."""
        s = superpose_split(k, n)
        assert s > 1
        rows = -(-k // s)
        g = torch.from_numpy(_stack(k, n, seed=k * n, zeros_every=5)).cuda()
        scale = torch.linspace(0.5, 1.5, k, device="cuda")
        noise = 0.01 * torch.ones(n, device="cuda")
        for pre in ("identity", "sign"):
            y = ops.ota_superpose(g, scale, noise, 0.9, pre=pre, impl="kernel")
            yp = ops.ota_superpose(g, scale, noise, 0.9, pre=pre,
                                   impl="plain")
            x = torch.sign(g) if pre == "sign" else g
            tol = _superpose_tol(k) * 0.9 * (scale.abs() @ x.abs()
                                             + noise.abs())
            assert bool(((y - yp).abs() <= tol).all())
            dropped = 0.9 * (scale[rows:2 * rows] @ x[rows:2 * rows])
            assert not bool((dropped.abs() <= tol).all())

    def test_split_kernels_build_without_stack_or_spills(self):
        """ptxas reports no stack frame and no spill in K2's, K4's (both in
        csrc/ota_superpose.cu) and K3's kernels."""
        from repro_torch.kernels import build
        names = ("ota_superpose", "stream_moments")
        build.build_all(names)
        for name in names:
            for entry, row in build.ptxas_report(name).items():
                assert row["stack"] == row["spill_stores"] == \
                    row["spill_loads"] == 0, (name, entry, row)

    def test_moments_and_scan_build_without_stack_or_spills(self):
        """ptxas reports no stack frame and no spill in K1's kernel and in
        each of K7's instantiations (bf16 and fp32)."""
        from repro_torch.kernels import build
        names = ("moments", "selective_scan")
        build.build_all(names)
        for name in names:
            report = build.ptxas_report(name)
            assert len(report) == (2 if name == "selective_scan" else 1)
            for entry, row in report.items():
                assert row["stack"] == row["spill_stores"] == \
                    row["spill_loads"] == 0, (name, entry, row)

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


def _attention_inputs(b, h, hkv, sq, skv, d, dtype, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, s, d))
                                .astype(np.float32)).cuda().to(dtype)
               for n, s in ((h, sq), (hkv, skv), (hkv, skv)))
    return q, k, v


def attention_tol(want, dtype):
    """chip_smoke.py's rule for K6 against its plain version (computed in
    fp32 from the same inputs): fp32 |d| <= 1e-5 + 1e-5 |o| (the
    reference's kernel test bound); bf16 |d| <= 2^-8 |o| + 1e-5, one bf16
    rounding of the output."""
    if dtype == torch.bfloat16:
        return 2.0 ** -8 * want.abs() + 1e-5
    return 1e-5 + 1e-5 * want.abs()


# keys per kv tile: kBK of csrc/flash_attention_wgmma.cu (bf16) and of
# csrc/flash_attention.cu (fp32), as chip_smoke.py's FLASH_TILE
FLASH_TILE = {torch.bfloat16: 128, torch.float32: 64}


@pytest.mark.cuda
class TestFlashAttentionOnCard:
    """K6's two bodies against their plain version at chip_smoke.py's
    shapes, with the checks that its tolerance rejects a result that lacks
    the last kv tile or has the window off by one, and that two launches
    give the same bits."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                        "False)")

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("b,h,hkv,sq,skv,d,causal,window", [
        (4, 32, 8, 8192, 8192, 80, True, 4096),    # the serving prefill
        (1, 32, 8, 8192, 8192, 80, True, 4096),
        (4, 32, 8, 8192, 8192, 128, True, None),   # Jamba's attention
        (1, 32, 8, 8192, 8192, 128, True, None),
        (2, 8, 8, 1000, 1000, 128, True, None),    # ragged S
        (2, 8, 8, 1000, 1000, 128, False, None),
        (1, 4, 2, 333, 333, 80, True, 16),         # window < a kv tile
        (1, 4, 2, 500, 500, 8, True, None),        # d not a multiple of 16
        (1, 4, 2, 500, 500, 24, True, 100),
        (1, 4, 2, 500, 500, 64, False, None),
        (1, 4, 2, 200, 700, 80, True, None),       # Sq < Skv
        (1, 4, 2, 700, 200, 80, True, 64),         # Sq > Skv: no skipping,
        (1, 4, 2, 700, 200, 128, False, 64),       # rows fully masked
    ])
    def test_flash_attention_matches_plain(self, b, h, hkv, sq, skv, d,
                                           causal, window, dtype):
        q, k, v = _attention_inputs(b, h, hkv, sq, skv, d, dtype,
                                    seed=sq + skv + d)
        got = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  impl="kernel")
        qf, kf, vf = q.float(), k.float(), v.float()
        want = ops.flash_attention(qf, kf, vf, causal=causal, window=window,
                                   impl="plain")
        assert got.dtype == dtype and got.shape == q.shape
        tol = attention_tol(want, dtype)
        assert bool(((got.float() - want).abs() <= tol).all())
        assert torch.equal(ops.flash_attention(q, k, v, causal=causal,
                                               window=window, impl="kernel"),
                           got)
        # the last kv tile the kernel visits starts at cut (causal: keys
        # past min(Sq, Skv) - 1 are masked for every row)
        last = min(sq, skv) if causal else skv
        cut = (last - 1) // FLASH_TILE[dtype] * FLASH_TILE[dtype]
        dropped = ops.flash_attention(qf, kf[:, :, :cut], vf[:, :, :cut],
                                      causal=causal, window=window,
                                      impl="plain")
        assert not bool(((dropped - want).abs() <= tol).all())
        off = ops.flash_attention(qf, kf, vf, causal=causal,
                                  window=(window or sq) - 1, impl="plain")
        assert not bool(((off - want).abs() <= tol).all())

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_bodies_build_without_spills(self, dtype):
        from repro_torch.kernels import build
        from repro_torch.kernels.flash_attention import BODIES
        name = BODIES[dtype][0]
        build.build_all([name])
        report = build.ptxas_report(name)
        # each body: one instantiation per head dim padded to 16
        assert len(report) == 8
        for entry, row in report.items():
            assert row["spill_stores"] == row["spill_loads"] == 0, entry


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
SCAN_TILE = 64                    # a multiple of the staged tile's steps
                                  # (kT = 32 in the .cu)


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

