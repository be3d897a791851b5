"""The Hopper kernels against their plain versions on the card (marked
``cuda``; they skip without one).  This file imports neither ``jax`` nor
``repro``, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_on_card.py
"""
import json
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

    @staticmethod
    def _vectors(n):
        """K5's inputs at N: a row of its own, and a view that starts one
        element into a row (off the 16-byte grid: a scalar head of 3)."""
        g = torch.from_numpy(_stack(1, n + 1, seed=n, zeros_every=5)).cuda()
        return {"row": g[0, :n].contiguous(), "head": g.reshape(-1)[1:]}

    @pytest.mark.parametrize("view", ["row", "head"])
    @pytest.mark.parametrize("n", [2048, 55_050])
    def test_norm_matches_plain(self, n, view):
        """K5 at the K-scale and the Case-I round's N: the sum of squares
        within chip_smoke.py's rule of the plain one, and the norm its
        root."""
        from repro_torch.kernels.grad_norm import norm_cuda, sumsq_cuda
        x = self._vectors(n)[view]
        got = ops.grad_norm(x, impl="kernel")
        want = ops.grad_norm(x, impl="plain")
        assert got.shape == () and got.dtype == torch.float32
        assert abs(float(got.double() ** 2 - want.double() ** 2)) <= \
            TERMS_RTOL * float((x.double() ** 2).sum())
        sq = sumsq_cuda(x)
        assert sq.shape == () and torch.equal(torch.sqrt(sq), got)
        assert torch.equal(norm_cuda(x), got)

    @pytest.mark.parametrize("n", [2048, 55_050, 1_000_003])
    def test_norm_launches_and_graph_replays_bitwise(self, n):
        """Two launches of K5, and two replays of one CUDA graph captured
        on a stream that already ran it, give the same bits."""
        x = self._vectors(n)["head"]
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            eager = ops.grad_norm(x, impl="kernel")
            assert torch.equal(ops.grad_norm(x, impl="kernel"), eager)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = ops.grad_norm(x, impl="kernel")
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager)

    @pytest.mark.parametrize("n", [55_050, 1_000_003])
    def test_norm_on_two_streams_at_once(self, n):
        """K5 launched on two streams that run at once, both released by
        one event (as test_moments_on_two_streams_at_once), gives each
        launch the bits it gets alone: its fold reads only its own
        partials, elected by its own stream's counter."""
        reps = 16
        xs = [[torch.from_numpy(_stack(1, n, seed=n + 10 * i + r,
                                       zeros_every=5)).cuda()[0]
               for r in range(reps)] for i in range(2)]
        want = [[ops.grad_norm(x, impl="kernel") for x in row] for row in xs]
        torch.cuda.synchronize()
        streams = [torch.cuda.Stream() for _ in xs]
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
                    outs[i].append(ops.grad_norm(xs[i][r], impl="kernel"))
        torch.cuda.synchronize()
        for got_row, want_row in zip(outs, want):
            for got, w in zip(got_row, want_row):
                assert torch.equal(got, w)

    @pytest.mark.parametrize("n", [2048, 55_050])
    def test_norm_is_one_kernel(self, n):
        """One ops.grad_norm call runs exactly one kernel on the card (the
        sum of squares, its fold and its root in one launch)."""
        from torch.profiler import ProfilerActivity, profile
        x = self._vectors(n)["row"]
        ops.grad_norm(x, impl="kernel")      # builds, zeroes the counters
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ops.grad_norm(x, impl="kernel")
            torch.cuda.synchronize()
        kernels = [(ev.key, ev.count) for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kernels) == 1 and kernels[0][1] == 1, kernels
        assert "moments_kernel" in kernels[0][0], kernels

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
        """ptxas reports no stack frame and no spill in each of K1's
        kernel's instantiations (K1 and K3's long rows, and the update norm
        K5) and in each of K7's (bf16 and fp32)."""
        from repro_torch.kernels import build
        names = ("moments", "selective_scan")
        build.build_all(names)
        for name in names:
            report = build.ptxas_report(name)
            assert len(report) == 2
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
        from repro_torch.fed import runtime
        runtime.clear_compile_caches()
        ops.reset_launch_counts()
        gpu = Experiment(spec, device="cuda")
        gpu.run(3)
        # the default (scan) driver: the graph's eager warm-up rounds, then
        # one replay a round, each replay counted
        n = 3 + runtime.GRAPH_WARMUP_ROUNDS
        assert ops.LAUNCH_COUNTS == {
            "batched_moments": n, "ota_superpose": n, "streaming_moments": 0,
            "ota_superpose_streaming": 0, "sumsq": n, "flash_attention": 0,
            "selective_scan": 0, "channel_noise": 0}
        cpu = Experiment(spec, device="cpu")
        cpu.run(3)
        for k, v in cpu.params.items():
            # same CPU-drawn inputs; fp32 sums in other orders on the card
            torch.testing.assert_close(gpu.params[k].cpu(), v, rtol=0,
                                       atol=1e-5)


# the reference's rule for its two drivers where they are not bitwise
# (tests/test_engine.py:157-162)
DRIVER_RULE = dict(params=dict(rtol=2e-6, atol=1e-7),
                   hist=dict(rtol=2e-6, atol=1e-9))


def _case_i_spec(**over):
    """chip_smoke.py's Case-I spec (K = 20, N = 55,050), chunks of 16 rounds
    and eval every 10."""
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.fl import (DataSpec, EvalSpec, ExperimentSpec,
                                FLConfig, ModelSpec)
    fl = FLConfig(num_devices=20, scheme="normalized", backend="kernels",
                  case="I", p=0.75, smoothness_L=5.0, expected_loss_drop=2.0,
                  channel=ChannelConfig(num_devices=20, channel_mean=1e-3),
                  seed=0)
    data = DataSpec(dataset="synthetic_mnist", split="dirichlet", alpha=1.0,
                    batch_size=50, num_train=4000, num_test=1000, seed=0)
    return ExperimentSpec(fl=fl, data=data,
                          model=ModelSpec(kind="mlp", hidden=64),
                          eval=EvalSpec(every=10), chunk_size=16, **over)


@pytest.mark.cuda
class TestDriverOnCard:
    """The compiled driver on the card: a CUDA graph of the round, replayed
    a chunk of rounds per host transfer, against the python driver's eager
    rounds; K2's and K4's gain read from device memory; launch counts under
    replay; no capture on a second run."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU")
        torch.backends.cuda.matmul.allow_tf32 = False

    @pytest.mark.parametrize("over", [{}, dict(participation=0.5),
                                      dict(participation=0.5,
                                           participation_mode="fixed",
                                           active_gather=True)],
                             ids=["case_i", "bernoulli", "fixed_gather"])
    def test_scan_matches_python(self, over):
        import dataclasses
        from repro_torch.fed import runtime
        from repro_torch.fl import Experiment
        runs = {}
        for driver in ("scan", "python"):
            e = Experiment(dataclasses.replace(_case_i_spec(**over),
                                               driver=driver), device="cuda")
            e.run(20)
            runs[driver] = e
        scan, python = runs["scan"], runs["python"]
        assert scan.history["eval_round"] == [1, 10, 20]
        for k in python.params:
            torch.testing.assert_close(scan.params[k], python.params[k],
                                       **DRIVER_RULE["params"])
        for k in runtime.DIAG_KEYS:
            np.testing.assert_allclose(scan.history[k], python.history[k],
                                       **DRIVER_RULE["hist"], err_msg=k)
        assert (scan.history["num_participants"]
                == python.history["num_participants"])

    def test_run_5_5_is_run_10(self):
        from repro_torch.fl import Experiment
        a = Experiment(_case_i_spec(), device="cuda")
        a.run(5)
        a.run(5)
        b = Experiment(_case_i_spec(), device="cuda")
        b.run(10)
        assert a.history == b.history
        for k in b.params:
            assert torch.equal(a.params[k], b.params[k]), k

    def test_launch_counts_count_replays_and_no_second_capture(self):
        from repro_torch.fed import runtime
        from repro_torch.fl import Experiment
        runtime.clear_compile_caches()
        e = Experiment(_case_i_spec(), device="cuda")
        runtime.cache_info()
        e.run(3, evaluate=False)
        assert runtime.cache_info()["traces_delta"]["run_chunk"] == 1
        ops.reset_launch_counts()
        e.run(21, evaluate=False)         # chunks of 16 and 5: 21 replays
        assert set(runtime.cache_info()["traces_delta"].values()) == {0}
        for name in ("batched_moments", "ota_superpose", "sumsq"):
            assert ops.LAUNCH_COUNTS[name] == 21, name
        runtime.clear_compile_caches()

    @pytest.mark.parametrize("k,n,kb", [(20, 55_050, None), (1000, 2048, None),
                                        (1000, 55_050, None),
                                        (20, 55_050, 4), (1000, 2048, 100),
                                        (7, 1_000_003, 1)])
    @pytest.mark.parametrize("pre", ["identity", "sign"])
    def test_gain_from_device_memory(self, k, n, kb, pre):
        """K2 and K4 read the gain from a 0-d fp32 tensor on the card: the
        same bits as the float gain, and as that gain times the result at
        a = 1 (the product comes last: y = a (sum + z))."""
        g = torch.from_numpy(_stack(k, n, 21, zeros_every=7)).cuda()
        gen = torch.Generator(device="cuda").manual_seed(3)
        scale = torch.rand((k,), generator=gen, device="cuda") + 0.5
        noise = 0.01 * torch.randn((n,), generator=gen, device="cuda")
        a = float(np.float32(0.3719))
        run = lambda gain: ops.ota_superpose(g, scale, noise, gain, pre=pre,
                                             k_block=kb, impl="kernel")
        y_float = run(a)
        y_tensor = run(torch.tensor(a, dtype=torch.float32, device="cuda"))
        y_one = run(1.0)
        torch.cuda.synchronize()
        assert torch.equal(y_float, y_tensor)
        assert torch.equal(y_tensor, a * y_one)

    def test_gain_changes_between_graph_replays(self):
        """A CUDA graph of K2 replays each value written to its gain
        tensor (a value captured by value would stay the first one)."""
        g = torch.from_numpy(_stack(20, 55_050, 22)).cuda()
        scale = torch.rand((20,), device="cuda")
        noise = torch.zeros((55_050,), device="cuda")
        gain = torch.ones((), device="cuda")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            ops.ota_superpose(g, scale, noise, gain)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            y = ops.ota_superpose(g, scale, noise, gain)
        outs = []
        for value in (1.0, 0.25, 3.0):
            gain.fill_(value)
            graph.replay()
            outs.append(y.clone())
        torch.cuda.synchronize()
        assert torch.equal(outs[1], 0.25 * outs[0])
        assert torch.equal(outs[2], 3.0 * outs[0])


@pytest.mark.cuda
class TestMeshOnCard:
    """The sharded streaming round (``device_mesh``) emulated on the card
    (no process group: the shards in turn, the fixed fold): Case I at
    k_block = 2 (10 K-blocks), device_mesh 1 and 5."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU")
        torch.backends.cuda.matmul.allow_tf32 = False

    @staticmethod
    def _run(dm, device="cuda", driver="scan"):
        from repro_torch.fl import Experiment
        ops.reset_launch_counts()
        e = Experiment(_case_i_spec(k_block=2, device_mesh=dm, driver=driver),
                       device=device)
        e.run(20)
        if device == "cuda":
            torch.cuda.synchronize()
        return e, dict(ops.LAUNCH_COUNTS)

    @pytest.mark.parametrize("dm", [1, 5])
    def test_scan_matches_python_bitwise(self, dm):
        """Both drivers give the same bits; K2 runs once a K-block and K5
        once a round (the graph's warm-up rounds launch too)."""
        from repro_torch.fed import runtime
        (scan, ls), (python, lp) = (self._run(dm, driver=d)
                                    for d in ("scan", "python"))
        for k in python.params:
            assert torch.equal(scan.params[k], python.params[k]), k
        for k in runtime.DIAG_KEYS:
            assert scan.history[k] == python.history[k], k
        for launches, rounds in ((ls, 20 + runtime.GRAPH_WARMUP_ROUNDS),
                                 (lp, 20)):
            assert launches["ota_superpose"] == 10 * rounds
            assert launches["sumsq"] == rounds
            assert launches["batched_moments"] == 0

    def test_device_mesh_one_is_none_bitwise(self):
        (one, _), (plain, _) = (self._run(dm) for dm in (1, None))
        for k in plain.params:
            assert torch.equal(one.params[k], plain.params[k]), k
        assert one.history == plain.history

    @pytest.mark.parametrize("dm", [1, 5])
    def test_gpu_matches_cpu(self, dm):
        (gpu, _), (cpu, _) = (self._run(dm, device=d) for d in ("cuda", "cpu"))
        for k in cpu.params:
            # fp32 gradients summed in other orders on the card and the CPU
            torch.testing.assert_close(gpu.params[k].cpu(), cpu.params[k],
                                       rtol=0.0, atol=1e-5)


@pytest.mark.cuda
class TestSweepOnCard:
    """Local steps and the batched sweep engine on the card: H = 4 local
    steps, scan against python; ``run_batched``'s lanes (one CUDA graph of
    a round of every lane) against their own sequential runs, bitwise; no
    capture on a warm repeat; engines sharing one graph memory pool,
    replayed out of their capture order, against eager runs."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU")
        torch.backends.cuda.matmul.allow_tf32 = False

    @staticmethod
    def _same(a, b):
        assert a.history == b.history
        for k in b.params:
            assert torch.equal(a.params[k], b.params[k]), k

    @pytest.mark.parametrize("over", [{}, dict(k_block=4),
                                      dict(participation=0.5,
                                           participation_mode="fixed",
                                           active_gather=True)],
                             ids=["dense", "k_block", "fixed_gather"])
    def test_local_steps_scan_is_bitwise_python(self, over):
        import dataclasses
        from repro_torch.fl import Experiment
        runs = {}
        for driver in ("scan", "python"):
            e = Experiment(dataclasses.replace(
                _case_i_spec(local_steps=4, local_lr=0.05, **over),
                driver=driver), device="cuda")
            e.run(12)
            runs[driver] = e
        self._same(runs["scan"], runs["python"])

    @staticmethod
    def _lanes(scheme, axis):
        """Three lanes of the Case-I spec that differ in one batchable
        field, and their task."""
        import dataclasses
        from repro_torch.fl import build_task
        spec = _case_i_spec()
        spec = dataclasses.replace(spec, fl=dataclasses.replace(
            spec.fl, scheme=scheme, grad_bound=2.0))
        task = build_task(spec.data, spec.model, 20, "cuda")
        values = {"seed": (0, 1, 2), "grad_bound": (0.5, 2.0, 8.0)}[axis]
        cfgs = [dataclasses.replace(spec.fl, **{axis: v}) for v in values]
        return cfgs, task

    @pytest.mark.parametrize("scheme,axis", [("normalized", "seed"),
                                             ("clipped", "grad_bound")])
    def test_run_batched_lane_is_its_run(self, scheme, axis):
        from repro_torch.fed import runtime
        from repro_torch.obs import params_sha256
        cfgs, task = self._lanes(scheme, axis)
        states = [runtime.setup(c, task.params0, task.model_dim)
                  for c in cfgs]
        states, hist = runtime.run_batched(
            cfgs, states, task.grad_fn, task.batch_provider, 20,
            eval_fn=task.eval_fn,
            chunk_batch_provider=task.chunk_batch_provider)
        for e, cfg in enumerate(cfgs):
            state = runtime.setup(cfg, task.params0, task.model_dim)
            state, want = runtime.run(
                cfg, state, task.grad_fn, task.batch_provider, 20,
                eval_fn=task.eval_fn,
                chunk_batch_provider=task.chunk_batch_provider)
            for k in runtime.DIAG_KEYS + ("test_acc", "train_loss"):
                assert hist[k][e].tolist() == want[k], (e, k)
            assert params_sha256(states[e].params) == params_sha256(
                state.params), e

    def test_warm_repeat_of_a_sweep_captures_nothing(self):
        import dataclasses
        from repro_torch.fed import runtime
        from repro_torch.fl import SweepSpec, run_sweep
        sweep = SweepSpec(dataclasses.replace(_case_i_spec(), chunk_size=8),
                          {"amplification": ("optimal", "bmax"),
                           "seed": (0, 1)})
        runtime.clear_compile_caches()
        runtime.cache_info()
        first = run_sweep(sweep, 10)
        assert runtime.cache_info()["traces_delta"]["run_chunk_batched"] == 2
        again = run_sweep(sweep, 10)
        assert set(runtime.cache_info()["traces_delta"].values()) == {0}
        assert first.params_digests == again.params_digests
        runtime.clear_compile_caches()

    def test_shared_pool_replays_out_of_capture_order(self):
        """Engines A (the dense round) and B (the streamed round, other
        temporaries) captured into the one pool, then run A, B, A, B: each
        keeps the bits of its eager (python-driver) run."""
        import dataclasses
        from repro_torch.fed import runtime
        from repro_torch.fl import Experiment
        runtime.clear_compile_caches()
        specs = {"A": _case_i_spec(), "B": _case_i_spec(k_block=4)}
        scan = {n: Experiment(s, device="cuda") for n, s in specs.items()}
        for name in ("A", "B", "A", "B", "A"):
            scan[name].run(5)
        assert runtime.cache_info()["traces"]["run_chunk"] == 2
        for name, rounds in (("A", 15), ("B", 10)):
            eager = Experiment(dataclasses.replace(specs[name],
                                                   driver="python"),
                               device="cuda")
            eager.run(rounds)
            self._same(scan[name], eager)
        runtime.clear_compile_caches()


def _case_ii_spec(**chkw):
    """The paper's Case-II experiment (ridge, K = 20, N = 30, eta 0.01,
    s_target 0.995, kernels backend; G fixed at 25) under the channel
    ``chkw``."""
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.fl import (DataSpec, EvalSpec, ExperimentSpec,
                                FLConfig, ModelSpec, build_task)
    data = DataSpec(dataset="ridge", split="iid", batch_size=50,
                    num_train=2000, dim=30, seed=10)
    model = ModelSpec(kind="ridge", lam=0.1)
    c = build_task(data, model, 20, "cpu").constants
    fl = FLConfig(num_devices=20, case="II", eta=0.01, backend="kernels",
                  channel=ChannelConfig(num_devices=20, channel_mean=1e-3,
                                        **chkw),
                  smoothness_L=c["smoothness_L"],
                  strong_convexity_M=c["strong_convexity_M"],
                  s_target=0.995, grad_bound=25.0, seed=0)
    return ExperimentSpec(fl=fl, data=data, model=model,
                          eval=EvalSpec(every=10))


CHANNEL_VARIANTS = {"iid_fading": dict(block_fading=True),
                    "ar1_csi": dict(model="ar1", rho=0.9, csi_error=0.2)}


@pytest.mark.cuda
class TestChannelOnCard:
    """Time-varying channels on the card: the host refresh (model step,
    estimate, Problem-3 re-solve) staged beside the captured round; scan
    against python bitwise, the card against the CPU, and K1, K2 and K5
    once a round."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU")
        torch.backends.cuda.matmul.allow_tf32 = False

    @pytest.mark.parametrize("variant", list(CHANNEL_VARIANTS))
    def test_scan_is_python_and_card_is_cpu(self, variant):
        import dataclasses
        from repro_torch.fed import runtime
        from repro_torch.fl import Experiment
        spec = _case_ii_spec(**CHANNEL_VARIANTS[variant])
        runtime.clear_compile_caches()
        runs = {}
        for driver in ("scan", "python"):
            e = Experiment(dataclasses.replace(spec, driver=driver),
                           device="cuda").setup()
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            e.run(20)
            torch.cuda.synchronize()
            if driver == "scan":
                for name in ("batched_moments", "ota_superpose", "sumsq"):
                    assert ops.LAUNCH_COUNTS[name] == (
                        20 + runtime.GRAPH_WARMUP_ROUNDS), name
            runs[driver] = e
        assert runs["scan"].history == runs["python"].history
        for k in runs["python"].params:
            assert torch.equal(runs["scan"].params[k],
                               runs["python"].params[k]), k
        cpu = Experiment(spec, device="cpu")
        cpu.run(20)
        for k, v in cpu.params.items():
            # the same host-drawn channel and re-solve; the round's fp32
            # sums in other orders on the card
            torch.testing.assert_close(runs["scan"].params[k].cpu(), v,
                                       rtol=0, atol=1e-5)
        np.testing.assert_array_equal(runs["scan"].state.h, cpu.state.h)
        runtime.clear_compile_caches()


def _clients_spec(client, **over):
    """The Case-I spec as benchmarks/figures.py::client_algorithms runs it
    (H = 4, local_lr 0.05, noise_var 1e-10), with ``client`` fields set."""
    import dataclasses
    spec = _case_i_spec(local_steps=4, local_lr=0.05, **over)
    channel = dataclasses.replace(spec.fl.channel, noise_var=1e-10)
    return dataclasses.replace(spec, fl=dataclasses.replace(
        spec.fl, channel=channel,
        client=dataclasses.replace(spec.fl.client, **client)))


@pytest.mark.cuda
class TestClientsOnCard:
    """The client algorithms on the card: a two-slot round captured in a
    CUDA graph and replayed, against eager rounds; batched lanes whose
    ``mu`` differs, each against its own run (a value baked into the
    captured graph would give every lane the structural config's)."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU")
        torch.backends.cuda.matmul.allow_tf32 = False

    @pytest.mark.parametrize("over", [{}, dict(k_block=4),
                                      dict(participation=0.5)],
                             ids=["dense", "k_block", "bernoulli"])
    def test_scaffold_graph_replays_are_eager_rounds(self, over):
        import dataclasses
        from repro_torch.fed import runtime
        from repro_torch.fl import Experiment
        spec = _clients_spec(dict(algo="scaffold"), **over)
        runs = {}
        for driver in ("scan", "python"):
            e = Experiment(dataclasses.replace(spec, driver=driver),
                           device="cuda").setup()
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            e.run(12)
            torch.cuda.synchronize()
            if driver == "scan" and not over:
                n = 12 + runtime.GRAPH_WARMUP_ROUNDS
                assert ops.LAUNCH_COUNTS["batched_moments"] == 2 * n
                assert ops.LAUNCH_COUNTS["ota_superpose"] == 2 * n
                assert ops.LAUNCH_COUNTS["sumsq"] == n
            runs[driver] = e
        scan, eager = runs["scan"], runs["python"]
        assert scan.history == eager.history
        for k in eager.params:
            assert torch.equal(scan.params[k], eager.params[k]), k
        for part in ("dev", "srv"):
            for k, v in eager.state.client_state[part].items():
                assert torch.equal(scan.state.client_state[part][k], v), \
                    (part, k)
        assert scan.state.client_state["srv"]["w1"].abs().max() > 0
        runtime.clear_compile_caches()

    @pytest.mark.parametrize("algo,field,values", [
        ("fedprox", "mu", (0.0, 0.5)),
        ("feddyn", "alpha", (0.01, 0.3)),
    ])
    def test_batched_client_lanes_are_their_runs(self, algo, field, values):
        from repro_torch.fed import runtime
        from repro_torch.fl import build_task
        from repro_torch.obs import params_sha256
        runtime.clear_compile_caches()
        spec = _clients_spec(dict(algo=algo))
        task = build_task(spec.data, spec.model, 20, "cuda")
        cfgs = [_clients_spec({"algo": algo, field: v}).fl_config()
                for v in values]
        states = [runtime.setup(c, task.params0, task.model_dim)
                  for c in cfgs]
        states, hist = runtime.run_batched(
            cfgs, states, task.grad_fn, task.batch_provider, 12,
            chunk_batch_provider=task.chunk_batch_provider)
        digests = []
        for e, cfg in enumerate(cfgs):
            state = runtime.setup(cfg, task.params0, task.model_dim)
            state, want = runtime.run(
                cfg, state, task.grad_fn, task.batch_provider, 12,
                chunk_batch_provider=task.chunk_batch_provider)
            for k in runtime.DIAG_KEYS:
                assert hist[k][e].tolist() == want[k], (e, k)
            digests.append(params_sha256(state.params))
            assert params_sha256(states[e].params) == digests[-1], e
        assert digests[0] != digests[1]
        runtime.clear_compile_caches()


@pytest.mark.cuda
class TestCheckpointObsOnCard:
    """Checkpoints and the flight recorder on the card at Case I: a resume
    from disk is bitwise the unbroken run under ``scan`` (the graph of the
    resumed run captured anew), a recorder changes no bit, and a
    checkpoint saved from the card loads on the CPU with the same
    leaves."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU")
        torch.backends.cuda.matmul.allow_tf32 = False

    @staticmethod
    def _same(a, b):
        from repro_torch.checkpoint import store
        assert a.history == b.history
        for k in b.params:
            assert torch.equal(a.params[k], b.params[k]), k
        got = store._flatten_with_paths(a.state.opt_state)
        want = store._flatten_with_paths(b.state.opt_state)
        assert [k for k, _ in got] == [k for k, _ in want]
        for (k, x), (_, y) in zip(got, want):
            assert torch.equal(x, y), k

    @pytest.mark.parametrize("over", [{}, dict(server_opt="adamw",
                                               participation=0.7)],
                             ids=["sgd", "adamw_p07"])
    def test_resume_from_disk_is_the_unbroken_run(self, tmp_path, over):
        from repro_torch.fl import Experiment
        spec = _case_i_spec(**over)
        cont = Experiment(spec, device="cuda")
        cont.run(20)
        first = Experiment(spec, device="cuda")
        first.run(10)
        path = first.save(str(tmp_path / "ck.msgpack"))
        resumed = Experiment(spec, device="cuda").load(path)
        resumed.run(10)
        first.history = {k: first.history[k] + resumed.history[k]
                         for k in first.history}
        first.state = resumed.state
        self._same(first, cont)

    def test_recorder_is_invisible(self, tmp_path):
        from repro_torch import obs
        from repro_torch.fl import Experiment
        off = Experiment(_case_i_spec(), device="cuda")
        off.run(20)
        rec = obs.make("jsonl", path=str(tmp_path / "run.jsonl"))
        on = Experiment(_case_i_spec(), device="cuda")
        with rec:
            on.run(20, recorder=rec)
        self._same(on, off)
        lines = [json.loads(s) for s in open(tmp_path / "run.jsonl")]
        assert [x["round"] for x in lines if x["event"] == "round"] == list(
            range(1, 21))

    def test_card_checkpoint_loads_on_the_cpu(self, tmp_path):
        from repro_torch.fl import Experiment
        from repro_torch.checkpoint import store
        spec = _case_i_spec()
        gpu = Experiment(spec, device="cuda")
        gpu.run(5)
        path = gpu.save(str(tmp_path / "ck.msgpack"))
        cpu = Experiment(spec, device="cpu").load(path)
        assert cpu.round == 5
        want = store._flatten_with_paths(gpu._ckpt_tree())
        got = store._flatten_with_paths(cpu._ckpt_tree())
        assert [k for k, _ in got] == [k for k, _ in want]
        for (k, a), (_, b) in zip(got, want):
            if isinstance(b, torch.Tensor):
                assert a.device.type == "cpu" and b.device.type == "cuda"
                assert torch.equal(a, b.cpu()), k
            else:
                np.testing.assert_array_equal(a, b, err_msg=k)


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
        (4, 8, 2, 8192, 8192, 128, True, None),    # Jamba's, one rank of 4
        (2, 8, 8, 1000, 1000, 128, True, None),    # ragged S
        (2, 8, 8, 1000, 1000, 128, False, None),
        (1, 4, 2, 333, 333, 80, True, 16),         # window < a kv tile
        (1, 4, 2, 500, 500, 8, True, None),        # d not a multiple of 16
        (1, 4, 2, 500, 500, 24, True, 100),
        (1, 4, 2, 500, 500, 64, False, None),
        (1, 4, 2, 200, 700, 80, True, None),       # Sq < Skv
        (1, 4, 2, 700, 200, 80, True, 64),         # Sq > Skv: no skipping,
        (1, 4, 2, 700, 200, 128, False, 64),       # rows fully masked
        (4, 16, 16, 8192, 2048, 64, False, None),  # seamless's cross-
        (4, 16, 16, 1, 2048, 64, False, None),     # attention, its decode
        (4, 16, 16, 2048, 2048, 64, False, None),  # seamless's encoder
        (4, 8, 8, 8192, 8192, 64, True, None),     # seamless on the mesh:
        (4, 4, 4, 8192, 8192, 64, True, None),     # a rank's decoder over
        (4, 8, 8, 2048, 2048, 64, False, None),    # model = 2 and 4, and
        (4, 4, 4, 2048, 2048, 64, False, None),    # its encoder
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
        if sq == 1 and not causal:
            return       # every window keeps all of one query row's keys
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
        (4, 8192, 2048, 16, "jamba"),     # one model rank of 4
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



def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device)


@pytest.mark.cuda
class TestZooOnCard:
    """The last three zoo configs reduced, fp32, served on the card (K6 on
    pixtral's and seamless's attention) against the same weights on the
    CPU: final hidden states within 1e-4 max|h_cpu| (fp32 sums in other
    orders: the kernel's tiles, cuBLAS's), and the prefill's token and 4
    greedy decode tokens identical."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                        "False)")
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        yield
        torch.backends.cuda.matmul.allow_tf32 = tf32

    @pytest.mark.parametrize("arch", ["pixtral-12b", "seamless-m4t-medium",
                                      "xlstm-1.3b"])
    def test_card_serves_as_the_cpu(self, arch):
        import dataclasses
        from repro_torch.configs import registry as reg
        from repro_torch.launch import serve
        from repro_torch.models import transformer as T
        cfg = dataclasses.replace(reg.reduce_config(reg.get_config(arch)),
                                  dtype="float32")
        p = T.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
        rng = np.random.default_rng(1)
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (2, 32)))}
        if cfg.modality == "vision":
            batch["modal_embeds"] = torch.from_numpy(rng.standard_normal(
                (2, cfg.num_modal_tokens, cfg.modal_embed_dim))).float()
        if cfg.is_encoder_decoder:
            batch["src_embeds"] = torch.from_numpy(rng.standard_normal(
                (2, 16, cfg.modal_embed_dim))).float()
        s = 32 + (cfg.num_modal_tokens if cfg.modality == "vision" else 0)
        out = {}
        for dev in ("cpu", "cuda"):
            params = _tree_to(p, dev)
            on = {k: v.to(dev) for k, v in batch.items()}
            ops.reset_launch_counts()
            hidden = T.forward_hidden(params, cfg, on)
            launches = ops.LAUNCH_COUNTS["flash_attention"]
            ids, cache = serve.build_prefill_cache_step(
                cfg, dev, cache_len=s + 4)(params, on)
            enc = T.encode_for_decode(params, cfg, on)
            decode = serve.build_decode_step(cfg, dev)
            got = [ids]
            for pos in range(s, s + 4):
                ids, cache = decode(params, cache, ids[:, None], pos,
                                    enc_out=enc)
                got.append(ids)
            out[dev] = (hidden.cpu(), torch.stack(got, 1).cpu(), launches)
        (h_cpu, ids_cpu, n_cpu), (h_card, ids_card, n_card) = (
            out["cpu"], out["cuda"])
        n_attn = cfg.num_layers * (not cfg.is_xlstm) + cfg.num_encoder_layers
        assert (n_cpu, n_card) == (0, n_attn)
        assert float((h_card - h_cpu).abs().max()) <= 1e-4 * float(
            h_cpu.abs().max())
        assert torch.equal(ids_card, ids_cpu)


@pytest.mark.cuda
class TestServingMeshOnCard:
    """The serving mesh emulated on the card (every rank in turn on it):
    reduced Jamba in fp32 over (1, 2) and context-parallel over (2, 1)
    gives the unsharded route's tokens; a rank's prefill launches K6 and
    K7 on its heads and channels; ``run_batched`` spread over two engines
    on the card is bitwise the unsharded batched run."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                        "False)")
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        yield
        torch.backends.cuda.matmul.allow_tf32 = tf32

    def _jamba(self):
        import dataclasses
        from repro_torch.configs import registry as reg
        from repro_torch.models import transformer as T
        cfg = dataclasses.replace(reg.reduce_config(
            reg.get_config("jamba-v0.1-52b")), dtype="float32")
        gen = torch.Generator(device="cuda").manual_seed(0)
        return cfg, T.init_params(cfg, gen, device="cuda")

    def test_mesh_tokens_are_the_unsharded_tokens(self):
        from repro_torch.launch import serve
        from repro_torch.launch.mesh import make_host_mesh
        cfg, p = self._jamba()
        toks = torch.randint(0, cfg.vocab_size, (2, 64), device="cuda",
                             generator=torch.Generator(device="cuda")
                             .manual_seed(1))

        def run(prefill, decode, params, place_cache=None):
            ids, cache = prefill(params, {"tokens": toks})
            if place_cache is not None:
                params, cache = place_cache(cache)
            out = [ids]
            for pos in range(64, 70):
                ids, cache = decode(params, cache, ids[:, None], pos)
                out.append(ids)
            return torch.stack(out, 1)
        pre = serve.build_prefill_cache_step(cfg, cache_len=72)
        want = run(pre, serve.build_decode_step(cfg), p)
        mesh = make_host_mesh(1, 2)
        pre_m, place = serve.build_prefill_cache_step(cfg, cache_len=72,
                                                      mesh=mesh)
        ops.reset_launch_counts()
        got = run(pre_m, serve.build_decode_step(cfg, mesh=mesh)[0],
                  place(p)[0])
        n_mamba = sum(k.startswith("mamba") for k in cfg.block_pattern)
        assert ops.LAUNCH_COUNTS["selective_scan"] == 2 * n_mamba * (
            cfg.num_superblocks)
        assert ops.LAUNCH_COUNTS["flash_attention"] == 2 * (
            cfg.num_superblocks)
        assert torch.equal(got, want)
        cp, place_cp = serve.build_decode_step(
            cfg, mesh=make_host_mesh(2, 1), context_parallel=True,
            cache_len=72)
        got = run(pre, cp, p, lambda cache: place_cp(p, cache))
        assert torch.equal(got, want)

    def test_two_engines_on_the_card_are_the_batched_run(self):
        from repro_torch.fl import SweepSpec, run_sweep
        sweep = SweepSpec(_case_ii_spec(), {"seed": (0, 1, 2, 3)})
        plain = run_sweep(sweep, 6, shard=False)
        two = run_sweep(sweep, 6, devices=[torch.device("cuda", 0)] * 2)
        assert two.params_digests == plain.params_digests
        for k in plain.history:
            np.testing.assert_array_equal(two.history[k], plain.history[k])


@pytest.mark.cuda
class TestTrainOnCard:
    """The training step on the card: K1 at a training-size row, the
    autograd guard of K6 and K7, and one reduced granite step against the
    CPU."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                        "False)")
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        yield
        torch.backends.cuda.matmul.allow_tf32 = tf32

    def test_k1_on_a_row_over_2_30(self):
        """One row of N = 2^30 + 3 (a ragged tail past 2^30 elements, 4.3
        GB): K1 against its plain version at the moments' rule, the same
        bits twice, and the rule rejects the plain result with the last
        chunk dropped."""
        from repro_torch.kernels.grad_norm import moments_split
        n = (1 << 30) + 3
        g = torch.randn((1, n), generator=torch.Generator(device="cuda")
                        .manual_seed(3), device="cuda")
        g[0, :5] = 100.0
        g[0, -5:] = -50.0
        sq, s = ops.batched_moments(g, impl="kernel")
        sq2, s2 = ops.batched_moments(g, impl="kernel")
        assert torch.equal(sq, sq2) and torch.equal(s, s2)
        abs_sq = abs_s = 0.0
        for lo in range(0, n, 1 << 27):
            part = g[0, lo:lo + (1 << 27)].double()
            abs_sq += float(torch.sum(part * part))
            abs_s += float(torch.sum(part.abs()))

        def within(pair):
            return (abs(float(sq[0]) - float(pair[0][0])) <= TERMS_RTOL
                    * abs_sq and abs(float(s[0]) - float(pair[1][0]))
                    <= TERMS_RTOL * abs_s)
        assert within(ops.batched_moments(g, impl="plain"))
        chunks = moments_split(1, n)
        per = -(-(-(-n // 4)) // chunks) * 4
        assert not within(ops.batched_moments(g[:, :(chunks - 1) * per],
                                              impl="plain"))

    def test_kernels_refuse_autograd(self):
        """K6 and K7 on inputs that require grad raise (no backward) and
        launch nothing; under ``torch.no_grad`` the same calls run."""
        q = torch.randn((1, 2, 64, 64), device="cuda", requires_grad=True)
        u = torch.randn((1, 64, 32), device="cuda", requires_grad=True)
        dt = torch.rand((1, 64, 32), device="cuda")
        a = -torch.rand((32, 16), device="cuda")
        bc = torch.randn((1, 64, 16), device="cuda")
        ops.reset_launch_counts()
        with pytest.raises(RuntimeError, match="no backward"):
            ops.flash_attention(q, q, q)
        with pytest.raises(RuntimeError, match="no backward"):
            ops.selective_scan(u, dt, a, bc, bc)
        assert ops.LAUNCH_COUNTS["flash_attention"] == 0
        assert ops.LAUNCH_COUNTS["selective_scan"] == 0
        with torch.no_grad():
            ops.flash_attention(q, q, q)
            ops.selective_scan(u, dt, a, bc, bc)
        torch.cuda.synchronize()
        assert ops.LAUNCH_COUNTS["flash_attention"] == 1
        assert ops.LAUNCH_COUNTS["selective_scan"] == 1

    def test_train_step_card_against_cpu(self):
        """Reduced granite, fp32, two FL clients on an emulated (2, 1) mesh,
        ``normalized`` with injected noise, two steps: the card (K1 once a
        client a step, the training attention, no K6) against the CPU:
        losses within 1e-5 relative, params within 1e-4 of their largest
        change (fp32 sums in other orders, compounded over two steps)."""
        import dataclasses
        from repro_torch.configs import registry as reg
        from repro_torch.launch import train as tl
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import transformer as T
        from repro_torch.optim.optimizers import sgd
        from repro_torch.tree import tree_leaves
        cfg = dataclasses.replace(reg.reduce_config(reg.get_config(
            "granite-moe-1b-a400m")), dtype="float32", num_layers=1)
        p0 = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
        toks = torch.randint(0, cfg.vocab_size, (4, 33),
                             generator=torch.Generator().manual_seed(1))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        ota = tl.OTARunParams(h=np.array([1e-3, 2e-3]), b=np.ones(2),
                              a=1.0 / 3e-3, noise_var=1e-9)
        noise = [tl.draw_noise(torch.Generator().manual_seed(t), p0, 1e-9,
                               "cpu") for t in range(2)]
        out = {}
        for dev in ("cpu", "cuda"):
            step, place = tl.build_train_step(
                cfg, make_host_mesh(2, 1, emulate=True), scheme="normalized",
                aggregation_axes=("data",), ota=ota, optimizer=sgd(0.05),
                device=dev)
            params, state, rows = place(_tree_to(p0, dev),
                                        sgd(0.05).init(_tree_to(p0, dev)),
                                        batch)
            ops.reset_launch_counts()
            losses = []
            for t in range(2):
                params, state, m = step(params, state, rows,
                                        noise=noise[t].to(dev))
                losses.append(float(m["loss"]))
            out[dev] = (losses, [l.cpu() for l in tree_leaves(params[0])],
                        dict(ops.LAUNCH_COUNTS))
        (l_cpu, p_cpu, n_cpu), (l_card, p_card, n_card) = out["cpu"], \
            out["cuda"]
        assert n_card["batched_moments"] == 4 and n_cpu["batched_moments"] \
            == 0
        assert n_card["flash_attention"] == 0
        for a, b in zip(l_card, l_cpu):
            assert abs(a - b) <= 1e-5 * abs(b)
        start = tree_leaves(p0)
        moved = max(float((b - s).abs().max()) for b, s in zip(p_cpu, start))
        gap = max(float((a - b).abs().max()) for a, b in zip(p_card, p_cpu))
        assert gap <= 1e-4 * moved


@pytest.mark.cuda
class TestTPTrainOnCard:
    """Tensor-parallel training on the card: the emulated mesh's backward
    (its folds on the ranks' own threads) completes and matches one model
    rank, a rank that waits in a backward fold on autograd's device thread
    is caught by the watchdog, and K1 at a model rank's cut row."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                        "False)")
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        yield
        torch.backends.cuda.matmul.allow_tf32 = tf32

    def test_emulated_2x2_step_completes_and_matches_one_rank(self):
        """Reduced granite, fp32, an emulated (2, 2) mesh on the card, two
        ``normalized`` steps with injected noise, each within 60 s: losses
        within 1e-5 relative of the (2, 1) mesh's, params (gathered) within
        1e-4 of their largest change; K1 twice a rank a step."""
        import dataclasses
        import time
        from repro_torch.configs import registry as reg
        from repro_torch.distribution import sharding as SH
        from repro_torch.launch import train as tl
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import transformer as T
        from repro_torch.optim.optimizers import sgd
        from repro_torch.tree import tree_leaves
        cfg = dataclasses.replace(reg.reduce_config(reg.get_config(
            "granite-moe-1b-a400m")), dtype="float32")
        p0 = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cuda")
        toks = torch.randint(0, cfg.vocab_size, (4, 65),
                             generator=torch.Generator().manual_seed(1))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        ota = tl.OTARunParams(h=np.array([1e-3, 2e-3]), b=np.ones(2),
                              a=1.0 / 3e-3, noise_var=1e-9)
        noise = [tl.draw_noise(torch.Generator().manual_seed(t), p0, 1e-9,
                               "cuda") for t in range(2)]
        out = {}
        for m in (1, 2):
            mesh = make_host_mesh(2, m, emulate=True)
            step, place = tl.build_train_step(
                cfg, mesh, scheme="normalized", aggregation_axes=("data",),
                ota=ota, optimizer=sgd(0.05), device="cuda")
            params, state, rows = place(p0, sgd(0.05).init(p0), batch)
            ops.reset_launch_counts()
            losses = []
            for t in range(2):
                t0 = time.perf_counter()
                params, state, m_ = step(params, state, rows, noise=noise[t])
                losses.append(float(m_["loss"]))
                assert time.perf_counter() - t0 < 60.0
            out[m] = (losses, SH.gather_params(params, mesh, cfg, p0),
                      ops.LAUNCH_COUNTS["batched_moments"])
        assert out[1][2] == 4 and out[2][2] == 16
        for a, b in zip(out[2][0], out[1][0]):
            assert abs(a - b) <= 1e-5 * abs(b)
        start = tree_leaves(p0)
        moved = max(float((b - s).abs().max())
                    for b, s in zip(tree_leaves(out[1][1]), start))
        gap = max(float((a - b).abs().max()) for a, b in
                  zip(tree_leaves(out[2][1]), tree_leaves(out[1][1])))
        assert gap <= 1e-4 * moved

    def test_watchdog_catches_a_backward_fold_on_the_device_thread(self):
        """The deadlock the emulated mesh avoids: with autograd's device
        threads back on (inside the ranks), rank 0's backward fold waits
        on the one device thread that rank 1's backward needs.  The wait
        times out and the run raises naming the rank, instead of hanging."""
        import time
        from repro_torch.distribution.tensor_parallel import run_ranks
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(1, 2, emulate=True)
        x = torch.randn(64, device="cuda")

        def program(ctx):
            with torch.autograd.set_multithreading_enabled(True):
                a = x.clone().requires_grad_()
                y = ctx.fold(torch.sin(ctx.enter(a)) * (ctx.m + 1))
                return torch.autograd.grad(y.sum(), a)[0]
        t0 = time.perf_counter()
        with pytest.raises(TimeoutError, match="rank 1"):
            run_ranks(mesh, program, timeout=10.0)
        assert time.perf_counter() - t0 < 60.0
        # the same program on the ranks' own threads completes
        def fixed(ctx):
            a = x.clone().requires_grad_()
            y = ctx.fold(torch.sin(ctx.enter(a)) * (ctx.m + 1))
            return torch.autograd.grad(y.sum(), a)[0]
        g = run_ranks(mesh, fixed, timeout=10.0)
        want = 3.0 * torch.cos(x)
        assert torch.equal(g[0], g[1])
        assert float((g[0] - want).abs().max()) <= 1e-6

    def test_k1_at_a_cut_row(self):
        """K1 at a model rank's cut row of granite-moe-1b-a400m over model
        = 2 ([1, 641,728,512] fp32, 2.57 GB) and at its replicated row ([1,
        101,506,048]) against the plain version at the moments' rule."""
        for n in (641_728_512, 101_506_048):
            g = torch.randn((1, n), generator=torch.Generator(device="cuda")
                            .manual_seed(5), device="cuda")
            sq, s = ops.batched_moments(g, impl="kernel")
            sq_p, s_p = ops.batched_moments(g, impl="plain")
            abs_sq = abs_s = 0.0
            for lo in range(0, n, 1 << 27):
                part = g[0, lo:lo + (1 << 27)].double()
                abs_sq += float(torch.sum(part * part))
                abs_s += float(torch.sum(part.abs()))
            assert abs(float(sq[0]) - float(sq_p[0])) <= TERMS_RTOL * abs_sq
            assert abs(float(s[0]) - float(s_p[0])) <= TERMS_RTOL * abs_s
            del g


@pytest.mark.cuda
class TestFSDPOnCard:
    """FSDP over ``data`` on the card: the mean step bitwise the step
    without FSDP on an emulated mesh; xlstm and seamless cut over the
    model axis give the uncut model's greedy tokens."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                        "False)")
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        yield
        torch.backends.cuda.matmul.allow_tf32 = tf32

    @pytest.mark.parametrize("shape,remat", [((2, 2), True), ((4, 2), False)])
    def test_fsdp_step_is_the_plain_step_bitwise(self, shape, remat):
        """Reduced granite, fp32, two adamw steps: every rank's slice of the
        params and of the optimizer state, and the metrics, the same bits
        as the step without FSDP."""
        import dataclasses
        from repro_torch.configs import registry as reg
        from repro_torch.distribution import sharding as SH
        from repro_torch.launch import train as tl
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import transformer as T
        from repro_torch.optim.optimizers import adamw
        from repro_torch.tree import tree_leaves
        cfg = dataclasses.replace(reg.reduce_config(reg.get_config(
            "granite-moe-1b-a400m")), dtype="float32", remat=remat)
        p0 = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cuda")
        toks = torch.randint(0, cfg.vocab_size, (8, 65),
                             generator=torch.Generator().manual_seed(1))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        mesh = make_host_mesh(*shape, emulate=True)
        out = {}
        for fsdp in (None, "data"):
            o = adamw(0.01)
            step, place = tl.build_train_step(cfg, mesh, scheme="mean",
                                              fsdp_axis=fsdp, optimizer=o,
                                              device="cuda")
            params, state, rows = place(p0, o.init(p0), batch)
            ms = []
            for _ in range(2):
                params, state, m = step(params, state, rows)
                ms.append(m)
            out[fsdp] = (params, state, ms)
        for r in range(mesh.size):
            for tree in ("params", "mu", "nu"):
                def pick(res, r=r, tree=tree):
                    return (res[0] if tree == "params" else
                            [getattr(s, tree) for s in res[1]])
                whole = SH.gather_params(pick(out[None]), mesh, cfg, p0)
                want = SH.shard_params(whole, mesh, r, cfg, "data")
                assert all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(pick(out["data"])[r]), tree_leaves(want)))
        for a, b in zip(out[None][2], out["data"][2]):
            assert all(torch.equal(a[k], b[k]) for k in a)

    @pytest.mark.parametrize("arch,model", [("xlstm-1.3b", 2),
                                            ("seamless-m4t-medium", 4)])
    def test_cut_zoo_tokens_are_the_uncut_tokens(self, arch, model):
        """Reduced, fp32: the prefill's token and 8 greedy tokens over an
        emulated (1, model) mesh on the card equal the uncut route's."""
        import dataclasses
        from repro_torch.configs import registry as reg
        from repro_torch.launch import serve
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import transformer as T
        cfg = dataclasses.replace(reg.reduce_config(reg.get_config(arch)),
                                  dtype="float32")
        p = T.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cuda")
        g = torch.Generator().manual_seed(2)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 64),
                                         generator=g)}
        if cfg.is_encoder_decoder:
            batch["src_embeds"] = torch.randn((4, 32, cfg.modal_embed_dim),
                                              generator=g)
        runs = []
        for mesh in (None, make_host_mesh(1, model, emulate=True)):
            kw = {} if mesh is None else {"mesh": mesh}
            pre = serve.build_prefill_cache_step(cfg, "cuda", cache_len=72,
                                                 **kw)
            dec = serve.build_decode_step(cfg, "cuda", **kw)
            enc = serve.build_encode_step(cfg, "cuda", **kw)
            params = p
            if mesh is not None:
                (pre, place), (dec, _), (enc, _) = pre, dec, enc
                params = place(p)[0]
            e = enc(params, batch) if cfg.is_encoder_decoder else None
            ids, cache = pre(params, batch)
            out = [ids]
            for pos in range(64, 72):
                ids, cache = dec(params, cache, ids[:, None], pos, enc_out=e)
                out.append(ids)
            runs.append(torch.stack(out, 1).cpu())
        assert torch.equal(runs[0], runs[1])


# pieces of leaves that the train step's noise kernel draws: (the whole
# shape, the rank's regions), as in tests/test_torch_channel_noise.py
NOISE_PIECES = [
    ((1 << 20,), None),
    ((24, 32, 1024, 512), [(slice(None), slice(16, 32), slice(None),
                            slice(None))]),
    ((6, 8, 10), [(slice(2, 4), slice(None), slice(5, 10))]),
    ((3, 4, 16), [(slice(None), slice(None), slice(2, 4)),
                  (slice(None), slice(None), slice(10, 12))]),
    ((7, 11, 3), [(slice(None), slice(3, 8), slice(1, 3))]),
    ((1001,), [(slice(333, 1000),)]),
]


@pytest.mark.cuda
class TestChannelNoiseOnCard:
    """The channel-noise kernel (``csrc/channel_noise.cu``) against its
    plain version: the uniforms bitwise, the normals and the fused update
    the same bits (both are correctly rounded fp32 operations in one
    order; chip_smoke.py allows 2 ulp in the normals), a piece the whole
    draw's slice, and a seeded train step its whole draw injected."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                        "False)")

    @pytest.mark.parametrize("i", range(len(NOISE_PIECES)))
    def test_kernel_is_the_plain_version(self, i):
        from repro_torch import rng
        from repro_torch.kernels import ref
        from repro_torch.kernels.channel_noise import (noise_uniforms_cuda,
                                                       piece_map)
        full, regions = NOISE_PIECES[i]
        pmap = piece_map(full, regions)
        stream = rng.noise_key(11, i)
        w = ref.piece_whole_index(torch.arange(pmap.numel, device="cuda"),
                                  pmap)
        u1, u2 = ref.noise_uniforms_ref(stream, w)
        uni = noise_uniforms_cuda(stream, pmap, "cuda")
        assert torch.equal(uni[:, 0], u1) and torch.equal(uni[:, 1], u2)
        n = ops.channel_noise(torch.zeros(pmap.numel, device="cuda"), stream,
                              1.0, 1.0, pmap, impl="kernel")
        assert torch.equal(n, ref.noise_normals_ref(u1, u2))
        y = torch.randn(pmap.numel, device="cuda")
        got = ops.channel_noise(y, stream, 0.03, 250.0, pmap, inplace=False,
                                impl="kernel")
        want = ops.channel_noise(y, stream, 0.03, 250.0, pmap, inplace=False,
                                 impl="plain")
        assert torch.equal(got, want)
        assert torch.equal(got.cpu(), ops.channel_noise(
            y.cpu(), stream, 0.03, 250.0, pmap, inplace=False))

    def test_piece_is_the_whole_draws_slice(self):
        from repro_torch.kernels.channel_noise import piece_map
        full = (8, 12, 64)
        regions = [(slice(4, 8), slice(None), slice(8, 16)),
                   (slice(4, 8), slice(None), slice(40, 48))]
        whole = ops.channel_noise(torch.zeros(full, device="cuda"), 5, 1.0,
                                  1.0, impl="kernel")
        piece = ops.channel_noise(torch.zeros((4, 12, 16), device="cuda"),
                                  5, 1.0, 1.0, piece_map(full, regions),
                                  impl="kernel")
        assert torch.equal(piece, torch.cat([whole[r] for r in regions],
                                            dim=-1))

    def test_seeded_step_is_its_whole_draw_injected(self):
        import dataclasses
        from repro_torch.configs import registry as reg
        from repro_torch.launch import train as tl
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import transformer as T
        from repro_torch.optim import optimizers as opt
        from repro_torch.tree import tree_leaves
        cfg = dataclasses.replace(reg.reduce_config(
            reg.get_config("granite-moe-1b-a400m")), dtype="float32")
        p0 = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cuda")
        ota = tl.OTARunParams(h=np.full(4, 1e-3), b=np.ones(4), a=250.0,
                              noise_var=1e-4)
        toks = torch.randint(0, cfg.vocab_size, (8, 32),
                             generator=torch.Generator().manual_seed(3))
        runs = []
        for injected in (False, True):
            o = opt.sgd(0.05)
            step, place = tl.build_train_step(
                cfg, make_host_mesh(4, 2, emulate=True), scheme="normalized",
                aggregation_axes=("data",), ota=ota, optimizer=o,
                device="cuda")
            p, s, rows = place(p0, o.init(p0), {"tokens": toks,
                                                "labels": toks.roll(-1, 1)})
            ops.reset_launch_counts()
            if injected:
                p, s, m = step(p, s, rows, noise=tl.seeded_noise(
                    9, p0, ota.noise_var, "cuda"))
                assert ops.LAUNCH_COUNTS["channel_noise"] == 0
            else:
                p, s, m = step(p, s, rows, 9)
                # one launch a leaf a rank
                assert ops.LAUNCH_COUNTS["channel_noise"] == (
                    8 * len(tree_leaves(p0)))
            runs.append(p)
        for a, b in zip(runs[0], runs[1]):
            assert all(torch.equal(x, y) for x, y in zip(
                tree_leaves(a), tree_leaves(b)))
