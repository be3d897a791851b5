#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero and prints no result:

1. device  -- the card, and ``nvidia-smi``'s name and power limit;
2. build   -- compiles every Hopper kernel from ``src/repro_torch/kernels/
              csrc`` with nvcc (one process per source, started together);
              fails if ptxas reports a spill in any kernel;
3. kernel  -- each kernel against its plain PyTorch version on the card, with
              the tolerance stated in the line: the dense moments (K1) and
              superposition (K2) at the FL round's shape (K = 20,
              N = 55,050), a wide-K shape (K = 1000) and a ragged one (K = 7,
              N = 1,000,003), and K2 at the streaming round's tile
              [1000, 2048]; the streamed moments (K3) and superposition (K4)
              at those three shapes (k_block 4, 100, 1) and the K-scale shape
              (K = 100,000, N = 2,048, k_block 1,000); the single-vector
              norm (K5) at the round's N and on each stack flattened.  Each
              K2 row shows its split S of the K-way sum and, where S > 1,
              that its tolerance rejects a result that lacks one K-chunk;
              each K4 row its chunks of whole K-blocks (S = 1: one pass)
              and that its tolerance rejects a result that lacks one
              K-block; each K1 and K3 row its chunks a row.  Device
              times (CUDA events over CUDA-graph replays, median of 50
              samples of 20 launches) beside the bytes bound and a PyTorch
              library call timed as a yardstick only, and the eager per-call
              times (host included);
4. main    -- 20 rounds of the paper's Case-I experiment (synthetic MNIST,
              784-64-64-10 MLP, K = 20, normalized scheme, kernels backend)
              through ``Experiment(spec, device="cuda").run``; the launch
              counts of K1, K2 and K5, finite history, falling train loss,
              and the final params against the same spec run on the CPU;
5. profile -- device time by kernel over 5 rounds (torch.profiler), and
              host time by function over 10 rounds (cProfile);
6. stream_facade -- the Case-I spec with k_block = 4 through
              ``Experiment.run``, 20 rounds, against the dense run of phase 4
              (STREAM_TOL); then participation 0.5 (bernoulli, fixed, fixed
              with active_gather) for 5 rounds each;
7. stream_ota -- ``ota.aggregate(OTAConfig(backend="kernels",
              k_block=1000))`` at the K-scale shape for four schemes, against
              the dense aggregate on the card and the plain route on the
              CPU; K3 and K4 must launch;
8. stream  -- the repo's 100,000-device case (benchmarks/kscale_case.py):
              3 streaming rounds of a {"w": [2048]} linear model over a
              shared pool, batches made per K-block through
              ``block_batch_provider``; rounds/s, K2 launches (100 a round),
              peak device memory under 512 MiB, params against the CPU;
9. flash   -- flash attention (K6) against its plain version, both
              bodies (fp32 in 3xTF32 on the tensor cores through
              mma.sync, bf16 on the tensor cores through wgmma and TMA), at the serving layer's shape ([4, 32,
              8192, 80] over 8 kv heads, window 4,096, as the prefill gives
              it, and at B = 1), at Jamba's attention layer's ([4 and 1, 32,
              8192, 128] over 8 kv heads, causal, no window), a ragged
              [2, 8, 1000, 128] causal and not, a window (16) smaller than a
              kv tile, head dims 8, 24 and 64, and Sq != Skv (200 queries
              over 700 keys; 700 over 200 with rows whose every key is
              masked); each row also shows that its tolerance rejects the
              plain result with the last kv tile dropped and with the window
              off by one, that two launches are bitwise equal, and ptxas's
              registers, shared memory and spills of the body (none may
              spill); device times beside the operations bound and
              ``scaled_dot_product_attention`` (a yardstick only);
10. serve  -- h2o-danube-1.8b at full width and depth (24 layers, d_model
              2,560, 32 heads over 8 kv heads, d_ff 6,912, vocab 32,000),
              random bf16 weights from a seed, through the serving steps:
              4 prompts of 8,192 tokens (twice the window) prefilled with
              the decode cache, then 32 greedy decode steps; K6 launches
              (24 a prefill), prefill and decode tokens/s, peak memory,
              where the device time goes; then in fp32 at B = 1 the kernel
              route against the plain route (final hidden states, greedy
              token) and prefill -> decode at position 8,192 against the
              forward over 8,193 tokens;
11. scan   -- the selective scan (K7) against its plain version, fp32 and
              bf16 u, B, C, at the Jamba prefill's [4, 8192, 8192, 16], at
              B = 1, ragged [2, 1000, 1000, 16] and [1, 333, 77, 5] with
              the reference kernel test's a and dt, and at the prefill's
              shape with Jamba's own (a = -(1..16), dt in [1e-3, 0.1]), the
              final state h_S too; each row also shows that its tolerance
              rejects the plain result with one time step dropped and with
              the state reset at a tile boundary; device times beside the
              operations bound (no PyTorch call computes the scan);
12. serve_hybrid -- jamba-v0.1-52b at full width, cut to one superblock of
              its four (8 layers: 1 attention, 7 Mamba, 4 MoE and 4 dense
              MLPs; 13.3 B parameters), random bf16 weights from a seed,
              through the same serving steps and prompts; 7 K7 and 1 K6
              launches a prefill; then in fp32 at B = 1 over 2,048 tokens
              the kernel route against the plain route (top-2 routing
              flips per MoE layer beside the router gaps; hidden states
              and greedy token over the tokens before the first flip) and
              the prefill -> decode handoff at
              capacity_factor 8.

Then the ``{"kernels": [...]}`` line, and last the ``{"ok": true, ...}`` line.

    python3 chip_smoke.py --rates [--src OTHER_TREE/src]

times only the warm Case-I round (20 rounds, no eval) and the K-scale round
(one round), RATE_SAMPLES samples each, then the device time of one more
K-scale round by kernel (torch.profiler), for the package under ``--src``
(default: this tree's), and prints one ``{"phase": "rates", ...}`` line:
run it on two trees in one machine session to compare them.
"""
from __future__ import annotations

import gc
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import torch

ROUNDS = 20
K_MAIN, N_MAIN = 20, 55_050
SHAPES = ((K_MAIN, N_MAIN), (1000, N_MAIN), (7, 1_000_003))
# (K, N, k_block) of the streamed kernels: the round's shape, wide K,
# ragged N, and the K-scale shape
STREAM_SHAPES = ((K_MAIN, N_MAIN, 4), (1000, N_MAIN, 100), (7, 1_000_003, 1),
                 (100_000, 2_048, 1_000))
K_SCALE, N_SCALE, KB_SCALE = 100_000, 2_048, 1_000
STREAM_ROUNDS = 3
RATE_SAMPLES = 7
STREAM_MEM_LIMIT_MB = 512.0      # a [K, B, 2048] batch stack alone is 6.55 GB
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
TF32_FLOPS_PER_S = 495e12        # H100 SXM TF32 tensor cores, dense
EPS32 = 2.0 ** -23
SAMPLES, LAUNCHES = 50, 20
# |kernel - plain| <= 1e-5 sum|terms| per device (moments) or per column
# (superposition; there capped by the rigorous 2 (K+2) eps32 at small K)
TERMS_RTOL = 1e-5
PARAMS_ATOL = 1e-5               # final params, GPU run vs CPU run
# streamed vs dense: the blocked K-way sums re-associate (the reference's
# STREAM_TOL, tests/test_streaming.py)
STREAM_RTOL, STREAM_ATOL = 3e-4, 1e-6
# K-scale round, GPU vs CPU: K-way fp32 sums over 100,000 terms in other
# orders on the card and the CPU, compounded over 3 rounds
KSCALE_REL = 1e-4
T_START = time.perf_counter()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _median_ms(run) -> float:
    """Median over SAMPLES of CUDA-event time of ``run()`` / LAUNCHES."""
    samples = []
    for _ in range(SAMPLES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / LAUNCHES)
    return statistics.median(samples)


def call_ms(fn) -> float:
    """Time per eager call of ``fn`` (LAUNCHES back to back): the host's
    Python and launch cost included, as the FL round pays it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(LAUNCHES):
            fn()
    return _median_ms(run)


_SIDE_STREAM = []


def device_ms(fn) -> float:
    """Device time per call of ``fn``: LAUNCHES calls captured in one CUDA
    graph and replayed, so no host cost is in the interval.  The warm-up
    and the capture run on one side stream, made once: every stream that
    runs a product keeps a cuBLAS workspace of its own, and K1's arrival
    counters are the stream's, so the graph holds no zeroing of them."""
    if not _SIDE_STREAM:
        _SIDE_STREAM.append(torch.cuda.Stream())
    side = _SIDE_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(LAUNCHES):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _median_ms(graph.replay)


def timings(kernel, plain, library=None) -> dict:
    return {"kernel_ms": device_ms(kernel), "plain_ms": device_ms(plain),
            "library_ms": None if library is None else device_ms(library),
            "kernel_call_ms": call_ms(kernel), "plain_call_ms": call_ms(plain)}


def bound(nbytes: float, flops: float, flops_per_s: float = FP32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def test_stack(k: int, n: int, gen: torch.Generator) -> torch.Tensor:
    """Random normal rows with exact zeros (sign(0) = 0) and large values at
    each row's head and tail, so a dropped or doubled edge element shows."""
    g = torch.randn((k, n), generator=gen, device="cuda")
    g[:, ::5] = 0.0
    g[:, :5] = 100.0
    g[:, -5:] = -50.0
    return g


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # fp32 stays fp32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0], "allow_tf32": False}
    emit(info)
    return info


def phase_build(build) -> None:
    """Builds every library; fails if ptxas reports a spill in any kernel."""
    t0 = time.perf_counter()
    took = build.build_all()
    ptxas = {name: build.ptxas_report(name) for name in build.SOURCES}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": took, "ptxas": ptxas})
    spills = [f"{name}: {entry} {row}" for name, report in ptxas.items()
              for entry, row in report.items()
              if row["spill_stores"] or row["spill_loads"]]
    if spills:
        fail("ptxas reports spills: " + "; ".join(spills))


def check_moments(ops, g: torch.Tensor, k_block=None) -> dict:
    from repro_torch.kernels.grad_norm import (moments_split,
                                               stream_moments_chunks)
    k, n = g.shape
    sq, s = ops.batched_moments(g, impl="kernel", k_block=k_block)
    sq_p, s_p = ops.batched_moments(g, impl="plain", k_block=k_block)
    torch.cuda.synchronize()
    # the two fp32 summations associate differently; tolerance relative to
    # the sum of absolute terms (fp64), 1e-5 -- each blocked sum's depth is
    # a few hundred levels at most at these shapes
    abs_sq = (g.double() ** 2).sum(1)
    abs_s = g.double().abs().sum(1)
    err = max(float((sq - sq_p).abs().max()), float((s - s_p).abs().max()))
    ok = bool(((sq - sq_p).abs().double() <= TERMS_RTOL * abs_sq).all()
              and ((s - s_p).abs().double() <= TERMS_RTOL * abs_s).all())
    b_ms, b_by = bound(k * n * 4 + 2 * k * 4, 3.0 * k * n)
    # the host's chunks a row for this shape (not a measurement)
    split = {"chunks_per_row": moments_split(k, n) if k_block is None
             else stream_moments_chunks(n)}
    return {"kernel": ("batched_moments" if k_block is None
                       else "streaming_moments"),
            "k": k, "n": n, "k_block": k_block, **split,
            "max_abs_err": err,
            "tolerance": f"|d| <= {TERMS_RTOL:g} * sum|terms| per device",
            "within_tolerance": ok,
            **timings(lambda: ops.batched_moments(g, impl="kernel",
                                                  k_block=k_block),
                      lambda: ops.batched_moments(g, impl="plain",
                                                  k_block=k_block),
                      lambda: torch.linalg.vector_norm(g, dim=1)),
            "library_call": "torch.linalg.vector_norm(g, dim=1)",
            "bound_ms": b_ms, "bound_by": b_by}


def check_superpose(ops, g: torch.Tensor, pre: str,
                    gen: torch.Generator, k_block=None) -> dict:
    from repro_torch.kernels.ota_aggregate import stream_split, superpose_split
    k, n = g.shape
    scale = torch.rand((k,), generator=gen, device="cuda") + 0.5
    noise = 0.01 * torch.randn((n,), generator=gen, device="cuda")
    a = 0.9
    kw = dict(pre=pre, k_block=k_block)
    y = ops.ota_superpose(g, scale, noise, a, impl="kernel", **kw)
    yp = ops.ota_superpose(g, scale, noise, a, impl="plain", **kw)
    torch.cuda.synchronize()
    x = torch.sign(g) if pre == "sign" else g
    # per column, relative to the sum of absolute terms: 1e-5, as the
    # moments; at small K the rigorous fp32 bound of two K-term sums plus
    # the noise add and the gain, 2 (K+2) eps32, is the tighter one
    ref_abs = a * (scale.double().abs() @ x.double().abs()
                   + noise.double().abs())
    rtol = min(2 * (k + 2) * EPS32, TERMS_RTOL)
    tol = rtol * ref_abs
    d = (y - yp).abs().double()
    check = {}
    # the rows the kernel sums apart: K4's K-blocks (in split_s chunks of
    # whole blocks), K2's K-chunks; split_s is what the wrapper's chooser
    # gives for this shape, printed in this row only (not a measurement)
    if k_block is None:
        check["split_s"] = superpose_split(k, n)
        block = -(-k // check["split_s"])
    else:
        check["split_s"] = stream_split(k, n, k_block)
        block = k_block
    if block < k:
        # the tolerance must reject a result that lacks one K-block or
        # K-chunk: that result is off by block b's term a p_b (about
        # sqrt(block) per column on these stacks, against about 1e-5 K)
        lo = min(1, -(-k // block) - 1) * block
        part = a * (scale[lo:lo + block].double()
                    @ x[lo:lo + block].double())
        check["rejects_dropped_block"] = not bool((part.abs() <= tol).all())
    b_ms, b_by = bound(k * n * 4 + 2 * n * 4 + k * 4, 2.0 * k * n)
    # one PyTorch call computes the identity sum: the yardstick
    library = (lambda: scale @ g) if pre == "identity" else None
    return {"kernel": ("ota_superpose" if k_block is None
                       else "ota_superpose_streaming"),
            "pre": pre, "k": k, "n": n, "k_block": k_block,
            "max_abs_err": float(d.max()),
            "max_rel_err": float((d / ref_abs.clamp_min(1e-30)).max()),
            "tolerance": (f"|d_j| <= {rtol:.3g} a (sum_k |s_k x_kj| + |z_j|)"
                          " = min(2 (K+2) eps32, 1e-5) * sum|terms|"),
            "within_tolerance": bool((d <= tol).all()),
            **check,
            **timings(lambda: ops.ota_superpose(g, scale, noise, a,
                                                impl="kernel", **kw),
                      lambda: ops.ota_superpose(g, scale, noise, a,
                                                impl="plain", **kw),
                      library),
            "library_call": "scale @ g" if library else None,
            "bound_ms": b_ms, "bound_by": b_by}


def check_sumsq(ops, x: torch.Tensor) -> dict:
    n = x.shape[0]
    got = ops.grad_norm(x, impl="kernel")
    want = ops.grad_norm(x, impl="plain")
    torch.cuda.synchronize()
    # sums of squares: two fp32 sums of n positive terms, relative 1e-5
    d = abs(float(got.double() ** 2 - want.double() ** 2))
    b_ms, b_by = bound(n * 4 + 4, 2.0 * n)
    return {"kernel": "sumsq", "n": n, "max_abs_err": d,
            "tolerance": f"|d(sum x^2)| <= {TERMS_RTOL:g} * sum x^2",
            "within_tolerance": d <= TERMS_RTOL * float((x.double() ** 2)
                                                          .sum()),
            **timings(lambda: ops.grad_norm(x, impl="kernel"),
                      lambda: ops.grad_norm(x, impl="plain"),
                      lambda: torch.linalg.vector_norm(x)),
            "library_call": "torch.linalg.vector_norm(x)",
            "bound_ms": b_ms, "bound_by": b_by}


def _emit_checked(rows, where: str) -> None:
    for row in rows:
        row["phase"] = "kernel"
        emit(row)
        if not row["within_tolerance"]:
            fail(f"{row['kernel']} disagrees with its plain version at "
                 f"{where}: max |d| = {row['max_abs_err']}")
        if row.get("rejects_dropped_block") is False:
            fail(f"{row['kernel']}'s tolerance at {where} would pass a "
                 "result that lacks a K-block or K-chunk")


def phase_kernels(ops) -> dict:
    """Every kernel against its plain version; returns the row of each
    kernel at the shape of the path that runs it (K1, K2, K5: the Case-I
    round; K3, K4: the K-scale aggregate)."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    path_rows = {}
    for k, n in SHAPES + ((KB_SCALE, N_SCALE),):
        g = test_stack(k, n, gen)
        rows = [] if n == N_SCALE else [check_moments(ops, g)]
        rows += [check_superpose(ops, g, pre, gen)
                 for pre in ("identity", "sign")]
        for row in rows:
            row["l2_resident"] = k * n * 4 < 50e6
        _emit_checked(rows, f"K={k} N={n}")
        if (k, n) == (K_MAIN, N_MAIN):
            path_rows["batched_moments"] = rows[0]
            path_rows["ota_superpose"] = rows[1]
            row = check_sumsq(ops, g[0].contiguous())
            _emit_checked([row], f"N={n}")
            path_rows["sumsq"] = row
        del g
    for k, n, kb in STREAM_SHAPES:
        g = test_stack(k, n, gen)
        rows = [check_moments(ops, g, kb)]
        rows += [check_superpose(ops, g, pre, gen, kb)
                 for pre in ("identity", "sign")]
        rows.append(check_sumsq(ops, g.reshape(-1)))
        for row in rows:
            row["l2_resident"] = k * n * 4 < 50e6
        _emit_checked(rows, f"K={k} N={n} k_block={kb}")
        if (k, n) == (K_SCALE, N_SCALE):
            path_rows["streaming_moments"] = rows[0]
            path_rows["ota_superpose_streaming"] = rows[1]
        del g
    torch.cuda.empty_cache()
    return path_rows


def case_i_spec():
    """The paper's Case-I experiment (benchmarks/common.py::CaseIExperiment)
    on the kernels backend."""
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.fl import (DataSpec, EvalSpec, ExperimentSpec, FLConfig,
                                ModelSpec)
    fl = FLConfig(num_devices=K_MAIN, scheme="normalized", backend="kernels",
                  case="I", p=0.75, smoothness_L=5.0, expected_loss_drop=2.0,
                  channel=ChannelConfig(num_devices=K_MAIN,
                                        channel_mean=1e-3),
                  seed=0)
    data = DataSpec(dataset="synthetic_mnist", split="dirichlet", alpha=1.0,
                    batch_size=50, num_train=4000, num_test=1000, seed=0)
    return ExperimentSpec(fl=fl, data=data, model=ModelSpec(kind="mlp",
                                                            hidden=64),
                          eval=EvalSpec(every=10))


def phase_main(ops) -> dict:
    from repro_torch.fl import Experiment
    spec = case_i_spec()
    gpu = Experiment(spec, device="cuda").setup()
    if gpu.task.model_dim != N_MAIN:
        fail(f"model dimension {gpu.task.model_dim} != {N_MAIN}")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    first = gpu.run(1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rest = gpu.run(ROUNDS - 1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(ops.LAUNCH_COUNTS)
    params_at_rounds = {k: v.detach().clone() for k, v in gpu.params.items()}
    hist = {k: first[k] + rest[k] for k in first}
    # the dense round's kernels: moments, superposition, update norm
    for name in ("batched_moments", "ota_superpose", "sumsq"):
        if launches[name] < ROUNDS:
            fail(f"{name} launched {launches[name]} times in {ROUNDS} "
                 "rounds")
    values = [v for key, vals in hist.items() if key != "round"
              for v in vals]
    if not all(math.isfinite(v) for v in values):
        fail("non-finite history")
    loss = hist["train_loss"]
    if not loss[-1] < loss[0]:
        fail(f"train_loss did not fall: {loss}")

    # steady state: 20 more rounds, no eval
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    gpu.run(ROUNDS, evaluate=False)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t3

    cpu = Experiment(spec, device="cpu")
    cpu.run(ROUNDS)
    cpu.run(ROUNDS, evaluate=False)
    diff = max(float((gpu.params[k].cpu() - cpu.params[k]).abs().max())
               for k in cpu.params)
    if not diff <= PARAMS_ATOL:
        fail(f"GPU and CPU params differ by {diff} > {PARAMS_ATOL}")
    out = {"phase": "main", "rounds": ROUNDS, "launches": launches,
           "first_round_s": t1 - t0,
           "rounds_per_s_2_to_20": (ROUNDS - 1) / (t2 - t1),
           "rounds_per_s_warm_no_eval": ROUNDS / warm,
           "train_loss": loss, "test_acc": hist["test_acc"],
           "max_abs_param_diff_vs_cpu": diff,
           "tolerance": f"|d| <= {PARAMS_ATOL:g} after {2 * ROUNDS} rounds "
                        "(fp32 gradients summed in other orders on the "
                        "card and the CPU)",
           "peak_mem_mb": torch.cuda.max_memory_allocated() / 2 ** 20}
    emit(out)
    return {"experiment": gpu, "launches": launches,
            "params": params_at_rounds}


def device_rows(prof):
    """(device us, name, calls) of the kernels in a torch.profiler trace.
    Only the device's own events: an operator's row carries its kernels'
    time as well, so summing both would count each kernel twice."""
    from torch.autograd import DeviceType
    return sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)


def phase_profile(exp) -> None:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        exp.run(5, evaluate=False)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    total = sum(r[0] for r in rows)
    emit({"phase": "profile", "rounds": 5, "wall_us": wall_us,
          "device_busy_us": total,
          "device_idle_share": (1 - total / wall_us) if total else None,
          "top_kernels": [{"name": n[:80], "device_us": d, "calls": c}
                          for d, n, c in rows[:12]]})


def phase_host_profile(exp) -> None:
    """Where a warm round's host time goes: cProfile over 10 rounds, the
    functions with the most own time."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    exp.run(10, evaluate=False)
    torch.cuda.synchronize()
    prof.disable()
    st = pstats.Stats(prof)
    rows = sorted(((v[2], v[3], v[1], f"{pathlib.Path(k[0]).name}:{k[1]}:{k[2]}")
                   for k, v in st.stats.items()), reverse=True)
    emit({"phase": "host_profile", "rounds": 10,
          "total_s": st.total_tt,
          "top_own_time": [{"fn": name, "own_s": own, "cum_s": cum,
                            "calls": calls}
                           for own, cum, calls, name in rows[:15]]})


def emit_memory(after: str) -> None:
    """The device memory still allocated after a phase (its locals gone),
    and how much of it live tensors hold (the rest is the allocator's own:
    cuBLAS keeps a workspace for every stream that ran a product)."""
    import warnings
    gc.collect()
    torch.cuda.synchronize()
    live = {}
    with warnings.catch_warnings():
        # the scan touches deprecated module attributes, which warn
        warnings.simplefilter("ignore")
        for obj in gc.get_objects():
            if isinstance(obj, torch.Tensor) and obj.is_cuda:
                st = obj.untyped_storage()
                live[st.data_ptr()] = st.nbytes()
    emit({"phase": "memory", "after": after,
          "allocated_mb": torch.cuda.memory_allocated() / 2 ** 20,
          "live_tensors_mb": sum(live.values()) / 2 ** 20})


def _max_rel(got: dict, want: dict) -> float:
    """max over leaves of max|got - want| / max|want|."""
    return max(float((got[k].float().cpu() - want[k].float().cpu()).abs()
                     .max()) / max(float(want[k].abs().max()), 1e-30)
               for k in want)


def _stream_close(got: dict, want: dict) -> bool:
    return all(torch.allclose(got[k].float().cpu(), want[k].float().cpu(),
                              rtol=STREAM_RTOL, atol=STREAM_ATOL)
               for k in want)


def phase_stream_facade(dense_params: dict) -> None:
    """The streaming round through the facade: the Case-I spec with
    k_block = 4 against the dense run of phase main; then partial
    participation at a smaller depth."""
    import dataclasses
    from repro_torch.fl import Experiment
    spec = case_i_spec()
    streamed = Experiment(dataclasses.replace(spec, k_block=4),
                          device="cuda")
    t0 = time.perf_counter()
    streamed.run(ROUNDS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ok = _stream_close(streamed.params, dense_params)
    out = {"phase": "stream_facade", "k_block": 4, "rounds": ROUNDS,
           "rounds_per_s": ROUNDS / secs,
           "max_rel_param_diff_vs_dense": _max_rel(streamed.params,
                                                   dense_params),
           "tolerance": f"rtol {STREAM_RTOL:g}, atol {STREAM_ATOL:g} "
                        "(blocked K-way sums re-associate)",
           "within_tolerance": ok, "participation": {}}
    if not ok:
        emit(out)
        fail("the streamed Case-I run left the dense run's STREAM_TOL")
    depth = 5
    runs = {}
    for name, over in (
            ("bernoulli", dict(participation=0.5)),
            ("fixed", dict(participation=0.5, participation_mode="fixed")),
            ("fixed_active_gather", dict(participation=0.5,
                                         participation_mode="fixed",
                                         active_gather=True))):
        e = Experiment(dataclasses.replace(spec, **over), device="cuda")
        hist = e.run(depth)
        values = [v for key, vals in hist.items() if key != "round"
                  for v in vals]
        if not all(math.isfinite(v) for v in values):
            fail(f"participation {name}: non-finite history")
        runs[name] = e
        out["participation"][name] = {
            "rounds": depth, "num_participants": hist["num_participants"],
            "train_loss": hist["train_loss"]}
    gather, dense = runs["fixed_active_gather"], runs["fixed"]
    if gather.history["num_participants"] != dense.history["num_participants"]:
        fail("active_gather scheduled other devices than the dense round")
    # a device's gradient may round differently in an [m]- and a [K]-device
    # call on the card, so the gather is held to STREAM_TOL here
    out["active_gather_bitwise"] = all(
        torch.equal(gather.params[k], dense.params[k]) for k in dense.params)
    out["active_gather_max_rel_diff"] = _max_rel(gather.params, dense.params)
    if not _stream_close(gather.params, dense.params):
        emit(out)
        fail("active_gather left the dense masked round's STREAM_TOL")
    emit(out)


def _kscale_stack(gen: torch.Generator, k: int, n: int) -> dict:
    """Gradients that share a direction (so the aggregate is not pure
    noise), as a two-leaf tree of [K, n - 8] and [K, 8]."""
    base = torch.randn((n,), generator=gen, device="cuda")
    g = base + 2.0 * torch.randn((k, n), generator=gen, device="cuda")
    return {"w": g[:, :n - 8].contiguous(), "b": g[:, n - 8:].contiguous()}


def phase_stream_ota(ops) -> dict:
    """ota.aggregate with k_block on the kernels backend at the K-scale
    shape: K3 and K4 launch; each result against the dense aggregate on the
    card and the plain route on the CPU."""
    from repro_torch.core import ota
    gen = torch.Generator(device="cuda").manual_seed(99)
    g = _kscale_stack(gen, K_SCALE, N_SCALE)
    h = 1e-3 * (torch.rand((K_SCALE,), generator=gen, device="cuda") + 0.5)
    b = torch.full((K_SCALE,), 5.0 ** 0.5, device="cuda")
    a = float(1.0 / (h * b).sum())
    noise = 1e-7 ** 0.5 * torch.randn((N_SCALE,), generator=gen,
                                      device="cuda")
    schemes = ("normalized", "benchmark2", "onebit", "normalized_per_tensor")
    cfg = {s: ota.OTAConfig(scheme=s, a=a, noise_var=1e-7, backend="kernels",
                            k_block=KB_SCALE) for s in schemes}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    streamed = {s: ota.aggregate(cfg[s], g, h, b, noise=noise)
                for s in schemes}
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCH_COUNTS)
    for name in ("streaming_moments", "ota_superpose_streaming"):
        if launches[name] < len(schemes):
            fail(f"{name} launched {launches[name]} times in "
                 f"{len(schemes)} streamed aggregates")
    g_cpu = {k: v.cpu() for k, v in g.items()}
    rows = {}
    for s in schemes:
        dense = ota.aggregate(ota.OTAConfig(scheme=s, a=a, noise_var=1e-7,
                                            backend="kernels"),
                              g, h, b, noise=noise)
        plain = ota.aggregate(cfg[s], g_cpu, h.cpu(), b.cpu(),
                              noise=noise.cpu())
        row = {"max_rel_diff_vs_dense": _max_rel(streamed[s], dense),
               "max_rel_diff_vs_plain": _max_rel(streamed[s], plain)}
        if s == "onebit":
            # sign outputs: a coordinate may flip only where the dense
            # pre-sign aggregate lies within the fp32 reordering bound of 0
            n = N_SCALE
            flat = torch.cat([g["b"], g["w"]], dim=1)
            scale = (h * b) / math.sqrt(n)
            pre = ops.ota_superpose(flat, scale, noise, a, pre="sign",
                                    impl="plain")
            slack = 2 * (K_SCALE + 2) * EPS32 * a * (
                scale.abs().sum() + noise.abs())
            near0 = pre.abs() <= slack
            ys = torch.cat([streamed[s]["b"], streamed[s]["w"]])
            for other, key in ((dense, "flips_vs_dense"),
                               (plain, "flips_vs_plain")):
                yo = torch.cat([other["b"], other["w"]]).to(ys.device)
                bad = (ys != yo) & ~near0
                row[key] = int((ys != yo).sum())
                ok = not bool(bad.any())
                row["within_tolerance"] = row.get("within_tolerance",
                                                  True) and ok
            row["tolerance"] = ("equal, except where |dense pre-sign| <= "
                                "2 (K+2) eps32 a (sum|s_k| + |z_j|)")
        else:
            ok = _stream_close(streamed[s], dense) and _stream_close(
                streamed[s], plain)
            row["within_tolerance"] = ok
            row["tolerance"] = (f"rtol {STREAM_RTOL:g}, atol "
                                f"{STREAM_ATOL:g} vs dense and vs plain")
        rows[s] = row
    out = {"phase": "stream_ota", "k": K_SCALE, "n": N_SCALE,
           "k_block": KB_SCALE, "launches": launches, "schemes": rows}
    for s, row in rows.items():
        if not row["within_tolerance"]:
            emit(out)
            fail(f"streamed aggregate ({s}) disagrees: {row}")
    emit(out)
    return launches


def kscale_case(device: str, k: int = K_SCALE, kb: int = KB_SCALE):
    """The repo's 100,000-device case (benchmarks/kscale_case.py;
    tests/test_streaming.py::TestKScaleSmoke): a shared pool of 4,096
    examples x 2,048 features, B = 8 rows per device drawn by (round,
    device) index, a {"w": [2048]} linear model, the normalized scheme on
    the kernels backend, b = b_max and a = 1 / sum(h b) (Problem 3 at this
    K is O(K^2)).  The channel is the port's dense Rayleigh draw (the
    reference's geometry gains wait for ROADMAP queue 1 item 11).  Every
    input is drawn on the CPU from a seed, so the GPU and the CPU run see
    the same."""
    import numpy as np
    from repro_torch import rng
    from repro_torch.core.channel import ChannelConfig, draw_channel
    from repro_torch.fed import runtime
    d, bsz, pool = N_SCALE, 8, 4096
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((pool, d), generator=gen)
    w_true = torch.randn((d,), generator=gen)
    y = x @ w_true + 0.1 * torch.randn((pool,), generator=gen)
    x, y = x.to(device), y.to(device)
    ccfg = ChannelConfig(num_devices=k, channel_mean=1e-3, noise_var=1e-7)
    h = draw_channel(rng.generator(0), ccfg).double().numpy()
    b = np.full(k, ccfg.b_max)
    cfg = runtime.FLConfig(
        num_devices=k, case="I", p=0.75, channel=ccfg, scheme="normalized",
        backend="kernels", smoothness_L=5.0, expected_loss_drop=2.0,
        grad_bound=10.0, seed=0, k_block=kb)
    state = runtime.FLState({"w": torch.zeros((d,), device=device)}, h, b,
                            1.0 / float(np.sum(h * b)), eta0=1.0,
                            model_dim=d)

    def grad_fn(params, batch):
        xb, yb = batch
        r = xb @ params["w"] - yb
        return {"w": xb.T @ r / r.shape[0]}

    def block_batch_provider(t, dev):
        # B pool rows keyed by (round, device index), by integer hashing
        # that gives the same rows on any device and under any blocking
        j = torch.arange(bsz, device=dev.device)
        v = (t * k + dev[:, None]) * bsz + j[None, :]
        v = (v * 2654435761) % 2 ** 31
        v = ((v ^ (v >> 13)) * 1274126177) % 2 ** 31
        idx = v % pool
        return x[idx], y[idx]

    return cfg, state, grad_fn, block_batch_provider


def phase_stream(ops) -> dict:
    from repro_torch.fed import runtime
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2 ** 20
    cfg, state, grad_fn, provider = kscale_case("cuda")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, first = runtime.run(cfg, state, grad_fn, None, 1,
                               block_batch_provider=provider)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, rest = runtime.run(cfg, state, grad_fn, None, STREAM_ROUNDS - 1,
                              block_batch_provider=provider)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(ops.LAUNCH_COUNTS)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    blocks = K_SCALE // KB_SCALE
    hist = {k: first[k] + rest[k] for k in first}
    out = {"phase": "stream", "k": K_SCALE, "k_block": KB_SCALE,
           "n": N_SCALE, "batch": 8, "pool": 4096,
           "rounds": STREAM_ROUNDS, "launches": launches,
           "first_round_s": t1 - t0,
           "rounds_per_s_2_to_3": (STREAM_ROUNDS - 1) / (t2 - t1),
           "peak_mem_mb": peak_mb, "mem_before_mb": base_mb,
           "mem_limit_mb": STREAM_MEM_LIMIT_MB,
           "grad_norm_mean": hist["grad_norm_mean"],
           "update_norm": hist["update_norm"],
           "channel": "the port's dense Rayleigh draw (geometry gains: "
                      "ROADMAP queue 1 item 11)"}
    if launches["ota_superpose"] != blocks * STREAM_ROUNDS:
        emit(out)
        fail(f"ota_superpose launched {launches['ota_superpose']} times, "
             f"expected {blocks} a round")
    if not peak_mb < STREAM_MEM_LIMIT_MB:
        emit(out)
        fail(f"peak device memory {peak_mb:.1f} MiB >= "
             f"{STREAM_MEM_LIMIT_MB} MiB")
    values = [v for key, vals in hist.items() if key != "round"
              for v in vals]
    if not all(math.isfinite(v) for v in values):
        fail("K-scale round: non-finite history")
    cfg_c, state_c, grad_c, provider_c = kscale_case("cpu")
    t3 = time.perf_counter()
    state_c, _ = runtime.run(cfg_c, state_c, grad_c, None, STREAM_ROUNDS,
                             block_batch_provider=provider_c)
    out["cpu_s"] = time.perf_counter() - t3
    w_gpu, w_cpu = state.params["w"].cpu(), state_c.params["w"]
    diff = float((w_gpu - w_cpu).abs().max())
    scale = float(w_cpu.abs().max())
    out.update(max_abs_param_diff_vs_cpu=diff, max_abs_param=scale,
               tolerance=f"max|d| <= {KSCALE_REL:g} max|w| (K-way fp32 sums "
                         "over 100,000 terms in other orders on the card "
                         "and the CPU)")
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        runtime.run(cfg, state, grad_fn, None, 1,
                    block_batch_provider=provider)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t4) * 1e6
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    # the profiled round's wall time carries the profiler's own start-up,
    # so the idle share is also read against the unprofiled round time
    round_us = 1e6 / out["rounds_per_s_2_to_3"]
    out["profile_one_round"] = {
        "wall_us": wall_us, "device_busy_us": busy,
        "device_idle_share": (1 - busy / wall_us) if busy else None,
        "unprofiled_round_us": round_us,
        "device_idle_share_of_unprofiled_round": 1 - busy / round_us,
        "top_kernels": [{"name": n[:80], "device_us": d, "calls": c}
                        for d, n, c in rows[:14]]}
    emit(out)
    if not (scale > 0 and diff <= KSCALE_REL * scale):
        fail(f"K-scale params: GPU vs CPU max|d| = {diff} > "
             f"{KSCALE_REL} * {scale}")
    del state, cfg, grad_fn, provider
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# the model zoo's serving path: flash attention (K6) and h2o-danube-1.8b

SERVE_ARCH = "h2o-danube-1.8b"
SERVE_BATCH, SERVE_PROMPT, SERVE_DECODE = 4, 8192, 32
# (B, H, Hkv, Sq, Skv, d, causal, window) of the K6 rows: the serving layer
# as the serve phase's prefill gives it (B = 4) and at B = 1, Jamba's
# attention layer as the serve_hybrid phase's prefill gives it (B = 4) and
# at B = 1, a ragged S causal and not, a window smaller than a kv tile,
# head dims 8, 24 and 64 (the bf16 body pads d to a multiple of 16 by TMA's
# zero fill), and Sq != Skv: fewer queries than keys, and more, where no
# tile is skipped and the rows past Skv + W - 1 have every key masked
FLASH_SHAPES = ((4, 32, 8, 8192, 8192, 80, True, 4096),
                (1, 32, 8, 8192, 8192, 80, True, 4096),
                (4, 32, 8, 8192, 8192, 128, True, None),
                (1, 32, 8, 8192, 8192, 128, True, None),
                (2, 8, 8, 1000, 1000, 128, True, None),
                (2, 8, 8, 1000, 1000, 128, False, None),
                (1, 4, 2, 333, 333, 80, True, 16),
                (1, 4, 2, 500, 500, 8, True, None),
                (1, 4, 2, 500, 500, 24, True, 100),
                (1, 4, 2, 500, 500, 64, False, None),
                (1, 4, 2, 200, 700, 80, True, None),
                (1, 4, 2, 700, 200, 80, True, 64),
                (1, 4, 2, 700, 200, 128, False, 64))
# keys per kv tile: kBK in csrc/flash_attention_wgmma.cu (bf16), kBK in
# csrc/flash_attention.cu (fp32)
FLASH_TILE = {torch.bfloat16: 128, torch.float32: 64}
HIDDEN_REL = 1e-4                # fp32 kernel vs plain route, final hidden
HANDOFF_REL = 2e-3               # tests/test_models.py:96's bound
HEAVY_MS = 1.0                   # calls longer than this are timed eagerly


def flash_tol(want: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """K6 against its plain version computed in fp32 from the same inputs:
    fp32 |d| <= 1e-5 + 1e-5 |o| (tests/test_kernels.py:84); bf16
    |d| <= 2^-8 |o| + 1e-5, one bf16 rounding of the output."""
    if dtype == torch.bfloat16:
        return 2.0 ** -8 * want.abs() + 1e-5
    return 1e-5 + 1e-5 * want.abs()


def band_pairs(sq: int, skv: int, causal: bool, window) -> int:
    """(query, key) pairs inside the causal/window band of one head."""
    i = torch.arange(sq, dtype=torch.int64)
    hi = torch.minimum(i + 1, torch.tensor(skv)) if causal \
        else torch.full_like(i, skv)
    lo = (i - window + 1).clamp(min=0) if window else torch.zeros_like(i)
    return int((hi - lo).clamp(min=0).sum())


def flash_bound(b, h, hkv, sq, skv, d, causal, window, dtype,
                fp32_cores: bool = False):
    """Operations: 4 d flops a pair in the band at the dtype's peak; for
    fp32 the least time of the two ways the card does that work, three TF32
    products at 495 TFLOP/s (3xTF32) or one at the fp32 cores' 67 TFLOP/s
    (``fp32_cores`` the latter alone); bytes: q, k, v read once and o
    written once, at 3.35 TB/s."""
    item = torch.finfo(dtype).bits // 8
    nbytes = item * d * (2 * b * h * sq + 2 * b * hkv * skv)
    flops = 4.0 * d * b * h * band_pairs(sq, skv, causal, window)
    if dtype == torch.bfloat16:
        return bound(nbytes, flops, BF16_FLOPS_PER_S)
    if fp32_cores or flops / FP32_FLOPS_PER_S < 3 * flops / TF32_FLOPS_PER_S:
        return bound(nbytes, flops, FP32_FLOPS_PER_S)
    return bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)


def flash_ms(fn) -> float:
    """Device time per call: CUDA-graph replays (``device_ms``) for short
    calls; for calls over HEAVY_MS, the median of 5 samples of 2 eager calls
    timed with CUDA events (the host's enqueue is far shorter)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    if start.elapsed_time(end) < HEAVY_MS:
        return device_ms(fn)
    samples = []
    for _ in range(5):
        start.record()
        fn()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / 2)
    return statistics.median(samples)


def flash_ptxas(build, dtype, d) -> dict:
    """ptxas's report of the K6 body that runs ``dtype`` at head dim ``d``
    (each body has one instantiation per d padded to 16), with the launch's
    dynamic shared memory."""
    from repro_torch.kernels import flash_attention as FA
    report = build.ptxas_report(FA.BODIES[dtype][0])
    tag = f"ILi{(d + 15) // 16 * 16}E"
    (row,) = (r for k, r in report.items() if tag in k)
    return dict(row, dynamic_smem=FA.smem_bytes(dtype, d))


def check_flash(ops, build, shape, dtype, gen) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import BODIES
    b, h, hkv, sq, skv, d, causal, window = shape
    q = torch.randn((b, h, sq, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, hkv, skv, d), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    kw = dict(causal=causal, window=window)
    got = ops.flash_attention(q, k, v, impl="kernel", **kw)
    again = ops.flash_attention(q, k, v, impl="kernel", **kw)
    qf, kf, vf = q.float(), k.float(), v.float()
    want = ops.flash_attention(qf, kf, vf, impl="plain", **kw)
    torch.cuda.synchronize()
    tol = flash_tol(want, dtype)
    d_abs = (got.float() - want).abs()
    # the rule must reject the plain result without the last kv tile the
    # kernel visits (causal: the tile of key min(Sq, Skv) - 1; later keys
    # are masked for every row), and with the window one narrower (no
    # window: Sq - 1, which drops the pair (Sq - 1, 0))
    last = min(sq, skv) if causal else skv
    cut = (last - 1) // FLASH_TILE[dtype] * FLASH_TILE[dtype]
    dropped = ops.flash_attention(qf, kf[:, :, :cut], vf[:, :, :cut],
                                  impl="plain", **kw)
    off = ops.flash_attention(qf, kf, vf, causal=causal,
                              window=(window or sq) - 1, impl="plain")
    rejects_dropped = not bool(((dropped - want).abs() <= tol).all())
    rejects_window = not bool(((off - want).abs() <= tol).all())
    del dropped, off, qf, kf, vf
    # the yardstick: one PyTorch call, on kv expanded to H heads (its
    # is_causal keeps key j <= query i, as K6 does, at any Sq and Skv)
    ke = torch.repeat_interleave(k, h // hkv, dim=1)
    ve = torch.repeat_interleave(v, h // hkv, dim=1)
    if window:
        i = torch.arange(sq, device="cuda")[:, None]
        j = torch.arange(skv, device="cuda")[None, :]
        mask = (j <= i) if causal else torch.ones(
            (sq, skv), dtype=torch.bool, device="cuda")
        mask = mask & (i - j < window)

        def library():
            return F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask)
        call = "scaled_dot_product_attention(attn_mask=band)"
    else:
        def library():
            return F.scaled_dot_product_attention(q, ke, ve, is_causal=causal)
        call = f"scaled_dot_product_attention(is_causal={causal})"
    b_ms, b_by = flash_bound(b, h, hkv, sq, skv, d, causal, window, dtype)
    # the fp32 row keeps the fp32 cores' bound beside it, under its own name
    cores = ({} if dtype == torch.bfloat16 else {
        "bound_fp32_cores_ms": flash_bound(b, h, hkv, sq, skv, d, causal,
                                           window, dtype, fp32_cores=True)[0]})
    row = {"kernel": "flash_attention", "dtype": str(dtype)[6:],
           "body": BODIES[dtype][1], "b": b, "h": h, "hkv": hkv, "sq": sq,
           "skv": skv, "d": d, "causal": causal, "window": window,
           "max_abs_err": float(d_abs.max()),
           "max_err_over_tol": float((d_abs / tol).max()),
           "tolerance": ("|d| <= 2^-8 |o_plain| + 1e-5 (plain in fp32 from "
                         "the same bf16 inputs)" if dtype == torch.bfloat16
                         else "|d| <= 1e-5 + 1e-5 |o_plain|"),
           "within_tolerance": bool((d_abs <= tol).all()),
           "rejects_dropped_kv_tile": rejects_dropped,
           "rejects_window_off_by_one": rejects_window,
           "two_launches_bitwise": bool(torch.equal(got, again)),
           "ptxas": flash_ptxas(build, dtype, d),
           "kernel_ms": flash_ms(lambda: ops.flash_attention(
               q, k, v, impl="kernel", **kw)),
           "plain_ms": flash_ms(lambda: ops.flash_attention(
               q, k, v, impl="plain", **kw)),
           "library_ms": flash_ms(library), "library_call": call,
           "bound_ms": b_ms, "bound_by": b_by, **cores,
           "band_pairs": b * h * band_pairs(sq, skv, causal, window)}
    row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
    return row


def phase_flash(ops, build) -> dict:
    """K6 against its plain version at FLASH_SHAPES, both bodies (fp32 in
    3xTF32, bf16 through wgmma); returns the row of the shape
    and type the serve phase's prefill gives it."""
    gen = torch.Generator(device="cuda").manual_seed(4321)
    path_row = None
    for shape in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            row = check_flash(ops, build, shape, dtype, gen)
            row["phase"] = "flash"
            emit(row)
            where = f"{shape} {row['dtype']}"
            if not row["within_tolerance"]:
                fail(f"flash_attention disagrees with its plain version at "
                     f"{where}: max |d| = {row['max_abs_err']}")
            if not (row["rejects_dropped_kv_tile"]
                    and row["rejects_window_off_by_one"]):
                fail(f"flash_attention's tolerance at {where} would pass a "
                     "result without the last kv tile or with the window "
                     "off by one")
            if not row["two_launches_bitwise"]:
                fail(f"flash_attention at {where}: two launches differ")
            if row["ptxas"]["spill_stores"] or row["ptxas"]["spill_loads"]:
                fail(f"flash_attention's {row['body']} body spills: "
                     f"{row['ptxas']}")
            if shape == FLASH_SHAPES[0] and dtype == torch.bfloat16:
                path_row = row
    torch.cuda.empty_cache()
    return path_row


def _profile_top(fn, n: int = 10) -> dict:
    """Device time of ``fn`` by kernel (torch.profiler), with the wall time
    around it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    return {"wall_us": wall_us, "device_busy_us": busy,
            "top_kernels": [{"name": nm[:80], "device_us": us, "calls": c,
                             "share": us / busy}
                            for us, nm, c in rows[:n]]}


def phase_serve(ops) -> int:
    """h2o-danube-1.8b through the serving steps (bf16), then the fp32
    checks at B = 1; returns K6's launches in the counted serving run."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    cfg = get_config(SERVE_ARCH)
    b, s, n_dec = SERVE_BATCH, SERVE_PROMPT, SERVE_DECODE
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = T.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = T.param_count(params)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda")
    prefill = serve.build_prefill_cache_step(cfg, "cuda", cache_len=s + n_dec)
    decode = serve.build_decode_step(cfg, "cuda")
    # warm-up on a short prompt: cuBLAS handles and workspaces, first launches
    ids, cache = prefill(params, {"tokens": tokens[:, :256]})
    decode(params, cache, ids[:, None], 256)
    del ids, cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ids, cache = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = [ids]
    for pos in range(s, s + n_dec):
        ids, cache = decode(params, cache, ids[:, None], pos)
        out.append(ids)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = ops.LAUNCH_COUNTS["flash_attention"]
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    generated = torch.stack(out, dim=1).cpu()
    logits, _ = T.decode_step(params, cfg, cache, ids[:, None], s + n_dec)
    finite = bool(torch.isfinite(logits).all()) and all(
        bool(torch.isfinite(c[name]).all()) for c in cache for name in c)
    row = {"phase": "serve", "arch": SERVE_ARCH, "dtype": cfg.dtype,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
           "window": cfg.sliding_window, "params": n_params,
           "param_count_formula": cfg.param_count(),
           "batch": b, "prompt": s, "decode_steps": n_dec,
           "init_s": init_s, "prefill_s": t1 - t0,
           "prefill_tokens_per_s": b * s / (t1 - t0),
           "decode_s": t2 - t1, "decode_tokens_per_s": b * n_dec / (t2 - t1),
           "decode_ms_per_step": (t2 - t1) / n_dec * 1e3,
           "peak_mem_mb": peak_mb, "flash_attention_launches": launches,
           "generated_ids": generated.tolist(), "finite": finite}
    # where the time goes: one more prefill and 8 decode steps, profiled
    row["prefill_profile"] = _profile_top(
        lambda: prefill(params, {"tokens": tokens}))
    state = {"ids": ids, "cache": cache}

    def steps():
        for pos in range(s + n_dec, s + n_dec + 8):
            state["ids"], state["cache"] = decode(
                params, state["cache"], state["ids"][:, None], pos)
    row["decode_profile_8_steps"] = _profile_top(steps)
    emit(row)
    if launches != cfg.num_layers:
        fail(f"flash_attention launched {launches} times in one prefill, "
             f"expected {cfg.num_layers}")
    if not finite or generated.min() < 0 or generated.max() >= cfg.vocab_size:
        fail("the serving run gave non-finite values or ids out of range")
    del params, cache, state, logits, tokens, ids, out
    gc.collect()
    torch.cuda.empty_cache()

    # fp32 at B = 1: kernel route vs plain route, and the cache handoff
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(1)
    p32 = T.init_params(cfg32, gen, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (1, s + 1), generator=gen,
                         device="cuda")
    w_un = L.unembed_matrix(p32["emb"], cfg32)
    batch = {"tokens": toks[:, :s]}
    t0 = time.perf_counter()
    h_kernel = T.forward_hidden(p32, cfg32, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    h_plain = T.forward_hidden(p32, cfg32, batch, impl="plain")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    hid_rel = float((h_kernel - h_plain).abs().max()
                    / h_plain.abs().max())
    tok_kernel = int(torch.argmax(h_kernel[0, -1] @ w_un))
    tok_plain = int(torch.argmax(h_plain[0, -1] @ w_un))
    del h_kernel, h_plain
    full = T.forward_hidden(p32, cfg32, {"tokens": toks})    # 8,193 tokens
    logits_full = (full[:, -1] @ w_un).float()
    del full
    _, cache = T.prefill_with_cache(p32, cfg32, batch, s + n_dec)
    logits_dec, _ = T.decode_step(p32, cfg32, cache, toks[:, s:], s)
    scale = float(logits_full.abs().max())
    handoff = float((logits_dec - logits_full).abs().max())
    check = {"phase": "serve_fp32", "batch": 1, "prompt": s,
             "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
             "kernel_route_s": t1 - t0, "plain_route_s": t2 - t1,
             "hidden_max_rel_diff": hid_rel,
             "hidden_tolerance": f"max|d| <= {HIDDEN_REL:g} max|h_plain|",
             "greedy_kernel": tok_kernel, "greedy_plain": tok_plain,
             "handoff_max_abs_diff": handoff, "logits_max_abs": scale,
             "handoff_tolerance": f"max|d| <= {HANDOFF_REL:g} max|logits| "
                                  "(tests/test_models.py:96)"}
    emit(check)
    if not hid_rel <= HIDDEN_REL:
        fail(f"fp32 kernel route vs plain route: hidden differ by {hid_rel}")
    if tok_kernel != tok_plain:
        fail(f"greedy token: kernel route {tok_kernel}, plain {tok_plain}")
    if not (scale > 0 and handoff <= HANDOFF_REL * scale):
        fail(f"prefill -> decode at {s}: logits differ by {handoff} > "
             f"{HANDOFF_REL} * {scale}")
    del p32, cache
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------
# the Jamba hybrid's serving path: the selective scan (K7), Mamba and MoE

HYBRID_ARCH = "jamba-v0.1-52b"
HYBRID_LAYERS = 8                # one superblock of the 32 (the full 103 GB
                                 # in bf16 does not fit one 80 GB card)
HYBRID_FP32_PROMPT = 2048        # fp32 weights are 53.2 GB at one superblock
# (B, S, D, N, draw) of the K7 rows: the Jamba prefill's scan (B = 4) and
# at B = 1, a ragged S and D, and a ragged one with N below the kernel's
# 16, with the reference kernel test's draw ("test"); and the prefill's
# scan with Jamba's own a and dt ("jamba", see scan_inputs)
SCAN_SHAPES = ((4, 8192, 8192, 16, "test"), (1, 8192, 8192, 16, "test"),
               (2, 1000, 1000, 16, "test"), (1, 333, 77, 5, "test"),
               (4, 8192, 8192, 16, "jamba"))
SCAN_TILE = 64                   # a multiple of the staged tile's steps
                                 # (kT = 32 in the .cu)
# |kernel - plain| <= SCAN_RTOL * Y_abs, Y_abs the plain scan of |u|, dt,
# a, |B|, |C| (an upper bound of sum_n |h_t,n C_t,n|): the two round
# differently (expf vs torch.exp, fused multiply-adds, the N-way sum's
# order), a few eps a step over the memory 1 / (dt |a|) of the slowest
# state: ~1e2 steps for the "test" draw, ~1e3 for the "jamba" draw
SCAN_RTOL = 1e-4
# the SFU's exponentials: 16 a clock per SM, 132 SMs, 1.98 GHz (H100 SXM)
EXP_PER_S = 16 * 132 * 1.98e9
HYBRID_HIDDEN_REL = 1e-4         # fp32 kernel vs plain route, final hidden


def scan_inputs(shape, dtype, gen):
    """u, B, C normal in ``dtype``.  Draw "test", the reference kernel
    test's (tests/test_kernels.py): dt = softplus(normal), a = -exp(normal).
    Draw "jamba", as models/mamba.py's init_mamba sets the operands up:
    a = -(1..N) in every channel, and each channel's dt log-uniform in
    [1e-3, 0.1] (dt_proj_b's range) and held over all steps, so the
    slowest state (dt 1e-3, a -1) remembers ~1e3 steps."""
    b, s, d, n, draw = shape

    def normal(*sh):
        return torch.randn(sh, generator=gen, device="cuda")
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


def scan_bound(shape, dtype):
    """Bytes: u, dt, a, B, C read once, y and h_S written once; operations:
    one exponential a (b, t, d, n) at the SFU rate, and ~6 fp32 flops a
    state (dt a, dt u B, the multiply-add of h, the product and sum with C)
    at 67 TFLOP/s; the largest of the three."""
    b, s, d, n = shape[:4]
    item = torch.finfo(dtype).bits // 8
    nbytes = (item * b * s * d + 4 * b * s * d + 4 * d * n
              + 2 * item * b * s * n + 4 * b * s * d + 4 * b * d * n)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(b * s * d * n / EXP_PER_S,
                6.0 * b * s * d * n / FP32_FLOPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_scan(ops, shape, dtype, gen) -> dict:
    b, s, d, n, draw = shape
    args = scan_inputs(shape, dtype, gen)
    u, dt, a, bm, cm = args
    y, h = ops.selective_scan(*args, return_state=True, impl="kernel")
    yp, hp = ops.selective_scan(*args, return_state=True, impl="plain")
    y_abs, h_abs = ops.selective_scan(u.abs(), dt, a, bm.abs(), cm.abs(),
                                      return_state=True, impl="plain")
    again = ops.selective_scan(*args, impl="kernel")
    torch.cuda.synchronize()
    tol = SCAN_RTOL * y_abs
    d_y, d_h = (y - yp).abs(), (h - hp).abs()
    # the rule must reject the plain result with one time step dropped
    # (dt = 0 there: no update) and with the state reset at a tile boundary
    dt_drop = dt.clone()
    dt_drop[:, s // 2] = 0.0
    dropped = ops.selective_scan(u, dt_drop, a, bm, cm, impl="plain")
    rejects_dropped = not bool(((dropped - yp).abs() <= tol).all())
    del dropped, dt_drop
    cut = max(1, s // 2 // SCAN_TILE) * SCAN_TILE
    reset = torch.cat([ops.selective_scan(
        *(x[:, sl].contiguous() for x in (u, dt)), a,
        *(x[:, sl].contiguous() for x in (bm, cm)), impl="plain")
        for sl in (slice(0, cut), slice(cut, None))], dim=1)
    rejects_reset = not bool(((reset - yp).abs() <= tol).all())
    del reset
    b_ms, b_by = scan_bound(shape, dtype)
    row = {"kernel": "selective_scan", "dtype": str(dtype)[6:],
           "b": b, "s": s, "d": d, "n": n, "draw": draw,
           "max_abs_err": float(d_y.max()),
           "max_err_over_tol": float((d_y / tol).max()),
           "state_max_abs_err": float(d_h.max()),
           "state_max_err_over_tol": float((d_h / (SCAN_RTOL * h_abs))
                                           .max()),
           "tolerance": (f"|d| <= {SCAN_RTOL:g} * Y_abs (y) and H_abs (h_S):"
                         " the plain scan of |u|, dt, a, |B|, |C| and its "
                         "final state"),
           "within_tolerance": bool((d_y <= tol).all()
                                    and (d_h <= SCAN_RTOL * h_abs).all()),
           "deterministic": bool(torch.equal(again, y)),
           "rejects_dropped_step": rejects_dropped,
           "rejects_state_reset_at_tile": rejects_reset,
           "kernel_ms": flash_ms(lambda: ops.selective_scan(
               *args, return_state=True, impl="kernel")),
           "plain_ms": flash_ms(lambda: ops.selective_scan(
               *args, return_state=True, impl="plain")),
           "library_ms": None,
           "library_call": "none: no single PyTorch call computes the "
                           "selective scan",
           "bound_ms": b_ms, "bound_by": b_by,
           "exponentials": b * s * d * n}
    row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
    return row


def phase_scan(ops) -> dict:
    """K7 against its plain version at SCAN_SHAPES, fp32 and bf16 u, B, C;
    returns the row of the shape and type the hybrid prefill gives it."""
    gen = torch.Generator(device="cuda").manual_seed(777)
    path_row = None
    for shape in SCAN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            row = check_scan(ops, shape, dtype, gen)
            row["phase"] = "scan"
            emit(row)
            where = f"{shape} {row['dtype']}"
            if not (row["within_tolerance"] and row["deterministic"]):
                fail(f"selective_scan disagrees with its plain version (or "
                     f"with itself) at {where}: max |d| = "
                     f"{row['max_abs_err']}")
            if not (row["rejects_dropped_step"]
                    and row["rejects_state_reset_at_tile"]):
                fail(f"selective_scan's tolerance at {where} would pass a "
                     "result that drops a time step or resets the state")
            if shape == SCAN_SHAPES[0] and dtype == torch.bfloat16:
                path_row = row
    gc.collect()
    torch.cuda.empty_cache()
    return path_row


class RouterLog:
    """Records each MoE layer's router probabilities [T, E] while active:
    it stands in for ``moe.router_probs`` (which ``moe_mlp`` looks up at
    call time) and restores it on exit.  The caller checks that it saw
    every MoE layer, so a ``moe_mlp`` that stops looking the name up fails
    the run instead of reading as no flips."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.probs = moe, []

    def __enter__(self):
        orig = self.orig = self.moe.router_probs

        def record(params, x_flat):
            probs, logits = orig(params, x_flat)
            self.probs.append(probs.detach().clone())
            return probs, logits
        self.moe.router_probs = record
        return self

    def __exit__(self, *exc):
        self.moe.router_probs = self.orig


def route_flips(probs_a, probs_b, k: int) -> tuple:
    """Per MoE layer: the tokens whose ordered top-k experts differ between
    two runs, and what could explain a flip: the smallest gap between
    consecutive probabilities among the top k + 1 (run b), and the largest
    change of a probability between the runs.  Also the first token that
    flipped in any layer (the token count if none did): every layer is
    causal, so the tokens before it took the same experts everywhere."""
    rows, first = [], int(probs_a[0].shape[0])
    for pa, pb in zip(probs_a, probs_b):
        ea = torch.topk(pa, k, dim=-1).indices
        vb, eb = torch.topk(pb, k + 1, dim=-1)
        flipped = (ea != eb[:, :k]).any(dim=-1)
        gaps = (vb[:, :-1] - vb[:, 1:]).min(dim=-1).values
        change = (pa - pb).abs().max(dim=-1).values
        if bool(flipped.any()):
            first = min(first, int(flipped.nonzero()[0, 0]))
        rows.append({"tokens": int(pa.shape[0]),
                     "flips": int(flipped.sum()),
                     "min_router_gap": float(gaps.min()),
                     "max_router_prob_change": float(change.max()),
                     # a flip is explained where the gap is within twice
                     # the change measured at that token
                     "unexplained_flips": int((flipped
                                               & (gaps > 2 * change)).sum())})
    return rows, first


def phase_serve_hybrid(ops) -> dict:
    """Jamba at full width, one superblock, through the serving steps
    (bf16), then the fp32 checks at B = 1; returns the launch counts of
    one counted prefill."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    full = get_config(HYBRID_ARCH)
    cfg = dataclasses.replace(full, num_layers=HYBRID_LAYERS)
    b, s, n_dec = SERVE_BATCH, SERVE_PROMPT, SERVE_DECODE
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = T.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = T.param_count(params)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda")
    # no sliding window: the cache holds every position decoded, the 32
    # counted steps, the logits check and the 8 profiled steps
    prefill = serve.build_prefill_cache_step(cfg, "cuda",
                                             cache_len=s + n_dec + 8)
    decode = serve.build_decode_step(cfg, "cuda")
    ids, cache = prefill(params, {"tokens": tokens[:, :256]})   # warm-up
    decode(params, cache, ids[:, None], 256)
    del ids, cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ids, cache = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = dict(ops.LAUNCH_COUNTS)
    prefill_peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    out = [ids]
    for pos in range(s, s + n_dec):
        ids, cache = decode(params, cache, ids[:, None], pos)
        out.append(ids)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    generated = torch.stack(out, dim=1).cpu()
    logits, _ = T.decode_step(params, cfg, cache, ids[:, None], s + n_dec)
    finite = bool(torch.isfinite(logits).all()) and all(
        bool(torch.isfinite(c[name]).all()) for c in cache for name in c)
    n_mamba = sum(k.startswith("mamba") for k in cfg.block_pattern)
    n_attn = sum(k.startswith("attn") for k in cfg.block_pattern)
    row = {"phase": "serve_hybrid", "arch": HYBRID_ARCH, "dtype": cfg.dtype,
           "layers": cfg.num_layers, "pattern": list(cfg.block_pattern),
           "cut": {"num_layers": f"{full.num_layers} -> {cfg.num_layers} "
                                 "(one superblock; widths as published)"},
           "d_model": cfg.d_model, "heads": cfg.num_heads,
           "kv_heads": cfg.num_kv_heads, "d_ff": cfg.d_ff,
           "experts": cfg.num_experts, "top_k": cfg.experts_per_token,
           "moe_d_ff": cfg.moe_d_ff, "d_inner": cfg.mamba_d_inner,
           "d_state": cfg.mamba_d_state, "dt_rank": cfg.mamba_dt_rank,
           "vocab": cfg.vocab_size, "params": n_params,
           "param_count_formula": cfg.param_count(),
           "moe_capacity_prefill": MOE.capacity(b * s, cfg),
           "batch": b, "prompt": s, "decode_steps": n_dec,
           "init_s": init_s, "prefill_s": t1 - t0,
           "prefill_tokens_per_s": b * s / (t1 - t0),
           "decode_s": t2 - t1, "decode_tokens_per_s": b * n_dec / (t2 - t1),
           "decode_ms_per_step": (t2 - t1) / n_dec * 1e3,
           "prefill_peak_mem_mb": prefill_peak_mb, "peak_mem_mb": peak_mb,
           "launches": launches,
           "generated_ids": generated.tolist(), "finite": finite}
    row["prefill_profile"] = _profile_top(
        lambda: prefill(params, {"tokens": tokens}), n=14)
    state = {"ids": ids, "cache": cache}

    def steps():
        for pos in range(s + n_dec, s + n_dec + 8):
            state["ids"], state["cache"] = decode(
                params, state["cache"], state["ids"][:, None], pos)
    row["decode_profile_8_steps"] = _profile_top(steps)
    emit(row)
    if (launches["selective_scan"] != n_mamba
            or launches["flash_attention"] != n_attn):
        fail(f"one hybrid prefill launched selective_scan "
             f"{launches['selective_scan']} times and flash_attention "
             f"{launches['flash_attention']}, expected {n_mamba} and "
             f"{n_attn}")
    if not finite or generated.min() < 0 or generated.max() >= cfg.vocab_size:
        fail("the hybrid serving run gave non-finite values or ids out of "
             "range")
    del params, cache, state, logits, tokens, ids, out
    gc.collect()
    torch.cuda.empty_cache()

    # fp32 at B = 1: kernel route vs plain route, and the cache handoff
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s32 = HYBRID_FP32_PROMPT
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(1)
    p32 = T.init_params(cfg32, gen, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (1, s32 + 1), generator=gen,
                         device="cuda")
    w_un = L.unembed_matrix(p32["emb"], cfg32)
    batch = {"tokens": toks[:, :s32]}
    t0 = time.perf_counter()
    with RouterLog() as log_kernel:
        h_kernel = T.forward_hidden(p32, cfg32, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with RouterLog() as log_plain:
        h_plain = T.forward_hidden(p32, cfg32, batch, impl="plain")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n_moe = sum(k.endswith("+moe") for k in cfg.block_pattern)
    logged = [len(log.probs) for log in (log_kernel, log_plain)]
    if logged != [n_moe, n_moe] or any(
            p.shape[0] != s32 for p in log_kernel.probs + log_plain.probs):
        fail(f"the router log saw {logged} MoE layers, expected {n_moe} "
             f"of {s32} tokens each")
    flips, clean = route_flips(log_kernel.probs, log_plain.probs,
                               cfg.experts_per_token)
    # an explained flip sends one token to other experts, and through the
    # causal mixers every later token differs too: the routes are compared
    # on the tokens before the first flip, the whole prompt when none flips
    if clean == 0:
        fail(f"top-{cfg.experts_per_token} routing differs at the first "
             f"token: no tokens left to compare the routes on: {flips}")
    hk, hp = h_kernel[:, :clean], h_plain[:, :clean]
    hid_rel = float((hk - hp).abs().max() / hp.abs().max())
    tok_kernel = int(torch.argmax(hk[0, -1] @ w_un))
    tok_plain = int(torch.argmax(hp[0, -1] @ w_un))
    del h_kernel, h_plain, hk, hp, log_kernel, log_plain
    # the handoff at capacity_factor 8 (as tests/test_models.py:78-81): a
    # prefill over T tokens drops pairs that a 1-token decode never drops
    cfg_h = dataclasses.replace(cfg32, capacity_factor=8.0)
    full_h = T.forward_hidden(p32, cfg_h, {"tokens": toks})    # s32 + 1
    logits_full = (full_h[:, -1] @ w_un).float()
    del full_h
    _, cache = T.prefill_with_cache(p32, cfg_h, batch, s32 + n_dec)
    logits_dec, _ = T.decode_step(p32, cfg_h, cache, toks[:, s32:], s32)
    scale = float(logits_full.abs().max())
    handoff = float((logits_dec - logits_full).abs().max())
    check = {"phase": "serve_hybrid_fp32", "batch": 1, "prompt": s32,
             "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
             "kernel_route_s": t1 - t0, "plain_route_s": t2 - t1,
             "tokens_compared": clean,
             "hidden_max_rel_diff": hid_rel,
             "hidden_tolerance": f"max|d| <= {HYBRID_HIDDEN_REL:g} "
                                 "max|h_plain|, over the tokens before the "
                                 "first routing flip",
             "greedy_kernel": tok_kernel, "greedy_plain": tok_plain,
             "route_flips_per_moe_layer": flips,
             "handoff_capacity_factor": 8.0,
             "handoff_max_abs_diff": handoff, "logits_max_abs": scale,
             "handoff_tolerance": f"max|d| <= {HANDOFF_REL:g} max|logits| "
                                  "(tests/test_models.py:96)"}
    emit(check)
    if any(f["unexplained_flips"] for f in flips):
        fail(f"top-{cfg.experts_per_token} routing differs between the "
             f"routes beyond the measured router gaps: {flips}")
    if not hid_rel <= HYBRID_HIDDEN_REL:
        fail(f"fp32 kernel route vs plain route: hidden differ by {hid_rel}")
    if tok_kernel != tok_plain:
        fail(f"greedy token: kernel route {tok_kernel}, plain {tok_plain}")
    if not (scale > 0 and handoff <= HANDOFF_REL * scale):
        fail(f"prefill -> decode at {s32}: logits differ by {handoff} > "
             f"{HANDOFF_REL} * {scale}")
    del p32, cache
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_rates(src: str) -> None:
    """Warm rounds/s of the Case-I round and of the K-scale round (the
    latter only where the package has the streaming round), RATE_SAMPLES
    samples each."""
    from repro_torch.fed import runtime
    from repro_torch.fl import Experiment
    exp = Experiment(case_i_spec(), device="cuda")
    exp.run(ROUNDS, evaluate=False)      # builds the kernels, warms up
    case_i = []
    for _ in range(RATE_SAMPLES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exp.run(ROUNDS, evaluate=False)
        torch.cuda.synchronize()
        case_i.append(ROUNDS / (time.perf_counter() - t0))
    del exp
    try:
        cfg, state, grad_fn, provider = kscale_case("cuda")
    except (TypeError, NotImplementedError):
        kscale = None                    # a tree without the streaming round
    else:
        state, _ = runtime.run(cfg, state, grad_fn, None, 1,
                               block_batch_provider=provider)
        kscale = []
        for _ in range(RATE_SAMPLES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = runtime.run(cfg, state, grad_fn, None, 1,
                                   block_batch_provider=provider)
            torch.cuda.synchronize()
            kscale.append(1.0 / (time.perf_counter() - t0))
        kscale_busy = _profile_top(lambda: runtime.run(
            cfg, state, grad_fn, None, 1, block_batch_provider=provider))
    emit({"phase": "rates", "src": src,
          "case_i_warm_rounds_per_s": case_i,
          "case_i_median": statistics.median(case_i),
          "kscale_rounds_per_s": kscale,
          "kscale_median": None if kscale is None
          else statistics.median(kscale),
          "kscale_profiled_round": None if kscale is None else kscale_busy})


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser(
        description="Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.")
    ap.add_argument("--rates", action="store_true",
                    help="time only the warm Case-I and K-scale rounds")
    ap.add_argument("--src", default=str(pathlib.Path(__file__).resolve()
                                         .parent / "src"),
                    help="directory that holds repro_torch (default: this "
                         "tree's src/)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    # the port is imported before anything is printed: a copy of this script
    # without the repo beside it fails here, with no output
    sys.path.insert(0, args.src)
    from repro_torch.kernels import build, ops
    info = phase_device()
    if args.rates:
        phase_rates(args.src)
        return
    phase_build(build)
    # the 100,000-device round first, on a clean card, so that its peak
    # device memory is its own
    phase_stream(ops)
    emit_memory("stream")
    checks = phase_kernels(ops)
    emit_memory("kernel")
    main_run = phase_main(ops)
    emit_memory("main")
    phase_profile(main_run["experiment"])
    phase_host_profile(main_run["experiment"])
    dense_params = main_run.pop("params")
    main_launches = main_run.pop("launches")
    del main_run
    emit_memory("host_profile")
    phase_stream_facade(dense_params)
    emit_memory("stream_facade")
    stream_launches = phase_stream_ota(ops)
    emit_memory("stream_ota")
    checks["flash_attention"] = phase_flash(ops, build)
    emit_memory("flash")
    serve_launches = {"flash_attention": phase_serve(ops)}
    emit_memory("serve")
    checks["selective_scan"] = phase_scan(ops)
    emit_memory("scan")
    hybrid_launches = phase_serve_hybrid(ops)
    emit_memory("serve_hybrid")
    csrc = "src/repro_torch/kernels/csrc/"
    # kernel -> (source, TPU kernel it replaces, launches on its path)
    sources = {
        "batched_moments": (csrc + "moments.cu",
                            "src/repro/kernels/grad_norm.py:81",
                            main_launches),
        "ota_superpose": (csrc + "ota_superpose.cu",
                          "src/repro/kernels/ota_aggregate.py:61",
                          main_launches),
        "streaming_moments": (csrc + "stream_moments.cu",
                              "src/repro/kernels/grad_norm.py:134",
                              stream_launches),
        "ota_superpose_streaming": (csrc + "ota_superpose.cu",
                                    "src/repro/kernels/ota_aggregate.py:125",
                                    stream_launches),
        "sumsq": (csrc + "sumsq.cu", "src/repro/kernels/grad_norm.py:50",
                  main_launches),
        "flash_attention": (csrc + "flash_attention_wgmma.cu",
                            "src/repro/kernels/flash_attention.py:86",
                            serve_launches),
        "selective_scan": (csrc + "selective_scan.cu",
                           "src/repro/kernels/selective_scan.py:76",
                           hybrid_launches),
    }
    kernels = []
    for name, (src, replaces, launches) in sources.items():
        row = checks[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": launches[name],
                        "max_abs_err": row["max_abs_err"],
                        "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
        if "body" in row:            # K6: the bf16 body runs on the path
            kernels[-1]["body"] = row["body"]
    print(info["nvidia_smi"], flush=True)
    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s in all",
          file=sys.stderr, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})


if __name__ == "__main__":
    main()
