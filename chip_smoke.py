#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero and prints no result:

1. device  -- the card, and ``nvidia-smi``'s name and power limit;
2. build   -- compiles every Hopper kernel from ``src/repro_torch/kernels/
              csrc`` with nvcc (one process per source, started together);
3. kernel  -- each kernel against its plain PyTorch version on the card, with
              the tolerance stated in the line: the dense moments (K1) and
              superposition (K2) at the FL round's shape (K = 20,
              N = 55,050), a wide-K shape (K = 1000) and a ragged one (K = 7,
              N = 1,000,003), and K2 at the streaming round's tile
              [1000, 2048]; the streamed moments (K3) and superposition (K4)
              at those three shapes (k_block 4, 100, 1) and the K-scale shape
              (K = 100,000, N = 2,048, k_block 1,000); the single-vector
              norm (K5) at the round's N and on each stack flattened.  Device
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
              peak device memory under 512 MiB, params against the CPU.

Then the ``{"kernels": [...]}`` line, and last the ``{"ok": true, ...}`` line.

    python3 chip_smoke.py --rates [--src OTHER_TREE/src]

times only the warm Case-I round (20 rounds, no eval) and the K-scale round
(one round), RATE_SAMPLES samples each, for the package under ``--src``
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
    before capture runs on one side stream, made once: every stream that
    runs a product keeps a cuBLAS workspace of its own."""
    if not _SIDE_STREAM:
        _SIDE_STREAM.append(torch.cuda.Stream())
    side = _SIDE_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(LAUNCHES):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _median_ms(graph.replay)


def timings(kernel, plain, library=None) -> dict:
    return {"kernel_ms": device_ms(kernel), "plain_ms": device_ms(plain),
            "library_ms": None if library is None else device_ms(library),
            "kernel_call_ms": call_ms(kernel), "plain_call_ms": call_ms(plain)}


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
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
    t0 = time.perf_counter()
    took = build.build_all()
    ptxas = {name: [ln.strip() for ln in build.log_path(name).read_text()
                    .splitlines() if "registers" in ln or "spill" in ln]
             for name in build.SOURCES}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": took, "ptxas": ptxas})


def check_moments(ops, g: torch.Tensor, k_block=None) -> dict:
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
    return {"kernel": ("batched_moments" if k_block is None
                       else "streaming_moments"),
            "k": k, "n": n, "k_block": k_block,
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
    if k_block is not None:
        # the tolerance must reject a result that lacks one K-block: that
        # result is off by block b's term a p_b (about sqrt(k_block) per
        # column on these stacks, against about 1e-5 K)
        lo = min(1, k // k_block - 1) * k_block
        part = a * (scale[lo:lo + k_block].double()
                    @ x[lo:lo + k_block].double())
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
                 "result that lacks a K-block")


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
                        for d, n, c in rows[:8]]}
    emit(out)
    if not (scale > 0 and diff <= KSCALE_REL * scale):
        fail(f"K-scale params: GPU vs CPU max|d| = {diff} > "
             f"{KSCALE_REL} * {scale}")
    del state, cfg, grad_fn, provider
    torch.cuda.empty_cache()
    return out


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
    emit({"phase": "rates", "src": src,
          "case_i_warm_rounds_per_s": case_i,
          "case_i_median": statistics.median(case_i),
          "kscale_rounds_per_s": kscale,
          "kscale_median": None if kscale is None
          else statistics.median(kscale)})


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
        "ota_superpose_streaming": (csrc + "ota_superpose_stream.cu",
                                    "src/repro/kernels/ota_aggregate.py:125",
                                    stream_launches),
        "sumsq": (csrc + "sumsq.cu", "src/repro/kernels/grad_norm.py:50",
                  main_launches),
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
    print(info["nvidia_smi"], flush=True)
    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s in all",
          file=sys.stderr, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})


if __name__ == "__main__":
    main()
