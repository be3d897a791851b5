#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero and prints no result:

1. device  -- the card, and ``nvidia-smi``'s name and power limit;
2. build   -- compiles every Hopper kernel from ``src/repro_torch/kernels/
              csrc`` with nvcc (one process per source, started together);
3. kernel  -- each kernel against its plain PyTorch version on the card at
              the FL round's shape (K = 20, N = 55,050), a wide-K shape
              (K = 1000) and a ragged one (K = 7, N = 1,000,003), with the
              tolerance stated in the line; device times (CUDA events over
              CUDA-graph replays, median of 50 samples of 20 launches)
              beside the bytes bound and a PyTorch library call timed as a
              yardstick only, and the eager per-call times (host included);
4. main    -- 20 rounds of the paper's Case-I experiment (synthetic MNIST,
              784-64-64-10 MLP, K = 20, normalized scheme, kernels backend)
              through ``Experiment(spec, device="cuda").run``; the kernels'
              launch counts, finite history, falling train loss, and the
              final params against the same spec run on the CPU;
5. profile -- device time by kernel over 5 rounds (torch.profiler), and
              host time by function over 10 rounds (cProfile).

Then the ``{"kernels": [...]}`` line, and last the ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

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
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
EPS32 = 2.0 ** -23
SAMPLES, LAUNCHES = 50, 20
MOMENTS_RTOL = 1e-5              # |kernel - plain| / sum|terms|
PARAMS_ATOL = 1e-5               # final params, GPU run vs CPU run


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


def device_ms(fn) -> float:
    """Device time per call of ``fn``: LAUNCHES calls captured in one CUDA
    graph and replayed, so no host cost is in the interval."""
    side = torch.cuda.Stream()
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


def check_moments(ops, g: torch.Tensor) -> dict:
    k, n = g.shape
    sq, s = ops.batched_moments(g, impl="kernel")
    sq_p, s_p = ops.batched_moments(g, impl="plain")
    torch.cuda.synchronize()
    # the two fp32 summations associate differently; tolerance relative to
    # the sum of absolute terms (fp64), 1e-5 -- each blocked sum's depth is
    # a few hundred levels at most at these shapes
    abs_sq = (g.double() ** 2).sum(1)
    abs_s = g.double().abs().sum(1)
    err = max(float((sq - sq_p).abs().max()), float((s - s_p).abs().max()))
    ok = bool(((sq - sq_p).abs().double() <= MOMENTS_RTOL * abs_sq).all()
              and ((s - s_p).abs().double() <= MOMENTS_RTOL * abs_s).all())
    b_ms, b_by = bound(k * n * 4 + 2 * k * 4, 3.0 * k * n)
    return {"kernel": "batched_moments", "k": k, "n": n,
            "max_abs_err": err,
            "tolerance": f"|d| <= {MOMENTS_RTOL:g} * sum|terms| per device",
            "within_tolerance": ok,
            **timings(lambda: ops.batched_moments(g, impl="kernel"),
                      lambda: ops.batched_moments(g, impl="plain"),
                      lambda: torch.linalg.vector_norm(g, dim=1)),
            "library_call": "torch.linalg.vector_norm(g, dim=1)",
            "bound_ms": b_ms, "bound_by": b_by}


def check_superpose(ops, g: torch.Tensor, pre: str,
                    gen: torch.Generator) -> dict:
    k, n = g.shape
    scale = torch.rand((k,), generator=gen, device="cuda") + 0.5
    noise = 0.01 * torch.randn((n,), generator=gen, device="cuda")
    a = 0.9
    y = ops.ota_superpose(g, scale, noise, a, pre=pre, impl="kernel")
    yp = ops.ota_superpose(g, scale, noise, a, pre=pre, impl="plain")
    torch.cuda.synchronize()
    x = torch.sign(g) if pre == "sign" else g
    # rigorous fp32 bound: two K-term sums plus the noise add and the gain
    ref_abs = a * (scale.double().abs() @ x.double().abs()
                   + noise.double().abs())
    tol = 2 * (k + 2) * EPS32 * ref_abs
    d = (y - yp).abs().double()
    b_ms, b_by = bound(k * n * 4 + 2 * n * 4 + k * 4, 2.0 * k * n)
    # one PyTorch call computes the identity sum: the yardstick
    library = (lambda: scale @ g) if pre == "identity" else None
    return {"kernel": "ota_superpose", "pre": pre, "k": k, "n": n,
            "max_abs_err": float(d.max()),
            "tolerance": "|d_j| <= 2 (K+2) eps32 a (sum_k |s_k x_kj| + |z_j|)",
            "within_tolerance": bool((d <= tol).all()),
            **timings(lambda: ops.ota_superpose(g, scale, noise, a, pre=pre,
                                                impl="kernel"),
                      lambda: ops.ota_superpose(g, scale, noise, a, pre=pre,
                                                impl="plain"),
                      library),
            "library_call": "scale @ g" if library else None,
            "bound_ms": b_ms, "bound_by": b_by}


def phase_kernels(ops) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1234)
    main = {}
    for k, n in SHAPES:
        g = test_stack(k, n, gen)
        rows = [check_moments(ops, g)]
        rows += [check_superpose(ops, g, pre, gen)
                 for pre in ("identity", "sign")]
        for row in rows:
            row["phase"] = "kernel"
            row["l2_resident"] = k * n * 4 < 50e6
            emit(row)
            if not row["within_tolerance"]:
                fail(f"{row['kernel']} disagrees with its plain version at "
                     f"K={k} N={n}: max |d| = {row['max_abs_err']}")
        if (k, n) == (K_MAIN, N_MAIN):
            main = {"batched_moments": rows[0], "ota_superpose": rows[1]}
        del g
    return main


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
    hist = {k: first[k] + rest[k] for k in first}
    for name, count in launches.items():
        if count < ROUNDS:
            fail(f"{name} launched {count} times in {ROUNDS} rounds")
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
    return {"experiment": gpu, "launches": launches}


def phase_profile(exp) -> None:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        exp.run(5, evaluate=False)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0.0))
        if dev > 0:
            rows.append((dev, ev.key, ev.count))
    rows.sort(reverse=True)
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


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    # the port is imported before anything is printed: a copy of this script
    # without the repo beside it fails here, with no output
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build, ops
    info = phase_device()
    phase_build(build)
    checks = phase_kernels(ops)
    main_run = phase_main(ops)
    phase_profile(main_run["experiment"])
    phase_host_profile(main_run["experiment"])
    sources = {"batched_moments": ("src/repro_torch/kernels/csrc/moments.cu",
                                   "src/repro/kernels/grad_norm.py:81"),
               "ota_superpose": ("src/repro_torch/kernels/csrc/ota_superpose.cu",
                                 "src/repro/kernels/ota_aggregate.py:61")}
    kernels = []
    for name, (src, replaces) in sources.items():
        row = checks[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": main_run["launches"][name],
                        "max_abs_err": row["max_abs_err"],
                        "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    print(info["nvidia_smi"], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})


if __name__ == "__main__":
    main()
