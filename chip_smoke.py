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
              norm (K5, K1's kernel over one row, one launch with its
              root) at the Case-I round's N = 55,050, the K-scale
              round's N = 2,048 and on each stack flattened.  First
              one launch's floor: ``torch.cuda._sleep(0)`` timed as the
              kernels are (phase ``launch_floor``).  Each
              K2 row shows its split S of the K-way sum and, where S > 1,
              that its tolerance rejects a result that lacks one K-chunk;
              each K4 row its chunks of whole K-blocks (S = 1: one pass)
              and that its tolerance rejects a result that lacks one
              K-block; each K1 and K3 row its chunks a row, each K5
              row its chunks.  Device
              times (CUDA events over CUDA-graph replays, median of 50
              samples of 20 launches) beside the bytes bound and a PyTorch
              library call timed as a yardstick only, and the eager per-call
              times (host included);
4. main    -- 20 rounds of the paper's Case-I experiment (synthetic MNIST,
              784-64-64-10 MLP, K = 20, normalized scheme, kernels backend)
              through ``Experiment(spec, device="cuda").run`` on the
              default driver (``scan``: a CUDA graph of the round, replayed
              a chunk of rounds per host transfer); the launch counts of
              K1, K2 and K5 (replays counted), finite history, falling
              train loss, and the final params against the same spec run
              on the CPU.  Phases 5, 6 and 8 run the default driver too;
5. profile -- device time by kernel over 5 rounds (torch.profiler), and
              host time by function over 10 rounds (cProfile);
6. stream_facade -- the Case-I spec with k_block = 4 through
              ``Experiment.run``, 20 rounds, against the dense run of phase 4
              (STREAM_TOL); then participation 0.5 (bernoulli, fixed, fixed
              with active_gather) for 5 rounds each;
6b. driver -- the two drivers against each other: the Case-I spec for 20
              rounds (chunks of 16, eval every 10), params and every
              DIAG_KEYS history bitwise (else the reference's rule,
              tests/test_engine.py:157-162); run(5); run(5) against
              run(10) under scan; participation 0.5 (bernoulli, and fixed
              with active_gather) for 10 rounds; 3 K-scale rounds, peak
              device memory under 512 MiB; the engines' capture counts
              (a second run adds none); and for both drivers and both
              rounds the warm rounds/s, device busy time a round and the
              device's idle share (torch.profiler);
6c. local_steps -- the Case-I spec with H = 4 local SGD steps a round
              (local_lr 0.05, benchmarks/figures.py:331): scan == python
              bitwise over 20 rounds on the dense round and on a
              k_block = 4 round, the card against a CPU run at phase 4's
              tolerance, K1, K2 and K5 launched every round, warm rounds/s,
              device busy a round and idle share;
6d. sweep  -- two of the paper's sweeps through ``run_sweep`` at full
              width: the fig1a grid (Case I, amplification {optimal, bmax}
              x 3 seeds: 2 structural groups of 3 lanes) and the sweep
              headline (Case-II ridge, noise_var {s2, 2 s2} x 4 seeds: 1
              group of 8 lanes); batched == sequential bitwise (every
              DIAG_KEYS history, each point's params digest), K1, K2 and K5
              launched every round, one capture a group and none on a warm
              repeat, warm aggregate lane-rounds/s batched against
              sequential, the device's idle share of profiled batched
              rounds, and the allocator's growth;
6e. channel -- the radio environment at Case II's width (ridge, K = 20,
              N = 30, kernels backend) in benchmarks/figures.py::
              channel_rounds_per_sec's four variants (fixed, i.i.d. block
              fading, AR(1) rho 0.9, AR(1) + CSI error 0.2): scan == python
              bitwise over 20 rounds, the card against a CPU run, K1, K2
              and K5 once a round, warm rounds/s, the host's staging a
              round and its Problem-3 re-solve share (cProfile), the
              device's idle share; the overhead ratio iid_fading / ar1_csi
              beside the reference's 2x budget (reported, not failed); then
              a reduced csi_robustness grid (scheme {normalized,
              benchmark1} x csi_error {0, 0.1, 0.3, 0.6} x 2 seeds, block
              fading: 2 groups of 8 lanes) through ``run_sweep``, batched
              == sequential bitwise, one capture a group, none on a warm
              repeat;
6f. clients -- the client algorithms (benchmarks/figures.py::
              client_algorithms: H = 4, local_lr 0.05, noise_var 1e-10) on
              Case I at full width: sgd, fedprox (mu 0.1), feddyn (alpha
              0.1) and scaffold, 20 rounds each: scan == python bitwise on
              the dense and a k_block = 4 round (params, history, client
              state), K1 and K2 once a slot and K5 once a round (two slots
              for feddyn and scaffold), the card against a CPU run round
              by round (params and client state), warm rounds/s, device
              busy a round and idle share; then the figure's grid through
              ``run_sweep`` (algorithm x Dirichlet alpha {0.1, 100} x
              participation {1.0, 0.5} x 3 seeds: 48 lanes in 16
              structural groups): batched == sequential bitwise over 20
              rounds, one capture a group and none on a warm repeat,
              lane-rounds/s both ways, the device's idle share; 200
              batched rounds for the feddyn/sgd and scaffold/sgd energy
              ratios (failed outside [1.95, 2.05], figures.py:528-534) and
              the final train-loss bands on the alpha = 0.1 split, whose
              separation from sgd is reported, not failed;
6g. obs    -- checkpoints and the flight recorder on Case I at full width,
              40 rounds in chunks of 16, eval every 10: (a) recorder off
              against the memory, jsonl and csv sinks, the same params
              (and client state) digest and DIAG_KEYS histories, under both
              drivers, on k_block = 4, on feddyn at H = 4 and on the fig1a
              grid through ``run_sweep``; the chunk events cover each round
              once and ``dump_history`` writes the live jsonl file's lines;
              (b) warm rounds/s with the jsonl sink off and on, A B B A,
              beside the reference's 1.05x budget (reported, not failed);
              (c) ``run(20); save; load; run(20)`` against ``run(40)``,
              bitwise, for sgd, adamw at participation 0.7, feddyn at
              H = 4 and Case-II ridge under AR(1) rho 0.8, CSI error 0.2 and
              geometry, each checkpoint loaded on the CPU against the card's
              leaves, save and load ms and file bytes; (d) a fresh run with
              REPRO_OBS_PROFILE set (its graph captured inside the trace)
              against the unprofiled run, bitwise, the trace naming K1, K2
              and K5 and holding one obs_chunk range per chunk; (e)
              ``serve_metrics`` on 127.0.0.1, port 0: round 40 and the
              event count;
6h. mesh   -- the sharded streaming round (``device_mesh``) emulated on
              the one card (no process group: the shards in turn, then
              the fixed fold of their carries): Case I at k_block = 2
              (10 K-blocks) with device_mesh None, 1 and 5, 20 rounds with
              eval and 20 warm ones on each driver: device_mesh 1 bitwise
              None, scan bitwise python, 5 within STREAM_TOL of None and
              against a CPU run at phase main's tolerance, K2 once a
              K-block and K5 once a round, warm rounds/s, peak memory,
              device busy and idle share; the K-scale round with
              device_mesh None and 4 (25 K-blocks a shard), 3 rounds each,
              K2 launches, peak memory, A B B A rates, 4 against None and
              against a CPU run; ``aggregate(kernels, k_block=1000,
              device_mesh=4)`` at the K-scale shape for normalized and
              benchmark2 (K2 100 times) against the streamed aggregate
              and the CPU, and the wall time of a call of each (median of
              5, host clock to a synchronize);
7. stream_ota -- ``ota.aggregate(OTAConfig(backend="kernels",
              k_block=1000))`` at the K-scale shape for four schemes, against
              the dense aggregate on the card and the plain route on the
              CPU; K3 and K4 must launch;
8. stream  -- the repo's 100,000-device case (benchmarks/kscale_case.py):
              3 streaming rounds of a {"w": [2048]} linear model over a
              shared pool, batches made per K-block through
              ``block_batch_provider``, the channel from geometry gains and
              Rayleigh amplitudes drawn one K-block at a time; rounds/s, K2 launches (100 a round,
              the graph's warm-up rounds included), peak device memory
              under 512 MiB, params against the CPU;
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
(one round), RATE_SAMPLES samples each on each driver (``null`` for the
scan driver of a tree that lacks it), then the device time of one more
K-scale round by kernel (torch.profiler), for the package under ``--src``
(default: this tree's), and prints one ``{"phase": "rates", ...}`` line:
run it on two trees in one machine session to compare them.

    python3 chip_smoke.py --driver

runs only phases 1, 2 and 6b (the two drivers against each other, their
rates and idle shares), and

    python3 chip_smoke.py --sweep

only phases 1, 2, 6c and 6d, and

    python3 chip_smoke.py --channel

only phases 1, 2 and 6e, and

    python3 chip_smoke.py --clients

only phases 1, 2 and 6f, and

    python3 chip_smoke.py --obs

only phases 1, 2 and 6g, and

    python3 chip_smoke.py --mesh

only phases 1, 2 and 6h.
"""
from __future__ import annotations

import gc
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
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
    # the gain as the FL round passes it: a 0-d fp32 tensor on the card
    # (a float would add a fill launch to each timed call)
    a = torch.tensor(0.9, dtype=torch.float32, device="cuda")
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
    b_ms, b_by = bound(k * n * 4 + 2 * n * 4 + k * 4 + 4, 2.0 * k * n)
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
    from repro_torch.kernels.grad_norm import sumsq_cuda, sumsq_split
    n = x.shape[0]
    got = ops.grad_norm(x, impl="kernel")
    want = ops.grad_norm(x, impl="plain")
    # the kernel's sum of squares (the same launch as the norm's) against
    # the plain one: two fp32 sums of n positive terms, relative 1e-5
    sq = sumsq_cuda(x)
    sq_plain = torch.sum(torch.square(x))
    torch.cuda.synchronize()
    total = float((x.double() ** 2).sum())
    d = abs(float(sq.double() - sq_plain.double()))
    d_norm = abs(float(got.double() ** 2 - want.double() ** 2))
    b_ms, b_by = bound(n * 4 + 4, 2.0 * n)
    # the host's chunks for this N (not a measurement)
    return {"kernel": "sumsq", "n": n, "chunks": sumsq_split(n),
            "max_abs_err": d, "norm_sq_abs_err": d_norm,
            "root_is_sqrt": bool(torch.equal(torch.sqrt(sq), got)),
            "tolerance": f"|d(sum x^2)| <= {TERMS_RTOL:g} * sum x^2, for "
                         "the sums and the norms squared",
            "within_tolerance": (d <= TERMS_RTOL * total
                                 and d_norm <= TERMS_RTOL * total),
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
        if row.get("root_is_sqrt") is False:
            fail(f"{row['kernel']}'s norm at {where} is not the root of its "
                 "sum of squares")
        if row.get("rejects_dropped_block") is False:
            fail(f"{row['kernel']}'s tolerance at {where} would pass a "
                 "result that lacks a K-block or K-chunk")


def phase_launch_floor() -> None:
    """What any launch costs in the harness that times the kernels: an
    empty ``torch.cuda._sleep(0)`` timed as ``timings`` times a kernel."""
    def sleep0():
        torch.cuda._sleep(0)
    emit({"phase": "launch_floor", "call": "torch.cuda._sleep(0)",
          "ms": device_ms(sleep0), "call_ms": call_ms(sleep0)})


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
        if (k, n) in ((K_MAIN, N_MAIN), (KB_SCALE, N_SCALE)):
            # the update norm at the Case-I and the K-scale round's N
            rows.append(check_sumsq(ops, g[0].contiguous()))
            rows[-1]["l2_resident"] = True
        _emit_checked(rows, f"K={k} N={n}")
        if (k, n) == (K_MAIN, N_MAIN):
            path_rows["batched_moments"] = rows[0]
            path_rows["ota_superpose"] = rows[1]
            path_rows["sumsq"] = rows[3]
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
    # the peak of this phase alone (phase kernel's test stacks are gone)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
    K is O(K^2)).  The channel is the reference's: geometry gains
    (``GeometryConfig(shadowing_std_db=4.0)``) and Rayleigh amplitudes on
    the device-indexed block schedule, drawn one K-block at a time
    (benchmarks/kscale_case.py:96-104).  Every input is drawn on the CPU
    from a seed, so the GPU and the CPU run see the same."""
    import numpy as np
    from repro_torch.channels import GeometryConfig
    from repro_torch.channels.geometry import relative_gains_block
    from repro_torch.core.channel import ChannelConfig, draw_channel_block
    from repro_torch.fed import runtime
    d, bsz, pool = N_SCALE, 8, 4096
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((pool, d), generator=gen)
    w_true = torch.randn((d,), generator=gen)
    y = x @ w_true + 0.1 * torch.randn((pool,), generator=gen)
    x, y = x.to(device), y.to(device)
    ccfg = ChannelConfig(num_devices=k, channel_mean=1e-3, noise_var=1e-7)
    geo = GeometryConfig(shadowing_std_db=4.0)
    blocks = []
    for lo in range(0, k, kb):
        devs = torch.arange(lo, min(lo + kb, k))
        scale = (ccfg.rayleigh_scale()
                 * relative_gains_block(7, geo, devs)).float()
        blocks.append(draw_channel_block(7, ccfg, devs, scale))
    h = torch.cat(blocks).double().numpy()
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
    # the scan driver's warm-up rounds before its capture launch too
    launched_rounds = STREAM_ROUNDS + runtime.GRAPH_WARMUP_ROUNDS
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
           "channel": "geometry gains (shadowing 4 dB) and Rayleigh "
                      "amplitudes, block draws of 1,000 devices"}
    if launches["ota_superpose"] != blocks * launched_rounds:
        emit(out)
        fail(f"ota_superpose launched {launches['ota_superpose']} times, "
             f"expected {blocks} a round over {launched_rounds} rounds")
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
PREFILL_SAMPLES = 3              # timed prefills a serving phase, median kept
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


def timed_prefills(ops, prefill, params, tokens):
    """PREFILL_SAMPLES timed prefills at the full shape, after a caller's
    warm-up at that shape; returns the last prefill's (ids, cache), the
    seconds of each and the launch counts of one."""
    seconds = []
    for _ in range(PREFILL_SAMPLES):
        ids = cache = None               # the last prefill's cache freed
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        ids, cache = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches = dict(ops.LAUNCH_COUNTS)
    return ids, cache, seconds, launches


def prefill_rates(b: int, s: int, seconds: list) -> dict:
    med = statistics.median(seconds)
    return {"prefill_s": med, "prefill_s_samples": seconds,
            "prefill_tokens_per_s": b * s / med,
            "prefill_tokens_per_s_samples": [b * s / x for x in seconds]}


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
    # warm-up at the full shape: cuBLAS handles and workspaces, the first
    # launches at the timed shape and the allocator's growth
    ids, cache = prefill(params, {"tokens": tokens})
    decode(params, cache, ids[:, None], s)
    del ids, cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ids, cache, prefill_s, counted = timed_prefills(ops, prefill, params,
                                                    tokens)
    t1 = time.perf_counter()
    out = [ids]
    for pos in range(s, s + n_dec):
        ids, cache = decode(params, cache, ids[:, None], pos)
        out.append(ids)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = counted["flash_attention"]
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
           "init_s": init_s, **prefill_rates(b, s, prefill_s),
           "decode_s": t2 - t1, "decode_tokens_per_s": b * n_dec / (t2 - t1),
           "decode_ms_per_step": (t2 - t1) / n_dec * 1e3,
           "peak_mem_mb": peak_mb, "flash_attention_launches": launches,
           "generated_ids": generated.tolist(), "finite": finite}
    # where the time goes: one more prefill and 8 decode steps, profiled
    row["prefill_profile"] = _profile_top(
        lambda: prefill(params, {"tokens": tokens}))
    row["prefill_device_busy_ms"] = (row["prefill_profile"]["device_busy_us"]
                                     / 1e3)
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
    # warm-up at the full shape (as phase serve)
    ids, cache = prefill(params, {"tokens": tokens})
    decode(params, cache, ids[:, None], s)
    del ids, cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ids, cache, prefill_s, launches = timed_prefills(ops, prefill, params,
                                                     tokens)
    t1 = time.perf_counter()
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
           "init_s": init_s, **prefill_rates(b, s, prefill_s),
           "decode_s": t2 - t1, "decode_tokens_per_s": b * n_dec / (t2 - t1),
           "decode_ms_per_step": (t2 - t1) / n_dec * 1e3,
           "prefill_peak_mem_mb": prefill_peak_mb, "peak_mem_mb": peak_mb,
           "launches": launches,
           "generated_ids": generated.tolist(), "finite": finite}
    row["prefill_profile"] = _profile_top(
        lambda: prefill(params, {"tokens": tokens}), n=14)
    row["prefill_device_busy_ms"] = (row["prefill_profile"]["device_busy_us"]
                                     / 1e3)
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


# the reference's rule for its two drivers where they are not bitwise
# (tests/test_engine.py:157-162)
DRIVER_PARAMS_RTOL, DRIVER_PARAMS_ATOL = 2e-6, 1e-7
DRIVER_HIST_RTOL, DRIVER_HIST_ATOL = 2e-6, 1e-9
DRIVER_RATE_SAMPLES = 3


def compare_runs(a_params: dict, a_hist: dict, b_params: dict,
                 b_hist: dict) -> dict:
    """Two runs' params and every DIAG_KEYS history: bitwise, and else the
    reference's rule for its drivers."""
    from repro_torch.fed import runtime
    bitwise = (all(torch.equal(a_params[k], b_params[k]) for k in b_params)
               and all(a_hist[k] == b_hist[k] for k in runtime.DIAG_KEYS))
    within = all(torch.allclose(a_params[k], b_params[k],
                                rtol=DRIVER_PARAMS_RTOL,
                                atol=DRIVER_PARAMS_ATOL) for k in b_params)
    for k in runtime.DIAG_KEYS:
        want = torch.tensor(b_hist[k], dtype=torch.float64)
        got = torch.tensor(a_hist[k], dtype=torch.float64)
        within = within and bool(torch.allclose(
            got, want, rtol=DRIVER_HIST_RTOL, atol=DRIVER_HIST_ATOL))
    diff = max(float((a_params[k].float() - b_params[k].float()).abs().max())
               for k in b_params)
    hist_keys = [k for k in runtime.DIAG_KEYS if a_hist[k] != b_hist[k]]
    return {"bitwise": bitwise, "within_rule": within,
            "max_abs_param_diff": diff, "history_keys_that_differ": hist_keys}


def _profiled_round(run, rounds: int) -> dict:
    """Device busy time a round and the device's idle share over ``rounds``
    rounds of ``run(rounds)`` (torch.profiler)."""
    prof = _profile_top(lambda: run(rounds), n=6)
    busy = prof["device_busy_us"]
    return {"profiled_rounds": rounds,
            "device_busy_us_per_round": busy / rounds,
            "profiled_wall_us_per_round": prof["wall_us"] / rounds,
            "device_idle_share": (1 - busy / prof["wall_us"]) if busy
            else None,
            "top_kernels": prof["top_kernels"]}


def driver_rates(run, rounds: int, profiled: int) -> dict:
    """Warm rounds/s of ``run(rounds)`` (DRIVER_RATE_SAMPLES samples, after
    one call that builds and warms up), then one profiled call."""
    run(rounds)
    samples = []
    for _ in range(DRIVER_RATE_SAMPLES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(rounds)
        torch.cuda.synchronize()
        samples.append(rounds / (time.perf_counter() - t0))
    out = {"rounds_per_call": rounds, "rounds_per_s": samples,
           "median_rounds_per_s": statistics.median(samples)}
    out.update(_profiled_round(run, profiled))
    out["device_idle_share_of_unprofiled_round"] = (
        1 - out["device_busy_us_per_round"] * 1e-6
        * out["median_rounds_per_s"])
    return out


def phase_driver(ops) -> None:
    """The scan driver against the python driver on both rounds; their
    rates, device busy time and idle share."""
    import dataclasses
    from repro_torch.fed import runtime
    from repro_torch.fl import Experiment
    spec = dataclasses.replace(case_i_spec(), chunk_size=16)
    out = {"phase": "driver", "chunk_size": spec.chunk_size,
           "eval_every": spec.eval.every}
    runtime.clear_compile_caches()
    runtime.cache_info()

    def pair(over: dict, rounds: int) -> dict:
        runs = {}
        for driver in ("scan", "python"):
            e = Experiment(dataclasses.replace(spec, driver=driver, **over),
                           device="cuda")
            e.run(rounds)
            runs[driver] = e
        row = compare_runs(runs["scan"].params, runs["scan"].history,
                           runs["python"].params, runs["python"].history)
        row["rounds"] = rounds
        row["num_participants"] = runs["scan"].history["num_participants"]
        return row

    out["case_i"] = pair({}, ROUNDS)
    out["bernoulli"] = pair(dict(participation=0.5), 10)
    out["fixed_active_gather"] = pair(dict(participation=0.5,
                                           participation_mode="fixed",
                                           active_gather=True), 10)
    a = Experiment(spec, device="cuda")
    a.run(5)
    a.run(5)
    b = Experiment(spec, device="cuda")
    b.run(10)
    out["run5_run5_vs_run10"] = compare_runs(a.params, a.history, b.params,
                                             b.history)
    out["captures_after_case_i"] = runtime.cache_info()
    a.run(10)
    out["captures_of_a_second_run"] = runtime.cache_info()["traces_delta"]
    del a, b

    # the K-scale round on both drivers, on a card holding nothing else
    runtime.clear_compile_caches()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2 ** 20
    kscale = {}
    for driver in ("scan", "python"):
        cfg, state, grad_fn, provider = kscale_case("cuda")
        state, hist = runtime.run(cfg, state, grad_fn, None, STREAM_ROUNDS,
                                  driver=driver,
                                  block_batch_provider=provider)
        kscale[driver] = (state.params, hist)
        if driver == "scan":
            out["kscale_peak_mem_mb"] = (torch.cuda.max_memory_allocated()
                                         / 2 ** 20)
    out["kscale_mem_before_mb"] = base_mb
    out["kscale"] = compare_runs(*kscale["scan"], *kscale["python"])
    out["kscale"]["rounds"] = STREAM_ROUNDS

    # rates: warm rounds/s, device busy time and idle share
    rates = {}
    for driver in ("scan", "python"):
        e = Experiment(dataclasses.replace(spec, driver=driver),
                       device="cuda")
        e.run(1)
        rates[f"case_i_{driver}"] = driver_rates(
            lambda n, e=e: e.run(n, evaluate=False), ROUNDS, 5)
        del e
    for driver in ("scan", "python"):
        cfg, state, grad_fn, provider = kscale_case("cuda")

        def run_k(n, cfg=cfg, state=state, grad_fn=grad_fn,
                  provider=provider, driver=driver):
            runtime.run(cfg, state, grad_fn, None, n, driver=driver,
                        block_batch_provider=provider)
        rates[f"kscale_{driver}"] = driver_rates(run_k, 1, 1)
        del state
    out["rates"] = rates
    out["captures"] = runtime.cache_info()["traces"]
    # what the engines hold, and what clear_compile_caches() gives back
    out["allocated_mb_with_engines"] = torch.cuda.memory_allocated() / 2 ** 20
    runtime.clear_compile_caches()
    out["allocated_mb_after_clear"] = torch.cuda.memory_allocated() / 2 ** 20
    emit(out)
    failed = [name for name in ("case_i", "bernoulli", "fixed_active_gather",
                                "kscale")
              if not out[name]["within_rule"]]
    if failed:
        fail(f"scan and python drivers leave the reference's rule on "
             f"{failed}")
    if not out["run5_run5_vs_run10"]["bitwise"]:
        fail("run(5); run(5) differs from run(10) under scan")
    if any(out["captures_of_a_second_run"].values()):
        fail("a second identical run captured again: "
             f"{out['captures_of_a_second_run']}")
    if not out["kscale_peak_mem_mb"] < STREAM_MEM_LIMIT_MB:
        fail(f"K-scale round under scan: peak device memory "
             f"{out['kscale_peak_mem_mb']:.1f} MiB >= {STREAM_MEM_LIMIT_MB}")


LOCAL_STEPS, LOCAL_LR = 4, 0.05  # benchmarks/figures.py:331 (scenarios)
SWEEP_RATE_ROUNDS = 64           # rounds a timed sweep call (chunks of 16)
PATH_KERNELS = ("batched_moments", "ota_superpose", "sumsq")


def check_path_launches(launches: dict, rounds: int, where: str,
                        lanes: int | None = None, slots=1) -> None:
    """The round's kernels (K1, K2, K5) launched at least once a round;
    given ``lanes``, exactly once a lane a round of a batched run, its
    graph's eager warm-up rounds included, with K1 and K2 once an OTA slot
    (``slots`` a lane, or one entry a lane)."""
    from repro_torch.fed import runtime
    per_lane = rounds + runtime.GRAPH_WARMUP_ROUNDS
    lane_slots = (sum(slots) if not isinstance(slots, int)
                  else slots * (lanes or 0))
    for name in PATH_KERNELS:
        if lanes is None:
            bad = launches[name] < rounds
        else:
            bad = launches[name] != per_lane * (
                lanes if name == "sumsq" else lane_slots)
        if bad:
            fail(f"{where}: {name} launched {launches[name]} times in "
                 f"{rounds} rounds"
                 + ("" if lanes is None else f" of {lanes} lanes"))


def phase_local_steps(ops) -> None:
    """Case I at full width with H = 4 local SGD steps (local_lr 0.05):
    scan == python bitwise over 20 rounds on the dense round and on a
    k_block = 4 round, the card against a CPU run at phase main's
    tolerance, warm rounds/s, device busy a round and idle share."""
    import dataclasses
    from repro_torch.fl import Experiment
    spec = dataclasses.replace(case_i_spec(), local_steps=LOCAL_STEPS,
                               local_lr=LOCAL_LR)
    out = {"phase": "local_steps", "local_steps": LOCAL_STEPS,
           "local_lr": LOCAL_LR, "rounds": ROUNDS}
    scan = None
    for name, over in (("dense", {}), ("k_block_4", {"k_block": 4})):
        runs = {}
        for driver in ("scan", "python"):
            e = Experiment(dataclasses.replace(spec, driver=driver, **over),
                           device="cuda").setup()
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            e.run(ROUNDS)
            torch.cuda.synchronize()
            launches = dict(ops.LAUNCH_COUNTS)
            runs[driver] = e
            if name == "dense" and driver == "scan":
                out["launches"] = launches
                check_path_launches(launches, ROUNDS, "local_steps")
        out[name] = compare_runs(runs["scan"].params, runs["scan"].history,
                                 runs["python"].params,
                                 runs["python"].history)
        if name == "dense":
            scan = runs["scan"]
    cpu = Experiment(spec, device="cpu")
    cpu.run(ROUNDS)
    diff = max(float((scan.params[k].cpu() - cpu.params[k]).abs().max())
               for k in cpu.params)
    loss = scan.history["train_loss"]
    out.update(max_abs_param_diff_vs_cpu=diff,
               tolerance=f"|d| <= {PARAMS_ATOL:g} (phase main's)",
               train_loss=loss, test_acc=scan.history["test_acc"])
    out["rates"] = driver_rates(
        lambda n: scan.run(n, evaluate=False), ROUNDS, 5)
    emit(out)
    for name in ("dense", "k_block_4"):
        if not out[name]["bitwise"]:
            fail(f"local steps: scan and python differ on the {name} round "
                 f"({out[name]})")
    if not diff <= PARAMS_ATOL:
        fail(f"local steps: GPU and CPU params differ by {diff}")
    if not all(math.isfinite(v) for v in loss) or not loss[-1] < loss[0]:
        fail(f"local steps: train_loss did not fall: {loss}")


def case_ii_spec():
    """The paper's Case-II experiment (benchmarks/common.py::
    CaseIIExperiment): ridge regression, K = 20, N = 30 (the weights; the
    model has no bias), eta 0.01, s_target 0.995, G from a noiseless mean-aggregation
    calibration run (30 rounds, max device norm x 1.2), on the kernels
    backend."""
    import dataclasses
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.fl import (DataSpec, EvalSpec, Experiment,
                                ExperimentSpec, FLConfig, ModelSpec,
                                build_task)
    data = DataSpec(dataset="ridge", split="iid", batch_size=50,
                    num_train=2000, dim=30, seed=10)
    model = ModelSpec(kind="ridge", lam=0.1)
    c = build_task(data, model, K_MAIN, "cuda").constants
    fl = FLConfig(num_devices=K_MAIN, case="II", eta=0.01,
                  channel=ChannelConfig(num_devices=K_MAIN,
                                        channel_mean=1e-3),
                  smoothness_L=c["smoothness_L"],
                  strong_convexity_M=c["strong_convexity_M"],
                  s_target=0.995, seed=0, backend="kernels")
    spec = ExperimentSpec(fl=fl, data=data, model=model,
                          eval=EvalSpec(every=10))
    cal = Experiment(dataclasses.replace(
        spec, fl=dataclasses.replace(fl, scheme="mean", grad_bound=1.0)),
        device="cuda")
    g = 1.2 * max(cal.run(30, evaluate=False)["grad_norm_max"])
    return dataclasses.replace(spec, fl=dataclasses.replace(fl,
                                                            grad_bound=g))


def _batched_round_profile(sweep, rounds: int) -> dict:
    """Device busy time and idle share of ``rounds`` warm batched rounds of
    every group of ``sweep`` (states set up outside the profile)."""
    from repro_torch.fed import runtime
    from repro_torch.fl import build_task
    from repro_torch.fl.sweep import _structural_signature
    groups = {}
    for pt in sweep.points():
        groups.setdefault(_structural_signature(pt.spec), []).append(pt.spec)
    calls = []
    for specs in groups.values():
        cfgs = [s.fl_config() for s in specs]
        task = build_task(specs[0].data, specs[0].model, cfgs[0].num_devices,
                          "cuda")
        states = [runtime.setup(c, task.params0, task.model_dim)
                  for c in cfgs]
        calls.append((cfgs, states, task))

    def run():
        for cfgs, states, task in calls:
            runtime.run_batched(cfgs, states, task.grad_fn,
                                task.batch_provider, rounds,
                                chunk_batch_provider=
                                task.chunk_batch_provider)
    run()                                # warm: every state past round 0
    lane_rounds = sweep.size * rounds
    prof = _profile_top(run, n=6)
    busy = prof["device_busy_us"]
    return {"profiled_rounds": rounds,
            "device_busy_us_per_lane_round": busy / lane_rounds,
            "wall_us_per_lane_round": prof["wall_us"] / lane_rounds,
            "device_idle_share": (1 - busy / prof["wall_us"]) if busy
            else None,
            "top_kernels": prof["top_kernels"]}


def _host_profile(run, n: int = 10) -> dict:
    """Where the calling thread's time goes in ``run()``: cProfile, the
    functions with the most own time."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    run()
    torch.cuda.synchronize()
    prof.disable()
    st = pstats.Stats(prof)
    rows = sorted(((v[2], v[3], v[1],
                    f"{pathlib.Path(k[0]).name}:{k[1]}:{k[2]}")
                   for k, v in st.stats.items()), reverse=True)
    return {"total_s": st.total_tt,
            "top_own_time": [{"fn": name, "own_s": own, "cum_s": cum,
                              "calls": calls}
                             for own, cum, calls, name in rows[:n]]}


def _sweep_rate(run, lane_rounds: int) -> dict:
    samples = []
    for _ in range(DRIVER_RATE_SAMPLES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        samples.append(lane_rounds / (time.perf_counter() - t0))
    return {"lane_rounds_per_s": samples,
            "median_lane_rounds_per_s": statistics.median(samples)}


def sweep_grid(ops, name: str, sweep, profile: bool = True,
               lane_slots=1) -> dict:
    """One grid through ``run_sweep`` at ROUNDS rounds: batched ==
    sequential bitwise (every DIAG_KEYS history and each point's params
    digest), K1, K2 and K5 once a lane a round (K1 and K2 once an OTA
    slot: ``lane_slots``, as ``check_path_launches`` reads it), one
    capture a structural group and none on a warm repeat, warm aggregate
    lane-rounds/s batched and sequential over SWEEP_RATE_ROUNDS rounds
    (both on the scan engine), the allocator's growth; with ``profile``, the host's and the device's
    profiles too.  Emits the row and fails on any check."""
    from repro_torch.fed import runtime
    from repro_torch.fl import run_sweep
    from repro_torch.fl.sweep import _structural_signature
    runtime.clear_compile_caches()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2 ** 20
    runtime.cache_info()
    row = {"phase": "sweep", "grid": name, "axes": {
        n: [str(v) for v in sweep.values(n)] for n in sweep.names},
        "classification": sweep.classification(), "size": sweep.size,
        "rounds": ROUNDS}
    ops.reset_launch_counts()
    batched = run_sweep(sweep, ROUNDS)
    torch.cuda.synchronize()
    row["launches"] = dict(ops.LAUNCH_COUNTS)
    row["captures_first_run"] = runtime.cache_info()["traces_delta"]
    sequential = run_sweep(sweep, ROUNDS, vectorized=False)
    row["bitwise_history"] = all(
        np.array_equal(batched.history[k], sequential.history[k])
        for k in runtime.DIAG_KEYS)
    row["bitwise_params"] = (batched.params_digests
                             == sequential.params_digests)
    row["history_keys_that_differ"] = [
        k for k in runtime.DIAG_KEYS
        if not np.array_equal(batched.history[k], sequential.history[k])]
    row["params_sha256"] = batched.params_sha256()
    loss_key = "train_loss" if "train_loss" in batched.history else "gap"
    row[loss_key] = batched.history[loss_key].tolist()
    runtime.cache_info()
    run_sweep(sweep, ROUNDS)
    row["captures_warm_repeat"] = runtime.cache_info()["traces_delta"]
    lane_rounds = sweep.size * SWEEP_RATE_ROUNDS
    for mode, vec in (("batched", True), ("sequential", False)):
        row[mode] = _sweep_rate(
            lambda vec=vec: run_sweep(sweep, SWEEP_RATE_ROUNDS,
                                      vectorized=vec, evaluate=False),
            lane_rounds)
    row["speedup"] = (row["batched"]["median_lane_rounds_per_s"]
                      / row["sequential"]["median_lane_rounds_per_s"])
    if profile:
        for mode, vec in (("batched", True), ("sequential", False)):
            row[f"host_profile_{mode}"] = _host_profile(
                lambda vec=vec: run_sweep(sweep, SWEEP_RATE_ROUNDS,
                                          vectorized=vec, evaluate=False))
        row["batched_profile"] = _batched_round_profile(sweep, 16)
    row["allocated_mb_before"] = base_mb
    row["allocated_mb_after"] = torch.cuda.memory_allocated() / 2 ** 20
    row["peak_mb"] = torch.cuda.max_memory_allocated() / 2 ** 20
    emit(row)
    check_path_launches(row["launches"], ROUNDS, f"sweep {name}",
                        lanes=sweep.size, slots=lane_slots)
    if not (row["bitwise_history"] and row["bitwise_params"]):
        fail(f"sweep {name}: batched differs from sequential "
             f"({row['history_keys_that_differ']})")
    if any(row["captures_warm_repeat"].values()):
        fail(f"sweep {name}: a warm repeat captured "
             f"{row['captures_warm_repeat']}")
    groups = len({_structural_signature(p.spec) for p in sweep.points()})
    if row["captures_first_run"]["run_chunk_batched"] != groups:
        fail(f"sweep {name}: {row['captures_first_run']} captures for "
             f"{groups} structural groups")
    flat = [v for k in runtime.DIAG_KEYS
            for v in batched.history[k].ravel()]
    if not all(math.isfinite(v) for v in flat):
        fail(f"sweep {name}: non-finite history")
    runtime.clear_compile_caches()
    return row


def phase_sweep(ops) -> None:
    """Two of the paper's sweeps at full width through ``run_sweep``
    (``sweep_grid``): the fig1a grid (Case I, amplification {optimal,
    bmax} x 3 seeds: 2 groups of 3 lanes) and the sweep headline (Case-II
    ridge, noise_var {s2, 2 s2} x 4 seeds: 1 group of 8 lanes), with the
    host's profile and the device's idle share of profiled batched
    rounds."""
    from repro_torch.fl import SweepSpec
    case_ii = case_ii_spec()
    nv = case_ii.fl.channel.noise_var
    sweep_grid(ops, "fig1a", SweepSpec(case_i_spec(),
                                       {"amplification": ("optimal", "bmax"),
                                        "seed": (0, 1, 2)}))
    sweep_grid(ops, "sweep_headline",
               SweepSpec(case_ii, {"noise_var": (nv, 2.0 * nv),
                                   "seed": (0, 1, 2, 3)}))


# benchmarks/figures.py::channel_rounds_per_sec's four environments
CHANNEL_VARIANTS = (("fixed", {}),
                    ("iid_fading", {"block_fading": True}),
                    ("ar1", {"model": "ar1", "rho": 0.9}),
                    ("ar1_csi", {"model": "ar1", "rho": 0.9,
                                 "csi_error": 0.2}))
CSI_OVERHEAD_BUDGET = 2.0        # benchmarks/figures.py:400-405


def _staging_profile(run, rounds: int) -> dict:
    """The host's staging of ``run(rounds)`` under cProfile: ``_stage``'s
    cumulative time a round and the share of it in the Problem-3 re-solve
    and in the rest of the channel refresh (cProfile's own cost inflates
    the Python-heavy parts)."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    run(rounds)
    torch.cuda.synchronize()
    prof.disable()
    cum = {}
    for (path, _, fn), v in pstats.Stats(prof).stats.items():
        if path.endswith(("runtime.py", "amplification.py")):
            cum[fn] = cum.get(fn, 0.0) + v[3]
    stage = cum.get("_stage", 0.0)
    solve = cum.get("solve_problem3_torch", 0.0)
    refresh = cum.get("_refresh", 0.0)
    return {"rounds": rounds, "stage_ms_per_round": 1e3 * stage / rounds,
            "resolve_ms_per_round": 1e3 * solve / rounds,
            "refresh_ms_per_round": 1e3 * refresh / rounds,
            "resolve_share_of_stage": solve / stage if stage else None,
            "refresh_share_of_stage": refresh / stage if stage else None}


def phase_channel(ops) -> dict:
    """The radio environment on the card at Case II's width (ridge, K = 20,
    N = 30, kernels backend), in benchmarks/figures.py::
    channel_rounds_per_sec's four variants: scan == python bitwise over 20
    rounds, the card against a CPU run (PARAMS_ATOL), K1, K2 and K5 once a
    round, warm rounds/s under scan over SWEEP_RATE_ROUNDS rounds, the
    host's staging a round with its Problem-3 re-solve share (cProfile),
    and the device's idle share; the overhead ratio iid_fading / ar1_csi
    beside the reference's 2x budget; then the reduced csi_robustness grid
    through ``run_sweep`` (``sweep_grid``).  Returns the launches of the
    variants' scan runs."""
    import collections
    import dataclasses
    from repro_torch.fed import runtime
    from repro_torch.fl import Experiment, SweepSpec
    t_phase = time.perf_counter()
    base = case_ii_spec()
    launches = collections.Counter()
    rates = {}

    def with_channel(spec, chkw):
        channel = dataclasses.replace(spec.fl.channel, **chkw)
        return dataclasses.replace(
            spec, fl=dataclasses.replace(spec.fl, channel=channel))

    for name, chkw in CHANNEL_VARIANTS:
        runtime.clear_compile_caches()
        spec = with_channel(base, chkw)
        row = {"phase": "channel", "variant": name, "channel": chkw,
               "rounds": ROUNDS}
        runs = {}
        for driver in ("scan", "python"):
            e = Experiment(dataclasses.replace(spec, driver=driver),
                           device="cuda").setup()
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            e.run(ROUNDS)
            torch.cuda.synchronize()
            if driver == "scan":
                row["launches"] = dict(ops.LAUNCH_COUNTS)
                launches.update(row["launches"])
            runs[driver] = e
        row["scan_vs_python"] = compare_runs(
            runs["scan"].params, runs["scan"].history,
            runs["python"].params, runs["python"].history)
        cpu = Experiment(spec, device="cpu")
        cpu.run(ROUNDS)
        scan = runs["scan"]
        diff = max(float((scan.params[k].cpu() - cpu.params[k]).abs().max())
                   for k in cpu.params)
        row.update(max_abs_param_diff_vs_cpu=diff,
                   tolerance=f"|d| <= {PARAMS_ATOL:g} (phase main's)",
                   gap=scan.history["gap"],
                   csi_gain_err=scan.history["csi_gain_err"][:4])
        warm = lambda n, e=scan: e.run(n, evaluate=False)
        row["rates"] = driver_rates(warm, SWEEP_RATE_ROUNDS, 16)
        row["staging"] = _staging_profile(warm, SWEEP_RATE_ROUNDS)
        rates[name] = row["rates"]["median_rounds_per_s"]
        emit(row)
        check_path_launches(row["launches"], ROUNDS, f"channel {name}",
                            lanes=1)
        if not row["scan_vs_python"]["bitwise"]:
            fail(f"channel {name}: scan and python differ "
                 f"({row['scan_vs_python']})")
        if not diff <= PARAMS_ATOL:
            fail(f"channel {name}: GPU and CPU params differ by {diff}")
        flat = [v for k in runtime.DIAG_KEYS for v in scan.history[k]]
        if not all(math.isfinite(v) for v in flat + scan.history["gap"]):
            fail(f"channel {name}: non-finite history")
        del runs, scan, cpu
    overhead = rates["iid_fading"] / rates["ar1_csi"]
    emit({"phase": "channel_overhead", "rounds_per_s": rates,
          "iid_fading_over_ar1_csi": overhead,
          "budget": CSI_OVERHEAD_BUDGET,
          "within_budget": overhead <= CSI_OVERHEAD_BUDGET})
    # the reduced csi_robustness grid (benchmarks/figures.py:414-445): 2
    # structural groups (scheme) of 8 lanes (csi_error x seed)
    fading = with_channel(base, {"block_fading": True})
    sweep_grid(ops, "csi_robustness", SweepSpec(
        fading, {"scheme": ("normalized", "benchmark1"),
                 "csi_error": (0.0, 0.1, 0.3, 0.6), "seed": (0, 1)}),
        profile=False)
    emit({"phase": "channel_seconds",
          "seconds": time.perf_counter() - t_phase})
    return dict(launches)


# benchmarks/figures.py::client_algorithms: H = 4, local_lr 0.05 (as phase
# local_steps), noise_var 1e-10 (figures.py:466-474: the de-gained slot-2
# aggregate amplifies the channel noise by about 1 / (a sum h b))
CLIENT_NOISE_VAR = 1e-10
CLIENT_ALGOS = (("sgd", {"client.algo": "sgd"}),
                ("fedprox", {"client.algo": "fedprox", "client.mu": 0.1}),
                ("feddyn", {"client.algo": "feddyn", "client.alpha": 0.1}),
                ("scaffold", {"client.algo": "scaffold"}))
CLIENT_GRID_ROUNDS = 200         # figures.py::client_algorithms' default
ENERGY_RATIO_BAND = (1.95, 2.05)  # figures.py:528-534
# the card against a CPU run, every round: the params at phase main's
# tolerance, the client state at CLIENT_STATE_RTOL of its largest
# magnitude.  The de-gain divides, so the slot-2 roundoff stays relative;
# measured on an H100 over 20 rounds, the largest gap was 1.9e-5 of
# max |state| (SCAFFOLD's variates, round 5), so 1e-4 leaves a 5x margin
CLIENT_STATE_RTOL = 1e-4


def clients_spec(client: dict | None = None):
    """Case I at full width as figures.py::client_algorithms runs it."""
    import dataclasses
    from repro_torch.fl.spec import apply_axes
    spec = case_i_spec()
    channel = dataclasses.replace(spec.fl.channel, noise_var=CLIENT_NOISE_VAR)
    spec = dataclasses.replace(
        spec, fl=dataclasses.replace(spec.fl, channel=channel),
        local_steps=LOCAL_STEPS, local_lr=LOCAL_LR)
    return apply_axes(spec, client or {})


def _state_gap(a: dict, b: dict) -> tuple:
    """max |a - b| over a client state's trees, and max |b|."""
    gap = top = 0.0
    for part in ("dev", "srv"):
        for k, v in b[part].items():
            gap = max(gap, float((a[part][k].cpu() - v).abs().max()))
            top = max(top, float(v.abs().max()))
    return gap, top


def _client_bitwise(a, b) -> bool:
    sa, sb = a.state.client_state, b.state.client_state
    if sa is None or sb is None:
        return sa is sb
    return all(torch.equal(sa[p][k], sb[p][k]) for p in ("dev", "srv")
               for k in sb[p])


def _client_algo(name: str, gpu_launches) -> dict:
    """One algorithm on Case I: scan == python bitwise over ROUNDS on the
    dense and a k_block = 4 round, K1/K2/K5 per slot, the card against a
    CPU run round by round, and the warm rate with the device's busy time
    and idle share."""
    import dataclasses
    from repro_torch.fl import Experiment, clients
    client = dict(CLIENT_ALGOS)[name]
    spec = clients_spec(client)
    slots = clients.get(spec.fl.client.algo).num_slots
    row = {"phase": "clients", "algo": name, "client": client,
           "rounds": ROUNDS, "slots": slots}
    for kind, over in (("dense", {}), ("k_block_4", {"k_block": 4})):
        runs = {}
        for driver in ("scan", "python"):
            e = Experiment(dataclasses.replace(spec, driver=driver, **over),
                           device="cuda").setup()
            _, ops_counts = _launches_of(lambda: e.run(ROUNDS))
            runs[driver] = e
            if driver == "scan":
                row[f"launches_{kind}"] = ops_counts
                if kind == "dense":
                    gpu_launches.update(ops_counts)
                    check_path_launches(ops_counts, ROUNDS,
                                        f"clients {name}", lanes=1,
                                        slots=slots)
        row[kind] = compare_runs(runs["scan"].params, runs["scan"].history,
                                 runs["python"].params,
                                 runs["python"].history)
        row[kind]["client_state_bitwise"] = _client_bitwise(runs["scan"],
                                                            runs["python"])
    # the card against the CPU, round by round
    gpu = Experiment(spec, device="cuda")
    cpu = Experiment(spec, device="cpu")
    gaps = []
    for _ in range(ROUNDS):
        gpu.run(1, evaluate=False)
        cpu.run(1, evaluate=False)
        g = {"params": max(float((gpu.params[k].cpu() - cpu.params[k])
                                 .abs().max()) for k in cpu.params)}
        if cpu.state.client_state is not None:
            g["state"], g["state_max"] = _state_gap(gpu.state.client_state,
                                                    cpu.state.client_state)
        gaps.append(g)
    row["gpu_vs_cpu_by_round"] = gaps
    row["tolerance"] = (f"every round: params |d| <= {PARAMS_ATOL:g} (phase "
                        f"main's); client state |d| <= "
                        f"{CLIENT_STATE_RTOL:g} max|state|")
    warm = Experiment(spec, device="cuda")
    warm.run(1, evaluate=False)
    row["rates"] = driver_rates(lambda n: warm.run(n, evaluate=False),
                                ROUNDS, 5)
    row["train_loss"] = runs["python"].history["train_loss"]
    emit(row)
    for kind in ("dense", "k_block_4"):
        if not (row[kind]["bitwise"] and row[kind]["client_state_bitwise"]):
            fail(f"clients {name}: scan and python differ on the {kind} "
                 f"round ({row[kind]})")
    for t, g in enumerate(gaps, start=1):
        if not g["params"] <= PARAMS_ATOL:
            fail(f"clients {name}: GPU and CPU params differ by "
                 f"{g['params']} at round {t}")
        if "state" in g and not g["state"] <= (CLIENT_STATE_RTOL
                                               * g["state_max"]):
            fail(f"clients {name}: GPU and CPU client state differ by "
                 f"{g['state']} at round {t} (max |state| "
                 f"{g['state_max']})")
    hist = runs["scan"].history
    flat = [v for k in hist if k != "round" for v in hist[k]]
    if not all(math.isfinite(v) for v in flat):
        fail(f"clients {name}: non-finite history")
    return row


def _launches_of(run) -> tuple:
    """``run()``'s result and the kernels' launch counts in it, from counts
    set to 0 just before it."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    return out, dict(ops.LAUNCH_COUNTS)


def client_sweep():
    """figures.py::client_algorithms' grid at full width: algorithm x
    Dirichlet alpha x participation x seed."""
    import dataclasses
    from repro_torch.fl import EvalSpec, SweepSpec
    base = dataclasses.replace(
        clients_spec(), eval=EvalSpec(every=max(CLIENT_GRID_ROUNDS // 10, 5)))
    return SweepSpec(base, {"algo": CLIENT_ALGOS, "alpha": (0.1, 100.0),
                            "participation": (1.0, 0.5),
                            "seed": (0, 1, 2)})


def client_figure(sweep) -> dict:
    """The figure itself: CLIENT_GRID_ROUNDS batched rounds of the grid,
    the two-slot energy ratios under full participation (failed outside
    ENERGY_RATIO_BAND, as the reference's figure fails them) and the final
    train-loss bands (reported)."""
    from repro_torch.fed import runtime
    from repro_torch.fl import run_sweep
    row = {"phase": "clients_figure", "size": sweep.size,
           "rounds": CLIENT_GRID_ROUNDS}
    t0 = time.perf_counter()
    res = run_sweep(sweep, CLIENT_GRID_ROUNDS)
    row["figure_s"] = time.perf_counter() - t0
    mean, std = res.band("train_loss", over="seed")   # [algo, alpha, part, E]
    emean, _ = res.band("tx_energy", over="seed")
    names = res.sweep.values("algo")
    energy = {n: float(np.sum(emean[i, 0, 0])) for i, n in enumerate(names)}
    row["total_tx_energy_alpha0.1_part1"] = energy
    row["energy_ratio"] = {n: energy[n] / energy["sgd"]
                           for n in ("feddyn", "scaffold")}
    final = {}
    for i, n in enumerate(names):
        for j, al in enumerate(res.sweep.values("alpha")):
            for k, part in enumerate(res.sweep.values("participation")):
                final[f"{n}/alpha={al}/part={part}"] = [
                    float(mean[i, j, k][-1]), float(std[i, j, k][-1])]
    row["final_train_loss_mean_std"] = final
    sm, ss = final["sgd/alpha=0.1/part=1.0"]
    row["separates_from_sgd_alpha0.1_part1"] = {
        n: final[f"{n}/alpha=0.1/part=1.0"][0]
        + final[f"{n}/alpha=0.1/part=1.0"][1] < sm - ss
        for n in ("feddyn", "scaffold")}
    row["figure_finite"] = all(
        math.isfinite(v) for k in runtime.DIAG_KEYS
        for v in res.history[k].ravel())
    emit(row)
    lo, hi = ENERGY_RATIO_BAND
    for n, ratio in row["energy_ratio"].items():
        if not lo <= ratio <= hi:
            fail(f"clients figure: {n}/sgd transmit-energy ratio {ratio} "
                 f"outside [{lo}, {hi}]")
    if not row["figure_finite"]:
        fail("clients figure: non-finite history")
    runtime.clear_compile_caches()
    return row


def phase_clients(ops) -> dict:
    """The client algorithms on Case I at full width (``_client_algo`` for
    sgd and the three correctors), then the figure's grid through
    ``sweep_grid`` and its CLIENT_GRID_ROUNDS-round figure
    (``client_figure``).  Returns the launches of the three correctors'
    dense scan runs and of the grid's first batched run."""
    import collections
    from repro_torch.fed import runtime
    from repro_torch.fl import clients
    t_phase = time.perf_counter()
    launches = collections.Counter()
    rates = {}
    for name, _ in CLIENT_ALGOS:
        runtime.clear_compile_caches()
        counted = launches if name != "sgd" else collections.Counter()
        row = _client_algo(name, counted)
        rates[name] = {k: row["rates"][k] for k in (
            "median_rounds_per_s", "device_busy_us_per_round",
            "device_idle_share")}
    runtime.clear_compile_caches()
    emit({"phase": "clients_rates", "rates": rates})
    sweep = client_sweep()
    row = sweep_grid(ops, "client_algorithms", sweep, lane_slots=[
        clients.get(p.spec.fl.client.algo).num_slots
        for p in sweep.points()])
    launches.update(row["launches"])
    client_figure(sweep)
    emit({"phase": "clients_seconds",
          "seconds": time.perf_counter() - t_phase})
    return dict(launches)


OBS_ROUNDS, OBS_CHUNK = 40, 16   # eval every 10 (case_i_spec's)
OBS_SINKS = ("memory", "jsonl", "csv")
OBS_RATE_ROUNDS = 160            # rounds a timed call of the overhead pairs
OBS_RATE_BLOCKS = 8              # A B B A blocks of warm calls
OBS_EMIT_REPS = 200              # timed on_chunk calls of one 16-round chunk
OBS_OVERHEAD_BUDGET = 1.05       # benchmarks/common.py:57 (the jsonl lane)
# K1, K5 and K2 in a torch.profiler trace, by their kernels' names
OBS_TRACE_KERNELS = {"batched_moments": "moments_kernel<false>",
                     "sumsq": "moments_kernel<true>",
                     "ota_superpose": "superpose_"}


def _obs_digest(e) -> tuple:
    """A run's bits: the params and client state digest, and every
    DIAG_KEYS history."""
    from repro_torch import obs
    from repro_torch.fed import runtime
    return (obs.params_sha256((e.params, e.state.client_state)),
            {k: e.history[k] for k in runtime.DIAG_KEYS})


def _sink(name: str, tmp: pathlib.Path, tag: str):
    from repro_torch import obs
    if name == "memory":
        return obs.make(name)
    return obs.make(name, path=str(tmp / f"{tag}.{name}"))


def _covered(rec) -> list:
    """The rounds the chunk events cover, in order."""
    return [t for c in rec.select("chunk")
            for t in range(c["round_start"], c["round_end"] + 1)]


def _jsonl_kinds(path, kinds=("round", "eval")) -> dict:
    lines = [json.loads(s) for s in open(path)]
    return {kind: [x for x in lines if x["event"] == kind] for kind in kinds}


def _obs_run(spec, driver: str = "scan", recorder=None):
    from repro_torch.fl import Experiment
    e = Experiment(spec, device="cuda")
    e.run(OBS_ROUNDS, driver=driver, chunk_size=OBS_CHUNK, recorder=recorder)
    torch.cuda.synchronize()
    return e


def _obs_variant(name: str, spec, driver: str, tmp: pathlib.Path) -> dict:
    """Recorder off against each of OBS_SINKS on one spec and driver
    (OBS_ROUNDS rounds, chunks of OBS_CHUNK): the same params, client
    state and DIAG_KEYS histories; the chunk events cover every round
    once; ``dump_history`` writes the live jsonl file's round and eval
    lines."""
    one = lambda rec: _obs_run(spec, driver, rec)
    want = _obs_digest(one(None))
    row = {"variant": name, "driver": driver, "bitwise": {}}
    for sink in OBS_SINKS:
        rec = _sink(sink, tmp, name)
        with rec:
            e = one(rec)
        row["bitwise"][sink] = _obs_digest(e) == want
        if sink == "memory":
            chunks = rec.select("chunk")
            row["chunks"] = len(chunks)
            row["rounds_once"] = (_covered(rec) == [
                r["round"] for r in rec.select("round")]
                == list(range(1, OBS_ROUNDS + 1)))
            row["dispatches"] = sum(c["dispatches"] for c in chunks)
            row["captures"] = sum(sum(c["retraces"].values())
                                  for c in chunks)
            row["chunk_wall_ms"] = [round(c["wall_time_s"] * 1e3, 3)
                                    for c in chunks]
            row["eval_rounds"] = [x["round"] for x in rec.select("eval")]
            row["memory_recorder"] = rec
        elif sink == "jsonl":
            post = tmp / f"{name}.post.jsonl"
            e.dump_history(str(post))
            row["dump_history_equals_live"] = (_jsonl_kinds(post)
                                               == _jsonl_kinds(rec.path))
    return row


def _obs_sweep(tmp: pathlib.Path) -> dict:
    """The fig1a grid through ``run_sweep`` (2 structural groups of 3
    lanes), recorder off against each sink: the same params digests and
    histories, and each group's chunk events cover every round once."""
    from repro_torch.fl import SweepSpec, run_sweep
    sweep = SweepSpec(case_i_spec(), {"amplification": ("optimal", "bmax"),
                                      "seed": (0, 1, 2)})
    off = run_sweep(sweep, OBS_ROUNDS)
    row = {"variant": "fig1a_sweep", "size": sweep.size, "bitwise": {}}
    for sink in OBS_SINKS:
        rec = _sink(sink, tmp, "fig1a")
        with rec:
            res = run_sweep(sweep, OBS_ROUNDS, recorder=rec)
        row["bitwise"][sink] = (
            res.params_digests == off.params_digests
            and all(np.array_equal(res.history[k], off.history[k])
                    for k in off.history))
        if sink == "memory":
            rounds = list(range(1, OBS_ROUNDS + 1))
            row["rounds_once"] = _covered(rec) == rounds * 2
            row["lanes_per_round_event"] = sorted({
                len(r["grad_norm_mean"]) for r in rec.select("round")})
    return row


def _obs_overhead(spec, tmp: pathlib.Path) -> dict:
    """Warm rounds/s of the scan driver with the jsonl sink off and on, in
    OBS_RATE_BLOCKS blocks of A B B A calls of OBS_RATE_ROUNDS rounds (no
    eval), beside the reference's budget (reported, not failed)."""
    from repro_torch import obs
    from repro_torch.fl import Experiment
    e = Experiment(spec, device="cuda")
    e.run(OBS_RATE_ROUNDS, evaluate=False)
    rates = {"off": [], "jsonl": []}
    with obs.make("jsonl", path=str(tmp / "rate.jsonl")) as rec:
        for _ in range(OBS_RATE_BLOCKS):
            for which in ("off", "jsonl", "jsonl", "off"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e.run(OBS_RATE_ROUNDS, evaluate=False,
                      recorder=rec if which == "jsonl" else None)
                torch.cuda.synchronize()
                rates[which].append(OBS_RATE_ROUNDS
                                    / (time.perf_counter() - t0))
    med = {k: statistics.median(v) for k, v in rates.items()}
    # the sink's own host cost: one chunk's events (a chunk event and 16
    # round events) into a jsonl file, and one run's manifest
    from repro_torch.fed import runtime
    rows = torch.zeros((OBS_CHUNK, len(runtime.DIAG_KEYS)))
    info = dict(wall_time_s=0.0, dispatches=OBS_CHUNK,
                retraces=runtime.trace_deltas({}))
    with obs.make("jsonl", path=str(tmp / "emit.jsonl")) as rec:
        t0 = time.perf_counter()
        for i in range(OBS_EMIT_REPS):
            runtime._emit_chunk(rec, i, list(range(OBS_CHUNK)), rows, info)
        emit_ms = (time.perf_counter() - t0) * 1e3 / OBS_EMIT_REPS
    t0 = time.perf_counter()
    for _ in range(5):
        e.manifest()
    manifest_ms = (time.perf_counter() - t0) * 1e3 / 5
    return {"rounds_per_call": OBS_RATE_ROUNDS, "rounds_per_s": rates,
            "median_rounds_per_s": med,
            "overhead_ratio_off_over_jsonl": med["off"] / med["jsonl"],
            "reference_budget": OBS_OVERHEAD_BUDGET,
            "jsonl_chunk_emit_ms": emit_ms, "manifest_ms": manifest_ms,
            "host_ms_per_chunk_off": OBS_CHUNK * 1e3 / med["off"]}


def _obs_resume(name: str, spec, tmp: pathlib.Path) -> dict:
    """``run(40)`` against ``run(20); save; load; run(20)`` on the card
    (a time-varying channel saves later, see below), bitwise (params,
    optimizer and client state, history); the checkpoint
    loaded on the CPU against the card's leaves, bitwise; save and load
    times and the file's size."""
    from repro_torch.checkpoint import store
    from repro_torch.fed import runtime
    from repro_torch.fl import Experiment
    cont = Experiment(spec, device="cuda")
    cont.run(OBS_ROUNDS)
    first = Experiment(spec, device="cuda")
    first.run(OBS_ROUNDS // 2)
    # under a time-varying channel, save at the first round from the half
    # on where the gain derived anew from the round's a, b and h_hat (what
    # a file without the eff_gain leaf resumes on) is not the designed gain
    # the leaf keeps, so the resume needs the leaf
    rederived = None
    if spec.fl.channel.time_varying():
        while (runtime.designed_gain(first.state) == first.state.eff_gain
               and first.round < OBS_ROUNDS - 1):
            first.run(1)
        rederived = (runtime.designed_gain(first.state)
                     != first.state.eff_gain)
    path = str(tmp / f"{name}.msgpack")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first.save(path)
    save_ms = (time.perf_counter() - t0) * 1e3
    resumed = Experiment(spec, device="cuda").setup()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resumed.load(path)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    saved = store._flatten_with_paths(first._ckpt_tree())
    resumed.run(OBS_ROUNDS - first.round)
    state = lambda e: store._flatten_with_paths(
        (e.params, e.state.opt_state, e.state.client_state))
    hist = {k: first.history[k] + resumed.history[k] for k in cont.history}
    bitwise = (hist == cont.history and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(state(resumed),
                                                    state(cont))))
    cpu = Experiment(spec, device="cpu").load(path)
    got = store._flatten_with_paths(cpu._ckpt_tree())
    cpu_bitwise = [k for k, _ in got] == [k for k, _ in saved] and all(
        (torch.equal(a, b.cpu()) and a.device.type == "cpu")
        if isinstance(b, torch.Tensor) else np.array_equal(a, b)
        for (_, a), (_, b) in zip(got, saved))
    return {"case": name, "saved_at_round": first.round,
            "resume_bitwise": bitwise, "rederived_gain_differs": rederived,
            "cpu_load_bitwise": cpu_bitwise, "leaves": len(saved),
            "file_bytes": os.path.getsize(path), "save_ms": save_ms,
            "load_ms": load_ms}


def _obs_profile(want: tuple, tmp: pathlib.Path) -> dict:
    """A fresh Case-I run with REPRO_OBS_PROFILE set (the engine's CUDA
    graph captured inside the trace) against the unprofiled run: bitwise;
    the trace names K1, K2 and K5 and holds one obs_chunk range per
    chunk."""
    from repro_torch import obs
    from repro_torch.fed import runtime
    from repro_torch.fl import Experiment
    runtime.clear_compile_caches()
    out = tmp / "trace"
    os.environ[obs.profiling.PROFILE_ENV] = str(out)
    try:
        rec = obs.MemoryRecorder()
        e = Experiment(case_i_spec(), device="cuda")
        e.run(OBS_ROUNDS, chunk_size=OBS_CHUNK, recorder=rec)
        torch.cuda.synchronize()
    finally:
        del os.environ[obs.profiling.PROFILE_ENV]
    traces = sorted(out.glob("obs_trace_*.json"))
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = {name: sum(1 for ev in events if ev.get("cat") == "kernel"
                         and pat in ev.get("name", ""))
               for name, pat in OBS_TRACE_KERNELS.items()}
    ranges = sorted({ev["name"] for ev in events
                     if ev.get("cat") == "user_annotation"
                     and ev.get("name", "").startswith("obs_chunk_")})
    chunks = rec.select("chunk")
    return {"bitwise": _obs_digest(e) == want, "traces": len(traces),
            "trace_bytes": traces[0].stat().st_size,
            "captured_in_trace": chunks[0]["retraces"]["run_chunk"] == 1,
            "kernel_events": kernels, "chunk_ranges": len(ranges),
            "chunks": len(chunks)}


def _obs_serve(rec) -> dict:
    """``serve_metrics`` on 127.0.0.1, port 0, over a finished run's
    MemoryRecorder."""
    import urllib.request
    from repro_torch.launch.serve import serve_metrics
    server = serve_metrics(rec, host="127.0.0.1", port=0)
    try:
        host, port = server.server_address
        body = json.loads(urllib.request.urlopen(
            f"http://{host}:{port}/metrics", timeout=30).read())
    finally:
        server.shutdown()
        server.server_close()
    return {"round": body["round"]["round"], "events": body["events"],
            "recorder_events": len(rec.events)}


def phase_obs(ops) -> dict:
    """Checkpoints and the flight recorder on Case I at full width (the
    path of a recorded and resumed run: the captured round with a recorder,
    save, load, resume):
    (a) recorder off against each sink, bitwise, under both drivers, on
    k_block = 4, on feddyn at H = 4 and on the fig1a grid through
    ``run_sweep``; (b) the jsonl sink's overhead; (c) resume from disk and
    the card's checkpoint on the CPU, bitwise; (d) a profiled fresh run,
    bitwise, and its trace; (e) ``serve_metrics``.  Returns the launches
    of K1, K2 and K5 in the phase (counts set to 0 at its start)."""
    import dataclasses
    import tempfile
    from repro_torch.channels import GeometryConfig
    from repro_torch.fed import runtime
    t_phase = time.perf_counter()
    runtime.clear_compile_caches()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    base = case_i_spec()
    feddyn = clients_spec(dict(CLIENT_ALGOS)["feddyn"])
    case_ii = case_ii_spec()
    ar1 = dataclasses.replace(case_ii, fl=dataclasses.replace(
        case_ii.fl, channel=dataclasses.replace(
            case_ii.fl.channel, model="ar1", rho=0.8, csi_error=0.2,
            geometry=GeometryConfig(shadowing_std_db=3.0))))
    with tempfile.TemporaryDirectory() as d:
        tmp = pathlib.Path(d)
        variants = [_obs_variant("dense", base, "scan", tmp),
                    _obs_variant("dense", base, "python", tmp),
                    _obs_variant("k_block_4", dataclasses.replace(
                        base, k_block=4), "scan", tmp),
                    _obs_variant("feddyn_h4", feddyn, "scan", tmp)]
        dense_rec = variants[0].pop("memory_recorder")
        for v in variants[1:]:
            v.pop("memory_recorder")
        want = _obs_digest(_obs_run(base))
        sweep = _obs_sweep(tmp)
        overhead = _obs_overhead(base, tmp)
        resume = [_obs_resume("sgd", base, tmp),
                  _obs_resume("adamw_p07", dataclasses.replace(
                      base, server_opt="adamw", participation=0.7), tmp),
                  _obs_resume("feddyn_h4", feddyn, tmp),
                  _obs_resume("ridge_ar1_csi_geometry", ar1, tmp)]
        profile = _obs_profile(want, tmp)
        served = _obs_serve(dense_rec)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCH_COUNTS)
    row = {"phase": "obs", "rounds": OBS_ROUNDS, "chunk_size": OBS_CHUNK,
           "variants": variants + [sweep], "overhead": overhead,
           "resume": resume, "profile": profile, "serve_metrics": served,
           "launches": launches,
           "seconds": time.perf_counter() - t_phase}
    emit(row)
    for v in variants + [sweep]:
        tag = f"obs {v['variant']} {v.get('driver', 'run_sweep')}"
        for sink, ok in v["bitwise"].items():
            if not ok:
                fail(f"{tag}: the {sink} recorder changed the run's bits")
        if not v["rounds_once"]:
            fail(f"{tag}: the chunk events do not cover each round once")
        if v.get("dump_history_equals_live") is False:
            fail(f"{tag}: dump_history differs from the live jsonl file")
    for r in resume:
        if not (r["resume_bitwise"] and r["cpu_load_bitwise"]):
            fail(f"obs resume {r['case']}: {r}")
    if not (profile["bitwise"] and profile["captured_in_trace"]
            and profile["traces"] == 1
            and all(n >= OBS_ROUNDS for n in
                    profile["kernel_events"].values())
            and profile["chunk_ranges"] == profile["chunks"]):
        fail(f"obs profile: {profile}")
    if not (served["round"] == OBS_ROUNDS
            and served["events"] == served["recorder_events"]):
        fail(f"obs serve_metrics: {served}")
    check_path_launches(launches, OBS_ROUNDS, "obs")
    return launches


# --------------------------------------------------------------------------
# the FL-device mesh: the sharded streaming round, emulated on one card

MESH_KB = 2                      # Case I: 10 K-blocks of 2 devices
MESH_CASE_I = (None, 1, 5)       # device_mesh values (5: 2 blocks a shard)
MESH_KSCALE = (None, 4)          # K-scale: 4 shards of 25 K-blocks
MESH_PROFILED = 5                # profiled rounds a Case-I value
MESH_RATE_ROUNDS = 3             # rounds a timed K-scale call (A B B A)


def _mesh_run(ops, spec, driver: str):
    """One Case-I run on the card: 20 rounds with eval, then 20 warm rounds
    without, timed.  Returns the experiment and its numbers (launches of the
    40 rounds, the graph's warm-up rounds included, and the peak device
    memory)."""
    import dataclasses
    from repro_torch.fl import Experiment
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2 ** 20
    ops.reset_launch_counts()
    e = Experiment(dataclasses.replace(spec, driver=driver), device="cuda")
    e.run(ROUNDS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e.run(ROUNDS, evaluate=False)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    return e, {"warm_rounds_per_s": ROUNDS / warm,
               "launches": dict(ops.LAUNCH_COUNTS),
               "peak_mem_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
               "mem_before_mb": base_mb}


def _wall_ms(fn, calls: int = 5) -> float:
    """Median host-clock ms of one call of ``fn`` ended by a synchronize,
    over ``calls`` calls after one warm-up call: the time of a long,
    host-bound call as its caller waits for it."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def _mesh_kscale(dm, device: str):
    import dataclasses
    cfg, state, grad_fn, provider = kscale_case(device)
    return (dataclasses.replace(cfg, device_mesh=dm), state, grad_fn,
            provider)


def phase_mesh(ops) -> dict:
    """The sharded streaming round (``device_mesh``), emulated on one card
    (one process, no group: the shards in turn, then the fixed fold):
    Case I at k_block = 2 with device_mesh None, 1 and 5 on both drivers;
    the K-scale round with device_mesh None and 4; and
    ``aggregate(kernels, k_block=1000, device_mesh=4)`` at the K-scale
    shape.  Returns the launches of the path's runs."""
    import dataclasses
    from repro_torch.core import ota
    from repro_torch.fed import runtime
    from repro_torch.fl import Experiment
    runtime.clear_compile_caches()
    t_phase = time.perf_counter()
    path = {name: 0 for name in ops.LAUNCH_COUNTS}

    def add(launches):
        for name, n in launches.items():
            path[name] += n

    out = {"phase": "mesh", "emulated": True, "case_i": {},
           "kscale": {}, "aggregate": {}}
    spec = dataclasses.replace(case_i_spec(), k_block=MESH_KB)
    blocks = K_MAIN // MESH_KB
    runs = {}
    for dm in MESH_CASE_I:
        sdm = dataclasses.replace(spec, device_mesh=dm)
        row = {}
        for driver in ("scan", "python"):
            e, nums = _mesh_run(ops, sdm, driver)
            add(nums["launches"])
            runs[dm, driver] = e
            # the graph's two eager warm-up rounds launch too
            rounds = 2 * ROUNDS + (runtime.GRAPH_WARMUP_ROUNDS
                                   if driver == "scan" else 0)
            nums["launched_rounds"] = rounds
            nums["k2_per_round"] = nums["launches"]["ota_superpose"] / rounds
            nums["k5_per_round"] = nums["launches"]["sumsq"] / rounds
            row[driver] = nums
            if (nums["launches"]["ota_superpose"] != blocks * rounds
                    or nums["launches"]["sumsq"] != rounds):
                emit(out)
                fail(f"device_mesh {dm} ({driver}): K2 launched "
                     f"{nums['launches']['ota_superpose']} times and K5 "
                     f"{nums['launches']['sumsq']} in {rounds} rounds, "
                     f"expected {blocks} and 1 a round")
        scan, python = runs[dm, "scan"], runs[dm, "python"]
        row["scan_vs_python"] = compare_runs(scan.params, scan.history,
                                             python.params, python.history)
        ops.reset_launch_counts()
        row["profile"] = _profiled_round(
            lambda n: scan.run(n, evaluate=False), MESH_PROFILED)
        add(dict(ops.LAUNCH_COUNTS))
        row["profile"]["device_idle_share_of_unprofiled_round"] = (
            1 - row["profile"]["device_busy_us_per_round"] * 1e-6
            * row["scan"]["warm_rounds_per_s"])
        out["case_i"][str(dm)] = row
    # device_mesh = 1 against None on each driver (the scan runs both took
    # the profiled rounds too); the python runs stand for both drivers below
    for driver in ("scan", "python"):
        one, plain = runs[1, driver], runs[None, driver]
        out["case_i"][f"1_vs_None_{driver}"] = compare_runs(
            one.params, one.history, plain.params, plain.history)
    plain, five = runs[None, "python"], runs[5, "python"]
    out["case_i"]["5_vs_None"] = {
        "max_rel_param_diff": _max_rel(five.params, plain.params),
        "within_tolerance": _stream_close(five.params, plain.params),
        "tolerance": f"rtol {STREAM_RTOL:g}, atol {STREAM_ATOL:g} (shard "
                     "partials re-associate the K-way sums)"}
    cpu = Experiment(dataclasses.replace(spec, device_mesh=5,
                                         driver="python"), device="cpu")
    cpu.run(ROUNDS)
    cpu.run(ROUNDS, evaluate=False)
    diff = max(float((five.params[k].cpu() - cpu.params[k]).abs().max())
               for k in cpu.params)
    out["case_i"]["5_gpu_vs_cpu"] = {
        "max_abs_param_diff": diff, "within_tolerance": diff <= PARAMS_ATOL,
        "tolerance": f"|d| <= {PARAMS_ATOL:g} after {2 * ROUNDS} rounds"}

    # the K-scale round: 3 rounds each on a card cleared of the engines
    # before it (so that each peak is its own), then A B B A timed calls
    del runs, scan, python, plain, five, cpu
    states = {}
    for dm in MESH_KSCALE:
        runtime.clear_compile_caches()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mb = torch.cuda.memory_allocated() / 2 ** 20
        cfg, state, grad_fn, provider = _mesh_kscale(dm, "cuda")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, first = runtime.run(cfg, state, grad_fn, None, 1,
                                   block_batch_provider=provider)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, rest = runtime.run(cfg, state, grad_fn, None,
                                  STREAM_ROUNDS - 1,
                                  block_batch_provider=provider)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = dict(ops.LAUNCH_COUNTS)
        add(launches)
        rounds = STREAM_ROUNDS + runtime.GRAPH_WARMUP_ROUNDS
        states[dm] = (cfg, state, grad_fn, provider,
                      {k: state.params[k].detach().clone()
                       for k in state.params})
        hist = {k: first[k] + rest[k] for k in first}
        out["kscale"][str(dm)] = {
            "first_round_s": t1 - t0,
            "rounds_per_s_2_to_3": (STREAM_ROUNDS - 1) / (t2 - t1),
            "launches": launches,
            "k2_per_round": launches["ota_superpose"] / rounds,
            "peak_mem_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
            "mem_before_mb": base_mb,
            "update_norm": hist["update_norm"]}
        if launches["ota_superpose"] != (K_SCALE // KB_SCALE) * rounds:
            emit(out)
            fail(f"K-scale device_mesh {dm}: K2 launched "
                 f"{launches['ota_superpose']} times in {rounds} rounds")
        if not all(math.isfinite(v) for key, vals in hist.items()
                   if key != "round" for v in vals):
            fail(f"K-scale device_mesh {dm}: non-finite history")
    w_plain, w_mesh = (states[dm][4]["w"].cpu() for dm in MESH_KSCALE)
    scale = float(w_plain.abs().max())
    d_plain = float((w_mesh - w_plain).abs().max())
    cfg_c, state_c, grad_c, provider_c = _mesh_kscale(4, "cpu")
    t3 = time.perf_counter()
    state_c, _ = runtime.run(cfg_c, state_c, grad_c, None, STREAM_ROUNDS,
                             block_batch_provider=provider_c)
    d_cpu = float((w_mesh - state_c.params["w"]).abs().max())
    out["kscale"]["4_vs_None"] = {
        "max_abs_param_diff": d_plain, "max_abs_param": scale,
        "within_tolerance": d_plain <= KSCALE_REL * scale}
    out["kscale"]["4_gpu_vs_cpu"] = {
        "max_abs_param_diff": d_cpu, "cpu_s": time.perf_counter() - t3,
        "within_tolerance": d_cpu <= KSCALE_REL * scale,
        "tolerance": f"max|d| <= {KSCALE_REL:g} max|w|"}

    def kscale_call(dm) -> float:
        """MESH_RATE_ROUNDS more rounds of the device_mesh ``dm`` run:
        rounds/s."""
        cfg, state, grad_fn, provider, _ = states[dm]
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runtime.run(cfg, state, grad_fn, None, MESH_RATE_ROUNDS,
                    block_batch_provider=provider)
        torch.cuda.synchronize()
        add(dict(ops.LAUNCH_COUNTS))
        return MESH_RATE_ROUNDS / (time.perf_counter() - t0)

    for dm in MESH_KSCALE:           # untimed: their engines were cleared
        kscale_call(dm)
    rates = {str(dm): [] for dm in MESH_KSCALE}
    for dm in (None, 4, 4, None):
        rates[str(dm)].append(kscale_call(dm))
    out["kscale"]["rates_abba"] = rates
    cfg, state, grad_fn, provider, _ = states[4]
    ops.reset_launch_counts()
    prof = _profiled_round(
        lambda n: runtime.run(cfg, state, grad_fn, None, n,
                              block_batch_provider=provider), 1)
    add(dict(ops.LAUNCH_COUNTS))
    prof["device_idle_share_of_unprofiled_round"] = (
        1 - prof["device_busy_us_per_round"] * 1e-6
        * statistics.median(rates["4"]))
    out["kscale"]["4_profile"] = prof
    del states, state, cfg, grad_fn, provider
    runtime.clear_compile_caches()

    # aggregate(kernels, k_block=1000, device_mesh=4) at the K-scale shape
    gen = torch.Generator(device="cuda").manual_seed(99)
    g = _kscale_stack(gen, K_SCALE, N_SCALE)
    h = 1e-3 * (torch.rand((K_SCALE,), generator=gen, device="cuda") + 0.5)
    b = torch.full((K_SCALE,), 5.0 ** 0.5, device="cuda")
    a = float(1.0 / (h * b).sum())
    noise = 1e-7 ** 0.5 * torch.randn((N_SCALE,), generator=gen,
                                      device="cuda")
    g_cpu = {k: v.cpu() for k, v in g.items()}
    for s in ("normalized", "benchmark2"):
        cfg = ota.OTAConfig(scheme=s, a=a, noise_var=1e-7, backend="kernels",
                            k_block=KB_SCALE, device_mesh=4)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        y = ota.aggregate(cfg, g, h, b, noise=noise)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCH_COUNTS)
        add(launches)
        flat = dataclasses.replace(cfg, device_mesh=None)
        streamed = ota.aggregate(flat, g, h, b, noise=noise)
        plain = ota.aggregate(cfg, g_cpu, h.cpu(), b.cpu(),
                              noise=noise.cpu())
        row = {"launches": launches,
               "max_rel_diff_vs_streamed": _max_rel(y, streamed),
               "max_rel_diff_vs_plain": _max_rel(y, plain),
               "within_tolerance": (_stream_close(y, streamed)
                                    and _stream_close(y, plain)),
               "wall_ms": _wall_ms(lambda: ota.aggregate(cfg, g, h, b,
                                                         noise=noise)),
               "streamed_wall_ms": _wall_ms(lambda: ota.aggregate(
                   flat, g, h, b, noise=noise))}
        out["aggregate"][s] = row
        if launches["ota_superpose"] != K_SCALE // KB_SCALE:
            emit(out)
            fail(f"aggregate(device_mesh=4, {s}): K2 launched "
                 f"{launches['ota_superpose']} times, expected "
                 f"{K_SCALE // KB_SCALE}")
    out["launches"] = path
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    checks = [(f"Case I device_mesh 1 vs None bitwise ({d})",
               out["case_i"][f"1_vs_None_{d}"]["bitwise"])
              for d in ("scan", "python")]
    checks += [("Case I device_mesh 5 vs None",
                out["case_i"]["5_vs_None"]["within_tolerance"]),
               ("Case I device_mesh 5 GPU vs CPU",
                out["case_i"]["5_gpu_vs_cpu"]["within_tolerance"]),
               ("K-scale device_mesh 4 vs None",
                out["kscale"]["4_vs_None"]["within_tolerance"]),
               ("K-scale device_mesh 4 GPU vs CPU",
                out["kscale"]["4_gpu_vs_cpu"]["within_tolerance"])]
    checks += [(f"Case I device_mesh {dm} scan vs python bitwise",
                out["case_i"][str(dm)]["scan_vs_python"]["bitwise"])
               for dm in MESH_CASE_I]
    checks += [(f"aggregate device_mesh 4 {s}", row["within_tolerance"])
               for s, row in out["aggregate"].items()]
    for what, ok in checks:
        if not ok:
            fail(f"phase mesh: {what} failed")
    return path


def phase_rates(src: str) -> None:
    """Warm rounds/s of the Case-I round and of the K-scale round (the
    latter only where the package has the streaming round), RATE_SAMPLES
    samples each, on each driver (None for a driver the package lacks)."""
    from repro_torch.fed import runtime
    from repro_torch.fl import Experiment

    def timed(run, rounds):
        run(rounds)                      # builds the kernels, warms up
        out = []
        for _ in range(RATE_SAMPLES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(rounds)
            torch.cuda.synchronize()
            out.append(rounds / (time.perf_counter() - t0))
        return out

    case_i, kscale, busy = {}, {}, {}
    for driver in ("python", "scan"):
        try:
            exp = Experiment(case_i_spec(), device="cuda")
            case_i[driver] = timed(
                lambda n: exp.run(n, evaluate=False, driver=driver), ROUNDS)
        except NotImplementedError:      # a tree without the scan driver
            case_i[driver] = None
        try:
            cfg, state, grad_fn, provider = kscale_case("cuda")
        except (TypeError, NotImplementedError, ImportError):
            # a tree without the streaming round or the block draws
            kscale[driver] = None
            continue

        def run_k(n):
            runtime.run(cfg, state, grad_fn, None, n, driver=driver,
                        block_batch_provider=provider)
        try:
            kscale[driver] = timed(run_k, 1)
        except NotImplementedError:
            kscale[driver] = None
            continue
        busy[driver] = _profile_top(lambda: run_k(1))
    med = lambda v: None if v is None else statistics.median(v)
    emit({"phase": "rates", "src": src,
          "case_i_warm_rounds_per_s": case_i,
          "case_i_median": {d: med(v) for d, v in case_i.items()},
          "kscale_rounds_per_s": kscale,
          "kscale_median": {d: med(v) for d, v in kscale.items()},
          "kscale_profiled_round": busy})


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser(
        description="Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.")
    ap.add_argument("--rates", action="store_true",
                    help="time only the warm Case-I and K-scale rounds")
    ap.add_argument("--driver", action="store_true",
                    help="run only the build and phase driver")
    ap.add_argument("--sweep", action="store_true",
                    help="run only the build and phases local_steps and "
                         "sweep")
    ap.add_argument("--channel", action="store_true",
                    help="run only the build and phase channel")
    ap.add_argument("--clients", action="store_true",
                    help="run only the build and phase clients")
    ap.add_argument("--obs", action="store_true",
                    help="run only the build and phase obs")
    ap.add_argument("--mesh", action="store_true",
                    help="run only the build and phase mesh")
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
    if args.driver:
        phase_driver(ops)
        return
    if args.sweep:
        phase_local_steps(ops)
        phase_sweep(ops)
        return
    if args.channel:
        phase_channel(ops)
        return
    if args.clients:
        phase_clients(ops)
        return
    if args.obs:
        phase_obs(ops)
        return
    if args.mesh:
        phase_mesh(ops)
        return
    # the 100,000-device round first, on a clean card, so that its peak
    # device memory is its own
    phase_stream(ops)
    emit_memory("stream")
    phase_launch_floor()
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
    phase_driver(ops)
    emit_memory("driver")
    phase_local_steps(ops)
    emit_memory("local_steps")
    phase_sweep(ops)
    emit_memory("sweep")
    channel_launches = phase_channel(ops)
    emit_memory("channel")
    client_launches = phase_clients(ops)
    emit_memory("clients")
    obs_launches = phase_obs(ops)
    emit_memory("obs")
    mesh_launches = phase_mesh(ops)
    emit_memory("mesh")
    # the round's kernels run on five paths: phase main's round, phase
    # channel's time-varying rounds, phase clients' two-slot rounds, phase
    # obs's recorded, saved and resumed runs and phase mesh's sharded
    # rounds and aggregates, each read from counts set to 0 before it
    round_launches = {name: main_launches[name] + channel_launches[name]
                      + client_launches[name] + obs_launches[name]
                      + mesh_launches[name] for name in PATH_KERNELS}
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
                            round_launches),
        "ota_superpose": (csrc + "ota_superpose.cu",
                          "src/repro/kernels/ota_aggregate.py:61",
                          round_launches),
        "streaming_moments": (csrc + "stream_moments.cu",
                              "src/repro/kernels/grad_norm.py:134",
                              stream_launches),
        "ota_superpose_streaming": (csrc + "ota_superpose.cu",
                                    "src/repro/kernels/ota_aggregate.py:125",
                                    stream_launches),
        "sumsq": (csrc + "moments.cu", "src/repro/kernels/grad_norm.py:50",
                  round_launches),
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
