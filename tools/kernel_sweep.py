#!/usr/bin/env python3
"""The numbers behind the kernels' split and tile choices, on one NVIDIA GPU.

    python3 tools/kernel_sweep.py [--only k1,k2,k3,k4,k5,k6,k7] [--parent DIR]

K1 (``moments_launch`` in ``csrc/moments.cu``): chunks a row around the
one ``moments_split`` picks and those that chunks of 4,096, 8,192 and
16,384 elements give K3's long rows (``stream_moments_chunks``), and 4
and 8 float4 loads in flight a thread (2 in the source), at the FL
round's, the wide and the ragged shapes, beside ``vector_norm(g, dim=1)``;
also each with the 50 MB L2 flushed before every launch.  K7
(``selective_scan_launch`` in ``csrc/selective_scan.cu``) at
``chip_smoke.SCAN_SHAPES``, with variants of the source: 1 and 4 lanes
a channel (2 in the source), the accurate expf, the first tile's loads
without their S > 0 test, 2 steps unrolled (4 in the source) and y_t's
products summed in 2 chains (1 in the source).  K5, the update norm
(``norm_launch`` in ``csrc/moments.cu``: K1's kernel over one row, the
sum of squares alone and its root in the same launch): chunk counts 1 to
54 at N = 55,050, those that 1 to 8 tiles of 512 float4s a chunk give,
and the one ``sumsq_split`` picks, at the FL rounds' N, a ragged million
and the rounds' stacks flattened, with the chunks interleaved (the
source) and contiguous, 4 loads in flight a thread, the sum of the
values reduced too, and K1's ``moments_launch`` over one row, beside
``vector_norm(x)`` and one launch's floor (``torch.cuda._sleep(0)``);
rows of a million elements and more also with the L2 flushed; the
variants at the chosen count timed again in turns.

K2 (``ota_superpose_launch`` in ``csrc/ota_superpose.cu``): the device
time of each split S of the K-way sum at the shapes its callers give it,
beside ``scale @ g``, with the S that ``superpose_split`` picks marked.
K3's short-row kernel (``csrc/stream_moments.cu``): 1, 2, 4 and 8 float4
loads in flight a lane, and CTAs of 4 or 8 warps, beside
``vector_norm(g, dim=1)``; K3's wrapper (K1's split for long rows) at the
long-row shapes.  K4 (``ota_superpose_stream_launch`` in the same source):
each number S of chunks of whole K-blocks at ``chip_smoke.STREAM_SHAPES``,
the S that ``stream_split`` picks marked, with pass 1 and the fold timed
apart (torch.profiler) where S > 1, for CTAs of 64, 128 and 256 columns,
the register bound, and 16 rows in flight.  K6's fp32 body
(``csrc/flash_attention.cu``): query and kv tile sizes at danube's and
Jamba's layers, and P V summed in one tensor-core accumulator across kv
tiles, beside ``scaled_dot_product_attention``.  ``--parent DIR`` names a
directory that holds another tree's ``moments.cu``, ``ota_superpose.cu``,
``ota_superpose_stream.cu``, ``sumsq.cu``, ``flash_attention.cu`` and
``selective_scan.cu`` (K1's, K2's, K4's, K5's two-pass, K6 fp32's and
K7's earlier designs), timed at the same shapes in the same run; K2's
splits and K4's chunkings are checked for the parent's bits (a parent
``ota_superpose.cu`` that takes the gain by value, as before the gain moved
to device memory, is bound so).  The tree's K2 and K4 read the gain from a
0-d fp32 tensor on the card.  Each variant
is checked against its plain version and for two launches giving the same
bits; ptxas's stack and spills and the number of CALL instructions in its
SASS are printed.
Device times: CUDA events over CUDA-graph replays (``chip_smoke.device_ms``;
``chip_smoke.flash_ms`` for K6).  One JSON line per result on standard
output.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
K2_SHAPES = ((20, 55_050), (1000, 2048), (1000, 55_050), (7, 1_000_003),
             (100_000, 2048))
K2_SPLITS = (1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 31, 48, 62, 96, 125, 250)
K2_MAX_ROWS = 5000       # longer chunks are far off at K = 100,000
K3_SHORT = ((100_000, 2048), (1000, 2048), (20, 2048))
K3_LONG = ((20, 55_050), (1000, 55_050), (7, 1_000_003))
K4_SPLITS = (1, 2, 3, 4, 5, 10, 20, 25, 34, 50, 100)
# K4: (columns a CTA, launch bound in CTAs an SM, rows in flight a thread)
# of each variant; the first is the tree's.  (256, 5): the register count
# ptxas picks unbounded (48); 16 rows spill at 32 registers
K4_VARIANTS = ((128, 16, 8), (64, 32, 8), (256, 8, 8), (256, 5, 8),
               (128, 16, 16))
# K6 fp32: (kBQ, kBK, kMinBlocks) of each variant; the first is the tree's
K6_TILES = ((128, 64, 1), (64, 64, 2), (64, 32, 3), (128, 32, 2))
K1_SHAPES = ((20, 55_050), (1000, 55_050), (7, 1_000_003))
K1_SPLITS = (1, 4, 6, 7, 13, 27, 52, 75, 100, 122, 150)
K3_CHUNK_ELEMS = (4096, 8192, 16384)   # K3's long rows: chunks from N alone
# K5: (K, N) of each vector, the stack flattened (K = 1: one row); the
# K-scale round's N, the Case-I round's, a ragged million, and the three
# stacks that the FL rounds' shapes give flattened
K5_SHAPES = ((1, 2048), (1, 55_050), (1, 1_000_003), (20, 55_050),
             (1000, 55_050), (100_000, 2048))
K5_SPLITS = (1, 2, 3, 6, 13, 27, 54)   # chunks at N = 55,050
K5_TILES_PER_CHUNK = (1, 2, 3, 4, 8)   # tiles of 512 float4s a chunk
L2_FLUSH_BYTES = 128 << 20       # written between launches: > the 50 MB L2
_P, _LL, _I, _F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
_K4_ARGS = [_P, _P, _P, _P, _LL, _LL, _LL, _I, _I, _P, _P, _P]
_K4_PARENT_ARGS = [_P, _P, _P, _F, _LL, _LL, _LL, _I, _P, _P, _P]
_K6_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def compile_variants(variants: dict) -> dict:
    """{name: source text} -> {name: (ctypes library, ptxas report, CALLs
    in the SASS)}, one nvcc each, started together."""
    from repro_torch.kernels import build
    out_dir = ROOT / "build" / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    procs = {}
    for name, text in variants.items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        lib = out_dir / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    cuobjdump = pathlib.Path(nvcc).with_name("cuobjdump")
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True).stdout
        libs[name] = (ctypes.CDLL(str(lib)), build.parse_ptxas(log),
                      len(re.findall(r"\bCALL\.", sass)))
        emit({"variant": name, "ptxas": libs[name][1],
              "sass_calls": libs[name][2]})
    return libs


def _superpose_inputs(gen, k, n):
    import chip_smoke as smoke
    g = smoke.test_stack(k, n, gen)
    scale = torch.rand((k,), generator=gen, device="cuda") + 0.5
    noise = 0.01 * torch.randn((n,), generator=gen, device="cuda")
    return g, scale, noise


def _superpose_tol(g, scale, noise, pre):
    """chip_smoke's rule: min(2 (K+2) eps32, 1e-5) a sum|terms| a column."""
    import chip_smoke as smoke
    k = g.shape[0]
    x = torch.sign(g) if pre == "sign" else g
    return min(2 * (k + 2) * smoke.EPS32, smoke.TERMS_RTOL) * 0.9 * (
        scale.abs() @ x.abs() + noise.abs())


def sweep_k2(libs, parent: bool, float_gain: dict) -> None:
    """Every split S of K2 at K2_SHAPES; with --parent, the parent's K2 at
    the same S beside it, checked for the same bits (one S gives the same
    chunks in both).  ``float_gain[name]``: the variant takes the gain by
    value (a parent from before the gain moved to device memory)."""
    import chip_smoke as smoke
    from repro_torch.kernels import ref
    from repro_torch.kernels.ota_aggregate import superpose_split
    gen = torch.Generator(device="cuda").manual_seed(7)
    trees = {name: libs[name][0] for name in ("k2_tree", "k2_parent")
             if name in libs and (parent or name == "k2_tree")}
    gain_dev = torch.tensor(0.9, dtype=torch.float32, device="cuda")
    gains = {}
    for name, lib in trees.items():
        by_value = float_gain.get(name, False)
        lib.ota_superpose_launch.argtypes = [_P, _P, _P, _F if by_value
                                             else _P, _LL, _LL, _I, _I,
                                             _P, _P, _P]
        gains[name] = 0.9 if by_value else gain_dev.data_ptr()
    for k, n in K2_SHAPES:
        g, scale, noise = _superpose_inputs(gen, k, n)
        want = ref.ota_superpose_ref(g, scale, noise, 0.9)
        tol = _superpose_tol(g, scale, noise, "identity")
        y = torch.empty((n,), device="cuda")
        chosen = superpose_split(k, n)
        row = {"kernel": "ota_superpose", "k": k, "n": n, "chosen_s": chosen,
               "library_ms": smoke.device_ms(lambda: scale @ g),
               "bound_ms": smoke.bound(k * n * 4 + 2 * n * 4 + k * 4,
                                       2.0 * k * n)[0], "variants": {}}
        bits = {}
        for name, lib in trees.items():
            times = row["variants"][name] = {}
            for s in sorted(set(K2_SPLITS) | {chosen}):
                rows = -(-k // s)
                if s > k or -(-k // rows) != s or rows > K2_MAX_ROWS:
                    continue
                part = torch.empty((s, n), device="cuda")

                def launch():
                    err = lib.ota_superpose_launch(
                        g.data_ptr(), scale.data_ptr(), noise.data_ptr(),
                        gains[name], k, n, s, 0, part.data_ptr(),
                        y.data_ptr(), _stream())
                    assert err == 0, err
                launch()
                first = y.clone()
                launch()
                torch.cuda.synchronize()
                # the tree and the parent give the same bits at one S
                same = bool(torch.equal(bits.setdefault(s, first), y))
                times[s] = {"ms": smoke.device_ms(launch),
                            "within_tolerance": bool(
                                ((y - want).abs() <= tol).all()),
                            "two_launches_bitwise": bool(
                                torch.equal(first, y)),
                            "same_bits_as_tree": same}
        emit(row)
        del g


def sweep_k3(libs) -> None:
    import chip_smoke as smoke
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(8)
    short = {name: lib for name, (lib, _, _) in libs.items()
             if name.startswith("k3_")}
    for lib in short.values():
        lib.stream_moments_launch.argtypes = [_P, _LL, _LL, _P, _P, _P]
    for k, n in K3_SHORT + K3_LONG:
        g = smoke.test_stack(k, n, gen)
        want = ref.batched_moments_ref(g)
        tol = smoke.TERMS_RTOL * (g.double() ** 2).sum(1)
        out = torch.empty((2, k), device="cuda")
        kb = {100_000: 1000, 1000: 100, 20: 4, 7: 1}[k]
        row = {"kernel": "streaming_moments", "k": k, "n": n, "k_block": kb,
               "library_ms": smoke.device_ms(
                   lambda: torch.linalg.vector_norm(g, dim=1)),
               "bound_ms": smoke.bound(k * n * 4 + 2 * k * 4, 3.0 * k * n)[0],
               "wrapper_ms": smoke.device_ms(
                   lambda: ops.batched_moments(g, k_block=kb, impl="kernel")),
               "variants": {}}
        for name, lib in short.items():
            if n > 4096:
                continue

            def launch():
                err = lib.stream_moments_launch(
                    g.data_ptr(), k, n, out[0].data_ptr(), out[1].data_ptr(),
                    _stream())
                assert err == 0, err
            launch()
            first = out.clone()
            launch()
            torch.cuda.synchronize()
            row["variants"][name] = {
                "ms": smoke.device_ms(launch),
                "within_tolerance": bool(((out[0] - want[0]).abs().double()
                                          <= tol).all()),
                "two_launches_bitwise": bool(torch.equal(first, out))}
        emit(row)
        del g


def _pass_and_fold_us(launch, count: int = 20) -> dict:
    """Device time a launch of K4's pass 1 and of its fold, apart
    (torch.profiler over ``count`` launches)."""
    import chip_smoke as smoke
    prof = smoke._profile_top(lambda: [launch() for _ in range(count)])
    out = {"pass1_us": 0.0, "fold_us": 0.0}
    for row in prof["top_kernels"]:
        key = "fold_us" if "fold" in row["name"] else "pass1_us"
        out[key] += row["device_us"] / count
    return out


def sweep_k4(libs, parent: bool) -> None:
    """Every number S of chunks of whole K-blocks at STREAM_SHAPES, for each
    launch bound; all of them fold the same block partials in block order,
    so all must give the same bits (and, with --parent, the parent's)."""
    import chip_smoke as smoke
    from repro_torch.kernels import ref
    from repro_torch.kernels.ota_aggregate import stream_split
    gen = torch.Generator(device="cuda").manual_seed(9)
    news = {name: lib for name, (lib, _, _) in libs.items()
            if name.startswith("k4_t")}
    gain = torch.tensor(0.9, dtype=torch.float32, device="cuda")
    for lib in news.values():
        lib.ota_superpose_stream_launch.argtypes = _K4_ARGS
    if parent:
        old = libs["k4_parent"][0]
        old.ota_superpose_stream_launch.argtypes = _K4_PARENT_ARGS
    for k, n, kb in smoke.STREAM_SHAPES:
        g, scale, noise = _superpose_inputs(gen, k, n)
        nb = k // kb
        part = torch.empty((nb, n), device="cuda")
        y = torch.empty((n,), device="cuda")
        chosen = stream_split(k, n, kb)
        row = {"kernel": "ota_superpose_streaming", "k": k, "n": n,
               "k_block": kb, "blocks": nb, "chosen_s": chosen,
               "library_ms": smoke.device_ms(lambda: scale @ g),
               "bound_ms": smoke.bound(k * n * 4 + 2 * n * 4 + k * 4,
                                       2.0 * k * n)[0], "variants": {}}
        wants = {pre: ref.ota_superpose_streaming_ref(
            g, scale, noise, 0.9, pre=pre, k_block=kb)
            for pre in ("identity", "sign")}
        tols = {pre: _superpose_tol(g, scale, noise, pre) for pre in wants}

        def launcher(lib, s, pre):
            def launch():
                if s is None:           # the parent's entry point
                    err = lib.ota_superpose_stream_launch(
                        g.data_ptr(), scale.data_ptr(), noise.data_ptr(),
                        0.9, k, n, kb, pre, part.data_ptr(), y.data_ptr(),
                        _stream())
                else:
                    err = lib.ota_superpose_stream_launch(
                        g.data_ptr(), scale.data_ptr(), noise.data_ptr(),
                        gain.data_ptr(), k, n, kb, s, pre, part.data_ptr(),
                        y.data_ptr(), _stream())
                assert err == 0, err
            return launch

        bits = {}
        for name, lib in news.items():
            splits = row["variants"][name] = {}
            for s in sorted(set(K4_SPLITS) | {chosen}):
                per = -(-nb // s)
                if (s > nb or -(-nb // per) != s
                        or (per * kb > K2_MAX_ROWS and s != chosen)):
                    continue
                entry = splits[s] = {"chosen": s == chosen}
                for i, pre in enumerate(wants):
                    launch = launcher(lib, s, i)
                    launch()
                    first = y.clone()
                    launch()
                    torch.cuda.synchronize()
                    bits.setdefault(pre, first)
                    entry[pre] = {
                        "within_tolerance": bool(
                            ((y - wants[pre]).abs() <= tols[pre]).all()),
                        "two_launches_bitwise": bool(torch.equal(first, y)),
                        "same_bits_as_other_s": bool(
                            torch.equal(bits[pre], y))}
                launch = launcher(lib, s, 0)
                entry["ms"] = smoke.device_ms(launch)
                if s > 1:
                    entry.update(_pass_and_fold_us(launch))
        if parent:
            tree = next(iter(news.values()))
            for i, pre in enumerate(wants):
                launcher(old, None, i)()
                torch.cuda.synchronize()
                row[f"bitwise_equal_to_parent_{pre}"] = bool(
                    torch.equal(bits[pre], y))
            row["parent_ms"] = smoke.device_ms(launcher(old, None, 0))
            row["chosen_ms_after_parent"] = smoke.device_ms(
                launcher(tree, chosen, 0))
        emit(row)
        del g, part


def _moments_parent_chunks(n: int) -> int:
    """The parent's K1 grid: chunks of 4,096 elements (kChunkVec)."""
    return max(1, -(-(-(-n // 4)) // 1024))


def _cold_ms(fn, flush) -> float:
    """Device time of ``fn`` with the L2 cache flushed before each call:
    the time of (flush, fn) less that of flush alone."""
    import chip_smoke as smoke
    return smoke.device_ms(lambda: (flush(), fn())) - smoke.device_ms(flush)


def sweep_k1(libs, parent: bool) -> None:
    """K1's variants at K1_SHAPES: every split of K1_SPLITS (and the chosen
    one) on the tree's source; the others at the chosen split; the parent
    at its own grid.  Each checked against the plain version, for two
    launches and two replays of one CUDA graph giving the same bits."""
    import chip_smoke as smoke
    from repro_torch.kernels import ref
    from repro_torch.kernels.grad_norm import (moments_split,
                                               stream_moments_chunks)
    gen = torch.Generator(device="cuda").manual_seed(11)
    trees = {name: lib for name, (lib, _, _) in libs.items()
             if name.startswith("k1_") and name != "k1_parent"}
    if parent:
        trees["k1_parent"] = libs["k1_parent"][0]
    for name, lib in trees.items():
        lib.moments_launch.argtypes = [_P, _LL, _LL, _I] + [_P] * (
            5 if name == "k1_parent" else 6)
    flush_buf = torch.empty((L2_FLUSH_BYTES // 4,), device="cuda")

    def flush():
        flush_buf.zero_()
    for k, n in K1_SHAPES:
        g = smoke.test_stack(k, n, gen)
        want = ref.batched_moments_ref(g)
        tol = smoke.TERMS_RTOL * (g.double() ** 2).sum(1)
        tol_s = smoke.TERMS_RTOL * g.double().abs().sum(1)
        chosen = moments_split(k, n)
        k3 = stream_moments_chunks(n)
        # K3's chunks a row at each chunk length of K3_CHUNK_ELEMS
        k3_alts = {e: -(-(-(-n // 4)) // (e // 4)) for e in K3_CHUNK_ELEMS}
        out = torch.empty((2, k), device="cuda")
        arrivals = torch.zeros((k,), dtype=torch.int32, device="cuda")

        def library():
            return torch.linalg.vector_norm(g, dim=1)
        row = {"kernel": "batched_moments", "k": k, "n": n,
               "chosen_chunks": chosen, "k3_chunks": k3,
               "k3_chunks_at": k3_alts,
               "l2_resident": k * n * 4 < 50e6,
               "library_ms": smoke.device_ms(library),
               "library_cold_ms": _cold_ms(library, flush),
               "bound_ms": smoke.bound(k * n * 4 + 2 * k * 4, 3.0 * k * n)[0],
               "variants": {}}
        for name, lib in trees.items():
            if name == "k1_parent":
                splits = (_moments_parent_chunks(n),)
            elif name == "k1_tree":
                splits = sorted(set(K1_SPLITS) | {chosen, k3}
                                | set(k3_alts.values()))
            else:
                splits = sorted({chosen, 7, 52, 100})
            times = row["variants"][name] = {}
            for c in splits:
                part = torch.empty((2, k, c), device="cuda")
                extra = () if name == "k1_parent" else (arrivals.data_ptr(),)

                def launch():
                    err = lib.moments_launch(
                        g.data_ptr(), k, n, c, part[0].data_ptr(),
                        part[1].data_ptr(), out[0].data_ptr(),
                        out[1].data_ptr(), *extra, _stream())
                    assert err == 0, err
                launch()
                first = out.clone()
                launch()
                torch.cuda.synchronize()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    launch()
                graph.replay()
                torch.cuda.synchronize()
                replay1 = out.clone()
                graph.replay()
                torch.cuda.synchronize()
                entry = times[c] = {
                    "chosen": c == chosen, "k3": c == k3,
                    "ms": smoke.device_ms(launch),
                    "within_tolerance": bool(
                        ((out[0] - want[0]).abs().double() <= tol).all()
                        and ((out[1] - want[1]).abs().double()
                             <= tol_s).all()),
                    "two_launches_bitwise": bool(torch.equal(first, out)),
                    "graph_replays_bitwise": bool(
                        torch.equal(replay1, out)
                        and torch.equal(first, out))}
                if (c in (chosen, k3, *k3_alts.values())
                        or name == "k1_parent"):
                    entry["cold_ms"] = _cold_ms(launch, flush)
                del graph, part
        emit(row)
        del g
    del flush_buf


def _k5_chunks(n: int, per: int) -> int:
    """The chunks ``sumsq_split`` would give N with ``per`` tiles a chunk
    (at least as many as one wave of CTAs needs)."""
    from repro_torch.kernels import _launch
    from repro_torch.kernels.grad_norm import MOMENTS_CTAS_PER_SM, SUMSQ_TILE
    tiles = -(-(-(-n // 4)) // SUMSQ_TILE)
    per = max(per, -(-tiles // (_launch.SMS * MOMENTS_CTAS_PER_SM)))
    return -(-tiles // per)


def _k5_contiguous(text: str) -> str:
    """K1's source with the update norm's chunks contiguous runs of the
    vector, as K1's rows are split, in place of interleaved tiles."""
    old = "  if constexpr (kNorm) {\n    v0 = (long long)j * kTile;"
    assert old in text
    return text.replace(old, "  if constexpr (false) {\n"
                             "    v0 = (long long)j * kTile;")


def _k5_with_sums(text: str) -> str:
    """K1's source with the update norm summing the values too (their
    partials written after the squares' and folded; only the final Σx is
    not stored), as K1 does."""
    text, count = re.subn(r"if constexpr \(!kNorm\)", "if constexpr (true)",
                          text)
    assert count == 8, count
    old = "x, n, nchunks, part, nullptr, sumsq, norm, arrivals);"
    assert old in text
    return text.replace(old, "x, n, nchunks, part, part + nchunks, sumsq, "
                             "norm, arrivals);")


def _alternating_ms(launches: dict, rounds: int = 3) -> dict:
    """{name: (median ms, samples)} of each launch, timed in turns, the
    order reversed every round (A B C, C B A, ...), so that no variant
    gains from where it stands in the run."""
    import chip_smoke as smoke
    names = list(launches)
    samples = {name: [] for name in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            samples[name].append(smoke.device_ms(launches[name]))
    return {name: {"median_ms": sorted(v)[len(v) // 2], "ms": v}
            for name, v in samples.items()}


def _checked_launch(launch, out, want, tol, root=True) -> dict:
    """Device time of ``launch`` (which writes the sum of squares to out[0]
    and, with ``root``, its root to out[1]), its error over chip_smoke's
    rule, and two launches and two replays of one CUDA graph compared for
    the same bits."""
    import chip_smoke as smoke
    launch()
    first = out.clone()
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        launch()
    graph.replay()
    torch.cuda.synchronize()
    replay1 = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    err = abs(float(out[0].double()) - want)
    entry = {"ms": smoke.device_ms(launch), "max_err_over_tol": err / tol,
             "within_tolerance": err <= tol,
             "two_launches_bitwise": bool(torch.equal(first, out)),
             "graph_replays_bitwise": bool(torch.equal(replay1, out)
                                           and torch.equal(first, out))}
    if root:
        entry["root_is_sqrt"] = bool(torch.equal(out[1],
                                                 torch.sqrt(out[0])))
    del graph
    return entry


def sweep_k5(libs, parent: bool) -> None:
    """The update norm at K5_SHAPES (``norm_launch``: K1's kernel over one
    row, the sum of squares alone and its root): at the chunk counts of
    K5_SPLITS, of K5_TILES_PER_CHUNK tiles a chunk and the one
    ``sumsq_split`` picks, with the chunks interleaved tile by tile (the
    tree) and contiguous; at the chosen count also 4 loads in flight a
    thread, the sum of the values reduced too, and K1's own
    ``moments_launch`` over one row (the sum of the values, no root; also
    at ``moments_split(1, n)``'s count); with --parent the parent's
    two-pass kernel (``sumsq_launch``), alone and with the root its
    ``ops.grad_norm`` took after it; beside ``vector_norm(x)`` and one
    launch's floor (``torch.cuda._sleep(0)``).  Each checked against the
    plain version (chip_smoke's rule), its root against ``torch.sqrt`` of
    its sum of squares, for two launches and two replays of one CUDA
    graph giving the same bits; rows of a million elements and more also
    with the L2 flushed before each launch.  The variants at the chosen
    count are timed again in turns (``alternating``)."""
    import chip_smoke as smoke
    from repro_torch.kernels import ref
    from repro_torch.kernels.grad_norm import moments_split, sumsq_split
    gen = torch.Generator(device="cuda").manual_seed(13)
    trees = {name: libs[name][0] for name in (
        "k5_tree", "k5_contiguous", "k5_u4", "k5_with_sums")}
    for lib in trees.values():
        lib.norm_launch.argtypes = [_P, _LL, _I] + [_P] * 5
    k1 = trees["k5_tree"]
    k1.moments_launch.argtypes = [_P, _LL, _LL, _I] + [_P] * 6
    two_pass = libs["k5_parent"][0] if parent else None
    if two_pass is not None:
        two_pass.sumsq_num_partials.argtypes = [_LL]
        two_pass.sumsq_num_partials.restype = _I
        two_pass.sumsq_launch.argtypes = [_P, _LL, _I, _P, _P, _P]
    flush_buf = torch.empty((L2_FLUSH_BYTES // 4,), device="cuda")

    def flush():
        flush_buf.zero_()

    def sleep0():
        torch.cuda._sleep(0)
    emit({"kernel": "launch_floor", "call": "torch.cuda._sleep(0)",
          "ms": smoke.device_ms(sleep0)})
    for k, n in K5_SHAPES:
        x = smoke.test_stack(k, n, gen).reshape(-1)
        size = x.shape[0]
        want = float(ref.grad_norm_ref(x).double() ** 2)
        tol = smoke.TERMS_RTOL * float((x.double() ** 2).sum())
        chosen = sumsq_split(size)
        cold = size >= 1_000_000
        out = torch.empty((2,), device="cuda")
        arrivals = torch.zeros((1,), dtype=torch.int32, device="cuda")

        def library():
            return torch.linalg.vector_norm(x)
        row = {"kernel": "sumsq", "k": k, "n": n, "size": size,
               "chosen_chunks": chosen,
               "moments_split_chunks": moments_split(1, size),
               "l2_resident": size * 4 < 50e6,
               "library_ms": smoke.device_ms(library),
               "bound_ms": smoke.bound(size * 4 + 4, 2.0 * size)[0],
               "variants": {}}
        if cold:
            row["library_cold_ms"] = _cold_ms(library, flush)
        splits = {chosen} | {_k5_chunks(size, p) for p in K5_TILES_PER_CHUNK}
        if size == 55_050:
            splits |= set(K5_SPLITS)

        def norm_launcher(lib, c):
            part = torch.empty((2 * c,), device="cuda")

            def launch():
                err = lib.norm_launch(
                    x.data_ptr(), size, c, part.data_ptr(),
                    out[0].data_ptr(), out[1].data_ptr(),
                    arrivals.data_ptr(), _stream())
                assert err == 0, err
            return launch

        def k1_launcher(c):
            part = torch.empty((2, c), device="cuda")

            def launch():
                err = k1.moments_launch(
                    x.data_ptr(), 1, size, c, part[0].data_ptr(),
                    part[1].data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                    arrivals.data_ptr(), _stream())
                assert err == 0, err
            return launch
        at_chosen = {}
        for name, lib in trees.items():
            times = row["variants"][name] = {}
            scan = name in ("k5_tree", "k5_contiguous")
            for c in sorted(splits) if scan else (chosen,):
                launch = norm_launcher(lib, c)
                entry = times[c] = {"chosen": c == chosen,
                                    **_checked_launch(launch, out, want, tol)}
                if c == chosen:
                    at_chosen[name] = launch
                    if cold:
                        entry["cold_ms"] = _cold_ms(launch, flush)
        times = row["variants"]["k1_moments_launch"] = {}
        for c in sorted({chosen, moments_split(1, size)}):
            launch = k1_launcher(c)
            times[c] = {"chosen": c == chosen,
                        **_checked_launch(launch, out, want, tol,
                                          root=False)}
            if c == chosen:
                at_chosen["k1_moments_launch"] = launch
        if two_pass is not None:
            nparts = two_pass.sumsq_num_partials(size)
            part = torch.empty((nparts,), device="cuda")

            def launch_two_pass():
                err = two_pass.sumsq_launch(x.data_ptr(), size, nparts,
                                            part.data_ptr(),
                                            out[0].data_ptr(), _stream())
                assert err == 0, err

            def parent_grad_norm():
                launch_two_pass()
                return torch.sqrt(out[0])
            entry = row["variants"]["k5_parent"] = {
                "partials": nparts,
                **_checked_launch(launch_two_pass, out, want, tol,
                                  root=False),
                "with_root_ms": smoke.device_ms(parent_grad_norm)}
            if cold:
                entry["cold_ms"] = _cold_ms(launch_two_pass, flush)
            at_chosen["k5_parent"] = launch_two_pass
            at_chosen["k5_parent_with_root"] = parent_grad_norm
        row["alternating"] = _alternating_ms(at_chosen)
        emit(row)
        del x, at_chosen
        torch.cuda.empty_cache()
    del flush_buf


def _scan_tol(args):
    """chip_smoke's rule: SCAN_RTOL * the plain scan of |u|, dt, a, |B|,
    |C|."""
    import chip_smoke as smoke
    from repro_torch.kernels import ops
    u, dt, a, bm, cm = args
    return smoke.SCAN_RTOL * ops.selective_scan(
        u.abs(), dt, a, bm.abs(), cm.abs(), impl="plain")


def sweep_k7(libs) -> None:
    """K7's variants at chip_smoke.SCAN_SHAPES, bf16 and fp32, the parent
    among them.  Each checked against the plain version and for two
    launches giving the same bits."""
    import chip_smoke as smoke
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(12)
    trees = {name: lib for name, (lib, _, _) in libs.items()
             if name.startswith("k7_")}
    for lib in trees.values():          # the parent's entry point too
        lib.selective_scan_launch.argtypes = [_P] * 7 + [_I] * 5 + [_P]
    for shape in smoke.SCAN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            b, s, d, n, draw = shape
            if dtype == torch.float32 and (b, s) != (4, 8192):
                continue
            args = smoke.scan_inputs(shape, dtype, gen)
            u, dt, a, bm, cm = args
            want = ops.selective_scan(*args, impl="plain")
            tol = _scan_tol(args)
            y = torch.empty((b, s, d), device="cuda")
            row = {"kernel": "selective_scan", "dtype": str(dtype)[6:],
                   "shape": list(shape),
                   "bound_ms": smoke.scan_bound(shape, dtype)[0],
                   "variants": {}}
            for name, lib in trees.items():
                def launch():
                    err = lib.selective_scan_launch(
                        u.data_ptr(), dt.data_ptr(), a.data_ptr(),
                        bm.data_ptr(), cm.data_ptr(), y.data_ptr(), None,
                        b, s, d, n, int(dtype == torch.bfloat16), _stream())
                    assert err == 0, err
                launch()
                first = y.clone()
                launch()
                torch.cuda.synchronize()
                err = (y - want).abs()
                row["variants"][name] = {
                    "ms": smoke.flash_ms(launch),
                    "within_tolerance": bool((err <= tol).all()),
                    "max_err_over_tol": float((err / tol).max()),
                    "two_launches_bitwise": bool(torch.equal(first, y))}
            emit(row)
            del args, u, dt, a, bm, cm, want, tol, y
            torch.cuda.empty_cache()


def _set_constants(text: str, **values) -> str:
    """``text`` with each ``constexpr int NAME = ...;`` set to values[NAME]."""
    for name, value in values.items():
        text, count = re.subn(rf"constexpr int {name} = [^;]+;",
                              f"constexpr int {name} = {value};", text)
        assert count == 1, name
    return text


def k6_one_accumulator(text: str) -> str:
    """The fp32 body with P V summed on the tensor cores in O itself across
    all kv tiles, as first built: the variant that missed the fp32 rule."""
    out = text.replace(
        "for (int e = 0; e < 4; ++e) pv[j][e] = 0.f;",
        "for (int e = 0; e < 4; ++e)\n"
        "          pv[j][e] = acc[j0 + j][e] * (e < 2 ? corr_a : corr_b);")
    for e, corr in ((0, "a"), (1, "a"), (2, "b"), (3, "b")):
        out = out.replace(
            f"acc[j0 + j][{e}] = acc[j0 + j][{e}] * corr_{corr} + pv[j][{e}];",
            f"acc[j0 + j][{e}] = pv[j][{e}];")
    assert out.count("= pv[j][") == 4
    return out


def sweep_k6(libs) -> None:
    """The fp32 body's variants (and the parent's, under --parent) at
    danube's and Jamba's attention layers, B = 4."""
    import chip_smoke as smoke
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(10)
    bodies = {name: lib for name, (lib, _, _) in libs.items()
              if name.startswith("k6_")}
    for lib in bodies.values():
        lib.flash_attention_launch.argtypes = _K6_ARGS
    for shape in (smoke.FLASH_SHAPES[0], smoke.FLASH_SHAPES[2]):
        b, h, hkv, sq, skv, d, causal, window = shape
        q = torch.randn((b, h, sq, d), generator=gen, device="cuda")
        k, v = (torch.randn((b, hkv, skv, d), generator=gen, device="cuda")
                for _ in range(2))
        want = ops.flash_attention(q, k, v, causal=causal, window=window,
                                   impl="plain")
        tol = smoke.flash_tol(want, torch.float32)
        o = torch.empty_like(q)
        ke = torch.repeat_interleave(k, h // hkv, dim=1)
        ve = torch.repeat_interleave(v, h // hkv, dim=1)
        if window:
            i = torch.arange(sq, device="cuda")[:, None]
            j = torch.arange(skv, device="cuda")[None, :]
            mask = (j <= i) & (i - j < window)

            def library():
                return F.scaled_dot_product_attention(q, ke, ve,
                                                      attn_mask=mask)
        else:
            def library():
                return F.scaled_dot_product_attention(q, ke, ve,
                                                      is_causal=causal)
        args = smoke.flash_bound(*shape, torch.float32)
        row = {"kernel": "flash_attention", "dtype": "float32",
               "shape": list(shape), "bound_ms": args[0],
               "bound_fp32_cores_ms": smoke.flash_bound(
                   *shape, torch.float32, fp32_cores=True)[0],
               "library_ms": smoke.flash_ms(library), "variants": {}}
        del ke, ve
        for name, lib in bodies.items():
            def launch():
                err = lib.flash_attention_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    b, h, hkv, sq, skv, d, int(causal), window or 0,
                    int(sq <= skv), 1.0 / math.sqrt(d), _stream())
                assert err == 0, err
            launch()
            first = o.clone()
            launch()
            torch.cuda.synchronize()
            err = (o - want).abs()
            row["variants"][name] = {
                "ms": smoke.flash_ms(launch),
                "within_tolerance": bool((err <= tol).all()),
                "max_err_over_tol": float((err / tol).max()),
                "two_launches_bitwise": bool(torch.equal(first, o))}
            del first, err
        emit(row)
        del q, k, v, o, want, tol
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="k1,k2,k3,k4,k5,k6,k7",
                    help="comma-separated sweeps to run (default: all)")
    ap.add_argument("--parent", help="directory with another tree's "
                    "moments.cu, ota_superpose.cu, ota_superpose_stream.cu, "
                    "sumsq.cu, flash_attention.cu and selective_scan.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_sweep: needs an NVIDIA GPU")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    only = set(args.only.split(","))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    torch.backends.cuda.matmul.allow_tf32 = False
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    k2 = (csrc / "ota_superpose.cu").read_text()
    k3 = (csrc / "stream_moments.cu").read_text()
    k6 = (csrc / "flash_attention.cu").read_text()
    par = pathlib.Path(args.parent) if args.parent else None
    variants = {}
    if "k1" in only:
        k1 = (csrc / "moments.cu").read_text()
        variants["k1_tree"] = k1
        for unroll in (4, 8):
            variants[f"k1_u{unroll}"] = _set_constants(k1, kUnroll=unroll)

        if par:
            variants["k1_parent"] = (par / "moments.cu").read_text()
    if "k5" in only:
        k1 = (csrc / "moments.cu").read_text()
        variants["k5_tree"] = k1
        variants["k5_contiguous"] = _k5_contiguous(k1)
        variants["k5_u4"] = _set_constants(k1, kUnroll=4)
        variants["k5_with_sums"] = _k5_with_sums(k1)
        if par:
            variants["k5_parent"] = (par / "sumsq.cu").read_text()
    if "k7" in only:
        k7 = (csrc / "selective_scan.cu").read_text()
        variants["k7_tree"] = k7
        variants["k7_expf"] = k7.replace(
            'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));',
            "r = expf(x * 0.6931471805599453f);")
        assert variants["k7_expf"] != k7
        variants["k7_unguarded"] = k7.replace("  if (S > 0) load(0);",
                                              "  load(0);")
        assert variants["k7_unguarded"] != k7
        variants["k7_one_lane"] = _set_constants(k7, kLanes=1)
        variants["k7_four_lanes"] = _set_constants(k7, kLanes=4)
        variants["k7_unroll2"] = _set_constants(k7, kUnroll=2)
        variants["k7_acc2"] = _set_constants(k7, kAcc=2)
        if par:
            variants["k7_parent"] = (par / "selective_scan.cu").read_text()
    if "k2" in only:
        variants["k2_tree"] = k2
        if par:
            variants["k2_parent"] = (par / "ota_superpose.cu").read_text()
    if "k3" in only:
        for unroll in (1, 2, 4, 8):
            for threads in (128, 256):
                variants[f"k3_u{unroll}_t{threads}"] = k3.replace(
                    "kUnroll = 4;", f"kUnroll = {unroll};").replace(
                    "kThreads = 128;", f"kThreads = {threads};")
    if "k4" in only:
        for threads, ctas, rows in K4_VARIANTS:
            variants[f"k4_t{threads}_b{ctas}_r{rows}"] = _set_constants(
                k2, kStreamThreads=threads, kStreamCtasPerSm=ctas,
                kRowsInFlight=rows)
        if par:
            variants["k4_parent"] = (par / "ota_superpose_stream.cu"
                                     ).read_text()
    if "k6" in only:
        for bq, bk, mb in K6_TILES:
            variants[f"k6_q{bq}_k{bk}_b{mb}"] = _set_constants(
                k6, kBQ=bq, kBK=bk, kMinBlocks=mb)
        variants["k6_one_accumulator"] = k6_one_accumulator(k6)
        if par:
            variants["k6_parent"] = (par / "flash_attention.cu").read_text()
    libs = compile_variants(variants)
    if "k1" in only:
        sweep_k1(libs, par is not None)
    if "k5" in only:
        sweep_k5(libs, par is not None)
    if "k7" in only:
        sweep_k7(libs)
    if "k2" in only:
        sweep_k2(libs, par is not None,
                 {name: "const float* a" not in variants[name]
                  for name in ("k2_tree", "k2_parent") if name in variants})
    if "k3" in only:
        sweep_k3(libs)
    if "k4" in only:
        sweep_k4(libs, par is not None)
    if "k6" in only:
        sweep_k6(libs)


if __name__ == "__main__":
    main()
