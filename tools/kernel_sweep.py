#!/usr/bin/env python3
"""The numbers behind the split choices of K2 and K3, on one NVIDIA GPU.

    python3 tools/kernel_sweep.py [--parent DIR]

K2 (``csrc/ota_superpose.cu``): the device time of each split S of the
K-way sum at the shapes its callers give it, with 8 or 16 rows' loads in
flight, beside ``scale @ g``, with the S that ``superpose_split`` picks
marked.  K3's short-row kernel
(``csrc/stream_moments.cu``): 1, 2, 4 and 8 float4 loads in flight a lane,
and CTAs of 4 or 8 warps, beside ``vector_norm(g, dim=1)``; K3's wrapper
(K1's split for long rows) at the long-row shapes.  ``--parent DIR`` names
a directory that holds another tree's ``ota_superpose.cu`` and
``stream_moments.cu`` (earlier designs), timed at the same shapes in the
same run.  Each variant is checked against its plain version and for two
launches giving the same bits; ptxas's stack and spills and the number of
CALL instructions in its SASS are printed.  Device times: CUDA events over
CUDA-graph replays (``chip_smoke.device_ms``).  One JSON line per result
on standard output.
"""
from __future__ import annotations

import argparse
import ctypes
import json
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
_P, _LL, _I, _F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def sweep_k2(libs, parent: bool) -> None:
    import chip_smoke as smoke
    from repro_torch.kernels import ref
    from repro_torch.kernels.ota_aggregate import superpose_split
    gen = torch.Generator(device="cuda").manual_seed(7)
    news = {name: lib for name, (lib, _, _) in libs.items()
            if name.startswith("k2_v")}
    for lib in news.values():
        lib.ota_superpose_launch.argtypes = [_P, _P, _P, _F, _LL, _LL, _I, _I,
                                             _P, _P, _P]
    if parent:
        old = libs["k2_parent"][0]
        old.ota_superpose_launch.argtypes = [_P, _P, _P, _F, _LL, _LL, _I, _P,
                                             _P]
    for k, n in K2_SHAPES:
        g = smoke.test_stack(k, n, gen)
        scale = torch.rand((k,), generator=gen, device="cuda") + 0.5
        noise = 0.01 * torch.randn((n,), generator=gen, device="cuda")
        want = ref.ota_superpose_ref(g, scale, noise, 0.9)
        tol = min(2 * (k + 2) * smoke.EPS32, smoke.TERMS_RTOL) * 0.9 * (
            scale.abs() @ g.abs() + noise.abs())
        y = torch.empty((n,), device="cuda")
        chosen = superpose_split(k, n)
        row = {"kernel": "ota_superpose", "k": k, "n": n, "chosen_s": chosen,
               "library_ms": smoke.device_ms(lambda: scale @ g),
               "bound_ms": smoke.bound(k * n * 4 + 2 * n * 4 + k * 4,
                                       2.0 * k * n)[0], "variants": {}}
        bits = {}
        for name, lib in news.items():
            times = row["variants"][name] = {}
            for s in sorted(set(K2_SPLITS) | {chosen}):
                rows = -(-k // s)
                if s > k or -(-k // rows) != s or rows > K2_MAX_ROWS:
                    continue
                part = torch.empty((s, n), device="cuda")

                def launch():
                    err = lib.ota_superpose_launch(
                        g.data_ptr(), scale.data_ptr(), noise.data_ptr(), 0.9,
                        k, n, s, 0, part.data_ptr(), y.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                    assert err == 0, err
                launch()
                first = y.clone()
                launch()
                torch.cuda.synchronize()
                # every variant of one S gives the same bits
                same = bool(torch.equal(bits.setdefault(s, first), y))
                ok = (bool(((y - want).abs() <= tol).all())
                      and bool(torch.equal(first, y)) and same)
                times[s] = [smoke.device_ms(launch), ok]
        if parent:
            def launch_old():
                old.ota_superpose_launch(
                    g.data_ptr(), scale.data_ptr(), noise.data_ptr(), 0.9, k,
                    n, 0, y.data_ptr(), torch.cuda.current_stream().cuda_stream)
            row["parent_ms"] = smoke.device_ms(launch_old)
            # the order of the timings: the chosen S once more, after
            lib = next(iter(news.values()))
            part = torch.empty((chosen, n), device="cuda")
            row["chosen_ms_after_parent"] = smoke.device_ms(
                lambda: lib.ota_superpose_launch(
                    g.data_ptr(), scale.data_ptr(), noise.data_ptr(), 0.9, k,
                    n, chosen, 0, part.data_ptr(), y.data_ptr(),
                    torch.cuda.current_stream().cuda_stream))
        emit(row)
        del g


def sweep_k3(libs, parent: bool) -> None:
    import chip_smoke as smoke
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(8)
    short = {name: lib for name, (lib, _, _) in libs.items()
             if name.startswith("k3_")}
    for name, lib in short.items():
        lib.stream_moments_launch.argtypes = (
            [_P, _LL, _LL, _LL, _P, _P, _P] if name == "k3_parent"
            else [_P, _LL, _LL, _P, _P, _P])
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
            if n > 4096 and name != "k3_parent":
                continue
            args = ((k, n, kb) if name == "k3_parent" else (k, n))

            def launch():
                err = lib.stream_moments_launch(
                    g.data_ptr(), *args, out[0].data_ptr(), out[1].data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="directory with another tree's "
                    "ota_superpose.cu and stream_moments.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_sweep: needs an NVIDIA GPU")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    k3 = (csrc / "stream_moments.cu").read_text()
    k2 = (csrc / "ota_superpose.cu").read_text()
    variants = {}
    for unroll in (8, 16):
        variants[f"k2_v1_u{unroll}"] = k2.replace(
            "#pragma unroll 8\n  for (long long i",
            f"#pragma unroll {unroll}\n  for (long long i")
    for unroll in (1, 2, 4, 8):
        for threads in (128, 256):
            variants[f"k3_u{unroll}_t{threads}"] = k3.replace(
                "kUnroll = 4;", f"kUnroll = {unroll};").replace(
                "kThreads = 128;", f"kThreads = {threads};")
    if args.parent:
        par = pathlib.Path(args.parent)
        variants["k2_parent"] = (par / "ota_superpose.cu").read_text()
        variants["k3_parent"] = (par / "stream_moments.cu").read_text()
    libs = compile_variants(variants)
    sweep_k2(libs, bool(args.parent))
    sweep_k3(libs, bool(args.parent))


if __name__ == "__main__":
    main()
