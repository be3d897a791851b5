#!/usr/bin/env python3
"""The FL-device mesh over real ranks: one process a rank, one card a rank
(NCCL), or the CPU (gloo) for a rehearsal.

    python3 tools/mesh_ranks.py [--ranks 4] [--device cuda|cpu]
        > chiprun_out/mesh_ranks.jsonl

Every rank joins one ``torch.distributed`` group on 127.0.0.1 (NCCL on
``cuda:<rank>``, gloo on the CPU) and runs, on its own device:

``sharded``  the sharded streaming round with ``device_mesh`` = the rank
             count on the physical path (a rank a shard: each rank folds
             its own K-blocks, the carries gathered, ``fold_shards``), for
             Case I (``chip_smoke.case_i_spec``, k_block 5: one K-block a
             shard at 4 ranks, 20 rounds with eval) and the K-scale round
             (``chip_smoke.kscale_case``, K = 100,000, k_block 1,000: 25
             K-blocks a shard at 4 ranks; 3 rounds, then MESH_RATE_ROUNDS
             timed).  Rank 0 then runs the same configs on the emulated
             path (``REPRO_FL_MESH=emulate``: the shards in turn on its one
             device, the scan driver's CUDA graph on a card).  Checked:
             every rank's params and history bitwise the emulated run's;
             rounds/s of both.
``mesh``     the ``mesh`` backend with K = the rank count: ``ota.aggregate(
             backend="mesh")`` (``ota_psum``: one all-reduce) for every
             scheme, noisy, with a CSI estimate, against the vmap aggregate
             on rank 0's device at the reference's cross-backend tolerance
             (rtol 2e-4, atol 2e-5), the same bits on every rank; then 10
             rounds of a ridge FL run on the mesh backend under both
             drivers (bitwise) against the vmap backend.

Rank 0 prints one JSON line per part; the exit code is 1 if a check fails.
On cards the kernels are built once before the ranks start, NCCL's
bootstrap stays on the loopback interface, and the cards' names and power
limits head the output.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESH_RATE_ROUNDS = 6
BACKEND_TOL = dict(rtol=2e-4, atol=2e-5)


def _bitwise(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k].cpu(), b[k].cpu()) for k in b)


def _hist(h: dict) -> dict:
    from repro_torch.fed import runtime
    return {k: list(h[k]) for k in runtime.DIAG_KEYS}


def _same_everywhere(params: dict) -> bool:
    """Whether every rank holds the same bits as rank 0."""
    ok = True
    for k in sorted(params):
        mine = params[k].contiguous()
        parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, mine)
        ok = ok and all(torch.equal(p, parts[0]) for p in parts)
    return ok


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def part_sharded(ranks: int, device: torch.device) -> dict:
    import dataclasses
    import chip_smoke as cs
    from repro_torch.fed import runtime
    from repro_torch.fl import Experiment
    out = {"part": "sharded", "ranks": ranks}
    runs = {}
    for mode in ("physical", "emulated"):
        if mode == "emulated":
            os.environ["REPRO_FL_MESH"] = "emulate"
            if dist.get_rank() != 0:
                break
        runtime.clear_compile_caches()
        spec = dataclasses.replace(cs.case_i_spec(), k_block=5,
                                   device_mesh=ranks)
        e = Experiment(spec, device=device)
        t0 = time.perf_counter()
        e.run(cs.ROUNDS)
        _sync(device)
        case_s = time.perf_counter() - t0
        cfg, state, grad_fn, provider = cs.kscale_case(str(device))
        cfg = dataclasses.replace(cfg, device_mesh=ranks)
        state, first = runtime.run(cfg, state, grad_fn, None,
                                   cs.STREAM_ROUNDS,
                                   block_batch_provider=provider)
        kparams = {k: v.clone() for k, v in state.params.items()}
        _sync(device)
        t1 = time.perf_counter()
        runtime.run(cfg, state, grad_fn, None, MESH_RATE_ROUNDS,
                    block_batch_provider=provider)
        _sync(device)
        rate = MESH_RATE_ROUNDS / (time.perf_counter() - t1)
        runs[mode] = dict(case_params=e.params, case_hist=e.history,
                          kparams=kparams, khist=_hist(first))
        out[mode] = {"case_i_20_rounds_s": case_s,
                     "kscale_rounds_per_s": rate,
                     "eager_on_card": runtime.cache_info()["eager_on_card"]}
    os.environ.pop("REPRO_FL_MESH", None)
    phys = runs["physical"]
    out["physical_same_on_every_rank"] = (
        _same_everywhere(phys["case_params"])
        and _same_everywhere(phys["kparams"]))
    if dist.get_rank() == 0:
        emu = runs["emulated"]
        out["case_i_bitwise"] = (
            _bitwise(phys["case_params"], emu["case_params"])
            and phys["case_hist"] == emu["case_hist"])
        out["kscale_bitwise"] = (_bitwise(phys["kparams"], emu["kparams"])
                                 and phys["khist"] == emu["khist"])
    return out


def part_mesh(ranks: int, device: torch.device) -> dict:
    from repro_torch.core import ota, schemes
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.fed import runtime
    out = {"part": "mesh", "ranks": ranks, "aggregate": {}}
    rng = np.random.default_rng(0)
    shapes = {"p0": (9, 5), "p1": (33,), "p2": (4, 3, 2)}
    g = {n: torch.from_numpy(rng.standard_normal((ranks,) + s).astype(
        np.float32)).to(device) for n, s in shapes.items()}
    h, b = (torch.from_numpy((np.abs(rng.standard_normal(ranks)) + c).astype(
        np.float32)).to(device) for c in (0.1, 0.5))
    h_hat = h * (1.0 + 0.1 * torch.from_numpy(rng.standard_normal(
        ranks).astype(np.float32)).to(device))
    z = 0.05 * torch.from_numpy(rng.standard_normal(sum(
        int(np.prod(s)) for s in shapes.values())).astype(np.float32))
    ok = True
    for scheme in schemes.names():
        kw = dict(scheme=scheme, a=1.3, noise_var=2.5e-3, grad_bound=7.5)
        got = ota.aggregate(ota.OTAConfig(backend="mesh", **kw), g, h, b,
                            h_hat=h_hat, noise=z)
        want = ota.aggregate(ota.OTAConfig(**kw), g, h, b, h_hat=h_hat,
                             noise=z)
        close = all(torch.allclose(got[k], want[k], **BACKEND_TOL)
                    for k in want)
        same = _same_everywhere(got)
        gap = max(float((got[k] - want[k]).abs().max()) for k in want)
        out["aggregate"][scheme] = {"within_tolerance": close,
                                    "same_on_every_rank": same,
                                    "max_abs_diff_vs_vmap": gap}
        ok = ok and close and same
    d = 6
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (48, d)).astype(np.float32)).to(device)
    y = x @ torch.linspace(0.5, 1.5, d, device=device)

    def grad_fn(params, batch):
        xb, yb = batch
        r = xb @ params["w"] - yb
        return {"w": xb.T @ r / r.shape[0]}

    def provider(t):
        idx = torch.from_numpy(np.random.default_rng([5, t]).integers(
            0, 48, (ranks, 6))).to(device)
        return x[idx], y[idx]

    fl = {}
    for name, backend, driver in (("mesh_scan", "mesh", "scan"),
                                  ("mesh_python", "mesh", "python"),
                                  ("vmap", "vmap", "scan")):
        cfg = runtime.FLConfig(
            num_devices=ranks, scheme="benchmark2", case="I", seed=0,
            grad_bound=10.0, backend=backend,
            channel=ChannelConfig(num_devices=ranks, noise_var=1e-6))
        st = runtime.setup(cfg, {"w": torch.zeros(d, device=device)}, d)
        _, hist = runtime.run(cfg, st, grad_fn, provider, 10, driver=driver,
                              chunk_size=4)
        fl[name] = (st.params, _hist(hist))
    out["fl_scan_vs_python_bitwise"] = (
        _bitwise(fl["mesh_scan"][0], fl["mesh_python"][0])
        and fl["mesh_scan"][1] == fl["mesh_python"][1])
    out["fl_vs_vmap_within_tolerance"] = torch.allclose(
        fl["mesh_scan"][0]["w"], fl["vmap"][0]["w"], **BACKEND_TOL)
    out["fl_same_on_every_rank"] = _same_everywhere(fl["mesh_scan"][0])
    out["ok"] = bool(ok and out["fl_scan_vs_python_bitwise"]
                     and out["fl_vs_vmap_within_tolerance"]
                     and out["fl_same_on_every_rank"])
    return out


def worker(rank: int, ranks: int, kind: str, port: int, failed) -> None:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    if kind == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
        backend = "nccl"
    else:
        torch.set_num_threads(1)
        device = torch.device("cpu")
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=ranks, rank=rank)
    try:
        sharded = part_sharded(ranks, device)
        dist.barrier()
        mesh = part_mesh(ranks, device)
        dist.barrier()
        if rank == 0:
            for line in (sharded, mesh):
                print(json.dumps(line), flush=True)
            if not (sharded["case_i_bitwise"] and sharded["kscale_bitwise"]
                    and sharded["physical_same_on_every_rank"]
                    and mesh["ok"]):
                failed.value = 1
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    if args.device == "cuda":
        if torch.cuda.device_count() < args.ranks:
            sys.exit(f"needs {args.ranks} cards, have "
                     f"{torch.cuda.device_count()}")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
        # NCCL's bootstrap on the loopback interface only; the kernels are
        # built once here, before the ranks load them
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.kernels import build
        build.build_all()
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    failed = mp.get_context("spawn").Value("i", 0)
    mp.spawn(worker, args=(args.ranks, args.device, port, failed),
             nprocs=args.ranks)
    sys.exit(failed.value)


if __name__ == "__main__":
    main()
