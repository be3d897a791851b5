#!/usr/bin/env python3
"""The serving mesh over real ranks, and the sweep engine's experiment axis
over real cards: one process a rank, one card a rank (NCCL), or the CPU
(gloo) for a rehearsal.

    python3 tools/serve_ranks.py [--ranks 4] [--device cuda|cpu]
        [--parts whole,parity,train,fsdp,zoo,pod,sweep] > serve_ranks.jsonl

Every rank joins one ``torch.distributed`` group on 127.0.0.1 (NCCL on
``cuda:<rank>``, gloo on the CPU), builds the physical ``(1, ranks)`` mesh
(``launch.mesh.make_host_mesh``; ``train``: ``(ranks / 2, 2)``) and runs,
on its own device:

``whole``   jamba-v0.1-52b at full width and depth (32 layers, 51.6 B
            parameters, 103 GB in bf16) over ``model = ranks``: each rank
            draws its shard of the weights a leaf at a time
            (``transformer.init_sharded_params``, one seed), then 4 prompts
            of 8,192 tokens are prefilled with the decode cache (one warm-up
            and ``PREFILL_SAMPLES`` timed) and 32 greedy steps decoded;
            prefill tokens/s, decode ms a step, each card's peak memory,
            the same ids on every rank;
``parity``  one superblock (8 layers) at full width, the same prompts, a
            prefill and 8 greedy steps on the physical mesh; then each rank
            runs the whole mesh emulated on its own card (every rank in
            turn, the same seed) and holds its own ids and cache shard to
            the emulated rank's, bitwise;
``train``   granite-moe-1b-a400m at full width and depth (24 layers, 1.385
            B parameters, bf16) trained by ``ranks / 2`` FL clients, each
            cut over 2 model ranks (``launch.train.build_train_step``,
            ``normalized`` with the example's channel, 4 x 1,024 tokens a
            client): two warm-up steps (noiseless, then seeded noisy),
            ``TRAIN_STEPS`` timed noiseless steps, ``TRAIN_STEPS`` seeded
            noisy steps (each rank draws its pieces of the noise on its
            card) and one with the noise drawn on the host and injected
            (the whole tree's, as the step drew it before the noise
            kernel); s a step, each card's peak memory; then each rank
            runs the same steps on the mesh
            emulated on its own card and holds its shard of the params and
            of the optimizer state to the emulated rank's, bitwise;
``fsdp``    granite-moe-1b-a400m whole (bf16) on the mean path over the
            physical ``(ranks / 2, 2)`` mesh (sgd with momentum, one warm-up
            and ``TRAIN_STEPS`` timed steps), without and with
            ``fsdp_axis="data"``, each rank's shard drawn alone
            (``init_sharded_params``) and the other run's results on the
            host: s a step and each card's peak memory of each, each
            rank's FSDP slices the bits of its plain shard's; then the
            FSDP steps on the mesh emulated on each card, bitwise;
``pod``     granite-moe-1b-a400m at 6 of its 24 layers (bf16; the mesh
            emulated on one card holds four ranks' gradients) over the
            physical ``(pod 2,
            data ranks / 2, model 1)`` mesh: a client a pod
            (``aggregation_axes=("pod",)``: the pod's data ranks split its
            rows), a client a (pod, data) rank, and the mean path with
            FSDP over ``("pod", "data")``; one warm-up and ``TRAIN_STEPS``
            timed steps each, then the same on the mesh emulated on each
            card: each rank's shard of the params and momentum, bitwise;
``zoo``     xlstm-1.3b (4 x 2,048 tokens) and seamless-m4t-medium (4 x
            8,192 tokens over 2,048 stub frames) whole over the physical
            ``(1, ranks)`` mesh, bf16: a prefill and ``PARITY_STEPS``
            greedy steps (after a warm-up), prefill tokens/s, decode ms a
            step, each card's peak; then the mesh emulated on each card:
            the same ids and the rank's cache shard, bitwise.

Then this process runs ``sweep``: the fig1a grid (Case I, amplification
{optimal, bmax} x 3 seeds: 2 groups of 3 lanes, spread over 3 cards) and
the sweep headline (Case II, noise_var {s2, 2 s2} x 4 seeds: 8 lanes, 2 a
card) through ``run_sweep(shard=True)``, against the same grids on one
card (``shard=False``): every lane bitwise, and warm lane-rounds/s of each
(A B B A calls of ``SWEEP_RATE_ROUNDS`` rounds).

On the CPU (``--device cpu``) the configs are the reduced ones (4 layers,
d_model 256) and the prompts 2 x 32 tokens, the sweep's devices the CPU
``ranks`` times; it rehearses the same code and checks.

Rank 0 prints one JSON line per part, this process the sweep's; the exit
code is 1 if a check fails.  On cards the kernels are built once before
the ranks start, NCCL's bootstrap stays on the loopback interface, and
the cards' names and power limits head the output.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import socket
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "jamba-v0.1-52b"
SUPERBLOCK = 8                   # layers of one superblock (attn_period)
PREFILL_SAMPLES = 2
DECODE_STEPS = 32
PARITY_STEPS = 8
TRAIN_ARCH = "granite-moe-1b-a400m"
TRAIN_STEPS = 2
SWEEP_ROUNDS = 20
SWEEP_RATE_ROUNDS = 64


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _config(cpu: bool, layers=None):
    from repro_torch.configs.registry import get_config, reduce_config
    cfg = get_config(ARCH)
    if cpu:
        cfg = dataclasses.replace(reduce_config(cfg), dtype="float32")
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=min(layers,
                                                      cfg.num_layers))
    return cfg


def _prompts(cfg, cpu: bool, device) -> torch.Tensor:
    b, s = (2, 32) if cpu else (4, 8192)
    gen = torch.Generator().manual_seed(5)
    return torch.randint(0, cfg.vocab_size, (b, s), generator=gen).to(device)


def _serve(cfg, mesh, params, tokens, steps, device):
    """Prefill and ``steps`` greedy steps; (ids [B, 1 + steps], cache,
    the prefill's seconds, the decode's).  ``tokens``: the prompt, or a
    batch dict (an encoder-decoder's ``src_embeds`` with it: its encoder
    runs first, on the mesh)."""
    from repro_torch.launch import serve
    batch = tokens if isinstance(tokens, dict) else {"tokens": tokens}
    s = batch["tokens"].shape[1]
    prefill, _ = serve.build_prefill_cache_step(
        cfg, device, cache_len=s + steps + 8, mesh=mesh)
    decode, _ = serve.build_decode_step(cfg, device, mesh=mesh)
    enc_out = None
    if cfg.is_encoder_decoder:
        encode, _ = serve.build_encode_step(cfg, device, mesh=mesh)
        enc_out = encode(params, batch)
    _sync(device)
    t0 = time.perf_counter()
    ids, cache = prefill(params, batch)
    _sync(device)
    t1 = time.perf_counter()
    out = [ids]
    for pos in range(s, s + steps):
        ids, cache = decode(params, cache, ids[:, None], pos, enc_out=enc_out)
        out.append(ids)
    _sync(device)
    return torch.stack(out, 1), cache, t1 - t0, time.perf_counter() - t1


def _params(cfg, mesh, rank, device):
    from repro_torch.models import transformer as T
    gen = torch.Generator(device=device).manual_seed(0)
    return T.init_sharded_params(cfg, gen, mesh, rank, device=device)


def _same_on_every_rank(t: torch.Tensor) -> bool:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return all(torch.equal(p, parts[0]) for p in parts)


def _gathered(x: float, device) -> list:
    t = torch.tensor([x], dtype=torch.float64, device=device)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return [float(p) for p in parts]


def part_whole(ranks: int, rank: int, device, cpu: bool) -> dict:
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    cfg = _config(cpu)
    mesh = make_host_mesh(1, ranks)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    t0 = time.perf_counter()
    params = [_params(cfg, mesh, rank, device)]
    _sync(device)
    init_s = time.perf_counter() - t0
    tokens = _prompts(cfg, cpu, device)
    b, s = tokens.shape
    _serve(cfg, mesh, params, tokens, 1, device)             # warm-up
    prefill_s, decode_s = [], None
    for _ in range(PREFILL_SAMPLES):
        ids, cache, p_s, d_s = _serve(cfg, mesh, params, tokens,
                                      DECODE_STEPS, device)
        prefill_s.append(p_s)
        decode_s = d_s
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else 0.0)
    out = {"part": "whole", "arch": ARCH, "layers": cfg.num_layers,
           "dtype": cfg.dtype, "mesh": {"data": 1, "model": ranks},
           "physical": mesh.physical,
           "params_per_rank": _gathered(T.param_count(params[0]), device),
           "param_count": cfg.param_count(),
           "init_sharded_s": _gathered(init_s, device),
           "batch": b, "prompt": s, "decode_steps": DECODE_STEPS,
           "prefill_s": prefill_s,
           "prefill_tokens_per_s": b * s / statistics.median(prefill_s),
           "decode_ms_per_step": decode_s / DECODE_STEPS * 1e3,
           "decode_tokens_per_s": b * DECODE_STEPS / decode_s,
           "peak_mem_gib_per_rank": _gathered(peak, device),
           "same_ids_on_every_rank": _same_on_every_rank(ids),
           "ids_in_range": bool(ids.min() >= 0
                                and ids.max() < cfg.vocab_size),
           "generated_ids_rank0": ids.cpu().tolist()}
    del params, cache
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["ok"] = (out["same_ids_on_every_rank"] and out["ids_in_range"]
                 and out["physical"])
    return out


def part_parity(ranks: int, rank: int, device, cpu: bool) -> dict:
    import torch.utils._pytree as pytree
    from repro_torch.launch.mesh import make_host_mesh
    cfg = _config(cpu, SUPERBLOCK)
    tokens = _prompts(cfg, cpu, device)
    mesh = make_host_mesh(1, ranks)
    ids, cache, p_s, d_s = _serve(cfg, mesh, [_params(cfg, mesh, rank,
                                                      device)],
                                  tokens, PARITY_STEPS, device)
    mine = [t.clone() for t in pytree.tree_leaves(cache[0])]
    del cache
    emu = make_host_mesh(1, ranks, emulate=True)
    want, wcache, e_p, e_d = _serve(
        cfg, emu, [_params(cfg, emu, r, device) for r in emu.local_ranks],
        tokens, PARITY_STEPS, device)
    theirs = pytree.tree_leaves(wcache[rank])
    bitwise = (torch.equal(ids, want) and len(mine) == len(theirs)
               and all(torch.equal(a, b) for a, b in zip(mine, theirs)))
    verdicts = _gathered(float(bitwise), device)
    del wcache, mine, theirs
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"part": "parity", "layers": cfg.num_layers,
            "prompt": tokens.shape[1], "decode_steps": PARITY_STEPS,
            "physical_prefill_s": p_s,
            "physical_decode_ms_per_step": d_s / PARITY_STEPS * 1e3,
            "emulated_prefill_s": e_p,
            "emulated_decode_ms_per_step": e_d / PARITY_STEPS * 1e3,
            "bitwise_per_rank": [bool(v) for v in verdicts],
            "ok": all(v == 1.0 for v in verdicts)}


def _train_steps(cfg, mesh, params, batch, device, cpu: bool):
    """Two warm-up steps (noiseless, then seeded noisy: the noise
    kernel's first bind), TRAIN_STEPS noiseless steps, TRAIN_STEPS seeded
    noisy steps and one noisy step with the noise drawn on the host
    (``draw_noise``, the whole tree's) and injected, on ``mesh``; (the
    params' and optimizer state's shards of the ranks this process runs,
    the timed steps' seconds in that order, the losses)."""
    import chip_smoke
    from repro_torch.launch import train as tl
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import inverse_power_schedule, sgd
    n = T.param_count(params)
    opt = sgd(inverse_power_schedule(0.75, eta0=0.5))
    steps = {}
    for noisy in (False, True):
        steps[noisy], place = tl.build_train_step(
            cfg, mesh, scheme="normalized", aggregation_axes=("data",),
            ota=chip_smoke.train_ota(n, noise=noisy), optimizer=opt,
            device=device)
    p, o, rows = place(params, opt.init(params), batch)
    p, o, m = steps[False](p, o, rows)
    losses = [float(m["loss"])]
    p, o, m = steps[True](p, o, rows, 100)
    secs, losses = [], losses + [float(m["loss"])]
    for t in range(2 * TRAIN_STEPS + 1):
        _sync(device)
        t0 = time.perf_counter()
        if t < 2 * TRAIN_STEPS:
            p, o, m = steps[t >= TRAIN_STEPS](p, o, rows, 101 + t)
        else:
            z = tl.draw_noise(torch.Generator().manual_seed(101 + t), params,
                              chip_smoke.train_ota(n).noise_var, device)
            p, o, m = steps[True](p, o, rows, noise=z)
            del z
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    return p, o, secs, losses


def part_train(ranks: int, rank: int, device, cpu: bool) -> dict:
    import torch.utils._pytree as pytree
    import chip_smoke
    from repro_torch.configs.registry import get_config, reduce_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    cfg = get_config(TRAIN_ARCH)
    if cpu:
        cfg = dataclasses.replace(reduce_config(cfg), dtype="float32")
    clients = ranks // 2
    rows, seq = (2, 32) if cpu else (chip_smoke.TRAIN_ROWS,
                                     chip_smoke.TRAIN_SEQ)
    batch = chip_smoke.train_batch(cfg, clients * rows, seq, seed=11)
    params = T.init_params(cfg, torch.Generator(device=device)
                           .manual_seed(0), device=device)
    mesh = make_host_mesh(clients, 2)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    p, o, secs, losses = _train_steps(cfg, mesh, params, batch, device, cpu)
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else 0.0)
    mine = [t.clone() for t in pytree.tree_leaves((p[0], o[0]))]
    del p, o
    emu = make_host_mesh(clients, 2, emulate=True)
    ep, eo, esecs, elosses = _train_steps(cfg, emu, params, batch, device,
                                          cpu)
    theirs = pytree.tree_leaves((ep[rank], eo[rank]))
    bitwise = (losses == elosses and len(mine) == len(theirs)
               and all(torch.equal(a, b) for a, b in zip(mine, theirs)))
    verdicts = _gathered(float(bitwise), device)
    del ep, eo, mine, theirs, params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    tokens = clients * rows * seq
    quiet = statistics.median(secs[:TRAIN_STEPS])
    return {"part": "train", "arch": TRAIN_ARCH, "layers": cfg.num_layers,
            "dtype": cfg.dtype, "mesh": {"data": clients, "model": 2},
            "physical": mesh.physical, "tokens_per_step": tokens,
            "s_per_step_no_noise": secs[:TRAIN_STEPS],
            "tokens_per_s": tokens / quiet,
            "s_per_step_noise": secs[TRAIN_STEPS:-1],
            "s_per_step_noise_host_drawn": secs[-1],
            "emulated_s_per_step_no_noise": esecs[:TRAIN_STEPS],
            "emulated_s_per_step_noise": esecs[TRAIN_STEPS:-1],
            "emulated_s_per_step_noise_host_drawn": esecs[-1],
            "loss": losses,
            "peak_mem_gib_per_rank": _gathered(peak, device),
            "bitwise_per_rank": [bool(v) for v in verdicts],
            "ok": mesh.physical and all(v == 1.0 for v in verdicts)
            and all(np.isfinite(losses))}


def part_fsdp(ranks: int, rank: int, device, cpu: bool) -> dict:
    import torch.utils._pytree as pytree
    import chip_smoke
    from repro_torch.configs.registry import get_config, reduce_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    cfg = get_config(TRAIN_ARCH)
    if cpu:
        cfg = dataclasses.replace(reduce_config(cfg), dtype="float32")
    clients = ranks // 2
    rows, seq = (2, 32) if cpu else (chip_smoke.TRAIN_ROWS,
                                     chip_smoke.TRAIN_SEQ)
    batch = chip_smoke.train_batch(cfg, clients * rows, seq, seed=11)
    mesh = make_host_mesh(clients, 2)
    runs = {}
    for fsdp in (None, "data"):
        # the rank's shard drawn alone (the whole model never on the card),
        # the other run's results on the host: the card holds one run
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        shard = T.init_sharded_params(cfg, torch.Generator(device=device)
                                      .manual_seed(0), mesh, rank,
                                      device=device, fsdp_axis=fsdp)
        p, o, ms, secs, resident = chip_smoke._fsdp_mean_steps(
            cfg, mesh, [shard], batch, fsdp, device, TRAIN_STEPS + 1)
        peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
                if device.type == "cuda" else 0.0)
        runs[fsdp] = {"p": chip_smoke._tree_to(p[0], "cpu"),
                      "mu": chip_smoke._tree_to(o[0].mu, "cpu"),
                      "secs": secs[1:],
                      "loss": [float(m["loss"]) for m in ms],
                      "peak": peak, "resident": resident[0]}
        del p, o, shard
    # this rank's FSDP slices against its plain shard, narrowed
    same_plain = (runs[None]["loss"] == runs["data"]["loss"]
                  and all(chip_smoke.fsdp_slice_same(
                      cfg, mesh, rank, runs[None][t], runs["data"][t])
                      for t in ("p", "mu")))
    mine = pytree.tree_leaves((runs["data"]["p"], runs["data"]["mu"]))
    losses = runs["data"]["loss"]
    runs = {k: {n: v for n, v in r.items() if n not in ("p", "mu")}
            for k, r in runs.items()}
    params = T.init_params(cfg, torch.Generator(device=device)
                           .manual_seed(0), device=device)
    emu = make_host_mesh(clients, 2, emulate=True)
    ep, eo, ems, esecs, _ = chip_smoke._fsdp_mean_steps(
        cfg, emu, params, batch, "data", device, TRAIN_STEPS + 1)
    theirs = [t.cpu() for t in pytree.tree_leaves((ep[rank], eo[rank].mu))]
    bitwise = (losses == [float(m["loss"]) for m in ems]
               and len(mine) == len(theirs)
               and all(torch.equal(a, b) for a, b in zip(mine, theirs)))
    verdicts = _gathered(float(bitwise and same_plain), device)
    del ep, eo, mine, theirs, params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    tokens = clients * rows * seq
    return {"part": "fsdp", "arch": TRAIN_ARCH, "layers": cfg.num_layers,
            "dtype": cfg.dtype, "mesh": {"data": clients, "model": 2},
            "physical": mesh.physical, "tokens_per_step": tokens,
            "optimizer": "sgd(0.05, momentum=0.9)",
            "s_per_step": {("fsdp" if k else "plain"): r["secs"]
                           for k, r in runs.items()},
            "emulated_fsdp_s_per_step": esecs[1:],
            "loss": losses,
            "peak_mem_gib_per_rank": {
                ("fsdp" if k else "plain"): _gathered(r["peak"], device)
                for k, r in runs.items()},
            "resident_bytes_rank0": {
                ("fsdp" if k else "plain"): r["resident"]
                for k, r in runs.items()},
            "bitwise_per_rank": [bool(v) for v in verdicts],
            "ok": mesh.physical and all(v == 1.0 for v in verdicts)
            and all(np.isfinite(losses))}


ZOO = (("xlstm-1.3b", 2048, 0), ("seamless-m4t-medium", 8192, 2048))


def part_zoo(ranks: int, rank: int, device, cpu: bool) -> dict:
    import torch.utils._pytree as pytree
    from repro_torch.configs.registry import get_config, reduce_config
    from repro_torch.launch.mesh import make_host_mesh
    out = {"part": "zoo", "mesh": {"data": 1, "model": ranks}}
    ok = True
    for arch, s, n_stub in ZOO:
        cfg = get_config(arch)
        if cpu:
            cfg = dataclasses.replace(reduce_config(cfg), dtype="float32")
            s, n_stub = 32, 8 if n_stub else 0
        gen = torch.Generator().manual_seed(5)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, s),
                                         generator=gen).to(device)}
        if cfg.is_encoder_decoder:
            batch["src_embeds"] = torch.randn(
                (4, n_stub, cfg.modal_embed_dim), generator=gen).to(
                device=device, dtype=torch.float32 if cpu else
                torch.bfloat16)
        mesh = make_host_mesh(1, ranks)
        params = [_params(cfg, mesh, rank, device)]
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        _serve(cfg, mesh, params, batch, 1, device)          # warm-up
        ids, cache, pre_s, dec_s = _serve(cfg, mesh, params, batch,
                                          PARITY_STEPS, device)
        peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
                if device.type == "cuda" else 0.0)
        mine = [t.clone() for t in pytree.tree_leaves(cache[0])]
        del cache, params
        emu = make_host_mesh(1, ranks, emulate=True)
        eparams = [_params(cfg, emu, r, device)
                   for r in range(ranks)]
        eids, ecache, _, _ = _serve(cfg, emu, eparams, batch, PARITY_STEPS,
                                    device)
        theirs = pytree.tree_leaves(ecache[rank])
        bitwise = (torch.equal(ids, eids) and len(mine) == len(theirs)
                   and all(torch.equal(a, b) for a, b in zip(mine, theirs)))
        verdicts = _gathered(float(bitwise), device)
        del eparams, ecache, mine, theirs
        if device.type == "cuda":
            torch.cuda.empty_cache()
        out[arch] = {"layers": cfg.num_layers, "dtype": cfg.dtype,
                     "batch": 4, "text_tokens": s, "stub_positions": n_stub,
                     "prefill_s": pre_s,
                     "prefill_tokens_per_s": 4 * s / pre_s,
                     "decode_ms_per_step": dec_s / PARITY_STEPS * 1e3,
                     "peak_mem_gib_per_rank": _gathered(peak, device),
                     "same_ids_on_every_rank": _same_on_every_rank(ids),
                     "bitwise_per_rank": [bool(v) for v in verdicts]}
        ok = ok and all(v == 1.0 for v in verdicts) \
            and out[arch]["same_ids_on_every_rank"]
    out["ok"] = ok and mesh.physical
    return out


def _pod_steps(cfg, mesh, params, batch, device, scheme, axes, fsdp):
    """One warm-up step and TRAIN_STEPS timed steps (sgd with momentum)
    on ``mesh``; (the params' and momentum's shards of the ranks this
    process runs, the timed steps' seconds, the losses)."""
    import chip_smoke
    from repro_torch.launch import train as tl
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import sgd
    opt = sgd(0.05, momentum=0.9)
    ota = None
    if axes:
        k = 1
        for a in axes:
            k *= mesh.shape[a]
        full = chip_smoke.train_ota(T.param_count(params), noise=True)
        h, b = full.h[:k], full.b[:k]
        ota = tl.OTARunParams(h=h, b=b, a=1.0 / float((h * b).sum()),
                              noise_var=full.noise_var,
                              grad_bound=full.grad_bound)
    step, place = tl.build_train_step(cfg, mesh, scheme=scheme,
                                      aggregation_axes=axes, fsdp_axis=fsdp,
                                      ota=ota, optimizer=opt, device=device)
    p, o, rows = place(params, opt.init(params), batch)
    p, o, m = step(p, o, rows, 100)
    secs, losses = [], [float(m["loss"])]
    for t in range(TRAIN_STEPS):
        _sync(device)
        t0 = time.perf_counter()
        p, o, m = step(p, o, rows, 101 + t)
        _sync(device)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    return p, [x.mu for x in o], secs, losses


# pod: (the clients' axes, the FSDP axis, the scheme) of each run
POD_RUNS = {"pod": (("pod",), None, "normalized"),
            "pod_data": (("pod", "data"), None, "normalized"),
            "fsdp_pod_data": (None, ("pod", "data"), "mean")}


def part_pod(ranks: int, rank: int, device, cpu: bool) -> dict:
    """granite-moe-1b-a400m at chip_smoke's OTA depth (6 of its 24
    layers: the emulated mesh holds every rank's gradient and OTA buffers
    on one card; bf16; reduced fp32 on the CPU) over the physical (pod 2,
    data ranks / 2, model 1) mesh: a client a pod, a client a (pod, data)
    rank, and the mean path with FSDP over (pod, data); each run's shard
    on each rank the bits of the same run on the mesh emulated on the
    rank's own card."""
    import torch.utils._pytree as pytree
    import chip_smoke
    from repro_torch.configs.registry import get_config, reduce_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    cfg = get_config(TRAIN_ARCH)
    if cpu:
        cfg = dataclasses.replace(reduce_config(cfg), dtype="float32")
    else:
        cfg = dataclasses.replace(cfg, num_layers=chip_smoke.TRAIN_OTA_LAYERS)
    data = ranks // 2
    rows, seq = (2, 32) if cpu else (chip_smoke.TRAIN_ROWS,
                                     chip_smoke.TRAIN_SEQ)
    batch = chip_smoke.train_batch(cfg, ranks * rows, seq, seed=11)
    params = T.init_params(cfg, torch.Generator(device=device)
                           .manual_seed(0), device=device)
    mesh = make_host_mesh(data, 1, pod=2)
    emu = make_host_mesh(data, 1, pod=2, emulate=True)
    out = {"part": "pod", "arch": TRAIN_ARCH, "layers": cfg.num_layers,
           "dtype": cfg.dtype, "mesh": {"pod": 2, "data": data, "model": 1},
           "physical": mesh.physical, "tokens_per_step": ranks * rows * seq}
    ok = mesh.physical
    for name, (axes, fsdp, scheme) in POD_RUNS.items():
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        p, mu, secs, losses = _pod_steps(cfg, mesh, params, batch, device,
                                         scheme, axes, fsdp)
        peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
                if device.type == "cuda" else 0.0)
        mine = [t.clone() for t in pytree.tree_leaves((p[0], mu[0]))]
        del p, mu
        ep, emu_mu, esecs, elosses = _pod_steps(cfg, emu, params, batch,
                                                device, scheme, axes, fsdp)
        theirs = pytree.tree_leaves((ep[rank], emu_mu[rank]))
        bitwise = (losses == elosses and len(mine) == len(theirs)
                   and all(torch.equal(a, b) for a, b in zip(mine, theirs)))
        verdicts = _gathered(float(bitwise), device)
        del ep, emu_mu, mine, theirs
        if device.type == "cuda":
            torch.cuda.empty_cache()
        out[name] = {"s_per_step": secs, "emulated_s_per_step": esecs,
                     "loss": losses,
                     "peak_mem_gib_per_rank": _gathered(peak, device),
                     "bitwise_per_rank": [bool(v) for v in verdicts]}
        ok = ok and all(v == 1.0 for v in verdicts) and all(
            np.isfinite(losses))
    out["ok"] = ok
    return out


PARTS = {"whole": part_whole, "parity": part_parity, "train": part_train,
         "fsdp": part_fsdp, "zoo": part_zoo, "pod": part_pod}


def worker(rank: int, ranks: int, kind: str, port: int, failed,
           parts=tuple(PARTS)) -> None:
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
        for name in parts:
            line = PARTS[name](ranks, rank, device, kind == "cpu")
            dist.barrier()
            if rank == 0:
                print(json.dumps(line), flush=True)
                if not line["ok"]:
                    failed.value = 1
    finally:
        dist.destroy_process_group()


def part_sweep(ranks: int, kind: str) -> dict:
    """fig1a over min(3, ranks) devices and the headline over ``ranks``,
    against one device: bitwise lanes and lane-rounds/s."""
    import chip_smoke
    from repro_torch.fed import runtime
    from repro_torch.fl import SweepSpec, run_sweep
    cpu = kind == "cpu"
    device = "cpu" if cpu else "cuda"
    devs = ([torch.device("cpu")] * ranks if cpu
            else [torch.device("cuda", i) for i in range(ranks)])
    rounds = 4 if cpu else SWEEP_ROUNDS
    rate_rounds = 4 if cpu else SWEEP_RATE_ROUNDS
    case_ii = chip_smoke.case_ii_spec(device)
    nv = case_ii.fl.channel.noise_var
    grids = {
        "fig1a": (SweepSpec(chip_smoke.case_i_spec(),
                            {"amplification": ("optimal", "bmax"),
                             "seed": (0, 1, 2)}), devs[:min(3, ranks)]),
        "sweep_headline": (SweepSpec(case_ii, {"noise_var": (nv, 2.0 * nv),
                                               "seed": (0, 1, 2, 3)}),
                           devs)}
    out = {"part": "sweep", "rounds": rounds, "rate_rounds": rate_rounds}
    ok = True

    def rate(sweep, **kw):
        if not cpu:
            for d in devs:
                torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        run_sweep(sweep, rate_rounds, evaluate=False, device=device, **kw)
        if not cpu:
            for d in devs:
                torch.cuda.synchronize(d)
        return sweep.size * rate_rounds / (time.perf_counter() - t0)

    for name, (sweep, where) in grids.items():
        runtime.clear_compile_caches()
        one = run_sweep(sweep, rounds, shard=False, device=device)
        spread = run_sweep(sweep, rounds, devices=where, device=device)
        bitwise = (all(np.array_equal(spread.history[k], one.history[k])
                       for k in one.history)
                   and spread.params_digests == one.params_digests)
        rates = {"one": [], "spread": []}
        for mode in ("one", "spread", "spread", "one"):
            rates[mode].append(rate(sweep, **(
                {"shard": False} if mode == "one" else {"devices": where})))
        out[name] = {"lanes": sweep.size, "devices": [str(d) for d in where],
                     "bitwise": bitwise,
                     "lane_rounds_per_s": rates,
                     "speedup": (statistics.median(rates["spread"])
                                 / statistics.median(rates["one"]))}
        ok = ok and bitwise
    out["ok"] = ok
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--parts", default="whole,parity,train,fsdp,zoo,pod,sweep",
                    help="the parts to run, in this order for the ranks' "
                         "(whole, parity, train, fsdp, zoo, pod), then sweep")
    args = ap.parse_args()
    parts = args.parts.split(",")
    if not set(parts) <= set(PARTS) | {"sweep"}:
        sys.exit(f"unknown part in {args.parts!r}; known: "
                 f"{sorted(PARTS) + ['sweep']}")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
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
        from repro_torch.kernels import build
        build.build_all()
    else:
        torch.set_num_threads(1)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    failed = mp.get_context("spawn").Value("i", 0)
    mine = tuple(p for p in parts if p in PARTS)
    if mine:
        mp.spawn(worker, args=(args.ranks, args.device, port, failed, mine),
                 nprocs=args.ranks)
    if "sweep" in parts:
        line = part_sweep(args.ranks, args.device)
        print(json.dumps(line), flush=True)
        if not line["ok"]:
            failed.value = 1
    sys.exit(failed.value)


if __name__ == "__main__":
    main()
