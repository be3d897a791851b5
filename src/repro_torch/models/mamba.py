"""The Mamba (S6) selective-state-space mixer (the port of
``repro/models/mamba.py``): init, the full-sequence mixer with the
prefill -> decode state handoff, and the single-token decode step.

The reference runs the recurrence as a chunked associative scan (XLA);
the port's serving runs it through ``kernels.ops.selective_scan``: the
hand-written Hopper kernel (K7) for CUDA tensors, the plain sequential
recurrence for CPU ones.  Both compute the same function; the chunking only
re-associates fp32 products.  K7 has no backward, so where autograd records
(``layers.records``) the mixer takes the training scan instead: the
reference's ``_ssm_inputs`` and chunk loop (chunks of ``cfg.mamba_chunk``,
each checkpointed under ``cfg.remat``, the [B, Di, N] state carried across
them), the recurrence inside a chunk a sequential fold where the reference
has a log-depth associative scan (the same products, associated in time
order).  The D-skip and the ``silu(z)`` gate stay plain PyTorch.  Decode is the exact O(1)-state
step and writes the new ssm and conv state into the caller's cache in
place (the port's decode convention, as ``layers.decode_attention``).

Tensor parallelism (``tp``, a ``RankContext``): a rank holds d_inner / M
channels (``in_proj``'s slice of each of its two halves, ``conv_w``,
``conv_b``, ``dt_proj``, ``A_log``, ``D``, ``x_proj``'s rows, ``out_proj``'s
rows), runs the conv, the scan (K7 at ``[B, S, d_inner/M, N]``) and the
gate on them, and folds two row-parallel products over the model axis:
``x_proj``'s (dt, B, C are functions of every channel) and ``out_proj``'s.
``cfg.mamba_shard_channels`` names the axis of that channel cut (the
reference's sharding constraint on the scan's inputs); the port's cut is
the model axis whatever it names.  Under autograd ``x`` enters the rank's
``in_proj`` through ``tp.enter`` and the folded ``x_proj`` output (dt, B,
C) enters the rank's channels again, so both gradients are whole; each
chunk of the training scan is a scope of the rank's collectives
(``RankContext.scope``), replayed by its recompute.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L


def _check(cfg: ModelConfig) -> None:
    if cfg.mamba_scan_dtype != "float32":
        raise NotImplementedError(
            f"mamba_scan_dtype={cfg.mamba_scan_dtype!r}: the scan runs in "
            f"fp32 (K7); a low-precision scan is speed work held for the "
            f"port's benchmark (ROADMAP, 'Held for the benchmark phase')")


def init_mamba(gen: torch.Generator, cfg: ModelConfig, device="cuda",
               cut=None):
    """The reference's shapes, scales and dtypes (``A_log``, ``D`` and
    ``dt_proj_b`` stay fp32 in a bf16 model); draws on the generator's
    device, as ``layers._normal``."""
    d, di = cfg.d_model, cfg.mamba_d_inner
    n, r, kk = cfg.mamba_d_state, cfg.mamba_dt_rank, cfg.mamba_d_conv
    dt = L.dtype_of(cfg)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt_init = torch.exp(torch.rand((di,), generator=gen, device=gen.device)
                        * (hi - lo) + lo)
    a_init = torch.arange(1, n + 1, dtype=torch.float32,
                          device=device)[None, :].repeat(di, 1)
    keep = functools.partial(L._keep, cut)
    return {
        "in_proj": keep("in_proj", L._normal(gen, (d, 2 * di),
                                             1.0 / math.sqrt(d), dt, device)),
        "conv_w": keep("conv_w", L._normal(gen, (kk, di), 1.0 / math.sqrt(kk),
                                           dt, device)),
        "conv_b": keep("conv_b", torch.zeros((di,), dtype=dt, device=device)),
        "x_proj": keep("x_proj", L._normal(gen, (di, r + 2 * n),
                                           1.0 / math.sqrt(di), dt, device)),
        "dt_proj_w": keep("dt_proj_w", L._normal(gen, (r, di), r ** -0.5, dt,
                                                 device)),
        # softplus^-1 of dt_init, so softplus(dt_proj_b) starts at dt_init
        "dt_proj_b": keep("dt_proj_b",
                          torch.log(torch.expm1(dt_init)).to(device)),
        "A_log": keep("A_log", torch.log(a_init)),
        "D": keep("D", torch.ones((di,), dtype=torch.float32, device=device)),
        "out_proj": keep("out_proj", L._normal(
            gen, (di, d), 1.0 / math.sqrt(di) / math.sqrt(2 * cfg.num_layers),
            dt, device)),
    }


def _scan_inputs(params, cfg: ModelConfig, u: torch.Tensor, tp=None):
    """u: [B, C, Di] conv+silu activations -> (dt [B,C,Di] fp32,
    a [Di,N] fp32, B [B,C,N], C [B,C,N]), B and C in u's dtype."""
    n, r = cfg.mamba_d_state, cfg.mamba_dt_rank
    # [B,C,r+2N], whole on every rank, then read by the rank's channels
    proj = L.enter_cut(cfg, L.fold_cut(cfg, u @ params["x_proj"], tp,
                                       "mamba"), tp, "mamba")
    dt_r, b_mat, c_mat = torch.split(proj, [r, n, n], dim=-1)
    dt = F.softplus((dt_r @ params["dt_proj_w"]).float()
                    + params["dt_proj_b"])
    a = -torch.exp(params["A_log"])
    return dt, a, b_mat, c_mat


def _ssm_inputs(params, cfg: ModelConfig, u: torch.Tensor, tp=None):
    """The reference's discretized inputs: u [B, C, Di] -> (dA [B,C,Di,N],
    dBu [B,C,Di,N], C [B,C,N]), all fp32.  Decode's single step uses them;
    the full sequence hands the undiscretized inputs to the scan."""
    dt, a, b_mat, c_mat = _scan_inputs(params, cfg, u, tp)
    da = torch.exp(dt[..., None] * a)
    dbu = (dt * u.float())[..., :, None] * b_mat.float()[..., None, :]
    return da, dbu, c_mat.float()


def _chunk_scan(carry_h: torch.Tensor, da: torch.Tensor, dbu: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = da_t * h_{t-1} + dbu_t within one chunk, folded in time order.

    carry_h: [B, Di, N]; da/dbu: [B, C, Di, N].  Returns (h_all
    [B,C,Di,N], h_last).  The steps' inputs are ``unbind``'s views: their
    backward is one stack, where indexing a step (``da[:, t]``) would
    write a zero-padded chunk-sized gradient a step (quadratic bytes in
    the chunk; ``launch.dryrun`` counts them)."""
    hs, h = [], carry_h
    for da_t, dbu_t in zip(da.unbind(1), dbu.unbind(1)):
        h = da_t * h + dbu_t
        hs.append(h)
    return torch.stack(hs, dim=1), h


def _train_scan(params, cfg: ModelConfig, u_conv: torch.Tensor, tp=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The differentiable scan of the conv+silu activations u_conv [B,S,Di]:
    (y [B,S,Di] fp32, h_S [B,Di,N] fp32), chunks of ``cfg.mamba_chunk``
    (one chunk of all S where it does not divide S)."""
    b, s, di = u_conv.shape
    c = min(cfg.mamba_chunk, s)
    if s % c != 0:
        c = s

    # a chunk's collectives are a scope inside the enclosing one (the
    # superblock), keyed when the chunk is first run, so that the chunk's
    # own recompute, outside the superblock's scope, finds them
    outer = None if tp is None else tp.scope_key

    def step(h, u_c, lo):
        with (tp.scope((outer, "scan", lo)) if tp is not None
              else contextlib.nullcontext()):
            da, dbu, c_mat = _ssm_inputs(params, cfg, u_c, tp)
        h_all, h_last = _chunk_scan(h, da, dbu)
        return h_last, torch.einsum("bcdn,bcn->bcd", h_all, c_mat)

    h = torch.zeros((b, di, cfg.mamba_d_state), dtype=torch.float32,
                    device=u_conv.device)
    ys = []
    for lo in range(0, s, c):
        h, y = L.remat(cfg.remat, step, h, u_conv[:, lo:lo + c], lo)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _causal_conv(params, cfg: ModelConfig, u: torch.Tensor):
    """Depthwise causal conv of kernel K, bias and silu: returns
    (u_conv [B,S,Di], u left-padded with K-1 zeros [B,S+K-1,Di])."""
    kk, s = cfg.mamba_d_conv, u.shape[1]
    u_pad = F.pad(u, (0, 0, kk - 1, 0))
    u_conv = sum(u_pad[:, i:i + s, :] * params["conv_w"][i]
                 for i in range(kk))
    return F.silu(u_conv + params["conv_b"]), u_pad


def mamba_mix(params, cfg: ModelConfig, x: torch.Tensor, *,
              return_state: bool = False, impl: str = "auto", tp=None):
    """Full-sequence Mamba mixing.  x: [B,S,D] -> [B,S,D].

    ``return_state=True`` additionally returns (ssm_state [B,Di,N] fp32,
    conv_tail [B,K-1,Di]) for the prefill -> decode handoff: the scan's
    final state, and the last K-1 PRE-conv inputs u (zeros before the
    prompt's start).  ``impl`` forces the scan's route
    (``ops.selective_scan``).  With ``tp`` the rank's channels run and
    the returned state is the rank's.  Where autograd records the scan is
    ``_train_scan``, unless ``impl`` forces the kernel, whose wrapper then
    raises (K7 has no backward)."""
    _check(cfg)
    xz = L.enter_cut(cfg, x, tp, "mamba") @ params["in_proj"]
    u, z = torch.chunk(xz, 2, dim=-1)                          # [B,S,Di]
    u_conv, u_pad = _causal_conv(params, cfg, u)
    if impl != "kernel" and L.records(x, params):
        y, h_last = _train_scan(params, cfg, u_conv, tp)
    else:
        dt, a, b_mat, c_mat = _scan_inputs(params, cfg, u_conv, tp)
        scanned = ops.selective_scan(u_conv, dt, a, b_mat.contiguous(),
                                     c_mat.contiguous(),
                                     return_state=return_state, impl=impl)
        y, h_last = scanned if return_state else (scanned, None)
    y = y + u_conv.float() * params["D"]
    y = (y * F.silu(z.float())).to(x.dtype)
    out = L.fold_cut(cfg, y @ params["out_proj"], tp, "mamba")
    if return_state:
        return out, (h_last, u_pad[:, u_pad.shape[1] - (cfg.mamba_d_conv
                                                        - 1):, :])
    return out


# --- decode ---------------------------------------------------------------


def init_mamba_cache(cfg: ModelConfig, batch: int, n_layers: int,
                     device="cuda"):
    """Stacked decode state: ssm [L, B, Di, N] fp32, conv [L, B, K-1, Di]
    in the model's dtype."""
    di, n, kk = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    return {"ssm": torch.zeros((n_layers, batch, di, n), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((n_layers, batch, kk - 1, di),
                                dtype=L.dtype_of(cfg), device=device)}


def mamba_decode_step(params, cfg: ModelConfig, x: torch.Tensor,
                      ssm_state: torch.Tensor, conv_state: torch.Tensor,
                      tp=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B,1,D]; ssm_state: [B,Di,N]; conv_state: [B,K-1,Di].  Returns
    (out [B,1,D], ssm_state, conv_state), the two states updated in place."""
    _check(cfg)
    xz = x @ params["in_proj"]
    u, z = torch.chunk(xz, 2, dim=-1)                          # [B,1,Di]
    window = torch.cat([conv_state, u], dim=1)                 # [B,K,Di]
    u_conv = torch.einsum("bkd,kd->bd", window, params["conv_w"]) \
        + params["conv_b"]
    u_conv = F.silu(u_conv)[:, None, :]                        # [B,1,Di]
    da, dbu, c_mat = _ssm_inputs(params, cfg, u_conv, tp)      # [B,1,Di,N]
    h = da[:, 0] * ssm_state + dbu[:, 0]                       # [B,Di,N]
    y = torch.einsum("bdn,bn->bd", h, c_mat[:, 0])[:, None, :]
    y = y + u_conv.float() * params["D"]
    y = (y * F.silu(z.float())).to(x.dtype)
    ssm_state.copy_(h)
    conv_state.copy_(window[:, 1:, :])
    return (L.fold_cut(cfg, y @ params["out_proj"], tp, "mamba"), ssm_state,
            conv_state)
