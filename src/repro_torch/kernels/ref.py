"""Plain PyTorch versions of the Hopper kernels (the allclose targets).

Ported from ``repro/kernels/ref.py``.  The kernel wrappers run these for
tensors on the CPU; ``chip_smoke.py`` holds each CUDA kernel against them on
the card.  Nothing on the GPU path calls them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

# elements of one query chunk's fp32 score block in ``attention_ref``
# (2^27: 512 MiB): a plain run at the full prompt length fits on the card
ATTN_CHUNK_ELEMS = 2 ** 27


def grad_norm_ref(x: torch.Tensor) -> torch.Tensor:
    """Global L2 norm of a flat (or any-shape) gradient vector."""
    return torch.sqrt(torch.sum(torch.square(x.float())))


def blocked_sumsq_ref(x: torch.Tensor, block_rows: int) -> torch.Tensor:
    """Per-block sums of squares of a [rows, cols] view of a flat vector
    (``block_rows`` rows a block; the reference's ``blocked_sumsq``)."""
    rows, cols = x.shape
    br = min(block_rows, rows)
    xb = x.reshape(rows // br, br * cols).float()
    return torch.sum(xb * xb, dim=1)


def k_block_size(k: int, k_block: int) -> int:
    """The effective K-block size (as the reference: at most K); raises
    ``ValueError`` unless it is positive and divides K."""
    if k_block < 1:
        raise ValueError(f"k_block must be >= 1, got {k_block}")
    kb = min(k_block, k)
    if k % kb != 0:
        raise ValueError(f"k_block {kb} must divide K {k}")
    return kb


def batched_moments_ref(g: torch.Tensor):
    """Per-device (sum of squares, sum) of [K, N] stacked flat gradients."""
    gf = g.float()
    return torch.sum(gf * gf, dim=1), torch.sum(gf, dim=1)


def block_tree_sum(x: torch.Tensor, threads: int = 256) -> torch.Tensor:
    """Sum over the last axis of ``x`` [..., M] in the fixed order of
    ``csrc/moments.cu``'s fold: thread t adds entries t, t + threads, ...
    in turn; then each warp's 32 values by shuffles at offsets 16, 8, 4,
    2, 1 (lane i adds lane i + offset); then warp 0 the warps' sums the
    same way."""
    m = x.shape[-1]
    acc = torch.zeros((*x.shape[:-1], threads), dtype=x.dtype,
                      device=x.device)
    for lo in range(0, m, threads):
        part = x[..., lo:lo + threads]
        acc[..., :part.shape[-1]] = acc[..., :part.shape[-1]] + part

    def warp(v):                          # [..., 32] -> [...]
        for off in (16, 8, 4, 2, 1):
            v = torch.cat([v[..., :32 - off] + v[..., off:],
                           v[..., 32 - off:]], dim=-1)
        return v[..., 0]
    warps = warp(acc.reshape(*acc.shape[:-1], threads // 32, 32))
    lanes = torch.zeros((*warps.shape[:-1], 32), dtype=x.dtype,
                        device=x.device)
    lanes[..., :threads // 32] = warps
    return warp(lanes)


def batched_moments_chunked_ref(g: torch.Tensor, chunks: int):
    """Per-device (sum of squares, sum) in the same fold order as K1's
    kernel: each row in ``chunks`` contiguous chunks summed apart, then
    each row's chunk partials folded by ``block_tree_sum``
    (``csrc/moments.cu``'s fold).  The chunks here are ceil(N / chunks)
    elements each and summed by ``torch.sum``; the kernel's are float4s
    after a row's alignment head, summed thread-strided, so this holds the
    fold's algebra, not the kernel's bits."""
    k, n = g.shape
    per = -(-n // chunks)
    gf = g.float()
    parts = [(torch.sum(c * c, dim=1), torch.sum(c, dim=1))
             for c in torch.split(gf, per, dim=1)]
    if len(parts) == 1:
        return parts[0]
    return tuple(block_tree_sum(torch.stack(p, dim=1))
                 for p in zip(*parts))


def ota_aggregate_ref(g: torch.Tensor, scale: torch.Tensor,
                      noise: torch.Tensor, a) -> torch.Tensor:
    """y = a * (sum_k scale_k g_k + z), scale_k = h_k b_k / ||g_k||: the
    oracle of the normalized-scheme superposition."""
    acc = torch.einsum("k,kn->n", scale.float(), g.float())
    return a * (acc + noise.float())


def ota_superpose_ref(g: torch.Tensor, scale: torch.Tensor,
                      noise: torch.Tensor, a, pre: str = "identity"
                      ) -> torch.Tensor:
    """y = a * (sum_k scale_k pre(g_k) + z) with pre in {identity, sign};
    the gain ``a`` a float or a 0-d fp32 tensor."""
    gf = g.float()
    if pre == "sign":
        gf = torch.sign(gf)
    acc = torch.einsum("k,kn->n", scale.float(), gf)
    return a * (acc + noise.float())


def streaming_moments_ref(g: torch.Tensor, k_block: int):
    """Per-device (sum of squares, sum) of [K, N] stacked flat gradients,
    computed K-block by K-block (only one [k_block, N] block is read at a
    time).  Returns ([K], [K]) fp32."""
    k = g.shape[0]
    kb = k_block_size(k, k_block)
    sq, s = [], []
    for lo in range(0, k, kb):
        bf = g[lo:lo + kb].float()
        sq.append(torch.sum(bf * bf, dim=1))
        s.append(torch.sum(bf, dim=1))
    return torch.cat(sq), torch.cat(s)


def ota_superpose_streaming_ref(g: torch.Tensor, scale: torch.Tensor,
                                noise: torch.Tensor, a,
                                pre: str = "identity", *,
                                k_block: int) -> torch.Tensor:
    """y = a * (sum_k scale_k pre(g_k) + z) with the K-way sum folded
    K-block by K-block, in order, into one fp32 accumulator:
    acc = ((p_0 + p_1) + p_2) + ..., p_b the block's partial sum (the
    association order of the reference's streaming kernel).  The gain
    ``a`` is a float or a 0-d fp32 tensor."""
    k, n = g.shape
    kb = k_block_size(k, k_block)
    sf = scale.float()
    acc = torch.zeros((n,), dtype=torch.float32, device=g.device)
    for lo in range(0, k, kb):
        bf = g[lo:lo + kb].float()
        if pre == "sign":
            bf = torch.sign(bf)
        acc = acc + torch.einsum("k,kn->n", sf[lo:lo + kb], bf)
    return a * (acc + noise.float())


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None
                  ) -> torch.Tensor:
    """Plain softmax attention with fp32 math (the reference's
    ``attention_ref``).  q: [B, H, Sq, d]; k, v: [B, Hkv, Skv, d] with Hkv
    dividing H (query head h reads kv head h // (H // Hkv), as the
    reference's head-expanded kv gives it).  Returns [B, H, Sq, d] in
    q.dtype.  Scores are masked to -1e30 where causal and k_pos > q_pos, or
    where q_pos - k_pos >= window.  Computed query chunk by query chunk, so
    the [B, H, Sq, Skv] scores are never formed at once; each row's softmax
    is its own, so the chunking changes no value."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = h // hkv
    kf, vf = k.float(), v.float()
    chunk = max(1, min(sq, ATTN_CHUNK_ELEMS // (b * h * skv)))
    k_pos = torch.arange(skv, device=q.device)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for lo in range(0, sq, chunk):
        hi = min(sq, lo + chunk)
        qc = q[:, :, lo:hi].float().reshape(b, hkv, g, hi - lo, d)
        s = torch.einsum("bjgqd,bjkd->bjgqk", qc, kf) / math.sqrt(d)
        q_pos = torch.arange(lo, hi, device=q.device)[:, None]
        ok = torch.ones((hi - lo, skv), dtype=torch.bool, device=q.device)
        if causal:
            ok = ok & (k_pos[None, :] <= q_pos)
        if window is not None:
            ok = ok & (q_pos - k_pos[None, :] < window)
        s = s.masked_fill(~ok, -1e30)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bjgqk,bjkd->bjgqd", p, vf)
        out[:, :, lo:hi] = o.reshape(b, h, hi - lo, d).to(q.dtype)
    return out


def selective_scan_ref(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       bmat: torch.Tensor, cmat: torch.Tensor, *,
                       return_state: bool = False):
    """The sequential recurrence of the Mamba selective scan, fp32
    throughout (the reference's ``selective_scan_ref``):
    h_t = exp(dt_t a) h_{t-1} + (dt_t u_t) B_t, h_0 = 0; y_t = <h_t, C_t>.

    u, dt: [B, S, D]; a: [D, N]; bmat, cmat: [B, S, N].  Returns y
    [B, S, D] fp32, and with ``return_state=True`` also the final state
    h_S [B, D, N] fp32 (the reference's Pallas kernel writes only y; the
    prefill -> decode handoff needs h_S)."""
    b, s, d = u.shape
    n = a.shape[1]
    uf, dtf, af = u.float(), dt.float(), a.float()
    bf, cf = bmat.float(), cmat.float()
    h = torch.zeros((b, d, n), dtype=torch.float32, device=u.device)
    y = torch.empty((b, s, d), dtype=torch.float32, device=u.device)
    for t in range(s):
        da = torch.exp(dtf[:, t, :, None] * af[None])
        dbu = (dtf[:, t] * uf[:, t])[..., None] * bf[:, t, None, :]
        h = da * h + dbu
        y[:, t] = torch.sum(h * cf[:, t, None, :], dim=-1)
    return (y, h) if return_state else y
