"""xLSTM blocks (the port of ``repro/models/xlstm.py``): the chunkwise
mLSTM (matrix memory) and the recurrent sLSTM, their decode caches and
single-token decode steps.

The reference's cells, function for function:

* **mLSTM**, chunkwise: inside a chunk of c steps an O(c^2) masked linear
  attention, across chunks a carried matrix memory ``C`` [B,H,dh,dh] and
  normaliser ``n`` [B,H,dh], fp32 throughout.  The input gate is a
  sigmoid (the reference's documented simplification of the paper's exp
  gate, so no stabiliser).  The reference's three-operand einsums are
  contracted pairwise here, so no [B,c,c,H,dh] intermediate is formed.
* **sLSTM**: the true sequential recurrence over S, with the exp input
  gate and its max stabiliser ``m``, and block-diagonal (per-head)
  recurrent weights ``r_gates`` [4,H,dh,dh] fp32.  The input
  contribution of the whole sequence is one product before the time
  loop; each step is one batched product over the heads and the gates'
  elementwise math.

Both run as plain PyTorch: the reference has no Pallas kernel for either
(its cells are plain ``jnp``).

Tensor parallelism (``tp``, a ``RankContext``; the cut of the reference's
``param_specs``, the cell's modules with the heads): ``up`` is cut in
halves, so a rank holds its features of ``u`` and ``z``.

* mLSTM: ``u`` is gathered over the model axis (``wq``/``wk``/``wv`` and
  ``ogate``, column-cut, read all of it) and the rank's heads run the
  chunked cell; ``wi``/``wf`` (row-cut) read the rank's ``u``, their
  partials fold and the rank keeps its heads' gates; ``down`` folds.  The
  decode cache ``C``/``n`` holds the rank's heads.
* sLSTM: ``w_gates`` (row-cut) folds once a layer, before the time loop;
  ``r_gates``/``b_gates`` are whole, so every rank runs the whole
  recurrence (state whole), as GSPMD does; the rank's features of ``h``
  times ``silu(z)`` go through ``down``, which folds.

Under autograd the replicated tensors enter the rank's work through
``tp.enter`` (the block's input, the gathered ``u``, the folded gates and
the sLSTM's ``h``), so every replicated leaf's gradient comes out whole.  The full-sequence mixers are
differentiable (the mLSTM's chunks checkpointed under ``cfg.remat``, as the
reference's); only the decode steps write the new state into the caller's
cache in place (the port's decode convention, as
``layers.decode_attention`` and ``mamba.mamba_decode_step``).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def _proj_factor() -> int:
    return 2  # up-projection factor of the xLSTM block (pf = 2)


def xlstm_inner_dim(cfg: ModelConfig) -> int:
    return _proj_factor() * cfg.d_model


def _heads(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(di, H, dh) of the cell."""
    di = xlstm_inner_dim(cfg)
    return di, cfg.num_heads, di // cfg.num_heads


# ---------------------------------------------------------------------------
# mLSTM


def init_mlstm(gen: torch.Generator, cfg: ModelConfig, device="cuda",
               cut=None):
    """The reference's shapes, scales and dtypes (the gates' weights and
    biases fp32 in a bf16 model); draws on the generator's device, as
    ``layers._normal``."""
    d = cfg.d_model
    di, h, _ = _heads(cfg)
    dt = L.dtype_of(cfg)
    f32 = torch.float32
    s = 1.0 / math.sqrt(di)

    def w(name, shape, scale, dtype):
        return L._keep(cut, name, L._normal(gen, shape, scale, dtype, device))
    return {
        "up": w("up", (d, 2 * di), 1.0 / math.sqrt(d), dt),
        "wq": w("wq", (di, di), s, dt),
        "wk": w("wk", (di, di), s, dt),
        "wv": w("wv", (di, di), s, dt),
        "wi": w("wi", (di, h), s, f32),
        "wf": w("wf", (di, h), s, f32),
        "bi": L._keep(cut, "bi", torch.zeros((h,), dtype=f32, device=device)),
        # start with long memory
        "bf": L._keep(cut, "bf", torch.full((h,), 3.0, dtype=f32,
                                            device=device)),
        "ogate": w("ogate", (di, di), s, dt),
        "down": w("down", (di, d),
                  1.0 / math.sqrt(di) / math.sqrt(2 * cfg.num_layers), dt),
    }


def _mlstm_chunk(q, k, v, log_f, i_gate, carry):
    """One chunk of the mLSTM recurrence.

    q,k,v: [B,c,H,dh]; log_f,i_gate: [B,c,H]; carry = (C [B,H,dh,dh],
    n [B,H,dh]).  Returns (h [B,c,H,dh], new_carry).  All fp32."""
    c_mem, n_mem = carry
    c = q.shape[1]
    f_cum = torch.cumsum(log_f, dim=1)                      # F_t (inclusive)
    decay_out = torch.exp(f_cum)                            # [B,c,H]
    # intra-chunk pairwise decay: exp(F_t - F_j) * i_j for j <= t
    df = f_cum[:, :, None, :] - f_cum[:, None, :, :]        # [B,t,j,H]
    tri = torch.ones((c, c), dtype=torch.bool,
                     device=q.device).tril()[None, :, :, None]
    w = torch.where(tri, torch.exp(df) * i_gate[:, None, :, :],
                    torch.zeros((), dtype=q.dtype, device=q.device))

    qk = torch.einsum("bthd,bjhd->btjh", q, k)              # [B,t,j,H]
    h_intra = torch.einsum("btjh,bjhd->bthd", qk * w, v)
    n_intra = torch.einsum("btjh,bjhd->bthd", w, k)

    h_inter = decay_out[..., None] * torch.einsum("bthd,bhde->bthe", q,
                                                  c_mem)
    n_inter = decay_out[..., None] * n_mem[:, None]

    n_tot = n_intra + n_inter
    denom = torch.abs(torch.einsum("bthd,bthd->bth", q, n_tot))
    h = (h_intra + h_inter) / torch.clamp(denom, min=1.0)[..., None]

    # carry update: everything decayed to the end of the chunk
    f_end = f_cum[:, -1][:, None]                           # [B,1,H]
    w_end = torch.exp(f_end - f_cum) * i_gate               # [B,c,H]
    decay_end = torch.exp(f_end[:, 0])                      # [B,H]
    c_new = decay_end[..., None, None] * c_mem \
        + torch.einsum("bchd,bche->bhde", w_end[..., None] * k, v)
    n_new = decay_end[..., None] * n_mem \
        + torch.einsum("bch,bchd->bhd", w_end, k)
    return h, (c_new, n_new)


def _cut(cfg: ModelConfig, tp) -> bool:
    """Whether ``tp``'s plan cuts the cell (its heads) over the model
    axis."""
    return L.cuts(cfg, tp, "heads")


def _up(params, cfg: ModelConfig, x: torch.Tensor, tp):
    """u, z of the up-projection (a rank's features of each with ``tp``;
    ``x`` enters the rank's work)."""
    return torch.chunk(L.enter_cut(cfg, x, tp, "heads") @ params["up"], 2,
                       dim=-1)


def _mlstm_qkv(params, cfg: ModelConfig, u: torch.Tensor, tp=None):
    """q, k (scaled by 1/sqrt(dh)), v [B,S,H,dh] fp32 and the gates'
    pre-activations [B,S,H] fp32 of the up-projection's first half u, and
    the whole u that the q/k/v and output-gate products read.  With the
    cell cut: the rank's heads, from ``u`` gathered over the model axis,
    and its heads' gates, from the fold of its rows' partials."""
    b, s, _ = u.shape
    _, hh, dh = _heads(cfg)
    uf = u.float()
    f_pre = uf @ params["wf"]
    i_pre = uf @ params["wi"]
    u_all = u
    if _cut(cfg, tp):
        hh //= tp.model
        u_all = tp.enter(torch.cat(list(tp.gather(u).unbind(0)), dim=-1))
        heads = slice(tp.m * hh, (tp.m + 1) * hh)
        f_pre = tp.enter(tp.fold(f_pre) + params["bf"])[..., heads]
        i_pre = tp.enter(tp.fold(i_pre) + params["bi"])[..., heads]
    else:
        f_pre = f_pre + params["bf"]
        i_pre = i_pre + params["bi"]
    q = (u_all @ params["wq"]).reshape(b, s, hh, dh).float()
    k = (u_all @ params["wk"]).reshape(b, s, hh, dh).float() / math.sqrt(dh)
    v = (u_all @ params["wv"]).reshape(b, s, hh, dh).float()
    return q, k, v, f_pre, i_pre, u_all


def _mlstm_out(params, cfg: ModelConfig, h: torch.Tensor, u: torch.Tensor,
               z: torch.Tensor, tp=None) -> torch.Tensor:
    """The output gate (of the whole ``u``), the silu(z) gate and the
    down-projection, its partials folded with the cell cut."""
    h = h * torch.sigmoid(u @ params["ogate"])
    return L.fold_cut(cfg, (h * F.silu(z)) @ params["down"], tp, "heads")


def mlstm_mix(params, cfg: ModelConfig, x: torch.Tensor,
              return_state: bool = False, tp=None):
    """Full mLSTM block mixing: up-proj, chunkwise cell, output gate,
    down-proj.  x: [B,S,D] -> [B,S,D]; ``return_state=True`` also returns
    the final carry (C [B,H,dh,dh], n [B,H,dh]) fp32, the decode cache's
    handoff (with ``tp``: the rank's heads).  Chunks of ``c =
    min(cfg.mlstm_chunk, S)`` steps, one chunk of all S where c does not
    divide S (the reference's rule)."""
    b, s, _ = x.shape
    u, z = _up(params, cfg, x, tp)                          # [B,S,di] each
    q, k, v, f_pre, i_pre, u_all = _mlstm_qkv(params, cfg, u, tp)
    hh, dh = q.shape[2], q.shape[3]
    log_f = F.logsigmoid(f_pre)                             # [B,S,H]
    i_gate = torch.sigmoid(i_pre)      # sigmoid (see module doc)

    c = min(cfg.mlstm_chunk, s)
    if s % c != 0:
        c = s
    carry = (torch.zeros((b, hh, dh, dh), dtype=torch.float32,
                         device=x.device),
             torch.zeros((b, hh, dh), dtype=torch.float32, device=x.device))
    hs = []
    for lo in range(0, s, c):
        h, carry = L.remat(cfg.remat, _mlstm_chunk, q[:, lo:lo + c],
                           k[:, lo:lo + c], v[:, lo:lo + c],
                           log_f[:, lo:lo + c], i_gate[:, lo:lo + c], carry)
        hs.append(h)
    h = torch.cat(hs, dim=1).reshape(b, s, hh * dh).to(x.dtype)
    out = _mlstm_out(params, cfg, h, u_all, z, tp)
    if return_state:
        return out, carry      # (C, n)
    return out


def init_mlstm_cache(cfg: ModelConfig, batch: int, n_layers: int,
                     device="cuda"):
    """Stacked decode state: C [L,B,H,dh,dh] and n [L,B,H,dh], fp32."""
    _, h, dh = _heads(cfg)
    return {"C": torch.zeros((n_layers, batch, h, dh, dh),
                             dtype=torch.float32, device=device),
            "n": torch.zeros((n_layers, batch, h, dh), dtype=torch.float32,
                             device=device)}


def mlstm_decode_step(params, cfg: ModelConfig, x: torch.Tensor,
                      c_mem: torch.Tensor, n_mem: torch.Tensor, tp=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B,1,D]; the exact single-step recurrence.  Returns (y [B,1,D],
    C, n), C [B,H,dh,dh] and n [B,H,dh] (with ``tp``: the rank's heads)
    updated in place."""
    b = x.shape[0]
    u, z = _up(params, cfg, x, tp)
    q, k, v, f_pre, i_pre, u_all = _mlstm_qkv(params, cfg, u, tp)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                     # [B,H,dh]
    f = torch.sigmoid(f_pre[:, 0])                          # [B,H]
    i = torch.sigmoid(i_pre[:, 0])
    c_mem.copy_(f[..., None, None] * c_mem
                + i[..., None, None] * torch.einsum("bhd,bhe->bhde", k, v))
    n_mem.copy_(f[..., None] * n_mem + i[..., None] * k)
    denom = torch.abs(torch.einsum("bhd,bhd->bh", q, n_mem))
    h = torch.einsum("bhd,bhde->bhe", q, c_mem) \
        / torch.clamp(denom, min=1.0)[..., None]
    h = h.reshape(b, 1, -1).to(x.dtype)
    return _mlstm_out(params, cfg, h, u_all, z, tp), c_mem, n_mem


# ---------------------------------------------------------------------------
# sLSTM


def init_slstm(gen: torch.Generator, cfg: ModelConfig, device="cuda",
               cut=None):
    """The reference's shapes, scales and dtypes (``r_gates`` and
    ``b_gates`` fp32 in a bf16 model)."""
    d = cfg.d_model
    di, h, dh = _heads(cfg)
    dt = L.dtype_of(cfg)

    def w(name, shape, scale, dtype):
        return L._keep(cut, name, L._normal(gen, shape, scale, dtype, device))
    return {
        "up": w("up", (d, 2 * di), 1.0 / math.sqrt(d), dt),
        # input weights for the 4 gates (z, i, f, o) fused: [di, 4*di]
        "w_gates": w("w_gates", (di, 4 * di), 1.0 / math.sqrt(di), dt),
        # block-diagonal recurrent weights, per gate, per head: [4,H,dh,dh]
        "r_gates": w("r_gates", (4, h, dh, dh), 1.0 / math.sqrt(dh),
                     torch.float32),
        "b_gates": L._keep(cut, "b_gates", torch.cat([
            torch.zeros((2 * di,)), torch.full((di,), 3.0),
            torch.zeros((di,))]).to(device=device, dtype=torch.float32)),
        "down": w("down", (di, d),
                  1.0 / math.sqrt(di) / math.sqrt(2 * cfg.num_layers), dt),
    }


def _slstm_cell(params, cfg: ModelConfig, wx_t: torch.Tensor, state):
    """One timestep.  wx_t: [B, 4*di] the precomputed input contribution;
    state: (c, n, h, m) each [B, di] fp32.  Returns (new state, h_new)."""
    di, hh, dh = _heads(cfg)
    c, n, h, m = state
    b = h.shape[0]
    # rec[b, g, head, e] = sum_d h[b, head, d] r_gates[g, head, d, e]: one
    # batched product over the (gate, head) pairs, r_gates read in place
    h_g = h.reshape(b, hh, dh).transpose(0, 1).expand(4, hh, b, dh)
    rec = torch.bmm(h_g.reshape(4 * hh, b, dh),
                    params["r_gates"].reshape(4 * hh, dh, dh))
    rec = rec.reshape(4, hh, b, dh).permute(2, 0, 1, 3).reshape(b, 4, di)
    pre = wx_t.reshape(b, 4, di) + rec + params["b_gates"].reshape(4, di)
    z_pre, i_pre, f_pre, o_pre = pre.unbind(1)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    log_f = F.logsigmoid(f_pre)
    m_new = torch.maximum(log_f + m, i_pre)                 # stabiliser
    i_s = torch.exp(i_pre - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c_new = f_s * c + i_s * z
    n_new = f_s * n + i_s
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, h_new, m_new), h_new


def _slstm_wx(params, cfg: ModelConfig, u: torch.Tensor, tp
              ) -> torch.Tensor:
    """The gates' input contribution [.., 4 di] fp32 (whole): with the
    cell cut, the fold of the rank's rows' partials (in fp32)."""
    wx = (u @ params["w_gates"]).float()
    return tp.fold(wx) if _cut(cfg, tp) else wx


def _slstm_out(params, cfg: ModelConfig, h: torch.Tensor, z: torch.Tensor,
               tp) -> torch.Tensor:
    """``h`` [.., di] (whole, in the model's dtype) gated by ``silu(z)``
    through ``down``: with the cell cut, the rank's features of ``h``
    (which enters the rank's work) and the fold of the partials."""
    if _cut(cfg, tp):
        n = h.shape[-1] // tp.model
        h = tp.enter(h)[..., tp.m * n:(tp.m + 1) * n]
    return L.fold_cut(cfg, (h * F.silu(z)) @ params["down"], tp, "heads")


def slstm_mix(params, cfg: ModelConfig, x: torch.Tensor,
              return_state: bool = False, tp=None):
    """x: [B,S,D] -> [B,S,D] through the true sequential recurrence;
    ``return_state=True`` also returns the final (c, n, h, m), each [B,di]
    fp32, the state starting at zeros and m = -1e30 (whole on every rank
    with ``tp``)."""
    b = x.shape[0]
    di = xlstm_inner_dim(cfg)
    u, z_gate = _up(params, cfg, x, tp)
    wx = _slstm_wx(params, cfg, u, tp)                      # [B,S,4di]
    zeros = torch.zeros((b, di), dtype=torch.float32, device=x.device)
    state = (zeros, zeros, zeros,
             torch.full((b, di), -1e30, dtype=torch.float32,
                        device=x.device))
    hs = []
    # the steps' inputs as ``unbind``'s views: their backward is one stack
    # (indexing ``wx[:, t]`` would write a zero-padded [B, S, 4 di]
    # gradient a step, quadratic bytes in S)
    for wx_t in wx.unbind(1):
        state, h = _slstm_cell(params, cfg, wx_t, state)
        hs.append(h)
    out = _slstm_out(params, cfg, torch.stack(hs, dim=1).to(x.dtype), z_gate,
                     tp)
    if return_state:
        return out, state
    return out


def init_slstm_cache(cfg: ModelConfig, batch: int, n_layers: int,
                     device="cuda"):
    """Stacked decode state: c, n, h [L,B,di] zeros and m [L,B,di] at
    -1e30, fp32."""
    di = xlstm_inner_dim(cfg)

    def zeros():
        return torch.zeros((n_layers, batch, di), dtype=torch.float32,
                           device=device)
    return {"c": zeros(), "n": zeros(), "h": zeros(),
            "m": torch.full((n_layers, batch, di), -1e30,
                            dtype=torch.float32, device=device)}


def slstm_decode_step(params, cfg: ModelConfig, x: torch.Tensor, state,
                      tp=None):
    """x: [B,1,D]; state: (c, n, h, m) each [B,di] (whole with ``tp``),
    updated in place.  Returns (y [B,1,D], state)."""
    u, z_gate = _up(params, cfg, x, tp)
    wx = _slstm_wx(params, cfg, u[:, 0], tp)
    new_state, h = _slstm_cell(params, cfg, wx, state)
    for old, new in zip(state, new_state):
        old.copy_(new)
    return _slstm_out(params, cfg, h[:, None, :].to(x.dtype), z_gate,
                      tp), state
