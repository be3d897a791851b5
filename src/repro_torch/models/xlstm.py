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
(its cells are plain ``jnp``).  The full-sequence mixers are
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


def _mlstm_qkv(params, cfg: ModelConfig, u: torch.Tensor):
    """q, k (scaled by 1/sqrt(dh)), v [B,S,H,dh] fp32 and the gates'
    pre-activations [B,S,H] fp32 of the up-projection's first half u."""
    b, s, _ = u.shape
    _, hh, dh = _heads(cfg)
    q = (u @ params["wq"]).reshape(b, s, hh, dh).float()
    k = (u @ params["wk"]).reshape(b, s, hh, dh).float() / math.sqrt(dh)
    v = (u @ params["wv"]).reshape(b, s, hh, dh).float()
    uf = u.float()
    return q, k, v, uf @ params["wf"] + params["bf"], \
        uf @ params["wi"] + params["bi"]


def _mlstm_out(params, h: torch.Tensor, u: torch.Tensor, z: torch.Tensor
               ) -> torch.Tensor:
    """The output gate, the silu(z) gate and the down-projection."""
    h = h * torch.sigmoid(u @ params["ogate"])
    return (h * F.silu(z)) @ params["down"]


def mlstm_mix(params, cfg: ModelConfig, x: torch.Tensor,
              return_state: bool = False):
    """Full mLSTM block mixing: up-proj, chunkwise cell, output gate,
    down-proj.  x: [B,S,D] -> [B,S,D]; ``return_state=True`` also returns
    the final carry (C [B,H,dh,dh], n [B,H,dh]) fp32, the decode cache's
    handoff.  Chunks of ``c = min(cfg.mlstm_chunk, S)`` steps, one chunk of
    all S where c does not divide S (the reference's rule)."""
    b, s, _ = x.shape
    di, hh, dh = _heads(cfg)
    u, z = torch.chunk(x @ params["up"], 2, dim=-1)         # [B,S,di] each
    q, k, v, f_pre, i_pre = _mlstm_qkv(params, cfg, u)
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
    h = torch.cat(hs, dim=1).reshape(b, s, di).to(x.dtype)
    out = _mlstm_out(params, h, u, z)
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
                      c_mem: torch.Tensor, n_mem: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B,1,D]; the exact single-step recurrence.  Returns (y [B,1,D],
    C, n), C [B,H,dh,dh] and n [B,H,dh] updated in place."""
    b = x.shape[0]
    di = xlstm_inner_dim(cfg)
    u, z = torch.chunk(x @ params["up"], 2, dim=-1)
    q, k, v, f_pre, i_pre = _mlstm_qkv(params, cfg, u)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                     # [B,H,dh]
    f = torch.sigmoid(f_pre[:, 0])                          # [B,H]
    i = torch.sigmoid(i_pre[:, 0])
    c_mem.copy_(f[..., None, None] * c_mem
                + i[..., None, None] * torch.einsum("bhd,bhe->bhde", k, v))
    n_mem.copy_(f[..., None] * n_mem + i[..., None] * k)
    denom = torch.abs(torch.einsum("bhd,bhd->bh", q, n_mem))
    h = torch.einsum("bhd,bhde->bhe", q, c_mem) \
        / torch.clamp(denom, min=1.0)[..., None]
    h = h.reshape(b, 1, di).to(x.dtype)
    return _mlstm_out(params, h, u, z), c_mem, n_mem


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


def slstm_mix(params, cfg: ModelConfig, x: torch.Tensor,
              return_state: bool = False):
    """x: [B,S,D] -> [B,S,D] through the true sequential recurrence;
    ``return_state=True`` also returns the final (c, n, h, m), each [B,di]
    fp32, the state starting at zeros and m = -1e30."""
    b, s, _ = x.shape
    di = xlstm_inner_dim(cfg)
    u, z_gate = torch.chunk(x @ params["up"], 2, dim=-1)
    wx = (u @ params["w_gates"]).float()                    # [B,S,4di]
    zeros = torch.zeros((b, di), dtype=torch.float32, device=x.device)
    state = (zeros, zeros, zeros,
             torch.full((b, di), -1e30, dtype=torch.float32,
                        device=x.device))
    hs = []
    for t in range(s):
        state, h = _slstm_cell(params, cfg, wx[:, t], state)
        hs.append(h)
    out = (torch.stack(hs, dim=1).to(x.dtype) * F.silu(z_gate)) \
        @ params["down"]
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


def slstm_decode_step(params, cfg: ModelConfig, x: torch.Tensor, state):
    """x: [B,1,D]; state: (c, n, h, m) each [B,di], updated in place.
    Returns (y [B,1,D], state)."""
    u, z_gate = torch.chunk(x @ params["up"], 2, dim=-1)
    wx = (u[:, 0] @ params["w_gates"]).float()
    new_state, h = _slstm_cell(params, cfg, wx, state)
    for old, new in zip(state, new_state):
        old.copy_(new)
    y = (h[:, None, :].to(x.dtype) * F.silu(z_gate)) @ params["down"]
    return y, state
