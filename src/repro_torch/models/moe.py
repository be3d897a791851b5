"""Top-k mixture-of-experts MLP with capacity-bounded dispatch (the port of
``repro/models/moe.py``), plain PyTorch: the reference leaves the expert
products to XLA, outside any Pallas kernel, and the port leaves them to
``torch.bmm``.

The dispatch is the reference's, step for step: (token, slot) pairs in
token-major, slot-minor order (slot 0 the larger probability), each pair's
position within its expert by an exclusive cumsum in that order, pairs at
or past ``capacity`` dropped (written to a scratch row ``cap`` that is cut
off), every expert run on its ``[cap, D]`` buffer, and each token's k pairs
gathered back with the renormalized router weights.  The k pairs are
summed over a ``[T, k, D]`` view, not with ``index_add_``, whose CUDA
atomics would make the order of the sum vary from run to run.

Tensor parallelism (``tp``): the expert stacks are cut over the model
axis.  The router stays whole, every rank computes the same dispatch and
keeps only the pairs of its experts, and the ranks' combines (each token's
pairs of that rank's experts, in slot order) fold in rank order.  Where
the batch's rows are cut over the data axis, the dispatch is still the
whole batch's (the reference's, under GSPMD): the capacity counts every
data rank's tokens and each expert's slots continue from the earlier data
ranks' pairs (their counts gathered), so the same pairs are dropped.
The aux losses are then the rank's share of the whole batch's: the
load-balance loss weighs the rank's router probabilities by the whole
batch's expert fractions, and both losses divide by the whole batch's
token count, so the data ranks' shares sum to the whole batch's losses
(the mean train step folds them).

Under autograd (``layers.records``) the expert activations are formed out
of place, and the router, the combine weights and both aux losses carry
gradients, as the reference's.  With the experts cut, the tokens and the
combine weights enter the rank's work (``tp.enter``) where its dispatch
buffer is filled and where it keeps its own pairs; the router's gradient
is then its aux part (the same on every rank) plus the folded combine
part, whole on every rank, and is not folded again.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distribution.sharding import tp_plan
from repro_torch.models import layers as L


def init_moe(gen: torch.Generator, cfg: ModelConfig, device="cuda",
             cut=None):
    """The reference's shapes, scales and dtypes (the router stays fp32)."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    dt = L.dtype_of(cfg)
    return {
        "router": L._keep(cut, "router", L._normal(gen, (d, e), 0.02,
                                                   torch.float32, device)),
        "w_gate": L._keep(cut, "w_gate", L._normal(
            gen, (e, d, f), 1.0 / math.sqrt(d), dt, device)),
        "w_up": L._keep(cut, "w_up", L._normal(
            gen, (e, d, f), 1.0 / math.sqrt(d), dt, device)),
        "w_down": L._keep(cut, "w_down", L._normal(
            gen, (e, f, d), 1.0 / math.sqrt(f)
            / math.sqrt(2 * cfg.num_layers), dt, device)),
    }


def capacity(num_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: ceil(T k / E * capacity_factor), rounded up to a
    multiple of 8, at least 8."""
    c = int(math.ceil(num_tokens * cfg.experts_per_token / cfg.num_experts
                      * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)


def router_probs(params, x_flat: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_flat: [T, D] -> (probs [T, E], logits [T, E]), fp32."""
    logits = x_flat.float() @ params["router"]
    return torch.softmax(logits, dim=-1), logits


def moe_mlp(params, cfg: ModelConfig, x: torch.Tensor, tp=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B,S,D] -> (y [B,S,D], aux {load_balance_loss, router_z_loss}).

    The expert activations are formed in place (``act(gate) * up`` written
    over ``gate``), which saves one [E, cap, F] buffer at the prefill;
    under autograd out of place.  With ``tp`` the rank runs its experts
    and the combines fold; with the batch cut over ``data`` the aux losses
    are the rank's shares (module doc)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.experts_per_token
    x_flat = x.reshape(t, d)
    recording = L.records(x, params)

    probs, logits = router_probs(params, x_flat)              # [T, E]
    top_p, top_e = torch.topk(probs, k, dim=-1)               # [T, k]
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)

    # dispatch, in pair order.  With the batch's rows cut over ``data`` the
    # order is the whole batch's: the capacity counts every data rank's
    # tokens, and a rank's slots start after the earlier ranks' pairs
    ranks = tp.size(tp.batch_axis) if tp is not None else 1
    split = tp is not None and tp.batch_split and ranks > 1
    t_all = t * ranks if split else t
    cap = capacity(t_all, cfg)
    flat_e = top_e.reshape(t * k)
    onehot = F.one_hot(flat_e, e)                             # [T*k, E]
    pos_in_e = torch.cumsum(onehot, dim=0) - onehot           # exclusive
    if split:
        counts = tp.gather(torch.sum(onehot, dim=0), tp.batch_axis)  # [D, E]
        pos_in_e = pos_in_e + torch.sum(counts[:tp.coord(tp.batch_axis)],
                                        dim=0)

    # aux losses (fp32): Switch-style load balance and the router z-loss
    z_sq = torch.square(torch.logsumexp(logits, dim=-1))
    if split:      # the rank's shares of the whole batch's losses
        frac_tokens = torch.sum(counts, dim=0).float() / (t_all * k)
        aux = {"load_balance_loss": e * torch.sum(
                   frac_tokens * (torch.sum(probs, dim=0) / t_all)),
               "router_z_loss": torch.sum(z_sq) / t_all}
    else:
        assign = torch.zeros((t, e), dtype=torch.float32, device=x.device)
        assign.scatter_(1, top_e, 1.0)                        # multi-hot
        frac_tokens = torch.mean(assign, dim=0) / k
        mean_prob = torch.mean(probs, dim=0)
        aux = {"load_balance_loss": e * torch.sum(frac_tokens * mean_prob),
               "router_z_loss": torch.mean(z_sq)}
    flat_pos = torch.gather(pos_in_e, 1, flat_e[:, None])[:, 0]
    keep = flat_pos < cap
    lo, e_rank = 0, e
    cut = tp is not None and tp.model > 1 and tp_plan(cfg, tp.model).experts
    if cut:      # the rank's experts only: the other pairs are dropped here
        e_rank = params["w_gate"].shape[0]
        lo = tp.m * e_rank
        keep = keep & (flat_e >= lo) & (flat_e < lo + e_rank)
    dest_e = torch.where(keep, flat_e - lo, 0)
    dest_c = torch.where(keep, flat_pos, cap)                 # cap: dropped
    tok_idx = torch.arange(t, device=x.device).repeat_interleave(k)
    buf = torch.zeros((e_rank, cap + 1, d), dtype=x.dtype, device=x.device)
    buf[dest_e, dest_c] = (tp.enter(x_flat) if cut else x_flat)[tok_idx]
    buf = buf[:, :cap, :]                                     # [E, C, D]

    # every expert on its buffer
    gate = torch.bmm(buf, params["w_gate"])
    up = torch.bmm(buf, params["w_up"])
    del buf
    if recording:
        gate = (F.silu(gate) if cfg.mlp_act == "silu"
                else F.gelu(gate, approximate="tanh")) * up
    elif cfg.mlp_act == "silu":
        F.silu(gate, inplace=True)
        gate.mul_(up)
    else:   # the reference's jax.nn.gelu is the tanh approximation
        gate = F.gelu(gate, approximate="tanh")
        gate.mul_(up)
    del up
    y_buf = torch.bmm(gate, params["w_down"])                 # [E, C, D]
    del gate

    # combine: each token's k pairs, summed in slot order
    y_pairs = y_buf[dest_e, torch.clamp(dest_c, max=cap - 1)]  # [T*k, D]
    w_pairs = ((tp.enter(top_p) if cut else top_p).reshape(t * k)
               * keep).to(y_pairs.dtype)
    y = (y_pairs * w_pairs[:, None]).reshape(t, k, d).sum(dim=1)
    if cut:
        y = tp.fold(y)
    return y.reshape(b, s, d), aux


def aux_loss(cfg: ModelConfig, aux: Dict[str, torch.Tensor]) -> torch.Tensor:
    return (cfg.router_aux_coef * aux["load_balance_loss"]
            + cfg.router_z_coef * aux["router_z_loss"])
