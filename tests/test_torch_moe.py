"""The port's top-k MoE MLP against ``repro.models.moe`` on the CPU: the
reduced olmoe and jamba MoE layers in fp32, with and without capacity
drops, the reference's params carried across and inputs drawn with numpy.

Tolerance ``1e-5 * max|reference|`` for y and the aux losses: the same
routing (asserted equal first), then fp32 products and sums in other
orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import moe as JMOE
from repro_torch import interop
from repro_torch.configs import registry as reg
from repro_torch.models import moe as MOE

KEY = jax.random.PRNGKey(7)
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread in this file: intra-op threads on these small
    tensors stall on the loaded machine of the parallel run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rel=REL):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * max(float(np.abs(want).max()), 1e-30), err


def _moe(arch, **over):
    over = dict(dtype="float32", **over)
    jcfg = dataclasses.replace(jreg.reduce_config(jreg.get_config(arch)),
                               **over)
    cfg = dataclasses.replace(reg.reduce_config(reg.get_config(arch)),
                              **over)
    jp = JMOE.init_moe(KEY, jcfg)
    p = interop.model_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, p


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _dropped_pairs(p, cfg, x):
    """Pairs past capacity, counted as the reference's dispatch counts them
    (pair order, exclusive cumsum per expert)."""
    t = x.shape[0] * x.shape[1]
    probs, _ = MOE.router_probs(p, torch.from_numpy(x).reshape(t, -1))
    top_e = torch.topk(probs, cfg.experts_per_token, dim=-1).indices
    per_e = torch.bincount(top_e.reshape(-1), minlength=cfg.num_experts)
    return int((per_e - MOE.capacity(t, cfg)).clamp(min=0).sum())


@pytest.mark.parametrize("arch,over,drops", [
    ("olmoe-1b-7b", {"capacity_factor": 1.0}, True),
    ("olmoe-1b-7b", {"capacity_factor": 8.0}, False),
    ("jamba-v0.1-52b", {"capacity_factor": 1.0}, True),
    ("jamba-v0.1-52b", {"capacity_factor": 8.0}, False),
    # top-4 of 8: each token sums four pairs
    ("olmoe-1b-7b", {"capacity_factor": 1.0, "num_experts": 8,
                     "experts_per_token": 4}, True),
])
def test_moe_mlp_matches_reference(arch, over, drops):
    """y and both aux losses; capacity_factor 1.0 drops pairs (checked),
    8.0 drops none."""
    jcfg, cfg, jp, p = _moe(arch, **over)
    x = _x(cfg, 2, 32, seed=len(over))
    # router logits scaled up: a skewed router fills some experts past
    # capacity, as a trained one does
    jp = dict(jp, router=jp["router"] * 40.0)
    p = dict(p, router=p["router"] * 40.0)
    assert (_dropped_pairs(p, cfg, x) > 0) == drops
    xf = x.reshape(-1, cfg.d_model)
    jtop = jax.lax.top_k(JMOE.router_probs(jp, jnp.asarray(xf))[0],
                         cfg.experts_per_token)[1]
    top = torch.topk(MOE.router_probs(p, torch.from_numpy(xf))[0],
                     cfg.experts_per_token, dim=-1).indices
    np.testing.assert_array_equal(top.numpy(), np.asarray(jtop))
    jy, jaux = jax.jit(JMOE.moe_mlp, static_argnums=(1,))(jp, jcfg,
                                                          jnp.asarray(x))
    y, aux = MOE.moe_mlp(p, cfg, torch.from_numpy(x))
    _close(y, jy)
    assert set(aux) == set(jaux)
    for name in jaux:
        assert aux[name].dtype == torch.float32
        _close(aux[name], jaux[name])
    _close(MOE.aux_loss(cfg, aux), JMOE.aux_loss(jcfg, jaux))


def test_router_and_capacity_match_reference():
    jcfg, cfg, jp, p = _moe("olmoe-1b-7b")
    x = _x(cfg, 1, 24, seed=3).reshape(24, -1)
    jprobs, jlogits = JMOE.router_probs(jp, jnp.asarray(x))
    probs, logits = MOE.router_probs(p, torch.from_numpy(x))
    _close(probs, jprobs)
    _close(logits, jlogits)
    for t in (1, 2, 8, 31, 64, 1000, 32768):
        for cf in (1.0, 1.25, 8.0):
            c = dataclasses.replace(cfg, capacity_factor=cf)
            jc = dataclasses.replace(jcfg, capacity_factor=cf)
            assert MOE.capacity(t, c) == JMOE.capacity(t, jc)
    assert MOE.capacity(32768, reg.get_config("jamba-v0.1-52b")) == 5120


def test_moe_is_deterministic_and_keeps_shape_and_dtype():
    """Two calls agree bitwise; a bf16 model's MoE returns bf16 and its
    init keeps the router fp32, with the reference's shapes."""
    _, cfg, _, p = _moe("jamba-v0.1-52b", capacity_factor=1.0)
    x = torch.from_numpy(_x(cfg, 2, 16, seed=4))
    y1, a1 = MOE.moe_mlp(p, cfg, x)
    y2, a2 = MOE.moe_mlp(p, cfg, x)
    assert torch.equal(y1, y2) and all(torch.equal(a1[k], a2[k]) for k in a1)
    cfg16 = reg.reduce_config(reg.get_config("jamba-v0.1-52b"))
    jp16 = JMOE.init_moe(KEY, jreg.reduce_config(
        jreg.get_config("jamba-v0.1-52b")))
    p16 = MOE.init_moe(torch.Generator().manual_seed(0), cfg16, device="cpu")
    for k in jp16:
        assert tuple(p16[k].shape) == jp16[k].shape
        assert str(p16[k].dtype)[6:] == str(jp16[k].dtype)
    y16, _ = MOE.moe_mlp(p16, cfg16, x.bfloat16())
    assert y16.dtype == torch.bfloat16 and bool(torch.isfinite(y16).all())
