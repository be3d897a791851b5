"""The port's training forward against the JAX package's, on the CPU:
``transformer.forward_loss`` and its gradient for one arch of each block
kind (danube: the sliding window; granite: MoE; jamba: Mamba + MoE;
xlstm-1.3b: the mLSTM and sLSTM cells; seamless: the encoder; pixtral:
the vision prefix), each ``reduce_config`` at fp32, with the reference's
weights carried across (``interop.model_params_from_jax``) and tokens,
labels, a loss mask and the stub embeddings drawn with numpy.  Then the
reference's ``TestArchSmoke`` contract on the port alone for the other
four archs, ``chunked_softmax_xent`` at its edges, ``cfg.remat`` on and
off bitwise, and the routes: no kernel under autograd, the kernel route
forced under autograd raises.

torch runs on one thread in this file.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.configs import registry as reg
from repro_torch.configs.base import InputShape
from repro_torch.distribution import ota_collectives as oc
from repro_torch.kernels import ops
from repro_torch.launch import train as tl
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

KEY = jax.random.PRNGKey(0)
PARITY = ("h2o-danube-1.8b", "granite-moe-1b-a400m", "jamba-v0.1-52b",
          "xlstm-1.3b", "seamless-m4t-medium", "pixtral-12b")
SMOKE_ONLY = tuple(a for a in reg.ARCH_IDS if a not in PARITY)
SMOKE_TRAIN = InputShape("smoke_train", 64, 2, "train")
# fp32 sums in other orders (XLA's fused reductions and einsums against
# torch's, the Mamba scan's sequential fold against the associative scan):
# the loss within LOSS_REL of the reference's, every gradient leaf within
# GRAD_REL of its largest entry (measured: at most 4.8e-6, xlstm)
LOSS_REL = 1e-6
GRAD_REL = 2e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(reference cfg, port cfg, reference params, port params), fp32."""
    jcfg = dataclasses.replace(jreg.reduce_config(jreg.get_config(arch)),
                               dtype="float32")
    cfg = dataclasses.replace(reg.reduce_config(reg.get_config(arch)),
                              dtype="float32")
    jp = JT.init_params(jcfg, KEY)
    return jcfg, cfg, jp, interop.model_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _batch(cfg, b=2, s=64, seed=1):
    """numpy tokens, labels and a loss mask (a fifth of the positions
    out) over the text, and the config's stub embeddings."""
    rng = np.random.default_rng(seed)
    st = s - cfg.num_modal_tokens if cfg.modality == "vision" else s
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, st),
                                    dtype=np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, st),
                                    dtype=np.int32),
             "loss_mask": (rng.random((b, st)) > 0.2).astype(np.float32)}
    if cfg.modality == "vision":
        batch["modal_embeds"] = rng.standard_normal(
            (b, cfg.num_modal_tokens, cfg.modal_embed_dim)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["src_embeds"] = rng.standard_normal(
            (b, 16, cfg.modal_embed_dim)).astype(np.float32)
    return batch


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_grads(cfg, p, batch):
    return tl._value_and_grad(lambda q: T.forward_loss(q, cfg, batch), p)


@pytest.mark.parametrize("arch", PARITY)
def test_forward_loss_and_gradients_match_reference(arch):
    jcfg, cfg, jp, p = _model(arch)
    batch = _batch(cfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda q, bt: JT.forward_loss(q, jcfg, bt), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = _port_grads(cfg, p, _t(batch))
    for got, want in ((loss, jl), (metrics["nll"], jm["nll"]),
                      (metrics["aux"], jm["aux"])):
        assert abs(float(got) - float(want)) <= LOSS_REL * abs(float(jl))
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(grads) == len(jleaves)
    for g, want in zip(grads, jleaves):
        want = np.asarray(want)
        assert g.shape == want.shape
        err = float(np.abs(g.numpy() - want).max())
        assert err <= GRAD_REL * float(np.abs(want).max()), (err, g.shape)


@pytest.mark.parametrize("arch", SMOKE_ONLY)
def test_arch_smoke_trains_one_step(arch):
    """The reference's ``TestArchSmoke::test_forward_and_train_step`` on
    the port: finite loss, a gradient of positive norm, one SGD step to a
    finite loss."""
    cfg = reg.reduce_config(reg.get_config(arch))
    assert cfg.d_model <= 512 and cfg.num_layers <= 4
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    batch = reg.make_dummy_inputs(cfg, SMOKE_TRAIN, device="cpu")
    loss, _, grads = _port_grads(cfg, params, batch)
    assert loss.shape == () and bool(torch.isfinite(loss))
    gn = torch.sqrt(oc.tree_sq_norm(grads))
    assert bool(torch.isfinite(gn)) and float(gn) > 0
    new = tree_unflatten(params, {
        f"{i:05d}": l - 0.01 * g.to(l.dtype)
        for i, (l, g) in enumerate(zip(tree_leaves(params), grads))})
    with torch.no_grad():
        loss2, _ = T.forward_loss(new, cfg, batch)
    assert bool(torch.isfinite(loss2))


@pytest.mark.parametrize("b,s,chunk", [(2, 48, 16), (3, 40, 16), (2, 8, 32)],
                         ids=["chunked", "ragged", "one_chunk"])
def test_chunked_softmax_xent_matches_reference(b, s, chunk):
    """With a mask (a row masked whole included), S a multiple of the
    chunk and not (one chunk of all S), and S under the chunk; against
    the reference's, fp32, and the mean of an all-zero mask is 0."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, s, 32)).astype(np.float32)
    w = rng.standard_normal((32, 97)).astype(np.float32) / 6
    labels = rng.integers(0, 97, (b, s), dtype=np.int32)
    mask = (rng.random((b, s)) > 0.3).astype(np.float32)
    mask[0] = 0.0
    for m in (None, mask):
        want = float(JL.chunked_softmax_xent(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels), chunk,
            None if m is None else jnp.asarray(m)))
        got = float(L.chunked_softmax_xent(
            torch.from_numpy(x), torch.from_numpy(w),
            torch.from_numpy(labels), chunk,
            None if m is None else torch.from_numpy(m)))
        assert abs(got - want) <= 1e-6 * abs(want), (got, want)
    zero = L.chunked_softmax_xent(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(labels), chunk,
                                  torch.zeros((b, s)))
    assert float(zero) == 0.0


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "jamba-v0.1-52b",
                                  "xlstm-1.3b"])
def test_remat_changes_no_bit(arch):
    """``cfg.remat`` checkpoints every superblock, attention chunk, scan
    chunk, mLSTM chunk and loss chunk: the loss and every gradient leaf
    are the bits of the run without it."""
    _, cfg, _, p = _model(arch)
    batch = _t(_batch(cfg, seed=5))
    on = _port_grads(dataclasses.replace(cfg, remat=True), p, batch)
    off = _port_grads(dataclasses.replace(cfg, remat=False), p, batch)
    assert torch.equal(on[0], off[0])
    assert all(torch.equal(a, b) for a, b in zip(on[2], off[2]))


def test_training_route_launches_no_kernel(monkeypatch):
    """Under autograd the attention and the Mamba scan take their
    differentiable cores: ``ops.flash_attention`` and
    ``ops.selective_scan`` are never called (jamba runs both)."""
    _, cfg, _, p = _model("jamba-v0.1-52b")

    def refuse(*a, **k):
        raise AssertionError("kernel wrapper called under autograd")
    monkeypatch.setattr(ops, "flash_attention", refuse)
    monkeypatch.setattr(ops, "selective_scan", refuse)
    loss, _, grads = _port_grads(cfg, p, _t(_batch(cfg)))
    assert bool(torch.isfinite(loss)) and len(grads) > 0
    with pytest.raises(AssertionError, match="kernel wrapper"):
        T.forward_hidden(p, cfg, _t(_batch(cfg)))


def test_kernel_route_under_autograd_raises():
    """The kernel route forced under autograd raises in the wrappers (K6,
    K7 have no backward), before it would reach the card; without
    autograd the same call still asks for a CUDA tensor."""
    _, cfg, _, p = _model("jamba-v0.1-52b")
    batch = _t(_batch(cfg))
    leaves = tl._with_grad(p)
    with pytest.raises(RuntimeError, match="no backward"):
        T.forward_hidden(leaves, cfg, batch, impl="kernel")
    x = torch.randn(2, 16, cfg.d_model, requires_grad=True)
    with pytest.raises(RuntimeError, match="selective_scan .K7.: the "
                                           "kernel has no backward"):
        M.mamba_mix(tree_map(lambda t: t[0], p["blocks"][1]["mamba"]),
                    cfg, x, impl="kernel")
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="flash_attention .K6."):
        ops.flash_attention(q, q, q, impl="kernel")
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        T.forward_hidden(p, cfg, batch, impl="kernel")


def test_forward_hidden_differentiable_and_unchanged():
    """``forward_hidden`` under autograd records (its output has a
    gradient) and gives the bits of the serving call, which runs under
    inference mode."""
    _, cfg, _, p = _model("granite-moe-1b-a400m")
    batch = _t(_batch(cfg))
    serve = T.forward_hidden(p, cfg, batch)
    assert serve.is_inference()
    train = T.forward_hidden(tl._with_grad(p), cfg, batch)
    assert train.requires_grad
    torch.testing.assert_close(train.detach(), serve, rtol=0, atol=0)


def test_moe_serving_bits_and_differentiable_aux():
    """The MoE's serving call (in-place activations) and its autograd call
    (out of place) give the same bits; the aux losses carry a gradient to
    the router, as the reference's do."""
    _, cfg, _, p = _model("granite-moe-1b-a400m")
    moe = tree_map(lambda t: t[0], p["blocks"][0]["moe"])
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(4))
    with torch.inference_mode():
        y0, aux0 = MOE.moe_mlp(moe, cfg, x)
    leaves = tl._with_grad(moe)
    y1, aux1 = MOE.moe_mlp(leaves, cfg, x)
    assert torch.equal(y0, y1.detach())
    assert all(torch.equal(aux0[k], aux1[k].detach()) for k in aux0)
    (g,) = torch.autograd.grad(MOE.aux_loss(cfg, aux1), [leaves["router"]])
    assert float(torch.linalg.vector_norm(g)) > 0
