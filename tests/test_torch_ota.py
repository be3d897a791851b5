"""The port's ``core.ota.aggregate`` on its ``vmap`` and ``kernels`` backends
against the JAX package's ``aggregate`` (vmap) and ``aggregate_kernels``
(Pallas interpret mode), for every registered scheme, with and without a
CSI estimate ``h_hat``.

The channel noise is the JAX package's own draw
(``repro.core.schemes.add_channel_noise`` on the shared key), raveled and
handed to the port as numpy: the two packages never share a PRNG stream.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.core import ota as jota
from repro.core import schemes as jschemes
from repro.fed.kernel_path import aggregate_kernels as jaggregate_kernels
from repro_torch.core import ota, schemes
from repro_torch.kernels import ops

K = 6
SHAPES = {"p0": (9, 5), "p1": (33,), "p2": (4, 3, 2)}
GRAD_BOUND = 7.5
NOISE_VAR = 2.5e-3
NKEY = jax.random.fold_in(jax.random.PRNGKey(11), 9)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread in this file: intra-op threads on these small
    tensors stall on the loaded machine of the parallel run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    g = {n: rng.standard_normal((K,) + s).astype(np.float32)
         for n, s in SHAPES.items()}
    h = (np.abs(rng.standard_normal(K)) + 0.1).astype(np.float32)
    b = (np.abs(rng.standard_normal(K)) + 0.5).astype(np.float32)
    h_hat = (h * (1.0 + 0.1 * rng.standard_normal(K))).astype(np.float32)
    return g, h, b, h_hat


def _jax_noise():
    zeros = {n: jnp.zeros(s, jnp.float32) for n, s in SHAPES.items()}
    z, _ = ravel_pytree(jschemes.add_channel_noise(zeros, NKEY, NOISE_VAR))
    return np.array(z)


def _cfgs(scheme, noisy, backend):
    kw = dict(scheme=scheme, a=1.3, noise_var=NOISE_VAR if noisy else 0.0,
              grad_bound=GRAD_BOUND, noiseless=not noisy)
    return jota.OTAConfig(backend=backend, **kw), ota.OTAConfig(
        backend=backend, **kw)


def _to_torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _assert_trees_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        # the reference's own cross-backend tolerance (tests/test_backends.py):
        # fp32 K-way reductions and norms associated in different orders
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2e-4, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("backend", ["vmap", "kernels"])
@pytest.mark.parametrize("with_h_hat", [False, True])
@pytest.mark.parametrize("scheme", jschemes.names())
def test_aggregate_matches_reference(scheme, with_h_hat, backend):
    assert schemes.names() == jschemes.names()
    g, h, b, h_hat = _inputs()
    jcfg, tcfg = _cfgs(scheme, True, backend)
    jh_hat = jnp.asarray(h_hat) if with_h_hat else None
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    if backend == "vmap":
        want = jota.aggregate(jcfg, jg, jnp.asarray(h), jnp.asarray(b), NKEY,
                              h_hat=jh_hat)
    else:
        want = jaggregate_kernels(jcfg, jg, jnp.asarray(h), jnp.asarray(b),
                                  NKEY, h_hat=jh_hat, interpret=True)
    got = ota.aggregate(tcfg, _to_torch(g), torch.from_numpy(h),
                        torch.from_numpy(b),
                        h_hat=torch.from_numpy(h_hat) if with_h_hat else None,
                        noise=torch.from_numpy(_jax_noise()))
    _assert_trees_close(got, want)


@pytest.mark.parametrize("scheme", schemes.names())
def test_backends_agree_on_one_generator_draw(scheme):
    """The port's own contract: both backends draw the same noise from one
    seed, and agree to fp32 reduction order."""
    g, h, b, _ = _inputs(seed=1)
    _, vcfg = _cfgs(scheme, True, "vmap")
    _, kcfg = _cfgs(scheme, True, "kernels")
    out = [ota.aggregate(c, _to_torch(g), torch.from_numpy(h),
                         torch.from_numpy(b),
                         generator=torch.Generator().manual_seed(5))
           for c in (vcfg, kcfg)]
    for k in SHAPES:
        torch.testing.assert_close(out[1][k], out[0][k], rtol=2e-4, atol=2e-5)


def test_noiseless_ignores_injected_noise():
    g, h, b, _ = _inputs()
    _, cfg = _cfgs("normalized", False, "kernels")
    args = (cfg, _to_torch(g), torch.from_numpy(h), torch.from_numpy(b))
    quiet = ota.aggregate(*args)
    injected = ota.aggregate(*args, noise=torch.ones(sum(
        int(np.prod(s)) for s in SHAPES.values())))
    for k in SHAPES:
        assert torch.equal(quiet[k], injected[k])


def test_kernels_backend_on_cpu_counts_no_launch():
    g, h, b, _ = _inputs()
    _, cfg = _cfgs("benchmark2", True, "kernels")
    ops.reset_launch_counts()
    ota.aggregate(cfg, _to_torch(g), torch.from_numpy(h), torch.from_numpy(b),
                  generator=torch.Generator().manual_seed(0))
    assert set(ops.LAUNCH_COUNTS.values()) == {0}


# these two fields raised NotImplementedError until the FL-device mesh was
# ported; each case now holds the port's OTAConfig to the reference's on a
# valid and an invalid value (the ids are the ones the cases had)
@pytest.mark.parametrize("field,valid,invalid,error", [
    ("backend", dict(backend="mesh"), dict(backend="mesh", k_block=4),
     "mesh backend"),
    ("device_mesh", dict(device_mesh=2, k_block=4),
     dict(device_mesh=0, k_block=4), ">= 1"),
], ids=["backend-mesh-item 15", "device_mesh-2-item 15"])
def test_unported_config_raises(field, valid, invalid, error):
    """The same values build on both packages, and an invalid one raises
    the same ValueError on both."""
    for cls in (ota.OTAConfig, jota.OTAConfig):
        assert getattr(cls(**valid), field) == valid[field]
        with pytest.raises(ValueError, match=error):
            cls(**invalid)


def test_k_block_config_is_validated():
    """k_block is ported: it builds, and bad values raise ValueError as the
    reference's OTAConfig does."""
    assert ota.OTAConfig(k_block=2).k_block == 2
    with pytest.raises(ValueError, match=">= 1"):
        ota.OTAConfig(k_block=0)
    with pytest.raises(ValueError, match="mesh"):
        ota.OTAConfig(backend="mesh", k_block=4)
    with pytest.raises(ValueError, match="mesh"):
        jota.OTAConfig(backend="mesh", k_block=4)


def test_apply_update_is_eq11():
    w = {"a": torch.ones(3), "b": torch.zeros(2)}
    y = {"a": torch.full((3,), 2.0), "b": torch.ones(2)}
    out = ota.apply_update(w, y, 0.25)
    assert torch.equal(out["a"], torch.full((3,), 0.5))
    assert torch.equal(out["b"], torch.full((2,), -0.25))


# ---------------------------------------------------------------------------
# the per-device helpers and the power accounting (core/ota.py's residues)


def test_per_device_helpers_are_exported():
    import repro.core as jcore
    import repro_torch.core as tcore
    for name in ("per_device_norm", "per_device_sq_norm",
                 "per_device_mean_std", "tree_num_elements",
                 "transmit_norms", "transmit_energy"):
        assert getattr(tcore, name) is getattr(ota, name)
        assert hasattr(jcore, name)


def test_per_device_helpers_match_reference():
    g, _, _, _ = _inputs(seed=3)
    tg, jg = _to_torch(g), {k: jnp.asarray(v) for k, v in g.items()}
    assert ota.tree_num_elements(tg) == jota.tree_num_elements(jg) == 102
    # per device: fp32 sums of N = 102 terms in other orders
    for name in ("per_device_sq_norm", "per_device_norm"):
        np.testing.assert_allclose(getattr(ota, name)(tg).numpy(),
                                   np.asarray(getattr(jota, name)(jg)),
                                   rtol=1e-6, err_msg=name)
    for got, want in zip(ota.per_device_mean_std(tg),
                         jota.per_device_mean_std(jg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("scheme", jschemes.names())
def test_transmit_norms_and_energy_match_reference(scheme, with_mask):
    g, _, b, _ = _inputs(seed=4)
    tg, jg = _to_torch(g), {k: jnp.asarray(v) for k, v in g.items()}
    mask = np.array([1, 0, 1, 1, 0, 1], np.float32)
    got = ota.transmit_energy(scheme, tg, torch.from_numpy(b), GRAD_BOUND,
                              torch.from_numpy(mask) if with_mask else None)
    want = jota.transmit_energy(scheme, jg, jnp.asarray(b), GRAD_BOUND,
                                jnp.asarray(mask) if with_mask else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(
        ota.transmit_norms(scheme, tg, GRAD_BOUND).numpy(),
        np.asarray(jota.transmit_norms(scheme, jg, GRAD_BOUND)), rtol=1e-5,
        atol=1e-6)
    if scheme == "normalized":
        np.testing.assert_allclose(
            ota.transmit_norms(scheme, tg).numpy(), np.ones(K), rtol=1e-6)


def test_aggregate_normalized_kernels_matches_reference():
    """The pre-registry entry point for ``normalized`` against the
    reference's (Pallas in interpret mode), on the reference's noise, and
    its plain oracle ``ota_aggregate_ref`` against the reference's."""
    from repro.fed.kernel_path import (aggregate_normalized_kernels as
                                       jnormalized)
    from repro.kernels import ref as jref
    from repro_torch.fed.kernel_path import aggregate_normalized_kernels
    from repro_torch.kernels import ref
    g, h, b, _ = _inputs(seed=5)
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    want = jnormalized(jg, jnp.asarray(h), jnp.asarray(b), 1.3, NKEY,
                       NOISE_VAR, interpret=True)
    got = aggregate_normalized_kernels(
        _to_torch(g), torch.from_numpy(h), torch.from_numpy(b), 1.3,
        noise_var=NOISE_VAR, noise=torch.from_numpy(_jax_noise()))
    _assert_trees_close(got, want)
    # its dense form against the oracle: y = a (sum_k scale_k g_k + z)
    flat = np.concatenate([g[k].reshape(K, -1) for k in sorted(g)], axis=1)
    norms = np.linalg.norm(flat.astype(np.float64), axis=1).astype(np.float32)
    scale = (h * b / (norms + 1e-12)).astype(np.float32)
    z = _jax_noise()
    oracle = ref.ota_aggregate_ref(torch.from_numpy(flat),
                                   torch.from_numpy(scale),
                                   torch.from_numpy(z), 1.3)
    np.testing.assert_allclose(
        oracle.numpy(), np.asarray(jref.ota_aggregate_ref(
            jnp.asarray(flat), jnp.asarray(scale), jnp.asarray(z), 1.3)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ota.ravel(got).numpy(), oracle.numpy(),
                               **dict(rtol=2e-4, atol=2e-5))
