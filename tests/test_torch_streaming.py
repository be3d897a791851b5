"""The port's K-streamed path against the JAX package's, on the CPU: the
plain versions of the streamed kernels (moments, superposition, the
single-vector norm), ``core.ota.aggregate`` with ``k_block``, and the
``k_block`` streaming round with its lazy-batch hook.

Inputs are made from a seed with numpy (or by the JAX package) and carried
across as numpy; the two packages never share a PRNG stream, so the
reference's channel noise is handed to the port per round.  Each tolerance
is written beside its assertion.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.core import ota as jota
from repro.core import schemes as jschemes
from repro.core.channel import ChannelConfig as JChannelConfig
from repro.data.datasets import synthetic_mnist as jsynthetic_mnist
from repro.fed import runtime as jruntime
from repro.fed.kernel_path import aggregate_kernels as jaggregate_kernels
from repro.fl import DataSpec as JDataSpec
from repro.fl import ModelSpec as JModelSpec
from repro.fl.tasks import build_task as jbuild_task
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.grad_norm import blocked_sumsq as jblocked_sumsq
from repro_torch import interop
from repro_torch.core import ota
from repro_torch.core.channel import ChannelConfig
from repro_torch.data.datasets import FederatedSplit
from repro_torch.fed import runtime
from repro_torch.fl import tasks
from repro_torch.kernels import ops, ref

EPS32 = float(np.finfo(np.float32).eps)
# streamed vs dense, and port vs reference over several rounds: the blocked
# K-way sums re-associate, ~1 ulp per round compounding through the round
# map (the reference's own STREAM_TOL, tests/test_streaming.py)
STREAM_TOL = dict(rtol=3e-4, atol=1e-6)


def _stack(k, n, seed, zeros_every=None):
    """Normal rows with large values at each row's head and tail (a dropped
    or doubled edge element shows at once) and optional exact zeros."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((k, n)).astype(np.float32)
    if zeros_every:
        g[:, ::zeros_every] = 0.0
    g[:, :5] = 100.0
    g[:, -5:] = -50.0
    return g


def _sum_tol(terms_abs_sum, n):
    """Gap between two blocked fp32 sums of the same n terms: each is within
    (depth) eps sum|terms| of the exact value, the depth of order log2 n."""
    return 2.0 * math.ceil(math.log2(n)) * EPS32 * terms_abs_sum


# (K, N, k_block): N ragged against the reference's 1024-lane packing
KERNEL_SHAPES = [(8, 3001, 2), (6, 1000, 3), (4, 1000, 4), (5, 3001, 1)]


class TestStreamedPlainVersions:
    @pytest.mark.parametrize("k,n,kb", KERNEL_SHAPES)
    def test_moments_match_reference(self, k, n, kb):
        g = _stack(k, n, seed=k * 100 + n)
        got_sq, got_s = ops.batched_moments(torch.from_numpy(g), k_block=kb)
        g64 = g.astype(np.float64)
        for want_sq, want_s in (
                jref.streaming_moments_ref(jnp.asarray(g), kb),
                jops.batched_moments(jnp.asarray(g), k_block=kb,
                                     interpret=True)):
            # per device: two blocked fp32 sums of n terms
            np.testing.assert_array_less(
                np.abs(got_sq.numpy() - np.asarray(want_sq)),
                _sum_tol(np.sum(g64 * g64, 1), n))
            np.testing.assert_array_less(
                np.abs(got_s.numpy() - np.asarray(want_s)),
                _sum_tol(np.sum(np.abs(g64), 1), n))

    @pytest.mark.parametrize("k,n,kb", KERNEL_SHAPES)
    @pytest.mark.parametrize("pre", ["identity", "sign"])
    def test_superpose_matches_reference(self, k, n, kb, pre):
        g = _stack(k, n, seed=k + n, zeros_every=7 if pre == "sign" else None)
        rng = np.random.default_rng(n + kb)
        scale = rng.uniform(0.1, 2.0, k).astype(np.float32)
        noise = (0.05 * rng.standard_normal(n)).astype(np.float32)
        a = 1.3
        got = ops.ota_superpose(torch.from_numpy(g), torch.from_numpy(scale),
                                torch.from_numpy(noise), a, pre=pre,
                                k_block=kb)
        x = np.sign(g) if pre == "sign" else g
        # per coordinate: two K-term sums plus the noise add and the gain
        bound = a * (np.abs(scale) @ np.abs(x) + np.abs(noise))
        args = (jnp.asarray(g), jnp.asarray(scale), jnp.asarray(noise))
        for want in (
                jref.ota_superpose_streaming_ref(*args, jnp.float32(a),
                                                 pre=pre, k_block=kb),
                jops.ota_superpose(*args, a, pre=pre, k_block=kb,
                                   interpret=True)):
            np.testing.assert_array_less(
                np.abs(got.numpy() - np.asarray(want)),
                2 * (k + 2) * EPS32 * bound + 1e-30)

    def test_superpose_folds_blocks_in_order(self):
        """acc = ((p_0 + p_1) + p_2): the plain version is bitwise a fold
        of the per-block dense sums, in block order."""
        g = torch.from_numpy(_stack(6, 1000, seed=3))
        s = torch.linspace(0.5, 2.0, 6)
        z = torch.zeros(1000)
        got = ref.ota_superpose_streaming_ref(g, s, z, 1.0, k_block=2)
        p = [ref.ota_superpose_ref(g[i:i + 2], s[i:i + 2], z, 1.0)
             for i in (0, 2, 4)]
        assert torch.equal(got, 1.0 * ((((z + p[0]) + p[1]) + p[2]) + z))

    # the K-scale round's N = 2,048 and the Case-I round's N = 55,050 among
    # them, in one-row blocks: at two rows or more the reference's
    # blocked_sumsq_ref and its interpreted kernel differ by an ulp there
    # (the norm is compared at ops.grad_norm's default block_rows anyway)
    @pytest.mark.parametrize("n,block_rows", [(3001, 1), (8193, 8),
                                              (1000, 256), (2048, 1),
                                              (55_050, 1)])
    def test_sumsq_matches_reference(self, n, block_rows):
        x = _stack(1, n, seed=n)[0]
        x2, _, br = jops._pack_flat(jnp.asarray(x), block_rows=block_rows)
        want = jblocked_sumsq(x2, block_rows=br, interpret=True)
        np.testing.assert_array_equal(np.asarray(jref.blocked_sumsq_ref(x2, br)),
                                      np.asarray(want))
        got = ref.blocked_sumsq_ref(torch.from_numpy(np.array(x2)), br)
        rows = np.asarray(x2, np.float64).reshape(-1, br * 1024)
        # per block: two fp32 sums of br * 1024 squares
        np.testing.assert_array_less(np.abs(got.numpy() - np.asarray(want)),
                                     _sum_tol(np.sum(rows ** 2, 1), br * 1024)
                                     + 1e-30)
        norm = ops.grad_norm(torch.from_numpy(x))
        want_norm = jops.grad_norm(jnp.asarray(x), interpret=True)
        # sums of squares within _sum_tol relative; the root halves it
        np.testing.assert_allclose(float(norm), float(want_norm),
                                   rtol=(math.ceil(math.log2(n)) + 1) * EPS32)


# ---------------------------------------------------------------------------
# core.ota.aggregate with k_block

K_AGG = 8
AGG_SHAPES = {"w": (4, 5), "b": (7,)}
NOISE_VAR = 1e-3
NKEY = jax.random.fold_in(jax.random.PRNGKey(3), 3)


def _agg_inputs():
    rng = np.random.default_rng(21)
    g = {n: rng.standard_normal((K_AGG,) + s).astype(np.float32)
         for n, s in AGG_SHAPES.items()}
    h = (rng.uniform(0.1, 1.0, K_AGG) * 1e-3).astype(np.float32)
    b = np.full(K_AGG, 2.0, np.float32)
    h_hat = (h * (1.0 + 0.1 * rng.standard_normal(K_AGG))).astype(np.float32)
    zeros = {n: jnp.zeros(s, jnp.float32) for n, s in AGG_SHAPES.items()}
    z, _ = ravel_pytree(jschemes.add_channel_noise(zeros, NKEY, NOISE_VAR))
    return g, h, b, h_hat, np.array(z)


@pytest.mark.parametrize("backend", ["vmap", "kernels"])
@pytest.mark.parametrize("scheme", jschemes.names())
def test_streamed_aggregate_matches_reference_and_dense(scheme, backend):
    g, h, b, h_hat, z = _agg_inputs()
    kw = dict(scheme=scheme, a=10.0, noise_var=NOISE_VAR, grad_bound=5.0,
              backend=backend, k_block=4)
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    if backend == "kernels":
        want = jaggregate_kernels(jota.OTAConfig(**kw), jg, jnp.asarray(h),
                                  jnp.asarray(b), NKEY,
                                  h_hat=jnp.asarray(h_hat), k_block=4,
                                  interpret=True)
    else:
        want = jota.aggregate(jota.OTAConfig(**kw), jg, jnp.asarray(h),
                              jnp.asarray(b), NKEY, h_hat=jnp.asarray(h_hat))
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    args = (tg, torch.from_numpy(h), torch.from_numpy(b))
    got = ota.aggregate(ota.OTAConfig(**kw), *args,
                        h_hat=torch.from_numpy(h_hat),
                        noise=torch.from_numpy(z))
    dense = ota.aggregate(ota.OTAConfig(**{**kw, "k_block": None}), *args,
                          h_hat=torch.from_numpy(h_hat),
                          noise=torch.from_numpy(z))
    for k in AGG_SHAPES:
        w = np.asarray(want[k])
        # port vs reference, the same blocking: per-device norms and
        # K-block sums associated differently, ~ulps of the largest term
        # (the reference's kernel-level rtol 1e-6, with an atol at that
        # rtol of the leaf's scale for entries near 0)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), dense[k].numpy(),
                                   **STREAM_TOL, err_msg=k)


def test_streamed_aggregate_bad_k_block_raises():
    g, h, b, _, _ = _agg_inputs()
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    for backend in ("vmap", "kernels"):
        with pytest.raises(ValueError, match="divide"):
            ota.aggregate(ota.OTAConfig(backend=backend, k_block=3), tg,
                          torch.from_numpy(h), torch.from_numpy(b))


def test_pinned_sum_is_the_reference_fold():
    """pinned_sum reproduces the reference's fixed association bitwise
    (elementwise fp32 adds in the same order), for odd and even lengths."""
    rng = np.random.default_rng(4)
    for n in (1, 2, 7, 12, 100, 1001):
        v = rng.standard_normal(n).astype(np.float32) * 10.0 ** rng.uniform(
            -3, 3, n).astype(np.float32)
        got = ota.pinned_sum(torch.from_numpy(v))
        want = jota.pinned_sum(jnp.asarray(v))
        assert np.float32(got) == np.float32(want), n


# ---------------------------------------------------------------------------
# the streaming round

K = 12
KB = 4
ROUNDS = 6
DATA = dict(dataset="synthetic_mnist", split="dirichlet", alpha=1.0,
            batch_size=16, num_train=300, num_test=60, seed=0)


def _fl_kwargs(scheme):
    return dict(num_devices=K, scheme=scheme, case="I", p=0.75,
                smoothness_L=5.0, expected_loss_drop=2.0, grad_bound=10.0,
                seed=0)


@functools.lru_cache(maxsize=None)
def _reference(scheme, k_block):
    """The JAX package's streaming (or dense) rounds on its kernels backend,
    one python-driver round per call; returns the setup state, per-round
    batches, noise, params and history."""
    task = jbuild_task(JDataSpec(**DATA), JModelSpec(hidden=8), K)
    cfg = jruntime.FLConfig(
        backend="kernels", k_block=k_block,
        channel=JChannelConfig(num_devices=K, channel_mean=1e-3),
        **_fl_kwargs(scheme))
    state = jruntime.setup(cfg, task.params0, task.model_dim)
    setup = dict(params=jax.tree_util.tree_map(np.asarray, state.params),
                 h=state.h, h_hat=state.h_hat, b=state.b, a=state.a,
                 eta0=state.eta0, model_dim=state.model_dim)
    key = jax.random.PRNGKey(cfg.seed + 1)
    zeros = jax.tree_util.tree_map(lambda l: jnp.zeros(l.shape, jnp.float32),
                                   task.params0)
    noise, batches, params, hist = {}, {}, [], []
    for t in range(1, ROUNDS + 1):
        z, _ = ravel_pytree(jschemes.add_channel_noise(
            zeros, jax.random.fold_in(key, t), cfg.channel.noise_var))
        noise[t] = np.array(z)
        batches[t] = np.array(task.batch_provider(t)[0])
        state, h = jruntime.run(cfg, state, task.grad_fn, task.batch_provider,
                                1, driver="python")
        params.append(jax.tree_util.tree_map(np.array, state.params))
        hist.append({k: h[k][0] for k in jruntime.DIAG_KEYS})
    return task, setup, noise, batches, params, hist


def _port_task(jtask):
    split = FederatedSplit(tuple(jtask.constants["split"].indices))
    params0 = interop.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jtask.params0), device="cpu")
    n = DATA["num_train"]
    x, y = jsynthetic_mnist(jax.random.PRNGKey(DATA["seed"]),
                            n + DATA["num_test"])
    x, y = np.asarray(x), np.asarray(y)
    return tasks.mlp_task(x[:n], y[:n], x[n:], y[n:], split, params0,
                          batch_size=DATA["batch_size"], provider_seed=0,
                          device="cpu")


def _port_run(scheme, backend, k_block, rounds=ROUNDS, per_round=None,
              **run_kw):
    """The port's rounds from the reference's setup, batches and noise."""
    jtask, setup, noise, batches, _, _ = _reference(scheme, KB)
    task = _port_task(jtask)
    cfg = runtime.FLConfig(
        backend=backend, k_block=k_block,
        channel=ChannelConfig(num_devices=K, channel_mean=1e-3),
        **_fl_kwargs(scheme))
    state = interop.state_from_jax(
        setup["params"], setup["h"], setup["h_hat"], setup["b"], setup["a"],
        setup["eta0"], 0, model_dim=setup["model_dim"], device="cpu")
    provider = lambda t: (torch.from_numpy(batches[t]),)
    hist = []
    for t in range(1, rounds + 1):
        state, h = runtime.run(
            cfg, state, task.grad_fn,
            None if "block_batch_provider" in run_kw else provider, 1,
            noise_provider=lambda t: torch.from_numpy(noise[t]), **run_kw)
        hist.append({k: h[k][0] for k in runtime.DIAG_KEYS})
        if per_round is not None:
            per_round(t, state, hist[-1])
    return state, hist, batches, task


@pytest.mark.parametrize("backend", ["vmap", "kernels"])
@pytest.mark.parametrize("scheme", ["normalized", "benchmark2"])
def test_streaming_round_matches_reference(scheme, backend):
    _, _, _, _, want_params, want_hist = _reference(scheme, KB)

    def check(t, state, hist):
        for k, want in want_params[t - 1].items():
            np.testing.assert_allclose(state.params[k].numpy(), want,
                                       **STREAM_TOL,
                                       err_msg=f"{scheme} round {t} {k}")
        for k in runtime.DIAG_KEYS:
            # the same per-device terms; fp32 sums in other orders
            assert hist[k] == pytest.approx(want_hist[t - 1][k], rel=1e-4,
                                            abs=1e-9), (scheme, t, k)

    _port_run(scheme, backend, KB, per_round=check)


@pytest.mark.parametrize("backend", ["vmap", "kernels"])
def test_streaming_round_matches_dense_round(backend):
    """The port's own contract: streamed == dense within STREAM_TOL, with
    the same diagnostics (grad_norm_min/max exact up to the round's drift)."""
    sd, hd, _, _ = _port_run("normalized", backend, None)
    ss, hs, _, _ = _port_run("normalized", backend, KB)
    for k in sd.params:
        np.testing.assert_allclose(ss.params[k].numpy(), sd.params[k].numpy(),
                                   **STREAM_TOL, err_msg=k)
    for t in range(ROUNDS):
        for k in ("grad_norm_min", "grad_norm_max", "grad_norm_mean",
                  "tx_energy", "num_participants", "eta"):
            assert hs[t][k] == pytest.approx(hd[t][k], rel=1e-5), (t, k)


def test_block_batch_provider_is_bitwise_dense_batches():
    """The lazy-batch hook: each K-block's batch made from its device
    indices gives bitwise the run of the dense batches cut into blocks."""
    seen = []

    def block_provider(t, dev):
        # t is the round index as a 0-d int64 tensor on the device
        seen.append(dev.tolist())
        return (torch.from_numpy(batches[int(t)])[dev],)

    s1, h1, batches, _ = _port_run("normalized", "kernels", KB, rounds=3)
    s2, h2, _, _ = _port_run("normalized", "kernels", KB, rounds=3,
                             block_batch_provider=block_provider)
    for k in s1.params:
        assert torch.equal(s1.params[k], s2.params[k]), k
    assert h1 == h2
    assert seen[:3] == [list(range(i, i + KB)) for i in range(0, K, KB)]


def test_block_batch_provider_needs_k_block():
    cfg = runtime.FLConfig(num_devices=4)
    with pytest.raises(ValueError, match="k_block"):
        runtime.run(cfg, None, None, None, 1,
                    block_batch_provider=lambda t, d: None)


def test_kscale_task_matches_reference():
    """The K-scale case (benchmarks/kscale_case.py) cut to K = 64: a shared
    pool of examples, B rows per device drawn by (round, device) index,
    a {"w": [2048]} linear model, b = b_max and a = 1 / sum(h b), through
    block_batch_provider in both packages (the same index table, handed
    across as numpy)."""
    k, kb, d, pool, bsz, rounds = 64, 16, 2048, 256, 8, 3
    rng = np.random.default_rng(7)
    x = rng.standard_normal((pool, d)).astype(np.float32)
    y = (x @ rng.standard_normal(d) + 0.1 * rng.standard_normal(pool)
         ).astype(np.float32)
    rows = rng.integers(0, pool, (rounds, k, bsz))
    h = rng.rayleigh(1e-3, k)
    b = np.full(k, 5.0 ** 0.5)
    a = 1.0 / float(np.sum(h * b))
    jx, jy, jrows = jnp.asarray(x), jnp.asarray(y), jnp.asarray(rows)

    def jgrad(params, batch):
        xb, yb = batch
        r = xb @ params["w"] - yb
        return {"w": xb.T @ r / r.shape[0]}

    jcfg = jruntime.FLConfig(
        num_devices=k, case="I", p=0.75, scheme="normalized",
        backend="kernels", k_block=kb, seed=0,
        channel=JChannelConfig(num_devices=k, channel_mean=1e-3,
                               noise_var=1e-7))
    jstate = jruntime.FLState({"w": jnp.zeros((d,), jnp.float32)}, h, b, a,
                              eta0=1.0, model_dim=d)
    key = jax.random.PRNGKey(jcfg.seed + 1)
    noise = {t: np.array(jschemes.add_channel_noise(
        {"w": jnp.zeros((d,), jnp.float32)}, jax.random.fold_in(key, t),
        1e-7)["w"]) for t in range(1, rounds + 1)}
    jstate, jhist = jruntime.run(
        jcfg, jstate, jgrad, None, rounds, driver="python",
        block_batch_provider=lambda t, dev: (jx[jrows[t - 1][dev]],
                                             jy[jrows[t - 1][dev]]))

    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    trows = torch.from_numpy(rows)

    def tgrad(params, batch):
        xb, yb = batch
        r = xb @ params["w"] - yb
        return {"w": xb.T @ r / r.shape[0]}

    cfg = runtime.FLConfig(
        num_devices=k, case="I", p=0.75, scheme="normalized",
        backend="kernels", k_block=kb, seed=0,
        channel=ChannelConfig(num_devices=k, channel_mean=1e-3,
                              noise_var=1e-7))
    state = runtime.FLState({"w": torch.zeros(d)}, h, b, a, eta0=1.0,
                            model_dim=d)
    state, hist = runtime.run(
        cfg, state, tgrad, None, rounds,
        noise_provider=lambda t: torch.from_numpy(noise[t]),
        block_batch_provider=lambda t, dev: (tx[trows[t - 1][dev]],
                                             ty[trows[t - 1][dev]]))
    np.testing.assert_allclose(state.params["w"].numpy(),
                               np.asarray(jstate.params["w"]), **STREAM_TOL)
    np.testing.assert_allclose(hist["grad_norm_mean"],
                               jhist["grad_norm_mean"], rtol=1e-5)
