"""The port's radio environment (``repro_torch.channels``,
``core/channel.py``), its Problem-3 solver of the rounds
(``amplification.solve_problem3_torch``) and the convergence bounds
(``core/convergence.py``) against the JAX package's.

The reference draws on threefry keys and the port on CPU generators, so the
two are compared on the same standard normals and uniforms (the reference's
own, made from a key, or numpy's from a seed), each with its tolerance
stated.  Statistics and the bitwise identities are checked on the port's own
draws.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st
from repro import channels as jchl
from repro.core import amplification as jamp
from repro.core import channel as jchan
from repro.core import convergence as jconv
from repro_torch import channels as chl
from repro_torch import rng
from repro_torch.core import amplification as amp
from repro_torch.core import channel as chan
from repro_torch.core import convergence as conv

K = 6
KEY = jax.random.PRNGKey(0)
# the same fp32 inputs in fp32 arithmetic on both sides, a few ops apart
DRAW_RTOL = 1e-6


def _normals(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


class TestConfigValidation:
    """``ChannelConfig`` and ``GeometryConfig`` accept and reject what the
    reference's do, on the same kwargs."""

    @pytest.mark.parametrize("kw", [
        dict(channel_mean=0.0), dict(channel_mean=-1e-5),
        dict(noise_var=-1e-7), dict(b_max=0.0), dict(b_max=-2.0),
        dict(num_devices=0), dict(rician_k=-1.0), dict(rho=1.0),
        dict(rho=-0.1), dict(csi_error=-0.5), dict(model="nope"),
        dict(csi_error_model="nope")])
    def test_rejects_as_the_reference(self, kw):
        base = dict(num_devices=K)
        base.update(kw)
        with pytest.raises(ValueError) as want:
            jchan.ChannelConfig(**base)
        with pytest.raises(ValueError) as got:
            chan.ChannelConfig(**base)
        # the same message, up to the registry's name list
        assert str(got.value).split(";")[0] == str(want.value).split(";")[0]

    @pytest.mark.parametrize("kw", [
        dict(), dict(model="rician", rician_k=3.0),
        dict(model="ar1", rho=0.9), dict(block_fading=True, csi_error=0.2),
        dict(csi_error=0.3, csi_error_model="multiplicative"),
        dict(model="ar1", rho=0.0, block_fading=True)])
    def test_accepts_as_the_reference(self, kw):
        want = jchan.ChannelConfig(num_devices=K, channel_mean=1e-3, **kw)
        got = chan.ChannelConfig(num_devices=K, channel_mean=1e-3, **kw)
        assert got.time_varying() == want.time_varying()
        assert got.amplitude_scale() == want.amplitude_scale()

    @pytest.mark.parametrize("kw", [
        dict(min_distance=0.0), dict(min_distance=600.0, cell_radius=500.0),
        dict(path_loss_exp=-1.0), dict(shadowing_std_db=-2.0),
        dict(ref_distance=0.0)])
    def test_geometry_rejects_as_the_reference(self, kw):
        with pytest.raises(ValueError) as want:
            jchl.GeometryConfig(**kw)
        with pytest.raises(ValueError) as got:
            chl.GeometryConfig(**kw)
        assert str(got.value) == str(want.value)

    def test_registry(self):
        assert chl.names() == jchl.names()
        for name in chl.names():
            assert chl.get(name).time_varying == jchl.get(name).time_varying
            assert chl.get(name).has_state == jchl.get(name).has_state
        assert chl.CSI_ERROR_MODELS == jchl.CSI_ERROR_MODELS
        with pytest.raises(ValueError, match="unknown channel model"):
            chl.get("missing")


class TestDrawsMatchReference:
    """Given the same normals or uniforms, the port's functions give the
    reference's values at rtol 1e-6."""

    @pytest.mark.parametrize("vector", [False, True])
    def test_envelope(self, vector):
        state = _normals(1, (K, 2))
        scale = (np.linspace(1e-4, 6e-4, K).astype(np.float32) if vector
                 else 3e-4)
        want = jchan.envelope(jnp.asarray(state), jnp.asarray(scale))
        got = chan.envelope(torch.from_numpy(state), torch.as_tensor(scale))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=DRAW_RTOL)

    @pytest.mark.parametrize("model,kw", [
        ("rayleigh", {}), ("rician", dict(rician_k=3.0)),
        ("ar1", dict(rho=0.7))])
    def test_model_step(self, model, kw):
        jcfg = jchan.ChannelConfig(num_devices=K, channel_mean=1e-3,
                                   model=model, **kw)
        cfg = chan.ChannelConfig(num_devices=K, channel_mean=1e-3,
                                 model=model, **kw)
        scale = cfg.amplitude_scale()
        state = _normals(2, (K, 2))
        key_t = jax.random.fold_in(KEY, 5)
        # the reference's own innovation draw, handed to the port
        w = np.array(jchan.draw_fading_state(key_t, K))
        step = jchl.get(model).step
        x0 = jnp.asarray(state)
        h_want, s_want = step(jcfg, scale, key_t, x0, cfg.rho)  # tracelint: disable=TL002 the step redraws w from key_t: the same draw on purpose
        h_got, s_got = chl.get(model).step(cfg, scale, torch.from_numpy(w),
                                           torch.from_numpy(state), cfg.rho)
        np.testing.assert_allclose(h_got.numpy(), np.asarray(h_want),
                                   rtol=DRAW_RTOL)
        assert (s_got is None) == (s_want is None)
        if s_got is not None:
            np.testing.assert_allclose(s_got.numpy(), np.asarray(s_want),
                                       rtol=DRAW_RTOL, atol=1e-7)

    @pytest.mark.parametrize("model", ["additive", "multiplicative"])
    @pytest.mark.parametrize("vector", [False, True])
    def test_estimate(self, model, vector):
        h = np.abs(_normals(3, (K,))) * 1e-3
        scale = (np.linspace(1e-4, 6e-4, K).astype(np.float32) if vector
                 else 8e-4)
        key = jax.random.fold_in(KEY, 9)
        e = np.array(jax.random.normal(key, (K,), jnp.float32))
        hj, sj = jnp.asarray(h), jnp.asarray(scale)
        want = jchl.estimate(hj, key, 0.3, sj, model)  # tracelint: disable=TL002 estimate redraws e from key: the same draw on purpose
        got = chl.estimate(torch.from_numpy(h), torch.from_numpy(e), 0.3,
                           torch.as_tensor(scale), model)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=DRAW_RTOL)
        # exactly h at csi_error = 0
        assert torch.equal(chl.estimate(torch.from_numpy(h),
                                        torch.from_numpy(e), 0.0, 8e-4,
                                        model), torch.from_numpy(h))

    @pytest.mark.parametrize("shadow", [0.0, 4.0])
    def test_relative_gains(self, shadow):
        geo_j = jchl.GeometryConfig(shadowing_std_db=shadow)
        geo = chl.GeometryConfig(shadowing_std_db=shadow)
        key = jax.random.fold_in(KEY, 11)
        want = jchl.relative_gains(key, geo_j, 64)
        u = np.array(jax.random.uniform(key, (64,)))  # tracelint: disable=TL002 relative_gains's own uniforms, drawn again on purpose
        x = np.array(jax.random.normal(jax.random.fold_in(key, 1), (64,)))
        got = chl.geometry.gains(torch.from_numpy(u), torch.from_numpy(x),
                                 geo)
        np.testing.assert_allclose(got.numpy(), want, rtol=DRAW_RTOL)
        np.testing.assert_allclose(
            chl.geometry.distances(torch.from_numpy(u), geo).numpy(),
            jchl.draw_distances(key, geo_j, 64),  # tracelint: disable=TL002 the same uniforms on purpose
            rtol=DRAW_RTOL)

    @pytest.mark.parametrize("k_factor", [0.0, 0.5, 3.0, 20.0])
    def test_amplitude_scale(self, k_factor):
        kw = dict(num_devices=K, channel_mean=2e-3, model="rician",
                  rician_k=k_factor)
        np.testing.assert_allclose(
            chan.ChannelConfig(**kw).amplitude_scale(),
            jchan.ChannelConfig(**kw).amplitude_scale(), rtol=DRAW_RTOL)

    def test_mean_snr_db(self):
        kw = dict(num_devices=K, channel_mean=1e-3)
        b = np.linspace(0.5, 2.0, K)
        assert chan.mean_snr_db(chan.ChannelConfig(**kw), b) == \
            pytest.approx(jchan.mean_snr_db(jchan.ChannelConfig(**kw), b),
                          rel=1e-6)


class TestStatistics:
    """The port's own draws (the reference's tests/test_channels.py
    statistics, same bounds)."""

    def test_rayleigh_mean(self):
        cfg = chan.ChannelConfig(num_devices=200_000, channel_mean=1e-3)
        h, _ = chl.get("rayleigh").init(cfg, cfg.amplitude_scale(),
                                        rng.generator(0))
        assert abs(float(h.double().mean()) - 1e-3) / 1e-3 < 0.02

    @pytest.mark.parametrize("k_factor", [0.0, 1.0, 5.0, 20.0])
    def test_rician_mean_calibrated(self, k_factor):
        cfg = chan.ChannelConfig(num_devices=200_000, channel_mean=1e-3,
                                 model="rician", rician_k=k_factor)
        h, _ = chl.get("rician").init(cfg, cfg.amplitude_scale(),
                                      rng.generator(1))
        assert abs(float(h.double().mean()) - 1e-3) / 1e-3 < 0.02
        assert float(h.min()) >= 0.0

    @pytest.mark.parametrize("rho", [0.3, 0.9])
    def test_ar1_stationary_marginal(self, rho):
        cfg = chan.ChannelConfig(num_devices=20_000, channel_mean=1e-3,
                                 model="ar1", rho=rho)
        model = chl.get("ar1")
        scale = cfg.amplitude_scale()
        h, state = model.init(cfg, scale, rng.generator(2))
        want_std = scale * math.sqrt(2.0 - math.pi / 2.0)
        for t in range(6):
            if t:
                h, state = model.step(cfg, scale, rng.generator(2, t), state,
                                      rho)
            assert abs(float(h.double().mean()) - 1e-3) / 1e-3 < 0.03
            assert abs(float(h.double().std()) - want_std) / want_std < 0.03

    def test_ar1_correlates_rounds(self):
        cfg = chan.ChannelConfig(num_devices=5_000, channel_mean=1e-3,
                                 model="ar1")
        model = chl.get("ar1")
        scale = cfg.amplitude_scale()
        h0, state = model.init(cfg, scale, rng.generator(3))
        h_corr, _ = model.step(cfg, scale, rng.generator(3, 1), state, 0.99)
        h_iid, _ = model.step(cfg, scale, rng.generator(3, 1), state, 0.0)
        corr_rel = float((h_corr - h0).abs().mean()) / 1e-3
        iid_rel = float((h_iid - h0).abs().mean()) / 1e-3
        assert corr_rel < 0.2 < iid_rel

    def test_estimate_spread(self):
        cfg = chan.ChannelConfig(num_devices=100_000, channel_mean=1e-3)
        h = chan.draw_channel(rng.generator(4), cfg)
        e = torch.randn(100_000, generator=rng.generator(5))
        hh = chl.estimate(h, e, 0.25, cfg.amplitude_scale(), "additive")
        want = 0.25 * cfg.amplitude_scale()
        assert abs(float((hh - h).double().std()) - want) / want < 0.05
        assert float(hh.min()) >= 0.0


class TestBitwiseIdentities:
    def test_default_draw_keeps_its_bits(self):
        """``draw_channel`` with no scale is the [K, 2] randn of the
        generator, enveloped at ``rayleigh_scale``; the rayleigh model's
        init and an explicit scalar scale give the same bits."""
        cfg = chan.ChannelConfig(num_devices=16, channel_mean=1e-3)
        iq = torch.randn((16, 2), generator=rng.generator(7))
        want = cfg.rayleigh_scale() * torch.sqrt(torch.sum(iq * iq, dim=-1))
        assert torch.equal(chan.draw_channel(rng.generator(7), cfg), want)
        assert torch.equal(chan.draw_channel(rng.generator(7), cfg,
                                             cfg.rayleigh_scale()), want)
        h, state = chl.get("rayleigh").init(cfg, cfg.amplitude_scale(),
                                            rng.generator(7))
        assert torch.equal(h, want) and state is None

    def test_rician_k0_is_rayleigh(self):
        cfg = chan.ChannelConfig(num_devices=64, channel_mean=1e-3,
                                 model="rician", rician_k=0.0)
        h_ric, _ = chl.get("rician").init(cfg, cfg.amplitude_scale(),
                                          rng.generator(8))
        h_ray, _ = chl.get("rayleigh").init(cfg, cfg.amplitude_scale(),
                                            rng.generator(8))
        assert torch.equal(h_ric, h_ray)

    def test_ar1_rho0_is_block_fading(self):
        cfg = chan.ChannelConfig(num_devices=16, channel_mean=1e-3,
                                 model="ar1")
        fading = chan.ChannelConfig(num_devices=16, channel_mean=1e-3,
                                    block_fading=True)
        model = chl.get("ar1")
        scale = cfg.amplitude_scale()
        _, state = model.init(cfg, scale, rng.generator(9))
        for t in (1, 2, 7):
            h_ar, state = model.step(cfg, scale, rng.generator(9, t), state,
                                     0.0)
            assert torch.equal(h_ar, chan.channel_for_round(9, fading, t,
                                                            scale))

    def test_scale_vector_and_wrong_length(self):
        cfg = chan.ChannelConfig(num_devices=6, channel_mean=1e-3)
        s = torch.arange(1, 7, dtype=torch.float32) * 1e-4
        base = chan.draw_channel(rng.generator(1), cfg, 1.0)
        np.testing.assert_allclose(chan.draw_channel(rng.generator(1), cfg,
                                                     s).numpy(),
                                   (s * base).numpy(), rtol=1e-6)
        with pytest.raises(ValueError, match="per-device scale"):
            chan.draw_channel(rng.generator(1), cfg, torch.ones(4))


class TestBlockDraws:
    """The device-indexed schedule: any blocking of [0, K) concatenates to
    the same bits."""

    def test_derive_seeds_is_derive_seed(self):
        idx = [0, 1, 2, 99_999, 12345]
        got = rng.derive_seeds(17, torch.tensor(idx))
        assert [int(v) for v in got] == [rng.derive_seed(17, i)
                                         for i in idx]

    @pytest.mark.parametrize("block", [8, 16])
    def test_blocking_invariant(self, block):
        cfg = chan.ChannelConfig(num_devices=64, channel_mean=1e-3)
        geo = chl.GeometryConfig(shadowing_std_db=4.0)
        whole = torch.arange(64)
        h = chan.draw_channel_block(7, cfg, whole)
        g = chl.geometry.relative_gains_block(7, geo, whole)
        hb = torch.cat([chan.draw_channel_block(7, cfg, whole[lo:lo + block])
                        for lo in range(0, 64, block)])
        gb = torch.cat([chl.geometry.relative_gains_block(
            7, geo, whole[lo:lo + block]) for lo in range(0, 64, block)])
        assert torch.equal(h, hb) and torch.equal(g, gb)
        sub = torch.tensor([63, 2, 17, 40])
        assert torch.equal(chan.draw_channel_block(7, cfg, sub), h[sub])
        assert torch.equal(chl.geometry.relative_gains_block(7, geo, sub),
                           g[sub])

    def test_block_draws_are_standard(self):
        w = chan.draw_fading_state_block(3, torch.arange(200_000)).double()
        assert abs(float(w.mean())) < 0.01
        assert abs(float(w.std()) - 1.0) < 0.01
        g = chl.geometry.relative_gains_block(
            3, chl.GeometryConfig(), torch.arange(1000))
        d = chl.geometry.distances(
            rng.block_uniforms(3, torch.arange(1000), (2,))[:, 0],
            chl.GeometryConfig())
        assert (d >= 50.0).all() and (d <= 500.0).all()
        np.testing.assert_allclose(g.numpy(),
                                   ((d / 300.0) ** -1.5).numpy(), rtol=1e-12)


def _rayleigh(seed, k, mean=1e-3):
    return np.random.default_rng(seed).rayleigh(mean / math.sqrt(math.pi / 2),
                                                k)


class TestSolver:
    """``solve_problem3_torch`` against the reference's
    ``solve_problem3_jax`` on the same fp32 h (Z at rtol 1e-5, b at atol
    1e-5 b_max, the same iteration count) and against SciPy's
    ``solve_problem3`` at tests/test_engine.py's tolerances."""

    CASES = [(0, 20, 1000, 1e-7), (1, 3, 50, 1e-7), (2, 8, 100_000, 1e-7),
             (3, 12, 10, 1e-7), (4, 20, 30, 1e-7), (5, 20, 55_050, 1e-9),
             (6, 5, 8, 0.0)]

    @pytest.mark.parametrize("seed,k,n,noise", CASES)
    def test_matches_the_jax_solver(self, seed, k, n, noise):
        h = _rayleigh(seed, k).astype(np.float32)
        b_max = math.sqrt(5.0)
        want = jamp.solve_problem3_jax(jnp.asarray(h), noise, n, b_max)
        got = amp.solve_problem3_torch(torch.from_numpy(h), noise, n, b_max)
        np.testing.assert_allclose(float(got.Z), float(want.Z), rtol=1e-5)
        np.testing.assert_allclose(got.b.numpy(), np.asarray(want.b),
                                   atol=1e-5 * b_max)
        assert int(got.iterations) == int(want.iterations)

    @pytest.mark.parametrize("seed,k,n", [(0, 20, 1000), (1, 3, 50),
                                          (2, 8, 100000), (3, 12, 10)])
    def test_matches_scipy(self, seed, k, n):
        h = _rayleigh(seed, k)
        ref = amp.solve_problem3(h, 1e-7, n, math.sqrt(5))
        got = amp.solve_problem3_torch(torch.as_tensor(h), 1e-7, n,
                                       math.sqrt(5))
        np.testing.assert_allclose(float(got.Z), ref.Z, rtol=1e-4)
        np.testing.assert_allclose(got.b.numpy(), ref.b, atol=5e-3)
        b = got.b.numpy()
        assert (b >= -1e-7).all() and (b <= math.sqrt(5) + 1e-6).all()

    def test_noiseless_edge_equalizes(self):
        sol = amp.solve_problem3_torch(torch.tensor([1.0, 2.0, 4.0]), 0.0, 1,
                                       10.0)
        hb = np.array([1.0, 2.0, 4.0]) * sol.b.numpy()
        assert np.std(hb) / np.mean(hb) < 0.05

    @settings(max_examples=15, deadline=None)
    @given(seed=st.integers(0, 10_000), k=st.integers(2, 16),
           log_noise=st.floats(-9, -4), n=st.integers(1, 200_000))
    def test_property_matches_scipy(self, seed, k, log_noise, n):
        h = _rayleigh(seed, k)
        noise = 10.0 ** log_noise
        ref = amp.solve_problem3(h, noise, n, 2.0)
        got = amp.solve_problem3_torch(torch.as_tensor(h), noise, n, 2.0)
        np.testing.assert_allclose(float(got.Z), ref.Z, rtol=2e-4)

    def test_batched_rows_are_their_solo_solves(self):
        """One [R, K] call with per-row sigma^2 and b_max is bitwise R solo
        calls, rows that stop early frozen (the vmapped while_loop's
        contract)."""
        h = torch.from_numpy(np.stack([_rayleigh(s, 20) for s in range(12)])
                             ).float()
        h[3] *= 1e3                       # rows of very different scales
        noise = torch.tensor([1e-7, 1e-9, 0.0, 1e-5] * 3)
        b_max = torch.tensor([math.sqrt(5.0), 1.0, 3.0] * 4)
        got = amp.solve_problem3_torch(h, noise, 30, b_max)
        iters = set()
        for i in range(12):
            solo = amp.solve_problem3_torch(h[i], noise[i], 30, b_max[i])
            for a, b in zip(solo, got):
                assert torch.equal(a, b[i]), i
            iters.add(int(solo.iterations))
        assert len(iters) > 1             # rows did stop at different steps

    def test_solve_problem6_is_the_reference(self):
        h = _rayleigh(3, 6)
        b_max = np.full(6, math.sqrt(5.0))
        r = 1.2 * amp.solve_problem3(h, 1e-7, 100, b_max).r_star
        v, b = amp.solve_problem6(r, h, 1e-7, 100, b_max)
        vj, bj = jamp.solve_problem6(r, h, 1e-7, 100, b_max)
        assert v == vj and np.array_equal(b, bj)
        assert v <= 0.0            # r above r* is feasible


class TestConvergence:
    """The bounds are the reference's on the same inputs."""

    H = np.array([1.1e-3, 0.7e-3, 1.9e-3, 0.4e-3])
    B = np.array([2.0, 1.5, 0.8, 2.2])

    @pytest.mark.parametrize("name,args", [
        ("variance_term", (H, B, 1e-7, 30)),
        ("case1_bound", (50, 0.75, 120.0, H, B, 5.0, math.pi / 3, 1e-7, 30,
                         2.0)),
        ("q_max", (0.01, 120.0, H, B, 0.5, 25.0, math.pi / 3)),
        ("case2_bound", (40, 0.01, 120.0, H, B, 2.0, 0.5, 25.0, math.pi / 3,
                         1e-7, 30, 4.0)),
        ("case2_bias_floor", (0.3, 2.0, 25.0, 0.5, math.pi / 3, 0.995)),
        ("s_for_epsilon", (0.01, 0.3, 2.0, 25.0, 0.5, math.pi / 3)),
        ("rounds_to_reach", (1e-3, 0.98, 4.0, 2.0)),
        ("rounds_to_reach", (1e-3, 1.5, 4.0, 2.0)),
    ])
    def test_bounds(self, name, args):
        assert getattr(conv, name)(*args) == getattr(jconv, name)(*args)

    def test_fit_rate(self):
        errs = 3.0 * 0.97 ** np.arange(40) + 1e-3
        want = jconv.fit_rate(errs)
        assert conv.fit_rate(errs) == conv.RateFit(want.exponent, want.ratio)
        with pytest.raises(ValueError):
            conv.case1_bound(10, 0.4, 1.0, self.H, self.B, 1.0, 1.0, 1e-7, 3,
                             1.0)

    def test_core_exports(self):
        import repro.core as jcore
        import repro_torch.core as core
        for name in ("case1_bound", "case2_bound", "q_max",
                     "case2_bias_floor", "s_for_epsilon", "variance_term",
                     "rounds_to_reach", "fit_rate", "RateFit",
                     "solve_problem6", "channel_for_round",
                     "draw_fading_state", "draw_noise", "envelope"):
            assert hasattr(core, name) and hasattr(jcore, name), name
        assert core.solve_problem3_torch is amp.solve_problem3_torch
