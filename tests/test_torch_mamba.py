"""The port's selective scan (K7's plain version) and Mamba mixer against
the JAX package, on the CPU.

The scan is held to ``repro.kernels.ref.selective_scan_ref`` (the oracle;
the reference's Pallas scan does not run on this jax) and its final state
to the reference model's ``_chunk_scan``; the mixer and its decode step to
``repro.models.mamba`` on the reduced jamba config in fp32, with the
reference's params carried across.  Inputs are drawn with numpy.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.kernels import ref as jref
from repro.models import mamba as JM
from repro_torch import interop
from repro_torch.configs import registry as reg
from repro_torch.kernels import ops
from repro_torch.kernels.selective_scan import selective_scan_cuda
from repro_torch.models import mamba as M

KEY = jax.random.PRNGKey(3)
ARCH = "jamba-v0.1-52b"
# the reference's mixer, compiled (eager associative scans are slow)
_J_MIX = jax.jit(JM.mamba_mix, static_argnums=(1,),
                 static_argnames=("return_state",))
_J_DECODE = jax.jit(JM.mamba_decode_step, static_argnums=(1,))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread in this file: intra-op threads on these small
    tensors stall on the loaded machine of the parallel run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scan_inputs(b, s, d, n, seed=0):
    """The reference kernel test's distributions (tests/test_kernels.py):
    u, B, C normal; dt = softplus(normal); a = -exp(normal)."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, s, d)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, d)))).astype(np.float32)
    a = -np.exp(rng.standard_normal((d, n))).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    return u, dt, a, bm, cm


def _t(*arrays):
    return [torch.from_numpy(x) for x in arrays]


def _close(got, want, rel=1e-5):
    """max|got - want| <= rel * max|want|: fp32 products and sums in other
    orders (the reference's chunked associative scan re-associates the
    recurrence's products)."""
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


# ---------------------------------------------------------------------------
# the scan


# the three shapes of tests/test_kernels.py::TestSelectiveScan, and a
# ragged S and D with N below the kernel's 16
SHAPES = [(1, 32, 16, 4), (2, 64, 32, 8), (1, 128, 64, 16), (2, 45, 33, 5)]


@pytest.mark.parametrize("b,s,d,n", SHAPES)
def test_scan_matches_reference_oracle(b, s, d, n):
    """Both run the same sequential fp32 recurrence: rtol 1e-5 (the
    reference kernel test's), atol 1e-6 of max|y|."""
    args = _scan_inputs(b, s, d, n, seed=s)
    got = ops.selective_scan(*_t(*args))
    want = np.asarray(jref.selective_scan_ref(*map(jnp.asarray, args)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("b,s,d,n", SHAPES)
def test_scan_final_state_matches_chunk_scan(b, s, d, n):
    """h_S against the final state of the reference model's associative
    ``_chunk_scan`` over the discretized inputs (1e-5 of max|h|), and y
    unchanged by return_state (bitwise)."""
    u, dt, a, bm, cm = _scan_inputs(b, s, d, n, seed=s + 1)
    y, h = ops.selective_scan(*_t(u, dt, a, bm, cm), return_state=True)
    da = jnp.exp(jnp.asarray(dt)[..., None] * jnp.asarray(a)[None, None])
    dbu = (jnp.asarray(dt) * jnp.asarray(u))[..., None] \
        * jnp.asarray(bm)[..., None, :]
    _, h_last = jax.jit(JM._chunk_scan)(jnp.zeros((b, d, n), jnp.float32),
                                        da, dbu)
    assert h.shape == (b, d, n) and h.dtype == torch.float32
    _close(h, h_last)
    assert torch.equal(y, ops.selective_scan(*_t(u, dt, a, bm, cm)))


def test_scan_bf16_inputs_read_as_fp32():
    """bf16 u, B, C are widened exactly: the result equals the fp32 scan of
    the widened values, bitwise."""
    u, dt, a, bm, cm = _t(*_scan_inputs(2, 20, 8, 4, seed=9))
    lo = [x.bfloat16() for x in (u, bm, cm)]
    got = ops.selective_scan(lo[0], dt, a, lo[1], lo[2])
    want = ops.selective_scan(lo[0].float(), dt, a, lo[1].float(),
                              lo[2].float())
    assert torch.equal(got, want)


def test_scan_dispatch_and_checks():
    """CPU tensors take the plain version and count no launch; the kernel
    route raises without a card (no fallback); mismatched shapes raise."""
    u, dt, a, bm, cm = _t(*_scan_inputs(1, 8, 4, 2))
    ops.reset_launch_counts()
    ops.selective_scan(u, dt, a, bm, cm)
    ops.selective_scan(u, dt, a, bm, cm, impl="plain")
    assert ops.LAUNCH_COUNTS["selective_scan"] == 0
    for call in (lambda: ops.selective_scan(u, dt, a, bm, cm, impl="kernel"),
                 lambda: selective_scan_cuda(u, dt, a, bm, cm)):
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            call()
    with pytest.raises(ValueError, match="bmat must be"):
        ops.selective_scan(u, dt, a, bm[:, :4], cm)
    with pytest.raises(ValueError, match="dt must be"):
        ops.selective_scan(u, dt[:, :, :2], a, bm, cm)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.selective_scan(u, dt, a, bm, cm, impl="fast")


# ---------------------------------------------------------------------------
# the mixer


def _mamba(**over):
    """(reference cfg, port cfg, reference params, port params) of one
    reduced jamba mamba layer, fp32."""
    over = dict(dtype="float32", **over)
    jcfg = dataclasses.replace(jreg.reduce_config(jreg.get_config(ARCH)),
                               **over)
    cfg = dataclasses.replace(reg.reduce_config(reg.get_config(ARCH)),
                              **over)
    jp = JM.init_mamba(KEY, jcfg)
    p = interop.model_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, p


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("s,chunk", [(24, 8), (20, 8), (7, 256)])
def test_mamba_mix_matches_reference(s, chunk):
    """mamba_mix, with and without return_state: S a multiple of the
    reference's mamba_chunk (three chunks), not a multiple (the reference
    falls back to one chunk), and shorter than one chunk; output, final
    ssm state and conv tail at 1e-5 of max."""
    jcfg, cfg, jp, p = _mamba(mamba_chunk=chunk)
    x = _x(cfg, 2, s, seed=s)
    want = _J_MIX(jp, jcfg, jnp.asarray(x))
    _close(M.mamba_mix(p, cfg, torch.from_numpy(x)), want)
    jout, (jssm, jconv) = _J_MIX(jp, jcfg, jnp.asarray(x),
                                 return_state=True)
    out, (ssm, conv) = M.mamba_mix(p, cfg, torch.from_numpy(x),
                                   return_state=True)
    _close(out, jout)
    _close(ssm, jssm)
    assert conv.shape == (2, cfg.mamba_d_conv - 1, cfg.mamba_d_inner)
    _close(conv, jconv)


def test_mamba_decode_step_matches_reference():
    """Five decode steps from a prefill's state: output, and the ssm and
    conv states (updated in place in the caller's tensors) at 1e-5."""
    jcfg, cfg, jp, p = _mamba()
    x = _x(cfg, 2, 13, seed=5)
    _, (jssm, jconv) = _J_MIX(jp, jcfg, jnp.asarray(x[:, :8]),
                              return_state=True)
    _, (ssm, conv) = M.mamba_mix(p, cfg, torch.from_numpy(x[:, :8]),
                                 return_state=True)
    ssm, conv = ssm.clone(), conv.clone()
    for t in range(8, 13):
        xt = x[:, t:t + 1]
        jout, jssm, jconv = _J_DECODE(jp, jcfg, jnp.asarray(xt), jssm,
                                      jconv)
        out, s2, c2 = M.mamba_decode_step(p, cfg, torch.from_numpy(xt),
                                          ssm, conv)
        assert s2 is ssm and c2 is conv
        _close(out, jout)
        _close(ssm, jssm)
        _close(conv, jconv)


def test_mamba_init_and_cache_match_reference():
    """init_mamba and init_mamba_cache: the reference's shapes and dtypes in
    a bf16 model (A_log, D, dt_proj_b fp32; the ssm state fp32, the conv
    state bf16); A_log = log(1..N) to one fp32 rounding (torch's and XLA's
    log differ in the last bit)."""
    jcfg = jreg.reduce_config(jreg.get_config(ARCH))
    cfg = reg.reduce_config(reg.get_config(ARCH))
    jp = JM.init_mamba(KEY, jcfg)
    p = M.init_mamba(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert set(p) == set(jp)
    for k in jp:
        assert tuple(p[k].shape) == jp[k].shape, k
        assert str(p[k].dtype)[6:] == str(jp[k].dtype), k
    np.testing.assert_allclose(p["A_log"].numpy(), np.asarray(jp["A_log"]),
                               rtol=2.0 ** -23, atol=0)
    dt0 = torch.nn.functional.softplus(p["dt_proj_b"])
    assert float(dt0.min()) >= 1e-3 * 0.999 and float(dt0.max()) <= 0.1001
    jc = JM.init_mamba_cache(jcfg, 2, 3)
    c = M.init_mamba_cache(cfg, 2, 3, device="cpu")
    for k in jc:
        assert tuple(c[k].shape) == jc[k].shape
        assert str(c[k].dtype)[6:] == str(jc[k].dtype)
        assert not bool(c[k].any())


def test_mamba_unported_options_raise():
    _, cfg, _, p = _mamba()
    x = torch.zeros((1, 4, cfg.d_model))
    # a bf16 scan is speed work held for the benchmark phase (ROADMAP)
    with pytest.raises(NotImplementedError, match="benchmark"):
        M.mamba_mix(p, dataclasses.replace(cfg, mamba_scan_dtype="bfloat16"),
                    x)
    # mamba_shard_channels names the axis of the channel cut (a mesh's
    # model axis): alone it is the same mixer
    assert torch.equal(
        M.mamba_mix(p, dataclasses.replace(cfg, mamba_shard_channels="model"),
                    x), M.mamba_mix(p, cfg, x))
