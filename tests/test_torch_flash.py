"""K6's plain version and dispatch against the JAX package: the port's
``ops.flash_attention`` on CPU tensors (the plain chunked attention) held to
``repro.kernels.ref.attention_ref`` and to the Pallas kernel in interpret
mode, at the reference's own test shapes (``tests/test_kernels.py::
TestFlashAttention``) plus a head dim of 80, a ragged S and grouped kv.

Tolerances: fp32 rtol = atol = 1e-5 (the reference's bound for its kernel
against its oracle: fp32 sums in another order); bf16 2e-2 (the
reference's, one bf16 rounding of inputs handled in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_cuda


def _inputs(shape, seed, kv_heads=None):
    rng = np.random.default_rng(seed)
    b, h, s, d = shape
    kv_shape = (b, kv_heads or h, s, d)
    q = rng.standard_normal(shape).astype(np.float32)
    k = rng.standard_normal(kv_shape).astype(np.float32)
    v = rng.standard_normal(kv_shape).astype(np.float32)
    return q, k, v


def _both(q, k, v, dtype, **kw):
    """(port's plain result, reference's attention_ref), both as fp32 numpy,
    from the same inputs rounded once to ``dtype``."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    got = ops.flash_attention(*(torch.from_numpy(a).to(tdt)
                                for a in (q, k, v)), **kw)
    assert got.dtype == tdt
    want = jref.attention_ref(*(jnp.asarray(a).astype(jdt)
                                for a in (q, k, v)), **kw)
    return got.float().numpy(), np.asarray(want, np.float32)


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 1e-5


class TestPlainMatchesReference:
    @pytest.mark.parametrize("b,h,s,d", [(1, 1, 128, 64), (2, 3, 256, 64),
                                         (1, 2, 512, 128)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_causal(self, b, h, s, d, dtype):
        got, want = _both(*_inputs((b, h, s, d), seed=s + h), dtype,
                          causal=True)
        np.testing.assert_allclose(got, want, rtol=_tol(dtype),
                                   atol=_tol(dtype))

    @pytest.mark.parametrize("window", [32, 64, 128])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_sliding_window(self, window, dtype):
        got, want = _both(*_inputs((1, 2, 256, 32), seed=window), dtype,
                          causal=True, window=window)
        np.testing.assert_allclose(got, want, rtol=_tol(dtype),
                                   atol=_tol(dtype))

    @pytest.mark.parametrize("window", [None, 40])
    def test_non_causal(self, window):
        got, want = _both(*_inputs((1, 1, 128, 32), seed=9), "float32",
                          causal=False, window=window)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                               (False, None)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_head_dim_80_ragged_s(self, causal, window, dtype):
        """danube's head dim (not a power of two) at S = 200, which no
        64-key tile divides."""
        got, want = _both(*_inputs((2, 2, 200, 80), seed=80), dtype,
                          causal=causal, window=window)
        np.testing.assert_allclose(got, want, rtol=_tol(dtype),
                                   atol=_tol(dtype))

    def test_grouped_kv_equals_expanded(self):
        """Grouped kv [B, Hkv, S, d] gives what the reference's
        head-expanded layout gives (query head h reads kv head h // 4)."""
        q, k, v = _inputs((1, 8, 96, 40), seed=3, kv_heads=2)
        got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  window=24)
        want = jref.attention_ref(jnp.asarray(q),
                                  jnp.repeat(jnp.asarray(k), 4, axis=1),
                                  jnp.repeat(jnp.asarray(v), 4, axis=1),
                                  causal=True, window=24)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)

    def test_matches_pallas_interpret(self):
        """Against the reference's Pallas kernel itself, in interpret mode."""
        q, k, v = _inputs((1, 2, 128, 32), seed=13)
        got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=True, window=48)
        want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True, window=48,
                                    block_q=32, block_k=32, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)

    def test_chunking_changes_no_value(self, monkeypatch):
        """The plain version computes query chunk by query chunk; one chunk
        per row gives the same values as one chunk for all."""
        q, k, v = (torch.from_numpy(a) for a in _inputs((1, 2, 70, 16), 5))
        whole = ops.flash_attention(q, k, v, window=9)
        from repro_torch.kernels import ref
        monkeypatch.setattr(ref, "ATTN_CHUNK_ELEMS", 1)
        rows = ops.flash_attention(q, k, v, window=9)
        torch.testing.assert_close(rows, whole, rtol=1e-6, atol=1e-6)


class TestDispatch:
    def test_each_dtype_has_its_body(self):
        """bf16 goes to the tensor-core body, fp32 to the fp32-core body;
        both are sources that the build compiles."""
        from repro_torch.kernels import build
        from repro_torch.kernels.flash_attention import BODIES, DTYPES
        assert set(BODIES) == set(DTYPES)
        assert BODIES[torch.bfloat16] == ("flash_attention_wgmma",
                                          "wgmma_tma")
        assert BODIES[torch.float32] == ("flash_attention", "fp32_cores")
        for lib, _ in BODIES.values():
            assert (build.CSRC / build.SOURCES[lib]).is_file()

    def test_cpu_takes_plain_and_counts_nothing(self):
        ops.reset_launch_counts()
        q = torch.ones(1, 2, 8, 8)
        ops.flash_attention(q, q, q)
        ops.flash_attention(q, q, q, impl="plain")
        assert ops.LAUNCH_COUNTS["flash_attention"] == 0

    @pytest.mark.parametrize("call", [
        lambda q: ops.flash_attention(q, q, q, impl="kernel"),
        lambda q: flash_attention_cuda(q, q, q),
    ])
    def test_kernel_request_on_cpu_raises(self, call):
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            call(torch.ones(1, 2, 8, 8))

    @pytest.mark.parametrize("q,k,kw,match", [
        (torch.ones(1, 2, 8, 8), torch.ones(1, 3, 8, 8), {}, "divide"),
        (torch.ones(1, 2, 8, 8), torch.ones(1, 2, 8, 16), {}, "head dim"),
        (torch.ones(2, 8, 8), torch.ones(2, 8, 8), {}, "4-D"),
        (torch.ones(1, 2, 8, 8), torch.ones(1, 2, 8, 8), {"window": 0},
         "window"),
        (torch.ones(1, 2, 8, 8), torch.ones(1, 2, 8, 8), {"impl": "fast"},
         "unknown impl"),
    ])
    def test_bad_arguments_raise_on_both_routes(self, q, k, kw, match):
        with pytest.raises(ValueError, match=match):
            ops.flash_attention(q, k, k, **kw)

    @pytest.mark.parametrize("bad,match", [
        (torch.ones(1, 2, 8, 8, dtype=torch.float64), "float32 or bfloat16"),
        (torch.ones(1, 2, 8, 8, dtype=torch.float16), "float32 or bfloat16"),
        (torch.ones(1, 8, 2, 8).transpose(1, 2), "contiguous"),
        (torch.ones(1, 2, 0, 8), "empty"),
    ])
    def test_kernel_layout_checks(self, bad, match):
        with pytest.raises(ValueError, match=match):
            flash_attention_cuda(bad, bad, bad)
