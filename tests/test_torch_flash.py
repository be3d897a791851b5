"""K6's plain version and dispatch against the JAX package: the port's
``ops.flash_attention`` on CPU tensors (the plain chunked attention) held to
``repro.kernels.ref.attention_ref`` and to the Pallas kernel in interpret
mode, at the reference's own test shapes (``tests/test_kernels.py::
TestFlashAttention``) plus a head dim of 80, a ragged S and grouped kv.

Tolerances: fp32 rtol = atol = 1e-5 (the reference's bound for its kernel
against its oracle: fp32 sums in another order); bf16 2e-2 (the
reference's, one bf16 rounding of inputs handled in another order).
``TestTF32Split`` emulates the fp32 body's 3xTF32 products in numpy and
holds them to the card's fp32 rule, 1e-5 + 1e-5 |o|.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_cuda


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread in this file: intra-op threads on these small
    tensors stall on the loaded machine of the parallel run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
        """bf16 goes to the wgmma body, fp32 to the 3xTF32 body; both are
        sources that the build compiles."""
        from repro_torch.kernels import build
        from repro_torch.kernels.flash_attention import BODIES, DTYPES
        assert set(BODIES) == set(DTYPES)
        assert BODIES[torch.bfloat16] == ("flash_attention_wgmma",
                                          "wgmma_tma")
        assert BODIES[torch.float32] == ("flash_attention", "tf32x3_mma")
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


def _tf32(x, mode):
    """fp32 ``x`` rounded to TF32's 10 stored mantissa bits: to nearest
    (ties away from zero, as ``cvt.rna.tf32.f32``) or toward zero (the low
    13 bits cleared, as the fp32 body's split and the tensor cores' reading
    of a raw fp32 operand)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    if mode == "nearest":
        bits = bits + np.uint32(0x1000)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _rz32(x):
    """fp64 ``x`` to fp32, rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def _mma(acc, a, b, terms, mode):
    """acc + a @ b as the fp32 body sums it on the tensor cores: one
    mma.sync m16n8k8 step per 8 of the inner dimension, on TF32 operands
    split as hi = tf32(x), lo = tf32(x - hi).  ``terms`` 1: hi hi alone;
    3: lo hi, hi lo, then hi hi, one step each.  A step's TF32 products
    are exact; its sum with the fp32 accumulator is rounded toward zero,
    as the tensor cores round it."""
    for k0 in range(0, a.shape[-1], 8):
        x, y = a[:, k0:k0 + 8], b[k0:k0 + 8]
        xh, yh = _tf32(x, mode), _tf32(y, mode)
        pairs = [(xh, yh)]
        if terms == 3:
            pairs = [(_tf32(x - xh, mode), yh), (xh, _tf32(y - yh, mode)),
                     *pairs]
        for u, w in pairs:
            acc = _rz32(acc.astype(np.float64)
                        + u.astype(np.float64) @ w.astype(np.float64))
    return acc


def _head_tf32(q, k, v, terms, mode, causal, pv):
    """One head [S, d] as the fp32 body computes it: kv tiles of 64 keys,
    the online softmax in fp32 in the log2 domain, and P V (P the
    unnormalised exponentials) on the tensor cores.  ``pv`` "tile": each
    tile's P V summed from zero and added to O in fp32 (one rounding, as
    the body's fused multiply-add); "one_accumulator": O itself carried
    across the tiles in the tensor cores' accumulator, as first built."""
    sq, d = q.shape
    scale = np.float32(1 / math.sqrt(d)) * np.float32(math.log2(math.e))
    m = np.full((sq, 1), np.float32(-1e30))
    l = np.zeros((sq, 1), np.float32)
    o = np.zeros((sq, d), np.float32)
    rows = np.arange(sq)[:, None]
    for k0 in range(0, k.shape[0], 64):
        kt, vt = k[k0:k0 + 64], v[k0:k0 + 64]
        s = _mma(np.zeros((sq, len(kt)), np.float32), q,
                 np.ascontiguousarray(kt.T), terms, mode) * scale
        if causal:
            s = np.where(np.arange(k0, k0 + len(kt))[None] <= rows, s,
                         np.float32(-1e30))
        mn = np.maximum(m, s.max(1, keepdims=True))
        corr = np.exp2(m - mn).astype(np.float32)
        p = np.exp2(s - mn).astype(np.float32)
        l = l * corr + p.sum(1, keepdims=True, dtype=np.float32)
        m = mn
        if pv == "tile":
            part = _mma(np.zeros((sq, d), np.float32), p, vt, terms, mode)
            o = (o.astype(np.float64) * corr + part).astype(np.float32)
        else:
            o = _mma(o * corr, p, vt, terms, mode)
    return o / np.maximum(l, np.float32(1e-30))


def _attention_tf32(q, k, v, terms, mode, causal=True, pv="tile"):
    """[B, H, S, d] attention (k and v with H heads) through
    ``_head_tf32``."""
    return np.stack([np.stack([
        _head_tf32(q[b, h], k[b, h], v[b, h], terms, mode, causal, pv)
        for h in range(q.shape[1])]) for b in range(q.shape[0])])


class TestTF32Split:
    """The design evidence for the fp32 body on the tensor cores, in a
    numpy emulation of its mma steps whose sums round toward zero: with
    every operand split into two TF32 parts, three products per product
    meet the card's fp32 rule against the plain version; one TF32 product
    does not; and P V carried across kv tiles in one tensor-core
    accumulator misses the rule on long rows, where each tile's P V summed
    from zero and added to O in fp32 meets it.  Both roundings of the
    split: to nearest, and the kernel's truncation."""

    SHAPE = (1, 2, 192, 128)
    # 16 query rows over 4,096 keys (64 tiles): the accumulator's shrink
    # grows with the tiles it is carried over, relative to |o|; values
    # offset by 1, a component all value vectors share, make |o| ~ 1
    LONG = (1, 1, 16, 4096, 16)

    def _plain(self, q, k, v, causal=True):
        o = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                causal=causal)
        return o.numpy()

    @pytest.mark.parametrize("mode", ["nearest", "truncate"])
    def test_three_products_meet_the_fp32_rule(self, mode):
        q, k, v = _inputs(self.SHAPE, seed=17)
        want = self._plain(q, k, v)
        got = _attention_tf32(q, k, v, 3, mode)
        assert bool((np.abs(got - want) <= 1e-5 + 1e-5 * np.abs(want)).all())

    @pytest.mark.parametrize("mode", ["nearest", "truncate"])
    def test_one_product_misses_the_fp32_rule(self, mode):
        q, k, v = _inputs(self.SHAPE, seed=17)
        want = self._plain(q, k, v)
        got = _attention_tf32(q, k, v, 1, mode)
        assert not bool((np.abs(got - want)
                         <= 1e-5 + 1e-5 * np.abs(want)).all())

    @pytest.mark.parametrize("mode", ["nearest", "truncate"])
    @pytest.mark.parametrize("pv,meets", [("tile", True),
                                          ("one_accumulator", False)])
    def test_pv_accumulation_on_long_rows(self, pv, meets, mode):
        b, h, sq, skv, d = self.LONG
        rng = np.random.default_rng(17)
        q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
        k = rng.standard_normal((b, h, skv, d)).astype(np.float32)
        v = (rng.standard_normal((b, h, skv, d)) + 1).astype(np.float32)
        want = self._plain(q, k, v, causal=False)
        got = _attention_tf32(q, k, v, 3, mode, causal=False, pv=pv)
        assert bool((np.abs(got - want)
                     <= 1e-5 + 1e-5 * np.abs(want)).all()) == meets

    def test_tensor_core_sums_round_toward_zero(self):
        """1 + 1.5 ulp rounds to 1 + 1 ulp, on either side of zero."""
        ulp = 2.0 ** -23
        x = np.array([1 + 1.5 * ulp, -(1 + 1.5 * ulp), 1 + ulp], np.float64)
        np.testing.assert_array_equal(
            _rz32(x), np.array([1 + ulp, -(1 + ulp), 1 + ulp], np.float32))

    def test_tf32_rounding(self):
        """1 + 2^-11 is a tie: to nearest rounds it away from zero to
        1 + 2^-10, truncation to 1; 1 + 2^-10 is a TF32 value."""
        x = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -10],
                     np.float32)
        np.testing.assert_array_equal(
            _tf32(x, "nearest"), [1 + 2.0 ** -10, -(1 + 2.0 ** -10),
                                  1 + 2.0 ** -10])
        np.testing.assert_array_equal(_tf32(x, "truncate"),
                                      [1.0, -1.0, 1 + 2.0 ** -10])
