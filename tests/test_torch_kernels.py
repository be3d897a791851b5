"""The port's kernel wrappers (``repro_torch.kernels.ops``) against the JAX
package's Pallas kernels, run in interpret mode as the reference's own
kernel tests run them.

On the CPU the port's wrappers take the plain versions (the input lies on
the CPU), so these tests pin the arithmetic the Hopper kernels must match;
tests/test_torch_on_card.py holds the CUDA kernels themselves to the plain
versions where a card is present.
"""
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _launch, ops, ref
from repro_torch.kernels import grad_norm, ota_aggregate
from repro_torch.kernels.grad_norm import (batched_moments_cuda, norm_cuda,
                                           sumsq_cuda,
                                           streaming_moments_cuda)
from repro_torch.kernels.ota_aggregate import (ota_superpose_cuda,
                                               ota_superpose_streaming_cuda)

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread in this file: intra-op threads on these small
    tensors stall on the loaded machine of the parallel run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stack(k, n, seed, zeros_every=None, edges=False):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((k, n)).astype(np.float32)
    if zeros_every:
        g[:, ::zeros_every] = 0.0          # exact zeros: sign(0) must be 0
    if edges:
        # large values at each row's head and tail: a dropped or doubled
        # edge element (unaligned head, ragged tail) shows at once
        g[:, :5] = 100.0
        g[:, -5:] = -50.0
    return g


def _sum_tol(terms_abs_sum, n):
    """Bound on the gap between two blocked fp32 sums of the same n terms.

    A sum of tree depth d is within d eps sum|terms| of the exact value; a
    blocked sum of n terms has depth of order log2 n, and two of them differ
    by at most twice that.  So the bound grows with the depth, not with n,
    and stays under one element of the stack: a dropped element fails."""
    return 2.0 * math.ceil(math.log2(n)) * EPS32 * terms_abs_sum


# N values: ragged against the reference's 1024-lane packing, and a K of 1
SHAPES = [(1, 1000), (5, 1000), (1, 3001), (5, 3001)]


class TestMomentsParity:
    @pytest.mark.parametrize("k,n", SHAPES)
    def test_matches_pallas_interpret(self, k, n):
        g = _stack(k, n, seed=k * 10_000 + n, edges=True)
        want_sq, want_s = jops.batched_moments(jnp.asarray(g), interpret=True)
        got_sq, got_s = ops.batched_moments(torch.from_numpy(g))
        # both are blocked fp32 sums of n terms in different orders; the
        # bound is per device, from that device's sum of |terms| (fp64)
        g64 = g.astype(np.float64)
        np.testing.assert_array_less(
            np.abs(got_sq.numpy() - np.asarray(want_sq)),
            _sum_tol(np.sum(g64 * g64, 1), n))
        np.testing.assert_array_less(
            np.abs(got_s.numpy() - np.asarray(want_s)),
            _sum_tol(np.sum(np.abs(g64), 1), n))

    @pytest.mark.parametrize("k,n", [(5, 3001)])
    def test_grad_norms(self, k, n):
        g = _stack(k, n, seed=3)
        want = jops.batched_grad_norms(jnp.asarray(g), interpret=True)
        got = ops.batched_grad_norms(torch.from_numpy(g))
        # the sums of squares differ by at most _sum_tol relative (all terms
        # positive); sqrt halves that and each side rounds once more
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=(math.ceil(math.log2(n)) + 1) * EPS32)


class TestMomentsFold:
    """K1's fold order (``ref.batched_moments_chunked_ref``): each row in
    chunks summed apart, the chunk partials folded in csrc/moments.cu's
    fixed tree (``ref.block_tree_sum``), held to the reference's oracle."""

    @pytest.mark.parametrize("k,n", SHAPES)
    @pytest.mark.parametrize("chunks", [1, 3, 13, 150, 300])
    def test_chunked_fold_matches_reference(self, k, n, chunks):
        g = _stack(k, n, seed=k * 7 + n + chunks, edges=True)
        want_sq, want_s = jref.batched_moments_ref(jnp.asarray(g))
        got_sq, got_s = ref.batched_moments_chunked_ref(torch.from_numpy(g),
                                                        chunks)
        g64 = g.astype(np.float64)
        np.testing.assert_array_less(
            np.abs(got_sq.numpy() - np.asarray(want_sq)),
            _sum_tol(np.sum(g64 * g64, 1), n))
        np.testing.assert_array_less(
            np.abs(got_s.numpy() - np.asarray(want_s)),
            _sum_tol(np.sum(np.abs(g64), 1), n))

    @pytest.mark.parametrize("m", [1, 8, 31, 256, 257, 700])
    def test_tree_sums_every_entry_once(self, m):
        """Integers sum exactly in fp32: the tree adds each entry once,
        thread-strided past 256 entries."""
        x = torch.arange(1, m + 1, dtype=torch.float32).repeat(2, 1)
        assert torch.equal(ref.block_tree_sum(x),
                           torch.full((2,), m * (m + 1) / 2))


class TestSuperposeParity:
    @pytest.mark.parametrize("k,n", SHAPES)
    @pytest.mark.parametrize("pre", ["identity", "sign"])
    def test_matches_pallas_interpret(self, k, n, pre):
        g = _stack(k, n, seed=k + n, zeros_every=7 if pre == "sign" else None)
        rng = np.random.default_rng(n)
        scale = rng.uniform(0.1, 2.0, k).astype(np.float32)
        noise = (0.05 * rng.standard_normal(n)).astype(np.float32)
        a = 1.3
        want = jops.ota_superpose(jnp.asarray(g), jnp.asarray(scale),
                                  jnp.asarray(noise), a, pre=pre,
                                  interpret=True)
        got = ops.ota_superpose(torch.from_numpy(g), torch.from_numpy(scale),
                                torch.from_numpy(noise), a, pre=pre)
        x = np.sign(g) if pre == "sign" else g
        # per coordinate: two K-term sums plus the noise add and the gain
        bound = a * (np.abs(scale) @ np.abs(x) + np.abs(noise))
        np.testing.assert_array_less(np.abs(got.numpy() - np.asarray(want)),
                                     2 * (k + 2) * EPS32 * bound + 1e-30)

    def test_sign_of_zero_is_zero(self):
        g = np.zeros((3, 50), np.float32)
        g[1, ::2] = -2.0
        got = ops.ota_superpose(torch.from_numpy(g), torch.ones(3),
                                torch.zeros(50), 1.0, pre="sign")
        want = np.where(np.arange(50) % 2 == 0, -1.0, 0.0)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_ota_aggregate_normalized(self):
        k, n = 5, 3001
        g = _stack(k, n, seed=5)
        rng = np.random.default_rng(0)
        hb = rng.uniform(0.5, 2.0, k).astype(np.float32)
        norms = np.linalg.norm(g, axis=1).astype(np.float32)
        noise = (0.01 * rng.standard_normal(n)).astype(np.float32)
        want = jops.ota_aggregate(jnp.asarray(g), jnp.asarray(hb),
                                  jnp.asarray(norms), jnp.asarray(noise), 0.7,
                                  interpret=True)
        got = ops.ota_aggregate(torch.from_numpy(g), torch.from_numpy(hb),
                                torch.from_numpy(norms),
                                torch.from_numpy(noise), 0.7)
        # K-term fp32 sums in different orders; entries are O(1e-2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)


class TestDispatch:
    def test_cpu_tensor_takes_plain_and_counts_nothing(self):
        ops.reset_launch_counts()
        ops.batched_moments(torch.ones(2, 9))
        ops.ota_superpose(torch.ones(2, 9), torch.ones(2), torch.zeros(9), 1.0)
        ops.batched_moments(torch.ones(2, 9), k_block=1)
        ops.ota_superpose(torch.ones(2, 9), torch.ones(2), torch.zeros(9), 1.0,
                          k_block=2)
        ops.grad_norm(torch.ones(9))
        ops.flash_attention(torch.ones(1, 2, 8, 8), torch.ones(1, 1, 8, 8),
                            torch.ones(1, 1, 8, 8))
        ops.selective_scan(torch.ones(1, 4, 3), torch.ones(1, 4, 3),
                           -torch.ones(3, 2), torch.ones(1, 4, 2),
                           torch.ones(1, 4, 2))
        ops.channel_noise(torch.zeros(9), 3, 1.0, 1.0)
        assert set(ops.LAUNCH_COUNTS) == {
            "batched_moments", "ota_superpose", "streaming_moments",
            "ota_superpose_streaming", "sumsq", "flash_attention",
            "selective_scan", "channel_noise"}
        assert set(ops.LAUNCH_COUNTS.values()) == {0}

    @pytest.mark.parametrize("call", [
        lambda: ops.batched_moments(torch.ones(2, 9), impl="kernel"),
        lambda: ops.ota_superpose(torch.ones(2, 9), torch.ones(2),
                                  torch.zeros(9), 1.0, impl="kernel"),
        lambda: batched_moments_cuda(torch.ones(2, 9)),
        lambda: ota_superpose_cuda(torch.ones(2, 9), torch.ones(2),
                                   torch.zeros(9), 1.0),
        lambda: ops.batched_moments(torch.ones(2, 9), k_block=1,
                                    impl="kernel"),
        lambda: ops.ota_superpose(torch.ones(2, 9), torch.ones(2),
                                  torch.zeros(9), 1.0, k_block=1,
                                  impl="kernel"),
        lambda: ops.grad_norm(torch.ones(9), impl="kernel"),
        lambda: streaming_moments_cuda(torch.ones(2, 9), 1),
        lambda: ota_superpose_streaming_cuda(torch.ones(2, 9), torch.ones(2),
                                             torch.zeros(9), 1.0, 1),
        lambda: sumsq_cuda(torch.ones(9)),
        lambda: norm_cuda(torch.ones(9)),
    ])
    def test_kernel_request_on_cpu_raises(self, call):
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            call()

    def test_ptxas_report_reads_each_entry(self, tmp_path, monkeypatch):
        """build.ptxas_report reads nvcc -Xptxas -v's lines per entry."""
        from repro_torch.kernels import build
        log = tmp_path / "k.log"
        log.write_text(
            "ptxas info    : 0 bytes gmem\n"
            "ptxas info    : Compiling entry function '_Z1aILi80EEv' for "
            "'sm_90a'\n"
            "ptxas info    : Function properties for _Z1aILi80EEv\n"
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
            "loads\n"
            "ptxas info    : Used 168 registers, used 1 barriers\n"
            "ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'\n"
            "    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
            "loads\n"
            "ptxas info    : Used 32 registers, used 1 barriers, 64 bytes "
            "smem\n")
        monkeypatch.setattr(build, "log_path", lambda name: log)
        assert build.ptxas_report("k") == {
            "_Z1aILi80EEv": {"registers": 168, "smem": 0, "stack": 0,
                             "spill_stores": 0, "spill_loads": 0},
            "_Z1bv": {"registers": 32, "smem": 64, "stack": 8,
                      "spill_stores": 8, "spill_loads": 4}}

    def test_cuda_tensor_cannot_be_made_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises((RuntimeError, AssertionError)):
            ops.batched_moments(torch.ones(2, 9, device="cuda"))

    def test_unknown_impl_and_streaming_raise(self):
        """An unknown impl raises; the streamed kernels run, and raise
        ValueError for a k_block that does not divide K (as the reference's
        ops do)."""
        with pytest.raises(ValueError, match="unknown impl"):
            ops.batched_moments(torch.ones(2, 9), impl="fast")
        with pytest.raises(ValueError, match="divide"):
            ops.batched_moments(torch.ones(6, 9), k_block=4)
        with pytest.raises(ValueError, match="divide"):
            ops.ota_superpose(torch.ones(6, 9), torch.ones(6),
                              torch.zeros(9), 1.0, k_block=4)
        with pytest.raises(ValueError, match="divide"):
            jops.ota_superpose(jnp.ones((6, 9)), jnp.ones(6), jnp.zeros(9),
                               1.0, k_block=4)
        sq, s = ops.batched_moments(torch.ones(6, 9), k_block=3)
        assert torch.equal(sq, torch.full((6,), 9.0))
        assert torch.equal(s, torch.full((6,), 9.0))

    @pytest.mark.parametrize("bad,match", [
        (torch.ones(2, 9, dtype=torch.float64), "float32"),
        (torch.ones(9), "2-D"),
        (torch.ones(9, 2).T, "contiguous"),
        (torch.ones(0, 9), "empty"),
        (torch.ones(2, 9), "needs a CUDA tensor"),
    ])
    def test_layout_checks(self, bad, match):
        with pytest.raises(ValueError, match=match):
            _launch.check(bad, 2, "g")


def _superpose_ctas(k, n):
    return (-(-n // ota_aggregate.SUPERPOSE_THREADS)
            * ota_aggregate.superpose_split(k, n))


def _stream_moments_ctas(k, n):
    chunks = grad_norm.stream_moments_chunks(n)
    if chunks == 1:
        return -(-k // grad_norm.STREAM_ROWS_PER_CTA)
    return k * chunks


class TestSplitChoosers:
    """How K2 splits its K-way sum (``superpose_split``), how K4 groups its
    K-blocks (``stream_split``) and how K3 splits its rows
    (``stream_moments_chunks``): the grids these give, and that they read
    nothing but their stated arguments."""

    def test_arguments(self):
        assert list(inspect.signature(ota_aggregate.superpose_split)
                    .parameters) == ["k", "n"]
        assert list(inspect.signature(ota_aggregate.stream_split)
                    .parameters) == ["k", "n", "k_block"]
        assert list(inspect.signature(grad_norm.stream_moments_chunks)
                    .parameters) == ["n"]

    def test_superpose_keeps_one_launch_at_the_round_shape(self):
        assert ota_aggregate.superpose_split(20, 55_050) == 1
        assert ota_aggregate.superpose_split(1, 7) == 1

    @pytest.mark.parametrize("k,n", [(1000, 2048), (1000, 55_050),
                                     (7, 1_000_003)])
    def test_grids_cover_the_card(self, k, n):
        """At least one CTA on each of the H100's 132 SMs."""
        assert _superpose_ctas(k, n) >= _launch.SMS
        assert _stream_moments_ctas(k, n) >= _launch.SMS

    @pytest.mark.parametrize("k", [1, 20, 31, 32, 63, 64, 100, 999, 1000,
                                   1001, 4096, 100_000])
    @pytest.mark.parametrize("n", [1, 7, 2048, 55_050, 1_000_003])
    def test_superpose_chunks_are_whole(self, k, n):
        """The S chunks of ceil(K / S) rows cover K with none empty, each
        of at least SUPERPOSE_MIN_ROWS rows when the sum is split."""
        s = ota_aggregate.superpose_split(k, n)
        rows = -(-k // s)
        assert 1 <= s <= k and -(-k // rows) == s
        if s > 1:
            assert rows >= ota_aggregate.SUPERPOSE_MIN_ROWS

    @pytest.mark.parametrize("k,n,kb", [(20, 55_050, 4), (20, 55_050, 20),
                                        (7, 1_000_003, 1), (1, 7, 1)])
    def test_stream_keeps_one_pass(self, k, n, kb):
        """Where K2 keeps one pass (the FL round's K = 20, the ragged N that
        fills a wave), so does K4: one launch, no partials."""
        assert ota_aggregate.stream_split(k, n, kb) == 1

    @pytest.mark.parametrize("k,n,kb,s", [(1000, 55_050, 100, 4),
                                          (100_000, 2048, 1000, 100),
                                          (1000, 2048, 100, 10),
                                          (1000, 2048, 1, 31)])
    def test_stream_split_at_the_callers_shapes(self, k, n, kb, s):
        """Wide: 10 blocks in 4 chunks of 3, 3, 3 and 1 (864 CTAs; 5 would
        pass one wave); K-scale: one chunk a block (800 CTAs)."""
        assert ota_aggregate.stream_split(k, n, kb) == s

    @pytest.mark.parametrize("k,kb", [(1, 1), (7, 1), (20, 4), (20, 20),
                                      (64, 2), (1000, 1), (1000, 100),
                                      (1000, 125), (4096, 64),
                                      (100_000, 1000), (100_000, 100_000)])
    @pytest.mark.parametrize("n", [1, 7, 2048, 55_050, 1_000_003])
    def test_stream_chunks_hold_whole_blocks(self, k, n, kb):
        """The S chunks of ceil(nb / S) K-blocks cover the nb blocks once
        with none empty, S is at most K2's split, and a split grid stays
        within one wave of CTAs."""
        s = ota_aggregate.stream_split(k, n, kb)
        nb = k // kb
        per = -(-nb // s)
        assert 1 <= s <= nb and -(-nb // per) == s
        assert sum(min(per, nb - c * per) for c in range(s)) == nb
        assert s <= ota_aggregate.superpose_split(k, n)
        if s > 1:
            tiles = -(-n // ota_aggregate.SUPERPOSE_THREADS)
            assert tiles * s <= (_launch.SMS
                                 * ota_aggregate.SUPERPOSE_CTAS_PER_SM)

    @pytest.mark.parametrize("n", [1, 7, 2048, 4096, 4097, 55_050,
                                   1_000_003])
    def test_stream_moments_chunks(self, n):
        """One chunk for a row one warp reads; longer rows take two or
        more chunks of at most MOMENTS_CHUNK elements on K1's kernel
        (ceil(ceil(N / 4) / (MOMENTS_CHUNK / 4)) float4 chunks), from N
        alone."""
        chunks = grad_norm.stream_moments_chunks(n)
        if n <= grad_norm.STREAM_ROW_MAX:
            assert chunks == 1
        else:
            assert chunks == max(2, -(-(-(-n // 4))
                                      // (grad_norm.MOMENTS_CHUNK // 4))) > 1

    def test_moments_split_arguments(self):
        """K1's chooser reads only its stated arguments."""
        assert list(inspect.signature(grad_norm.moments_split)
                    .parameters) == ["k", "n"]

    @pytest.mark.parametrize("k", [1, 7, 20, 131, 1000, 1056, 1057, 100_000])
    @pytest.mark.parametrize("n", [1, 7, 4095, 55_050, 1_000_003])
    def test_moments_split_fills_one_wave(self, k, n):
        """One chunk a row where K alone fills a wave of CTAs; otherwise
        chunks of at least MOMENTS_MIN_VEC float4s, none empty, and the
        grid within one wave."""
        c = grad_norm.moments_split(k, n)
        wave = _launch.SMS * grad_norm.MOMENTS_CTAS_PER_SM
        nvec = -(-n // 4)
        per = -(-nvec // c)
        assert 1 <= c and -(-nvec // per) == c
        if k >= wave:
            assert c == 1
        if c > 1:
            assert k * c <= wave and per >= grad_norm.MOMENTS_MIN_VEC

    @pytest.mark.parametrize("k,n,c", [(20, 55_050, 6), (1000, 55_050, 1),
                                       (7, 1_000_003, 122)])
    def test_moments_split_at_the_callers_shapes(self, k, n, c):
        assert grad_norm.moments_split(k, n) == c

    def test_sumsq_split_arguments(self):
        """K5's chooser reads N alone."""
        assert list(inspect.signature(grad_norm.sumsq_split)
                    .parameters) == ["n"]

    @pytest.mark.parametrize("n", [1, 7, 2047, 2048, 2049, 55_050,
                                   1_000_003, 1_101_000, 7_000_021,
                                   55_050_000, 204_800_000])
    def test_sumsq_split_fills_one_wave(self, n):
        """At most one wave of CTAs and no more chunks than tiles of
        SUMSQ_TILE float4s, so none is empty; the interleaved tiles give
        each chunk ceil(tiles / chunks) of them or one fewer; about
        sqrt(tiles / SUMSQ_FOLD_RATIO) tiles a chunk where the wave allows
        it; one chunk (no fold) for a single tile."""
        c = grad_norm.sumsq_split(n)
        wave = _launch.SMS * grad_norm.MOMENTS_CTAS_PER_SM
        tiles = -(-(-(-n // 4)) // grad_norm.SUMSQ_TILE)
        assert 1 <= c <= min(wave, tiles)
        counts = [len(range(j, tiles, c)) for j in range(c)]
        assert sum(counts) == tiles and min(counts) >= max(counts) - 1 >= 0
        per = -(-tiles // c)
        balanced = math.sqrt(tiles / grad_norm.SUMSQ_FOLD_RATIO)
        assert per >= -(-tiles // wave)
        if per > -(-tiles // wave):
            assert abs(per - balanced) <= 1
        if tiles == 1:
            assert c == 1

    @pytest.mark.parametrize("n,c", [(2048, 1), (55_050, 27),
                                     (1_000_003, 245), (204_800_000, 1053)])
    def test_sumsq_split_at_the_callers_shapes(self, n, c):
        """One CTA at the K-scale round's N = 2,048, one tile a CTA at the
        Case-I round's N = 55,050, two tiles a CTA at a million, and a
        wave at the K-scale stack flattened."""
        assert grad_norm.sumsq_split(n) == c
