"""The OTA train step's channel noise drawn a rank's piece at a time
(``kernels/channel_noise.py``, ``kernels.ops.channel_noise``, the plain
version ``kernels.ref.noise_normals_ref``), on the CPU:

* the stream's hash is ``rng._mix`` (splitmix64) of the block schedule,
  its uniforms on the 2^-24 grid, its normals within 1e-6 of float64
  Box-Muller on the same uniforms, its square root correctly rounded
  whatever the library's, and the kernel source's constants are the plain
  version's;
* a piece is bitwise the whole leaf's draw sliced: a leaf cut on dim 0,
  on dim 1, on two dims, a halves leaf, a ragged offset, and every leaf of
  reduced jamba and granite on a (2, 2) mesh's model ranks;
* the stream's mean, variance and kurtosis over 2^20 draws, and its lag-1
  and cross-leaf correlations, within stated bounds;
* ``step(seed)`` is bitwise ``step(noise=seeded_noise(seed, ...))`` on the
  emulated (4, 1), (4, 2) and (2, 2, 1) meshes, and the noise moves the
  step;
* the wrapper: in place or not, the gain as a float or a tensor, the
  kernel route refused off the card, the meta route one pass of y.

The reference draws its noise with ``jax.random`` inside its jitted step;
its parity tests inject that draw through ``noise=``
(``tests/test_torch_train_step.py``, ``tests/test_torch_tp_train.py``).
torch runs on one thread in this file.
"""
import dataclasses
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch import rng
from repro_torch.configs import registry as reg
from repro_torch.distribution import sharding as SH
from repro_torch.kernels import ops, ref
from repro_torch.kernels.channel_noise import NOISE_CONSTS, piece_map
from repro_torch.launch import train as tl
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as opt
from repro_torch.tree import tree_flatten, tree_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "granite-moe-1b-a400m"
STATS_N = 1 << 20
# bounds on the stream's statistics over STATS_N draws: about five standard
# errors each (mean 1/1024, variance sqrt(2/n) = 1.4e-3, kurtosis sqrt(24/n)
# = 4.8e-3, a correlation 1/1024)
MEAN_TOL = 5e-3
VAR_TOL = 7e-3
KURT_TOL = 2.5e-2
CORR_TOL = 5e-3
# the normals against float64 Box-Muller on the same uniforms
NORMAL_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread in this file: intra-op threads on these small
    tensors stall on the loaded machine of the parallel run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _whole(stream, shape):
    """The whole leaf's standard normals under the leaf stream ``stream``
    (an ``rng.noise_key``)."""
    return ref.noise_draw_ref(stream, piece_map(shape)).view(shape)


# ---------------------------------------------------------------------------
# the stream


def test_hash_is_the_block_schedules():
    stream = rng.noise_key(12, 3)
    w = np.arange(0, 200_000, 7, dtype=np.int64)
    got = rng.counter_hash(stream, torch.from_numpy(w)).numpy().view(np.uint64)
    want = rng._mix(np.uint64(stream)
                    + (w.astype(np.uint64) + np.uint64(1))
                    * np.uint64(rng._MUL))
    assert np.array_equal(got, want)
    assert stream == rng.derive_seed(12, rng.NOISE_SALT, 3)


def test_uniforms_on_the_grid_and_normals_near_float64():
    u1, u2 = ref.noise_uniforms_ref(rng.noise_key(1, 0),
                                    torch.arange(STATS_N))
    assert torch.all((u1 > 0) & (u1 <= 1)) and torch.all((u2 >= 0) & (u2 < 1))
    for u, lo in ((u1, 1), (u2, 0)):
        k = u.double() * 2 ** 24
        assert torch.equal(k, k.round()) and k.min() >= lo
    n = ref.noise_normals_ref(u1, u2).double()
    want = (torch.sqrt(-2.0 * torch.log(u1.double()))
            * torch.cos(2.0 * math.pi * u2.double()))
    assert (n - want).abs().max() <= NORMAL_ATOL
    # the 24-bit grid cuts the tails at sqrt(-2 ln 2^-24)
    assert n.abs().max() <= math.sqrt(-2.0 * math.log(2.0 ** -24))


@pytest.mark.parametrize("off", [0, -1, 1])
def test_sqrt_is_correctly_rounded(monkeypatch, off):
    """``ref.sqrt_rn`` is the correctly rounded fp32 root (numpy's fp64
    root rounded to fp32), also where the library's root is an ulp off
    either way (the kernel's ``__fsqrt_rn`` is correctly rounded)."""
    x = torch.rand(1 << 20, generator=torch.Generator().manual_seed(2)) * 40
    x[:8] = torch.tensor([0.0, 2.0 ** -126, 1e-30, 1.0, 2.0, 4.0, 34.6, 5.0])
    want = torch.from_numpy(np.sqrt(x.numpy().astype(np.float64))
                            .astype(np.float32))
    real = torch.sqrt
    if off:
        far = torch.tensor(math.inf if off > 0 else 0.0, dtype=torch.float64)
        monkeypatch.setattr(torch, "sqrt",
                            lambda t: torch.nextafter(real(t), far))
    assert torch.equal(ref.sqrt_rn(x), want)


def test_kernel_constants_are_the_plain_versions():
    src = (ROOT / "src/repro_torch/kernels/csrc/channel_noise.cu").read_text()
    names = {"SQRT2": "kSqrt2", "LN2": "kLn2", "TWO_PI": "kTwoPi"}
    for name, value in NOISE_CONSTS.items():
        cname = names.get(name, "k" + name)
        m = re.search(rf"constexpr float {cname} = ([-0-9.e]+)f;", src)
        assert m, cname
        assert float(np.float32(m.group(1))) == value, name


def test_stream_statistics():
    stream0, stream1 = rng.noise_key(5, 0), rng.noise_key(5, 1)
    a = ref.noise_draw_ref(stream0, piece_map((STATS_N,))).double()
    b = ref.noise_draw_ref(stream1, piece_map((STATS_N,))).double()
    mean, var = a.mean(), a.var()
    kurt = ((a - mean) ** 4).mean() / var ** 2
    lag1 = torch.corrcoef(torch.stack([a[:-1], a[1:]]))[0, 1]
    cross = torch.corrcoef(torch.stack([a, b]))[0, 1]
    assert abs(float(mean)) <= MEAN_TOL
    assert abs(float(var) - 1.0) <= VAR_TOL
    assert abs(float(kurt) - 3.0) <= KURT_TOL
    assert abs(float(lag1)) <= CORR_TOL
    assert abs(float(cross)) <= CORR_TOL
    # a seed's leaves and two seeds' leaf 0 are different streams
    assert not torch.equal(a, b)
    assert not torch.equal(a, ref.noise_draw_ref(rng.noise_key(6, 0),
                                                 piece_map((STATS_N,))))


# ---------------------------------------------------------------------------
# a piece is the whole draw's slice


PIECES = {
    "dim0": ((12, 6, 5), [(slice(3, 6), slice(None), slice(None))]),
    "dim1": ((4, 12, 5), [(slice(None), slice(8, 12), slice(None))]),
    "two_dims": ((6, 8, 10), [(slice(2, 4), slice(None), slice(5, 10))]),
    "halves": ((3, 4, 16), [(slice(None), slice(None), slice(2, 4)),
                            (slice(None), slice(None), slice(10, 12))]),
    "halves_and_dim0": ((6, 2, 16), [(slice(3, 6), slice(None), slice(0, 4)),
                                     (slice(3, 6), slice(None),
                                      slice(8, 12))]),
    "ragged_offset": ((7, 11, 3), [(slice(None), slice(3, 8), slice(1, 3))]),
    "vector": ((1001,), [(slice(333, 1000),)]),
}


@pytest.mark.parametrize("case", list(PIECES))
def test_piece_is_the_whole_draws_slice(case):
    full, regions = PIECES[case]
    stream = rng.noise_key(21, 4)
    whole = _whole(stream, full)
    want = torch.cat([whole[r] for r in regions], dim=-1)
    got = ops.channel_noise(torch.zeros_like(want), stream, 1.0, 1.0,
                            piece_map(full, regions))
    assert torch.equal(got, want)
    # the whole leaf through the wrapper is the draw itself
    assert torch.equal(ops.channel_noise(torch.zeros(full), stream, 1.0, 1.0),
                       whole)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", ARCH])
def test_every_leafs_piece_on_a_cut_mesh(arch):
    """Every leaf of a reduced model on a (2, 2) mesh's model ranks
    (jamba: Mamba's halves ``in_proj``, its cut experts and vocabulary):
    a rank's piece is ``cut_leaf`` of the whole leaf's draw."""
    cfg = dataclasses.replace(reg.reduce_config(reg.get_config(arch)),
                              dtype="float32")
    mesh = make_host_mesh(2, 2)
    whole = tree_flatten(T.init_params(cfg, torch.Generator(), device="cpu"))
    halves = 0
    for rank in (0, 1):
        shard = SH.shard_params(T.init_params(cfg, torch.Generator(),
                                              device="cpu"), mesh, rank, cfg)
        lay = SH.CutLayout(shard, cfg, mesh, rank)
        for leaf, k in enumerate(sorted(whole)):
            stream = rng.noise_key(3, leaf)
            want = lay.piece(k, _whole(stream, whole[k].shape))
            got = ops.channel_noise(
                torch.zeros(want.shape), stream, 1.0, 1.0,
                piece_map(lay.full[k], lay.regions(k)))
            assert torch.equal(got, want), (rank, k)
            halves += lay.halves[k] and lay.cut[k]
    assert arch != "jamba-v0.1-52b" or halves > 0


# ---------------------------------------------------------------------------
# the wrapper


def test_wrapper_routes_and_gain():
    stream, sigma = rng.noise_key(2, 1), 0.25
    y = torch.randn((5, 7), generator=torch.Generator().manual_seed(0))
    z = _whole(stream, (5, 7)) * sigma
    want = (y + z) * 3.0
    out = ops.channel_noise(y.clone(), stream, sigma, 3.0, inplace=False)
    assert torch.equal(out, want)
    inplace = y.clone()
    assert ops.channel_noise(inplace, stream, sigma, 3.0) is inplace
    assert torch.equal(inplace, want)
    gain = torch.tensor(3.0)
    assert torch.equal(ops.channel_noise(y.clone(), stream, sigma, gain), want)
    before = dict(ops.LAUNCH_COUNTS)
    ops.channel_noise(y.clone(), stream, sigma, 3.0)
    assert ops.LAUNCH_COUNTS == before         # the plain route counts none
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.channel_noise(y.clone(), stream, sigma, 3.0, impl="kernel")
    with pytest.raises(ValueError, match="contiguous fp32"):
        ops.channel_noise(y.t(), stream, sigma, 3.0)
    with pytest.raises(ValueError, match="elements"):
        ops.channel_noise(y.clone(), stream, sigma, 3.0, piece_map((5, 8)))


def test_meta_route_is_one_pass_of_y():
    from repro_torch.launch import dryrun
    y = torch.empty((1000, 64), device="meta")
    got = dryrun.count(lambda: ops.channel_noise(y, 9, 1.0, 2.0,
                                                 piece_map((2000, 64),
                                                           [(slice(0, 1000),
                                                             slice(None))])))
    assert got["bytes"] == 2 * y.numel() * 4 and got["ops"] == 1


# ---------------------------------------------------------------------------
# the step: a seed is its whole draw injected


MESHES = {
    "4x1": (lambda: make_host_mesh(4, 1), ("data",)),
    "4x2": (lambda: make_host_mesh(4, 2), ("data",)),
    "2x2x1_pod": (lambda: make_host_mesh(2, 1, pod=2), ("pod",)),
}
H = np.array([1.0e-3, 1.4e-3, 0.7e-3, 1.1e-3])
B = np.array([1.0, 0.8, 1.2, 0.9])


def _steps(mesh, axes, how, steps=2):
    cfg = dataclasses.replace(reg.reduce_config(reg.get_config(ARCH)),
                              dtype="float32")
    p0 = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    k = mesh.axis_size(mesh.canonical(axes))
    ota = tl.OTARunParams(h=H[:k], b=B[:k], a=250.0, noise_var=1e-4)
    o = opt.adamw(0.01)
    step, place = tl.build_train_step(
        cfg, mesh, scheme="normalized", aggregation_axes=axes, ota=ota,
        optimizer=o, device="cpu")
    rs = np.random.default_rng(4)
    toks = torch.from_numpy(rs.integers(0, cfg.vocab_size, (8, 32)))
    params, state, rows = place(p0, o.init(p0), {
        "tokens": toks, "labels": toks.roll(-1, 1)})
    for t in range(steps):
        seed = 7 + t
        if how == "seed":
            params, state, m = step(params, state, rows, seed)
        elif how == "generator":
            params, state, m = step(params, state, rows,
                                    torch.Generator().manual_seed(seed))
        elif how == "drawn":
            params, state, m = step(params, state, rows, tl.noise_seed(
                torch.Generator().manual_seed(seed)))
        elif how == "injected":
            z = tl.seeded_noise(seed, p0, ota.noise_var)
            params, state, m = step(params, state, rows, noise=z)
        else:
            params, state, m = step(params, state, rows, None)
    return params, state, m


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(
        tree_leaves(a), tree_leaves(b)))


@pytest.mark.parametrize("name", list(MESHES))
def test_seeded_step_is_its_whole_draw_injected(name):
    make, axes = MESHES[name]
    mesh = make()
    p, s, m = _steps(mesh, axes, "seed")
    pi, si, mi = _steps(mesh, axes, "injected")
    for r in range(mesh.size):
        assert _same(p[r], pi[r]), r
        assert _same(tuple(s[r]), tuple(si[r])), r
    assert all(torch.equal(m[k], mi[k]) for k in m)
    # and the noise is there: a noiseless step ends elsewhere
    pq, _, _ = _steps(mesh, axes, "none")
    assert not _same(p[0], pq[0])


def test_generator_gives_the_seed_by_one_draw():
    gen = torch.Generator().manual_seed(7)
    want = int(torch.randint(0, 2 ** 63 - 1, (),
                             generator=torch.Generator().manual_seed(7)))
    assert tl.noise_seed(gen) == want and tl.noise_seed(7) == 7
    assert tl.noise_seed(None) is None
    mesh = make_host_mesh(4, 1)
    p, _, _ = _steps(mesh, ("data",), "generator", steps=1)
    q, _, _ = _steps(mesh, ("data",), "drawn", steps=1)
    assert _same(p[0], q[0])
