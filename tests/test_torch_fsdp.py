"""FSDP over ``data`` on the mean path (``launch/train.py``'s
``build_train_step(scheme="mean", fsdp_axis="data")``), on the CPU:

* ``RankContext.unshard`` (the gather of a leaf's slices over ``data``):
  ``torch.autograd.gradcheck`` at fp64 of its backward (the whole leaves'
  gradients folded over ``data``, the rank's slice kept) on a (2, 1) and
  a (2, 2) emulated mesh, two leaves cut along different dims in one
  collective; its forward the concatenation of the slices, bitwise;
* the FSDP step bitwise the same step without FSDP (reduced granite,
  fp32, two steps): every rank's slice of the new params and of the
  optimizer state, the loss and the metrics, at (2, 2) and (4, 2), with
  ``cfg.remat`` on and off, under ``sgd`` and ``adamw``;
* the cut: every rank's slices gathered give the whole tree back, the
  ``F`` entries are the reference's ``param_specs(fsdp_axis=)`` sanitized
  against the whole leaves, ``tok`` is not cut, ``init_sharded_params``
  draws the same slices as ``shard_params``;
* two planted faults rejected: the gather's backward without its fold,
  and the cut leaves' gradients folded over ``data`` again by the step;
* the reference's ``build_train_step(scheme="mean", fsdp_axis="data")``
  on a ``(4, 2)`` forced-host mesh, one subprocess, two steps of reduced
  granite at fp32 (sgd with momentum), the weights carried across: every
  metric and final parameter.

The physical mesh (four ``gloo`` ranks) is held bitwise to the emulated
one in ``tests/test_torch_tp_train.py``, which spawns its ranks once.
torch runs on one thread in this file.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as reg
from repro_torch.distribution import sharding as SH
from repro_torch.distribution import tensor_parallel as TPM
from repro_torch.distribution.tensor_parallel import run_ranks
from repro_torch.launch import train as tl
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as opt
from repro_torch.tree import tree_leaves, tree_unflatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "granite-moe-1b-a400m"
# the port's FSDP step against the reference's, two steps of sgd with
# momentum at fp32: the metrics within METRIC_REL, every final parameter
# within PARAM_REL of its leaf's largest change (the bounds of the (4, 2)
# step without FSDP in tests/test_torch_tp_train.py; measured 9.6e-8 and
# 5.5e-5, the port's step without FSDP the same).  Not adamw: its
# normalised update turns the rounding of a near-zero gradient into a
# step of the full rate (measured 0.19 of a leaf's change, both ports)
METRIC_REL = 1e-6
PARAM_REL = 3e-4
# a planted fault moves some leaf by more than this share of its change
FAULT_REL = 1e-2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(arch=ARCH, **kw):
    return dataclasses.replace(reg.reduce_config(reg.get_config(arch)),
                               dtype="float32", **kw)


def _params(cfg, seed=0):
    return T.init_params(cfg, torch.Generator().manual_seed(seed),
                         device="cpu")


def _batch(cfg, rows=8, seq=32, seed=5):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (rows, seq), generator=g)
    mask = (torch.rand((rows, seq), generator=g) > 0.3).float()
    return {"tokens": toks, "labels": toks.roll(-1, 1), "loss_mask": mask}


# ---------------------------------------------------------------------------
# the gather and its conjugate


class _Ranks(torch.autograd.Function):
    """``fn(ctx, x_rank)`` on every rank of an emulated mesh, as one
    function of the stacked per-rank inputs to the stacked outputs; its
    backward runs every rank's own backward on the mesh with the rank's
    part of the upstream gradient."""

    @staticmethod
    def forward(c, xs, mesh, fn):
        c.save_for_backward(xs)
        c.mesh, c.fn = mesh, fn
        return torch.stack(run_ranks(
            mesh, lambda ctx: fn(ctx, xs[ctx.rank]).detach()))

    @staticmethod
    def backward(c, g):
        xs, = c.saved_tensors

        def program(ctx):
            a = xs[ctx.rank].detach().requires_grad_()
            with torch.enable_grad():
                return torch.autograd.grad(c.fn(ctx, a), a, g[ctx.rank])[0]
        return torch.stack(run_ranks(c.mesh, program)), None, None


def _two_leaves(ctx, x):
    """A rank's slices of two leaves (rows of one, columns of the other)
    gathered over ``data`` in one call, then a rank's own work on them:
    the batch is cut over ``data``, so the loss is the sum over ranks."""
    ctx.batch_split = True
    a, b = ctx.unshard([x[:, :3], x[:, 3:].T.contiguous()], [0, 1])
    w = torch.arange(1.0, 4.0, dtype=x.dtype) * (ctx.rank + 1)
    return torch.sin(a * w).sum(0) + torch.cos(b).sum() * (ctx.d + 1)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_unshard_gradcheck(shape):
    mesh = make_host_mesh(*shape)
    xs = torch.randn((mesh.size, 2, 5), generator=torch.Generator()
                     .manual_seed(3), dtype=torch.float64,
                     requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a: _Ranks.apply(a, mesh, _two_leaves), (xs,))


def test_unshard_forward_is_the_concatenation():
    """The forward concatenates the data ranks' slices in rank order along
    each leaf's dim, bitwise, per dtype; without a cut batch the backward
    keeps the rank's slice of its own gradient, unfolded."""
    mesh = make_host_mesh(2, 2)
    gen = torch.Generator().manual_seed(4)
    xs = torch.randn((mesh.size, 3, 4), generator=gen)
    ys = torch.randn((mesh.size, 2, 5), generator=gen).double()

    def program(ctx):
        x = xs[ctx.rank].clone().requires_grad_()
        a, b = ctx.unshard([x, ys[ctx.rank]], [1, 0])
        col = [xs[d * 2 + ctx.m] for d in range(2)]
        ok = (torch.equal(a, torch.cat(col, 1))
              and torch.equal(b, torch.cat([ys[d * 2 + ctx.m]
                                            for d in range(2)], 0))
              and b.dtype == torch.float64)
        g = torch.autograd.grad((a * a).sum(), x)[0]
        return ok and torch.equal(g, 2 * x.detach())
    assert all(run_ranks(mesh, program))


# ---------------------------------------------------------------------------
# the step against the step without FSDP, bitwise


def _run(cfg, mesh, o, params, batch, fsdp, steps=2):
    step, place = tl.build_train_step(cfg, mesh, scheme="mean",
                                      fsdp_axis=fsdp, optimizer=o,
                                      device="cpu")
    p, s, rows = place(params, o.init(params), batch)
    metrics = []
    for _ in range(steps):
        p, s, m = step(p, s, rows)
        metrics.append(m)
    return p, s, metrics


def _as_fsdp(cfg, mesh, like, shards):
    """Every rank's FSDP slice of the whole tree the plain shards make."""
    whole = SH.gather_params(shards, mesh, cfg, like)
    return [SH.shard_params(whole, mesh, r, cfg, "data")
            for r in range(mesh.size)]


def _state_trees(o, state):
    """An optimizer state's trees (momenta), empty where they are 0-d."""
    return [t for t in (state.mu, state.nu) if not isinstance(t,
                                                              torch.Tensor)]


def _same_bits(cfg, mesh, params, o, want, got) -> bool:
    pw, sw, mw = want
    pg, sg, mg = got
    ok = all(torch.equal(a, b)
             for r, shard in enumerate(_as_fsdp(cfg, mesh, params, pw))
             for a, b in zip(tree_leaves(pg[r]), tree_leaves(shard)))
    for tw, tg in zip(zip(*[_state_trees(o, s) for s in sw]),
                      zip(*[_state_trees(o, s) for s in sg])):
        ok = ok and all(torch.equal(a, b) for r, shard in enumerate(
            _as_fsdp(cfg, mesh, params, list(tw)))
            for a, b in zip(tree_leaves(tg[r]), tree_leaves(shard)))
    return ok and all(torch.equal(a[k], b[k]) for a, b in zip(mw, mg)
                      for k in a)


STEP_CASES = {
    "2x2_sgd_remat": ((2, 2), "sgd", True),
    "2x2_adamw": ((2, 2), "adamw", False),
    "4x2_adamw_remat": ((4, 2), "adamw", True),
    "4x2_sgd": ((4, 2), "sgd", False),
}


def _opt(name):
    return opt.sgd(0.05, momentum=0.9) if name == "sgd" else opt.adamw(
        opt.cosine_schedule(0.01, 1, 4), weight_decay=0.01)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_fsdp_step_is_the_plain_step_bitwise(case):
    shape, name, remat = STEP_CASES[case]
    cfg = _cfg(remat=remat)
    params = _params(cfg)
    batch = _batch(cfg)
    mesh = make_host_mesh(*shape)
    o = _opt(name)
    want = _run(cfg, mesh, o, params, batch, None)
    got = _run(cfg, mesh, o, params, batch, "data")
    assert _same_bits(cfg, mesh, params, o, want, got)
    assert float(got[2][1]["loss"]) < float(got[2][0]["loss"])


# ---------------------------------------------------------------------------
# the cut


@pytest.mark.parametrize("arch", [ARCH, "jamba-v0.1-52b", "xlstm-1.3b",
                                  "seamless-m4t-medium"])
@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_slices_add_up_to_the_whole_tree(arch, shape):
    """Every rank's slices gathered give the whole tree; the cut of each
    leaf is the reference's ``param_specs(fsdp_axis="data")`` sanitized
    against the whole leaf (whole where the plan keeps a module whole);
    ``CutLayout`` gives back each whole shape and rank's piece."""
    cfg = _cfg(arch)
    params = _params(cfg)
    mesh = make_host_mesh(*shape)
    plan = SH.tp_plan(cfg, mesh.model)

    def expect(names, leaf, spec):
        kept = SH.leaf_cut(names, spec, plan)
        return SH.sanitize_spec(mesh, SH.Spec(*(
            e if e == "data" or kept[d] is not None else None
            for d, e in enumerate(spec))), leaf.shape)
    want = SH._zip_named(expect, params,
                         SH.param_specs(params, fsdp_axis="data"))
    assert SH.tp_param_specs(params, cfg, mesh, "data") == want
    assert SH.tp_param_specs(params, cfg, mesh, "data")["emb"]["tok"][1] \
        is None
    shards = [SH.shard_params(params, mesh, r, cfg, "data")
              for r in range(mesh.size)]
    whole = SH.gather_params(shards, mesh, cfg, params, "data")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(whole),
                                                 tree_leaves(params)))
    full = dict(enumerate(tree_leaves(params)))
    cut = 0
    for r, shard in enumerate(shards):
        lay = SH.CutLayout(shard, cfg, mesh, r, "data")
        assert SH.tp_param_specs(shard, cfg, mesh, "data") == want
        for i, got in enumerate(tree_leaves(shard)):
            k = f"{i:05d}"
            assert lay.full[k] == tuple(full[i].shape)
            assert torch.equal(lay.piece(k, full[i]), got)
            cut += lay.fsdp[k] is not None
    assert cut > 0


def test_init_sharded_params_draws_the_fsdp_slices():
    cfg = _cfg("xlstm-1.3b")
    mesh = make_host_mesh(2, 2)
    params = _params(cfg, seed=3)
    for r in range(mesh.size):
        got = T.init_sharded_params(cfg, torch.Generator().manual_seed(3),
                                    mesh, r, device="cpu", fsdp_axis="data")
        want = SH.shard_params(params, mesh, r, cfg, "data")
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                     tree_leaves(want)))


# ---------------------------------------------------------------------------
# planted faults


class _FoldEverything(SH.CutLayout):
    """A layout that reports no leaf cut over ``data``: the step then folds
    the gathered leaves' gradients again."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.fsdp = {k: None for k in self.fsdp}


def _gap(cfg, mesh, params, want, got) -> float:
    """The largest gap of a final FSDP slice to the plain step's, over its
    leaf's largest change."""
    out = 0.0
    for r, shard in enumerate(_as_fsdp(cfg, mesh, params, want[0])):
        for a, b, p0 in zip(tree_leaves(got[0][r]), tree_leaves(shard),
                            tree_leaves(SH.shard_params(params, mesh, r, cfg,
                                                        "data"))):
            moved = float((b - p0).abs().max())
            if moved > 0:
                out = max(out, float((a - b).abs().max()) / moved)
    return out


@pytest.mark.parametrize("fault", ["gather_without_fold", "folded_twice"])
def test_planted_faults_are_rejected(fault, monkeypatch):
    cfg = _cfg()
    params = _params(cfg)
    batch = _batch(cfg)
    mesh = make_host_mesh(2, 2)
    o = opt.sgd(0.05)
    want = _run(cfg, mesh, o, params, batch, None, steps=1)
    if fault == "gather_without_fold":
        real = TPM._Unshard.backward

        def no_fold(fctx, *gs):
            keep, fctx.rc.batch_split = fctx.rc.batch_split, False
            try:
                return real(fctx, *gs)
            finally:
                fctx.rc.batch_split = keep
        monkeypatch.setattr(TPM._Unshard, "backward", staticmethod(no_fold))
    else:
        monkeypatch.setattr(tl.SH, "CutLayout", _FoldEverything)
    got = _run(cfg, mesh, o, params, batch, "data", steps=1)
    monkeypatch.undo()
    assert not _same_bits(cfg, mesh, params, o, want, got)
    assert _gap(cfg, mesh, params, want, got) > FAULT_REL


def test_what_still_raises():
    """FSDP with an OTA scheme, over ('pod', 'data') on a mesh without a
    pod axis, over another axis."""
    cfg = _cfg()
    mesh = make_host_mesh(2, 2)
    ota = tl.OTARunParams(h=np.ones(2), b=np.ones(2))
    with pytest.raises(NotImplementedError, match="never pair"):
        tl.build_train_step(cfg, mesh, scheme="normalized", ota=ota,
                            aggregation_axes=("data",), fsdp_axis="data",
                            device="cpu")
    with pytest.raises(ValueError, match="on a mesh with a pod axis"):
        tl.build_train_step(cfg, mesh, scheme="mean",
                            fsdp_axis=("pod", "data"), device="cpu")
    with pytest.raises(ValueError, match="'data' axis"):
        tl.build_train_step(cfg, mesh, scheme="mean", fsdp_axis="model",
                            device="cpu")


# ---------------------------------------------------------------------------
# the reference's FSDP step on a (4, 2) forced-host mesh


STEPS = 2
REFERENCE_SCRIPT = r'''
import os
import sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.registry import get_config, reduce_config
from repro.launch import train as tl
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as T
from repro.optim.optimizers import sgd

STEPS, ARCH = eval(sys.argv[2])
mesh = make_host_mesh(4, 2)
cfg = dataclasses.replace(reduce_config(get_config(ARCH)), dtype="float32")
params0 = T.init_params(cfg, jax.random.PRNGKey(0))
rng = np.random.default_rng(2)
tokens = rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32)
labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
mask = np.ones((8, 32), np.float32)
mask[2:4, 16:] = 0.0
mask[4:6] = rng.random((2, 32)) > 0.5
batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
         "loss_mask": jnp.asarray(mask)}
res = {"tokens": tokens, "labels": labels, "mask": mask}
for i, l in enumerate(jax.tree_util.tree_leaves(params0)):
    res[f"p0/{i:05d}"] = np.asarray(l)
o = sgd(0.05, momentum=0.9)
step, in_sh = tl.build_train_step(cfg, mesh, scheme="mean",
                                  fsdp_axis="data", optimizer=o)
params, opt_state = params0, o.init(params0)
ps, os_, bs = in_sh(params, opt_state, batch)
with jax.set_mesh(mesh):
    params = jax.device_put(params, ps)
    opt_state = jax.device_put(opt_state, os_)
    bt = jax.device_put(batch, bs)
    jitted = jax.jit(step, in_shardings=(ps, os_, bs,
                                         NamedSharding(mesh, P())),
                     out_shardings=(ps, os_, None))
    for t in range(STEPS):
        params, opt_state, m = jitted(params, opt_state, bt,
                                      jax.random.PRNGKey(t))
        for k, v in m.items():
            res[f"m{t}/{k}"] = np.asarray(v)
for i, l in enumerate(jax.tree_util.tree_leaves(params)):
    res[f"p/{i:05d}"] = np.asarray(l)
np.savez(sys.argv[1], **res)
print("REF_FSDP_OK")
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref_fsdp")
    script = tmp / "ref_fsdp.py"
    script.write_text(REFERENCE_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(script), str(tmp / "ref.npz"),
                        repr((STEPS, ARCH))], capture_output=True, text=True,
                       env=env, cwd=ROOT, timeout=600)
    assert "REF_FSDP_OK" in r.stdout, r.stderr[-4000:]
    return dict(np.load(tmp / "ref.npz"))


def test_fsdp_step_matches_reference(reference):
    cfg = _cfg()
    like = T.init_params(cfg, torch.Generator(), device="cpu")
    n = len(tree_leaves(like))
    p0 = tree_unflatten(like, {f"{i:05d}": torch.from_numpy(
        reference[f"p0/{i:05d}"]) for i in range(n)})
    batch = {"tokens": torch.from_numpy(reference["tokens"]),
             "labels": torch.from_numpy(reference["labels"]),
             "loss_mask": torch.from_numpy(reference["mask"])}
    mesh = make_host_mesh(4, 2)
    o = opt.sgd(0.05, momentum=0.9)
    step, place = tl.build_train_step(cfg, mesh, scheme="mean",
                                      fsdp_axis="data", optimizer=o,
                                      device="cpu")
    params, state, rows = place(p0, o.init(p0), batch)
    for t in range(STEPS):
        params, state, m = step(params, state, rows)
        assert set(m) == {k.split("/")[-1] for k in reference
                          if k.startswith(f"m{t}/")}
        for k, v in m.items():
            want = float(reference[f"m{t}/{k}"])
            assert abs(float(v) - want) <= METRIC_REL * abs(want), (t, k)
    full = SH.gather_params(params, mesh, cfg, p0, "data")
    for i, leaf in enumerate(tree_leaves(full)):
        want = reference[f"p/{i:05d}"]
        moved = np.abs(want - reference[f"p0/{i:05d}"]).max()
        assert np.abs(leaf.numpy() - want).max() <= PARAM_REL * moved, i
