"""Tensor-parallel training (``launch/train.py`` on a ``(data, model)``
mesh) against the uncut model and the JAX package's, on the CPU:

* the conjugate collectives (``RankContext.fold``, ``enter``, ``gather``):
  their forward bits are the folds' and stacks' of the ranks' inputs, and
  ``torch.autograd.gradcheck`` at fp64 holds their backward on a (1, 2)
  and a (2, 2) emulated mesh, through a function that feeds every rank of
  a group the same upstream gradient (the loss is replicated, counted
  once);
* ``forward_loss``'s gradient over a cut model, gathered with
  ``gather_params``, against the uncut model's leaf by leaf (reduced
  granite over model = 2: heads, kv, experts and vocabulary cut; over
  model = 4: kv whole; reduced jamba over model = 2: Mamba and the dense
  MLP cut), the replicated leaves bitwise equal across the model ranks,
  and two planted faults (``enter`` without its backward fold; the
  replicated leaves' gradients folded again) rejected;
* ``ota_psum``'s statistics over a cut gradient (``cut_stats``) against
  the uncut client's, and every registered scheme's update on a (2, 2)
  mesh against the (2, 1) mesh's;
* the reference's ``build_train_step`` on a ``(4, 2)`` forced-host mesh,
  one subprocess, reduced granite at fp32, three steps of ``normalized``
  with its noise taken out and injected and of ``mean``: every metric and
  final parameter;
* the port's counterparts of ``tests/test_distribution.py::
  test_ota_train_step_loss_decreases_on_mesh`` and ``test_seq_parallel_
  is_numerically_transparent``;
* four ``gloo`` ranks (one subprocess): a physical ``(2, 2)`` mesh bitwise
  the emulated one, on the OTA and the mean path, the mean path under
  FSDP (``tests/test_torch_fsdp.py``), and reduced xlstm-1.3b and
  seamless-m4t-medium served and trained one step
  (``tests/test_torch_tp_zoo.py``);
* the pod axis: a (2, 2, 1) mesh whose clients are its (pod, data) ranks,
  and its mean path under FSDP over (pod, data), bitwise the (4, 1) mesh
  they flatten to; a client a pod (``aggregation_axes=("pod",)``) against
  the reference's (2, 2, 1) step (in the reference's subprocess) and over
  four gloo ranks;
* what still raises: FSDP with an OTA scheme, and over (pod, data) on a
  mesh without a pod axis.

torch runs on one thread in this file and in the ranks.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as reg
from repro_torch.core import schemes
from repro_torch.distribution import ota_collectives as oc
from repro_torch.distribution import sharding as SH
from repro_torch.distribution.ota_collectives import fold_shards
from repro_torch.distribution.tensor_parallel import run_ranks
from repro_torch.launch import train as tl
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as opt
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "granite-moe-1b-a400m"
# fp32: a cut model's gradient leaves within GRAD_REL of the uncut
# model's largest entry of the leaf (measured: at most 2.7e-6, jamba; the
# row-parallel products and the folds sum in other orders)
GRAD_REL = 2e-5
# the (4, 2) step against the reference's (4, 2) step, three steps at fp32:
# the metrics within METRIC_REL, every final parameter within PARAM_REL of
# its leaf's largest change (measured: 1.5e-7 and 6.4e-5, the mean path)
METRIC_REL = 1e-6
PARAM_REL = 3e-4
# a (2, 2) scheme's update against the (2, 1) mesh's, one step: the
# metrics and every parameter within STEP_REL of the leaf's largest change
# (measured: at most 7.4e-6, raw and normalized_per_tensor; metrics equal)
STEP_REL = 3e-5


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


def _batch(cfg, rows, seq, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (rows, seq))
    mask = (rng.random((rows, seq)) > 0.2).astype(np.float32)
    return {"tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(np.roll(toks, -1, axis=1)),
            "loss_mask": torch.from_numpy(mask)}


# ---------------------------------------------------------------------------
# the conjugate collectives


class _MeshFn(torch.autograd.Function):
    """``fn(ctx, x_rank, x_group)`` run on every rank of an emulated mesh,
    as one function of the per-rank inputs ``xs`` [ranks, ...] and the
    per-group replicated inputs ``xg`` [data, ...] to the groups' outputs
    [data, ...] (the output of a group's ranks is replicated: model rank
    0's is returned).  Its backward hands every rank of a group the same
    upstream gradient and runs each rank's own backward on the mesh; a
    replicated input's gradient must come out the same on every rank."""

    @staticmethod
    def forward(c, xs, xg, mesh, fn):
        c.save_for_backward(xs, xg)
        c.mesh, c.fn = mesh, fn
        outs = run_ranks(mesh, lambda ctx: fn(ctx, xs[ctx.rank],
                                              xg[ctx.d]).detach())
        return torch.stack([outs[d * mesh.model] for d in range(mesh.data)])

    @staticmethod
    def backward(c, g):
        xs, xg = c.saved_tensors

        def program(ctx):
            a = xs[ctx.rank].detach().requires_grad_()
            b = xg[ctx.d].detach().requires_grad_()
            with torch.enable_grad():
                out = c.fn(ctx, a, b)
                return torch.autograd.grad(out, (a, b), g[ctx.d])
        res = run_ranks(c.mesh, program)
        m = c.mesh.model
        for d in range(c.mesh.data):
            for r in range(d * m, (d + 1) * m):
                assert torch.equal(res[r][1], res[d * m][1])
        return (torch.stack([r[0] for r in res]),
                torch.stack([res[d * m][1] for d in range(c.mesh.data)]),
                None, None)


def _conjugates(ctx, x, xg):
    """Every conjugate op on its boundary: ``xg`` (replicated) enters
    rank-partial work, whose row-parallel output folds; a rank's own ``x``
    is gathered and read replicated after."""
    w = torch.arange(1.0, 5.0, dtype=torch.float64) * (ctx.m + 1)
    partial = torch.sin(ctx.enter(xg) * w) * x
    folded = ctx.fold(partial)
    stack = ctx.gather(x * x)                      # [M, 4]
    return folded * torch.sum(stack, dim=0) + torch.cos(xg) * folded


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_conjugate_collectives_gradcheck(shape):
    mesh = make_host_mesh(*shape)
    gen = torch.Generator().manual_seed(3)
    xs = torch.randn((mesh.size, 4), generator=gen, dtype=torch.float64,
                     requires_grad=True)
    xg = torch.randn((mesh.data, 4), generator=gen, dtype=torch.float64,
                     requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b: _MeshFn.apply(a, b, mesh, _conjugates), (xs, xg))


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_conjugate_forward_bits(shape):
    """``fold``, ``enter`` and ``gather`` under autograd give the bits of
    the fold and the stack of the ranks' inputs (and ``enter`` its input);
    the max fold carries no gradient."""
    mesh = make_host_mesh(*shape)
    gen = torch.Generator().manual_seed(4)
    xs = torch.randn((mesh.size, 3, 5), generator=gen)

    def program(ctx):
        x = xs[ctx.rank].clone().requires_grad_()
        group = xs[ctx.d * mesh.model:(ctx.d + 1) * mesh.model]
        col = xs[ctx.m::mesh.model]
        mx = ctx.fold(x, op=torch.maximum)
        return (torch.equal(ctx.fold(x), fold_shards(group)),
                torch.equal(ctx.fold(x, "data"), fold_shards(col)),
                torch.equal(ctx.gather(x), group),
                torch.equal(ctx.enter(x), x),
                ctx.fold(x).requires_grad and ctx.enter(x).requires_grad,
                torch.equal(mx, fold_shards(group, torch.maximum))
                and not mx.requires_grad)
    assert all(all(r) for r in run_ranks(mesh, program))


# ---------------------------------------------------------------------------
# a cut model's gradient against the uncut model's


GRAD_CASES = {
    "granite_m2": (ARCH, 2),          # heads, kv, experts, vocab cut
    "granite_m4": (ARCH, 4),          # kv whole: each rank's kv heads
    "jamba_m2": ("jamba-v0.1-52b", 2),  # Mamba and the dense MLP cut
}


def _rank_grads(cfg, params, batch, mesh, client_grads=tl._client_grads):
    """Every rank's (loss, metrics, gradient tree) on its shard."""
    def program(ctx):
        p = SH.shard_params(params, mesh, ctx.rank, cfg)
        loss, m, g = client_grads(cfg, ctx, p, batch)
        return loss, m, tree_unflatten(p, tree_flatten(g))
    return run_ranks(mesh, program)


def _uncut(cfg, params, batch):
    return tl._value_and_grad(lambda q: T.forward_loss(q, cfg, batch),
                              params)


def _grad_gaps(cfg, params, batch, mesh, outs):
    """The largest relative gap of a gathered gradient leaf to the uncut
    model's, and whether every replicated leaf is the same bits on every
    model rank."""
    loss, metrics, want = _uncut(cfg, params, batch)
    full = SH.gather_params([o[2] for o in outs], mesh, cfg, params)
    gap = max(float((a - b).abs().max()) / float(b.abs().max())
              for a, b in zip(tree_leaves(full), want))
    lay = SH.CutLayout(outs[0][2], cfg, mesh, 0)
    flat = [tree_flatten(o[2]) for o in outs]
    same = all(torch.equal(f[k], flat[0][k]) for f in flat[1:]
               for k in flat[0] if not lay.cut[k])
    return gap, same, loss, metrics


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_cut_gradients_match_uncut(case):
    arch, m = GRAD_CASES[case]
    cfg = _cfg(arch)
    params = _params(cfg)
    batch = _batch(cfg, 2, 64, seed=5)
    mesh = make_host_mesh(1, m)
    plan = SH.tp_plan(cfg, m)
    assert plan.experts and plan.mamba and plan.vocab
    assert plan.kv == (m == 2)
    outs = _rank_grads(cfg, params, batch, mesh)
    gap, same, loss, metrics = _grad_gaps(cfg, params, batch, mesh, outs)
    assert float(metrics["aux"]) > 0.0
    assert gap <= GRAD_REL, gap
    assert same
    for o in outs:
        assert abs(float(o[0]) - float(loss)) <= 1e-6 * float(loss)
    # the router and the norms are among the replicated leaves
    lay = SH.CutLayout(outs[0][2], cfg, mesh, 0)
    whole = {names[-2] if names[-1] == "scale" else names[-1]
             for (names, _), k in zip(SH._named_leaves(outs[0][2]),
                                      sorted(lay.cut)) if not lay.cut[k]}
    assert {"router", "ln1", "ln2", "final_ln"} <= whole


def _fault_fold_again(cfg, ctx, params, rows, count=None):
    """The replicated leaves' gradients folded over the model axis after
    the backward."""
    loss, m, grads = tl._client_grads(cfg, ctx, params, rows, count)
    lay = SH.CutLayout(params, cfg, ctx.mesh, ctx.rank)
    return loss, m, tuple(g if lay.cut[f"{i:05d}"] else ctx.fold(g)
                          for i, g in enumerate(grads))


@pytest.mark.parametrize("fault", ["no_backward_fold", "fold_again"])
def test_planted_faults_are_rejected(fault, monkeypatch):
    """``enter`` without its backward fold, and the replicated leaves'
    gradients folded again after the backward (the router's aux part then
    counts twice): the uncut comparison rejects both."""
    from repro_torch.distribution import tensor_parallel as TPM
    cfg = _cfg()
    params = _params(cfg)
    batch = _batch(cfg, 2, 64, seed=5)
    mesh = make_host_mesh(1, 2)
    grads_fn = tl._client_grads
    if fault == "no_backward_fold":
        monkeypatch.setattr(TPM.RankContext, "enter",
                            lambda self, x, axis="model": x)
    else:
        grads_fn = _fault_fold_again
    outs = _rank_grads(cfg, params, batch, mesh, client_grads=grads_fn)
    monkeypatch.undo()
    gap = _grad_gaps(cfg, params, batch, mesh, outs)[0]
    assert gap > 1e3 * GRAD_REL, gap


@pytest.mark.parametrize("arch", [ARCH, "jamba-v0.1-52b", "qwen2-7b"])
@pytest.mark.parametrize("m", [2, 4])
def test_param_specs_hold_for_a_shard(arch, m):
    """The cut read from names alone (``tp_param_specs``), of the whole
    tree and of any rank's shard, is the reference's ``param_specs``
    sanitized against the whole leaves' shapes and made whole where the
    plan keeps a module whole; ``CutLayout`` gives back the whole shapes
    and each rank's piece."""
    cfg = _cfg(arch)
    params = _params(cfg)
    mesh = make_host_mesh(1, m)
    plan = SH.tp_plan(cfg, m)
    want = SH._zip_named(lambda names, leaf, spec: SH.leaf_cut(
        names, SH.sanitize_spec(mesh, spec, leaf.shape), plan), params,
        SH.param_specs(params))
    assert SH.tp_param_specs(params, cfg, mesh) == want
    full = tree_flatten(params)
    for r in range(m):
        shard = SH.shard_params(params, mesh, r, cfg)
        assert SH.tp_param_specs(shard, cfg, mesh) == want
        lay = SH.CutLayout(shard, cfg, mesh, r)
        got = tree_flatten(shard)
        for k, v in full.items():
            assert lay.full[k] == tuple(v.shape)
            assert torch.equal(lay.piece(k, v), got[k])


# ---------------------------------------------------------------------------
# the OTA statistics over a cut gradient


@pytest.mark.parametrize("scheme", ["normalized_per_tensor", "benchmark2"])
@pytest.mark.parametrize("impl", ["kernels", "plain"])
def test_cut_stats_are_the_whole_clients(scheme, impl):
    """Sigma g^2, Sigma g, the per-tensor squares and the count of a cut
    gradient (K1 rows of the cut leaves folded over model, the replicated
    leaves once) against the uncut client's."""
    cfg = _cfg()
    params = _params(cfg)
    batch = _batch(cfg, 2, 32, seed=6)
    want = tree_flatten(list(_uncut(cfg, params, batch)[2]))
    sch = schemes.get(scheme)
    ref = schemes.compute_stats(want, sch, batched=False)
    mesh = make_host_mesh(1, 2)

    def program(ctx):
        p = SH.shard_params(params, mesh, ctx.rank, cfg)
        g = tree_flatten(list(tl._client_grads(cfg, ctx, p, batch)[2]))
        lay = SH.CutLayout(p, cfg, mesh, ctx.rank)
        return oc.cut_stats(g, sch, impl, ctx, lay)
    for st in run_ranks(mesh, program):
        assert st.count == ref.count
        assert abs(float(st.sq_norm) - float(ref.sq_norm)) \
            <= 1e-5 * float(ref.sq_norm)
        if sch.needs_moments:
            assert abs(float(st.total) - float(ref.total)) \
                <= 1e-5 * float(torch.cat([v.abs().reshape(-1)
                                           for v in want.values()]).sum())
        if sch.per_tensor:
            for a, b in zip(st.tensor_sq_norms, ref.tensor_sq_norms):
                assert abs(float(a) - float(b)) <= 1e-5 * float(b) + 1e-12


def _one_step(cfg, params, mesh, scheme, batch, noise):
    o = opt.sgd(0.05)
    ota = tl.OTARunParams(h=np.array([1e-3, 2e-3]), b=np.array([1.0, 0.7]),
                          a=400.0, noise_var=1e-7,
                          grad_bound=5.0 if scheme in ("benchmark1",
                                                       "clipped") else None)
    step, place = tl.build_train_step(
        cfg, mesh, scheme=scheme, aggregation_axes=("data",), ota=ota,
        optimizer=o, device="cpu")
    p, s, rows = place(params, o.init(params), batch)
    p, s, m = step(p, s, rows, noise=noise)
    return SH.gather_params(p, mesh, cfg, params), m


@pytest.mark.parametrize("scheme", [s for s in schemes.names()
                                    if s != "mean"])
def test_every_scheme_on_a_cut_client(scheme):
    """One step of each registered OTA scheme: the (2, 2) mesh's update
    (gathered) and metrics against the (2, 1) mesh's, the same injected
    noise."""
    cfg = _cfg(num_layers=1)
    params = _params(cfg)
    batch = _batch(cfg, 4, 32, seed=7)
    n = T.param_count(params)
    noise = torch.randn(n, generator=torch.Generator().manual_seed(8)) \
        * 3e-4
    want, wm = _one_step(cfg, params, make_host_mesh(2, 1), scheme, batch,
                         noise)
    got, gm = _one_step(cfg, params, make_host_mesh(2, 2), scheme, batch,
                        noise)
    for k in wm:
        assert abs(float(gm[k]) - float(wm[k])) <= STEP_REL * abs(
            float(wm[k])) + 1e-12, k
    for a, b, p0 in zip(tree_leaves(got), tree_leaves(want),
                        tree_leaves(params)):
        moved = float((b - p0).abs().max())
        assert float((a - b).abs().max()) <= STEP_REL * max(moved, 1e-6)


# ---------------------------------------------------------------------------
# the reference's train step on a (4, 2) forced-host mesh


# "pod": a client a pod of a (pod 2, data 2, model 1) mesh, its two data
# ranks splitting its rows and folding its gradient (the multi-pod plan of
# llama3-405b, ``launch/dryrun.py::plan_for``), against the reference's
# ``aggregation_axes=("pod",)`` on its (2, 2, 1) mesh
CASES = {
    "normalized": dict(scheme="normalized", a=250.0, noise_var=1e-7,
                       schedule=True),
    "mean": dict(scheme="mean", a=None, noise_var=0.0, schedule=False),
    "pod": dict(scheme="normalized", a=250.0, noise_var=1e-7, schedule=True,
                pod=True),
}
H = np.array([1e-3, 2e-3, 1.5e-3, 0.5e-3])
B = np.array([1.0, 0.8, 1.2, 0.9])
STEPS = 3

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
from repro.core import schemes
from repro.launch import train as tl
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as T
from repro.optim.optimizers import inverse_power_schedule, sgd

CASES, H, B, STEPS, ARCH = eval(sys.argv[2])
H, B = np.asarray(H), np.asarray(B)
mesh = make_host_mesh(4, 2)
pod_mesh = jax.make_mesh((2, 2, 1), ("pod", "data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
cfg = dataclasses.replace(reduce_config(get_config(ARCH)), dtype="float32")
params0 = T.init_params(cfg, jax.random.PRNGKey(0))
rng = np.random.default_rng(2)
tokens = rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32)
labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
mask = np.ones((8, 32), np.float32)      # a count a data rank that differs
mask[2:4, 16:] = 0.0
mask[4:6] = rng.random((2, 32)) > 0.5
mask[6:8, 4:] = 0.0
batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
         "loss_mask": jnp.asarray(mask)}
res = {"tokens": tokens, "labels": labels, "mask": mask}
for i, l in enumerate(jax.tree_util.tree_leaves(params0)):
    res[f"p0/{i:05d}"] = np.asarray(l)
zeros = jax.tree_util.tree_map(lambda l: jnp.zeros(l.shape, jnp.float32),
                               params0)
for name, c in CASES.items():
    o = sgd(inverse_power_schedule(0.75, eta0=0.05) if c["schedule"]
            else 0.05)
    ota = None
    m_, axes, k = ((pod_mesh, ("pod",), 2) if c.get("pod")
                   else (mesh, ("data",), 4))
    if c["scheme"] != "mean":
        ota = tl.OTARunParams(h=H[:k], b=B[:k], a=c["a"],
                              noise_var=c["noise_var"])
    step, in_sh = tl.build_train_step(
        cfg, m_, scheme=c["scheme"],
        aggregation_axes=None if ota is None else axes, ota=ota,
        optimizer=o)
    params, opt_state = params0, o.init(params0)
    ps, os_, bs = in_sh(params, opt_state, batch)
    with jax.set_mesh(m_):
        params = jax.device_put(params, ps)
        opt_state = jax.device_put(opt_state, os_)
        bt = jax.device_put(batch, bs)
        jitted = jax.jit(step, in_shardings=(ps, os_, bs,
                                             NamedSharding(m_, P())),
                         out_shardings=(ps, os_, None))
        for t in range(STEPS):
            key = jax.random.fold_in(jax.random.PRNGKey(3), t)
            if c["noise_var"] > 0:
                z = schemes.add_channel_noise(zeros, key, c["noise_var"])
                res[f"{name}/noise{t}"] = np.concatenate(
                    [np.asarray(l).ravel()
                     for l in jax.tree_util.tree_leaves(z)])
            params, opt_state, m = jitted(params, opt_state, bt, key)
            for k, v in m.items():
                res[f"{name}/m{t}/{k}"] = np.asarray(v)
    for i, l in enumerate(jax.tree_util.tree_leaves(params)):
        res[f"{name}/p/{i:05d}"] = np.asarray(l)
np.savez(sys.argv[1], **res)
print("REF_TP_TRAIN_OK")
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's cases on its (4, 2) and (2, 2, 1) meshes, from one
    subprocess."""
    tmp = tmp_path_factory.mktemp("ref_tp_train")
    script = tmp / "ref_tp_train.py"
    script.write_text(REFERENCE_SCRIPT)
    arg = repr((CASES, H.tolist(), B.tolist(), STEPS, ARCH))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(script), str(tmp / "ref.npz"),
                        arg], capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=600)
    assert "REF_TP_TRAIN_OK" in r.stdout, r.stderr[-4000:]
    return dict(np.load(tmp / "ref.npz"))


@pytest.mark.parametrize("name", list(CASES))
def test_tp_train_step_matches_reference(reference, name):
    cfg, c = _cfg(), CASES[name]
    like = T.init_params(cfg, torch.Generator(), device="cpu")
    n = len(tree_leaves(like))
    p0 = tree_unflatten(like, {f"{i:05d}": torch.from_numpy(
        reference[f"p0/{i:05d}"]) for i in range(n)})
    batch = {"tokens": torch.from_numpy(reference["tokens"]),
             "labels": torch.from_numpy(reference["labels"]),
             "loss_mask": torch.from_numpy(reference["mask"])}
    o = opt.sgd(opt.inverse_power_schedule(0.75, eta0=0.05)
                if c["schedule"] else 0.05)
    ota = None
    mesh, axes, k = ((make_host_mesh(2, 1, pod=2), ("pod",), 2)
                     if c.get("pod") else (make_host_mesh(4, 2), ("data",), 4))
    if c["scheme"] != "mean":
        ota = tl.OTARunParams(h=H[:k], b=B[:k], a=c["a"],
                              noise_var=c["noise_var"])
    step, place = tl.build_train_step(
        cfg, mesh, scheme=c["scheme"],
        aggregation_axes=None if ota is None else axes, ota=ota,
        optimizer=o, device="cpu")
    params, opt_state, rows = place(p0, o.init(p0), batch)
    for t in range(STEPS):
        kw = {}
        if c["noise_var"] > 0:
            kw["noise"] = torch.from_numpy(reference[f"{name}/noise{t}"])
        params, opt_state, m = step(params, opt_state, rows, **kw)
        want_keys = {k.split("/")[-1] for k in reference
                     if k.startswith(f"{name}/m{t}/")}
        assert set(m) == want_keys
        for k, v in m.items():
            want = float(reference[f"{name}/m{t}/{k}"])
            assert abs(float(v) - want) <= METRIC_REL * abs(want), (t, k)
    full = SH.gather_params(params, mesh, cfg, p0)
    for i, l in enumerate(tree_leaves(full)):
        want = reference[f"{name}/p/{i:05d}"]
        moved = np.abs(want - reference[f"p0/{i:05d}"]).max()
        assert np.abs(l.numpy() - want).max() <= PARAM_REL * moved, i
    # every rank's shard is its piece of the gathered tree; the replicated
    # leaves are the same bits on every rank
    for r, shard in enumerate(params):
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(shard),
            tree_leaves(SH.shard_params(full, mesh, r, cfg))))


# ---------------------------------------------------------------------------
# the pod axis: a (pod 2, data 2, model 1) mesh against the (4, 1) mesh it
# flattens to (rank (p * 2 + d) is rank p * 2 + d of the (4, 1) mesh)

POD_CASES = {
    # four clients, one a (p, d): the (4, 1) mesh's clients over data
    "pod_data": dict(scheme="normalized", axes=("pod", "data"), fsdp=None,
                     flat_axes=("data",), flat_fsdp=None),
    # the mean path with FSDP over (pod, data): the (4, 1) mesh's over data
    "fsdp": dict(scheme="mean", axes=None, fsdp=("pod", "data"),
                 flat_axes=None, flat_fsdp="data"),
}


def _pod_run(mesh, scheme, axes, fsdp, steps=2):
    cfg = _cfg()
    p0 = _params(cfg)
    o = opt.adamw(0.01)
    ota = (tl.OTARunParams(h=H, b=B, a=250.0, noise_var=1e-7)
           if axes else None)
    step, place = tl.build_train_step(
        cfg, mesh, scheme=scheme, aggregation_axes=axes, fsdp_axis=fsdp,
        ota=ota, optimizer=o, device="cpu")
    params, state, rows = place(p0, o.init(p0), _batch(cfg, 8, 32, 4))
    metrics = []
    for t in range(steps):
        params, state, m = step(params, state, rows, 7 + t)
        metrics.append(m)
    return cfg, p0, params, state, metrics


@pytest.mark.parametrize("case", list(POD_CASES))
def test_pod_mesh_is_the_flattened_mesh_bitwise(case):
    """Two AdamW steps of reduced granite: every rank's params, optimizer
    state and the metrics are the bits of the (4, 1) mesh's rank; under
    FSDP over (pod, data) the whole params are also the plain mean step's
    (no FSDP) bits."""
    c = POD_CASES[case]
    pod = make_host_mesh(2, 1, pod=2)
    cfg, p0, params, state, ms = _pod_run(pod, c["scheme"], c["axes"],
                                          c["fsdp"])
    _, _, fparams, fstate, fms = _pod_run(make_host_mesh(4, 1), c["scheme"],
                                          c["flat_axes"], c["flat_fsdp"])
    for r in range(4):
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(params[r]), tree_leaves(fparams[r]))), r
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(tuple(state[r])), tree_leaves(tuple(fstate[r])))), r
    for m, fm in zip(ms, fms):
        assert set(m) == set(fm)
        assert all(torch.equal(m[k], fm[k]) for k in m)
    if c["fsdp"]:
        _, _, plain, _, pms = _pod_run(pod, "mean", None, None)
        whole = SH.gather_params(params, pod, cfg, p0, fsdp_axis=c["fsdp"])
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(whole), tree_leaves(SH.gather_params(plain, pod, cfg,
                                                             p0))))
        assert all(torch.equal(ms[-1][k], pms[-1][k]) for k in pms[-1])


# ---------------------------------------------------------------------------
# the reference's mesh tests, on the port


def test_ota_train_step_loss_decreases_on_mesh():
    """``tests/test_distribution.py::test_ota_train_step_loss_decreases_
    on_mesh``: reduced granite (bf16, as there), 4 FL clients each cut over
    2 model ranks, ``normalized`` with noise, six steps."""
    cfg = reg.reduce_config(reg.get_config(ARCH))
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    o = opt.sgd(0.05)
    ota = tl.OTARunParams(h=np.full(4, 1e-3), b=np.ones(4), a=250.0,
                          noise_var=1e-7)
    step, place = tl.build_train_step(
        cfg, make_host_mesh(4, 2), scheme="normalized",
        aggregation_axes=("data",), ota=ota, optimizer=o, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (8, 64),
                           generator=torch.Generator().manual_seed(2))
    params, opt_state, _ = place(params, o.init(params))
    losses = []
    for i in range(6):     # a whole batch dict: the step cuts its rows
        params, opt_state, m = step(params, opt_state,
                                    {"tokens": tokens, "labels": tokens},
                                    3 + i)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.2, losses


def test_seq_parallel_is_numerically_transparent():
    """``tests/test_distribution.py::test_seq_parallel_is_numerically_
    transparent``: ``seq_shard_activations`` (a placement hint) and the
    ``dots`` remat policy give the base run's losses on a (4, 2) mesh,
    reduced qwen2 at fp32, three steps; in the port to the bit."""
    tokens = torch.randint(0, 512, (8, 64),
                           generator=torch.Generator().manual_seed(2))
    losses = {}
    for variant, ov in (("base", {}),
                        ("seqpar", {"seq_shard_activations": "model"}),
                        ("dots", {"seq_shard_activations": "model",
                                  "remat_policy": "dots"})):
        cfg = _cfg("qwen2-7b", **ov)
        params = _params(cfg)
        o = opt.sgd(0.05)
        ota = tl.OTARunParams(h=np.full(4, 1e-3), b=np.ones(4), a=250.0,
                              noise_var=0.0)
        step, place = tl.build_train_step(
            cfg, make_host_mesh(4, 2), scheme="normalized",
            aggregation_axes=("data",), ota=ota, optimizer=o, device="cpu")
        p, s, rows = place(params, o.init(params),
                           {"tokens": tokens, "labels": tokens})
        ls = []
        for i in range(3):
            p, s, m = step(p, s, rows, 3 + i)
            ls.append(float(m["loss"]))
        losses[variant] = ls
    assert losses["seqpar"] == losses["base"] == losses["dots"], losses
    assert losses["base"][-1] < losses["base"][0]


def test_fsdp_raises_naming_its_item():
    """FSDP runs on the mean path (``tests/test_torch_fsdp.py``); with an
    OTA scheme it raises (the reference's plans never pair them), and over
    ('pod', 'data') it needs a mesh with a pod axis."""
    cfg = _cfg()
    ota = tl.OTARunParams(h=np.ones(2), b=np.ones(2))
    with pytest.raises(NotImplementedError, match="never pair"):
        tl.build_train_step(cfg, make_host_mesh(2, 2), fsdp_axis="data",
                            scheme="normalized", aggregation_axes=("data",),
                            ota=ota, device="cpu")
    with pytest.raises(ValueError, match="on a mesh with a pod axis"):
        tl.build_train_step(cfg, make_host_mesh(2, 2),
                            fsdp_axis=("pod", "data"), scheme="mean",
                            device="cpu")


# ---------------------------------------------------------------------------
# physical ranks (gloo) against the emulated mesh


RANKS_SCRIPT = r'''
import os
import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RANKS = 4


def run(mesh, scheme, steps=2, fsdp=None, axes=("data",)):
    import dataclasses
    import numpy as np
    from repro_torch.configs import registry as reg
    from repro_torch.launch import train as tl
    from repro_torch.models import transformer as T
    from repro_torch.optim import optimizers as opt
    cfg = dataclasses.replace(reg.reduce_config(
        reg.get_config("jamba-v0.1-52b")), dtype="float32", num_layers=2)
    p = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    o = opt.adamw(opt.cosine_schedule(0.01, 1, 4))
    ota = None
    if scheme != "mean":
        ota = tl.OTARunParams(h=np.array([1e-3, 2e-3]), b=np.ones(2),
                              a=250.0, noise_var=1e-7)
    step, place = tl.build_train_step(
        cfg, mesh, scheme=scheme,
        aggregation_axes=None if ota is None else axes, ota=ota,
        fsdp_axis=fsdp, optimizer=o, device="cpu")
    g = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (4, 16), generator=g)
    mask = (torch.rand((4, 16), generator=g) > 0.3).float()
    params, state, rows = place(p, o.init(p), {
        "tokens": toks, "labels": toks.roll(-1, 1), "loss_mask": mask})
    out = []
    for t in range(steps):
        params, state, m = step(params, state, rows, 11 + t)
        out.append({k: v.clone() for k, v in m.items()})
    return {"params": params, "state": state, "metrics": out}


def zoo(mesh):
    """Reduced xlstm and seamless: the encoder's output, a prefill and 4
    greedy steps (ids and this rank's cache), then one mean step."""
    import dataclasses
    from repro_torch.configs import registry as reg
    from repro_torch.launch import serve
    from repro_torch.launch import train as tl
    from repro_torch.models import transformer as T
    from repro_torch.optim import optimizers as opt
    out = {}
    for arch in ("xlstm-1.3b", "seamless-m4t-medium"):
        cfg = dataclasses.replace(reg.reduce_config(reg.get_config(arch)),
                                  dtype="float32")
        p = T.init_params(cfg, torch.Generator().manual_seed(1),
                          device="cpu")
        g = torch.Generator().manual_seed(6)
        toks = torch.randint(0, cfg.vocab_size, (4, 16), generator=g)
        batch = {"tokens": toks}
        if cfg.is_encoder_decoder:
            batch["src_embeds"] = torch.randn((4, 8, cfg.modal_embed_dim),
                                              generator=g)
        pre, place = serve.build_prefill_cache_step(cfg, "cpu", cache_len=20,
                                                    mesh=mesh)
        dec, _ = serve.build_decode_step(cfg, "cpu", mesh=mesh)
        enc, _ = serve.build_encode_step(cfg, "cpu", mesh=mesh)
        params = place(p)[0]
        enc_out = enc(params, batch) if cfg.is_encoder_decoder else None
        ids, cache = pre(params, batch)
        got = [ids]
        for pos in range(16, 20):
            ids, cache = dec(params, cache, ids[:, None], pos,
                             enc_out=enc_out)
            got.append(ids)
        o = opt.adamw(0.01)
        step, tplace = tl.build_train_step(cfg, mesh, scheme="mean",
                                           optimizer=o, device="cpu")
        tp_, ts, rows = tplace(p, o.init(p), dict(
            batch, labels=toks.roll(-1, 1)))
        tp_, ts, m = step(tp_, ts, rows)
        out[arch] = {"ids": torch.stack(got, 1), "cache": cache,
                     "enc_out": enc_out, "params": tp_, "state": ts,
                     "metrics": m}
    return out


def worker(rank, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=RANKS, rank=rank)
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(2, 2)
    assert mesh.physical and mesh.rank == rank
    res = {s: run(mesh, s) for s in ("normalized", "mean")}
    res["fsdp"] = run(mesh, "mean", fsdp="data")
    res["pod"] = run(make_host_mesh(2, 1, pod=2), "normalized",
                     axes=("pod",))
    res["zoo"] = zoo(mesh)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    out_dir = sys.argv[1]
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    mp.spawn(worker, args=(port, out_dir), nprocs=RANKS)
    print("RANKS_OK")
'''


@pytest.fixture(scope="module")
def physical(tmp_path_factory):
    """Every rank's run, from one subprocess of four ``gloo`` ranks."""
    tmp = tmp_path_factory.mktemp("tp_train_ranks")
    script = tmp / "ranks.py"
    script.write_text(textwrap.dedent(RANKS_SCRIPT))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               MASTER_ADDR="127.0.0.1", OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(script), str(tmp)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=600)
    assert r.returncode == 0 and "RANKS_OK" in r.stdout, r.stderr[-4000:]
    namespace = {}
    exec(compile(RANKS_SCRIPT.split("def worker")[0], "ranks", "exec"),
         namespace)
    return ([torch.load(tmp / f"rank{i}.pt", weights_only=False)
             for i in range(4)], namespace)


def _flat(tree):
    import torch.utils._pytree as pytree
    return pytree.tree_leaves(tree)


@pytest.mark.parametrize("scheme", ["normalized", "mean", "fsdp", "pod"])
def test_physical_ranks_are_the_emulated_mesh_bitwise(physical, scheme):
    """Each gloo rank of a physical (2, 2) mesh (reduced jamba: its
    attention, Mamba, dense MLP, experts and vocabulary cut over the model
    axis; ``fsdp``: the mean path with the FSDP rules' leaves also cut over
    ``data``; ``pod``: a (2, 2, 1) mesh, a client a pod) ends with the bits
    of the emulated mesh's rank after two AdamW steps: params, optimizer
    state and metrics."""
    ranks, ns = physical
    want = (ns["run"](make_host_mesh(2, 2), "mean", fsdp="data")
            if scheme == "fsdp" else
            ns["run"](make_host_mesh(2, 1, pod=2), "normalized",
                      axes=("pod",)) if scheme == "pod" else
            ns["run"](make_host_mesh(2, 2), scheme))
    for r, res in enumerate(ranks):
        got = res[scheme]
        for a, b in zip(_flat(got["params"][0]), _flat(want["params"][r])):
            assert torch.equal(a, b), r
        for a, b in zip(_flat(got["state"][0]), _flat(want["state"][r])):
            assert torch.equal(a, b), r
    for t, m in enumerate(ranks[0][scheme]["metrics"]):
        assert all(torch.equal(m[k], want["metrics"][t][k]) for k in m)


@pytest.fixture(scope="module")
def emulated_zoo(physical):
    """The zoo's runs on the emulated mesh, on one thread as the ranks."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return physical[1]["zoo"](make_host_mesh(2, 2))
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "seamless-m4t-medium"])
def test_physical_zoo_is_the_emulated_mesh_bitwise(physical, emulated_zoo,
                                                   arch):
    """Each gloo rank of a physical (2, 2) mesh serving reduced xlstm
    (mLSTM heads and sLSTM features cut) and seamless (encoder and decoder
    cut) holds the emulated mesh's ids, encoder output and cache shard, and
    after one mean step its params, optimizer state and metrics, bitwise."""
    ranks, _ = physical
    want = emulated_zoo[arch]
    for r, res in enumerate(ranks):
        got = res["zoo"][arch]
        assert torch.equal(got["ids"], want["ids"])
        if want["enc_out"] is not None:
            assert torch.equal(got["enc_out"], want["enc_out"])
        for key in ("cache", "params", "state"):
            for a, b in zip(_flat(got[key][0]), _flat(want[key][r])):
                assert torch.equal(a, b), (r, key)
        assert all(torch.equal(got["metrics"][k], want["metrics"][k])
                   for k in want["metrics"])
