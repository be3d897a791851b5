"""The port's train step (``repro_torch.launch.train``) against the JAX
package's, on the CPU:

* the reference's ``build_train_step`` on a ``(4, 1)`` forced-host mesh,
  run once in a subprocess for three cases of reduced granite-moe-1b-a400m
  at fp32: ``normalized`` with channel noise under the inverse-power
  schedule, ``benchmark2`` (a scheme with a server post-transform and side
  information) and ``mean`` with loss masks whose counts differ between
  the data ranks; the reference's noise is taken out with
  ``schemes.add_channel_noise`` on a zero tree and injected into the port.
  Three steps; every metric and the final params match, and the emulated
  ranks end with the same bits;
* the port's counterpart of ``tests/test_distribution.py::
  test_ota_train_step_loss_decreases_on_mesh``;
* four ``gloo`` ranks (one subprocess, the physical mesh) bitwise the
  emulated mesh, on the OTA and the mean path;
* the schedules and the tree ``sgd``/``adamw`` against the reference's,
  ``token_stream``, ``make_batch_from_specs`` (``tests/test_configs.py::
  TestMakeBatchFromSpecs``), ``instrument_train_step``, the host noise draw,
  and what raises.

torch runs on one thread in this file and in the ranks.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import datasets as jdata
from repro.models import transformer as JT
from repro.optim import optimizers as jopt
from repro_torch.configs import registry as reg
from repro_torch.configs.base import InputShape
from repro_torch.core import schemes
from repro_torch.data.datasets import token_stream
from repro_torch.launch import train as tl
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.obs.recorders import MemoryRecorder
from repro_torch.optim import optimizers as opt
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "granite-moe-1b-a400m"
# fp32, three steps: the metrics within METRIC_REL of the reference's
# (measured 1.5e-7), every final parameter within PARAM_REL of its
# leaf's largest change over the three steps (measured 7.5e-5, benchmark2:
# the sums of other orders compound through steps that halve the loss)
METRIC_REL = 1e-6
PARAM_REL = 3e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the reference's train step on a (4, 1) forced-host mesh


CASES = {
    "normalized": dict(scheme="normalized", a=250.0, noise_var=1e-7,
                       schedule=True),
    "benchmark2": dict(scheme="benchmark2", a=None, noise_var=0.0,
                       schedule=False),
    "mean": dict(scheme="mean", a=None, noise_var=0.0, schedule=False),
}
H = np.array([1e-3, 2e-3, 1.5e-3, 0.5e-3])
B = np.array([1.0, 0.8, 1.2, 0.9])
STEPS = 3

REFERENCE_SCRIPT = r'''
import os
import sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
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
mesh = make_host_mesh(4, 1)
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
    if c["scheme"] != "mean":
        a = c["a"] if c["a"] is not None else 1.0 / float(np.sum(H * B))
        ota = tl.OTARunParams(h=H, b=B, a=a, noise_var=c["noise_var"])
    step, in_sh = tl.build_train_step(
        cfg, mesh, scheme=c["scheme"],
        aggregation_axes=None if ota is None else ("data",), ota=ota,
        optimizer=o)
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
print("REF_TRAIN_OK")
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's three cases, from one subprocess."""
    tmp = tmp_path_factory.mktemp("ref_train")
    script = tmp / "ref_train.py"
    script.write_text(REFERENCE_SCRIPT)
    arg = repr((CASES, H.tolist(), B.tolist(), STEPS, ARCH))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(script), str(tmp / "ref.npz"),
                        arg], capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=600)
    assert "REF_TRAIN_OK" in r.stdout, r.stderr[-4000:]
    return dict(np.load(tmp / "ref.npz"))


def _cfg():
    return dataclasses.replace(reg.reduce_config(reg.get_config(ARCH)),
                               dtype="float32")


def _port_case(name, ref, mesh):
    """The port's run of one case from the reference's params and batch:
    (per-step metrics, per-rank final params)."""
    cfg, c = _cfg(), CASES[name]
    like = T.init_params(cfg, torch.Generator(), device="cpu")
    n = len(tree_leaves(like))
    p0 = tree_unflatten(like, {f"{i:05d}": torch.from_numpy(
        ref[f"p0/{i:05d}"]) for i in range(n)})
    batch = {"tokens": torch.from_numpy(ref["tokens"]),
             "labels": torch.from_numpy(ref["labels"]),
             "loss_mask": torch.from_numpy(ref["mask"])}
    o = opt.sgd(opt.inverse_power_schedule(0.75, eta0=0.05)
                if c["schedule"] else 0.05)
    ota = None
    if c["scheme"] != "mean":
        a = c["a"] if c["a"] is not None else 1.0 / float(np.sum(H * B))
        ota = tl.OTARunParams(h=H, b=B, a=a, noise_var=c["noise_var"])
    step, place = tl.build_train_step(
        cfg, mesh, scheme=c["scheme"],
        aggregation_axes=None if ota is None else ("data",), ota=ota,
        optimizer=o, device="cpu")
    params, opt_state, rows = place(p0, o.init(p0), batch)
    metrics = []
    for t in range(STEPS):
        kw = {}
        if c["noise_var"] > 0:
            kw["noise"] = torch.from_numpy(ref[f"{name}/noise{t}"])
        params, opt_state, m = step(params, opt_state, rows, **kw)
        metrics.append(m)
    return metrics, params


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_matches_reference(reference, name):
    metrics, params = _port_case(name, reference, make_host_mesh(4, 1))
    for t, m in enumerate(metrics):
        want_keys = {k.split("/")[-1] for k in reference
                     if k.startswith(f"{name}/m{t}/")}
        assert set(m) == want_keys
        for k, v in m.items():
            want = float(reference[f"{name}/m{t}/{k}"])
            assert abs(float(v) - want) <= METRIC_REL * abs(want), (t, k)
    leaves = tree_leaves(params[0])
    for i, l in enumerate(leaves):
        want = reference[f"{name}/p/{i:05d}"]
        moved = np.abs(want - reference[f"p0/{i:05d}"]).max()
        assert np.abs(l.numpy() - want).max() <= PARAM_REL * moved, i
    for other in params[1:]:
        assert all(torch.equal(a, b)
                   for a, b in zip(tree_leaves(other), leaves))


def test_ota_train_step_loss_decreases():
    """``tests/test_distribution.py::test_ota_train_step_loss_decreases_
    on_mesh`` on the port: reduced granite (bf16, as there), 4 FL clients
    on an emulated (4, 1) mesh (the reference's (4, 2) cuts the model
    too), ``normalized`` with noise, six steps."""
    cfg = reg.reduce_config(reg.get_config(ARCH))
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    o = opt.sgd(0.05)
    ota = tl.OTARunParams(h=np.full(4, 1e-3), b=np.ones(4), a=250.0,
                          noise_var=1e-7)
    step, place = tl.build_train_step(
        cfg, make_host_mesh(4, 1), scheme="normalized",
        aggregation_axes=("data",), ota=ota, optimizer=o, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (8, 64),
                           generator=torch.Generator().manual_seed(2))
    params, opt_state, rows = place(params, o.init(params),
                                    {"tokens": tokens, "labels": tokens})
    losses = []
    for i in range(6):
        params, opt_state, m = step(params, opt_state, rows, 3 + i)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.2, losses


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


def run(mesh, scheme, steps=2):
    import dataclasses
    import numpy as np
    from repro_torch.configs import registry as reg
    from repro_torch.launch import train as tl
    from repro_torch.models import transformer as T
    from repro_torch.optim import optimizers as opt
    cfg = dataclasses.replace(reg.reduce_config(
        reg.get_config("granite-moe-1b-a400m")), dtype="float32")
    p = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    o = opt.adamw(opt.cosine_schedule(0.01, 1, 4))
    ota = None
    if scheme != "mean":
        ota = tl.OTARunParams(h=np.array([1e-3, 2e-3, 1.5e-3, 0.5e-3]),
                              b=np.ones(4), a=250.0, noise_var=1e-7)
    step, place = tl.build_train_step(
        cfg, mesh, scheme=scheme,
        aggregation_axes=None if ota is None else ("data",), ota=ota,
        optimizer=o, device="cpu")
    g = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (8, 16), generator=g)
    mask = (torch.rand((8, 16), generator=g) > 0.3).float()
    params, state, rows = place(p, o.init(p), {
        "tokens": toks, "labels": toks.roll(-1, 1), "loss_mask": mask})
    out = []
    for t in range(steps):
        params, state, m = step(params, state, rows, 11 + t)
        out.append({k: v.clone() for k, v in m.items()})
    return {"params": params, "state": state, "metrics": out}


def worker(rank, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=RANKS, rank=rank)
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(4, 1)
    assert mesh.physical and mesh.rank == rank
    res = {s: run(mesh, s) for s in ("normalized", "mean")}
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
    tmp = tmp_path_factory.mktemp("train_ranks")
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


@pytest.mark.parametrize("scheme", ["normalized", "mean"])
def test_physical_ranks_are_the_emulated_mesh_bitwise(physical, scheme):
    """Each gloo rank's params, AdamW state and metrics after two steps
    are the bits of the emulated mesh's rank (its metrics: rank 0's)."""
    ranks, ns = physical
    want = ns["run"](make_host_mesh(4, 1), scheme)
    for r, res in enumerate(ranks):
        got = res[scheme]
        for a, b in zip(_flat(got["params"][0]), _flat(want["params"][r])):
            assert torch.equal(a, b), r
        for a, b in zip(_flat(got["state"][0]), _flat(want["state"][r])):
            assert torch.equal(a, b), r
    for t, m in enumerate(ranks[0][scheme]["metrics"]):
        assert all(torch.equal(m[k], want["metrics"][t][k]) for k in m)


# ---------------------------------------------------------------------------
# the pieces


def test_schedules_match_reference():
    steps = np.arange(0, 40, dtype=np.int32)
    pairs = [(opt.inverse_power_schedule(0.75, eta0=0.5),
              jopt.inverse_power_schedule(0.75, eta0=0.5)),
             (opt.constant_schedule(0.03), jopt.constant_schedule(0.03)),
             (opt.cosine_schedule(0.1, 5, 30, floor=0.01),
              jopt.cosine_schedule(0.1, 5, 30, floor=0.01))]
    for mine, ref in pairs:
        got = np.array([float(mine(torch.tensor(s))) for s in steps])
        want = np.array([float(ref(jnp.asarray(s))) for s in steps])
        np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(ValueError, match="p must lie"):
        opt.inverse_power_schedule(1.0)


# adamw's first step on the reference's gradients: where the port's update
# differs by more than ADAMW_GAP of its leaf's largest change, the
# reference's gradient is within NEAR_ZERO of the leaf's largest gradient
# (measured: gaps up to 0.126 of a leaf's change, all on gradients at most
# 4.5e-6 of the leaf's largest, 7e-8 absolute: a few times adamw's eps)
ADAMW_GAP = 1e-2
NEAR_ZERO = 1e-4


def test_adamw_gap_sits_on_near_zero_gradients():
    """The explanation of the adamw gap (ROADMAP queue 3): one step of
    reduced granite at fp32, no mesh.  The two packages' gradients agree
    within the sgd bounds (the loss within METRIC_REL, every gradient leaf
    within PARAM_REL of its largest entry: measured 7e-8 and 1.7e-6); the
    first adamw step, ``g / (|g| + eps)``, turns the rounding of a near-zero
    gradient into a step of the full rate, so its gap sits on those
    elements only."""
    jcfg = dataclasses.replace(jreg.reduce_config(jreg.get_config(ARCH)),
                               dtype="float32")
    cfg = _cfg()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    mask = (rng.random((8, 32)) > 0.2).astype(np.float32)
    jloss, jg = jax.jit(jax.value_and_grad(lambda p: JT.forward_loss(
        p, jcfg, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
                  "loss_mask": jnp.asarray(mask)})[0]))(jp)
    jo = jopt.adamw(0.01)
    jnew, _ = jo.update(jg, jo.init(jp), jp)
    p0 = [np.asarray(l) for l in jax.tree_util.tree_leaves(jp)]
    like = T.init_params(cfg, torch.Generator(), device="cpu")
    params = tree_unflatten(like, {f"{i:05d}": torch.from_numpy(l.copy())
                                   for i, l in enumerate(p0)})
    loss, _, grads = tl._value_and_grad(lambda q: T.forward_loss(q, cfg, {
        "tokens": torch.from_numpy(toks).long(),
        "labels": torch.from_numpy(labels).long(),
        "loss_mask": torch.from_numpy(mask)}), params)
    assert abs(float(loss) - float(jloss)) <= METRIC_REL * abs(float(jloss))
    o = opt.adamw(0.01)
    new, _ = o.update(tree_unflatten(params, {f"{i:05d}": g for i, g in
                                              enumerate(grads)}),
                      o.init(params), params)
    for i, (g, jgl, n, jn, l0) in enumerate(zip(
            grads, jax.tree_util.tree_leaves(jg), tree_leaves(new),
            jax.tree_util.tree_leaves(jnew), p0)):
        jgl = np.asarray(jgl)
        gmax = np.abs(jgl).max()
        assert np.abs(g.numpy() - jgl).max() <= PARAM_REL * gmax, i
        want = np.asarray(jn) - l0
        gap = np.abs((n.numpy() - l0) - want) / np.abs(want).max()
        off = gap > ADAMW_GAP
        assert np.all(np.abs(jgl[off]) <= NEAR_ZERO * gmax), i


@pytest.mark.parametrize("kind", ["sgd", "momentum", "adamw"])
def test_tree_optimizers_match_reference(kind):
    """A nested tree of dicts and tuples, a schedule and three steps of
    changing gradients; against the reference (fp32)."""
    rng = np.random.default_rng(0)
    tree = {"emb": {"tok": rng.standard_normal((4, 3))},
            "blocks": ({"w": rng.standard_normal((2, 3, 3)),
                        "b": rng.standard_normal((2, 3))},),
            "final": rng.standard_normal(3)}
    tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)
    sched = (opt.inverse_power_schedule(0.6, 0.2),
             jopt.inverse_power_schedule(0.6, 0.2))
    make = {"sgd": (opt.sgd(sched[0]), jopt.sgd(sched[1])),
            "momentum": (opt.sgd(sched[0], momentum=0.9),
                         jopt.sgd(sched[1], momentum=0.9)),
            "adamw": (opt.adamw(sched[0], weight_decay=0.01),
                      jopt.adamw(sched[1], weight_decay=0.01))}[kind]
    mine, ref = make
    p = tree_map(torch.from_numpy, tree)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    s, js = mine.init(p), ref.init(jp)
    for t in range(3):
        g = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
        p, s = mine.update(tree_map(torch.from_numpy, g), s, p)
        jp, js = ref.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
    assert int(s.step) == 3
    for a, b in zip(tree_leaves(p), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    assert isinstance(p["blocks"], tuple)


def test_float_rate_and_call_rate_keep_their_bits():
    """A float rate multiplies as a python float, and a per-call ``lr``
    tensor (the FL runtime's eta_t) replaces it: the same bits as the
    explicit products."""
    p = {"w": torch.randn(5, generator=torch.Generator().manual_seed(1))}
    g = {"w": torch.randn(5, generator=torch.Generator().manual_seed(2))}
    o = opt.sgd(0.1)
    new, _ = o.update(g, o.init(p), p)
    assert torch.equal(new["w"], p["w"] - 0.1 * g["w"])
    eta = torch.tensor(0.37)
    new, _ = opt.sgd(0.0).update(g, o.init(p), p, lr=eta)
    assert torch.equal(new["w"], p["w"] - eta * g["w"])


def test_token_stream():
    """``tests/test_substrate.py::test_token_stream_in_vocab``, and the
    steps between neighbours in [0, 17) mod vocab."""
    toks = token_stream(torch.Generator().manual_seed(0), 4, 128, vocab=97)
    assert toks.shape == (4, 128) and toks.dtype == torch.int32
    assert int(toks.min()) >= 0 and int(toks.max()) < 97
    steps = torch.remainder(toks[:, 1:] - toks[:, :-1], 97)
    assert int(steps.max()) < 17
    again = token_stream(torch.Generator().manual_seed(0), 4, 128, vocab=97)
    assert torch.equal(toks, again)
    ref = np.asarray(jdata.token_stream(jax.random.PRNGKey(0), 4, 128, 97))
    assert ref.shape == tuple(toks.shape) and ref.dtype == np.int32


class TestMakeBatchFromSpecs:
    """``tests/test_configs.py::TestMakeBatchFromSpecs`` on the port."""

    def _inputs(self):
        cfg = reg.reduce_config(reg.get_config("qwen2-7b"))
        shape = InputShape("smoke_train", 64, 2, "train")
        return cfg, reg.make_dummy_inputs(cfg, shape, device="cpu")

    def test_specs_match_reference(self):
        from repro.configs import registry as jreg
        from repro.configs.base import InputShape as JShape
        for arch in ("qwen2-7b", "pixtral-12b", "seamless-m4t-medium"):
            for kind in ("train", "prefill", "decode"):
                mine = reg.input_specs(
                    reg.reduce_config(reg.get_config(arch)),
                    InputShape("s", 64, 2, kind))
                ref = jreg.input_specs(
                    jreg.reduce_config(jreg.get_config(arch)),
                    JShape("s", 64, 2, kind))
                assert set(mine) == set(ref)
                for k in ref:
                    assert tuple(mine[k].shape) == tuple(ref[k].shape)
                    assert str(mine[k].dtype).split(".")[-1] == \
                        str(ref[k].dtype)

    def test_labels_passthrough_when_present(self):
        cfg, inputs = self._inputs()
        batch = tl.make_batch_from_specs(inputs, cfg)
        assert batch["labels"] is inputs["labels"]
        assert "loss_mask" not in batch

    def test_labels_default_to_shifted_tokens(self):
        cfg, inputs = self._inputs()
        del inputs["labels"]
        batch = tl.make_batch_from_specs(inputs, cfg)
        toks, labels = batch["tokens"].numpy(), batch["labels"].numpy()
        mask = batch["loss_mask"].numpy()
        np.testing.assert_array_equal(labels[:, :-1], toks[:, 1:])
        np.testing.assert_array_equal(mask[:, -1], 0.0)
        np.testing.assert_array_equal(mask[:, :-1], 1.0)
        prior = torch.zeros_like(batch["loss_mask"])
        prior[0] = 1.0
        again = tl.make_batch_from_specs(
            dict(inputs, loss_mask=prior), cfg)["loss_mask"]
        assert float(again[1].sum()) == 0.0 and float(again[0, -1]) == 0.0

    def test_default_batch_is_loss_ready(self):
        cfg, inputs = self._inputs()
        del inputs["labels"]
        params = T.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        batch = tl.make_batch_from_specs(inputs, cfg)
        with torch.no_grad():
            loss, _ = T.forward_loss(params, cfg, batch)
            explicit = dict(batch, labels=torch.cat(
                [batch["tokens"][:, 1:], batch["tokens"][:, :1]], dim=1))
            loss2, _ = T.forward_loss(params, cfg, explicit)
        assert bool(torch.isfinite(loss))
        assert float(loss) == pytest.approx(float(loss2), rel=1e-6)


def _small_step(mesh, recorder=None):
    cfg = dataclasses.replace(reg.reduce_config(reg.get_config(ARCH)),
                              dtype="float32", num_layers=1)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    o = opt.sgd(0.05)
    step, place = tl.build_train_step(
        cfg, mesh, scheme="normalized", aggregation_axes=("data",),
        ota=tl.OTARunParams(h=np.full(2, 1e-3), b=np.ones(2), a=500.0,
                            noise_var=1e-7), optimizer=o, device="cpu")
    if recorder is not None:
        step = tl.instrument_train_step(step, recorder,
                                        manifest={"run": "train"})
    toks = torch.randint(0, cfg.vocab_size, (4, 16),
                         generator=torch.Generator().manual_seed(1))
    params, state, rows = place(params, o.init(params),
                                {"tokens": toks, "labels": toks})
    for t in range(3):
        params, state, m = step(params, state, rows, t)
    return params, m


def test_instrument_train_step_same_bits_one_event_a_step():
    mesh = make_host_mesh(2, 1)
    rec = MemoryRecorder()
    got, gm = _small_step(mesh, rec)
    want, wm = _small_step(mesh)
    assert all(torch.equal(a, b) for a, b in zip(_flat(got), _flat(want)))
    assert all(torch.equal(gm[k], wm[k]) for k in wm)
    rounds = rec.of("round") if hasattr(rec, "of") else [
        e for e in rec.events if e.get("event") == "round"]
    assert [e["round"] for e in rounds] == [0, 1, 2]
    assert [e["event"] for e in rec.events].count("manifest") == 1
    assert rounds[-1]["loss"] == pytest.approx(float(wm["loss"]))


def test_draw_noise_is_the_schemes_draw():
    """The step's host draw is ``schemes.add_channel_noise`` of a zero tree
    of the flattened leaves, bitwise (one draw a leaf, in leaf order)."""
    cfg = dataclasses.replace(reg.reduce_config(reg.get_config(ARCH)),
                              num_layers=1)
    like = T.init_params(cfg, torch.Generator(), device="cpu")
    z = tl.draw_noise(torch.Generator().manual_seed(9), like, 1e-3, "cpu")
    flat = tree_flatten(like)
    want = schemes.add_channel_noise(
        {k: torch.zeros(v.shape) for k, v in flat.items()},
        torch.Generator().manual_seed(9), 1e-3)
    assert torch.equal(z, torch.cat([want[k].reshape(-1)
                                     for k in sorted(want)]))
    assert tree_unflatten(like, flat)["emb"]["tok"] is like["emb"]["tok"]


def test_unported_training_raises():
    """FSDP with an OTA scheme (the reference's plans never pair them) and
    over ('pod', 'data') on a mesh without a pod axis raise; so do the
    other aggregation axes and an OTA scheme without its parameters.  (A
    cut model trains: ``tests/test_torch_tp_train.py``; FSDP on the mean
    path: ``tests/test_torch_fsdp.py``.)"""
    cfg = reg.reduce_config(reg.get_config(ARCH))
    ota = tl.OTARunParams(h=np.ones(2), b=np.ones(2))
    with pytest.raises(NotImplementedError, match="never pair"):
        tl.build_train_step(cfg, make_host_mesh(2, 1), fsdp_axis="data",
                            aggregation_axes=("data",), ota=ota,
                            device="cpu")
    with pytest.raises(ValueError, match="on a mesh with a pod axis"):
        tl.build_train_step(cfg, make_host_mesh(2, 1),
                            fsdp_axis=("pod", "data"), scheme="mean",
                            device="cpu")
    with pytest.raises(ValueError, match="OTARunParams"):
        tl.build_train_step(cfg, make_host_mesh(2, 1),
                            aggregation_axes=("data",), device="cpu")
    with pytest.raises(ValueError, match="pass \\('data',\\)"):
        tl.build_train_step(cfg, make_host_mesh(2, 1), ota=ota,
                            aggregation_axes=("model",), device="cpu")
