"""The client algorithms in the port (``repro_torch.fl.clients``: FedProx,
FedDyn, SCAFFOLD and the second OTA slot), on the CPU, at the reference's
small shape (``tests/test_clients.py``: K = 8, 320 examples, hidden 8).

* the registry: names, validation, flags, ``init_state``, the tables;
* ``sgd``, default and explicit, bitwise on both drivers;
* each algorithm's round against the JAX package's round
  (``REFERENCE_CASES``: every algorithm on the dense round, and the
  masked ``bernoulli`` (with an empty round) and ``fixed``, active-gather
  and ``k_block`` rounds, and the ``k_block`` round masked and gathered,
  each under a two-slot algorithm; one reference
  compile a case, so the matrix is crossed, not full): every round starts
  from the reference's state after the round before (its params and
  client state through ``repro_torch.interop``; its batches, masks and
  both slots' noise through the providers), so the tolerance is one
  round's;
* scan == python bitwise; ``run(3); run(3)`` == ``run(6)``;
* the two-slot energy, exactly twice the unit-norm budget; slot 2's noise
  on its own stream; an empty round holding the server state;
* batched lanes of ``mu`` / ``alpha`` bitwise their own runs, ``mu = 0``
  the sgd run, and a mixed-algorithm grid batched against sequential;
* (slow) the non-IID separation of FedDyn and SCAFFOLD from sgd.

torch runs on one thread in this file (``_one_torch_thread``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.core import schemes as jschemes
from repro.core.channel import ChannelConfig as JChannelConfig
from repro.data.datasets import synthetic_mnist as jsynthetic_mnist
from repro.fed import runtime as jruntime
from repro.fl import DataSpec as JDataSpec
from repro.fl import ModelSpec as JModelSpec
from repro.fl import clients as jclients
from repro.fl.tasks import build_task as jbuild_task
from repro_torch import interop, rng
from repro_torch.core import ota
from repro_torch.core.channel import ChannelConfig
from repro_torch.data.datasets import FederatedSplit
from repro_torch.fed import runtime
from repro_torch.fl import (DataSpec, EvalSpec, Experiment, ExperimentSpec,
                            ModelSpec, SweepSpec, run_sweep, tasks)
from repro_torch.fl import clients
from repro_torch.fl.sweep import STRUCTURAL

K = 8
ROUNDS = 6
EMPTY_ROUND = 3
H, LOCAL_LR = 2, 0.05
DATA = dict(dataset="synthetic_mnist", split="dirichlet", alpha=1.0,
            num_train=320, num_test=64, batch_size=16, seed=0)
# one round of the port against one round of the reference from the same
# state: fp32 gradients and K-way sums associated differently by XLA and
# PyTorch (the runtime parity tolerance for the params), then for the
# client state the slot-2 aggregate de-gained by 1/(a sum h_hat b), which
# scales its roundoff with it, hence the wider atol; SCAFFOLD's device
# variates come closest, at about a twentieth of it
PARAMS_TOL = dict(rtol=1e-4, atol=1e-6)
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
HIST_TOL = dict(rel=1e-4, abs=1e-9)

ALGOS = {"fedprox": dict(algo="fedprox", mu=0.1),
         "feddyn": dict(algo="feddyn", alpha=0.1),
         "scaffold": dict(algo="scaffold")}
ROUND_KINDS = {
    "dense": {},
    "bernoulli": dict(participation=0.55),
    "fixed": dict(participation=0.5, participation_mode="fixed"),
    "gather": dict(participation=0.5, participation_mode="fixed",
                   active_gather=True),
    "k_block": dict(k_block=4),
    # the streamed round's masked and gathered branches: two K-blocks each
    "bernoulli_k_block": dict(participation=0.55, k_block=4),
    "gather_k_block": dict(participation=0.5, participation_mode="fixed",
                           active_gather=True, k_block=2),
}
# (algorithm, round) pairs held against the reference: every algorithm on
# the dense round, every other round under a two-slot algorithm
REFERENCE_CASES = (("fedprox", "dense"), ("feddyn", "dense"),
                   ("scaffold", "dense"), ("feddyn", "bernoulli"),
                   ("scaffold", "fixed"), ("feddyn", "gather"),
                   ("scaffold", "k_block"), ("feddyn", "bernoulli_k_block"),
                   ("scaffold", "gather_k_block"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The file's tensors are tiny and its rounds many small ops: on one
    thread they run as fast alone and do not stall on a loaded machine
    (the parallel test run), where intra-op threads wait on each other.
    Restored for the worker's next file."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fl_kwargs(algo, kind):
    return dict(num_devices=K, scheme="normalized", case="I", p=0.75,
                grad_bound=10.0, smoothness_L=5.0, expected_loss_drop=2.0,
                seed=0, local_steps=H, local_lr=LOCAL_LR,
                **ROUND_KINDS[kind])


@functools.lru_cache(maxsize=None)
def _jtask():
    return jbuild_task(JDataSpec(**DATA), JModelSpec(hidden=8), K)


def _np_tree(tree):
    return None if tree is None else jax.tree_util.tree_map(np.array, tree)


@functools.lru_cache(maxsize=None)
def _reference(algo, kind):
    """The JAX package's python-driver rounds of one case (vmap backend),
    one round a call, with what the port needs: each round's starting
    state, batch, mask and both slots' noise, and its params, client state
    and history.  The bernoulli case has round EMPTY_ROUND's mask zeroed
    (the reference's own idiom: its mask draw is patched)."""
    task = _jtask()
    cfg = jruntime.FLConfig(
        backend="vmap", channel=JChannelConfig(num_devices=K,
                                               channel_mean=1e-3),
        client=jclients.ClientConfig(**ALGOS[algo]), **_fl_kwargs(algo, kind))
    draw = jruntime._participation_mask

    def masked(cfg_, key, t):
        m = draw(cfg_, key, t)
        if not kind.startswith("bernoulli"):
            return m
        return jnp.where(t == EMPTY_ROUND, jnp.zeros_like(m), m)

    state = jruntime.setup(cfg, task.params0, task.model_dim)
    key = jax.random.PRNGKey(cfg.seed + 1)
    zeros = jax.tree_util.tree_map(lambda l: jnp.zeros(l.shape, jnp.float32),
                                   task.params0)

    def noise(k):
        z, _ = ravel_pytree(jschemes.add_channel_noise(
            zeros, k, cfg.channel.noise_var))
        return np.array(z)

    rounds = []
    jruntime._participation_mask = masked
    try:
        for t in range(1, ROUNDS + 1):
            kt = jax.random.fold_in(key, t)
            r = dict(start=(_np_tree(state.params),
                            _np_tree(state.client_state)),
                     noise=noise(kt),
                     noise2=noise(jax.random.fold_in(kt,
                                                     jruntime._SLOT_SALT)),
                     batch=np.array(task.batch_provider(t)[0]))
            if cfg.participation < 1.0:
                r["mask"] = np.array(masked(cfg, key, jnp.asarray(t)))
            state, hist = jruntime.run(cfg, state, task.grad_fn,
                                       task.batch_provider, 1,
                                       driver="python")
            r.update(params=_np_tree(state.params),
                     client_state=_np_tree(state.client_state),
                     hist={k: hist[k][0] for k in jruntime.DIAG_KEYS})
            rounds.append(r)
    finally:
        jruntime._participation_mask = draw
    return state, rounds


@functools.lru_cache(maxsize=None)
def _port_task():
    jtask = _jtask()
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


def _close_tree(got, want, tol, what):
    if want is None:
        assert got is None, what
        return
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, **tol,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("backend", ["vmap", "kernels"])
@pytest.mark.parametrize("algo,kind", REFERENCE_CASES)
def test_round_matches_reference(algo, kind, backend):
    """Each round of the port from the reference's state before it: the
    params, the client state (dev and srv) and every DIAG_KEYS value."""
    jstate, ref = _reference(algo, kind)
    cfg = runtime.FLConfig(
        backend=backend, channel=ChannelConfig(num_devices=K,
                                               channel_mean=1e-3),
        client=clients.ClientConfig(**ALGOS[algo]), **_fl_kwargs(algo, kind))
    task = _port_task()
    for t, r in enumerate(ref, start=1):
        params, cstate = r["start"]
        state = interop.state_from_jax(
            params, jstate.h, jstate.h_hat, jstate.b, jstate.a, jstate.eta0,
            t - 1, model_dim=jstate.model_dim, client_state=cstate,
            device="cpu")
        providers = dict(
            noise_provider=lambda _: torch.from_numpy(r["noise"]),
            slot2_noise_provider=(
                (lambda _: torch.from_numpy(r["noise2"]))
                if clients.get(cfg.client.algo).num_slots == 2 else None))
        if "mask" in r:
            providers["mask_provider"] = lambda _: torch.from_numpy(r["mask"])
        state, hist = runtime.run(
            cfg, state, task.grad_fn, lambda _: (torch.from_numpy(r["batch"]),),
            1, **providers)
        where = f"{algo}/{kind}/{backend} round {t}"
        _close_tree(state.params, r["params"], PARAMS_TOL, where)
        want_cs = r["client_state"]
        if want_cs is None:
            assert state.client_state is None, where
        else:
            for part in ("dev", "srv"):
                _close_tree(state.client_state[part], want_cs[part],
                            STATE_TOL, f"{where} {part}")
        for k in runtime.DIAG_KEYS:
            assert hist[k][0] == pytest.approx(r["hist"][k], **HIST_TOL), \
                (where, k)
        if kind.startswith("bernoulli") and t == EMPTY_ROUND:
            assert hist["num_participants"][0] == 0.0


# ---------------------------------------------------------------------------
# the registry


def test_registry_names_flags_and_tables():
    assert clients.names() == jclients.names() == (
        "sgd", "fedprox", "feddyn", "scaffold")
    assert clients.BATCHED_CLIENT_FIELDS == jclients.BATCHED_CLIENT_FIELDS
    assert (clients.STRUCTURAL_CLIENT_FIELDS
            == jclients.STRUCTURAL_CLIENT_FIELDS)
    for name in clients.names():
        mine, ref = clients.get(name), jclients.get(name)
        for flag in ("has_state", "has_server_state", "num_slots",
                     "uses_mu", "uses_alpha", "stateful"):
            assert getattr(mine, flag) == getattr(ref, flag), (name, flag)
    assert [f.name for f in dataclasses.fields(clients.ClientConfig)] == [
        f.name for f in dataclasses.fields(jclients.ClientConfig)]
    assert clients.ClientConfig() == clients.ClientConfig(algo="sgd")


@pytest.mark.parametrize("bad,match", [
    (dict(algo="fedavgm"), "unknown client algorithm"),
    (dict(mu=-0.1), "mu must be"),
    (dict(algo="feddyn", alpha=-0.5), "alpha must be"),
])
def test_config_validation(bad, match):
    with pytest.raises(ValueError, match=match):
        clients.ClientConfig(**bad)


@pytest.mark.parametrize("algo", ["feddyn", "scaffold"])
def test_two_slot_rejects_a_baseline_variate_scheme(algo):
    with pytest.raises(ValueError, match="variate"):
        runtime.FLConfig(client=clients.ClientConfig(
            algo=algo, variate_scheme="mean"))
    with pytest.raises(ValueError, match="unknown scheme"):
        runtime.FLConfig(client=clients.ClientConfig(
            algo=algo, variate_scheme="nope"))
    # a one-slot algorithm never reads the field
    runtime.FLConfig(client=clients.ClientConfig(algo="fedprox",
                                                 variate_scheme="mean"))


@pytest.mark.parametrize("bad,match", [
    (dict(num_slots=3), "num_slots"),
    (dict(has_state=True), "update_state"),
    (dict(num_slots=2, has_server_state=True), "variate_stat"),
    (dict(num_slots=2, variate_stat=lambda *a: a,
          apply_variate=lambda *a: a), "has_server_state"),
    (dict(has_server_state=True), "no slot"),
])
def test_algorithm_record_checks(bad, match):
    with pytest.raises(ValueError, match=match):
        clients.ClientAlgorithm(name="bad", **bad)
    with pytest.raises(ValueError, match="already registered"):
        clients.register(clients.ClientAlgorithm(name="sgd"))


def test_init_state_and_resolve_params():
    params0 = {"w": torch.ones((3, 2)), "b": torch.zeros((2,))}
    for algo in ("sgd", "fedprox"):
        assert clients.init_state(clients.ClientConfig(algo=algo), params0,
                                  K) is None
    for algo in ("feddyn", "scaffold"):
        st = clients.init_state(clients.ClientConfig(algo=algo), params0, K)
        assert st["dev"]["w"].shape == (K, 3, 2)
        assert st["dev"]["b"].shape == (K, 2)
        assert st["srv"]["w"].shape == (3, 2)
        for part in ("dev", "srv"):
            for leaf in st[part].values():
                assert leaf.dtype == torch.float32
                assert leaf.device == params0["w"].device
                assert not leaf.any()
    ccfg = clients.ClientConfig(algo="fedprox", mu=0.3)
    assert clients.resolve_params(ccfg).mu == 0.3
    lane = torch.tensor(0.7)
    cp = clients.resolve_params(ccfg, lane, None)
    assert cp.mu is lane and cp.alpha == ccfg.alpha


# ---------------------------------------------------------------------------
# the port's own contracts, on the port's own task


def _spec(algo="sgd", backend="kernels", noise_var=1e-7, data_alpha=1.0,
          h=H, channel=None, **fl):
    client = (None if algo is None else
              clients.ClientConfig(**ALGOS.get(algo, dict(algo=algo))))
    return ExperimentSpec(
        fl=runtime.FLConfig(
            num_devices=K, scheme="normalized", case="I", p=0.75,
            backend=backend, grad_bound=10.0, smoothness_L=5.0,
            expected_loss_drop=2.0, seed=0, client=client,
            channel=ChannelConfig(num_devices=K, channel_mean=1e-3,
                                  noise_var=noise_var, **(channel or {})),
            **fl),
        data=DataSpec(**{**DATA, "alpha": data_alpha}),
        model=ModelSpec(kind="mlp", hidden=8), eval=EvalSpec(every=5),
        chunk_size=4, local_steps=h, local_lr=LOCAL_LR)


def _same(a, b):
    assert a.history == b.history
    for k in b.params:
        assert torch.equal(a.params[k], b.params[k]), k
    sa, sb = a.state.client_state, b.state.client_state
    assert (sa is None) == (sb is None)
    if sb is not None:
        for part in ("dev", "srv"):
            for k in sb[part]:
                assert torch.equal(sa[part][k], sb[part][k]), (part, k)


@pytest.mark.parametrize("backend", ["vmap", "kernels"])
@pytest.mark.parametrize("driver", ["scan", "python"])
def test_sgd_default_is_explicit_sgd(driver, backend):
    runs = []
    for algo in (None, "sgd"):
        e = Experiment(dataclasses.replace(_spec(algo, backend),
                                           driver=driver), device="cpu")
        e.run(4)
        runs.append(e)
    _same(*runs)
    assert runs[0].state.client_state is None


@pytest.mark.parametrize("kind", ["dense", "bernoulli", "gather", "k_block",
                                  "bernoulli_k_block", "gather_k_block"])
@pytest.mark.parametrize("algo", ["fedprox", "feddyn", "scaffold"])
def test_scan_is_python_bitwise(algo, kind):
    runs = []
    for driver in ("scan", "python"):
        e = Experiment(dataclasses.replace(
            _spec(algo, **ROUND_KINDS[kind]), driver=driver), device="cpu")
        e.run(6)
        runs.append(e)
    _same(*runs)


@pytest.mark.parametrize("algo", ["feddyn", "scaffold"])
def test_two_slots_under_a_time_varying_channel(algo):
    """AR(1) fading with CSI error: both slots use the round's refreshed
    channel and estimate (staged h_t, h_hat_t); scan == python bitwise and
    the client state stays finite."""
    runs = []
    for driver in ("scan", "python"):
        e = Experiment(dataclasses.replace(
            _spec(algo, channel=dict(model="ar1", rho=0.9, csi_error=0.2),
                  participation=0.5), driver=driver), device="cpu")
        e.run(5)
        runs.append(e)
    _same(*runs)
    for tree in runs[0].state.client_state.values():
        assert all(torch.isfinite(l).all() for l in tree.values())


@pytest.mark.parametrize("algo", ["feddyn", "scaffold"])
def test_run_3_3_is_run_6_and_reset_zeroes_the_state(algo):
    a = Experiment(_spec(algo), device="cpu")
    a.run(3)
    a.run(3)
    b = Experiment(_spec(algo), device="cpu")
    b.run(6)
    _same(a, b)
    assert a.state.client_state["srv"]["w1"].abs().sum() > 0
    a.reset()
    for part in ("dev", "srv"):
        assert not any(l.any() for l in a.state.client_state[part].values())


@pytest.mark.parametrize("algo", ["feddyn", "scaffold"])
def test_two_slot_energy_is_twice_the_unit_norm_budget(algo):
    """Full participation and unit-norm schemes on both slots: each slot's
    eq.-8 total is sum_k b_k^2, so a two-slot round spends exactly twice
    the sgd round's."""
    sgd = Experiment(_spec("sgd"), device="cpu")
    two = Experiment(_spec(algo), device="cpu")
    sgd.run(4)
    two.run(4)
    budget = float(torch.sum(torch.as_tensor(sgd.state.b,
                                             dtype=torch.float32) ** 2))
    assert sgd.history["tx_energy"] == pytest.approx([budget] * 4, rel=1e-6)
    assert two.history["tx_energy"] == [2.0 * e
                                        for e in sgd.history["tx_energy"]]


def test_slot2_noise_is_its_own_stream():
    """Slot 2 draws from ``rng.generator(seed + 1, SLOT_SALT, t)``; slot 1
    keeps the sgd round's bits, and the two slots' noise is unrelated."""
    cfg = _spec("scaffold").fl_config()
    lane = runtime._LaneHost(cfg, torch.ones(K), torch.ones(K), 1.0, 1.0)
    shapes = {k: v.shape for k, v in _port_task().params0.items()}
    sch = runtime.schemes.get(cfg.scheme)
    ts = [1, 2]
    staged = runtime._stage([lane], sch, shapes, ts, noisy=True)
    sgd_lane = runtime._LaneHost(_spec("sgd").fl_config(), torch.ones(K),
                                 torch.ones(K), 1.0, 1.0)
    sgd_staged = runtime._stage([sgd_lane], sch, shapes, ts, noisy=True)
    assert sgd_staged.noise2 is None
    sgd = Experiment(_spec("sgd"), device="cpu").setup()
    with pytest.raises(ValueError, match="one slot"):
        runtime.run(sgd.cfg, sgd.state, sgd.task.grad_fn,
                    sgd.task.batch_provider, 1,
                    slot2_noise_provider=lambda t: None)
    assert torch.equal(staged.noise, sgd_staged.noise)
    ocfg = ota.OTAConfig(noise_var=cfg.channel.noise_var)
    for i, t in enumerate(ts):
        want = ota.resolve_noise(ocfg, shapes, "cpu", rng.generator(
            cfg.seed + 1, rng.SLOT_SALT, t))
        assert torch.equal(staged.noise2[i, 0], want)
        z1, z2 = staged.noise[i, 0].double(), staged.noise2[i, 0].double()
        corr = float(torch.dot(z1, z2) / (z1.norm() * z2.norm()))
        assert abs(corr) < 0.06, corr        # ~5 sigma at N = 6,442


@pytest.mark.parametrize("kind", ["dense", "k_block"])
@pytest.mark.parametrize("algo", ["feddyn", "scaffold"])
def test_empty_round_holds_the_state(algo, kind):
    """A bernoulli round in which nobody participates: params, every
    device's state and the server state stay as they were, and stay
    finite (the de-gained slot-2 aggregate is 0 / EPS, not 0 * inf)."""
    spec = _spec(algo, participation=0.55, **ROUND_KINDS[kind])
    e = Experiment(spec, device="cpu")
    e.run(2)
    before = (runtime._clone(e.params), runtime._clone(e.state.client_state))
    state, hist = runtime.run(e.cfg, e.state, e.task.grad_fn,
                              e.task.batch_provider, 1,
                              mask_provider=lambda t: torch.zeros(K))
    assert hist["num_participants"] == [0.0]
    for k, v in before[0].items():
        assert torch.equal(state.params[k], v), k
    for part, tree in before[1].items():
        for k, v in tree.items():
            assert torch.equal(state.client_state[part][k], v), (part, k)
            assert torch.isfinite(state.client_state[part][k]).all()


@pytest.mark.parametrize("algo,field,values", [
    ("fedprox", "mu", (0.0, 0.1, 0.5)),
    ("feddyn", "alpha", (0.05, 0.1, 0.3)),
])
def test_client_lanes_are_their_own_runs(algo, field, values):
    """A batched run's lanes differ only in mu (alpha): each lane is
    bitwise its own sequential run, so the value reaches the round from
    the lane's device memory, not from the structural config the round
    body was built from (mu = 0.0, alpha = 0.01)."""
    spec = _spec(algo)
    task = Experiment(spec, device="cpu").setup().task
    cfgs = [dataclasses.replace(spec.fl_config(), client=dataclasses.replace(
        spec.fl.client, **{field: v})) for v in values]
    states = [runtime.setup(c, task.params0, task.model_dim) for c in cfgs]
    states, hist = runtime.run_batched(cfgs, states, task.grad_fn,
                                       task.batch_provider, 5,
                                       chunk_size=3)
    finals = []
    for e, cfg in enumerate(cfgs):
        state = runtime.setup(cfg, task.params0, task.model_dim)
        state, want = runtime.run(cfg, state, task.grad_fn,
                                  task.batch_provider, 5, chunk_size=3)
        for k in runtime.DIAG_KEYS:
            assert hist[k][e].tolist() == want[k], (e, k)
        for k in state.params:
            assert torch.equal(states[e].params[k], state.params[k]), (e, k)
        finals.append(torch.cat([v.ravel() for v in state.params.values()]))
    assert not torch.equal(finals[0], finals[1])


def test_mu_zero_is_sgd():
    """FedProx at mu = 0 adds mu (w - w_t) = 0 to every local gradient: the
    batched mu = 0 lane is the sgd run."""
    res = run_sweep(SweepSpec(_spec("fedprox"), {"client.mu": (0.0, 0.3)}),
                    5, device="cpu")
    sgd = Experiment(_spec("sgd"), device="cpu")
    sgd.run(5)
    for k in runtime.DIAG_KEYS:
        assert res.history[k][0].tolist() == sgd.history[k], k
    assert res.history["train_loss"][0].tolist() == sgd.history["train_loss"]


def test_mixed_algorithm_grid_batched_is_sequential():
    """The figure's algorithm axis (composite, structural) over seeds:
    each algorithm is a structural group, and the batched grid is the grid
    run point by point, bitwise."""
    axes = {"algo": (("sgd", {"client.algo": "sgd"}),
                     ("fedprox", {"client.algo": "fedprox",
                                  "client.mu": 0.1}),
                     ("feddyn", {"client.algo": "feddyn",
                                 "client.alpha": 0.1}),
                     ("scaffold", {"client.algo": "scaffold"})),
            "seed": (0, 1)}
    sweep = SweepSpec(_spec(participation=0.5), axes)
    assert sweep.classification() == {"algo": STRUCTURAL,
                                       "seed": "batchable"}
    runtime.cache_info()
    res_b = run_sweep(sweep, 5, device="cpu")
    assert runtime.cache_info()["traces_delta"]["run_chunk_batched"] == 4
    res_s = run_sweep(sweep, 5, vectorized=False, device="cpu")
    for key in res_b.history:
        np.testing.assert_array_equal(res_b.history[key], res_s.history[key],
                                      err_msg=key)
    assert res_b.params_digests == res_s.params_digests
    assert len(set(res_b.params_digests)) == 8


@pytest.mark.slow
def test_stateful_correctors_separate_from_sgd():
    """The reference's non-IID deliverable (tests/test_clients.py::
    TestNonIIDSeparation) on the port: a dirichlet(0.1) split, H = 4,
    noise_var 1e-10, 3 seeds; FedDyn's and SCAFFOLD's final train-loss
    bands sit below sgd's.  40 rounds of the reference's 120, to keep the
    parallel test run inside its time limit (the bands separate at 20, 40,
    60 and 120 rounds alike; chip_smoke.py's phase clients runs the
    figure's 200 at full width)."""
    axes = {"algo": (("sgd", {"client.algo": "sgd"}),
                     ("feddyn", {"client.algo": "feddyn",
                                 "client.alpha": 0.1}),
                     ("scaffold", {"client.algo": "scaffold"})),
            "seed": (0, 1, 2)}
    base = dataclasses.replace(_spec(None, noise_var=1e-10, data_alpha=0.1,
                                     h=4), eval=EvalSpec(every=20))
    res = run_sweep(SweepSpec(base, axes), 40, device="cpu")
    mean, std = res.band("train_loss", over="seed")
    final = {n: (mean[i][-1], std[i][-1])
             for i, n in enumerate(res.sweep.values("algo"))}
    sm, ss = final["sgd"]
    for name in ("feddyn", "scaffold"):
        am, as_ = final[name]
        assert am + as_ < sm - ss, (name, final)
