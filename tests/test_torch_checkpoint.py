"""Checkpoints in the port (``repro_torch.checkpoint.store`` and
``Experiment.save`` / ``load``), on the CPU, against the JAX package's
``repro.checkpoint.store`` and its ``Experiment``.

* the store: the reference's ``TestCheckpoint`` (bf16, a nested dict and
  tuple, an int32 scalar; retention; a shape mismatch raises);
* the codec against ``msgpack`` (imported here only): the same bytes on
  encode and the same tree on decode over every tag the codec writes;
* the file format both ways: a file of ``repro.checkpoint.store.save``
  restores in the port, and the port's in the reference, leaf for leaf
  and bitwise;
* the port's ``save`` of a state carried over from the reference
  (``interop.state_from_jax``) is the reference's file byte for byte
  (adamw on the fixed channel, and scaffold's ``['client']`` subtree), and
  each package's file loads in the other's ``Experiment``;
* ``run(5); save; load; run(5)`` == ``run(10)`` bitwise (params, optimizer
  and client state, history) under both drivers: sgd, adamw at
  participation 0.7, feddyn, scaffold, and AR(1) rho 0.8 with CSI 0.2 and
  geometry (the designed gain ``['channel']['eff_gain']``);
* the reference's ``TestSaveLoad``, ``test_checkpoint_roundtrip_ar1_csi_
  geometry``, ``test_load_pre_subsystem_checkpoint`` and
  ``TestClientCheckpoints``.

The tasks are Case-II ridge (N = 30) at K = 4; torch runs on one thread.
"""
import functools
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.core.channel import ChannelConfig as JChannelConfig
from repro.fed import runtime as jruntime
from repro.fl import DataSpec as JDataSpec
from repro.fl import EvalSpec as JEvalSpec
from repro.fl import Experiment as JExperiment
from repro.fl import ExperimentSpec as JExperimentSpec
from repro.fl import ModelSpec as JModelSpec
from repro.fl import clients as jclients
from repro.optim.optimizers import OptState as JOptState
from repro_torch import interop
from repro_torch.channels import GeometryConfig
from repro_torch.checkpoint import _msgpack, store
from repro_torch.core.channel import ChannelConfig
from repro_torch.fed import runtime as rt
from repro_torch.fl import (DataSpec, EvalSpec, Experiment, ExperimentSpec,
                            ModelSpec, clients)
from repro_torch.optim.optimizers import OptState

K = 4
ROUNDS = 10
RIDGE = dict(dataset="ridge", split="iid", num_train=200, dim=30,
             batch_size=16, seed=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors, many small ops: one thread, restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fl(port, algo=None, channel=None, seed=0):
    """One Case-II ridge FLConfig of either package."""
    run_ns = rt if port else jruntime
    chan = (ChannelConfig if port else JChannelConfig)(
        num_devices=K, channel_mean=1e-3, noise_var=1e-7, **(channel or {}))
    extra = {}
    if algo is not None:
        extra["client"] = (clients if port else jclients).ClientConfig(
            algo=algo, alpha=0.05)
    # the reference on its vmap backend (its kernels backend runs Pallas in
    # interpret mode on the CPU); a checkpoint does not record the backend
    return run_ns.FLConfig(
        num_devices=K, scheme="normalized", case="II", eta=0.01,
        backend="kernels" if port else "vmap", channel=chan,
        grad_bound=25.0, s_target=0.995, smoothness_L=2.0,
        strong_convexity_M=0.5, seed=seed, **extra)


def spec(driver="scan", algo=None, channel=None, port=True, seed=0,
         **over):
    kw = dict(local_steps=2, local_lr=0.05) if algo else {}
    kw.update(over)
    ns = ((DataSpec, ModelSpec, EvalSpec, ExperimentSpec) if port else
          (JDataSpec, JModelSpec, JEvalSpec, JExperimentSpec))
    fl = _fl(port, algo, channel, seed)
    return ns[3](fl=fl, data=ns[0](**RIDGE), model=ns[1](kind="ridge"),
                 eval=ns[2](every=4), driver=driver, chunk_size=3, **kw)


def _leaves(tree):
    return [v for _, v in store._flatten_with_paths(tree)]


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _assert_state_equal(a, b):
    """Two ports' states bitwise: params, optimizer, client state."""
    for x, y in zip(_leaves((a.params, a.opt_state, a.client_state)),
                    _leaves((b.params, b.opt_state, b.client_state))):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the store (the reference's tests/test_substrate.py::TestCheckpoint)


class TestStore:
    def test_roundtrip(self, tmp_path):
        tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                "nested": {"b": torch.ones((4,), dtype=torch.bfloat16)},
                "t": (torch.zeros((2,)), torch.tensor(3, dtype=torch.int32)),
                "h": np.arange(3, dtype=np.float64) / 3.0}
        path = str(tmp_path / "ck.msgpack")
        store.save(path, tree, {"round": 7})
        like = {"a": torch.zeros(2, 3), "nested": {"b": torch.zeros(
            4, dtype=torch.bfloat16)}, "t": (torch.zeros(2), torch.tensor(
                0, dtype=torch.int32)), "h": np.zeros(3)}
        restored, meta = store.restore(path, like)
        assert meta["round"] == 7
        assert isinstance(restored["t"], tuple)
        assert restored["nested"]["b"].dtype == torch.bfloat16
        assert restored["t"][1].dtype == torch.int32
        assert restored["h"].dtype == np.float64
        for a, b in zip(_leaves(tree), _leaves(restored)):
            np.testing.assert_array_equal(_np(a.float() if isinstance(
                a, torch.Tensor) else a), _np(b.float() if isinstance(
                    b, torch.Tensor) else b))
        np.testing.assert_array_equal(restored["h"], tree["h"])

    def test_retention(self, tmp_path):
        d = str(tmp_path)
        for r in range(6):
            store.save_round(d, r, {"w": torch.zeros((1,))}, keep=3)
        assert len(os.listdir(d)) == 3
        assert store.latest_round(d).endswith("round_00000005.msgpack")
        assert store.latest_round(str(tmp_path / "none")) is None

    def test_shape_mismatch_raises(self, tmp_path):
        path = str(tmp_path / "ck.msgpack")
        store.save(path, {"w": torch.zeros((3,))})
        with pytest.raises(ValueError, match="shape mismatch"):
            store.restore(path, {"w": torch.zeros((4,))})
        with pytest.raises(KeyError, match="missing leaf"):
            store.restore(path, {"v": torch.zeros((3,))})

    def test_paths_are_jax_keystr(self):
        """The port's flattening gives jax's paths in jax's order."""
        tree = {"params": {"w2": np.zeros(2), "w1": np.zeros(1)},
                "opt": OptState(np.zeros((), np.int32), {"b": np.zeros(1)},
                                np.zeros(())),
                "client": {"dev": None, "srv": {"a": np.zeros(1)}},
                "t": (np.zeros(1), [np.ones(1)])}
        jtree = dict(tree, opt=JOptState(*tree["opt"]))
        flat, _ = jax.tree_util.tree_flatten_with_path(jtree)
        assert [p for p, _ in store._flatten_with_paths(tree)] == [
            jax.tree_util.keystr(p) for p, _ in flat]

    def test_atomic_write_leaves_no_tmp(self, tmp_path):
        path = str(tmp_path / "sub" / "ck.msgpack")
        store.save(path, {"w": torch.ones(2)})
        assert os.listdir(tmp_path / "sub") == ["ck.msgpack"]


# ---------------------------------------------------------------------------
# the codec against msgpack


PAYLOADS = [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
    2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
    -2 ** 31 - 1, -2 ** 63, 0.5, -1e300, float("inf"), True, False, None,
    "", "é" * 15, "a" * 32, "a" * 255, "a" * 256, "a" * 65536, b"",
    b"\x00" * 255, b"\x01" * 256, b"\x02" * 65536, [], list(range(15)),
    list(range(16)), list(range(65536)), {}, {str(i): i for i in range(15)},
    {str(i): i for i in range(16)}, {str(i): None for i in range(65536)},
    {"meta": {"round": 5, "scheme": "normalized"},
     "leaves": {"['w']": {"dtype": "<f4", "shape": [2, 3],
                          "data": b"\x00" * 24, "orig_dtype": None}}},
]


@pytest.mark.parametrize("obj", PAYLOADS, ids=[
    f"{type(o).__name__}{i}" for i, o in enumerate(PAYLOADS)])
def test_codec_matches_msgpack(obj):
    ref = msgpack.packb(obj, use_bin_type=True)
    assert _msgpack.packb(obj) == ref
    assert _msgpack.unpackb(ref) == msgpack.unpackb(ref, raw=False)


def test_codec_reads_float32_and_rejects_other_tags():
    assert _msgpack.unpackb(b"\xca\x3f\xc0\x00\x00") == 1.5
    assert _msgpack.packb((1, 2)) == msgpack.packb((1, 2),
                                                   use_bin_type=True)
    with pytest.raises(ValueError, match="0xd4"):
        _msgpack.unpackb(msgpack.packb(msgpack.ExtType(1, b"x")))
    with pytest.raises(ValueError, match="extra data"):
        _msgpack.unpackb(b"\x01\x02")
    with pytest.raises(TypeError):
        _msgpack.packb({"x": object()})


# ---------------------------------------------------------------------------
# the file format, both ways


def _pair_trees():
    """One tree in both packages' types: a NamedTuple, a nested tuple and
    list, a None, bf16, int32, fp32 and float64 leaves."""
    gen = np.random.default_rng(0)
    w = gen.standard_normal((3, 4)).astype(np.float32)
    bf = gen.standard_normal(5).astype(np.float32)
    h = gen.standard_normal(4)
    jtree = {"params": {"w": jnp.asarray(w), "b": jnp.asarray(bf,
                                                             jnp.bfloat16)},
             "opt": JOptState(jnp.asarray(7, jnp.int32),
                              {"w": jnp.asarray(w * 2)}, jnp.zeros(())),
             "channel": {"h": h, "a": np.asarray(0.25)},
             "client": {"dev": None, "srv": {"w": w * 3}},
             "t": (jnp.asarray(w[0]), [jnp.asarray(w[1])])}
    ptree = {"params": {"w": torch.from_numpy(w.copy()),
                        "b": torch.from_numpy(bf.copy()).bfloat16()},
             "opt": OptState(torch.tensor(7, dtype=torch.int32),
                             {"w": torch.from_numpy(w * 2)},
                             torch.zeros(())),
             "channel": {"h": h.copy(), "a": np.asarray(0.25)},
             "client": {"dev": None, "srv": {"w": w * 3}},
             "t": (torch.from_numpy(w[0].copy()),
                   [torch.from_numpy(w[1].copy())])}
    return jtree, ptree


def _bits(v):
    v = _np(v.float() if isinstance(v, torch.Tensor)
            and v.dtype == torch.bfloat16 else v)
    if v.dtype.kind == "V" or v.dtype.name == "bfloat16":
        v = np.asarray(jnp.asarray(v).astype(jnp.float32))
    return v.dtype.str, v.shape, v.tobytes()


def test_reference_file_restores_in_the_port(tmp_path):
    jtree, ptree = _pair_trees()
    path = str(tmp_path / "ref.msgpack")
    jstore.save(path, jtree, {"round": 3, "scheme": "normalized"})
    restored, meta = store.restore(path, ptree)
    assert meta == {"round": 3, "scheme": "normalized"}
    assert isinstance(restored["opt"], OptState)
    assert restored["params"]["b"].dtype == torch.bfloat16
    assert restored["channel"]["h"].dtype == np.float64
    jflat = jax.tree_util.tree_leaves(jtree)
    assert len(jflat) == len(_leaves(restored))
    for j, p in zip(jflat, _leaves(restored)):
        assert _bits(p) == _bits(j)


def test_port_file_restores_in_the_reference(tmp_path):
    jtree, ptree = _pair_trees()
    path = str(tmp_path / "port.msgpack")
    store.save(path, ptree, {"round": 3, "scheme": "normalized"})
    restored, meta = jstore.restore(path, jtree)
    assert meta == {"round": 3, "scheme": "normalized"}
    assert restored["params"]["b"].dtype == jnp.bfloat16
    jflat = jax.tree_util.tree_leaves(restored)
    for j, p in zip(jflat, _leaves(ptree)):
        assert _bits(j) == _bits(p)
    # and both packages write the same bytes for the same tree
    jpath = str(tmp_path / "ref.msgpack")
    jstore.save(jpath, jtree, {"round": 3, "scheme": "normalized"})
    assert open(jpath, "rb").read() == open(path, "rb").read()


# ---------------------------------------------------------------------------
# Experiment files across the packages


def _np_tree(tree):
    return None if tree is None else jax.tree_util.tree_map(np.array, tree)


@functools.lru_cache(maxsize=None)
def _reference_run(algo, server_opt):
    """A reference Experiment after 3 rounds, its checkpoint's bytes and
    its state as numpy."""
    e = JExperiment(spec(algo=algo, port=False, server_opt=server_opt))
    e.run(3)
    st = e.state
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ref.msgpack")
        e.save(path)
        data = open(path, "rb").read()
    carried = dict(params=_np_tree(st.params), h=st.h, h_hat=st.h_hat,
                   b=st.b, a=st.a, eta0=st.eta0, round=st.round,
                   model_dim=st.model_dim,
                   client_state=_np_tree(st.client_state),
                   opt_state=_np_tree(st.opt_state))
    return e, data, carried


@pytest.mark.parametrize("algo,server_opt", [(None, "adamw"),
                                             ("scaffold", "sgd")])
def test_carried_state_saves_the_reference_bytes(tmp_path, algo, server_opt):
    """The port's save of the reference's state is the reference's file,
    byte for byte; each package's file loads in the other's Experiment
    with the same leaves."""
    jexp, ref_bytes, carried = _reference_run(algo, server_opt)
    port_spec = spec(algo=algo, server_opt=server_opt)
    e = Experiment(port_spec, device="cpu").setup()
    c = dict(carried)
    e.state = interop.state_from_jax(
        c.pop("params"), c.pop("h"), c.pop("h_hat"), c.pop("b"), c.pop("a"),
        c.pop("eta0"), device="cpu", **c)
    path = str(tmp_path / "port.msgpack")
    e.save(path)
    assert open(path, "rb").read() == ref_bytes
    # the reference's file in the port's Experiment: the carried state
    ref_path = str(tmp_path / "ref.msgpack")
    with open(ref_path, "wb") as f:
        f.write(ref_bytes)
    loaded = Experiment(port_spec, device="cpu").load(ref_path)
    assert loaded.round == 3
    _assert_state_equal(loaded.state, e.state)
    for k in ("h", "b", "h_hat"):
        np.testing.assert_array_equal(getattr(loaded.state, k),
                                      getattr(e.state, k))
    assert (loaded.state.a, loaded.state.eta0) == (e.state.a, e.state.eta0)
    # the port's file in the reference's Experiment: the reference's state
    back = JExperiment(spec(algo=algo, port=False,
                            server_opt=server_opt)).load(path)
    assert back.round == 3
    for x, y in zip(jax.tree_util.tree_leaves(
            (back.state.params, back.state.opt_state,
             back.state.client_state)),
            jax.tree_util.tree_leaves(
                (jexp.state.params, jexp.state.opt_state,
                 jexp.state.client_state))):
        assert _bits(x) == _bits(y)


# ---------------------------------------------------------------------------
# resume from disk, bitwise


RESUME_CASES = {
    "sgd": {},
    "adamw_p07": dict(server_opt="adamw", participation=0.7),
    "feddyn": dict(algo="feddyn"),
    "scaffold": dict(algo="scaffold"),
    # seed 3: the gain derived anew from round 5's a, b and h_hat is an
    # ulp off the designed one, so this case fails without the saved
    # ['channel']['eff_gain'] leaf (at seed 0 the two agree at round 5)
    "ar1_csi_geometry": dict(seed=3, channel=dict(
        model="ar1", rho=0.8, csi_error=0.2,
        geometry=GeometryConfig(shadowing_std_db=3.0))),
}


@pytest.mark.parametrize("driver", ["scan", "python"])
@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resume_from_disk_is_the_unbroken_run(tmp_path, case, driver):
    s = spec(driver, **RESUME_CASES[case])
    cont = Experiment(s, device="cpu")
    cont.run(ROUNDS)
    first = Experiment(s, device="cpu")
    first.run(ROUNDS // 2)
    path = first.save(str(tmp_path / "ck.msgpack"))
    resumed = Experiment(s, device="cpu").load(path)
    assert resumed.round == ROUNDS // 2
    resumed.run(ROUNDS - ROUNDS // 2)
    _assert_state_equal(resumed.state, cont.state)
    assert {k: first.history[k] + resumed.history[k]
            for k in cont.history} == cont.history
    if s.fl.channel.time_varying():
        assert rt.designed_gain(first.state) != first.state.eff_gain
        assert resumed.state.eff_gain == cont.state.eff_gain
        np.testing.assert_array_equal(resumed.state.fad_state,
                                      cont.state.fad_state)
        np.testing.assert_array_equal(resumed.state.h, cont.state.h)


def test_eff_gain_leaf_and_its_absence(tmp_path):
    """The port writes the designed gain of a time-varying channel; a file
    without it (the reference's layout) loads and re-derives it from the
    loaded a, b and h_hat, as the reference does at every run."""
    s = spec(channel=dict(model="ar1", rho=0.8, csi_error=0.2))
    e = Experiment(s, device="cpu")
    e.run(3)
    path = e.save(str(tmp_path / "ck.msgpack"))
    payload = msgpack.unpackb(open(path, "rb").read(), raw=False)
    leaf = payload["leaves"]["['channel']['eff_gain']"]
    assert (leaf["dtype"], leaf["shape"]) == ("<f8", [])
    assert np.frombuffer(leaf["data"], np.float64)[0] == e.state.eff_gain
    del payload["leaves"]["['channel']['eff_gain']"]
    with open(path, "wb") as f:
        f.write(msgpack.packb(payload, use_bin_type=True))
    e2 = Experiment(s, device="cpu").load(path)
    assert e2.state.eff_gain is None
    e2.run(1)
    assert e2.state.eff_gain == rt.designed_gain(
        Experiment(s, device="cpu").load(path).state)
    # a fixed channel writes no gain
    f = Experiment(spec(), device="cpu")
    f.save(str(tmp_path / "fixed.msgpack"))
    assert "eff_gain" not in f._ckpt_tree()["channel"]


# ---------------------------------------------------------------------------
# the reference's TestSaveLoad, channel and client checkpoint tests


class TestSaveLoad:
    def test_save_before_any_run_resumes(self, tmp_path):
        s = spec(server_opt="adamw")
        path = Experiment(s, device="cpu").save(str(tmp_path / "ck.msgpack"))
        e = Experiment(s, device="cpu").load(path)
        assert e.round == 0 and int(e.state.opt_state.step) == 0
        e.run(4)
        ref = Experiment(s, device="cpu")
        ref.run(4)
        _assert_state_equal(e.state, ref.state)

    def test_channel_round_trips_float64(self, tmp_path):
        e = Experiment(spec(), device="cpu")
        e.run(3)
        path = e.save(str(tmp_path / "ck.msgpack"))
        e2 = Experiment(spec(), device="cpu").load(path)
        assert e2.state.h.dtype == np.float64
        np.testing.assert_array_equal(e2.state.h, e.state.h)
        np.testing.assert_array_equal(e2.state.b, e.state.b)
        assert e2.state.a == e.state.a and e2.state.eta0 == e.state.eta0

    def test_load_checks_structure(self, tmp_path):
        path = str(tmp_path / "ck.msgpack")
        e = Experiment(spec(), device="cpu")
        e.run(2)
        e.save(path)
        with pytest.raises((KeyError, ValueError)):
            Experiment(spec(server_opt="adamw"), device="cpu").load(path)

    def test_checkpoint_roundtrip_ar1_csi_geometry(self, tmp_path):
        s = spec(channel=dict(model="ar1", rho=0.8, csi_error=0.2,
                              geometry=GeometryConfig(shadowing_std_db=3.0)))
        e = Experiment(s, device="cpu")
        e.run(3)
        path = e.save(str(tmp_path / "ck.msgpack"))
        e2 = Experiment(s, device="cpu").load(path)
        for k in ("fad_state", "h_hat", "scale", "h", "b"):
            np.testing.assert_array_equal(getattr(e2.state, k),
                                          getattr(e.state, k))
        assert e2.state.eff_gain == e.state.eff_gain

    def test_load_pre_subsystem_checkpoint(self, tmp_path):
        e = Experiment(spec(), device="cpu")
        e.run(2)
        path = e.save(str(tmp_path / "old.msgpack"))
        payload = msgpack.unpackb(open(path, "rb").read(), raw=False)
        assert any("h_hat" in k for k in payload["leaves"])
        payload["leaves"] = {k: v for k, v in payload["leaves"].items()
                             if "h_hat" not in k}
        with open(path, "wb") as f:
            f.write(msgpack.packb(payload, use_bin_type=True))
        e2 = Experiment(spec(), device="cpu").load(path)
        assert e2.round == 2
        np.testing.assert_array_equal(e2.state.h, e.state.h)
        with pytest.raises(KeyError, match="h_hat"):
            store.restore(path, e2._ckpt_tree())


class TestClientCheckpoints:
    def test_pre_registry_checkpoint_loads(self, tmp_path):
        s = spec(algo="scaffold")
        e = Experiment(s, device="cpu")
        e.run(3)
        tree = e._ckpt_tree()
        del tree["client"]
        path = str(tmp_path / "old.msgpack")
        store.save(path, tree, {"round": e.state.round,
                                "model_dim": e.state.model_dim,
                                "scheme": e.cfg.scheme,
                                "server_opt": e.cfg.server_opt})
        e2 = Experiment(s, device="cpu").load(path)
        assert e2.round == 3
        for part in ("dev", "srv"):
            for leaf in e2.state.client_state[part].values():
                assert leaf.dtype == torch.float32 and not leaf.any()
        e2.run(2)
        assert e2.round == 5

    def test_pre_environment_checkpoint_loads(self, tmp_path):
        e = Experiment(spec(), device="cpu")
        e.run(2)
        meta = {"round": 2, "model_dim": e.state.model_dim,
                "scheme": e.cfg.scheme, "server_opt": e.cfg.server_opt}
        tree = e._ckpt_tree()
        del tree["channel"]["h_hat"]
        path = str(tmp_path / "pre_env.msgpack")
        store.save(path, tree, meta)
        e2 = Experiment(spec(), device="cpu").load(path)
        np.testing.assert_array_equal(e2.state.h_hat, e2.state.h)
        tree2 = e._ckpt_tree()
        del tree2["channel"]["h"]
        bad = str(tmp_path / "bad.msgpack")
        store.save(bad, tree2, meta)
        with pytest.raises(KeyError, match=r"\['h'\]"):
            Experiment(spec(), device="cpu").load(bad)

    def test_client_state_goes_out_fp32_and_back_as_tensors(self, tmp_path):
        e = Experiment(spec(algo="feddyn"), device="cpu")
        e.run(2)
        tree = e._ckpt_tree()
        assert all(isinstance(v, np.ndarray) and v.dtype == np.float32
                   for v in _leaves(tree["client"]))
        path = e.save(str(tmp_path / "ck.msgpack"))
        e2 = Experiment(spec(algo="feddyn"), device="cpu").load(path)
        for part in ("dev", "srv"):
            for k, v in e.state.client_state[part].items():
                got = e2.state.client_state[part][k]
                assert isinstance(got, torch.Tensor)
                assert torch.equal(got, v)
