"""The flight recorder in the port (``repro_torch.obs``, ``runtime.run`` /
``run_batched(recorder=)``, ``run_sweep(recorder=)``, ``Experiment``'s
``recorder=``, ``manifest``, ``dump_history``, profiling and
``serve_metrics``), on the CPU; the reference's ``tests/test_obs.py``
classes ``TestBitwiseInvisibility``, ``TestEventStream``, ``TestSinks``,
``TestProfiling`` and ``TestLiveMetrics``, and the reference's event stream
beside the port's on one spec.

Recorder on against off gives the same bits (params, client state,
history) on both drivers and backends, the streamed round, a two-slot
client algorithm, every sink, and a batched and a sequential
``run_sweep`` (the reference's own sequential-sweep test fails on this
jax; the port's passes).  The task is Case-II ridge (N = 30) at K = 4;
torch runs on one thread.
"""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core.channel import ChannelConfig as JChannelConfig
from repro.fed import runtime as jruntime
from repro.fl import DataSpec as JDataSpec
from repro.fl import EvalSpec as JEvalSpec
from repro.fl import Experiment as JExperiment
from repro.fl import ExperimentSpec as JExperimentSpec
from repro.fl import ModelSpec as JModelSpec
from repro_torch import obs
from repro_torch.core.channel import ChannelConfig
from repro_torch.fed import runtime as rt
from repro_torch.fl import (DataSpec, EvalSpec, Experiment, ExperimentSpec,
                            ModelSpec, SweepSpec, clients, run_sweep)

K = 4
ROUNDS = 8
RIDGE = dict(dataset="ridge", split="iid", num_train=200, dim=30,
             batch_size=16, seed=3)
FL = dict(num_devices=K, scheme="normalized", case="II", eta=0.01,
          grad_bound=25.0, s_target=0.995, smoothness_L=2.0,
          strong_convexity_M=0.5, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors, many small ops: one thread, restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def ridge_spec(backend="kernels", driver="scan", **fl_kw):
    over = {k: fl_kw.pop(k) for k in ("k_block", "local_steps", "local_lr")
            if k in fl_kw}
    fl = rt.FLConfig(backend=backend, channel=ChannelConfig(
        num_devices=K, channel_mean=1e-3), **{**FL, **fl_kw})
    return ExperimentSpec(fl=fl, data=DataSpec(**RIDGE),
                          model=ModelSpec(kind="ridge"),
                          eval=EvalSpec(every=5), chunk_size=3,
                          driver=driver, **over)


def _same_state(a, b):
    assert obs.params_sha256(a.params) == obs.params_sha256(b.params)
    sa, sb = a.state.client_state, b.state.client_state
    assert (sa is None) == (sb is None)
    if sb is not None:
        for part in ("dev", "srv"):
            for k in sb[part]:
                assert torch.equal(sa[part][k], sb[part][k]), (part, k)


def assert_invisible(spec, rounds=ROUNDS, **run_kw):
    """The run without a recorder, then with a MemoryRecorder: the same
    bits.  Returns the recorder."""
    e_off = Experiment(spec, device="cpu")
    h_off = e_off.run(rounds, **run_kw)
    rec = obs.MemoryRecorder()
    e_on = Experiment(spec, device="cpu")
    h_on = e_on.run(rounds, recorder=rec, **run_kw)
    _same_state(e_on, e_off)
    assert h_on == h_off
    return rec


class TestBitwiseInvisibility:
    @pytest.mark.parametrize("driver", ("scan", "python"))
    @pytest.mark.parametrize("backend", ("vmap", "kernels"))
    def test_driver_backend_matrix(self, driver, backend):
        rec = assert_invisible(ridge_spec(backend, driver))
        assert rec.select("manifest") and rec.select("chunk")
        assert len(rec.select("round")) == ROUNDS

    def test_k_block_streaming(self):
        rec = assert_invisible(ridge_spec(k_block=2))
        assert len(rec.select("round")) == ROUNDS

    @pytest.mark.parametrize("driver", ("scan", "python"))
    def test_two_slot_client_state(self, driver):
        rec = assert_invisible(ridge_spec(
            driver=driver, client=clients.ClientConfig(algo="scaffold"),
            local_steps=2, local_lr=0.05))
        assert len(rec.select("round")) == ROUNDS

    def test_sink_choice_invisible(self, tmp_path):
        e0 = Experiment(ridge_spec(), device="cpu")
        h0 = e0.run(ROUNDS)
        for rec in (obs.make("null"), obs.make("memory"),
                    obs.make("jsonl", path=str(tmp_path / "r.jsonl")),
                    obs.make("csv", path=str(tmp_path / "r.csv"))):
            e = Experiment(ridge_spec(), device="cpu", recorder=rec)
            with rec:
                assert e.run(ROUNDS) == h0
            _same_state(e, e0)

    def test_batched_sweep_invisible(self):
        sweep = SweepSpec(ridge_spec(), {"eta": (0.01, 0.02),
                                         "seed": (0, 1)})
        res_off = run_sweep(sweep, ROUNDS, device="cpu")
        rec = obs.MemoryRecorder()
        res_on = run_sweep(sweep, ROUNDS, recorder=rec, device="cpu")
        assert res_off.params_sha256() is not None
        assert res_on.params_sha256() == res_off.params_sha256()
        for k in res_off.history:
            np.testing.assert_array_equal(res_on.history[k],
                                          res_off.history[k])
        assert rec.events[0]["event"] == "manifest"
        assert rec.events[0]["manifest"]["sweep_shape"] == [2, 2]
        # batched rounds carry one value a lane
        row = rec.select("round")[0]
        assert isinstance(row["grad_norm_mean"], list)
        assert len(row["grad_norm_mean"]) == sweep.size
        assert [r["round"] for r in rec.select("round")] == list(
            range(1, ROUNDS + 1))
        ev = rec.select("eval")
        assert [e["round"] for e in ev] == [1, 5]
        assert len(ev[0]["gap"]) == sweep.size
        lanes = res_off.history["grad_norm_mean"]
        assert [r["grad_norm_mean"] for r in rec.select("round")] == \
            lanes.T.tolist()

    def test_sequential_sweep_invisible(self):
        sweep = SweepSpec(ridge_spec(), {"eta": (0.01, 0.02)})
        res_off = run_sweep(sweep, ROUNDS, vectorized=False, device="cpu")
        rec = obs.MemoryRecorder()
        res_on = run_sweep(sweep, ROUNDS, vectorized=False, recorder=rec,
                           device="cpu")
        assert res_on.params_sha256() == res_off.params_sha256()
        # batched and sequential agree on the combined digest too
        assert (run_sweep(sweep, ROUNDS, device="cpu").params_sha256()
                == res_off.params_sha256())
        # the grid's manifest, then each point's own run
        assert [e["event"] for e in rec.events].count("manifest") == 3
        assert len(rec.select("round")) == 2 * ROUNDS


class TestEventStream:
    def test_chunk_events_cover_all_rounds(self):
        rt.clear_compile_caches()
        rec = obs.MemoryRecorder()
        e = Experiment(ridge_spec(), device="cpu")
        e.run(ROUNDS, recorder=rec)
        e.run(ROUNDS, recorder=rec)
        chunks = rec.select("chunk")
        covered = []
        for c in chunks:
            assert c["round_end"] >= c["round_start"]
            # one lane: one round body a round
            assert c["dispatches"] == c["round_end"] - c["round_start"] + 1
            assert c["wall_time_s"] > 0 and c["rss_mb"] > 0
            assert set(c["retraces"]) == set(rt.TRACE_KINDS)
            covered.extend(range(c["round_start"], c["round_end"] + 1))
        assert covered == [r["round"] for r in rec.select("round")]
        assert covered == list(range(1, 2 * ROUNDS + 1))
        # the first chunk holds the engine's build, and nothing else does
        assert chunks[0]["retraces"]["run_chunk"] == 1
        assert sum(sum(c["retraces"].values()) for c in chunks) == 1

    def test_eval_events_follow_schedule(self):
        rec = obs.MemoryRecorder()
        Experiment(ridge_spec(), device="cpu").run(10, recorder=rec)
        assert [ev["round"] for ev in rec.select("eval")] == [1, 5, 10]
        assert "gap" in rec.select("eval")[0]

    @pytest.mark.parametrize("driver", ("scan", "python"))
    def test_round_events_match_history(self, driver):
        rec = obs.MemoryRecorder()
        e = Experiment(ridge_spec(driver=driver), device="cpu")
        hist = e.run(ROUNDS, recorder=rec)
        rows = rec.select("round")
        for k in rt.DIAG_KEYS:
            assert [r[k] for r in rows] == [float(v) for v in hist[k]]
        assert [ev["gap"] for ev in rec.select("eval")] == hist["gap"]

    def test_dump_history_matches_live_jsonl(self, tmp_path):
        live, post = tmp_path / "live.jsonl", tmp_path / "post.jsonl"
        e = Experiment(ridge_spec(), device="cpu")
        with obs.JsonlRecorder(str(live)) as rec:
            e.run(ROUNDS, recorder=rec)
        e.dump_history(str(post))
        lv = [json.loads(s) for s in open(live)]
        pv = [json.loads(s) for s in open(post)]
        for kind in ("round", "eval"):
            assert ([x for x in lv if x["event"] == kind]
                    == [x for x in pv if x["event"] == kind])
        assert pv[0]["event"] == "manifest"
        # the post-hoc manifest is the run's end state
        assert pv[0]["manifest"]["round"] == ROUNDS
        assert pv[0]["manifest"]["params_sha256"] == obs.params_sha256(
            e.params)
        assert lv[0]["manifest"]["round"] == 0

    @pytest.mark.parametrize("driver", ("scan", "python"))
    def test_reference_and_port_streams_agree(self, driver):
        """The reference and the port on one spec, chunk size and eval
        schedule: the same event kinds in the same order, the same keys,
        chunk ranges and eval rounds."""
        jfl = jruntime.FLConfig(backend="vmap", channel=JChannelConfig(
            num_devices=K, channel_mean=1e-3), **FL)
        jspec = JExperimentSpec(fl=jfl, data=JDataSpec(**RIDGE),
                                model=JModelSpec(kind="ridge"),
                                eval=JEvalSpec(every=5), chunk_size=3,
                                driver=driver)
        jrec, rec = jobs.MemoryRecorder(), obs.MemoryRecorder()
        JExperiment(jspec).run(10, recorder=jrec)
        Experiment(ridge_spec(driver=driver), device="cpu").run(
            10, recorder=rec)
        assert [e["event"] for e in rec.events] == [
            e["event"] for e in jrec.events]
        for mine, ref in zip(rec.events, jrec.events):
            assert set(mine) == set(ref), mine["event"]
        ranges = lambda r: [(c["round_start"], c["round_end"])
                            for c in r.select("chunk")]
        assert ranges(rec) == ranges(jrec)
        assert [set(c["retraces"]) for c in rec.select("chunk")] == [
            set(c["retraces"]) for c in jrec.select("chunk")]
        assert [e["round"] for e in rec.select("eval")] == [
            e["round"] for e in jrec.select("eval")]
        m, jm = rec.events[0]["manifest"], jrec.events[0]["manifest"]
        assert {"spec", "config_sha256", "structural_signature",
                "params_sha256", "round"} <= set(m) & set(jm)


class TestSinks:
    def test_registry(self):
        assert obs.names() == ["csv", "jsonl", "memory", "null"]
        assert isinstance(obs.make("memory"), obs.MemoryRecorder)
        with pytest.raises(KeyError, match="unknown recorder"):
            obs.get("nope")
        with pytest.raises(TypeError, match="callable"):
            obs.register("bad", 3)

    def test_memory_latest(self):
        rec = obs.MemoryRecorder()
        rec.on_manifest({"manifest_version": 1})
        rec.on_round(1, {"grad_norm_mean": 2.0})
        rec.on_round(2, {"grad_norm_mean": 1.0})
        snap = rec.latest()
        assert snap["events"] == 3
        assert snap["round"]["round"] == 2
        assert snap["eval"] is None

    def test_jsonl_buffers_until_flush(self, tmp_path):
        path = tmp_path / "r.jsonl"
        rec = obs.JsonlRecorder(str(path), flush_every=1000)
        for t in range(5):
            rec.on_round(t, {"x": float(t)})
        assert path.read_text() == ""          # still buffered
        rec.close()
        lines = [json.loads(s) for s in path.read_text().splitlines()]
        assert [ln["x"] for ln in lines] == [0.0, 1.0, 2.0, 3.0, 4.0]

    def test_csv_round_table(self, tmp_path):
        path = tmp_path / "r.csv"
        with obs.CsvRecorder(str(path)) as rec:
            rec.on_manifest({"manifest_version": 1})   # dropped by csv
            rec.on_round(1, {"grad_norm_mean": 2.5})
            rec.on_round(2, {"grad_norm_mean": [1.5, 0.5]})
        lines = path.read_text().splitlines()
        assert lines[0] == "round,grad_norm_mean"
        assert lines[2] == '2,"[1.5, 0.5]"'

    def test_chunk_fanout_batched_lanes(self):
        rec = obs.MemoryRecorder()
        rec.on_chunk(0, [1, 2], {"g": np.arange(6.0).reshape(3, 2)})
        rows = rec.select("round")
        assert rows[0]["g"] == [0.0, 2.0, 4.0]      # [E] lanes of round 1
        assert rows[1]["g"] == [1.0, 3.0, 5.0]


class TestProfiling:
    def test_rss_sampling(self):
        assert obs.profiling.rss_mb() > 0
        assert obs.profiling.peak_rss_mb() >= obs.profiling.rss_mb() * 0.5

    def test_disabled_without_env(self, monkeypatch):
        monkeypatch.delenv(obs.profiling.PROFILE_ENV, raising=False)
        assert not obs.profiling.enabled()
        assert obs.profiling.start_profile() is None
        assert obs.profiling.stop_profile(None) is None
        null = obs.profiling.annotate_chunk(0)
        assert null is obs.profiling.annotate_chunk(1)
        with obs.profiling.annotate_chunk(0):
            pass

    def test_profiled_run_is_the_unprofiled_run(self, tmp_path,
                                                monkeypatch):
        """With REPRO_OBS_PROFILE set, a run is one Chrome trace with one
        obs_chunk range per chunk, and gives the unprofiled bits."""
        e0 = Experiment(ridge_spec(), device="cpu")
        h0 = e0.run(ROUNDS)
        monkeypatch.setenv(obs.profiling.PROFILE_ENV, str(tmp_path / "tr"))
        e = Experiment(ridge_spec(), device="cpu")
        rec = obs.MemoryRecorder()
        assert e.run(ROUNDS, recorder=rec) == h0
        _same_state(e, e0)
        traces = list((tmp_path / "tr").glob("obs_trace_*.json"))
        assert len(traces) == 1
        names = {ev.get("name") for ev in
                 json.loads(traces[0].read_text())["traceEvents"]}
        chunks = {f"obs_chunk_{c['chunk']}" for c in rec.select("chunk")}
        assert chunks and chunks <= names
        # one trace at a time: a nested start is refused
        handle = obs.profiling.start_profile()
        try:
            assert obs.profiling.start_profile() is None
        finally:
            obs.profiling.stop_profile(handle)


class TestLiveMetrics:
    def test_serve_metrics_endpoint(self):
        from repro_torch.launch.serve import serve_metrics
        rec = obs.MemoryRecorder()
        Experiment(ridge_spec(), device="cpu").run(ROUNDS, recorder=rec)
        server = serve_metrics(rec)
        try:
            host, port = server.server_address
            body = json.loads(urllib.request.urlopen(
                f"http://{host}:{port}/metrics", timeout=10).read())
            assert body["round"]["round"] == ROUNDS
            assert body["events"] == len(rec.events)
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(f"http://{host}:{port}/other",
                                       timeout=10)
        finally:
            server.shutdown()
            server.server_close()
