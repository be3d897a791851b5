"""``Experiment``: compile an ``ExperimentSpec`` into a runnable object (port
of ``repro/fl/experiment.py``).

    spec = ExperimentSpec(fl=FLConfig(scheme="normalized", backend="kernels"))
    e = Experiment(spec)            # device="cuda" by default
    e.run(20)                       # setup() is implicit on first run
    e.history["train_loss"]         # accumulated across run() calls
    e.save("ckpt.msgpack")          # params, optimizer, channel, client state
    e2 = Experiment(spec).load("ckpt.msgpack"); e2.run(20)   # resumes

    rec = obs.make("jsonl", path="run.jsonl")
    e.run(300, recorder=rec)        # a manifest, then chunk/round/eval events
    rec.close()

The device defaults to ``"cuda"`` and a missing card raises; pass
``device="cpu"`` to run the plain versions on the CPU.  Checkpoints are the
reference's MessagePack files (``repro_torch.checkpoint.store``): a file
either package wrote resumes in the other, and a file written on the card
loads on the CPU, and the other way round, with the same bits.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint import store
from repro_torch.device import resolve_device
from repro_torch.fed import runtime
from repro_torch.fl.spec import ExperimentSpec
from repro_torch.fl.tasks import Task, build_task

Tree = Dict[str, torch.Tensor]

# the checkpoint leaves that may be absent: the reference's forward-compat
# prefixes (checkpoints from before its wireless-environment subsystem and
# its client-algorithm registry), and the port's designed gain, which the
# reference does not write
MISSING_OK = ("['channel']['h_hat']", "['channel']['fad_state']",
              "['channel']['scale']", "['channel']['eff_gain']",
              "['client']")


class Experiment:
    """A declarative OTA-FL experiment: spec -> setup() -> run(num_rounds).
    ``history`` accumulates every per-round diagnostic and eval metric
    across ``run()`` calls; ``save()``/``load()`` checkpoint the whole
    resumable state (params, server optimizer, channel, client state and
    round).

    A checkpoint carries no placement: the spec's ``device_mesh`` fixes the
    round's order of sums, not where it runs, so a run saved on a group of
    D ranks resumes with the same bits in one process (the emulated
    shards), and the other way round (see ``FLConfig.device_mesh``)."""

    def __init__(self, spec: ExperimentSpec, task: Optional[Task] = None,
                 device="cuda", recorder: Optional[obs.Recorder] = None):
        self.spec = spec
        self.cfg = spec.fl_config()
        self.device = resolve_device(device)
        # a caller that already built the task (parity tests) may inject
        # it; it must match the spec and live on ``device``
        self.task: Optional[Task] = task
        self.state: Optional[runtime.FLState] = None
        self.history: Dict[str, List] = {}
        # the default sink of every run() (a per-call recorder overrides it)
        self.recorder: Optional[obs.Recorder] = recorder

    def setup(self) -> "Experiment":
        """Build the task, draw the channel, and run the paper's parameter
        optimization (Problem 3 / Algorithm 1)."""
        if self.task is None:
            self.task = build_task(self.spec.data, self.spec.model,
                                   self.cfg.num_devices, self.device)
        self.state = runtime.setup(self.cfg, self.task.params0,
                                   self.task.model_dim)
        self.history = {}
        return self

    def reset(self) -> "Experiment":
        """Re-setup from round 0 (fresh params, optimizer, channel and
        client state); the task already built is reused."""
        return self.setup()

    def _ensure_setup(self) -> None:
        if self.state is None:
            self.setup()

    def run(self, num_rounds: int, *, driver: Optional[str] = None,
            chunk_size: Optional[int] = None,
            eval_every: Optional[int] = None,
            evaluate: Optional[bool] = None,
            noise_provider: Optional[Callable[[int], torch.Tensor]] = None,
            recorder: Optional[obs.Recorder] = None) -> Dict[str, List]:
        """Run ``num_rounds`` FL rounds and merge the produced history into
        ``self.history``.  Returns this call's history.

        ``driver`` and ``chunk_size`` override the spec's, as in the
        reference: ``"scan"`` (the spec's default) runs the chunked engine,
        up to ``chunk_size`` rounds a chunk with the task's
        ``chunk_batch_provider``, ``"python"`` one round at a time (where
        ``chunk_size`` changes nothing); both give the same bits.  The
        state -- params, optimizer, channel and the client algorithm's
        state -- carries from one call to the next (``reset`` starts them
        anew).

        ``recorder`` (or the constructor's) streams the run: a manifest
        event, then the engine's chunk, round and eval events.  With
        ``REPRO_OBS_PROFILE`` set, the call is one ``torch.profiler``
        trace.  Neither changes a bit of the run."""
        self._ensure_setup()
        ev = self.spec.eval
        enabled = ev.enabled if evaluate is None else evaluate
        rec = recorder if recorder is not None else self.recorder
        if rec is not None:
            rec.on_manifest(self.manifest())
        handle = obs.profiling.start_profile()
        try:
            self.state, hist = runtime.run(
                self.cfg, self.state, self.task.grad_fn,
                self.task.batch_provider, num_rounds,
                eval_fn=self.task.eval_fn if enabled else None,
                eval_every=eval_every if eval_every is not None else ev.every,
                driver=driver or self.spec.driver,
                chunk_size=chunk_size or self.spec.chunk_size,
                chunk_batch_provider=self.task.chunk_batch_provider,
                noise_provider=noise_provider, recorder=rec)
        finally:
            obs.profiling.stop_profile(handle)
        for k, v in hist.items():
            self.history.setdefault(k, []).extend(v)
        return hist

    # ---------------------------------------------------------- observability

    def manifest(self) -> Dict[str, Any]:
        """This experiment's run manifest: spec JSON, config hash,
        structural signature, the current params digest, the round and the
        torch/CUDA/GPU identity (:mod:`repro_torch.obs.manifest`)."""
        self._ensure_setup()
        return obs.run_manifest(spec=self.spec, cfg=self.cfg,
                                params=self.state.params,
                                extra={"round": int(self.state.round)})

    def dump_history(self, path: str) -> str:
        """Write ``self.history`` to ``path`` as the JSONL stream a live
        ``JsonlRecorder`` writes: a manifest line, then one ``round`` line
        per round and one ``eval`` line per eval round."""
        self._ensure_setup()
        diag_keys = [k for k in runtime.DIAG_KEYS if k in self.history]
        eval_keys = [k for k in self.history
                     if k not in ("round", "eval_round")
                     and k not in runtime.DIAG_KEYS]
        with obs.JsonlRecorder(path) as rec:
            rec.on_manifest(self.manifest())
            for j, t in enumerate(self.history.get("round", [])):
                rec.on_round(int(t), {k: self.history[k][j]
                                      for k in diag_keys})
            for j, t in enumerate(self.history.get("eval_round", [])):
                rec.on_eval(int(t), {k: self.history[k][j]
                                     for k in eval_keys})
        return path

    # ------------------------------------------------------------- properties

    @property
    def params(self) -> Tree:
        self._ensure_setup()
        return self.state.params

    @property
    def round(self) -> int:
        return 0 if self.state is None else self.state.round

    # ------------------------------------------------------------ checkpoints

    def _ckpt_tree(self) -> Dict[str, Any]:
        """The checkpoint tree: the reference's (``params``, ``opt``, the
        float64 ``channel`` and the fp32 ``client`` state, each present as
        the spec makes it), and under a time-varying channel the port's
        designed gain ``['channel']['eff_gain']`` (0-d float64)."""
        st = self.state
        as64 = lambda v: np.asarray(v, np.float64)
        channel = {"h": as64(st.h), "b": as64(st.b), "a": as64(st.a),
                   "eta0": as64(st.eta0),
                   "h_hat": as64(st.h if st.h_hat is None else st.h_hat)}
        if st.fad_state is not None:
            channel["fad_state"] = as64(st.fad_state)
        if st.scale is not None:
            channel["scale"] = as64(st.scale)
        if self.cfg.channel.time_varying():
            channel["eff_gain"] = as64(st.eff_gain if st.eff_gain is not None
                                       else runtime.designed_gain(st))
        out = {"params": st.params, "opt": st.opt_state, "channel": channel}
        if st.client_state is not None:
            out["client"] = {
                part: None if tree is None else {
                    k: v.detach().cpu().numpy().astype(np.float32)
                    for k, v in tree.items()}
                for part, tree in st.client_state.items()}
        return out

    def save(self, path: str) -> str:
        """Checkpoint the state so that a fresh ``Experiment`` on the same
        spec can ``load`` it and resume the same trajectory, bit for
        bit."""
        self._ensure_setup()
        # before any run: the optimizer state run() would start from
        runtime._init_missing_state(self.cfg, self.state, self.device)
        store.save(path, self._ckpt_tree(),
                   {"round": int(self.state.round),
                    "model_dim": int(self.state.model_dim),
                    "scheme": self.cfg.scheme,
                    "server_opt": self.cfg.server_opt})
        return path

    def load(self, path: str) -> "Experiment":
        """Restore a checkpoint written by ``save`` (of either package):
        shapes and structure are checked against this spec's, the tensors
        go to ``self.device``, and the experiment is placed at the
        checkpoint's round.  Only ``MISSING_OK``'s leaves may be absent:
        they keep ``setup()``'s values (the reference's older layouts), and
        an absent designed gain is derived anew from the loaded ``a``,
        ``b`` and ``h_hat`` at the next run, as the reference does; a
        missing params, optimizer or core channel leaf raises."""
        self._ensure_setup()
        runtime._init_missing_state(self.cfg, self.state, self.device)
        like = self._ckpt_tree()
        if "eff_gain" in like["channel"]:
            like["channel"]["eff_gain"] = np.asarray(np.nan)
        restored, meta = store.restore(path, like, missing_ok=MISSING_OK)
        st = self.state
        ch = restored["channel"]
        st.params = restored["params"]
        st.opt_state = restored["opt"]
        st.h = np.asarray(ch["h"], np.float64)
        st.b = np.asarray(ch["b"], np.float64)
        st.a = float(ch["a"])
        st.eta0 = float(ch["eta0"])
        st.h_hat = np.asarray(ch["h_hat"], np.float64)
        if "fad_state" in ch:
            st.fad_state = np.asarray(ch["fad_state"], np.float64)
        if "scale" in ch:
            st.scale = np.asarray(ch["scale"], np.float64)
        if "eff_gain" in ch:
            gain = float(ch["eff_gain"])
            st.eff_gain = None if math.isnan(gain) else gain
        if "client" in restored:
            st.client_state = {
                part: None if tree is None else {
                    k: torch.from_numpy(np.array(v, np.float32)).to(
                        self.device) for k, v in tree.items()}
                for part, tree in restored["client"].items()}
        st.round = int(meta["round"])
        return self
