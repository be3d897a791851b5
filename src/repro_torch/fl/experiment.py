"""``Experiment``: compile an ``ExperimentSpec`` into a runnable object (port
of ``repro/fl/experiment.py``).

    spec = ExperimentSpec(fl=FLConfig(scheme="normalized", backend="kernels"))
    e = Experiment(spec)            # device="cuda" by default
    e.run(20)                       # setup() is implicit on first run
    e.history["train_loss"]         # accumulated across run() calls

The device defaults to ``"cuda"`` and a missing card raises; pass
``device="cpu"`` to run the plain versions on the CPU.  Checkpoints
(``save``/``load``) and ``dump_history`` wait for the checkpoint slice
(ROADMAP queue 1 item 14).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.fed import runtime
from repro_torch.fl.spec import ExperimentSpec
from repro_torch.fl.tasks import Task, build_task

Tree = Dict[str, torch.Tensor]


class Experiment:
    """A declarative OTA-FL experiment: spec -> setup() -> run(num_rounds).
    ``history`` accumulates every per-round diagnostic and eval metric
    across ``run()`` calls."""

    def __init__(self, spec: ExperimentSpec, task: Optional[Task] = None,
                 device="cuda"):
        self.spec = spec
        self.cfg = spec.fl_config()
        self.device = resolve_device(device)
        # a caller that already built the task (parity tests) may inject
        # it; it must match the spec and live on ``device``
        self.task: Optional[Task] = task
        self.state: Optional[runtime.FLState] = None
        self.history: Dict[str, List] = {}

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
        """Re-setup from round 0 (fresh params, optimizer and channel
        state); the task already built is reused."""
        return self.setup()

    def run(self, num_rounds: int, *, driver: Optional[str] = None,
            chunk_size: Optional[int] = None,
            eval_every: Optional[int] = None,
            evaluate: Optional[bool] = None,
            noise_provider: Optional[Callable[[int], torch.Tensor]] = None
            ) -> Dict[str, List]:
        """Run ``num_rounds`` FL rounds and merge the produced history into
        ``self.history``.  Returns this call's history.

        ``driver`` and ``chunk_size`` override the spec's, as in the
        reference: ``"scan"`` (the spec's default) runs the chunked engine,
        up to ``chunk_size`` rounds a chunk with the task's
        ``chunk_batch_provider``, ``"python"`` one round at a time (where
        ``chunk_size`` changes nothing); both give the same bits."""
        if self.state is None:
            self.setup()
        ev = self.spec.eval
        enabled = ev.enabled if evaluate is None else evaluate
        self.state, hist = runtime.run(
            self.cfg, self.state, self.task.grad_fn, self.task.batch_provider,
            num_rounds, eval_fn=self.task.eval_fn if enabled else None,
            eval_every=eval_every if eval_every is not None else ev.every,
            driver=driver or self.spec.driver,
            chunk_size=chunk_size or self.spec.chunk_size,
            chunk_batch_provider=self.task.chunk_batch_provider,
            noise_provider=noise_provider)
        for k, v in hist.items():
            self.history.setdefault(k, []).extend(v)
        return hist

    @property
    def params(self) -> Tree:
        if self.state is None:
            self.setup()
        return self.state.params

    @property
    def round(self) -> int:
        return 0 if self.state is None else self.state.round
