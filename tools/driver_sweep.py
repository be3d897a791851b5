#!/usr/bin/env python3
"""The scan driver's CUDA-graph designs and schedules, against each other on
the card.

    python3 tools/driver_sweep.py > chiprun_out/driver_sweep.jsonl

``one_round``: the port's design (``runtime._GraphChunks``), one round
captured once and replayed once a round, the cursor stepping through the
staged chunk, the host drawing the next chunk's inputs while the card runs
the replays.  ``serial``: the same, with the host waiting for the replays
before it draws the next chunk (``SerialChunks``: the schedule without that
overlap).  ``unrolled``: a whole chunk captured as one graph, one graph for
each chunk length (``UnrolledChunks``), replayed once a chunk.  All run the
same round body over the same buffers.  On the Case-I round
(``chip_smoke.case_i_spec``, no eval, 20 rounds a call: chunks of 16 and 4;
and 160 rounds a call: ten chunks of 16) and the K-scale round
(``chip_smoke.kscale_case``, 3 rounds a call: one chunk of 3): PAIRS
pairs of turns of ``one_round`` and each rival, the order swapped from
pair to pair, each turn from empty engine caches: the first call's
seconds (the warm-up and the captures in it), then the median warm
rounds/s of WARM calls; how many pairs ``one_round`` wins, and each
design's quartiles.  Every run's params are checked against the cell's
first run, bitwise.  One JSON line per cell and rival.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PAIRS = 10       # alternating pairs of turns, the order swapped each pair
WARM = 3         # warm calls a turn, its rate their median


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("driver_sweep: needs an NVIDIA GPU")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as smoke
    from repro_torch.fed import runtime
    from repro_torch.fl import Experiment
    from repro_torch.kernels import ops

    class UnrolledChunks(runtime._GraphChunks):
        """A chunk of rounds captured as one graph, one for each chunk
        length, warmed up once."""

        def __init__(self, body, device, chunk_size):
            super().__init__(body, device, chunk_size)
            self.graphs, self.counts = {}, {}

        def launch(self, staged):
            self.rounds = rounds = staged.t.shape[0]
            self._stage(staged)
            if rounds not in self.graphs:
                stream = (self._warm_up() if self.static is None
                          else runtime._capture_stream(self.device))
                graph = torch.cuda.CUDAGraph()
                with ops.capture_counts() as self.counts[rounds]:
                    with torch.cuda.graph(graph, stream=stream):
                        self.cursor.zero_()
                        for _ in range(rounds):
                            self._step()
                self.graphs[rounds] = graph
            if self.pending is not None:
                runtime._copy_into(self.static, self.pending)
                self.pending = None
            self.cursor.zero_()
            self.graphs[rounds].replay()
            ops.replay_counts(self.counts[rounds])

    class SerialChunks(runtime._GraphChunks):
        """The one-round graph, the host waiting for each chunk's
        replays before it goes on."""

        def launch(self, staged):
            super().launch(staged)
            torch.cuda.synchronize()

    designs = {"one_round": runtime._GraphChunks, "serial": SerialChunks,
               "unrolled": UnrolledChunks}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    torch.backends.cuda.matmul.allow_tf32 = False

    def case_i(rounds):
        def make():
            e = Experiment(smoke.case_i_spec(), device="cuda")
            e.setup()
            return lambda: e.run(rounds, evaluate=False), rounds, \
                lambda: e.params
        return make

    def kscale():
        cfg, state, grad_fn, provider = smoke.kscale_case("cuda")
        holder = [state]

        def call():
            holder[0], _ = runtime.run(cfg, holder[0], grad_fn, None,
                                       smoke.STREAM_ROUNDS,
                                       block_batch_provider=provider)
        return call, smoke.STREAM_ROUNDS, lambda: holder[0].params

    want = {}

    def turn(cell, make, design):
        """One design from empty engine caches: the first call (warm-up and
        captures in it) timed apart, then the median of WARM calls."""
        # the scan driver's builder makes the engine class it finds in the
        # module at call time
        runtime._GraphChunks = designs[design]
        runtime.clear_compile_caches()
        call, rounds, params = make()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        got = {k: v.clone() for k, v in params().items()}
        same = all(torch.equal(got[k], v) for k, v in
                   want.setdefault(cell, got).items())
        rates = []
        for _ in range(WARM):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            rates.append(rounds / (time.perf_counter() - t0))
        return cold, statistics.median(rates), same, rounds

    for cell, make in (("case_i_20", case_i(smoke.ROUNDS)),
                       ("case_i_160", case_i(160)), ("kscale", kscale)):
        for rival in ("serial", "unrolled"):
            runs = {"one_round": [], rival: []}
            first = {"one_round": [], rival: []}
            wins, bitwise = 0, True
            for i in range(PAIRS):
                order = ("one_round", rival) if i % 2 == 0 else (
                    rival, "one_round")
                pair = {}
                for design in order:
                    cold, rate, same, rounds = turn(cell, make, design)
                    pair[design] = rate
                    runs[design].append(rate)
                    first[design].append(cold)
                    bitwise = bitwise and same
                wins += pair["one_round"] > pair[rival]
            q = {d: statistics.quantiles(v, n=4) for d, v in runs.items()}
            emit({"cell": cell, "rounds_per_call": rounds,
                  "designs": ["one_round", rival], "pairs": PAIRS,
                  "rounds_per_s": runs,
                  "median_rounds_per_s": {d: statistics.median(v)
                                          for d, v in runs.items()},
                  "quartiles": q, "one_round_wins": wins,
                  "first_call_s_median": {d: statistics.median(v)
                                          for d, v in first.items()},
                  "params_bitwise_first_run": bitwise})
    runtime._GraphChunks = designs["one_round"]
    runtime.clear_compile_caches()


if __name__ == "__main__":
    main()
