"""TL009: the flight recorder inside the captured round."""
from repro_torch.obs import profiling


def _round_tail(y, r, recorder):
    recorder.emit({"kind": "round"})
    profiling.annotate_chunk(0)
    return y


class RoundBody:
    def __call__(self, lane, staged, cursor, hist):
        return _round_tail(lane.params, staged, self.recorder)
