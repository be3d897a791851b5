"""TL009: the recorder at the chunk boundary, outside the round."""
from repro_torch.obs import profiling


def _round_tail(y, r):
    return y * r.eta


class RoundBody:
    def __call__(self, lane, staged, cursor, hist):
        return _round_tail(lane.params, staged)


def _emit_chunk(recorder, rows):
    with profiling.annotate_chunk(0):
        recorder.emit({"kind": "chunk", "rows": rows})
