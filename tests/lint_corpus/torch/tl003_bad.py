"""TL003: Python branches on tensor values in the captured round."""
import torch


def _round_tail(y, r):
    if r.participants > 0:
        y = y * 2.0
    assert torch.isfinite(y).all()
    while y.abs().max() > 1.0:
        y = y / 2.0
    return y if y.sum() > 0 else -y


class RoundBody:
    def __call__(self, lane, staged, cursor, hist):
        return _round_tail(lane.params, staged)
