"""Every finding here carries a reasoned suppression."""
import torch


def _round_math(g):
    # tracelint: disable=TL001 fixture: a deliberate sync, waived with its reason
    s = g.sum().item()
    if g.sum() > 0:  # tracelint: disable=TL003 fixture: a deliberate branch
        s = s + 1.0
    return s


class RoundBody:
    def __call__(self, lane, staged, cursor, hist):
        return _round_math(lane.params)


def draw(shape):
    return torch.randn(shape)  # tracelint: disable=TL002 fixture: the global stream on purpose
