"""TL003: the same decisions on the device, or on static config."""
import torch


def _round_tail(y, r, cfg):
    if cfg.k_block is not None:                 # static config
        y = y * 1.0
    if y.shape[0] > 1:                          # metadata
        y = y * 1.0
    if r.empty is not None:                     # identity test
        y = torch.where(r.empty, y * 0.0, y)
    return torch.where(y.sum() > 0, y, -y)


class RoundBody:
    def __call__(self, lane, staged, cursor, hist):
        return _round_tail(lane.params, staged, self.cfg)
