"""TL001: the same round with every host value staged beforehand; the host
reads happen in ``_stage``, which the captured round does not reach."""
import torch


def _round_math(params, r, cfg):
    g = params["w"] * r.eta
    n = cfg.num_devices                         # static config
    k = int(g.shape[0])                         # metadata
    keep = torch.where(g > 0, g, torch.zeros_like(g))
    return g * r.a_eff / n + keep * k


class RoundBody:
    def __call__(self, lane, staged, cursor, hist):
        return _round_math(lane.params, staged, self.cfg)


def _stage(history):
    # host code: reads the last chunk's rows
    return history.cpu().tolist(), float(history[0, 0])
