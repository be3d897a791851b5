"""TL001: host syncs in the captured round (RoundBody.__call__ and what it
reaches, and a registered scheme's callable)."""
import torch


def register(record):
    return record


class Scheme:
    def __init__(self, **kw):
        self.kw = kw


def _round_math(params, r):
    g = params["w"] * r.eta
    scale = g.sum().item()                     # .item()
    if_host = float(r.eta)                      # float() of a tensor
    rows = g.tolist()                           # .tolist()
    torch.cuda.synchronize()                    # a sync
    z = torch.tensor([1.0, 2.0])                # host data to the device
    idx = torch.nonzero(g)                      # data-dependent shape
    picked = g[g > 0]                           # boolean-mask indexing
    return g * scale + if_host, rows, z, idx, picked


class RoundBody:
    def __call__(self, lane, staged, cursor, hist):
        return _round_math(lane.params, staged)


register(Scheme(name="bad", device_scale=lambda st, gb: 1.0 / float(st.norm)))
