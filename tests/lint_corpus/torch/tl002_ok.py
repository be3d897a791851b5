"""TL002: every draw names its generator."""
import torch


def init(shape, seed):
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn(shape, generator=gen)
    mask = torch.bernoulli(torch.full(shape, 0.5), generator=gen)
    w.normal_(generator=gen)
    return w * mask + torch.rand(shape, generator=gen)
