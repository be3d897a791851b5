"""TL002: draws from the global generator, and global seeding."""
import torch


def init(shape):
    torch.manual_seed(0)
    w = torch.randn(shape)
    mask = torch.bernoulli(torch.full(shape, 0.5))
    w.normal_()
    return w * mask + torch.rand_like(w)
