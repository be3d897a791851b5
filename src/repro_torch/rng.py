"""Seeded random streams of the port.

Every draw goes through an explicit CPU ``torch.Generator`` seeded from the
config (the JAX package's threefry keys have no counterpart here, so the two
packages never share a stream: parity tests hand JAX-made inputs across).
Drawing on the CPU and moving the result to the device makes a CPU run and a
GPU run from one seed see the same data, channel and noise.
"""
from __future__ import annotations

import torch

_MASK = 0x7FFFFFFFFFFFFFFF


def derive_seed(seed: int, *salts: int) -> int:
    """A 63-bit seed derived from ``seed`` and ``salts`` (the port's
    ``fold_in``): distinct salts give unrelated streams."""
    out = int(seed) & _MASK
    for s in salts:
        out = (out * 0x9E3779B97F4A7C15 + int(s) + 0x632BE59BD9B4E019) & _MASK
        out ^= out >> 29
    return out


def generator(seed: int, *salts: int) -> torch.Generator:
    """A CPU generator seeded with ``derive_seed(seed, *salts)`` (or
    ``seed`` itself when no salt is given)."""
    return torch.Generator().manual_seed(derive_seed(seed, *salts)
                                         if salts else int(seed) & _MASK)
