"""Seeded random streams of the port.

Every draw goes through an explicit CPU ``torch.Generator`` seeded from the
config (the JAX package's threefry keys have no counterpart here, so the two
packages never share a stream: parity tests hand JAX-made inputs across).
Drawing on the CPU and moving the result to the device makes a CPU run and a
GPU run from one seed see the same data, channel and noise.

Participation masks (``MASK_SALT``): round t's [K] 0/1 mask is drawn once,
on the CPU, from ``generator(seed + 1, MASK_SALT, t)``, and the streaming
round slices it per K-block.  The reference draws lazily per device
(``fold_in`` of the device index) so that a TPU never holds a [K] draw; here
[K] floats are 400 KB at K = 100,000, and slicing one draw is invariant to
the blocking by construction.
"""
from __future__ import annotations

import torch

_MASK = 0x7FFFFFFFFFFFFFFF
MASK_SALT = 0x5EED          # the participation-mask stream (the reference's)


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
