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

The OTA noise: round t's slot-1 channel noise is drawn from
``generator(seed + 1, t)``; the second transmission slot of the two-slot
client algorithms (``SLOT_SALT``, the reference's ``_SLOT_SALT``) draws its
own from ``generator(seed + 1, SLOT_SALT, t)``, so slot 1 keeps its bits and
the two slots' noise is independent.

The streams (for the channel, the reference's ``PRNGKey(seed)`` for the
setup and ``chan_key = PRNGKey(seed + 2)``, ``fold_in(t)``, for the
rounds):

======================  ===============================================
draw                    stream
======================  ===============================================
setup draw              ``generator(seed)`` (the default draw's bits)
geometry                ``generator(seed, GEOM_SALT)``; its shadowing
                        ``generator(seed, GEOM_SALT, 1)``
setup estimate          ``generator(seed, CSI_SALT)``
round t's channel       ``generator(seed + 2, t)``
round t's estimate      ``generator(seed + 2, CSI_SALT, t)``
round t's slot-1 noise  ``generator(seed + 1, t)``
round t's slot-2 noise  ``generator(seed + 1, SLOT_SALT, t)``
round t's mask          ``generator(seed + 1, MASK_SALT, t)``
======================  ===============================================

The block schedule (``block_normals`` / ``block_uniforms``, behind
``core.channel.draw_fading_state_block`` and
``channels.geometry.relative_gains_block``): device i's values are a
counter-based hash of ``derive_seed(seed, i)``, computed for a whole array
of device indices at once (no generator per device), so any blocking of
``[0, K)`` concatenates to the same values.  It is a different stream from
the dense ``[K, 2]`` draw, as in the reference.

The train step's channel noise (``noise_key``, ``mix64``): element w of
leaf l (its place in sorted-key order) hashes ``noise_key(seed, l)`` with
the counter w, the block schedule's hash on torch int64 tensors, so that
any piece of a leaf is drawn on its own device and is the whole draw's
slice (``kernels/channel_noise.py``).
"""
from __future__ import annotations

import numpy as np
import torch

_MASK = 0x7FFFFFFFFFFFFFFF
MASK_SALT = 0x5EED          # the participation-mask stream (the reference's)
CSI_SALT = 0xC51            # the CSI-estimation stream (the reference's)
GEOM_SALT = 0x6E0           # the geometry draw (the reference's)
SLOT_SALT = 0x510           # the second OTA slot's noise (the reference's)
NOISE_SALT = 0x7A15E        # the train step's channel noise (the port's)
_MUL = 0x9E3779B97F4A7C15
_ADD = 0x632BE59BD9B4E019


def derive_seed(seed: int, *salts: int) -> int:
    """A 63-bit seed derived from ``seed`` and ``salts`` (the port's
    ``fold_in``): distinct salts give unrelated streams."""
    out = int(seed) & _MASK
    for s in salts:
        # tracelint: disable=TL001 salts are python or numpy ints
        out = (out * _MUL + int(s) + _ADD) & _MASK
        out ^= out >> 29
    return out


def generator(seed: int, *salts: int) -> torch.Generator:
    """A CPU generator seeded with ``derive_seed(seed, *salts)`` (or
    ``seed`` itself when no salt is given)."""
    return torch.Generator().manual_seed(derive_seed(seed, *salts)
                                         if salts else int(seed) & _MASK)


def derive_seeds(seed: int, idx) -> np.ndarray:
    """``derive_seed(seed, i)`` for every i of ``idx`` (an int array or
    tensor), as uint64, in wrapping 64-bit arithmetic."""
    i = np.asarray(torch.as_tensor(idx).cpu(), dtype=np.uint64)
    mask = np.uint64(_MASK)
    out = np.full(i.shape, int(seed) & _MASK, dtype=np.uint64)
    out = (out * np.uint64(_MUL) + i + np.uint64(_ADD)) & mask
    return out ^ (out >> np.uint64(29))


def _mix(z: np.ndarray) -> np.ndarray:
    # splitmix64's finalizer
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def block_uniforms(seed: int, idx, counters) -> torch.Tensor:
    """[len(idx), len(counters)] float64 uniforms in (0, 1): entry (j, c) is
    a hash of device ``idx[j]``'s seed ``derive_seed(seed, idx[j])`` and
    the counter ``counters[c]``, so it depends on nothing else."""
    keys = derive_seeds(seed, idx)[:, None]
    c = np.asarray(counters, dtype=np.uint64)[None, :] + np.uint64(1)
    z = _mix(keys + c * np.uint64(_MUL))
    u = ((z >> np.uint64(11)).astype(np.float64) + 0.5) * 2.0 ** -53
    return torch.from_numpy(u)


def block_normals(seed: int, idx, counter: int = 0) -> torch.Tensor:
    """[len(idx), 2] float64 standard normals of the block schedule: one
    Box-Muller pair a device from the uniforms at counters ``counter`` and
    ``counter + 1``."""
    u = block_uniforms(seed, idx, (counter, counter + 1)).numpy()
    # numpy's elementwise math, single-threaded, gives each element the same
    # bits whatever the array's length (torch's CPU loops take another code
    # path for a loop's tail), which is what keeps any blocking invariant
    r = np.sqrt(-2.0 * np.log(u[:, 0]))
    ang = 2.0 * np.pi * u[:, 1]
    return torch.from_numpy(np.stack([r * np.cos(ang), r * np.sin(ang)],
                                     axis=-1))


def noise_key(seed: int, leaf: int) -> int:
    """The key of leaf ``leaf``'s channel noise in a train step seeded
    with ``seed``: ``derive_seed(seed, NOISE_SALT, leaf)``."""
    return derive_seed(seed, NOISE_SALT, leaf)


def _signed(c: int) -> int:
    return c - (1 << 64) if c >= 1 << 63 else c


def mix64(z: torch.Tensor) -> torch.Tensor:
    """``_mix`` (splitmix64's finalizer) of an int64 tensor read as uint64,
    in wrapping 64-bit arithmetic; ``>>`` of an int64 tensor is arithmetic,
    so each shift is masked to its logical width."""
    z = z ^ ((z >> 30) & ((1 << 34) - 1))
    z = z * _signed(0xBF58476D1CE4E5B9)
    z = z ^ ((z >> 27) & ((1 << 37) - 1))
    z = z * _signed(0x94D049BB133111EB)
    return z ^ ((z >> 31) & ((1 << 33) - 1))


def counter_hash(key: int, w: torch.Tensor) -> torch.Tensor:
    """The hash of counter ``w`` (an int64 tensor) under ``key``:
    ``mix64(key + (w + 1) * _MUL)`` mod 2^64, ``block_uniforms``' hash."""
    return mix64((w + 1) * _signed(_MUL) + _signed(key & ((1 << 64) - 1)))
