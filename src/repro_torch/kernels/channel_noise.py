"""The OTA train step's channel noise on the card: the wrapper of
``csrc/channel_noise.cu`` and the map from a rank's piece of a leaf to the
whole leaf.

The kernel applies ``y <- a (y + sigma n(key, w))`` to one piece of one
leaf of the folded update, where ``w`` is the element's flat index in the
*whole* leaf and ``key = rng.noise_key(seed, leaf)`` (``leaf`` the leaf's
place in sorted-key order).  ``n`` is a pure function of (key, w), so a
rank's piece is bitwise the whole leaf's draw sliced, whatever the cut, the
rank or the launch shape, and a rank draws only its own piece.

The stream: splitmix64 (``rng.mix64``, the finalizer ``rng._mix`` of the
port's block schedule, on ``key + (w + 1) * 0x9E3779B97F4A7C15``), the
port's one hash, rather than Philox4x32-10: it is one 64-bit multiply-xor
chain a draw, written the same way in torch int64 ops (the plain version,
``ref.noise_normals_ref``) and in C, and its keys come from ``rng.
derive_seed`` as every other seeded stream of the port.  The top 24 bits
give u1 = (k + 1) 2^-24 in (0, 1] and the next 24 u2 = k 2^-24 in [0, 1),
both exact in fp32; Box-Muller's cosine branch gives one normal an element
(|n| <= sqrt(-2 ln 2^-24) = 5.77: the 24-bit grid cuts the tails there).
``ln`` and ``cos`` are short polynomials of fp32 additions, products, one
division and one square root, each correctly rounded (``__fadd_rn`` and
the like in the kernel, one torch op each in the plain version), so the
plain version is the kernel's bits on the CPU and on the card, and on the
CPU its bits do not depend on the length of the array (torch's vectorised
``log``/``cos`` take another code path for a loop's tail).

A piece is described by a ``PieceMap``: the piece's shape, its region's
start in each dim of the whole leaf, the whole leaf's strides, and for a
``halves`` leaf (``in_proj``'s ``[u | z]``, two regions of the last dim
side by side) the column where the second region starts in the piece and
its start in the whole leaf.  ``piece_map`` builds it from the whole shape
and ``sharding._regions``' index tuples, collapsing every dim whose inner
neighbour is whole into that neighbour.

Public callers go through ``repro_torch.kernels.ops.channel_noise``, which
counts the launches and serves CPU tensors with the plain version.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _launch

MAX_DIMS = 8          # dims of a collapsed piece (kMaxDims, the .cu)


def _f32(x: float) -> float:
    return float(np.float32(x))


# the transform's fp32 constants, as the kernel spells them (kSqrt2, ...)
NOISE_CONSTS = {
    "SQRT2": _f32(math.sqrt(2.0)), "LN2": _f32(math.log(2.0)),
    "TWO_PI": _f32(2.0 * math.pi),
    # ln m = 2 s (1 + s^2 L3 + s^4 L5 + ... + s^10 L11), s = (m-1)/(m+1)
    "L3": _f32(1 / 3), "L5": _f32(1 / 5), "L7": _f32(1 / 7),
    "L9": _f32(1 / 9), "L11": _f32(1 / 11),
    # cos x = 1 + C2 x^2 + ... + C8 x^8, sin x = x (1 + S3 x^2 + ... + S9 x^8)
    "C2": -0.5, "C4": _f32(1 / 24), "C6": _f32(-1 / 720),
    "C8": _f32(1 / 40320),
    "S3": _f32(-1 / 6), "S5": _f32(1 / 120), "S7": _f32(-1 / 5040),
    "S9": _f32(1 / 362880),
}


@dataclasses.dataclass(frozen=True)
class PieceMap:
    """A contiguous piece of a leaf, and where its elements sit in the
    whole leaf (module doc)."""
    pshape: Tuple[int, ...]
    start: Tuple[int, ...]
    wstride: Tuple[int, ...]
    split: int
    start2: int

    @property
    def numel(self) -> int:
        return math.prod(self.pshape)


def piece_map(full: Sequence[int], regions: Optional[Sequence] = None
              ) -> PieceMap:
    """The ``PieceMap`` of the piece that holds ``regions`` (index tuples
    of slices into a tensor of shape ``full``, as ``sharding._regions``
    gives them: one, or two that differ in the last dim only, side by side
    in the piece); None: the whole leaf."""
    full = tuple(int(n) for n in full) or (1,)
    regions = list(regions or [tuple(slice(None) for _ in full)])
    if len(regions) not in (1, 2):
        raise ValueError(f"a piece holds one or two regions, got "
                         f"{len(regions)}")
    dims = []               # [whole, piece, start] from the first dim on
    for d, n in enumerate(full):
        sl = regions[0][d] if d < len(regions[0]) else slice(None)
        lo, hi, _ = sl.indices(n)
        dims.append([n, hi - lo, lo])
    split, start2 = dims[-1][1], 0
    if len(regions) == 2:
        lo, hi, _ = regions[1][-1].indices(full[-1])
        split, start2 = dims[-1][1], lo
        dims[-1][1] += hi - lo
    # collapse, innermost first: a dim merges into its inner neighbour
    # when that neighbour is whole (and is not the two-region last dim)
    out = [dims[-1]]
    halves = len(regions) == 2
    for n, p, s in reversed(dims[:-1]):
        inner = out[0]
        if inner[1] == inner[0] and inner[2] == 0 and not (
                halves and len(out) == 1):
            out[0] = [n * inner[0], p * inner[0], s * inner[0]]
        else:
            out.insert(0, [n, p, s])
    if len(out) > MAX_DIMS:
        raise ValueError(f"a piece of {len(out)} collapsed dims; the kernel "
                         f"takes {MAX_DIMS}")
    wstride = [1] * len(out)
    for d in range(len(out) - 2, -1, -1):
        wstride[d] = wstride[d + 1] * out[d + 1][0]
    if not halves:                 # one region: no column starts a second
        split = out[-1][1]
    return PieceMap(tuple(o[1] for o in out), tuple(o[2] for o in out),
                    tuple(wstride), int(split), int(start2))


_P, _LL, _I, _F, _U64 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_float, ctypes.c_uint64)
_ARR = ctypes.POINTER(ctypes.c_longlong)
_ENTRY_POINTS = {
    "channel_noise": {
        "channel_noise_launch": (
            [_P, _P, _LL, _I, _ARR, _ARR, _ARR, _LL, _LL, _U64, _F, _P, _P],
            _I),
        "noise_uniforms_launch": (
            [_P, _LL, _I, _ARR, _ARR, _ARR, _LL, _LL, _U64, _P], _I),
    },
}


def _library() -> ctypes.CDLL:
    return _launch.bind("channel_noise", _ENTRY_POINTS["channel_noise"])


def _map_args(pmap: PieceMap) -> list:
    arr = ctypes.c_longlong * len(pmap.pshape)
    return [len(pmap.pshape), arr(*pmap.pshape), arr(*pmap.start),
            arr(*pmap.wstride), pmap.split, pmap.start2]


def channel_noise_cuda(y: torch.Tensor, key: int, sigma: float,
                       gain: torch.Tensor, pmap: PieceMap,
                       out: torch.Tensor) -> torch.Tensor:
    """``out = gain (y + sigma n(key, w))`` for a contiguous fp32 CUDA piece
    ``y`` (``out`` may be ``y``), the gain a 0-d fp32 tensor on the card
    read there; launched on the current stream."""
    _launch.check(y.reshape(-1), 1, "y")
    _launch.check(out.reshape(-1), 1, "out")
    lib = _library()
    with torch.cuda.device(y.device):
        err = lib.channel_noise_launch(
            y.data_ptr(), out.data_ptr(), y.numel(), *_map_args(pmap),
            key, sigma, gain.data_ptr(),
            torch.cuda.current_stream(y.device).cuda_stream)
    _launch.raise_on(err, lib.channel_noise_error_string, "channel_noise")
    return out


def noise_uniforms_cuda(key: int, pmap: PieceMap, device) -> torch.Tensor:
    """[numel, 2] fp32: the (u1, u2) the kernel draws for each element of
    the piece ``pmap`` (the check's view of the stream)."""
    lib = _library()
    out = torch.empty((pmap.numel, 2), dtype=torch.float32, device=device)
    with torch.cuda.device(out.device):
        err = lib.noise_uniforms_launch(
            out.data_ptr(), pmap.numel, *_map_args(pmap), key,
            torch.cuda.current_stream(out.device).cuda_stream)
    _launch.raise_on(err, lib.channel_noise_error_string, "channel_noise")
    return out
