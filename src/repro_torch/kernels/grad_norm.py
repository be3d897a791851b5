"""Reductions of flat gradients on the card: the wrappers of
``csrc/moments.cu`` and ``csrc/stream_moments.cu``, the Hopper ports of
``repro/kernels/grad_norm.py``'s ``batched_blocked_moments``,
``streaming_blocked_moments`` and ``blocked_sumsq``.

``batched_moments_cuda(g)`` and ``streaming_moments_cuda(g, k_block)`` read
the [K, N] fp32 stack in place (no padding copy) and return
``(sumsq, sums)``, each [K] fp32, summed in a fixed order;
``sumsq_cuda(x)`` and ``norm_cuda(x)`` return the 0-d sum of squares and
its root of one flat vector, from one launch of K1's kernel over a single
row.  ``moments_split(k, n)`` is the number of chunks K1 splits each row
into, at most one wave of CTAs; ``stream_moments_chunks(n)`` the number the
streamed moments split each row into, and ``sumsq_split(n)`` the number the
single vector is split into, both from N alone.  All run
``csrc/moments.cu``'s one launch: the block that finishes a row last
folds its partials, in a fixed order, elected by an arrival counter that
it sets back to 0.  The counters are one zeroed int32 array a (device,
stream), so launches on two streams never share them; a CUDA graph keeps
the array of the stream it was captured on, so two graphs captured on
one stream are not replayed at once.
Public callers go through ``repro_torch.kernels.ops``, which counts the
launches and serves CPU tensors with the plain versions.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _launch

MOMENTS_CHUNK = 8192     # elements a chunk of K3's long rows: 8,192 ran
                         # ahead of 4,096 and 16,384 at the round's, the
                         # wide and the ragged shapes (kernel_sweep k1)
MOMENTS_CTAS_PER_SM = 8  # CTAs of 256 threads an SM holds (kThreads,
                         # csrc/moments.cu)
MOMENTS_MIN_VEC = 2048   # float4s a chunk holds at least (8 a thread)
SUMSQ_TILE = 512         # float4s a tile of the single vector (kTile,
                         # csrc/moments.cu): one load round of a CTA
SUMSQ_FOLD_RATIO = 120   # one tile read in series (~0.47 us from the L2
                         # on an H100) over what one more CTA adds to the
                         # fold and the arrival counter (~3.9 ns), fitted
                         # to tools/kernel_sweep.py --only k5
STREAM_ROW_MAX = 4096    # rows one warp reads alone (kRowMax,
                         # csrc/stream_moments.cu)
STREAM_ROWS_PER_CTA = 4  # such rows a CTA (kWarps, csrc/stream_moments.cu)

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# library -> {entry point: (argtypes, restype)}
_ENTRY_POINTS = {
    "moments": {
        "moments_launch": ([_P, _LL, _LL, _I] + [_P] * 6, _I),
        "norm_launch": ([_P, _LL, _I] + [_P] * 5, _I),
    },
    "stream_moments": {
        "stream_moments_launch": ([_P, _LL, _LL, _P, _P, _P], _I),
    },
}
# (device index, stream, K) -> K1's arrival counters [K] int32: zeroed
# once, and 0 again after every launch.  Never freed, since a captured
# CUDA graph holds their address.
_ARRIVALS: Dict[Tuple[int, int, int], torch.Tensor] = {}


def moments_split(k: int, n: int) -> int:
    """Chunks each row of K1's [K, N] stack is split into, from (K, N)
    alone: as many as a grid of K x chunks CTAs holds in one wave
    (MOMENTS_CTAS_PER_SM on each SM), but at least MOMENTS_MIN_VEC float4s
    a chunk; a K that fills the wave alone keeps one chunk a row (no fold).
    The chunks hold ceil(ceil(N / 4) / chunks) float4s each, and none is
    empty."""
    nvec = -(-n // 4)
    c = max(1, min(_launch.SMS * MOMENTS_CTAS_PER_SM // k,
                   nvec // MOMENTS_MIN_VEC))
    per = -(-nvec // c)
    return -(-nvec // per)


def sumsq_split(n: int) -> int:
    """Chunks (CTAs) the single vector of the update norm is split into,
    from N alone.  Chunk j reads the tiles j, j + chunks, ... of
    SUMSQ_TILE float4s, so chunks of p tiles cost about p tile reads in
    series plus chunks / SUMSQ_FOLD_RATIO more for the fold: p =
    sqrt(tiles / SUMSQ_FOLD_RATIO), rounded, at least 1, and enough that
    the chunks fit one wave of CTAs (MOMENTS_CTAS_PER_SM on each SM).  So
    one CTA with no fold up to N = 4 SUMSQ_TILE, one tile a CTA at the
    Case-I round's N, and every chunk holds ceil(tiles / chunks) tiles or
    one fewer, none empty."""
    tiles = -(-(-(-n // 4)) // SUMSQ_TILE)
    wave = _launch.SMS * MOMENTS_CTAS_PER_SM
    per = max(1, round(math.sqrt(tiles / SUMSQ_FOLD_RATIO)), -(-tiles // wave))
    return -(-tiles // per)


def stream_moments_chunks(n: int) -> int:
    """Chunks each device row of the streamed moments is split into, from
    N alone: 1 for a row that one warp reads whole (N <= STREAM_ROW_MAX,
    csrc/stream_moments.cu), else two or more chunks of at most
    MOMENTS_CHUNK elements on K1's kernel (csrc/moments.cu), folded in a
    fixed order.  So neither K nor k_block changes how a device's sums are
    taken."""
    return 1 if n <= STREAM_ROW_MAX else max(2, -(-n // MOMENTS_CHUNK))


def _library(name: str) -> ctypes.CDLL:
    return _launch.bind(name, _ENTRY_POINTS[name])


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _arrivals(device: torch.device, stream: int, k: int) -> torch.Tensor:
    """K zeroed counters of this stream's K1 launches (zeroed on the
    stream itself, at first use)."""
    key = (device.index, stream, k)
    if key not in _ARRIVALS:
        _ARRIVALS[key] = torch.zeros((k,), dtype=torch.int32, device=device)
    return _ARRIVALS[key]


def _moments_split(g: torch.Tensor, nchunks: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's kernel with ``nchunks`` chunks a row: partials [K, nchunks],
    each device's folded in a fixed order by the block that finishes the
    row last."""
    lib = _library("moments")
    k, n = g.shape
    stream = _stream(g)
    with torch.cuda.device(g.device):
        part = torch.empty((2, k, nchunks), dtype=torch.float32,
                           device=g.device)
        out = torch.empty((2, k), dtype=torch.float32, device=g.device)
        arrivals = (_arrivals(g.device, stream, k).data_ptr()
                    if nchunks > 1 else None)
        err = lib.moments_launch(
            g.data_ptr(), k, n, nchunks, part[0].data_ptr(),
            part[1].data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            arrivals, stream)
    _launch.raise_on(err, lib.moments_error_string, "moments")
    return out[0], out[1]


def batched_moments_cuda(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of squares, sum) per row of a contiguous fp32 CUDA [K, N] stack,
    launched on the current stream (no synchronisation)."""
    _launch.check(g, 2, "g")
    return _moments_split(g, moments_split(*g.shape))


def streaming_moments_cuda(g: torch.Tensor, k_block: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of squares, sum) per row of a contiguous fp32 CUDA [K, N] stack,
    with the rows tiled into K-blocks of ``k_block`` (which must divide K,
    and changes no result); launched on the current stream.  Rows split
    into ``stream_moments_chunks(N)`` > 1 chunks take K1's kernels."""
    _launch.check(g, 2, "g")
    k, n = g.shape
    if not 1 <= k_block <= k or k % k_block:
        raise ValueError(f"k_block {k_block} must divide K {k}")
    nchunks = stream_moments_chunks(n)
    if nchunks > 1:
        return _moments_split(g, nchunks)
    lib = _library("stream_moments")
    with torch.cuda.device(g.device):
        out = torch.empty((2, k), dtype=torch.float32, device=g.device)
        err = lib.stream_moments_launch(
            g.data_ptr(), k, n, out[0].data_ptr(), out[1].data_ptr(),
            _stream(g))
    _launch.raise_on(err, lib.stream_moments_error_string, "stream_moments")
    return out[0], out[1]


def _norm(x: torch.Tensor) -> torch.Tensor:
    """[2]: the sum of squares of a contiguous fp32 CUDA vector and its
    root, from one launch of K1's kernel over one row in ``sumsq_split(N)``
    chunks (``norm_launch``), on the current stream."""
    _launch.check(x, 1, "x")
    lib = _library("moments")
    n = x.shape[0]
    nchunks = sumsq_split(n)
    stream = _stream(x)
    with torch.cuda.device(x.device):
        part = torch.empty((nchunks,), dtype=torch.float32, device=x.device)
        out = torch.empty((2,), dtype=torch.float32, device=x.device)
        arrivals = (_arrivals(x.device, stream, 1).data_ptr()
                    if nchunks > 1 else None)
        err = lib.norm_launch(x.data_ptr(), n, nchunks, part.data_ptr(),
                              out[0].data_ptr(), out[1].data_ptr(),
                              arrivals, stream)
    _launch.raise_on(err, lib.moments_error_string, "moments")
    return out


def sumsq_cuda(x: torch.Tensor) -> torch.Tensor:
    """0-d fp32 sum of squares of a contiguous fp32 CUDA vector, launched on
    the current stream."""
    return _norm(x)[0]


def norm_cuda(x: torch.Tensor) -> torch.Tensor:
    """0-d fp32 L2 norm of a contiguous fp32 CUDA vector: the root of
    ``sumsq_cuda(x)``, taken in the same launch."""
    return _norm(x)[1]
