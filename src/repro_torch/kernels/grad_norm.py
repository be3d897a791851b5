"""Reductions of flat gradients on the card: the wrappers of
``csrc/moments.cu``, ``csrc/stream_moments.cu`` and ``csrc/sumsq.cu``, the
Hopper ports of ``repro/kernels/grad_norm.py``'s ``batched_blocked_moments``,
``streaming_blocked_moments`` and ``blocked_sumsq``.

``batched_moments_cuda(g)`` and ``streaming_moments_cuda(g, k_block)`` read
the [K, N] fp32 stack in place (no padding copy) and return
``(sumsq, sums)``, each [K] fp32, summed in a fixed order;
``sumsq_cuda(x)`` returns the 0-d sum of squares of one flat vector.
``stream_moments_chunks(n)`` is the number of chunks the streamed moments
split each row into.
Public callers go through ``repro_torch.kernels.ops``, which counts the
launches and serves CPU tensors with the plain versions.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _launch

MOMENTS_CHUNK = 4096     # elements a chunk of csrc/moments.cu (kChunkVec * 4)
STREAM_ROW_MAX = 4096    # rows one warp reads alone (kRowMax,
                         # csrc/stream_moments.cu)
STREAM_ROWS_PER_CTA = 4  # such rows a CTA (kWarps, csrc/stream_moments.cu)

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# library -> {entry point: (argtypes, restype)}
_ENTRY_POINTS = {
    "moments": {
        "moments_num_chunks": ([_LL], _I),
        "moments_launch": ([_P, _LL, _LL, _I, _P, _P, _P, _P, _P], _I),
    },
    "stream_moments": {
        "stream_moments_launch": ([_P, _LL, _LL, _P, _P, _P], _I),
    },
    "sumsq": {
        "sumsq_num_partials": ([_LL], _I),
        "sumsq_launch": ([_P, _LL, _I, _P, _P, _P], _I),
    },
}


def stream_moments_chunks(n: int) -> int:
    """Chunks each device row of the streamed moments is split into, from
    N alone: 1 for a row that one warp reads whole (N <= STREAM_ROW_MAX,
    csrc/stream_moments.cu), else K1's chunks of MOMENTS_CHUNK elements
    (csrc/moments.cu), added in chunk order by a second pass.  So neither
    K nor k_block changes how a device's sums are taken."""
    return 1 if n <= STREAM_ROW_MAX else -(-n // MOMENTS_CHUNK)


def _library(name: str) -> ctypes.CDLL:
    return _launch.bind(name, _ENTRY_POINTS[name])


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _moments_split(g: torch.Tensor, nchunks: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's two passes: partials [K, nchunks], then each device's partials
    added in chunk order."""
    lib = _library("moments")
    k, n = g.shape
    with torch.cuda.device(g.device):
        part = torch.empty((2, k, nchunks), dtype=torch.float32,
                           device=g.device)
        out = torch.empty((2, k), dtype=torch.float32, device=g.device)
        err = lib.moments_launch(
            g.data_ptr(), k, n, nchunks, part[0].data_ptr(),
            part[1].data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            _stream(g))
    _launch.raise_on(err, lib.moments_error_string, "moments")
    return out[0], out[1]


def batched_moments_cuda(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of squares, sum) per row of a contiguous fp32 CUDA [K, N] stack,
    launched on the current stream (no synchronisation)."""
    _launch.check(g, 2, "g")
    return _moments_split(g, _library("moments").moments_num_chunks(
        g.shape[1]))


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
        if nchunks != _library("moments").moments_num_chunks(n):
            raise RuntimeError("MOMENTS_CHUNK does not match csrc/moments.cu")
        return _moments_split(g, nchunks)
    lib = _library("stream_moments")
    with torch.cuda.device(g.device):
        out = torch.empty((2, k), dtype=torch.float32, device=g.device)
        err = lib.stream_moments_launch(
            g.data_ptr(), k, n, out[0].data_ptr(), out[1].data_ptr(),
            _stream(g))
    _launch.raise_on(err, lib.stream_moments_error_string, "stream_moments")
    return out[0], out[1]


def sumsq_cuda(x: torch.Tensor) -> torch.Tensor:
    """0-d fp32 sum of squares of a contiguous fp32 CUDA vector, launched on
    the current stream."""
    _launch.check(x, 1, "x")
    lib = _library("sumsq")
    nparts = lib.sumsq_num_partials(x.shape[0])
    with torch.cuda.device(x.device):
        part = torch.empty((nparts,), dtype=torch.float32, device=x.device)
        out = torch.empty((), dtype=torch.float32, device=x.device)
        err = lib.sumsq_launch(x.data_ptr(), x.shape[0], nparts,
                               part.data_ptr(), out.data_ptr(), _stream(x))
    _launch.raise_on(err, lib.sumsq_error_string, "sumsq")
    return out
