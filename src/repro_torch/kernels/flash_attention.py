"""Flash attention on the card: the wrapper of K6's two bodies, the Hopper
port of ``repro/kernels/flash_attention.py``'s ``flash_attention_blocked``.
bf16 runs ``csrc/flash_attention_wgmma.cu`` (the tensor cores through
wgmma, TMA copies, warp-specialised; ``sm_90a`` only) and fp32 runs
``csrc/flash_attention.cu`` (the tensor cores through mma.sync in 3xTF32:
each product as three TF32 products, fp32-accurate); ``BODIES`` names
them.

``flash_attention_cuda(q, k, v, causal=, window=)`` takes q [B, H, Sq, d]
and k, v [B, Hkv, Skv, d] (Hkv dividing H: grouped-query attention reads
kv head ``h // (H // Hkv)``, with no expanded copy), all contiguous bf16 or
all contiguous fp32 on one CUDA device, d a multiple of 8 up to 128, any
Sq and Skv (the kernel masks the ragged tails).  It returns o [B, H, Sq, d]
in the input type, computed with fp32 scores, running max, denominator and
accumulator.  Public callers go through ``repro_torch.kernels.ops``, which
counts the launches and serves CPU tensors with the plain version.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _launch

DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128
# dtype -> (library, the body's name in chip_smoke.py's rows)
BODIES = {torch.bfloat16: ("flash_attention_wgmma", "wgmma_tma"),
          torch.float32: ("flash_attention", "tf32x3_mma")}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P], _I)
_INT_MAX = 2 ** 31 - 1
_GRID_YZ_MAX = 65_535


def _bind(dtype: torch.dtype):
    """(library name, the bound library) of the body that runs ``dtype``;
    both bodies export ``<name>_launch`` with one signature."""
    name = BODIES[dtype][0]
    return name, _launch.bind(name, {
        f"{name}_launch": _ARGS,
        f"{name}_smem_bytes": ([_I], ctypes.c_longlong)})


def smem_bytes(dtype: torch.dtype, d: int) -> int:
    """Dynamic shared memory of the ``dtype`` body's launch at head dim
    ``d`` (builds and loads the body's library)."""
    name, lib = _bind(dtype)
    return int(getattr(lib, f"{name}_smem_bytes")(d))


def check_window(window: Optional[int]) -> None:
    if window is not None and (isinstance(window, bool)
                               or not isinstance(window, int) or window < 1):
        raise ValueError(f"window must be None or an int >= 1, got {window!r}")


def check_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q [B, H, Sq, d] and k, v [B, Hkv, Skv, d] fit together
    (Hkv dividing H): what both the kernel and its plain version take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-D [B, H, S, d], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head dim")
    if k.shape[1] < 1 or h % k.shape[1]:
        raise ValueError(f"{k.shape[1]} kv heads do not divide {h} query "
                         "heads")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """o = softmax(q k^T / sqrt(d) + mask) v, launched on the current stream
    (no synchronisation); see the module docstring for what it takes."""
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        _launch.check(t, 4, what, DTYPES)
        if t.data_ptr() % 16:
            raise ValueError(f"{what} must start on a 16-byte boundary")
    check_heads(q, k, v)
    check_window(window)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share one dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} must be a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}")
    if b > _GRID_YZ_MAX or h > _GRID_YZ_MAX or max(sq, skv) > _INT_MAX:
        raise ValueError(f"shape {tuple(q.shape)} / {tuple(k.shape)} exceeds "
                         "the kernel's grid")
    # skipping kv tiles outside the band is exact only while every row has
    # a key inside it (the .cu file's note); with Sq > Skv it visits all
    skip = int(sq <= skv)
    name, lib = _bind(q.dtype)
    with torch.cuda.device(q.device):
        o = torch.empty_like(q)
        err = getattr(lib, f"{name}_launch")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, hkv,
            sq, skv, d, int(causal), window or 0, skip, 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    _launch.raise_on(err, getattr(lib, f"{name}_error_string"), name)
    return o
