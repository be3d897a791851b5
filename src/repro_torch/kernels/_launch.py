"""What the kernel wrappers share: binding a kernel's library, the checks on
what a kernel takes, and the error a refused launch reports."""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.kernels import build

SMS = 132        # streaming multiprocessors of an H100 SXM: the card the
                 # split and grid choosers size their waves for

_BOUND: Dict[str, ctypes.CDLL] = {}


def bind(name: str, entry_points: Dict[str, Tuple[Sequence, object]]
         ) -> ctypes.CDLL:
    """The library of kernel ``name`` (built at first use), with
    ``argtypes``/``restype`` set for each of its ``entry_points``
    (``{function: (argtypes, restype)}``) and for its
    ``<name>_error_string``."""
    lib = _BOUND.get(name)
    if lib is None:
        lib = build.load(name)
        for fn, (args, res) in entry_points.items():
            getattr(lib, fn).argtypes = list(args)
            getattr(lib, fn).restype = res
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _BOUND[name] = lib
    return lib


def check(t: torch.Tensor, ndim: int, what: str,
          dtypes: Tuple[torch.dtype, ...] = (torch.float32,)) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of rank ``ndim``, of
    one of ``dtypes`` (fp32 alone by default), with no empty dimension: the
    only layout the kernels read."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype not in dtypes:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise ValueError(f"{what} must be {names}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what} must be {ndim}-D, got shape {tuple(t.shape)}")
    if t.numel() == 0:
        raise ValueError(f"{what} is empty (shape {tuple(t.shape)})")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if t.device.type != "cuda":
        raise ValueError(f"{what} is on {t.device}; the Hopper kernel needs a "
                         "CUDA tensor (CPU tensors take the plain version "
                         "through repro_torch.kernels.ops)")


def raise_on(err: int, error_string, kernel: str) -> None:
    """Raise if the C entry point returned a CUDA error code."""
    if err != 0:
        msg = error_string(err).decode(errors="replace")
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err} "
                           f"({msg})")
