"""Build the Hopper kernels with ``nvcc`` at first use and load them with
``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), under
``build/kernels/`` at the root of the checkout.  The file name carries a hash
of the source and the flags, so an edited source rebuilds and an unchanged
one is loaded as it is.  ``build_all`` starts one ``nvcc`` per source, all
together.

Nothing here runs at import time: this module is imported on hosts with no
``nvcc`` and no card (the CPU tests), where only ``load`` would fail.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = {"moments": "moments.cu", "ota_superpose": "ota_superpose.cu",
           "stream_moments": "stream_moments.cu",
           "flash_attention": "flash_attention.cu",
           "flash_attention_wgmma": "flash_attention_wgmma.cu",
           "selective_scan": "selective_scan.cu",
           "channel_noise": "channel_noise.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the "
                       "Hopper kernels are compiled on the machine with the "
                       "card")


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` lives for the current source."""
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def log_path(name: str) -> Path:
    """The compiler's output (ptxas register/shared-memory report)."""
    return library_path(name).with_suffix(".log")


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """ptxas's report of kernel ``name``'s built library, by entry function
    (mangled name): registers, static shared memory, stack and spill
    bytes."""
    return parse_ptxas(log_path(name).read_text())


def parse_ptxas(log: str) -> Dict[str, Dict[str, int]]:
    """The per-entry report in the text of an ``nvcc -Xptxas -v`` run."""
    out: Dict[str, Dict[str, int]] = {}
    entry = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = out.setdefault(m.group(1), {"registers": 0, "smem": 0,
                                                "stack": 0, "spill_stores": 0,
                                                "spill_loads": 0})
            continue
        if entry is None:
            continue
        for key, pat in (("stack", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers"),
                         ("smem", r"(\d+) bytes smem")):
            m = re.search(pat, line)
            if m:
                entry[key] = int(m.group(1))
    return out


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every kernel of ``names`` (default: all) that has no library
    for its current source yet, one ``nvcc`` per source, started together.
    Returns the seconds each build took (0.0 for a library already built).
    Raises ``RuntimeError`` with the compiler output if a build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    took = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            took[name] = 0.0
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
