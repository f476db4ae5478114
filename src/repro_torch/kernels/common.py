"""Device helper for the hand-written Hopper kernels.

Each CUDA source under ``repro_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface and loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds). The build
runs at first use, into ``build/kernels/`` at the repository root; all
sources compile in parallel, one ``nvcc`` process each. A library is rebuilt
when its source or a ``csrc`` header the source includes is newer.

Every C entry point returns ``cudaGetLastError()`` after its launch;
`check` raises when it is not 0. Wrappers count their launches in
`LAUNCHES` — one per kernel launch, nowhere else — so a run can show that
its main path went through the kernels. The count means launches executed:
a serving tick captured as a CUDA graph (`runtime.steps`) takes back what
its wrappers counted during the capture, which executes nothing, and adds
that one tick's launches on every replay.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# kernel name → CUDA source (one shared library each)
SOURCES = {
    "score_est": "score_est.cu",
    "flash_decode": "flash_decode.cu",
    "flash_prefill": "flash_prefill.cu",
    "flash_prefill_bwd": "flash_prefill_bwd.cu",
    "selection_fused": "selection_fused.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: Counter = Counter()
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names the
    CPU. Asking for CUDA on a machine without a card raises — there is no
    silent CPU fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run the plain versions")
    return dev


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _inputs(name: str) -> list[Path]:
    """The CUDA source of kernel library ``name`` and the ``csrc`` headers
    it includes (``#include "x.cuh"``, one level: headers include none)."""
    src = CSRC / SOURCES[name]
    return [src] + [CSRC / h for h in re.findall(r'^#include "([^"]+)"', src.read_text(),
                                                  flags=re.M)]


def _stale(name: str) -> bool:
    """The library is missing or older than its source or a header it includes."""
    lib = _lib_path(name)
    return not lib.exists() or any(lib.stat().st_mtime < p.stat().st_mtime
                                   for p in _inputs(name))


def build_kernels(names=None) -> float:
    """Compile the named kernels (default: all) that are missing or older
    than their source or its headers, all ``nvcc`` processes started
    together. Returns the wall seconds spent; raises with the compiler
    output on failure."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if _stale(n)]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    procs = {}
    for n in todo:
        tmp = BUILD_DIR / f"lib{n}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        BUILD_LOG[n] = out
        if p.returncode != 0:
            failed.append(f"--- {n} (exit {p.returncode}) ---\n{out}")
        else:
            os.replace(tmp, _lib_path(n))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.time() - t0


P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float


def load(name: str, fn: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``fn`` of kernel library ``name``, built on first
    use, with its argument types declared."""
    lib = _LIBS.get(name)
    if lib is None:
        build_kernels([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    f = getattr(lib, fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Wrapper-side validation before a pointer reaches a kernel."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
