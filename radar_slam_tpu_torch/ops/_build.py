"""Build, load and bind the package's CUDA sources (``csrc/*.cu``).

Each source is compiled once by ``nvcc`` into a shared library with a
plain C interface and loaded with ``ctypes`` -- no PyTorch headers, so a
build takes seconds.  Libraries land in ``radar_slam_tpu_torch/_build/``
(git-ignored), keyed by a hash of the source, every ``csrc`` header it
includes (transitively) and the flags, so an edited source or header is
rebuilt and a stale library is never loaded.  Nothing is built
at import time: the first call that needs a kernel builds it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (PATH or /usr/local/cuda)")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def sources(name: str, csrc: Path = CSRC_DIR) -> list:
    """``<csrc>/<name>.cu`` and every header it includes with quotes,
    transitively, in first-include order."""
    seen, todo = [], [csrc / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / m.decode()
                 for m in _INCLUDE.findall(path.read_bytes())]
    return seen


def library_path(name: str, csrc: Path = CSRC_DIR) -> Path:
    """Where the library built from ``<csrc>/<name>.cu`` lives: named by a
    hash of the source, its included headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name, csrc):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it.  The compiler's
    report (registers, shared memory, spills per kernel) is kept beside
    the library as ``.log``."""
    out = library_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) for "
                               f"{name}.cu:\n{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


@functools.lru_cache(maxsize=None)
def bind(name: str, symbol: str, argtypes: tuple):
    """The C function ``symbol`` of the library built from
    ``csrc/<name>.cu``, with its argument types set (``ctypes.c_void_p``
    for pointers and the stream, so no 64-bit value is cut) and an int
    (``cudaError_t``) result."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check_input(name: str, x: torch.Tensor, dtype: torch.dtype,
                device: torch.device, shape=None) -> None:
    """Raise unless ``x`` has ``dtype``, lies on ``device``, is contiguous
    and (when given) has ``shape``."""
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype} != {dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)} != {tuple(shape)}")


def launch(fn, *args) -> None:
    """Call a bound launcher; raise on a non-zero ``cudaError_t``."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError_t {err}")
