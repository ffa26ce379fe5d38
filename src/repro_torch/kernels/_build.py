"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds).  Libraries live in ``_cuda_build/`` beside this file (listed in
``.gitignore``), named by a hash of the source text and the compiler
flags, so an edited source is rebuilt and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source at once and waits for
all of them.

A failed build raises :class:`KernelBuildError` carrying the compiler's
output; nothing falls back to another implementation.  Nothing is built
or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_cuda_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


def sources() -> List[str]:
    """Names (file stems) of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc_path() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built from source at first use")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start ``nvcc`` for one source unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)               # atomic: readers never see a partial


def build_all() -> Dict[str, str]:
    """Build every kernel source, all ``nvcc`` processes in parallel.

    Returns ``{name: compiler output}`` (``-Xptxas -v`` register and spill
    report; empty for a library that was already built).
    """
    with _lock:
        procs = {name: _start(name) for name in sources()}
        errors = []
        for name, proc in procs.items():
            if proc is None:
                continue
            try:
                _finish(name, proc)
            except KernelBuildError as exc:
                errors.append(str(exc))
        if errors:
            raise KernelBuildError("\n".join(errors))
    return {name: (BUILD_DIR / f"{name}.log").read_text()
            if procs[name] is not None else "" for name in procs}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            proc = _start(name)
            if proc is not None:
                _finish(name, proc)
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (every source exports
    ``error_string``, a wrapper of ``cudaGetErrorString``)."""
    if status != 0:
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        msg = lib.error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: Tuple[int, ...], device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor on ``device`` with
    this dtype and shape: what a kernel's raw pointer arguments assume."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_plain(name: str, *tensors) -> None:
    """Raise ``TypeError`` if a tensor subclass (a DTensor, a LocalTensor,
    a fake tensor) would reach the ctypes launch of kernel ``name``: a
    launch takes the storage of plain device tensors.  Under a mesh the
    kernels run inside ``local_map`` on each rank's local tensors
    (:mod:`repro_torch.kernels.local`)."""
    for t in tensors:
        if t is not None and type(t) not in (torch.Tensor,
                                             torch.nn.Parameter):
            raise TypeError(
                f"{name}: got a {type(t).__name__}; the kernel takes plain "
                f"tensors (run it inside local_map under a mesh)")
