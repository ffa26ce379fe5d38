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

Each kernel is also an operator of the ``repro_torch`` namespace
(``torch.ops.repro_torch.<name>``, :func:`define_op`): its CUDA
implementation is the ctypes launch, its CPU implementation the plain
version (for ``torch.library.opcheck``; the model's ops route CPU tensors
to the plain versions directly), its fake implementation allocates what a
launch allocates without a device (the dry-run traces through it, sizing
launch plans for :data:`H100_SMS` SMs and reporting scratch through
:func:`fake_scratch`), and its flop formula is registered with
``torch.utils.flop_counter``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

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
                 shape: Tuple[int, ...], device: torch.device,
                 real: bool = True) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor on ``device`` with
    this dtype and shape: what a kernel's raw pointer arguments assume.
    ``real`` False (a fake implementation) leaves out the device type."""
    if real and t.device.type != "cuda":
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


#: The kernels' operator namespace, the package's name:
#: ``torch.ops.repro_torch.<name>`` (another tree's copy imported beside
#: this one under another package name registers ops of its own).
NAMESPACE = __package__.split(".")[0]
#: SMs of the card the kernels are built for (an NVIDIA H100 SXM5): what
#: a fake implementation plans a launch for, having no device to ask.  A
#: real launch asks its device.
H100_SMS = 132

_op_lib: Optional[torch.library.Library] = None
_scratch_watchers: List[Callable[[List[torch.Tensor]], None]] = []


def define_op(name: str, schema: str, *, cuda: Callable, cpu: Callable,
              fake: Callable, flops: Callable):
    """Define ``repro_torch::<name><schema>`` with its CUDA, CPU and fake
    implementations and its flop formula (``flops(*shapes, out_shape=)``
    in ``torch.utils.flop_counter``'s form), and return the op's overload.
    The low-level ``torch.library`` API: no Python autograd layer sits on
    the call (the model's autograd functions call the ops), which keeps
    the per-call host time of the serving path's launches small."""
    from torch.utils.flop_counter import register_flop_formula

    global _op_lib
    if _op_lib is None:
        _op_lib = torch.library.Library(NAMESPACE, "DEF")
    _op_lib.define(name + schema)
    _op_lib.impl(name, cuda, "CUDA")
    _op_lib.impl(name, cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_op_lib)
    packet = getattr(getattr(torch.ops, NAMESPACE), name)
    register_flop_formula(packet)(flops)
    return packet.default


def nothing(like: torch.Tensor) -> torch.Tensor:
    """The empty fp32 tensor an op returns for an output that was not
    asked for (an op returns tensors, never None): no bytes allocated."""
    return like.new_empty((0,), dtype=torch.float32)


def fake_scratch(*tensors: Optional[torch.Tensor]) -> None:
    """Hand the scratch a fake implementation allocated (what its launch
    allocates beside its outputs and frees when it returns; None entries
    skipped) to whoever watches (:func:`watch_scratch`: the dry-run adds
    its bytes to the peak at the op)."""
    got = [t for t in tensors if t is not None]
    for watcher in _scratch_watchers:
        watcher(got)


@contextlib.contextmanager
def watch_scratch(watcher: Callable[[List[torch.Tensor]], None]):
    """Call ``watcher(tensors)`` with every fake implementation's scratch
    while the context is open."""
    _scratch_watchers.append(watcher)
    try:
        yield
    finally:
        _scratch_watchers.remove(watcher)
