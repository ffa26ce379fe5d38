"""Production mesh construction (``repro.launch.mesh``), as
``torch.distributed`` device meshes.

``make_production_mesh`` is a function (never a module-level constant), so
importing this module touches no process group.  The caller sets up the
process group first: ``torch.distributed.init_process_group`` with NCCL on
real cards, or a fake backend of 512 ranks for the dry-run
(:mod:`repro_torch.launch.dryrun`).

Mesh axes (the reference's names and shapes, so records compare cell for
cell):
* ``pod``   -- data parallelism across pods,
* ``data``  -- intra-pod data parallelism / FSDP shard axis,
* ``model`` -- tensor/expert/context parallel axis (16-way).
"""

from __future__ import annotations

import math
from typing import Tuple


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device_type: str):
    """A mesh over ranks 0 .. prod(shape) - 1 of the default group."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, have {world}; initialise a "
            f"process group of at least {n} ranks (a fake one for the "
            f"dry-run) or run on a real cluster")
    ranks = torch.arange(n, dtype=torch.int64).view(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_test_mesh(shape: Tuple[int, ...] = (2, 2),
                   axes: Tuple[str, ...] = ("data", "model"),
                   device_type: str = "cpu"):
    """Small mesh for tests (a fake or simulated process group of at least
    ``prod(shape)`` ranks on the CPU; NCCL on cards)."""
    return _mesh(shape, axes, device_type)


def batch_axes_of(mesh) -> Tuple[str, ...]:
    names = tuple(mesh.mesh_dim_names)
    return tuple(a for a in ("pod", "data") if a in names)
