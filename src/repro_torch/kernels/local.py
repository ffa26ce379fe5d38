"""Plain local tensors for the kernels under a mesh.

Under a device mesh the model's tensors are DTensors; every kernel call
goes through ``local_map`` (:mod:`repro_torch.sharding.calls`), which hands
the wrapped function each rank's local tensors.  On a real process group
those are plain tensors.  Under ``LocalTensorMode`` (one process
simulating every rank, with real values: the CPU tests) they are
LocalTensors, one plain tensor per rank inside; :func:`each_rank` runs a
function once per simulated rank on those plain tensors and joins the
results, so a kernel (or its plain version) only ever sees plain tensors,
and a function that depends on the rank (a query offset, the slice of a
sequence-sharded cache) gets that rank.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

try:                                    # simulated ranks (CPU tests)
    from torch.distributed._local_tensor import LocalTensor, local_tensor_mode
except ImportError:                     # pragma: no cover - older torch
    LocalTensor = None

    def local_tensor_mode():
        return None


def this_rank() -> int:
    """This process's rank in the default group (0 without one)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def coordinate(mesh, rank: int) -> Dict[str, int]:
    """``{axis: index}`` of global ``rank`` on ``mesh`` (read on the host,
    so it runs under a fake-tensor mode too)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():
        ranks = mesh.mesh.numpy()
    where = np.argwhere(ranks == rank)
    if where.shape[0] != 1:
        raise ValueError(f"rank {rank} is not on the mesh")
    return dict(zip(mesh.mesh_dim_names, (int(i) for i in where[0])))


def _is_local(t) -> bool:
    return LocalTensor is not None and isinstance(t, LocalTensor)


def each_rank(fn: Callable, *args):
    """``fn(rank, *args)`` on plain tensors.

    Where ``args`` hold LocalTensors (under ``LocalTensorMode``), ``fn``
    runs once per simulated rank with that rank's tensors, the mode off,
    and each tensor it returns (alone or in a tuple; ``None`` stays
    ``None``) is joined into a LocalTensor.  A function that only writes
    into its tensors in place returns None.  Otherwise ``fn`` runs once
    with this process's rank.  ``fn`` must not run collectives.
    """
    mode = local_tensor_mode()
    if mode is None or not any(_is_local(a) for a in args):
        return fn(this_rank(), *args)
    outs = {}
    with mode.disable():
        for r in sorted(mode.ranks):
            outs[r] = fn(r, *(a._local_tensors[r] if _is_local(a) else a
                              for a in args))
    first = outs[min(outs)]
    if first is None:
        return None
    if isinstance(first, tuple):
        return tuple(None if first[i] is None
                     else LocalTensor({r: o[i] for r, o in outs.items()})
                     for i in range(len(first)))
    return LocalTensor(outs)

