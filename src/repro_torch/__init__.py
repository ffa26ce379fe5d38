"""PyTorch + CUDA port of the preemptive thread-block scheduling system.

The package mirrors ``src/repro``'s layout.  The JAX package stays the
reference: every ported function is tested against it on shared numpy
inputs.  This package imports ``torch`` and numpy only, never JAX or the
JAX package.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise rather than fall back (:func:`resolve_device`).
No function of the package sets the process's intra-op thread count for
longer than a block of :func:`intra_op_threads`: the caller's process owns
it.
"""

from __future__ import annotations

import contextlib
from typing import TYPE_CHECKING, Iterator, Union

if TYPE_CHECKING:
    import torch


def resolve_device(device: Union[str, "torch.device", None] = None
                   ) -> "torch.device":
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and this process has no CUDA device.  torch is imported here,
    not with the package, so the port's DES and sweep modules (and their
    fork pools) run without loading it.
    """
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "on the CPU")
    return dev


@contextlib.contextmanager
def intra_op_threads(n: int) -> Iterator[None]:
    """Run the block on ``n`` torch intra-op threads, then give back the
    count it found, also when the block raises.

    A small CPU operation wakes every intra-op thread.  Issued from
    several threads, or beside other processes that use every core, it
    then waits for them: on an 8-core host, ten reduced decode blocks
    under the lane executor ran 20 to 50 times slower on eight threads
    than on one.  torch is imported here, as in :func:`resolve_device`.
    """
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)
