"""PyTorch + CUDA port of the preemptive thread-block scheduling system.

The package mirrors ``src/repro``'s layout.  The JAX package stays the
reference: every ported function is tested against it on shared numpy
inputs.  This package imports ``torch`` and numpy only, never JAX or the
JAX package.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise rather than fall back (:func:`resolve_device`).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Union

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
