"""Step-function builders (``repro.launch.steps``): the train step only,
on one device.  The sharded steps and the prefill and decode builders
come with the sharding slice.

A training job is N repetitions of this step, so profiling the first
steady invocation (the paper's structural runtime prediction) predicts
the job.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..configs.base import ArchConfig
from ..configs.shapes import InputShape
from ..models import lm
from ..optim import adamw
from ..tree import leaves


@dataclass
class StepBundle:
    """A step function and what it is."""

    fn: Callable                  # (params, opt_state, batch) -> (p, o, m)
    kind: str


def build_train_step(cfg: ArchConfig, shape: InputShape, mesh=None,
                     opt_cfg: adamw.OptConfig = adamw.OptConfig(),
                     backend: str = "kernel", remat: bool = True,
                     microbatches: Optional[int] = None) -> StepBundle:
    """One optimizer step over ``M`` microbatches (``microbatches``, 1 by
    default, as the reference picks for one device): the gradients of
    each are summed in fp32, each divided by M, before one AdamW update.
    The params are the stacked tree with ``requires_grad`` set
    (``lm.init(..., stacked=True)``); the step updates them and the
    optimizer state in place and returns them with the metrics ``nll``,
    ``aux``, ``z`` (of the last microbatch), ``grad_norm`` and ``lr``, as
    0-d tensors on the device."""
    if mesh is not None:
        raise NotImplementedError(
            "build_train_step: sharded steps (a mesh) come with the "
            "sharding slice; the port trains on one device")
    M = microbatches if microbatches is not None else 1
    if shape.global_batch % max(M, 1):
        M = 1

    def grads_of(params, batch):
        ps = leaves(params)
        total, metrics = lm.loss_fn(cfg, params, batch, backend=backend,
                                    remat=remat)
        return torch.autograd.grad(total, ps), metrics

    def train_step(params, opt_state, batch):
        ps = leaves(params)
        if M <= 1:
            grads, metrics = grads_of(params, batch)
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in ps]
            for i in range(M):
                mb = {k: v.chunk(M, dim=0)[i] for k, v in batch.items()}
                g, metrics = grads_of(params, mb)
                for acc, gi in zip(grads, g):
                    acc.add_(gi.float() / M)
        # grads and leaves in the order of the state's m and v
        _, opt_state, stats = adamw.update(list(grads), opt_state, ps,
                                           opt_cfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, dict(metrics, **stats)

    return StepBundle(train_step, "train")
