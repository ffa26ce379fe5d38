"""AdamW with global-norm clipping and LR schedules, on tensors
(``repro.optim.adamw``, rewritten for PyTorch).

The state mirrors the parameters' tree (:mod:`repro_torch.tree`): ``m``
and ``v`` (fp32, like the reference's) and ``step`` (a 0-d int32 tensor).
:func:`update` works in place under ``torch.no_grad()``: parameters, ``m``
and ``v`` are overwritten (the reference returns new trees; in place
keeps one copy of each on the card).  Each leaf is updated in fp32 in the
reference's order of operations.  Weight decay applies to every leaf with
two or more dimensions *of the stacked tree* that training holds
(``params_from_numpy(..., stacked=True)``): a stage's norm scales
``[L, d]`` and biases are decayed, ``final_norm`` ``[d]`` is not, exactly
as the reference decides on its stacked pytree.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..tree import leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"      # cosine|linear|constant


def schedule_lr(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor; fp32 result on its
    device): linear warm-up, then the schedule's decay."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - frac
    else:
        decay = torch.ones_like(frac)
    return cfg.lr * warm * decay


def init(params) -> Dict:
    """Zero ``m`` and ``v`` in fp32 beside every leaf, ``step`` 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


@torch.no_grad()
def update(grads, state: Dict, params, cfg: OptConfig) -> Tuple:
    """One AdamW step: returns (params, state, {"grad_norm", "lr"}), the
    params and the state updated in place (the same objects)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.clip_norm > 0 \
        else torch.ones((), device=gnorm.device)
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        mh = m / bc1
        vh = v / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        if cfg.weight_decay > 0 and p.dim() >= 2:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
