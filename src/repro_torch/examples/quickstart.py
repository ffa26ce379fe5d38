"""Quickstart: the paper's idea in a minute (``examples/quickstart.py`` of
the JAX package).

1. Build a reduced model from the zoo and train it for a few steps.
2. Time ONE step and predict the whole job's runtime with the Staircase
   model (Eq. 1) -- structural runtime prediction.
3. Compare the prediction against the actual runtime.

Every arch of the zoo runs here at ``.reduced()`` (head dim 32; reduced
MLA's qk 48 padded to 64 beside v 32): on the card through the flash
forward and backward kernels and, for mamba2-2.7b and recurrentgemma-2b,
the SSD and RG-LRU scans and their backwards.  Each step's time runs to a
``torch.cuda.synchronize()``, the reference's ``block_until_ready``; step
0 includes the kernels' first-use build and load, where the reference's
includes its JIT compile.

Run::

    PYTHONPATH=src python -m repro_torch.examples.quickstart \\
        [--arch yi-6b] [--steps 12] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Iterable, Optional, Sequence

import torch

from .. import resolve_device
from ..configs import ARCHS, get_arch
from ..configs.shapes import InputShape
from ..core.jobs import _sync
from ..core.predictor import staircase_runtime
from ..data import pipeline as data
from ..launch.steps import StepBundle, build_train_step
from ..models import lm
from ..optim import adamw
from ..tree import leaves

#: The reference quickstart's batch: 4 sequences of 64 tokens.
SHAPE = InputShape("quickstart", seq_len=64, global_batch=4, kind="train")


def opt_config(steps: int) -> adamw.OptConfig:
    """The reference quickstart's optimizer settings for a run of
    ``steps`` steps."""
    return adamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=steps)


def run_steps(bundle: StepBundle, params: Dict, opt: Dict,
              batches: Iterable[Dict[str, torch.Tensor]], steps: int,
              device: torch.device) -> Dict:
    """Train one step a batch, printing each step's nll and time; step 1
    is the sampled "thread block" whose time predicts the other
    ``steps - 1``.  Returns ``{"nll": [...], "ms": [...], "dt_1": s,
    "predicted_s": s or None, "wall_s": s}``."""
    nll, ms = [], []
    dt_1 = predicted = None
    t_job0 = time.perf_counter()
    for step, batch in enumerate(batches):
        t0 = time.perf_counter()
        params, opt, metrics = bundle.fn(params, opt, batch)
        _sync(device)
        dt = time.perf_counter() - t0
        if step == 1:   # steady-state sample: one "thread block"
            dt_1 = dt
            predicted = staircase_runtime(steps - 1, 1, dt)
            print(f"[staircase] t={dt * 1e3:.1f} ms/step -> predicted "
                  f"{predicted:.2f}s for the remaining {steps - 1} steps")
        nll.append(float(metrics["nll"]))
        ms.append(dt * 1e3)
        print(f"step {step}: nll={nll[-1]:.4f} ({dt * 1e3:.0f} ms)")
    return {"nll": nll, "ms": ms, "dt_1": dt_1, "predicted_s": predicted,
            "wall_s": time.perf_counter() - t_job0}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Train ``--arch`` reduced for ``--steps`` steps; returns
    :func:`run_steps`' record."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-6b", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless asked; no fallback)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_arch(args.arch).reduced()
    bundle = build_train_step(cfg, SHAPE, mesh=None, remat=False,
                              opt_cfg=opt_config(args.steps))
    params = lm.init(cfg, seed=0, device=device, dtype=torch.float32,
                     stacked=True)
    for p in leaves(params):
        p.requires_grad_()
    opt = adamw.init(params)

    n = sum(p.numel() for p in leaves(params))
    print(f"arch={args.arch} (reduced: {n / 1e6:.1f}M params) on {device}")
    batches = (data.batch_for_step(cfg, SHAPE, step, device=device)
               for step in range(args.steps))
    run = run_steps(bundle, params, opt, batches, args.steps, device)
    if run["predicted_s"]:
        # compare against the steady-state portion (on the card, step 0
        # builds and loads the kernels on first use)
        first = ("the kernels' first-use build and load"
                 if device.type == "cuda" else "first-call set-up")
        print(f"[staircase] total wall {run['wall_s']:.2f}s (step 0 "
              f"includes {first}); prediction for the sampled portion was "
              f"{run['predicted_s']:.2f}s -- see benchmarks/fig04 for the "
              f"calibrated accuracy study")
    return run


if __name__ == "__main__":
    main()
