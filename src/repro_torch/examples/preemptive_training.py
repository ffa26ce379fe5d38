"""End-to-end training with preemption and restart
(``examples/preemptive_training.py`` of the JAX package).

Trains a ~100M-parameter llama-style model (the yi family at d 640, 10
heads / 2 KV of 64, 10 layers) with the whole stack: the seekable
synthetic data pipeline, AdamW, asynchronous checkpoints.  Part way
through, the job is preempted (as the SRTF scheduler or a node failure
would); training resumes from the latest checkpoint and the structural
predictor re-estimates the remaining runtime from one post-restart step (a
new "slice", Section 4 of the paper).  Its head dims (64, 64) are a pair
both flash kernels take, so on the card every attention layer runs the
forward and backward kernels.

Run::

    PYTHONPATH=src python -m repro_torch.examples.preemptive_training \\
        [--steps 200] [--preempt-at 0.4] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import torch

from .. import resolve_device
from ..checkpoint.checkpointer import Checkpointer
from ..configs import get_arch
from ..configs.shapes import InputShape
from ..core.jobs import _sync
from ..core.predictor import staircase_runtime
from ..data import pipeline as data
from ..launch.steps import build_train_step
from ..models import lm
from ..optim import adamw
from ..tree import leaves


def model_100m():
    # yi-family block at ~100M params: 2*V*D + L*(4*D*hd*H-ish + 3*D*F)
    return dataclasses.replace(
        get_arch("yi-6b"), arch_id="yi-100m",
        d_model=640, n_layers=10, n_heads=10, n_kv_heads=2, d_ff=1712,
        vocab_size=49152)


def run_segment(cfg, shape, bundle, ck, start, stop, seed, label,
                device) -> List[Dict]:
    """Train steps ``start``..``stop`` (from the latest checkpoint, if
    any), checkpointing every 25 steps and at the end.  Returns each
    step's {"step", "nll", "ms"}."""
    params = lm.init(cfg, seed=seed, device=device, dtype=torch.float32,
                     stacked=True)
    for p in leaves(params):
        p.requires_grad_()
    opt = adamw.init(params)
    step = 0
    if ck.latest_step() is not None:
        step, state, _ = ck.restore({"params": params, "opt": opt})
        params, opt = state["params"], state["opt"]
        print(f"[{label}] restored checkpoint at step {step}")
    t_sample = None
    records = []
    for s in range(max(step, start), stop):
        batch = data.batch_for_step(cfg, shape, s, device=device)
        t0 = time.perf_counter()
        params, opt, metrics = bundle.fn(params, opt, batch)
        _sync(device)
        dt = time.perf_counter() - t0
        records.append({"step": s, "nll": float(metrics["nll"]),
                        "ms": dt * 1e3})
        if t_sample is None and s > max(step, start):
            t_sample = dt
            pred = staircase_runtime(stop - s, 1, dt)
            print(f"[{label}] predictor: t={dt:.3f}s/step -> "
                  f"~{pred:.1f}s to finish this segment")
        if s % 20 == 0:
            print(f"[{label}] step={s} nll={records[-1]['nll']:.4f} "
                  f"({dt:.3f}s)")
        if (s + 1) % 25 == 0:
            ck.save(s + 1, {"params": params, "opt": opt}, {"seg": label})
    ck.save(stop, {"params": params, "opt": opt}, {"seg": label})
    ck.wait()
    return records


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, List[Dict]]:
    """Run both segments; returns ``{"seg1": records, "seg2": records}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--preempt-at", type=float, default=0.4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless asked; no fallback)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = model_100m()
    n = cfg.n_params()
    print(f"model: {n / 1e6:.0f}M params, {cfg.n_layers}L d={cfg.d_model}")
    shape = InputShape("train100m", args.seq, args.batch, "train")
    bundle = build_train_step(
        cfg, shape, mesh=None, remat=False,
        opt_cfg=adamw.OptConfig(lr=6e-4, warmup_steps=20,
                                total_steps=args.steps))

    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, keep=2)
        cut = int(args.steps * args.preempt_at)
        print(f"== segment 1: steps 0..{cut}, then PREEMPT ==")
        seg1 = run_segment(cfg, shape, bundle, ck, 0, cut, 0, "seg1",
                           device)
        print("== preempted (scheduler hand-off / node loss) ==")
        print("== segment 2: resume from checkpoint and finish ==")
        seg2 = run_segment(cfg, shape, bundle, ck, 0, args.steps, 0, "seg2",
                           device)
        print("done: training survived preemption with step-granular state.")
    return {"seg1": seg1, "seg2": seg2}


if __name__ == "__main__":
    main()
