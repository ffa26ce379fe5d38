"""End-to-end training driver of the port (``repro.launch.train``).

Single-job mode (default): train one architecture for N steps with the
whole stack -- the seekable synthetic data pipeline, AdamW, asynchronous
checkpoints, restart (``--resume``), and step-time telemetry feeding the
structural predictor's staircase estimate of the job's completion.

Multi-job mode (``--jobs a:n,b:m,...``): the paper's scenario, concurrent
training jobs scheduled on the lane executor under ``--policy``
(fifo|mpmax|srtf|srtf-adaptive), preempted at step boundaries.

Unlike the JAX driver, which trains reduced configs unless ``--full``, the
model runs at its full published width unless ``--reduced`` is given, on
``cuda`` unless ``--device cpu`` is.  ``--n-layers N`` cuts the chosen
config's depth (``dataclasses.replace``, as the reference's training
example builds its model; an encoder's depth alike): the reference keeps
fp32 weights and fp32
AdamW moments, 16 bytes a parameter with the gradients, so full yi-6b
(6.06 B parameters, 97 GB) does not fit one 80 GB card and trains there
at ``--n-layers 12`` (2.6 B parameters, 41.6 GB of state) with every
width kept.  On the card all five decoder families train: dense GQA
(yi-6b, yi-34b, mistral-nemo-12b; head dim 128), Mamba-2 (mamba2-2.7b,
through the SSD backward kernel; all 64 layers peak at ~71 GiB at B 4 x
1024, ``--n-layers 56`` at ~62 GiB), the RG-LRU / local-attention hybrid
(recurrentgemma-2b, all 26 layers, through the RG-LRU backward kernel
and the flash backward at head dim 256), MLA (minicpm3-4b: 60.7 GiB of
fp32 state at all 62 layers, ``--n-layers 40`` peaks at ~58.5 GiB; the
flash backward at qk 96 padded to 128 beside v 64) and MLA + MoE
(deepseek-v2-lite-16b: 241.6 GiB of state at 27 layers, ``--n-layers 5``,
one dense and four MoE layers, peaks at ~58.9 GiB; the flash backward at
(192, 128)); minicpm3-4b at 48 layers and deepseek-v2-lite-16b at 6 ran
out of memory on an 80 GB card.  whisper-large-v3 trains every layer
(32 encoder and 32 decoder, 1.60 B parameters; ~52 GiB at B 4 x (1024
tokens + 1536 frames)), the flash backward at (64, 64) for the encoder,
the decoder's self attention and cross attention.  pixtral-12b's
embedding and head alone hold 21.5 GB of state: ``--n-layers 6`` peaks
at ~59.5 GiB at B 4 x (1024 patches + 1024 tokens), 8 at ~67.6 GiB.  A
sequence is its patches, then its text, so ``--seq`` must leave at least
two text tokens (``ValueError`` otherwise): pixtral takes ``--seq 2048``
for 1024 tokens.  With ``--reduced`` every arch of the zoo, dbrx-132b
included, trains on the card through the kernels: the flash forward and
backward at head dim 32 (reduced MLA's qk 48 padded to 64 beside v 32),
the SSD and RG-LRU scans and their backwards.

Examples::

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \\
        --n-layers 12 --steps 6 --batch 4 --seq 1024 \\
        --checkpoint-dir /tmp/ck --checkpoint-every 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \\
        --n-layers 12 --steps 6 --batch 4 --seq 1024 \\
        --checkpoint-dir /tmp/ck --resume
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --jobs yi-6b:8,yi-6b:2 --n-layers 2 --batch 4 --seq 1024 \\
        --policy srtf
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \\
        --n-layers 56 --steps 4 --batch 4 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch recurrentgemma-2b --steps 4 --batch 4 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm3-4b \\
        --n-layers 40 --steps 4 --batch 4 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch deepseek-v2-lite-16b --n-layers 5 --steps 4 --batch 4 \\
        --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch whisper-large-v3 --steps 4 --batch 4 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train --arch pixtral-12b \\
        --n-layers 6 --steps 4 --batch 4 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --reduced --arch yi-6b --steps 4 --batch 2 --seq 32
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional, Sequence

import torch

from .. import resolve_device
from ..checkpoint.checkpointer import Checkpointer
from ..configs import ARCHS, get_arch
from ..configs.base import ArchConfig
from ..configs.shapes import InputShape
from ..core.executor import LaneExecutor
from ..core.jobs import _sync, make_train_job
from ..core.metrics import evaluate
from ..core.policies import make_policy
from ..core.predictor import staircase_runtime
from ..data import pipeline as data
from ..models import lm
from ..optim import adamw
from ..tree import leaves
from .serve import release_device_memory
from .steps import build_train_step


def arch_config(args, arch_id: str) -> ArchConfig:
    """The arch's config as the flags ask: reduced or full width, depth
    cut to ``--n-layers`` if given (an encoder's depth too, both stacks
    alike)."""
    cfg = get_arch(arch_id)
    if args.reduced:
        cfg = cfg.reduced()
    if args.n_layers:
        enc = None if cfg.encoder is None else dataclasses.replace(
            cfg.encoder, n_layers=args.n_layers)
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers, encoder=enc)
    return cfg


def train_single(args) -> Dict:
    """Train ``--arch`` for ``--steps`` steps.  Returns ``{"steps": [per
    step {"step", "nll", "aux", "z", "grad_norm", "lr", "ms"}],
    "predicted_s", "peak_bytes"}`` (peak None on the CPU)."""
    cfg = arch_config(args, args.arch)
    if args.seq < cfg.n_patches + 2:
        raise ValueError(
            f"{cfg.arch_id}: --seq {args.seq} leaves under two text tokens "
            f"after its {cfg.n_patches} patches (a sequence is patches, "
            f"then text, and the loss needs a next token)")
    dev = args.device
    shape = InputShape("train_cli", args.seq, args.batch, "train")
    opt_cfg = adamw.OptConfig(lr=args.lr,
                              warmup_steps=max(2, args.steps // 10),
                              total_steps=max(args.steps, 2))
    bundle = build_train_step(cfg, shape, mesh=None, opt_cfg=opt_cfg,
                              remat=False)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    ck = None
    start_step = 0
    params = lm.init(cfg, seed=args.seed, device=dev, dtype=torch.float32,
                     stacked=True)
    for p in leaves(params):
        p.requires_grad_()
    opt_state = adamw.init(params)
    if args.checkpoint_dir:
        ck = Checkpointer(args.checkpoint_dir)
        if args.resume and ck.latest_step() is not None:
            start_step, state, _ = ck.restore(
                {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            print(f"[train] resumed from step {start_step}")
    print(f"[train] {cfg.arch_id}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{sum(p.numel() for p in leaves(params)) / 1e6:.1f} M parameters "
          f"on {dev}, batch {args.batch} x {args.seq}", flush=True)

    records = []
    predicted = None
    t_accum = 0.0
    for step in range(start_step, args.steps):
        batch = data.batch_for_step(cfg, shape, step,
                                    data.DataConfig(seed=args.seed), dev)
        t0 = time.perf_counter()
        params, opt_state, metrics = bundle.fn(params, opt_state, batch)
        _sync(dev)
        dt = time.perf_counter() - t0
        t_accum += dt
        rec = {"step": step, "ms": dt * 1e3}
        rec.update({k: float(v) for k, v in metrics.items()})
        records.append(rec)
        if predicted is None and step == start_step + 1:
            # structural runtime prediction for the whole job (Eq. 1 with
            # R=1 lane): profile one steady-state step, extrapolate.
            predicted = staircase_runtime(args.steps - step, 1, dt)
            print(f"[predictor] t={dt:.3f}s/step -> predicted remaining "
                  f"{predicted:.1f}s for {args.steps - step} steps")
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step={step} nll={rec['nll']:.4f} "
                  f"gnorm={rec['grad_norm']:.3f} lr={rec['lr']:.2e} "
                  f"{dt:.3f}s", flush=True)
        if ck is not None and args.checkpoint_every and \
                step + 1 < args.steps and \
                (step + 1) % args.checkpoint_every == 0:
            ck.save(step + 1, {"params": params, "opt": opt_state},
                    {"arch": args.arch})
    if ck is not None:
        if not args.no_final_checkpoint:      # the last step's state
            ck.save(args.steps, {"params": params, "opt": opt_state},
                    {"arch": args.arch})
        ck.wait()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    print(f"[train] done: {args.steps - start_step} steps, "
          f"{t_accum:.1f}s compute" + (
              f", peak device memory {peak / 2**30:.2f} GiB"
              if peak is not None else ""))
    return {"steps": records, "predicted_s": predicted, "peak_bytes": peak}


def train_multi(args) -> Dict:
    """The ``--jobs`` mix under ``--policy``.  Returns ``{"metrics",
    "results", "peak_bytes"}``."""
    dev = args.device
    items = []
    for item in args.jobs.split(","):
        arch_id, _, blocks = item.partition(":")
        items.append((arch_id, int(blocks or 20)))

    def job(arch_id, blocks, seed, arrival=0.0, tenant=None):
        return make_train_job(
            arch_config(args, arch_id), arch_id, blocks=blocks,
            batch=args.batch, seq=args.seq, max_residency=args.lanes,
            seed=seed, arrival=arrival, tenant=tenant, device=dev)

    # Solo baselines: one warmed job per distinct (arch, blocks) item,
    # measured once and freed before the next.  Job keys are
    # "{arch}#{order}"; split on the last '#' to recover the arch.
    solo = {}
    for arch_id, blocks in items:
        if (arch_id, blocks) in solo:
            continue
        res = LaneExecutor([job(arch_id, blocks, args.seed)],
                           make_policy("fifo"), n_lanes=args.lanes).run()
        solo[(arch_id, blocks)] = next(iter(res.values())).turnaround
        del res
        release_device_memory(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    specs = [job(arch_id, blocks, args.seed + i, 0.05 * i, arch_id)
             for i, (arch_id, blocks) in enumerate(items)]
    blocks_of = {f"{js.name}#{order}": js.num_blocks
                 for order, js in enumerate(specs)}
    ex = LaneExecutor(specs, make_policy(args.policy), n_lanes=args.lanes,
                      predictor=args.predictor)
    # SJF-style oracles are per kernel name; use the first item's baseline.
    for (name, _), rt in solo.items():
        ex.oracle_runtimes.setdefault(name, rt)
    results = ex.run()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    turnaround = {k: r.turnaround for k, r in results.items()}
    solo_map = {k: solo[(k.rsplit("#", 1)[0], blocks_of[k])]
                for k in turnaround}
    m = evaluate(turnaround, solo_map)
    print(f"[multi] policy={args.policy} STP={m.stp:.3f} ANTT={m.antt:.3f} "
          f"fairness={m.fairness:.3f}")
    for k, r in results.items():
        print(f"  {k}: turnaround={r.turnaround:.2f}s blocks={r.blocks}")
    del ex, specs
    release_device_memory(dev)
    return {"metrics": m, "results": results, "peak_bytes": peak}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="yi-6b", choices=sorted(ARCHS))
    ap.add_argument("--jobs", default=None,
                    help="multi-job mode: arch:blocks,arch:blocks,...")
    ap.add_argument("--policy", default="srtf")
    ap.add_argument("--predictor", default="simple-slicing",
                    help="registered predictor name (simple-slicing, ewma)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--no-final-checkpoint", action="store_true",
                    help="save no state after the last step, only the "
                         "--checkpoint-every ones before it")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless asked; no fallback)")
    ap.add_argument("--reduced", action="store_true",
                    help="train each arch's reduced config instead of its "
                         "full published width")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the config's depth to this many layers "
                         "(0: the config's own)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Run the driver; returns what :func:`train_single` or
    :func:`train_multi` returns, for callers that check the run."""
    args = build_parser().parse_args(argv)
    args.device = resolve_device(args.device)
    if args.jobs:
        return train_multi(args)
    return train_single(args)


if __name__ == "__main__":
    main()
