"""Time full-width deepseek-v2-lite-16b training steps on the card, in turns
with another tree of the port.

    python3 tools/moe_step_time.py --baseline TREE

Each run is ``python -m repro_torch.launch.train --arch
deepseek-v2-lite-16b --n-layers 2 --steps 6 --batch 4 --seq 1024`` (full
width, depth cut: one dense layer, then one MoE layer of 64 experts top 6
with 2 shared) in a subprocess of its own, with a tree's ``src`` alone on
the path; it builds that tree's kernels into that tree's git-ignored
``kernels/_cuda_build/``.  ``--baseline`` takes the root of another tree
(for example an unpacked ``git archive`` of the parent commit, in a
git-ignored directory); the runs go baseline, this, this, baseline, so
that a drift in the card's clock falls on both.

Prints the card's name and power limit, then for each run the steady step
ms (the median of the wall ms of steps 1-5) and each step's wall ms and
nll (``repr``, every bit).  Needs a GPU and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

from baseline import ROOT, card

LAYERS, STEPS = 2, 6
RUN = ("import json, sys\n"
       "from repro_torch.launch import train\n"
       "run = train.main(sys.argv[1:])\n"
       "print('RESULT ' + json.dumps(run['steps'], allow_nan=False))\n")


def run_tree(tree: Path) -> list:
    """One train run of ``tree``'s port: its per-step records."""
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    args = ["--arch", "deepseek-v2-lite-16b", "--n-layers", str(LAYERS),
            "--steps", str(STEPS), "--batch", "4", "--seq", "1024"]
    proc = subprocess.run([sys.executable, "-c", RUN, *args], env=env,
                          cwd=str(tree), capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"train run of {tree} exited {proc.returncode}")
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, required=True,
                    help="another tree (its root, holding src/repro_torch)")
    args = ap.parse_args(argv)
    card()
    trees = {"baseline": args.baseline.resolve(), "this": ROOT}
    for name in ("baseline", "this", "this", "baseline"):
        records = run_tree(trees[name])
        steady = statistics.median(r["ms"] for r in records[1:])
        print(f"[moe] {name} ({trees[name]}): steady step {steady:.1f} ms "
              f"wall (median of steps 1-{STEPS - 1}); steps (ms, nll): "
              + "; ".join(f"{r['ms']:.1f}, {r['nll']!r}" for r in records),
              flush=True)


if __name__ == "__main__":
    main()
