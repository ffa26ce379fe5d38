"""Time ``chip_smoke.py``'s executor-sweep and benchmarks phases of this
tree and another one in turns on the card.

    python3 tools/smoke_phase_time.py --baseline TREE [--order 0110]

``--baseline`` takes the root of another tree (for example an unpacked
``git archive`` of the parent commit, in a git-ignored directory).
``--order`` lists the turns, ``0`` the baseline and ``1`` this tree.
Each turn runs, in a child process of its own from the tree's root, the
phases of ``PHASES`` that the tree's ``chip_smoke.py`` has, one after the
other, and fails if one fails (a phase checks what it measures).  A tree
that measures the executor sweep inside its benchmarks phase has no
``phase_executor_sweep``.  Prints the card's name and power limit, each
turn's phases' seconds and their sum, and a JSON line of every turn.
Needs a GPU; builds no kernel (the phases run synthetic blocks and the
DES).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PHASES = ("phase_executor_sweep", "phase_benchmarks")

CHILD = """
import json, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import chip_smoke
seconds = {}
for name in sys.argv[2:]:
    phase = getattr(chip_smoke, name, None)
    if phase is not None:
        t0 = time.perf_counter()
        phase()
        seconds[name] = time.perf_counter() - t0
print("SECONDS " + json.dumps(seconds, allow_nan=False))
"""


def turn(tree: Path) -> dict:
    """Seconds of each of ``PHASES`` that ``tree`` has, in a child."""
    proc = subprocess.run([sys.executable, "-c", CHILD, str(tree), *PHASES],
                          cwd=tree, capture_output=True, text=True,
                          timeout=1200)
    if proc.returncode != 0:
        raise SystemExit(f"{tree}: exit {proc.returncode}\n"
                         f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    line = next(x for x in proc.stdout.splitlines()
                if x.startswith("SECONDS "))
    return json.loads(line.split(" ", 1)[1])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--baseline", type=Path, required=True)
    ap.add_argument("--order", default="0110")
    args = ap.parse_args(argv)
    trees = {"0": args.baseline.resolve(), "1": ROOT}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    turns = []
    for side in args.order:
        seconds = turn(trees[side])
        label = "baseline" if side == "0" else "this"
        turns.append({"tree": label, **seconds,
                      "sum": sum(seconds.values())})
        print(f"{label}: " + ", ".join(f"{k} {v:.1f}s"
                                       for k, v in seconds.items())
              + f"; sum {sum(seconds.values()):.1f}s ({card})", flush=True)
    print(json.dumps({"card": card, "turns": turns}, allow_nan=False))


if __name__ == "__main__":
    main()
