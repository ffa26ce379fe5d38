"""Run ``chip_smoke.py``'s full-width serve paths of this tree and another
one in turns on the card, and print each path's SRTF and FIFO STP, ANTT
and peak memory side by side.

    python3 tools/serve_paths_compare.py --baseline TREE

``--baseline`` takes the root of another tree (for example an unpacked
``git archive`` of the parent commit, in a git-ignored directory).  The
turns are the baseline, this tree, this tree, the baseline (:data:`TURNS`),
so a drift of the card or the host over the run weighs on both sides
alike.  Each turn runs, in a child process of its own from the tree's root, the
tree's ``phase_build`` and then its ``phase_serve`` on each of its
``SERVE_PATHS``, which check that every job
finishes and each path's kernels ran (this tree's also the exact launch
counts).  Prints the card's name and power limit, each turn's rows
(path, policy, STP, ANTT, fairness, peak GiB) and a JSON line of every
turn; a turn that fails stops the run with the end of its output.
Needs a GPU; about two minutes a turn on an NVIDIA H100 80GB HBM3 (the
kernels' build 15 s, the seven serve paths 80 s in ``chip_smoke.py``).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TURNS = ("baseline", "this", "this", "baseline")

CHILD = """
import sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import chip_smoke
chip_smoke.phase_build()
for path in chip_smoke.SERVE_PATHS:
    chip_smoke.phase_serve(*path)
"""
ROW = re.compile(r"^\[serve\] (srtf|fifo): STP=([\d.]+) ANTT=([\d.]+) "
                 r"fairness=([\d.]+) peak_memory=([\d.]+) GiB")
PATH = re.compile(r"^\[serve\] python -m repro_torch\.launch\.serve --jobs "
                  r"(\S+)")


def turn(tree: Path) -> list:
    """``[{path, policy, stp, antt, fairness, peak_gib}]`` of one tree's
    serve paths, from a child process."""
    proc = subprocess.run([sys.executable, "-c", CHILD, str(tree)],
                          cwd=tree, capture_output=True, text=True,
                          timeout=1200)
    if proc.returncode != 0:
        raise SystemExit(f"{tree}: exit {proc.returncode}\n"
                         f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    rows, path = [], None
    for line in proc.stdout.splitlines():
        m = PATH.match(line)
        if m:
            path = m.group(1) + (" poisson" if "poisson" in line else "")
        m = ROW.match(line)
        if m:
            rows.append({"path": path, "policy": m.group(1),
                         "stp": float(m.group(2)),
                         "antt": float(m.group(3)),
                         "fairness": float(m.group(4)),
                         "peak_gib": float(m.group(5))})
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--baseline", type=Path, required=True)
    args = ap.parse_args(argv)
    trees = {"baseline": args.baseline.resolve(), "this": ROOT}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    turns = []
    for label in TURNS:
        rows = turn(trees[label])
        turns.append({"tree": label, "rows": rows})
        for r in rows:
            print(f"{label}: {r['path']} {r['policy']}: STP {r['stp']} "
                  f"ANTT {r['antt']} fairness {r['fairness']} peak "
                  f"{r['peak_gib']} GiB ({card})", flush=True)
    print(json.dumps({"card": card, "turns": turns}, allow_nan=False))


if __name__ == "__main__":
    main()
