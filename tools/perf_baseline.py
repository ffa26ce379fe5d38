"""Measure the baseline block of the port's DES perf lane.

    python3 tools/perf_baseline.py --commit SHA [--out FILE]

Runs ``python -m repro_torch.benchmarks.perf --jobs 4 --repeat 3`` (full
mode, best of 3) in a child from a temporary directory, with this tree's
``src`` alone on the path, and prints its rows, then the ``BASELINE``
block they give for ``src/repro_torch/benchmarks/perf.py`` as one JSON
object: the python engine's blocks/sec and the table5 sweep's best cold
and warm walls.  Its ``protocol`` names the host CPU (``/proc/cpuinfo``'s
model name and processor count, and the CPUs this process may use), the
card beside it (``nvidia-smi``'s name and power limit, or "no card") and
``--commit``: the last commit that changed ``src/repro_torch/core``
(``git log -1 --format=%h -- src/repro_torch/core``), given by hand where
the tree has no ``.git``.  ``--out`` keeps the lane's JSON.  The lane
itself needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
JOBS = 4
REPEAT = 3


def host_cpu() -> str:
    """The first processor's model name in ``/proc/cpuinfo`` (its vendor,
    family, model and stepping where the name reads ``unknown``), the
    processor count there and the CPUs this process may use."""
    lines = Path("/proc/cpuinfo").read_text().splitlines()
    fields = {}
    for line in lines:
        key, _, value = line.partition(":")
        fields.setdefault(key.strip(), value.strip())
    model = fields.get("model name", "unknown")
    if model == "unknown":
        model = (f"{fields.get('vendor_id', 'unknown vendor')} family "
                 f"{fields.get('cpu family', '?')} model "
                 f"{fields.get('model', '?')} stepping "
                 f"{fields.get('stepping', '?')} (model name unknown)")
    count = sum(line.startswith("processor") for line in lines)
    return (f"{model}, {count} processors in /proc/cpuinfo, "
            f"{len(os.sched_getaffinity(0))} usable")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "no card"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--commit", required=True)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as cwd:
        out = Path(cwd) / "perf.json"
        subprocess.run(
            [sys.executable, "-m", "repro_torch.benchmarks.perf", "--jobs",
             str(JOBS), "--repeat", str(REPEAT), "--out", str(out)],
            cwd=cwd, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            check=True)
        payload = json.loads(out.read_text())
    if args.out:
        args.out.write_text(json.dumps(payload, indent=1, sort_keys=True,
                                       allow_nan=False) + "\n")
    rows = {row["name"]: row for row in payload["rows"]}
    cold = rows[f"table5.cold.jobs{JOBS}"]
    block = {
        "commit": args.commit,
        "protocol": (
            f"best-of-{REPEAT} measurements of `python -m "
            f"repro_torch.benchmarks.perf --jobs {JOBS} --repeat "
            f"{REPEAT}` (tools/perf_baseline.py; blocks/sec of the "
            f"python engine, table5 walls under {cold['engine']}) of "
            f"src/repro_torch/core at {args.commit}, on {host_cpu()}, "
            f"beside {card()}; best = least-contended observation"),
        f"table5.cold.jobs{JOBS}.wall_s.best": cold["wall_s"],
        f"table5.warm.jobs{JOBS}.wall_s.best":
            rows[f"table5.warm.jobs{JOBS}"]["wall_s"],
    }
    for label in ("table5_pair", "mix4_10x", "mgk_saturated"):
        name = f"blocks_per_sec.{label}"
        block[name] = rows[name]["blocks_per_sec"]
    print("BASELINE " + json.dumps(block, allow_nan=False), flush=True)


if __name__ == "__main__":
    main()
