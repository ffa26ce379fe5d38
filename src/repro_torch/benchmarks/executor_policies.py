"""Lane-executor policy benchmark on real device work.

Concurrent jobs of synthetic blocks (``x = tanh(x @ x) + 0.5 x`` on the
device, each block ending in a synchronize) are scheduled under each
policy; STP/ANTT/fairness use measured solo runtimes.  This is the
hardware-in-the-loop analogue of the paper's Table 5: block durations are
wall-clock measurements, lane parallelism is virtual time.

The table comes from executor-machine :class:`~repro_torch.core.sweep.
SweepSpec` sweeps over a trace-replay scenario: its kernel grids are
bridged to jobs of synthetic blocks
(:func:`repro_torch.core.scenarios.executor_workload`), solo baselines go
through the content-addressed sweep cache (reused across runs, keyed by
device), and cells are measured anew each run.  The main sweep crosses
every policy with the default predictor; a second SRTF-only sweep under
the EWMA baseline predictor (sharing the solo baselines through the
cache) shows what Simple Slicing's slice-boundary resampling buys on real
measurements.

    PYTHONPATH=src python -m repro_torch.benchmarks.executor_policies
    PYTHONPATH=src python -m repro_torch.benchmarks.executor_policies \\
        --device cpu

Runs on ``cuda`` unless ``--device`` says otherwise (no fallback).  Keep
``--jobs 1`` on the card: more jobs spawn one process, and one CUDA
context, per worker.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional, Tuple, Union

from ..core.predictor import DEFAULT_PREDICTOR
from ..core.scenarios import TraceReplay
from ..core.sweep import SweepResult, SweepSpec, run_sweep
from ..core.workload import ERCBENCH, scaled_spec
from .common import metric_row

N_LANES = 4
POLICY_NAMES = ("fifo", "mpmax", "srtf", "srtf-adaptive")

#: Reduced grids: a long job first and a short job arriving while it runs
#: (the FIFO-pessimal order, paper Section 2), plus a medium co-runner for
#: the second workload.
SPECS = {
    "long": scaled_spec(ERCBENCH["SAD"], name="long", num_blocks=48,
                        mean_t=30_000.0),
    "short": scaled_spec(ERCBENCH["JPEG-d"], name="short", num_blocks=6,
                         mean_t=5_000.0),
    "medium": scaled_spec(ERCBENCH["AES-e"], name="medium", num_blocks=32,
                          mean_t=14_000.0),
}

#: Two workloads, each long-first + short-later (arrival cycles map to
#: seconds through the sweep's ``time_scale``).
TRACE = {
    "workloads": [
        {"name": "long+short", "arrivals": [
            {"kernel": "long", "time": 0.0},
            {"kernel": "short", "time": 5_000.0},
        ]},
        {"name": "medium+short", "arrivals": [
            {"kernel": "medium", "time": 0.0},
            {"kernel": "short", "time": 5_000.0},
        ]},
    ],
}


def _scenario(subset: Optional[int] = None) -> TraceReplay:
    """The trace's workloads, the first ``subset`` of them if given."""
    trace = {"workloads": TRACE["workloads"][:subset]}
    return TraceReplay(trace=trace, specs=SPECS, name="executor-pairs")


def overlaps(cell) -> bool:
    """Whether some job arrived before an earlier arrival had finished, so
    that the policy had a choice to make."""
    order = sorted(cell.arrival, key=cell.arrival.get)
    return any(cell.arrival[later] < cell.finish.get(first, float("inf"))
               for i, first in enumerate(order) for later in order[i + 1:])


def sweeps(device: Optional[str] = None, jobs: int = 1,
           cache_dir: Optional[Union[str, Path]] = None,
           subset: Optional[int] = None
           ) -> Tuple[SweepResult, SweepResult]:
    """The main sweep (every policy, default predictor) and the srtf-only
    EWMA sweep over the first ``subset`` workloads (all unless given);
    every block on ``device`` (``cuda`` unless asked)."""
    def sweep(policies, predictors) -> SweepResult:
        return run_sweep(SweepSpec(
            scenarios=(_scenario(subset),), policies=policies,
            predictors=predictors, machine="executor", n_sm=N_LANES,
            device=device), jobs=jobs, cache_dir=cache_dir)

    # Only SRTF consults the predictor, so the EWMA cells are a separate
    # srtf-only sweep (every cell is a real measurement).
    return (sweep(POLICY_NAMES, (DEFAULT_PREDICTOR,)),
            sweep(("srtf",), ("ewma",)))


def rows(result: SweepResult, ewma_result: SweepResult
         ) -> List[Tuple[str, str]]:
    """The benchmark's ``(name, derived)`` rows of the two sweeps, for
    the workloads that swept."""
    workloads = [wl["name"] for wl in TRACE["workloads"]
                 if result.select(workload=wl["name"])]
    out = []
    for wl in workloads:
        for policy in POLICY_NAMES:
            cell, = result.select(workload=wl, policy=policy,
                                  predictor=DEFAULT_PREDICTOR)
            out.append(metric_row(f"executor.{wl}.{policy}", cell.metrics))
    for wl in workloads:
        ewma_cell, = ewma_result.select(workload=wl, policy="srtf",
                                        predictor="ewma")
        out.append(metric_row(f"executor.{wl}.srtf+ewma",
                              ewma_cell.metrics))
    cells = list(result.cells) + list(ewma_result.cells)
    n_overlap = sum(overlaps(c) for c in cells)
    out.append(("executor.note",
                "synthetic block measurements via the scenario->executor "
                "bridge; virtual lane time; paper ordering SRTF>FIFO on "
                "STP/ANTT expected only where a pair overlaps: "
                f"{n_overlap} of {len(cells)} cells overlap at this time "
                "scale; srtf+ewma = same policy under the EWMA baseline "
                "predictor"))
    return out


def run(device: Optional[str] = None, jobs: int = 1,
        cache_dir: Optional[Union[str, Path]] = None,
        subset: Optional[int] = None) -> List[Tuple[str, str]]:
    """The benchmark's ``(name, derived)`` rows over the first ``subset``
    workloads (all unless given); every block on ``device`` (``cuda``
    unless asked)."""
    return rows(*sweeps(device, jobs, cache_dir, subset))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="torch device of the blocks (default cuda)")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--cache-dir", default="artifacts/sweep_cache")
    args = ap.parse_args(argv)
    for name, derived in run(args.device, args.jobs, args.cache_dir):
        print(f"{name},{derived}")


if __name__ == "__main__":
    main()
