"""Benchmark driver: one module per paper table/figure.

Prints ``name,us_per_call,derived`` CSV.  ``us_per_call`` is the wall time of
the producing module's ``run()`` divided by the number of derived rows it
emitted (all benchmarks are derived from simulation/lowering artifacts, not
single-op microbenchmarks).

Sweep-shaped modules execute through :mod:`repro_torch.core.sweep`:

* ``--jobs N``      — multiprocess fan-out over sweep cells,
* ``--cache-dir D`` — content-addressed on-disk result cache (default
  ``artifacts/sweep_cache``; ``--no-cache`` disables it),
* ``--subset N``    — first N workloads of each scenario (CI smoke),
* ``--machine M``   — only run modules driving this machine (``des`` for
  the discrete-event simulator, ``executor`` for the lane executor on
  the ``--device``; default both),
* ``--engine E``    — DES event-loop engine for the simulations
  (``python`` = reference loop, ``compiled`` = flat-array engine,
  ``auto`` = compiled when a fast backend is available; default auto).
  The resolved engine is echoed in the run header so BENCH rows are
  attributable,
* ``--dispatch D``  — cell dispatch tier: ``local`` (per-cell process
  pool, default) or ``queue`` (chunked pull-based workers —
  :mod:`repro_torch.core.distrib`; DES modules only, executor modules fall
  back to local),
* ``--workers N``   — worker count for ``--dispatch queue`` (default:
  follow ``--jobs``),
* ``--device D``    — torch device of the executor rows' blocks (default
  ``cuda``, no fallback; the DES modules ignore it).

Usage::

    PYTHONPATH=src python -m repro_torch.benchmarks.run [module-substring ...] \
        [--jobs 4] [--cache-dir artifacts/sweep_cache | --no-cache] \
        [--subset 4] [--machine des|executor] \
        [--engine auto|python|compiled] \
        [--dispatch local|queue] [--workers 4] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import importlib
import sys
import time
import traceback

#: (module, machine) — the machine whose results the module renders; the
#: ``--machine`` flag filters on it.
MODULES = [
    ("repro_torch.benchmarks.fig01_fifo_luck", "des"),
    ("repro_torch.benchmarks.fig03_staircase_trace", "des"),
    ("repro_torch.benchmarks.fig04_prediction_accuracy", "des"),
    ("repro_torch.benchmarks.fig06_block_durations", "des"),
    ("repro_torch.benchmarks.fig07_residency", "des"),
    ("repro_torch.benchmarks.fig09_corunner", "des"),
    ("repro_torch.benchmarks.fig11_ss_predictor", "des"),
    ("repro_torch.benchmarks.table5_policies", "des"),
    ("repro_torch.benchmarks.fig14_15_16_per_workload", "des"),
    ("repro_torch.benchmarks.table6_arrival_offsets", "des"),
    ("repro_torch.benchmarks.scenarios_openloop", "des"),
    ("repro_torch.benchmarks.closedloop", "des"),
    ("repro_torch.benchmarks.executor_policies", "executor"),
    ("repro_torch.benchmarks.roofline", "des"),
]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("filters", nargs="*",
                    help="only run modules whose name contains a filter")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes for sweep cells")
    ap.add_argument("--cache-dir", default=None,
                    help="sweep result cache directory "
                         "(default artifacts/sweep_cache)")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the on-disk sweep cache")
    ap.add_argument("--subset", type=int, default=None,
                    help="truncate each scenario to its first N workloads")
    ap.add_argument("--machine", choices=("des", "executor", "all"),
                    default="all",
                    help="only run modules driving this machine")
    ap.add_argument("--engine", choices=("auto", "python", "compiled"),
                    default="auto",
                    help="DES event-loop engine (auto = compiled when a "
                         "fast backend is available)")
    ap.add_argument("--dispatch", choices=("local", "queue"),
                    default="local",
                    help="cell dispatch tier (queue = chunked pull-based "
                         "workers; DES modules only)")
    ap.add_argument("--workers", type=int, default=None,
                    help="worker count for --dispatch queue "
                         "(default: follow --jobs)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the executor rows' blocks")
    args = ap.parse_args()

    from ..core.fastsim import default_engine, engine_token

    from . import common

    engine = None if args.engine == "auto" else args.engine
    extra = {"dispatcher": args.dispatch, "workers": args.workers}
    if args.no_cache:
        common.configure(jobs=args.jobs, cache_dir=None, subset=args.subset,
                         engine=engine, **extra)
    elif args.cache_dir is not None:
        common.configure(jobs=args.jobs, cache_dir=args.cache_dir,
                         subset=args.subset, engine=engine, **extra)
    else:
        common.configure(jobs=args.jobs, subset=args.subset, engine=engine,
                         **extra)

    # Attributability header: which event loop produced the rows below
    # (the token also names the active compiled backend).
    print(f"# engine={args.engine} -> {engine_token(engine or default_engine())}")
    if args.dispatch != "local":
        print(f"# dispatch={args.dispatch} workers="
              f"{args.workers if args.workers is not None else args.jobs}")
    print("name,us_per_call,derived")
    failures = 0
    for modname, machine in MODULES:
        if args.machine != "all" and machine != args.machine:
            continue
        if args.filters and not any(f in modname for f in args.filters):
            continue
        try:
            mod = importlib.import_module(modname)
            t0 = time.perf_counter()
            # Executor rows: the run's device, jobs, cache and subset (on
            # the local dispatcher, as common._dispatcher_for falls back).
            rows = mod.run() if machine == "des" else mod.run(
                args.device, common.JOBS, common.CACHE_DIR, common.SUBSET)
            dt_us = (time.perf_counter() - t0) * 1e6
            per = dt_us / max(1, len(rows))
            for name, derived in rows:
                print(f"{name},{per:.0f},\"{derived}\"")
        except Exception:
            failures += 1
            print(f"{modname},0,\"ERROR\"", flush=True)
            traceback.print_exc(file=sys.stderr)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
