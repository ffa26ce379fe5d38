"""Shared helpers for the paper-reproduction benchmarks.

The sweep-shaped benchmarks (Table 5, Table 6, Figs. 1/14/15/16, the
open-loop scenario rows) are thin views over :mod:`repro_torch.core.sweep`: each
declares one :class:`~repro_torch.core.sweep.SweepSpec` and renders rows from the
shared :class:`~repro_torch.core.sweep.SweepResult`.  Parallelism and the
on-disk result cache are configured once per invocation from
``repro_torch.benchmarks.run`` flags via :func:`configure` (``--jobs``,
``--cache-dir``, ``--subset``); a warm cache turns the full table sweeps
into second-scale reruns.
"""

from __future__ import annotations

import functools
import math
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.metrics import WorkloadMetrics, evaluate
from ..core.policies import make_policy
from ..core.scenarios import ClosedLoopScenario, PairStagger, Scenario
from ..core.simulator import simulate
from ..core.sweep import (
    SweepResult,
    SweepSpec,
    run_sweep,
    run_sweeps,
    solo_runtime_cached,
)
from ..core.workload import ERCBENCH, Arrival, reorder_for_oracle

SEED = 0

#: Default on-disk sweep cache (content-addressed; safe to delete).
DEFAULT_CACHE_DIR = Path("artifacts") / "sweep_cache"

#: Runner configuration, set once per invocation by ``repro_torch.benchmarks.run``.
JOBS = 1
CACHE_DIR: Optional[Path] = DEFAULT_CACHE_DIR
SUBSET: Optional[int] = None
#: DES event-loop engine ("python"/"compiled"; None = compiled when a
#: fast backend is available — see repro_torch.core.fastsim.default_engine).
ENGINE: Optional[str] = None
#: Cell dispatch tier ("local" = per-cell process pool; "queue" = chunked
#: pull-based workers — see repro_torch.core.distrib) and the queue tier's
#: worker count (None = follow JOBS).
DISPATCHER = "local"
WORKERS: Optional[int] = None

_UNSET = object()


def configure(jobs: Optional[int] = None, cache_dir=_UNSET,
              subset=_UNSET, engine=_UNSET, dispatcher=_UNSET,
              workers=_UNSET) -> None:
    """Set sweep parallelism / cache / workload-subset / DES engine /
    dispatcher for this process.

    ``cache_dir=None`` disables the on-disk cache; ``subset=N`` truncates
    every scenario's workload list to its first N entries (the CI smoke
    uses this to keep sweep-runner coverage cheap); ``engine`` pins the
    DES event loop (``None`` = compiled-when-available); ``dispatcher``
    selects the cell dispatch tier ("local"/"queue") and ``workers`` the
    queue tier's worker count (``None`` = follow ``jobs``).
    """
    global JOBS, CACHE_DIR, SUBSET, ENGINE, DISPATCHER, WORKERS
    if jobs is not None:
        JOBS = max(1, int(jobs))
    if cache_dir is not _UNSET:
        CACHE_DIR = Path(cache_dir) if cache_dir is not None else None
    if subset is not _UNSET:
        SUBSET = int(subset) if subset is not None else None
    if engine is not _UNSET:
        ENGINE = engine
    if dispatcher is not _UNSET:
        DISPATCHER = dispatcher
    if workers is not _UNSET:
        WORKERS = int(workers) if workers is not None else None


class _SubsetScenario(Scenario):
    """First-N-workloads view of another scenario (``--subset``)."""

    def __init__(self, inner: Scenario, limit: int):
        super().__init__(inner.seed)
        self.inner = inner
        self.limit = limit
        self.name = inner.name

    def reseeded(self, seed: int) -> "Scenario":
        return _SubsetScenario(self.inner.reseeded(seed), self.limit)

    def workloads(self):
        return self.inner.workloads()[: self.limit]


class _SubsetClosedLoop(ClosedLoopScenario):
    """First-N-processes view of a closed-loop scenario (``--subset``).

    Delegates everything — including ``process_params`` — to the inner
    scenario, so subset cells share cache entries with full-sweep cells of
    the same workload names.
    """

    def __init__(self, inner: ClosedLoopScenario, limit: int):
        super().__init__(inner.seed)
        self.inner = inner
        self.limit = limit
        self.name = inner.name

    def reseeded(self, seed: int) -> "Scenario":
        return _SubsetClosedLoop(self.inner.reseeded(seed), self.limit)

    def process_names(self):
        return self.inner.process_names()[: self.limit]

    def make_process(self, name: str):
        return self.inner.make_process(name)

    def mix_specs(self):
        return self.inner.mix_specs()

    def process_params(self) -> dict:
        return self.inner.process_params()


def _subset(scenario: Scenario) -> Scenario:
    if SUBSET is None:
        return scenario
    if isinstance(scenario, ClosedLoopScenario):
        return _SubsetClosedLoop(scenario, SUBSET)
    return _SubsetScenario(scenario, SUBSET)


def _build_spec(scenarios, policies, predictors=(None,), seeds=(SEED,),
                until=None, machine="des", n_sm=None,
                time_scale=None) -> SweepSpec:
    scenarios = tuple(_subset(s) for s in scenarios)
    kwargs = {}
    if n_sm is not None:
        kwargs["n_sm"] = n_sm
    if time_scale is not None:
        kwargs["time_scale"] = time_scale
    if machine == "des":
        # The engine axis only exists for DES cells (SweepSpec rejects it
        # on executor sweeps).
        kwargs["engine"] = ENGINE
    return SweepSpec(scenarios=scenarios, policies=tuple(policies),
                     predictors=tuple(predictors), seeds=tuple(seeds),
                     until=until, machine=machine, **kwargs)


def sweep(scenarios, policies, predictors=(None,), seeds=(SEED,),
          until=None, machine="des", n_sm=None,
          time_scale=None) -> SweepResult:
    """Run one sweep under the module's configuration (jobs/cache/subset).

    ``machine="executor"`` drives the cells through the lane executor
    (``n_sm`` is then the lane count); see
    :mod:`repro_torch.core.sweep`.
    """
    spec = _build_spec(scenarios, policies, predictors=predictors,
                       seeds=seeds, until=until, machine=machine,
                       n_sm=n_sm, time_scale=time_scale)
    return run_sweep(spec, jobs=JOBS, cache_dir=CACHE_DIR,
                     dispatcher=_dispatcher_for(machine), workers=WORKERS)


def _dispatcher_for(*machines: str) -> str:
    """The configured dispatcher, downgraded to "local" for executor
    cells (the queue tier is DES-only: executor cells are wall-clock
    measurements calibrated against local pool contention)."""
    if DISPATCHER == "queue" and "executor" in machines:
        return "local"
    return DISPATCHER


def sweeps(grids) -> List[SweepResult]:
    """Run several sweep grids as ONE batch (single worker pool, in-flight
    cross-grid dedup — see :func:`repro_torch.core.sweep.run_sweeps`).  Each
    grid is a dict of :func:`sweep` keyword arguments."""
    specs = [_build_spec(**grid) for grid in grids]
    return run_sweeps(specs, jobs=JOBS, cache_dir=CACHE_DIR,
                      dispatcher=_dispatcher_for(*(s.machine for s in specs)),
                      workers=WORKERS)


@functools.lru_cache(maxsize=None)
def solo_runtimes(seed: int = SEED) -> Dict[str, float]:
    return {
        name: solo_runtime_cached(spec, seed=seed, cache_dir=CACHE_DIR)
        for name, spec in ERCBENCH.items()
    }


def run_workload(policy: str, wl: List[Arrival], seed: int = SEED,
                 **sim_kwargs):
    """Run one workload under one policy.  SJF/LJF are realized the way the
    paper realizes them: FIFO with oracle-chosen arrival order.

    (Direct, uncached single run — figure benchmarks that need the full
    :class:`~repro_torch.core.simulator.SimResult` use this; sweep-shaped tables
    go through :func:`sweep`.)
    """
    solo = solo_runtimes(seed)
    if policy in ("sjf", "ljf"):
        wl = reorder_for_oracle(wl, solo, longest_first=(policy == "ljf"))
        policy = "fifo"
    sim_kwargs.setdefault("engine", ENGINE)
    return simulate(wl, lambda: make_policy(policy), seed=seed,
                    oracle_runtimes=solo, **sim_kwargs)


def workload_metrics(policy: str, wl: List[Arrival],
                     seed: int = SEED) -> WorkloadMetrics:
    solo = solo_runtimes(seed)
    res = run_workload(policy, wl, seed=seed)
    solo_map = {k: solo[res.name[k]] for k in res.turnaround}
    return evaluate(res.turnaround, solo_map)


TABLE5_POLICIES = ("fifo", "mpmax", "srtf", "srtf-adaptive", "sjf")

#: Every policy the Table-5 sweep executes (the zero-sampling variant rides
#: in the same sweep so the whole table is one SweepSpec).
TABLE5_SWEEP_POLICIES = TABLE5_POLICIES + ("srtf-zero", "ljf")


#: Memo shared by the Table-5 accessors; :func:`table5_batch` pre-fills
#: both entries from ONE pooled run (single straggler tail, the seed-0
#: FIFO/SRTF cells deduped in flight instead of through the disk cache).
_TABLE5_MEMO: Dict[tuple, SweepResult] = {}


def _table5_grid(seed: int) -> dict:
    return {"scenarios": (PairStagger(seed=seed),),
            "policies": TABLE5_SWEEP_POLICIES, "seeds": (seed,)}


def _table5_ci_grid(seeds: Tuple[int, ...]) -> dict:
    return {"scenarios": (PairStagger(seed=SEED),),
            "policies": TABLE5_CI_POLICIES, "seeds": seeds}


def table5_batch(seed: int = SEED) -> Tuple[SweepResult, SweepResult]:
    """The main Table-5 grid and its multi-seed CI companion, executed as
    one sweep batch (used by the table5 benchmark, which needs both)."""
    main_key = ("main", seed)
    ci_key = ("ci", TABLE5_CI_SEEDS)
    if main_key not in _TABLE5_MEMO or ci_key not in _TABLE5_MEMO:
        main, ci = sweeps([_table5_grid(seed),
                           _table5_ci_grid(TABLE5_CI_SEEDS)])
        _TABLE5_MEMO[main_key] = main
        _TABLE5_MEMO[ci_key] = ci
    return _TABLE5_MEMO[main_key], _TABLE5_MEMO[ci_key]


def table5_result(seed: int = SEED) -> SweepResult:
    """The full Table-5 grid as one sweep: 56 pair-stagger workloads x all
    policies (incl. the zero-sampling SRTF variant and LJF for Fig. 1)."""
    key = ("main", seed)
    if key not in _TABLE5_MEMO:
        _TABLE5_MEMO[key] = sweep(**_table5_grid(seed))
    return _TABLE5_MEMO[key]


def table5_sweep(seed: int = SEED) -> Dict[str, List[Tuple[str, WorkloadMetrics]]]:
    """Per-policy per-workload metrics view (Figs. 14/15/16, Table 5)."""
    result = table5_result(seed)
    out: Dict[str, List[Tuple[str, WorkloadMetrics]]] = {}
    for pol in TABLE5_SWEEP_POLICIES:
        out[pol] = [(c.workload, c.metrics)
                    for c in result.select(policy=pol)]
    return out


def table5_summary(seed: int = SEED) -> Dict[str, WorkloadMetrics]:
    result = table5_result(seed)
    return {pol: result.summary(policy=pol) for pol in TABLE5_SWEEP_POLICIES}


#: Seeds for the multi-seed spread rows (each reseeds the simulator's
#: per-kernel noise streams; pair-stagger arrivals are deterministic).
TABLE5_CI_SEEDS = (0, 1, 2)

#: Policies worth a spread row (the headline FIFO -> SRTF comparison).
TABLE5_CI_POLICIES = ("fifo", "srtf")


def table5_ci_result(seeds: Tuple[int, ...] = TABLE5_CI_SEEDS) -> SweepResult:
    """The Table-5 grid swept across noise seeds (for ``summary_ci``);
    seed-0 FIFO/SRTF cells are shared with :func:`table5_result` — in
    flight when both run as one batch, through the content-addressed
    cache otherwise."""
    key = ("ci", seeds)
    if key not in _TABLE5_MEMO:
        _TABLE5_MEMO[key] = sweep(**_table5_ci_grid(seeds))
    return _TABLE5_MEMO[key]


def linear_fit_end_prediction(end_times: np.ndarray) -> float:
    """Predict kernel finish time by least-squares fit of block end times
    against block rank (the paper's 'linear regression' predictor)."""
    n = len(end_times)
    if n < 2:
        return float(end_times[-1]) if n else float("nan")
    x = np.arange(1, n + 1, dtype=float)
    slope, intercept = np.polyfit(x, np.sort(end_times), 1)
    return float(slope * n + intercept)


def fmt(x: float, nd: int = 3) -> str:
    if x is None or (isinstance(x, float) and math.isnan(x)):
        return "nan"
    return f"{x:.{nd}f}"


def metric_row(prefix: str, m: WorkloadMetrics) -> Tuple[str, str]:
    """Uniform ``name,derived`` row for an STP/ANTT/fairness triple."""
    return (prefix,
            f"stp={m.stp:.2f};antt={m.antt:.2f};fair={m.fairness:.2f}")


def metric_ci_row(prefix: str, ci) -> Tuple[str, str]:
    """``name,derived`` row for a :class:`~repro_torch.core.sweep.MetricsCI`:
    geomean with the min..max seed spread in brackets."""

    def band(t: Tuple[float, float, float]) -> str:
        return f"{t[0]:.2f}[{t[1]:.2f},{t[2]:.2f}]"

    return (prefix,
            f"stp={band(ci.stp)};antt={band(ci.antt)};"
            f"fair={band(ci.fairness)} "
            f"(geomean[min,max] across {ci.n_seeds} seeds)")
