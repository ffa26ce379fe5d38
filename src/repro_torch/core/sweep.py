"""Declarative experiment sweeps with a content-addressed cache and
multiprocess fan-out.

One :class:`SweepSpec` names the whole grid — scenarios x policies x
predictors x seeds, on either **machine** — and :func:`run_sweep`
executes it:

* **cells** are (workload, policy, predictor, seed) runs; SJF/LJF are
  realized the way the paper realizes them (FIFO with oracle-chosen
  arrival order, Section 2), and every cell gets the measured solo
  runtimes as its oracle, exactly like the hand-rolled benchmark loops
  this module replaces;
* **tiers**: open-loop scenarios materialize fixed arrival lists; a
  :class:`~repro.core.scenarios.ClosedLoopScenario` instead names seeded
  arrival *processes* — each cell builds a fresh process and the machine
  feeds it completions (the :class:`~repro.core.events.ArrivalSource`
  edge), so the arrival sequence reacts to the policy under test.
  Closed-loop cell cache keys digest the **process parameters + seed**
  (there is no arrival list to digest), their solo oracles cover the
  declared kernel mix, their DES code fingerprint widens to include
  ``scenarios.py`` (the process code is result-determining), and SJF/LJF
  — which need a materialized list to reorder — are rejected explicitly;
* **machines**: ``machine="des"`` (default) simulates cells on the
  discrete-event simulator; ``machine="executor"`` drives the same
  workloads through the real-JAX :class:`~repro.core.executor.LaneExecutor`
  — each scenario arrival is bridged to a job of actual jit-compiled
  blocks (:func:`repro.core.scenarios.executor_workload`) and block
  durations are wall-clock measurements;
* **fan-out**: with ``jobs > 1`` cells run in a process pool (fork for the
  pure-Python DES; spawn for executor cells, because forking a process
  with an initialized JAX runtime can deadlock).  Executor solo baselines
  are measured under the *same* pool-contention conditions as the cells:
  with ``jobs > 1`` they go through an identical spawn pool of the same
  width (serial parent-process baselines would be systematically faster
  than co-run cells on a small container, inflating every slowdown), and
  the pool width is part of the solo cache key.  DES solo baselines are
  deterministic simulations and fan out through a fork pool of the same
  width when there is more than one to measure;
* **dispatchers**: ``dispatcher="local"`` (default) is the per-cell
  process-pool path above.  ``dispatcher="queue"`` serves DES cells in
  LPT-ordered *chunks* to long-lived pull-based workers — local spawned
  processes and/or remote ``python -m repro.launch.worker`` nodes — with
  heartbeat/death detection, bounded re-dispatch, and two-way cache sync
  (:class:`repro.core.distrib.QueueDispatcher`, DESIGN.md Section 12).
  Records are byte-identical across dispatchers (a tested gate);
  executor sweeps reject the queue tier because their cells are
  wall-clock measurements calibrated against local pool contention;
* **cache**: with ``cache_dir`` every cell and solo-runtime measurement is
  stored content-addressed, keyed by a SHA-256 over the *workload content*
  (every :class:`~repro.core.workload.KernelSpec` field, arrival times,
  uids — see :func:`repro.core.scenarios.workload_digest`), the policy,
  the resolved predictor name, the simulation seed, machine size, horizon,
  the solo-runtime oracle and a **code fingerprint** (a digest of the
  schedule-determining sources — simulator/policies/predictor for the DES
  — so schedule-changing commits auto-invalidate; :data:`CACHE_VERSION`
  stays as the manual override).  A warm DES rerun touches no simulator
  code and returns bit-identical
  :class:`~repro.core.metrics.WorkloadMetrics` (floats survive the JSON
  round-trip exactly; NaN is encoded as ``null`` on disk and decoded back,
  keeping every cache record standard JSON).

Executor cells are **measurements**, not pure functions: their records
carry ``measured: true`` and their cell keys fold in a per-run nonce, so
every :func:`run_sweep` invocation re-measures cells (in-run SJF/FIFO
dedup still applies) instead of pretending wall-time is bit-reproducible;
their records stay in memory and are never persisted (a nonce-keyed file
could not be read back).
Executor *solo* runtimes are deterministic cache keys (spec content +
lane count + code fingerprint) and ARE reused across runs — rerunning an
executor sweep skips the solo-baseline measurements.

Open-loop runs are first-class: cells carry
:class:`~repro.core.metrics.WindowMetrics` (completion-window STP/ANTT/
fairness + makespan/utilization/finished counts), and ``until`` truncates
every simulation at a horizon.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import multiprocessing
import time
import uuid
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .distrib import (
    DispatchError,
    QueueDispatcher,
    cache_memo_stats,
    cache_read as _cache_read,
    cache_write as _cache_write,
    canonical_digest as _canonical_digest,
    chunk_size_for,
    clear_cache_memo,
    run_cell as _run_cell,
    run_des_chunk,
    _run_chunk,
    scavenge_cache_dir,
)
from .executor import solo_runtime_executor
from .fastsim import default_engine, engine_token
from .metrics import (
    MetricsError,
    QueueingMetrics,
    WindowMetrics,
    WorkloadMetrics,
    evaluate_queueing,
    geomean,
)
from .policies import make_policy
from .predictor import DEFAULT_PREDICTOR
from .scenarios import (
    ClosedLoopScenario,
    DEFAULT_EXECUTOR_TIME_SCALE,
    Scenario,
    executor_job,
    make_scenario,
    workload_digest,
)
from .simulator import solo_runtime
from .workload import Arrival, KernelSpec, N_SM, reorder_for_oracle

#: Bump when simulator/policy/predictor changes intentionally alter
#: schedules: cached cells are only valid for the code that produced them.
#: (Schedule-changing *commits* are caught automatically by the code
#: fingerprint in every key — see :func:`_code_fingerprint`; this constant
#: remains the manual override.)
#: 2: DES cell keys fold in the engine token (compiled flat-array engine,
#:    DESIGN.md Section 10) and the "des"/"des-closed" fingerprints widen
#:    to the engine sources.
#: 3: the cell runners and record store move to distrib.py (the
#:    distributed sweep tier, DESIGN.md Section 12) and every machine's
#:    fingerprint widens to the same 13-module closure — records produced
#:    by any dispatcher share one provenance domain.
CACHE_VERSION = 3

#: The two concrete machines a sweep can target.
MACHINES = ("des", "executor")

#: The two DES event-loop engines a sweep can pin (``None`` = pick the
#: compiled engine exactly when a fast backend is available).
ENGINES = ("python", "compiled")

#: Policies realized as FIFO over an oracle-reordered arrival list.
ORACLE_ORDER_POLICIES = ("sjf", "ljf")

#: Placeholder marking a cache key as scheduled-for-computation.
_PENDING: dict = {}


# ------------------------------------------------------------------ spec
@dataclass(frozen=True)
class SweepSpec:
    """The declarative experiment grid.

    ``scenarios`` holds registered names and/or :class:`Scenario`
    instances (names are constructed with default parameters).  ``seeds``
    are *sweep* seeds: each reseeds the scenario's arrival draws and the
    simulator's noise streams coherently.  ``until`` truncates every cell
    at an observation horizon — the open-loop mode (cycles on the DES,
    seconds of lane time on the executor).

    ``machine`` selects the cell substrate: ``"des"`` (discrete-event
    simulator) or ``"executor"`` (real-JAX lane executor; ``n_sm`` is then
    the lane count and ``time_scale`` maps scenario cycles to seconds of
    arrival time — see :func:`repro.core.scenarios.executor_workload`).

    ``engine`` pins the DES event-loop implementation (``"python"`` /
    ``"compiled"``; ``None`` = compiled-when-available).  Both engines are
    gated bit-identical, but every DES cell key folds in the resolved
    engine token — :func:`repro.core.fastsim.engine_token`, which also
    encodes which compiled backend (native C / numba / interpreted twin)
    is active — so a gating regression could never silently mix
    provenance across cached records.  Executor sweeps reject the axis:
    their cells never run the DES event loop.
    """

    scenarios: Tuple[Union[str, Scenario], ...]
    policies: Tuple[str, ...]
    predictors: Tuple[Optional[str], ...] = (None,)
    seeds: Tuple[int, ...] = (0,)
    n_sm: int = N_SM
    until: Optional[float] = None
    machine: str = "des"
    time_scale: float = DEFAULT_EXECUTOR_TIME_SCALE
    engine: Optional[str] = None
    device: Optional[str] = None    # executor blocks' torch device; None = cuda

    def __post_init__(self):
        object.__setattr__(self, "scenarios", tuple(self.scenarios))
        object.__setattr__(self, "policies", tuple(self.policies))
        object.__setattr__(self, "predictors", tuple(self.predictors))
        object.__setattr__(self, "seeds", tuple(self.seeds))
        if self.machine not in MACHINES:
            raise ValueError(
                f"unknown machine {self.machine!r}; choose from {MACHINES}")
        if self.engine is not None:
            if self.engine not in ENGINES:
                raise ValueError(f"unknown engine {self.engine!r}; choose "
                                 f"from {ENGINES} (or None = auto)")
            if self.machine == "executor":
                raise ValueError(
                    "engine selects the DES event loop; executor sweeps "
                    "have no engine axis (leave it as None)")
        if self.device is not None and self.machine != "executor":
            raise ValueError("device selects where executor blocks run; a "
                             "DES sweep has no device (leave it as None)")
        if self.machine == "executor":  # key and payload device: a string
            object.__setattr__(self, "device", _device_name(self.device))


@dataclass(frozen=True)
class CellResult:
    """One executed (workload, policy, predictor, seed) cell."""

    scenario: str
    workload: str
    policy: str
    predictor: str
    seed: int
    window: WindowMetrics
    turnaround: Dict[str, float]
    finish: Dict[str, float]
    unfinished: Tuple[str, ...]
    names: Dict[str, str]          # kernel key -> spec name
    #: Arrival time of every kernel, finished or in flight (queueing
    #: metrics integrate number-in-system over the window).
    arrival: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: True for executor cells: the numbers are wall-clock measurements of
    #: real JAX executions, not deterministic simulation outputs.
    measured: bool = False

    @property
    def metrics(self) -> Optional[WorkloadMetrics]:
        """Closed-workload STP/ANTT/fairness (``None`` if nothing
        finished inside the window)."""
        return self.window.workload_metrics

    def queueing(self, warmup_frac: float = 0.2) -> QueueingMetrics:
        """Steady-state queueing metrics of this cell
        (:func:`repro.core.metrics.evaluate_queueing`; raises
        :class:`~repro.core.metrics.MetricsError` when nothing completed
        after the warmup trim)."""
        return evaluate_queueing(self.arrival, self.finish,
                                 end_time=self.window.end_time,
                                 warmup_frac=warmup_frac)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["unfinished"] = list(self.unfinished)
        return d

    @classmethod
    def from_record(cls, record: dict, **labels) -> "CellResult":
        """Attach sweep labels to one cached simulation record.

        Records are label-free on purpose: an SJF cell and the FIFO cell
        of the mirrored workload are the *same simulation* and share one
        cache entry; only the labels differ.  NaN window metrics (nothing
        finished inside the window) are stored as ``null`` on disk —
        standard JSON — and decoded back to NaN here.
        """
        window = {k: (float("nan") if v is None else v)
                  for k, v in record["window"].items()}
        return cls(
            window=WindowMetrics(**window),
            turnaround=dict(record["turnaround"]),
            finish=dict(record["finish"]),
            unfinished=tuple(record["unfinished"]),
            names=dict(record["names"]),
            arrival=dict(record.get("arrival", {})),
            measured=bool(record.get("measured", False)), **labels)


@dataclass(frozen=True)
class MetricsCI:
    """Multi-seed spread of a sweep summary.

    Each metric is a ``(geomean, min, max)`` triple over the per-seed
    Table-5-style summaries — the lightweight confidence band the ROADMAP's
    multi-seed item asks for (min/max, not a parametric interval: seed
    counts are small and the spread is what readers compare).
    """

    stp: Tuple[float, float, float]
    antt: Tuple[float, float, float]
    fairness: Tuple[float, float, float]
    n_seeds: int

    @property
    def point(self) -> WorkloadMetrics:
        """The centers alone, as a plain :class:`WorkloadMetrics`."""
        return WorkloadMetrics(
            stp=self.stp[0], antt=self.antt[0], fairness=self.fairness[0])


class SweepResult:
    """All cells of one sweep plus cache/runtime statistics."""

    def __init__(self, cells: List[CellResult], stats: Dict[str, float]):
        self.cells = cells
        self.stats = stats

    def select(self, scenario: Optional[str] = None,
               workload: Optional[str] = None,
               policy: Optional[str] = None,
               predictor: Optional[str] = None,
               seed: Optional[int] = None) -> List[CellResult]:
        return [
            c for c in self.cells
            if (scenario is None or c.scenario == scenario)
            and (workload is None or c.workload == workload)
            and (policy is None or c.policy == policy)
            and (predictor is None or c.predictor == predictor)
            and (seed is None or c.seed == seed)
        ]

    def summary(self, **filters) -> WorkloadMetrics:
        """Geometric-mean STP/ANTT/fairness over the selected cells'
        finished-kernel metrics (paper Table-5 style)."""
        ms = [c.metrics for c in self.select(**filters)]
        ms = [m for m in ms if m is not None]
        if not ms:
            raise MetricsError(f"no finished cells match {filters!r}")
        return WorkloadMetrics(
            stp=geomean(m.stp for m in ms),
            antt=geomean(m.antt for m in ms),
            fairness=geomean(m.fairness for m in ms))

    def summary_ci(self, **filters) -> MetricsCI:
        """Multi-seed spread: per-seed :meth:`summary`, aggregated to
        geomean ± min/max per metric (see :class:`MetricsCI`)."""
        seeds = sorted({c.seed for c in self.select(**filters)})
        if not seeds:
            raise MetricsError(f"no cells match {filters!r}")
        per_seed = [self.summary(**{**filters, "seed": s}) for s in seeds]

        def agg(values) -> Tuple[float, float, float]:
            vals = list(values)
            return (geomean(vals), min(vals), max(vals))

        return MetricsCI(
            stp=agg(m.stp for m in per_seed),
            antt=agg(m.antt for m in per_seed),
            fairness=agg(m.fairness for m in per_seed),
            n_seeds=len(seeds))

    def unfinished_total(self, **filters) -> int:
        return sum(c.window.n_unfinished for c in self.select(**filters))


# ----------------------------------------------------------------- cache
# The record store itself (NaN-safe JSON, the bounded LRU mirror,
# packfiles, atomic writes, tmp scavenging) and the cell runners live in
# :mod:`repro.core.distrib` — the execution tier shared by every
# dispatcher.  This module owns the *keys*: what identifies a cell.

#: Result-determining source files per machine: any edit to these changes
#: every cache key, so result-changing commits auto-invalidate without a
#: manual CACHE_VERSION bump.  machine.py/events.py carry SchedulerCore's
#: dispatch logic and the decision types; workload.py holds the DES
#: duration model (KernelSpec.duration/base_t); scenarios.py holds the
#: executor bridge's block-cost mapping (_synthetic_shape/_jitted_block);
#: metrics.py shapes the window/queueing numbers *stored in* every cache
#: record.  Over-invalidation (e.g. an unrelated scenario edit) merely
#: recomputes; under-invalidation silently serves stale numbers.
#:
#: Each tuple must equal the transitive closure of repro.core-internal
#: imports from the machine's result-determining entry points
#: (``repro.analysis.importgraph.ENTRY_POINTS``) — enforced statically by
#: ``python -m repro.analysis`` and by tests/test_analysis.py.  The
#: closure over-approximates (an import edge counts even if unexercised:
#: scenarios.py pulls executor.py into the closed-loop DES fingerprint via
#: the ExecutorJob bridge import), which is the safe direction for a
#: cache key.
#: The three tables are identical: distrib.py — the cell
#: runners + record store every dispatcher executes through — joins every
#: machine's entry points, and its own closure (simulator + engines for
#: the DES runner, scenarios + executor for the bridge) pulls each
#: machine's remaining sources in.  The unification over-invalidates
#: (e.g. an engine edit now also invalidates executor records) but keeps
#: one provenance domain across dispatchers: a record computed on a
#: remote worker is keyed by exactly the code the local path would have
#: run, and the worker handshake compares these same fingerprints.
_FINGERPRINT_SOURCES: Dict[str, Tuple[str, ...]] = {
    # fastsim/fastsim_c/fastsim_twin: the compiled event-loop engine
    # (DESIGN.md Section 10) is reachable from simulate()'s lazy engine
    # selection, and although it is gated bit-identical to the reference
    # loop, an edit to it must invalidate DES cells — under-invalidation
    # would silently serve records produced by unvetted engine code.
    "des": ("distrib", "simulator", "machine", "events", "policies",
            "predictor", "workload", "metrics", "scenarios", "executor",
            "fastsim", "fastsim_c", "fastsim_twin"),
    # Closed-loop DES cells also depend on scenarios.py directly: the
    # arrival *process* code (not a materialized list) determines what the
    # cell simulates, so an edit to it must invalidate those cells.
    "des-closed": ("distrib", "simulator", "machine", "events", "policies",
                   "predictor", "workload", "metrics", "scenarios",
                   "executor", "fastsim", "fastsim_c", "fastsim_twin"),
    "executor": ("distrib", "simulator", "machine", "events", "policies",
                 "predictor", "workload", "metrics", "scenarios",
                 "executor", "fastsim", "fastsim_c", "fastsim_twin"),
}


def fingerprint_sources() -> Dict[str, Tuple[str, ...]]:
    """Per-machine fingerprint tables, as a defensive copy.

    Public read surface for the static analyzer's coverage pass and the
    drift tests; the table itself stays private so nothing mutates what
    the cache keys are built from."""
    return dict(_FINGERPRINT_SOURCES)

_code_fp_memo: Dict[str, str] = {}


def _code_fingerprint(machine: str = "des") -> str:
    """Digest of the sources whose behavior cached results depend on."""
    fp = _code_fp_memo.get(machine)
    if fp is None:
        h = hashlib.sha256()
        for modname in _FINGERPRINT_SOURCES[machine]:
            h.update(Path(__file__).with_name(f"{modname}.py").read_bytes())
        fp = h.hexdigest()[:16]
        _code_fp_memo[machine] = fp
    return fp


def code_fingerprints() -> Dict[str, str]:
    """Every fingerprint this code tree produces, by machine key.

    The dispatcher/worker handshake payload: a worker whose fingerprints
    disagree with the dispatcher's refuses the run, because records it
    computed would be keyed by code the parent is not running."""
    return {m: _code_fingerprint(m) for m in _FINGERPRINT_SOURCES}


def _des_solo_key(spec: KernelSpec, seed: int, n_sm: int) -> str:
    return _canonical_digest({
        "version": CACHE_VERSION, "kind": "solo",
        "code": _code_fingerprint("des"),
        "spec": dataclasses.asdict(spec), "seed": seed, "n_sm": n_sm,
    })


def _device_name(device) -> str:   # the executor's device as a key string
    return "cuda" if device is None else str(device)


def _executor_solo_key(spec: KernelSpec, n_lanes: int,
                       pool_jobs: int, device: Optional[str]) -> str:
    # pool_jobs is the worker-pool width the baseline was measured under:
    # a baseline measured serially and one measured next to pool
    # neighbours contending for CPU are different measurements and must
    # not share a cache entry (the executor-sweep fidelity contract).
    return _canonical_digest({
        "version": CACHE_VERSION, "kind": "solo", "machine": "executor",
        "measured": True, "code": _code_fingerprint("executor"),
        "spec": dataclasses.asdict(spec), "n_lanes": n_lanes,
        "pool_jobs": pool_jobs, "device": _device_name(device),
    })


def solo_runtime_cached(spec: KernelSpec, seed: int = 0, n_sm: int = N_SM,
                        cache_dir: Optional[Union[str, Path]] = None
                        ) -> float:
    """Measured FIFO solo runtime of ``spec``, through the sweep cache."""
    cache_dir = Path(cache_dir) if cache_dir is not None else None
    key = _des_solo_key(spec, seed, n_sm)
    hit = _cache_read(cache_dir, key)
    if hit is not None:
        return float(hit["runtime"])
    rt = solo_runtime(spec, lambda: make_policy("fifo"), n_sm=n_sm,
                      seed=seed)
    _cache_write(cache_dir, key, {"runtime": rt})
    return rt


def _measure_des_solo(payload: dict) -> float:
    """Measure one DES solo baseline (module-level: pickles into the fork
    pool when a cold sweep has several baselines to simulate)."""
    return solo_runtime(payload["spec"], lambda: make_policy("fifo"),
                        n_sm=payload["n_sm"], seed=payload["seed"])


def _measure_executor_solo(payload: dict) -> float:
    """Measure one executor solo baseline (module-level: pickles into the
    spawn pool when solos are measured under cell-like pool contention)."""
    spec = payload["spec"]
    job = executor_job(Arrival(spec, 0.0, uid=f"{spec.name}#0"),
                       n_lanes=payload["n_lanes"],
                       time_scale=payload["time_scale"], device=payload["device"])
    return solo_runtime_executor(job, lambda: make_policy("fifo"),
                                 n_lanes=payload["n_lanes"])


def solo_runtime_executor_cached(
        spec: KernelSpec, n_lanes: int = 4,
        time_scale: float = DEFAULT_EXECUTOR_TIME_SCALE,
        cache_dir: Optional[Union[str, Path]] = None,
        pool_jobs: int = 1, device: Optional[str] = None) -> float:
    """Measured solo runtime of ``spec`` bridged onto the real-JAX lane
    executor, through the sweep cache.

    Keyed like :func:`solo_runtime_cached` — spec content, machine size and
    code fingerprint — WITHOUT a per-run nonce: solo baselines are the
    expensive, stable part of an executor sweep and are deliberately reused
    across runs (the ``measured`` field marks the record as a wall-clock
    measurement, so consumers know reuse trades freshness for speed).
    ``pool_jobs`` labels the pool-contention conditions of the measurement
    and is part of the key (see :func:`_executor_solo_key`); this serial
    helper only reads/writes the ``pool_jobs`` it is told, the pooled
    measurement itself lives in :func:`run_sweep`.
    """
    cache_dir = Path(cache_dir) if cache_dir is not None else None
    key = _executor_solo_key(spec, n_lanes, pool_jobs, device)
    hit = _cache_read(cache_dir, key)
    if hit is not None:
        return float(hit["runtime"])
    rt = _measure_executor_solo(
        {"spec": spec, "n_lanes": n_lanes, "time_scale": time_scale, "device": device})
    _cache_write(cache_dir, key,
                 {"runtime": rt, "measured": True, "pool_jobs": pool_jobs})
    return rt


def _cell_key(arrivals: Sequence[Arrival], policy: str, predictor: str,
              seed: int, n_sm: int, until: Optional[float],
              solo: Dict[str, float], machine: str = "des",
              nonce: Optional[str] = None,
              time_scale: Optional[float] = None,
              engine: Optional[str] = None,
              wl_digest: Optional[str] = None, device: Optional[str] = None) -> str:
    # The workload content enters through scenarios.workload_digest — the
    # one canonical payload (spec fields + times + uids) shared with tests
    # and documentation.  ``wl_digest`` lets _queue_spec pass the digest it
    # already computed for this arrival list (non-reordering policies of
    # one workload all share it); the value is workload_digest(arrivals)
    # either way, so keys cannot depend on who computed it.
    payload = {
        "version": CACHE_VERSION, "kind": "cell", "machine": machine,
        "code": _code_fingerprint(machine),
        "workload": (workload_digest(arrivals)
                     if wl_digest is None else wl_digest),
        "policy": policy, "predictor": predictor, "seed": seed,
        "n_sm": n_sm, "until": until, "solo": solo,
    }
    if machine == "des":
        # The resolved engine token ("python" / "compiled-native" / ...)
        # also fingerprints numba/native availability — bit-identity is
        # gated, but provenance must never silently mix across records.
        payload["engine"] = engine_token(engine)
    if machine == "executor":
        # Executor cells are wall-clock measurements: the nonce makes every
        # run_sweep invocation re-measure (no cross-run hit pretending
        # bit-identity) while in-run dedup (SJF == FIFO) still applies.
        payload["measured"] = True
        payload["nonce"] = nonce
        payload["time_scale"] = time_scale
        payload["device"] = device
    return _canonical_digest(payload)


def _closed_cell_key(scn: ClosedLoopScenario, wl_name: str, policy: str,
                     predictor: str, seed: int, n_sm: int,
                     until: Optional[float], solo: Dict[str, float],
                     machine: str = "des", nonce: Optional[str] = None,
                     time_scale: Optional[float] = None,
                     engine: Optional[str] = None, device: Optional[str] = None) -> str:
    # Closed-loop cells have no materialized arrival list to digest: the
    # key digests the *process parameters* + seed instead (the process +
    # the machine's deterministic completions fully determine the
    # arrivals).  The DES fingerprint widens to "des-closed" because the
    # process *code* in scenarios.py is now result-determining.
    payload = {
        "version": CACHE_VERSION, "kind": "cell", "machine": machine,
        "closed_loop": True,
        "code": _code_fingerprint(
            "des-closed" if machine == "des" else machine),
        "process": scn.process_params(),
        "workload": wl_name,
        "policy": policy, "predictor": predictor, "seed": seed,
        "n_sm": n_sm, "until": until, "solo": solo,
    }
    if machine == "des":
        payload["engine"] = engine_token(engine)
    if machine == "executor":
        payload["measured"] = True
        payload["nonce"] = nonce
        payload["time_scale"] = time_scale
        payload["device"] = device
    return _canonical_digest(payload)


# ---------------------------------------------------------------- worker
def _effective(arrivals: Sequence[Arrival], policy: str,
               solo: Dict[str, float]) -> Tuple[List[Arrival], str]:
    """The (arrival list, policy) a cell actually simulates.

    SJF/LJF are realized the way the paper realizes them (Section 2): FIFO
    over the oracle-reordered arrival list.  Keying the cache on this
    *effective* content dedups them against the FIFO cells of the mirrored
    workloads — a pre-refactor ``run_workload`` invariant, now exploited.
    """
    if policy in ORACLE_ORDER_POLICIES:
        return (reorder_for_oracle(arrivals, solo,
                                   longest_first=(policy == "ljf")), "fifo")
    return list(arrivals), policy


# ---------------------------------------------------------------- runner
def _materialize(spec: SweepSpec) -> Tuple[List[tuple], Dict[tuple, KernelSpec]]:
    """Pass 1: expand the grid into per-(scenario, seed) workloads and the
    solo-oracle demand.

    Returns ``(worklist, solo_specs)``: worklist entries are
    ``(scn, seed, wl_name, arrivals_or_None, wl_specs)`` — ``arrivals`` is
    ``None`` for closed-loop workloads (the worker builds the process) and
    ``wl_specs`` maps every kernel name the workload may mention to its
    spec; ``solo_specs`` maps solo memo keys to the spec to measure.

    Solo oracles are keyed by *spec content*, not name: two workloads may
    reuse a kernel name with different spec fields, and a name-keyed table
    would last-write-win and corrupt the earlier workload's STP/ANTT.
    Within one workload the name must be unambiguous (the machines look
    oracles up by spec name), so a same-name conflict there is an error.
    """
    on_executor = spec.machine == "executor"
    worklist: List[tuple] = []
    solo_specs: Dict[tuple, KernelSpec] = {}

    def memo_key(kspec: KernelSpec, seed: int) -> tuple:
        return (kspec, spec.machine, None if on_executor else seed,
                spec.n_sm)

    for scn_ref in spec.scenarios:
        base = make_scenario(scn_ref)
        for seed in spec.seeds:
            scn = base.reseeded(seed)
            if isinstance(scn, ClosedLoopScenario):
                # No arrival list exists yet — the mix declares every
                # kernel the process may emit, so the solo oracle covers
                # the full mix up front.
                mix = dict(scn.mix_specs())
                for name, kspec in mix.items():
                    if kspec.name != name:
                        raise ValueError(
                            f"mix_specs() of {scn.name!r} maps {name!r} "
                            f"to a spec named {kspec.name!r}")
                    solo_specs[memo_key(kspec, seed)] = kspec
                for wl_name in scn.process_names():
                    worklist.append((scn, seed, wl_name, None, mix))
                continue
            for wl_name, arrivals in scn.workloads():
                wl_specs: Dict[str, KernelSpec] = {}
                for a in arrivals:
                    name = a.spec.name
                    prev = wl_specs.get(name)
                    if prev is not None and prev != a.spec:
                        raise ValueError(
                            f"workload {wl_name!r} uses kernel name "
                            f"{name!r} for two different specs; solo "
                            "oracles are looked up by name within one "
                            "workload")
                    wl_specs[name] = a.spec
                    solo_specs[memo_key(a.spec, seed)] = a.spec
                worklist.append((scn, seed, wl_name, arrivals, wl_specs))
    return worklist, solo_specs


def _measure_solos(solo_specs: Dict[tuple, KernelSpec], spec: SweepSpec,
                   jobs: int, cache_dir: Optional[Path]
                   ) -> Tuple[Dict[tuple, float], Dict[str, int]]:
    """Measure (or load) every solo baseline the sweep needs.

    DES solos are deterministic simulations: cache misses fan out through
    a fork pool of the sweep's width (they were serial even under
    ``jobs > 1`` once — pure fixed cost at the head of every cold
    sweep), and since each is a pure function of (spec, seed, n_sm), pool
    order cannot affect the values.
    Executor solos are wall-clock measurements, and with ``jobs > 1`` the
    *cells* will run inside a worker pool contending for CPU; baselines
    measured serially in the quiet parent would then be systematically
    faster than the co-run cells, inflating every slowdown (the ROADMAP
    executor-sweep fidelity item).  So with ``jobs > 1`` the baselines are
    measured through the same spawn pool, same width, the cache key
    records the pool width they were measured under, and any miss
    re-measures the sweep's *whole* solo set together (partial fills
    would measure nearly alone in the pool and undercount contention).
    """
    memo: Dict[tuple, float] = {}
    computed = 0
    if spec.machine != "executor":
        keys = {mk: _des_solo_key(kspec, mk[2], spec.n_sm)
                for mk, kspec in solo_specs.items()}
        misses = []
        for mk, key in keys.items():
            hit = _cache_read(cache_dir, key)
            if hit is not None:
                memo[mk] = float(hit["runtime"])
            else:
                misses.append(mk)
        pool_jobs = min(max(1, jobs), max(1, len(misses)))
        if misses:
            payloads = [{"spec": solo_specs[mk], "n_sm": spec.n_sm,
                         "seed": mk[2]} for mk in misses]
            if pool_jobs > 1:
                with ProcessPoolExecutor(max_workers=pool_jobs) as pool:
                    runtimes = list(pool.map(_measure_des_solo, payloads,
                                             chunksize=1))
            else:
                runtimes = [_measure_des_solo(p) for p in payloads]
            for mk, rt in zip(misses, runtimes):
                memo[mk] = float(rt)
                _cache_write(cache_dir, keys[mk], {"runtime": rt})
            computed = len(misses)
        return memo, {"solo_computed": computed,
                      "solo_pool_jobs": pool_jobs}

    pool_jobs = max(1, jobs)
    keys = {mk: _executor_solo_key(kspec, spec.n_sm, pool_jobs, spec.device)
            for mk, kspec in solo_specs.items()}
    hits = {mk: _cache_read(cache_dir, key) for mk, key in keys.items()}
    if pool_jobs > 1 and any(hit is None for hit in hits.values()):
        # All-or-nothing under a pool: a lone miss dispatched through an
        # otherwise-idle pool would measure *uncontended* and then sit in
        # the cache next to contention-measured neighbours — the exact
        # bias this path exists to remove.  Re-measuring the whole solo
        # set together keeps every baseline of this sweep mutually
        # consistent (solo sets are small next to cells).
        hits = {mk: None for mk in hits}
    misses = [mk for mk, hit in hits.items() if hit is None]
    for mk, hit in hits.items():
        if hit is not None:
            memo[mk] = float(hit["runtime"])
    if misses:
        payloads = [{"spec": solo_specs[mk], "n_lanes": spec.n_sm,
                     "time_scale": spec.time_scale, "device": spec.device} for mk in misses]
        if pool_jobs > 1:
            ctx = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(max_workers=pool_jobs,
                                     mp_context=ctx) as pool:
                runtimes = list(pool.map(_measure_executor_solo, payloads,
                                         chunksize=1))
        else:
            runtimes = [_measure_executor_solo(p) for p in payloads]
        for mk, rt in zip(misses, runtimes):
            memo[mk] = float(rt)
            _cache_write(cache_dir, keys[mk],
                         {"runtime": rt, "measured": True,
                          "pool_jobs": pool_jobs})
        computed = len(misses)
    return memo, {"solo_computed": computed, "solo_pool_jobs": pool_jobs}


def _queue_spec(spec: SweepSpec, jobs: int, cache_dir: Optional[Path],
                records: Dict[str, dict], pending: List[dict]) -> dict:
    """Pass 2 for one spec: resolve every cell against the cache and the
    shared ``records``/``pending`` state; returns the spec's bookkeeping
    (ordered cell labels + per-spec stats)."""
    on_executor = spec.machine == "executor"
    # Executor cells are measurements: a fresh nonce per run keeps them out
    # of cross-run cache hits while in-run dedup still works.  Baselined
    # determinism finding (uuid): the nonce exists precisely to be unique
    # per run; it uniquifies keys and never shapes a result.
    nonce = uuid.uuid4().hex if on_executor else None
    # Resolve the engine axis once per spec: the resolved name goes into
    # every worker payload and its token into every DES cell key, so a
    # spec run under "auto" on two hosts with different backends can never
    # share records across engine provenance.
    engine = None if on_executor else (spec.engine or default_engine())

    worklist, solo_specs = _materialize(spec)
    solo_memo, solo_stats = _measure_solos(solo_specs, spec, jobs, cache_dir)

    ordered: List[Tuple[str, dict]] = []   # (key, labels) in cell order
    hits = dedup = queued = 0
    for scn, seed, wl_name, arrivals, wl_specs in worklist:
        closed = arrivals is None
        wl_solo = {
            name: solo_memo[(kspec, spec.machine,
                             None if on_executor else seed, spec.n_sm)]
            for name, kspec in wl_specs.items()
        }
        # One digest per arrival list, not one per cell: every
        # non-reordering policy of this workload keys the same content
        # (oracle-reordered SJF/LJF lists digest separately below).
        base_digest = None if closed else workload_digest(arrivals)
        for policy in spec.policies:
            if closed and policy in ORACLE_ORDER_POLICIES:
                raise ValueError(
                    f"policy {policy!r} is realized as FIFO over an "
                    "oracle-reordered arrival list, but closed-loop "
                    f"scenario {scn.name!r} has no materialized arrivals "
                    "to reorder")
            if closed:
                eff_arrivals, eff_policy = None, policy
                eff_digest = None
            else:
                eff_arrivals, eff_policy = _effective(
                    arrivals, policy, wl_solo)
                eff_digest = (workload_digest(eff_arrivals)
                              if policy in ORACLE_ORDER_POLICIES
                              else base_digest)
            for pred in spec.predictors:
                pred_name = DEFAULT_PREDICTOR if pred is None else pred
                if closed:
                    key = _closed_cell_key(
                        scn, wl_name, eff_policy, pred_name, seed,
                        spec.n_sm, spec.until, wl_solo,
                        machine=spec.machine, nonce=nonce,
                        time_scale=spec.time_scale, engine=engine, device=spec.device)
                else:
                    key = _cell_key(eff_arrivals, eff_policy, pred_name,
                                    seed, spec.n_sm, spec.until, wl_solo,
                                    machine=spec.machine, nonce=nonce,
                                    time_scale=spec.time_scale,
                                    engine=engine, wl_digest=eff_digest, device=spec.device)
                ordered.append((key, {
                    "scenario": scn.name, "workload": wl_name,
                    "policy": policy, "predictor": pred_name,
                    "seed": seed,
                }))
                if key in records:
                    # In-flight dedup: SJF == FIFO of the mirrored
                    # workload, or a sibling spec in the same batch.
                    dedup += 1
                    continue
                hit = _cache_read(cache_dir, key)
                if hit is not None:
                    hits += 1
                    records[key] = hit
                    continue
                records[key] = _PENDING
                queued += 1
                payload = {
                    "key": key, "arrivals": eff_arrivals,
                    "policy": eff_policy, "predictor": pred_name,
                    "seed": seed, "n_sm": spec.n_sm,
                    "until": spec.until, "solo": wl_solo,
                    "machine": spec.machine,
                    "time_scale": spec.time_scale,
                    "cache_dir": cache_dir,
                    "engine": engine,
                    "device": spec.device,
                }
                if closed:
                    payload["closed_loop"] = True
                    payload["scenario_obj"] = scn
                    payload["workload_name"] = wl_name
                pending.append(payload)
    return {
        "ordered": ordered,
        "stats": {
            "cells": len(ordered), "cache_hits": hits,
            "computed": queued, "deduplicated": dedup,
            "jobs": jobs, "machine": spec.machine,
            "engine": None if engine is None else engine_token(engine),
            **solo_stats,
        },
    }


def _execute_pending(pending: List[dict], jobs: int,
                     records: Dict[str, dict]) -> None:
    """Run every queued payload (one pool per machine kind) and fill
    ``records``."""
    by_machine: Dict[str, List[dict]] = {}
    for payload in pending:
        by_machine.setdefault(payload["machine"], []).append(payload)
    for machine, batch in by_machine.items():
        # Longest-cells-first dispatch (LPT): DES cell cost tracks the
        # total block count, and launching the SHA1-sized cells first
        # keeps them off the pool's tail.  The sort is stable, so
        # equal-cost policy siblings stay adjacent — the chunk runner's
        # staging prototype depends on that adjacency.  Results are keyed
        # by cell key, so dispatch order never affects the output.
        def _cost(payload: dict) -> float:
            arrivals = payload.get("arrivals")
            if arrivals is None:
                return math.inf      # closed loop: unknown, go first
            return float(sum(a.spec.num_blocks for a in arrivals))

        if machine == "executor":
            if jobs > 1:
                # Executor cells run real JAX, and forking a process with
                # an initialized JAX runtime can deadlock — spawn workers
                # instead (they re-import and re-JIT, which the per-cell
                # compile cost dominates anyway).
                batch.sort(key=_cost, reverse=True)
                ctx = multiprocessing.get_context("spawn")
                with ProcessPoolExecutor(max_workers=jobs,
                                         mp_context=ctx) as pool:
                    results = list(pool.map(_run_cell, batch, chunksize=1))
            else:
                results = [_run_cell(p) for p in batch]
            for payload, record in zip(batch, results):
                records[payload["key"]] = record
            continue

        # DES: whole chunks run in-engine through run_des_chunk — one
        # packfile write per chunk instead of one cache file per cell,
        # and sibling cells share a staging prototype.  Pending cells are
        # known cache misses (pass 2 resolved hits), so the runner skips
        # the per-cell cache probe.  Fork is fine for the pure-Python DES.
        batch.sort(key=_cost, reverse=True)
        cache_dir = batch[0].get("cache_dir")
        if jobs > 1:
            size = chunk_size_for(len(batch), jobs)
            chunks = [(batch[i:i + size], cache_dir)
                      for i in range(0, len(batch), size)]
            with ProcessPoolExecutor(max_workers=jobs) as pool:
                for chunk_records in pool.map(_run_chunk, chunks):
                    records.update(chunk_records)
        else:
            records.update(run_des_chunk(batch, cache_dir,
                                         read_cache=False))


#: The two cell-dispatch tiers a sweep can run under.
DISPATCHERS = ("local", "queue")


def run_sweeps(specs: Sequence[SweepSpec], jobs: int = 1,
               cache_dir: Optional[Union[str, Path]] = None,
               dispatcher: str = "local",
               workers: Optional[int] = None,
               dispatch_opts: Optional[dict] = None) -> List[SweepResult]:
    """Execute several sweeps as ONE batch: all cache misses share one
    worker pool (one straggler tail instead of one per sweep) and cells
    shared between specs are computed once, in flight, instead of meeting
    through the on-disk cache.  Returns one :class:`SweepResult` per spec,
    exactly as consecutive :func:`run_sweep` calls would.

    ``dispatcher="local"`` (default) computes misses through the
    process-pool path; ``dispatcher="queue"`` serves them in chunks to
    ``workers`` (default ``jobs``) long-lived pull-based workers via
    :class:`repro.core.distrib.QueueDispatcher` — byte-identical records,
    DES specs only.  ``dispatch_opts`` passes through to the dispatcher
    (e.g. ``{"spawn_workers": False, "port": 5055}`` to serve remote
    workers, or ``{"chunk_cells": 16}`` to pin the chunking policy).
    """
    if dispatcher not in DISPATCHERS:
        raise ValueError(f"unknown dispatcher {dispatcher!r}; choose from "
                         f"{DISPATCHERS}")
    if dispatcher == "queue":
        for spec in specs:
            if spec.machine == "executor":
                raise ValueError(
                    "the queue dispatcher is DES-only: executor cells are "
                    "wall-clock measurements calibrated against local "
                    "pool contention (DESIGN.md Section 6); run executor "
                    "sweeps with dispatcher='local'")
    # Baselined determinism finding (wallclock): elapsed_s is driver-side
    # bookkeeping landing only in SweepResult.stats — never in a cell
    # record or a cache key.
    t0 = time.perf_counter()
    cache_dir = Path(cache_dir) if cache_dir is not None else None
    # Scavenge crashed writers' tmp orphans once per batch, before any
    # cell could race a fresh tmp file with the same name.
    scavenged = scavenge_cache_dir(cache_dir)
    records: Dict[str, dict] = {}          # key -> raw record
    pending: List[dict] = []
    queued = [_queue_spec(spec, jobs, cache_dir, records, pending)
              for spec in specs]
    batch_stats: Dict[str, float] = {"dispatcher": dispatcher,
                                     "tmp_scavenged": scavenged}
    # Baselined determinism finding (wallclock): dispatch_s brackets the
    # dispatch tier alone (pending list -> committed records) so the perf
    # lane can compare dispatchers on exactly the code the tier swaps;
    # stats-only, like elapsed_s.
    t_dispatch = time.perf_counter()
    if dispatcher == "queue" and pending:
        qd = QueueDispatcher(pending, cache_dir=cache_dir,
                             workers=workers if workers is not None else jobs,
                             fingerprints=code_fingerprints(),
                             **(dispatch_opts or {}))
        qrecords, qstats = qd.run()
        records.update(qrecords)
        batch_stats.update(qstats)
    else:
        _execute_pending(pending, jobs, records)
    batch_stats["dispatch_s"] = time.perf_counter() - t_dispatch
    elapsed = time.perf_counter() - t0
    memo = cache_memo_stats()
    batch_stats.update(elapsed_s=elapsed,
                       memo_entries=memo["entries"],
                       memo_hits=memo["hits"],
                       memo_evictions=memo["evictions"])
    out = []
    for entry in queued:
        cells = [CellResult.from_record(records[key], **labels)
                 for key, labels in entry["ordered"]]
        out.append(SweepResult(cells, {**entry["stats"], **batch_stats}))
    return out


def run_sweep(spec: SweepSpec, jobs: int = 1,
              cache_dir: Optional[Union[str, Path]] = None,
              dispatcher: str = "local",
              workers: Optional[int] = None,
              dispatch_opts: Optional[dict] = None) -> SweepResult:
    """Execute every cell of ``spec``; see the module docstring."""
    return run_sweeps([spec], jobs=jobs, cache_dir=cache_dir,
                      dispatcher=dispatcher, workers=workers,
                      dispatch_opts=dispatch_opts)[0]


__all__ = [
    "CACHE_VERSION",
    "CellResult",
    "DISPATCHERS",
    "DispatchError",
    "QueueDispatcher",
    "cache_memo_stats",
    "clear_cache_memo",
    "code_fingerprints",
    "ENGINES",
    "fingerprint_sources",
    "MACHINES",
    "MetricsCI",
    "scavenge_cache_dir",
    "SweepResult",
    "SweepSpec",
    "run_sweep",
    "run_sweeps",
    "solo_runtime_cached",
    "solo_runtime_executor_cached",
]
