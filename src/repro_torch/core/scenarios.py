"""Scenario registry: named, seeded arrival-process generators.

The paper's evaluation grid (Tables 5-6) is {two-program ERCBench
workloads} x {policies} x {arrival offsets}; the ROADMAP's production story
needs far more — open-loop Poisson kernel streams shared-cloud style
(Kernelet), bursty ON/OFF DL traffic, N-program mixes, and replayed
production traces.  This module makes every one of those a first-class,
*named* workload generator with a single contract::

    scenario = make_scenario("poisson-open", seed=0, n_arrivals=8)
    workloads = scenario.workloads()   # -> List[(name, List[Arrival])]

mirroring the policy/predictor registries (``POLICIES``/``PREDICTORS``):
``SCENARIOS`` maps public names to classes, :func:`register_scenario` adds
new ones, :func:`make_scenario` resolves names (or passes instances
through).  Scenarios are **deterministic**: the same (scenario params,
seed) produce bit-identical arrival lists in any process — RNG streams are
seeded from ``zlib.crc32`` of the scenario name (stable across processes;
Python's ``hash()`` is salted), exactly like the simulator's per-kernel
noise streams.  That determinism is what makes sweep results
content-addressable (:mod:`repro.core.sweep`).

The contract is **two-tier** (DESIGN.md Section 7):

* **Open loop** (:class:`Scenario`): ``workloads()`` yields fixed, fully
  materialized arrival lists — arrivals do not react to machine state.
* **Closed loop** (:class:`ClosedLoopScenario`): ``make_process(name)``
  yields an **arrival process** — a seeded, stateful generator that is fed
  kernel completions by the machine (the
  :class:`~repro.core.events.ArrivalSource` feedback edge) and emits the
  next arrivals: offered load that reacts to how fast the scheduler
  drains it, the regime where preemptive SRTF is actually stress-tested.

Built-in open-loop scenarios:

* ``pair-stagger``  — the paper's 56 two-program ERCBench workloads
  (Section 6.1.3); byte-identical to
  :func:`repro.core.workload.two_program_workloads`.
* ``table6-offset`` — the second kernel arrives after a fraction of the
  first kernel's solo runtime (Table 6).
* ``poisson-open``  — open-loop Poisson arrivals over an
  ERCBench/Parboil2-like kernel mix (shared-cloud kernel streams).
* ``bursty``        — heavy-tail ON/OFF bursts (Pareto burst sizes,
  exponential gaps): the bursty many-kernel DL traffic shape.
* ``nprogram-mix``  — random closed N-program workloads (N > 2).
* ``trace-replay``  — arrivals replayed from a JSON trace (file or
  in-memory), for production traces and hermetic tests.
* ``diurnal``       — piecewise-rate (day/night) Poisson stream; the rate
  profile is calibratable from a ``trace-replay`` JSON
  (:func:`fit_diurnal_profile` / :meth:`Diurnal.from_trace`).

Built-in closed-loop scenarios:

* ``mgk-closed``    — M/G/k-style offered Poisson load with a bounded
  population: at most ``population`` kernels in the system; excess offered
  arrivals are deferred until a completion frees a slot (``admission=
  "defer"``) or rejected outright (``admission="drop"``).
* ``think-time``    — ``n_tenants`` independent tenants, each resubmitting
  a fresh kernel ``think ~ Exp(mean_think)`` after its previous one
  finishes (the interactive-user loop).
"""

from __future__ import annotations

import copy
import functools
import itertools
import json
import math
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Type, Union

import numpy as np

from .executor import ExecutorJob
from .workload import (
    Arrival,
    ERCBENCH,
    KernelSpec,
    PARBOIL2_LIKE,
    TABLE3_RUNTIME,
    two_program_workloads,
)

#: The single scenario contract: named workloads, each a list of arrivals.
Workload = Tuple[str, List[Arrival]]

#: Default open-loop mix: every ERCBench kernel except SHA1 (whose 22M-cycle
#: solo runtime would dominate any stream) plus the short/medium
#: Parboil2-like kernels.
OPEN_LOOP_MIX: Tuple[str, ...] = (
    "AES-d", "AES-e", "JPEG-d", "JPEG-e", "RayTracing", "SAD",
    "ImageDenoising-nlm2", "SGEMM", "CUTCP", "HISTO",
)


def _spec_table(extra: Optional[Dict[str, KernelSpec]] = None
                ) -> Dict[str, KernelSpec]:
    table = dict(ERCBENCH)
    table.update(PARBOIL2_LIKE)
    if extra:
        table.update(extra)
    return table


class Scenario:
    """Base class: a seeded arrival-process generator.

    Subclasses implement :meth:`workloads`; all randomness must come from
    :meth:`rng` so that (params, seed) fully determine the output.
    """

    name = "base"

    def __init__(self, seed: int = 0):
        self.seed = seed

    def rng(self, *extra: int) -> np.random.Generator:
        """Process-stable RNG stream for this (scenario, seed[, extra])."""
        name_hash = zlib.crc32(self.name.encode()) % (2 ** 31)
        return np.random.default_rng(
            np.random.SeedSequence(entropy=(self.seed, name_hash, *extra)))

    def workloads(self) -> List[Workload]:
        raise NotImplementedError

    def reseeded(self, seed: int) -> "Scenario":
        """A copy of this scenario drawing from ``seed`` instead.

        Used by the sweep runner so one declarative spec can sweep arrival
        draws and simulation noise coherently across seeds.
        """
        import copy
        clone = copy.copy(self)
        clone.seed = seed
        return clone


#: Registry of scenario implementations, keyed by their public name.
SCENARIOS: Dict[str, Type[Scenario]] = {}


def register_scenario(name: str):
    """Class decorator registering a :class:`Scenario` under ``name``."""

    def decorate(cls: Type[Scenario]) -> Type[Scenario]:
        cls.name = name
        SCENARIOS[name] = cls
        return cls

    return decorate


def make_scenario(spec: Union[str, Scenario], **kwargs) -> Scenario:
    """Resolve ``spec`` into a scenario instance.

    ``spec`` may be an instance (returned as-is; kwargs then disallowed) or
    a registered name constructed with ``**kwargs``.
    """
    if isinstance(spec, Scenario):
        if kwargs:
            raise ValueError("kwargs are only valid with a scenario name")
        return spec
    try:
        cls = SCENARIOS[spec]
    except KeyError:
        raise ValueError(
            f"unknown scenario {spec!r}; choose from {sorted(SCENARIOS)}"
        ) from None
    return cls(**kwargs)


@register_scenario("pair-stagger")
class PairStagger(Scenario):
    """The paper's two-program ERCBench workloads (Section 6.1.3).

    Deterministic (no RNG): delegates to
    :func:`~repro.core.workload.two_program_workloads`, so the 56-pair
    sweep produced through the registry is byte-identical to the
    hard-coded one the golden traces were pinned against.
    """

    def __init__(self, seed: int = 0,
                 names: Optional[Sequence[str]] = None,
                 stagger_cycles: float = 100.0,
                 both_orders: bool = True):
        super().__init__(seed)
        self.names = list(names) if names is not None else None
        self.stagger_cycles = stagger_cycles
        self.both_orders = both_orders

    def workloads(self) -> List[Workload]:
        return two_program_workloads(
            names=self.names, stagger_cycles=self.stagger_cycles,
            both_orders=self.both_orders)


@register_scenario("table6-offset")
class Table6Offset(Scenario):
    """Table 6: second kernel arrives after ``offset_fraction`` of the first
    kernel's solo runtime.  ``solo`` maps kernel names to the solo runtimes
    the offsets are computed from (defaults to the paper's Table 3 values;
    the benchmarks pass the simulator-measured ones)."""

    def __init__(self, seed: int = 0,
                 offset_fraction: float = 0.25,
                 names: Optional[Sequence[str]] = None,
                 solo: Optional[Dict[str, float]] = None):
        super().__init__(seed)
        self.offset_fraction = offset_fraction
        self.names = sorted(names) if names is not None else sorted(ERCBENCH)
        self.solo = dict(solo) if solo is not None else dict(TABLE3_RUNTIME)

    @property
    def suffix(self) -> str:
        """Workload-name suffix — the one place the fraction is formatted
        (consumers filter cells with ``workload.endswith(scn.suffix)``)."""
        return f"@{int(round(self.offset_fraction * 100))}"

    def workloads(self) -> List[Workload]:
        out: List[Workload] = []
        for a, b in itertools.permutations(self.names, 2):
            offset = self.offset_fraction * self.solo[a]
            wl = [
                Arrival(ERCBENCH[a], 0.0, uid=f"{a}#0"),
                Arrival(ERCBENCH[b], offset, uid=f"{b}#1"),
            ]
            out.append((f"{a}+{b}{self.suffix}", wl))
        return out


class _MixScenario(Scenario):
    """Shared machinery for scenarios drawing kernels from a named mix."""

    def __init__(self, seed: int = 0,
                 names: Sequence[str] = OPEN_LOOP_MIX,
                 specs: Optional[Dict[str, KernelSpec]] = None):
        super().__init__(seed)
        self.names = list(names)
        self.specs = _spec_table(specs)
        missing = [n for n in self.names if n not in self.specs]
        if missing:
            raise ValueError(f"unknown kernels in mix: {missing}")

    def _pick(self, rng: np.random.Generator) -> KernelSpec:
        return self.specs[self.names[int(rng.integers(len(self.names)))]]

    @staticmethod
    def _build(arrivals: List[Tuple[KernelSpec, float]]) -> List[Arrival]:
        return [Arrival(spec, t, uid=f"{spec.name}#{i}")
                for i, (spec, t) in enumerate(arrivals)]


@register_scenario("poisson-open")
class PoissonOpen(Scenario):
    """Open-loop Poisson kernel stream over an ERCBench/Parboil2-like mix.

    Shared-cloud style (Kernelet): kernels arrive regardless of machine
    state with exponential inter-arrival times of mean
    ``mean_interarrival`` cycles.  With ``n_workloads`` > 1 each workload
    is an independent draw of the same process.
    """

    def __init__(self, seed: int = 0,
                 names: Sequence[str] = OPEN_LOOP_MIX,
                 specs: Optional[Dict[str, KernelSpec]] = None,
                 n_arrivals: int = 8,
                 mean_interarrival: float = 100_000.0,
                 n_workloads: int = 2):
        self._mix = _MixScenario(seed, names, specs)
        super().__init__(seed)
        self.n_arrivals = n_arrivals
        self.mean_interarrival = mean_interarrival
        self.n_workloads = n_workloads

    def workloads(self) -> List[Workload]:
        out: List[Workload] = []
        for w in range(self.n_workloads):
            rng = self.rng(w)
            t = 0.0
            draws: List[Tuple[KernelSpec, float]] = []
            for _ in range(self.n_arrivals):
                draws.append((self._mix._pick(rng), t))
                t += float(rng.exponential(self.mean_interarrival))
            out.append((f"poisson{w}", self._mix._build(draws)))
        return out


def fit_bursty_profile(times: Sequence[float],
                       threshold: Optional[float] = None) -> Dict[str, float]:
    """Fit :class:`Bursty` parameters from observed arrival times (the
    bursty counterpart of :func:`fit_diurnal_profile`).

    Arrivals are split into bursts at gaps larger than ``threshold``.
    With ``threshold=None`` the split point is found by Otsu's method on
    the log-gaps (the split maximizing between-class variance): the
    within-burst and idle gaps are exponentials separated by orders of
    magnitude, so they form two log-space clusters and the variance
    criterion finds the valley deterministically.  Fitted values:

    * ``n_bursts`` / ``max_burst`` — observed burst count and largest
      burst size;
    * ``within_gap`` — mean intra-burst gap (0.0 when every burst has one
      arrival — nothing to calibrate);
    * ``idle_gap`` — mean inter-burst gap *minus* ``within_gap``: the
      generator draws ``Exp(within_gap) + Exp(idle_gap)`` between bursts,
      so the observed separation over-counts by one within-draw (clamped
      at 0; 0.0 when there is a single burst);
    * ``burst_alpha`` — continuous-Pareto MLE on cell midpoints
      (``alpha = n / sum(ln(size + 0.5))``; the ``max_burst`` censoring
      is ignored — adequate for the loose shapes scenarios need);
    * ``threshold`` — the split actually used.

    Raises :class:`ValueError` on degenerate input (no arrivals, negative
    times, a non-positive explicit threshold).
    """
    times = sorted(float(t) for t in times)
    if not times:
        raise ValueError("cannot fit a bursty profile to zero arrivals")
    if times[0] < 0.0:
        raise ValueError("negative arrival time in trace")
    gaps = [b - a for a, b in zip(times, times[1:])]
    if threshold is None:
        positive = sorted(g for g in gaps if g > 0.0)
        if len(positive) >= 2:
            logs = [math.log(g) for g in positive]
            # Otsu in one pass over the sorted logs: split after index k
            # maximizing w0*w1*(mu0-mu1)^2 (between-class variance).
            total = sum(logs)
            n = len(logs)
            acc = 0.0
            best_score, best_k = -1.0, 0
            for k in range(n - 1):
                acc += logs[k]
                w0 = k + 1
                w1 = n - w0
                mu0 = acc / w0
                mu1 = (total - acc) / w1
                score = w0 * w1 * (mu0 - mu1) ** 2
                if score > best_score:
                    best_score, best_k = score, k
            threshold = math.sqrt(positive[best_k] * positive[best_k + 1])
        elif positive:
            threshold = positive[0]
        else:
            threshold = 0.0
    elif threshold <= 0.0:
        raise ValueError("threshold must be positive")
    sizes = [1]
    intra: List[float] = []
    inter: List[float] = []
    for g in gaps:
        if g <= threshold:
            sizes[-1] += 1
            intra.append(g)
        else:
            sizes.append(1)
            inter.append(g)
    within = sum(intra) / len(intra) if intra else 0.0
    idle = max(0.0, sum(inter) / len(inter) - within) if inter else 0.0
    alpha = len(sizes) / sum(math.log(s + 0.5) for s in sizes)
    return {
        "n_bursts": len(sizes),
        "burst_alpha": alpha,
        "max_burst": max(sizes),
        "within_gap": within,
        "idle_gap": idle,
        "threshold": threshold,
    }


@register_scenario("bursty")
class Bursty(Scenario):
    """Heavy-tail ON/OFF arrival bursts (bursty DL inference traffic).

    Each burst holds ``1 + floor(Pareto(alpha))`` kernels (capped at
    ``max_burst``) spaced ``Exp(within_gap)`` apart; bursts are separated
    by ``Exp(idle_gap)`` quiet periods.  Use :meth:`from_trace` /
    :func:`fit_bursty_profile` to calibrate the burst-size and gap
    parameters from a ``trace-replay`` JSON, the way ``diurnal`` fits its
    rate profile.
    """

    def __init__(self, seed: int = 0,
                 names: Sequence[str] = OPEN_LOOP_MIX,
                 specs: Optional[Dict[str, KernelSpec]] = None,
                 n_bursts: int = 3,
                 burst_alpha: float = 1.5,
                 max_burst: int = 6,
                 within_gap: float = 1_000.0,
                 idle_gap: float = 500_000.0,
                 n_workloads: int = 2):
        self._mix = _MixScenario(seed, names, specs)
        super().__init__(seed)
        self.n_bursts = n_bursts
        self.burst_alpha = burst_alpha
        self.max_burst = max_burst
        self.within_gap = within_gap
        self.idle_gap = idle_gap
        self.n_workloads = n_workloads

    @classmethod
    def from_trace(cls, path: Optional[Union[str, Path]] = None,
                   trace: Optional[Union[list, dict]] = None,
                   threshold: Optional[float] = None,
                   **kwargs) -> "Bursty":
        """Calibrate burst-size/gap parameters from a ``trace-replay``-
        shaped JSON (first workload's arrival times); see
        :func:`fit_bursty_profile` for the fit itself."""
        replay = TraceReplay(path=path, trace=trace,
                             specs=kwargs.get("specs"))
        workloads = replay.workloads()
        if not workloads or not workloads[0][1]:
            raise ValueError("trace holds no arrivals to calibrate from")
        profile = fit_bursty_profile(
            [a.time for a in workloads[0][1]], threshold=threshold)
        return cls(n_bursts=profile["n_bursts"],
                   burst_alpha=profile["burst_alpha"],
                   max_burst=profile["max_burst"],
                   within_gap=profile["within_gap"],
                   idle_gap=profile["idle_gap"], **kwargs)

    def workloads(self) -> List[Workload]:
        out: List[Workload] = []
        for w in range(self.n_workloads):
            rng = self.rng(w)
            t = 0.0
            draws: List[Tuple[KernelSpec, float]] = []
            for _ in range(self.n_bursts):
                size = min(self.max_burst,
                           1 + int(rng.pareto(self.burst_alpha)))
                for _ in range(size):
                    draws.append((self._mix._pick(rng), t))
                    t += float(rng.exponential(self.within_gap))
                t += float(rng.exponential(self.idle_gap))
            out.append((f"bursty{w}", self._mix._build(draws)))
        return out


@register_scenario("nprogram-mix")
class NProgramMix(Scenario):
    """Random closed N-program workloads (N > 2): every kernel arrives
    within the first ``max_stagger`` cycles, generalizing the paper's
    two-program staggered launches to wider co-run sets."""

    def __init__(self, seed: int = 0,
                 names: Sequence[str] = OPEN_LOOP_MIX,
                 specs: Optional[Dict[str, KernelSpec]] = None,
                 n_programs: int = 4,
                 max_stagger: float = 100.0,
                 n_workloads: int = 4):
        if n_programs < 2:
            raise ValueError("nprogram-mix needs n_programs >= 2")
        self._mix = _MixScenario(seed, names, specs)
        super().__init__(seed)
        self.n_programs = n_programs
        self.max_stagger = max_stagger
        self.n_workloads = n_workloads

    def workloads(self) -> List[Workload]:
        out: List[Workload] = []
        for w in range(self.n_workloads):
            rng = self.rng(w)
            draws = [(self._mix._pick(rng),
                      0.0 if i == 0 else
                      float(rng.uniform(0.0, self.max_stagger)))
                     for i in range(self.n_programs)]
            draws.sort(key=lambda d: d[1])
            out.append((f"mix{w}x{self.n_programs}", self._mix._build(draws)))
        return out


@register_scenario("trace-replay")
class TraceReplay(Scenario):
    """Replay arrivals from a JSON trace (production traces, hermetic tests).

    Accepts either ``path`` to a JSON file or an in-memory ``trace``.
    Two shapes are understood::

        [{"kernel": "JPEG-d", "time": 0.0}, ...]                # one workload
        {"workloads": [{"name": "w0", "arrivals": [...]}, ...]} # several

    Kernel names resolve against ERCBench + Parboil2-like specs plus any
    caller-supplied ``specs``.  Deterministic by construction (no RNG).
    """

    def __init__(self, seed: int = 0,
                 path: Optional[Union[str, Path]] = None,
                 trace: Optional[Union[list, dict]] = None,
                 specs: Optional[Dict[str, KernelSpec]] = None,
                 name: str = "trace"):
        super().__init__(seed)
        if (path is None) == (trace is None):
            raise ValueError("trace-replay needs exactly one of path/trace")
        self.path = str(path) if path is not None else None
        self.trace = trace
        self.specs = _spec_table(specs)
        self.workload_name = name

    def _events(self) -> Union[list, dict]:
        if self.path is not None:
            return json.loads(Path(self.path).read_text())
        return self.trace

    def _arrivals(self, events: Sequence[dict]) -> List[Arrival]:
        out = []
        for i, ev in enumerate(events):
            kernel = ev["kernel"]
            try:
                spec = self.specs[kernel]
            except KeyError:
                raise ValueError(
                    f"trace kernel {kernel!r} not in spec table") from None
            out.append(Arrival(spec, float(ev.get("time", 0.0)),
                               uid=ev.get("uid", f"{kernel}#{i}")))
        return sorted(out, key=lambda a: a.time)

    def workloads(self) -> List[Workload]:
        data = self._events()
        if isinstance(data, dict):
            return [(wl.get("name", f"{self.workload_name}{i}"),
                     self._arrivals(wl["arrivals"]))
                    for i, wl in enumerate(data["workloads"])]
        return [(self.workload_name, self._arrivals(data))]


# ----------------------------------------------------------------- diurnal
#: Named day/night rate profile: relative arrival rate per segment of the
#: repeating day (trough -> ramp -> sustained peak -> evening falloff).
DAY_NIGHT_PROFILE: Tuple[float, ...] = (
    0.15, 0.3, 0.7, 1.0, 1.0, 0.8, 0.5, 0.25)


def fit_diurnal_profile(times: Sequence[float], n_segments: int,
                        period: float) -> Tuple[Tuple[float, ...], float]:
    """Fit a :class:`Diurnal` ``(profile, peak_interarrival)`` from
    observed arrival times (e.g. a production ``trace-replay`` JSON).

    Arrival times are binned by ``time mod period`` into ``n_segments``
    equal segments over an observation span rounded up to whole periods;
    per-segment rates are normalized so the peak segment has relative rate
    1.0, and ``peak_interarrival`` is the peak segment's mean interarrival
    gap.  Raises :class:`ValueError` on degenerate input (no arrivals,
    non-positive period, fewer than one segment).
    """
    times = sorted(float(t) for t in times)
    if not times:
        raise ValueError("cannot fit a diurnal profile to zero arrivals")
    if times[0] < 0.0:
        raise ValueError("negative arrival time in trace")
    if period <= 0.0 or n_segments < 1:
        raise ValueError("need period > 0 and n_segments >= 1")
    # Observation span rounded up to whole periods; the epsilon keeps a
    # span that is an exact multiple of the period (e.g. from_trace's
    # default period == max(times)) from counting a phantom extra period,
    # which would halve every fitted rate.
    n_periods = max(1, math.ceil(times[-1] / period - 1e-9))
    segment = period / n_segments
    counts = [0] * n_segments
    for t in times:
        rem = t % period
        if rem == 0.0 and t > 0.0:
            # An arrival at an exact period multiple closes the previous
            # period (from_trace's default period == max(times) puts the
            # last arrival here); binning it into segment 0 would inflate
            # the first segment's rate.
            counts[n_segments - 1] += 1
        else:
            counts[min(n_segments - 1, int(rem / segment))] += 1
    observed_per_segment = n_periods * segment
    rates = [c / observed_per_segment for c in counts]
    peak = max(rates)
    # times is non-empty, so at least one bin counted and peak > 0
    return tuple(r / peak for r in rates), 1.0 / peak


@register_scenario("diurnal")
class Diurnal(Scenario):
    """Piecewise-rate (non-homogeneous) Poisson stream: the day/night load
    shape real clusters see.

    The rate over a repeating day of ``len(profile)`` segments of
    ``segment`` cycles each is ``profile[j] / peak_interarrival`` —
    ``profile`` holds *relative* rates (peak 1.0), ``peak_interarrival``
    the mean gap at peak.  Arrivals are drawn by cumulative-hazard
    inversion (unit-rate exponentials mapped through the piecewise-linear
    integrated rate), so zero-rate segments are skipped exactly.  Use
    :meth:`from_trace` / :func:`fit_diurnal_profile` to calibrate the
    profile from a ``trace-replay`` JSON.
    """

    def __init__(self, seed: int = 0,
                 names: Sequence[str] = OPEN_LOOP_MIX,
                 specs: Optional[Dict[str, KernelSpec]] = None,
                 n_arrivals: int = 12,
                 peak_interarrival: float = 40_000.0,
                 profile: Sequence[float] = DAY_NIGHT_PROFILE,
                 segment: float = 150_000.0,
                 n_workloads: int = 2):
        self._mix = _MixScenario(seed, names, specs)
        super().__init__(seed)
        self.profile = tuple(float(r) for r in profile)
        if not self.profile or min(self.profile) < 0.0 \
                or max(self.profile) <= 0.0:
            raise ValueError(
                "profile needs >= 1 non-negative relative rates, peak > 0")
        if peak_interarrival <= 0.0 or segment <= 0.0:
            raise ValueError("peak_interarrival and segment must be > 0")
        self.n_arrivals = n_arrivals
        self.peak_interarrival = peak_interarrival
        self.segment = segment
        self.n_workloads = n_workloads

    @classmethod
    def from_trace(cls, path: Optional[Union[str, Path]] = None,
                   trace: Optional[Union[list, dict]] = None,
                   n_segments: int = 8, period: Optional[float] = None,
                   **kwargs) -> "Diurnal":
        """Calibrate ``profile``/``peak_interarrival``/``segment`` from a
        ``trace-replay``-shaped JSON (first workload's arrival times).
        ``period`` defaults to the trace's observed span."""
        replay = TraceReplay(path=path, trace=trace,
                             specs=kwargs.get("specs"))
        workloads = replay.workloads()
        if not workloads or not workloads[0][1]:
            raise ValueError("trace holds no arrivals to calibrate from")
        times = [a.time for a in workloads[0][1]]
        if period is None:
            period = max(times) if max(times) > 0.0 else 1.0
        profile, peak = fit_diurnal_profile(times, n_segments, period)
        return cls(profile=profile, peak_interarrival=peak,
                   segment=period / n_segments, **kwargs)

    def _hazard_per_segment(self) -> List[float]:
        """Integrated rate (expected arrivals) of each segment."""
        return [r * self.segment / self.peak_interarrival
                for r in self.profile]

    def _invert(self, cum_hazard: float) -> float:
        """Arrival time whose integrated rate equals ``cum_hazard``."""
        seg_hazard = self._hazard_per_segment()
        per_period = sum(seg_hazard)
        period = self.segment * len(self.profile)
        k, rem = divmod(cum_hazard, per_period)
        t = k * period
        for j, h in enumerate(seg_hazard):
            if rem < h:  # lands inside segment j (rate > 0 since h > rem >= 0)
                return t + j * self.segment \
                    + rem * self.peak_interarrival / self.profile[j]
            rem -= h
        # rem == per_period boundary rounding: start of the next period
        return t + period

    def workloads(self) -> List[Workload]:
        out: List[Workload] = []
        for w in range(self.n_workloads):
            rng = self.rng(w)
            hazard = 0.0
            draws: List[Tuple[KernelSpec, float]] = []
            for _ in range(self.n_arrivals):
                draws.append((self._mix._pick(rng), self._invert(hazard)))
                hazard += float(rng.exponential(1.0))
            out.append((f"diurnal{w}", self._mix._build(draws)))
        return out


# ------------------------------------------------------- closed-loop tier
class ArrivalProcess:
    """Base class for completion-driven arrival generators.

    Implements the :class:`repro.core.events.ArrivalSource` machine
    contract: :meth:`initial` is called once at attach time,
    :meth:`on_completion` once per natural kernel completion.  A process
    is **stateful and single-use** — one machine run consumes one process;
    build a fresh one per run via
    :meth:`ClosedLoopScenario.make_process`.  Times are in scenario cycles
    (machines with other clocks convert — see
    :meth:`repro.core.machine.MachineBase.attach_arrival_source`).
    """

    def initial(self) -> List[Arrival]:
        raise NotImplementedError

    def on_completion(self, key: str, now: float) -> List[Arrival]:
        raise NotImplementedError


class ClosedLoopScenario(Scenario):
    """Tier-2 scenario contract: named, seeded arrival *processes*.

    Closed-loop scenarios cannot materialize ``workloads()`` — the arrival
    sequence depends on the machine's completions, which depend on the
    policy under test (that coupling is the point).  Instead they expose:

    * :meth:`process_names` — the workload names of the sweep grid,
    * :meth:`make_process`  — a fresh single-use :class:`ArrivalProcess`
      per (workload, run), seeded from (scenario seed, workload index),
    * :meth:`mix_specs`     — every kernel spec the process may emit
      (the sweep runner measures solo oracles from it up front),
    * :meth:`process_params` — the canonical parameter payload the sweep
      cache digests in place of a materialized arrival list.
    """

    def workloads(self) -> List[Workload]:
        raise TypeError(
            f"{self.name!r} is a closed-loop scenario: arrivals are "
            "completion-driven and cannot be materialized up front; use "
            "process_names()/make_process() (or run it through "
            "repro.core.sweep.run_sweep)")

    def process_names(self) -> List[str]:
        raise NotImplementedError

    def make_process(self, name: str) -> ArrivalProcess:
        raise NotImplementedError

    def mix_specs(self) -> Dict[str, KernelSpec]:
        raise NotImplementedError

    def process_params(self) -> dict:
        """Canonical cache-key payload: class + every draw-determining
        parameter + the full content of every spec the process may emit.
        The sweep seed is *not* included — the cell key carries it."""
        import dataclasses
        return {
            "scenario": self.name,
            "class": type(self).__name__,
            "params": self._params(),
            "specs": {n: dataclasses.asdict(s)
                      for n, s in sorted(self.mix_specs().items())},
        }

    def _params(self) -> dict:
        """Draw-determining parameters (primitives only); subclass hook
        for :meth:`process_params`."""
        raise NotImplementedError

    def _process_rng(self, name: str) -> np.random.Generator:
        """Per-(scenario, seed, workload) RNG stream for a fresh process."""
        names = self.process_names()
        try:
            index = names.index(name)
        except ValueError:
            raise ValueError(
                f"unknown workload {name!r}; choose from {names}") from None
        return self.rng(index)


class _MGkProcess(ArrivalProcess):
    """Bounded-population window over a pre-drawn offered Poisson stream.

    The offered stream (arrival gaps + kernel picks) is drawn up front, so
    the *demand* is identical across policies — only admission timing
    reacts to completions.  At most ``population`` released-but-unfinished
    kernels exist at any time; on each completion the next offered arrival
    is released at ``max(offered time, now)`` (``admission="defer"``) or
    offered arrivals whose time passed while the system was full are
    rejected and counted in :attr:`dropped` (``admission="drop"``).
    """

    def __init__(self, offered: List[Tuple[KernelSpec, float]],
                 population: int, admission: str):
        self._offered = offered
        self._population = population
        self._admission = admission
        self._next = 0
        self._in_system = 0
        self._live: set = set()   # uids this process emitted, unfinished
        #: Offered arrivals rejected by the admission cap (drop mode).
        self.dropped = 0

    def _release(self, at: Optional[float] = None) -> Arrival:
        spec, time = self._offered[self._next]
        uid = f"{spec.name}#{self._next}"
        self._next += 1
        self._in_system += 1
        self._live.add(uid)
        return Arrival(spec, time if at is None else max(time, at), uid=uid)

    def initial(self) -> List[Arrival]:
        out = []
        while self._next < len(self._offered) \
                and self._in_system < self._population:
            out.append(self._release())
        return out

    def on_completion(self, key: str, now: float) -> List[Arrival]:
        if key not in self._live:
            # The machine reports every natural completion; static
            # arrivals it was constructed with are not ours and must not
            # corrupt the population accounting.
            return []
        self._live.discard(key)
        self._in_system -= 1
        if self._admission == "drop":
            # Loss system: offered arrivals whose time passed while the
            # system was full found it full — reject them.
            while self._next < len(self._offered) \
                    and self._offered[self._next][1] < now:
                self._next += 1
                self.dropped += 1
        out = []
        while self._next < len(self._offered) \
                and self._in_system < self._population:
            out.append(self._release(at=now))
        return out

    # In-engine lowering (consumed by FastSimulator).  The offered stream
    # is pre-drawn, so "defer" admission is a pure function of completion
    # order: the j-th in-engine release is offered arrival _next + j.
    # "drop" admission depends on wall-clock `now` vs the offered times in
    # a way the engine doesn't model (dropped counting) — not lowered.
    def engine_stage(self, limit: int) -> Optional[dict]:
        if self._admission != "defer":
            return None
        end = min(len(self._offered), self._next + limit)
        specs = []
        times = []
        uids = []
        for j in range(self._next, end):
            spec, time = self._offered[j]
            specs.append(spec)
            times.append(time)
            uids.append(f"{spec.name}#{j}")
        return {
            "mode": "mgk", "specs": specs, "times": times, "uids": uids,
            "more": end < len(self._offered),
            "in_system": self._in_system,
            "population": self._population,
            "live": frozenset(self._live),
        }

    def engine_commit(self, consumed: int, in_system: int,
                      live: Sequence[str]) -> None:
        self._next += consumed
        self._in_system = in_system
        self._live = set(live)


@register_scenario("mgk-closed")
class MGkClosed(ClosedLoopScenario):
    """M/G/k-style offered load with a bounded population (closed loop).

    ``n_total`` offered arrivals per workload with mean gap
    ``mean_interarrival`` (the offered load), drawn from the kernel mix; at
    most ``population`` kernels in the system.  ``admission="defer"``
    queues excess offered arrivals until a completion frees a slot —
    sustained backpressure; ``admission="drop"`` is the admission-capped
    variant: arrivals that find the system full are rejected (the process
    counts them in ``dropped``).  Each of ``n_workloads`` workloads is an
    independent draw of the same offered process.
    """

    def __init__(self, seed: int = 0,
                 names: Sequence[str] = OPEN_LOOP_MIX,
                 specs: Optional[Dict[str, KernelSpec]] = None,
                 n_total: int = 12,
                 mean_interarrival: float = 50_000.0,
                 population: int = 4,
                 admission: str = "defer",
                 n_workloads: int = 1,
                 tag: str = ""):
        self._mix = _MixScenario(seed, names, specs)
        super().__init__(seed)
        if population < 1:
            raise ValueError("mgk-closed needs population >= 1")
        if admission not in ("defer", "drop"):
            raise ValueError(
                f"unknown admission {admission!r}; choose defer or drop")
        self.n_total = n_total
        self.mean_interarrival = mean_interarrival
        self.population = population
        self.admission = admission
        self.n_workloads = n_workloads
        #: Optional label folded into workload names (e.g. one tag per
        #: offered-load point, so load-sweep cells stay distinguishable).
        self.tag = tag

    def _params(self) -> dict:
        return {
            "names": list(self._mix.names), "n_total": self.n_total,
            "mean_interarrival": self.mean_interarrival,
            "population": self.population, "admission": self.admission,
            "n_workloads": self.n_workloads, "tag": self.tag,
        }

    def process_names(self) -> List[str]:
        prefix = f"mgk{self.tag}" if self.tag else "mgk"
        return [f"{prefix}.{w}" for w in range(self.n_workloads)]

    def mix_specs(self) -> Dict[str, KernelSpec]:
        return {n: self._mix.specs[n] for n in self._mix.names}

    def make_process(self, name: str) -> _MGkProcess:
        rng = self._process_rng(name)
        t = 0.0
        offered: List[Tuple[KernelSpec, float]] = []
        for _ in range(self.n_total):
            offered.append((self._mix._pick(rng), t))
            t += float(rng.exponential(self.mean_interarrival))
        return _MGkProcess(offered, self.population, self.admission)


class _ThinkTimeProcess(ArrivalProcess):
    """N tenants, each looping submit -> await completion -> think."""

    def __init__(self, rng: np.random.Generator, picks, mean_think: float,
                 n_tenants: int, n_rounds: int):
        self._rng = rng
        self._pick = picks
        self._mean_think = mean_think
        self._n_tenants = n_tenants
        self._n_rounds = n_rounds
        self._tenant_of: Dict[str, int] = {}
        self._rounds_done = [0] * n_tenants
        self._seq = 0

    def _submit(self, tenant: int, at: float) -> Arrival:
        spec = self._pick(self._rng)
        uid = f"{spec.name}#{self._seq}"
        self._seq += 1
        self._tenant_of[uid] = tenant
        self._rounds_done[tenant] += 1
        return Arrival(spec, at, uid=uid)

    def initial(self) -> List[Arrival]:
        # Each tenant thinks once before its first submission, so tenants
        # de-synchronize exactly like they do between rounds.
        return [
            self._submit(i, float(self._rng.exponential(self._mean_think)))
            for i in range(self._n_tenants)
        ]

    def on_completion(self, key: str, now: float) -> List[Arrival]:
        tenant = self._tenant_of.pop(key, None)
        if tenant is None or self._rounds_done[tenant] >= self._n_rounds:
            return []
        think = float(self._rng.exponential(self._mean_think))
        return [self._submit(tenant, now + think)]

    # In-engine lowering (consumed by FastSimulator).  Each resubmission
    # consumes one (think draw, spec pick) pair from the shared RNG in
    # completion order regardless of WHICH tenant completed, so the k-th
    # future pair is pre-drawable on a copy of the RNG; only its tenant
    # binding is decided in-engine.  `engine_commit` replays the consumed
    # draws on the real RNG so python and engine streams stay aligned.
    def engine_stage(self, limit: int) -> Optional[dict]:
        total = 0
        for done in self._rounds_done:
            if done < self._n_rounds:
                total += self._n_rounds - done
        n = min(total, limit)
        rng = copy.deepcopy(self._rng)
        specs = []
        delays = []
        uids = []
        for k in range(n):
            # Draw order matches on_completion -> _submit exactly.
            think = float(rng.exponential(self._mean_think))
            spec = self._pick(rng)
            specs.append(spec)
            delays.append(think)
            uids.append(f"{spec.name}#{self._seq + k}")
        return {
            "mode": "think", "specs": specs, "delays": delays,
            "uids": uids, "more": total > n,
            "n_rounds": self._n_rounds,
            "rounds_done": list(self._rounds_done),
            "tenants": dict(self._tenant_of),
        }

    def engine_commit(self, consumed: int, rounds_done: Sequence[int],
                      tenants: Dict[str, int]) -> None:
        for _ in range(consumed):
            self._rng.exponential(self._mean_think)
            self._pick(self._rng)
        self._seq += consumed
        self._rounds_done = list(rounds_done)
        self._tenant_of = dict(tenants)


@register_scenario("think-time")
class ThinkTime(ClosedLoopScenario):
    """Interactive-tenant loop (closed loop): each of ``n_tenants``
    tenants resubmits a fresh kernel from the mix ``think ~
    Exp(mean_think)`` cycles after its previous kernel finishes, for
    ``n_rounds`` rounds.  Offered load tracks service capacity by
    construction — the canonical closed queueing loop."""

    def __init__(self, seed: int = 0,
                 names: Sequence[str] = OPEN_LOOP_MIX,
                 specs: Optional[Dict[str, KernelSpec]] = None,
                 n_tenants: int = 3,
                 mean_think: float = 20_000.0,
                 n_rounds: int = 4,
                 n_workloads: int = 1):
        self._mix = _MixScenario(seed, names, specs)
        super().__init__(seed)
        if n_tenants < 1 or n_rounds < 1:
            raise ValueError("think-time needs n_tenants, n_rounds >= 1")
        self.n_tenants = n_tenants
        self.mean_think = mean_think
        self.n_rounds = n_rounds
        self.n_workloads = n_workloads

    def _params(self) -> dict:
        return {
            "names": list(self._mix.names), "n_tenants": self.n_tenants,
            "mean_think": self.mean_think, "n_rounds": self.n_rounds,
            "n_workloads": self.n_workloads,
        }

    def process_names(self) -> List[str]:
        return [f"think.{w}" for w in range(self.n_workloads)]

    def mix_specs(self) -> Dict[str, KernelSpec]:
        return {n: self._mix.specs[n] for n in self._mix.names}

    def make_process(self, name: str) -> _ThinkTimeProcess:
        return _ThinkTimeProcess(
            self._process_rng(name), self._mix._pick,
            self.mean_think, self.n_tenants, self.n_rounds)


def open_loop_names() -> Tuple[str, ...]:
    """Registered scenario names whose ``workloads()`` materializes (the
    CLI frontends that pace fixed submission streams filter on this)."""
    return tuple(sorted(
        name for name, cls in SCENARIOS.items()
        if not issubclass(cls, ClosedLoopScenario)))


# ------------------------------------------------------- executor bridge
#: Seconds of executor (lane) time per scenario cycle.  Chosen so that the
#: cycle-scale arrival gaps the scenarios emit (hundreds to a few thousand
#: cycles) land in the same regime as real measured block durations
#: (fractions of a millisecond).
DEFAULT_EXECUTOR_TIME_SCALE = 1e-6


def _synthetic_shape(spec: KernelSpec) -> Tuple[int, int]:
    """Deterministic (matrix dim, repeat count) for one kernel spec.

    The dim follows the grid's per-block parallelism (``threads_per_block``)
    and the repeat count the block-duration scale (``mean_t``), so distinct
    specs get distinct real costs and the SJF/SRTF orderings over synthetic
    jobs remain meaningful.
    """
    dim = max(16, min(128, int(spec.threads_per_block)))
    reps = max(1, min(6, int(math.log10(max(float(spec.mean_t), 10.0)))))
    return dim, reps


@functools.lru_cache(maxsize=None)
def _synthetic_block(dim: int, reps: int, device):
    """One synthetic block body and its input on ``device``, shared by
    every job with the same shape: ``x = tanh(x @ x) + 0.5 x``, ``reps``
    times, in eager float32.  torch is imported here, not with the module,
    so DES-only sweeps and their fork pools never load it."""
    import torch

    x0 = torch.linspace(-1.0, 1.0, dim * dim,
                        device=device).reshape(dim, dim)

    def step(x):
        for _ in range(reps):
            x = torch.tanh(x @ x) + 0.5 * x
        return x

    return step, x0


@functools.lru_cache(maxsize=None)
def _synthetic_graph(dim: int, reps: int, device):
    """:func:`_synthetic_block`'s body on its input captured as a CUDA
    graph on ``device`` (a card), once a shape: the first call (a job's
    warm-up) captures it, and every block replays it."""
    from ..graphs import capture

    step, x0 = _synthetic_block(dim, reps, device)
    return capture(lambda: step(x0), device)


def executor_job(arrival: Arrival, *, n_lanes: int = 4,
                 time_scale: float = DEFAULT_EXECUTOR_TIME_SCALE,
                 device=None) -> ExecutorJob:
    """Map one scenario :class:`~repro_torch.core.workload.Arrival` to a
    schedulable :class:`~repro_torch.core.executor.ExecutorJob`.

    The job keeps the scenario's declared grid (``num_blocks``, residency
    capped at the lane count) and arrival time (cycles scaled to seconds by
    ``time_scale``); each block is a REAL computation on ``device``
    (``cuda`` unless asked; raises without a card) whose cost is a
    deterministic function of the spec (:func:`_synthetic_shape`), so
    executor sweeps measure actual dispatch/compute behavior at
    scenario-declared sizes.  On the card a block replays the shape's
    CUDA graph (:func:`_synthetic_graph`) and ends in a synchronize, so
    the executor times the work and not its enqueueing; the warm-up runs
    one block, which puts the CUDA context, the cuBLAS handle and the
    graph's capture outside every measured block.
    """
    from .. import resolve_device

    dev = resolve_device(device)
    spec = arrival.spec
    dim, reps = _synthetic_shape(spec)

    def block():
        import torch

        if dev.type == "cuda":
            _synthetic_graph(dim, reps, dev).replay()   # cost only
            torch.cuda.synchronize(dev)
        else:
            step, x0 = _synthetic_block(dim, reps, dev)
            step(x0)                      # result discarded; cost only

    return ExecutorJob(
        name=spec.name, num_blocks=spec.num_blocks,
        max_residency=min(spec.max_residency, n_lanes),
        make_block_fn=lambda residency: block,
        arrival=arrival.time * time_scale,
        est_block_seconds=float(spec.mean_t),   # SJF fallback ordering only
        warmup_fn=block)


def executor_workload(arrivals: Sequence[Arrival], *, n_lanes: int = 4,
                      time_scale: float = DEFAULT_EXECUTOR_TIME_SCALE,
                      device=None) -> List[Tuple[str, ExecutorJob]]:
    """Bridge one scenario workload to ``(key, job)`` pairs, every block on
    ``device`` (``cuda`` unless asked).

    Keys are the scenario's arrival uids (``{name}#{i}``) so executor cells
    carry the same kernel keys as DES cells of the same workload; pass each
    pair to :meth:`~repro_torch.core.executor.LaneExecutor.add_job` as
    ``add_job(job, key=key)``.
    """
    return [(a.key, executor_job(a, n_lanes=n_lanes, time_scale=time_scale,
                                 device=device))
            for a in arrivals]


# --------------------------------------------------------------- utilities
def workload_digest(arrivals: Sequence[Arrival]) -> str:
    """Content digest of one arrival list (the sweep-cache workload key).

    Covers every :class:`KernelSpec` field plus arrival times and uids, so
    any change to the workload's content changes the digest.
    """
    import dataclasses
    import hashlib

    payload = [
        {"spec": dataclasses.asdict(a.spec), "time": a.time, "uid": a.uid}
        for a in arrivals
    ]
    # allow_nan=False: a NaN spec field would otherwise serialize as the
    # non-standard NaN token — and NaN != NaN, so two identical workloads
    # could digest differently.  Loud failure beats a poisoned cache key.
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"),
                      allow_nan=False)
    return hashlib.sha256(blob.encode()).hexdigest()


def submission_offsets(scenario: Union[str, Scenario], n: int,
                       time_scale: float = 1.0, **kwargs) -> List[float]:
    """First-workload arrival times as ``n`` submission offsets.

    The serving/dryrun frontends use this to pace real job submissions from
    a scenario's arrival process: offsets are the scenario's first
    workload's arrival times scaled by ``time_scale`` (e.g. cycles ->
    seconds).  If the workload holds fewer than ``n`` arrivals the stream
    is extended at the mean observed gap.
    """
    scn = make_scenario(scenario, **kwargs)
    workloads = scn.workloads()
    if not workloads:
        raise ValueError(f"scenario {scn.name!r} produced no workloads")
    times = sorted(a.time for a in workloads[0][1])
    if not times:
        raise ValueError(f"scenario {scn.name!r} produced an empty workload")
    gaps = [b - a for a, b in zip(times, times[1:])]
    mean_gap = (sum(gaps) / len(gaps)) if gaps else 0.0
    while len(times) < n:
        times.append(times[-1] + mean_gap)
    return [t * time_scale for t in times[:n]]


__all__ = [
    "ArrivalProcess",
    "Bursty",
    "ClosedLoopScenario",
    "DAY_NIGHT_PROFILE",
    "DEFAULT_EXECUTOR_TIME_SCALE",
    "Diurnal",
    "MGkClosed",
    "NProgramMix",
    "OPEN_LOOP_MIX",
    "executor_job",
    "executor_workload",
    "fit_bursty_profile",
    "fit_diurnal_profile",
    "open_loop_names",
    "PairStagger",
    "PoissonOpen",
    "SCENARIOS",
    "Scenario",
    "Table6Offset",
    "ThinkTime",
    "TraceReplay",
    "Workload",
    "make_scenario",
    "register_scenario",
    "submission_offsets",
    "workload_digest",
]
