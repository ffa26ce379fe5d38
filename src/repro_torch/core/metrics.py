"""Multiprogram performance metrics (paper Section 6).

* STP  — system throughput (Eyerman & Eeckhout [9]): sum of normalized
  progress, ``STP = sum_i T_solo_i / T_multi_i`` (higher is better).
* ANTT — average normalized turnaround time: ``mean_i T_multi_i / T_solo_i``
  (lower is better).
* StrictF — fairness (Vandierendonck & Seznec [36]): ratio of minimum to
  maximum slowdown; 1.0 means perfectly fair.

Closed two-program workloads always finish, so :func:`evaluate` demands at
least one finished kernel and raises :class:`MetricsError` on degenerate
inputs (empty turnaround map, non-positive runtimes) instead of letting a
``ZeroDivisionError`` surface from deep inside a sweep.  Open-loop and
truncated runs (``run(until=...)``) go through :func:`evaluate_window`:
STP/ANTT/fairness over the kernels that *finished* inside the observation
window, plus makespan, utilization and finished/unfinished counts, so
results with unfinished kernels are first-class instead of silently
dropped.

Closed-loop (sustained-traffic) runs additionally go through
:func:`evaluate_queueing`: steady-state queueing metrics — mean/p95
response time, time-averaged number in system, throughput — over the
post-warmup part of the observation window.  Warmup trimming discards
kernels that *arrived* before ``warmup_frac`` of the window, so transient
cold-start behavior does not pollute the steady-state numbers; degenerate
trims (nothing completed after the trim, empty window) raise
:class:`MetricsError` following the same convention as :func:`evaluate`
and :func:`geomean`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence


class MetricsError(ValueError):
    """Degenerate metric input (empty or non-positive runtimes)."""


@dataclass(frozen=True)
class WorkloadMetrics:
    stp: float
    antt: float
    fairness: float

    def as_dict(self) -> Dict[str, float]:
        return {"stp": self.stp, "antt": self.antt, "fairness": self.fairness}


@dataclass(frozen=True)
class WindowMetrics:
    """Completion-window evaluation of one (possibly truncated) run.

    ``stp``/``antt``/``fairness`` are computed over the ``n_finished``
    kernels that completed inside the window; they are ``nan`` when nothing
    finished (a truncated run is data, not an error).  ``makespan`` and
    ``end_time`` come from the machine (see
    :attr:`repro.core.simulator.SimResult.makespan`), ``utilization`` is
    the busy fraction of the machine over the window, and ``throughput``
    is finished kernels per unit machine time.
    """

    stp: float
    antt: float
    fairness: float
    n_finished: int
    n_unfinished: int
    makespan: float
    end_time: float
    utilization: float

    @property
    def complete(self) -> bool:
        return self.n_unfinished == 0

    @property
    def throughput(self) -> float:
        if self.end_time <= 0.0:
            return 0.0
        return self.n_finished / self.end_time

    def as_dict(self) -> Dict[str, float]:
        return {
            "stp": self.stp, "antt": self.antt, "fairness": self.fairness,
            "n_finished": self.n_finished, "n_unfinished": self.n_unfinished,
            "makespan": self.makespan, "end_time": self.end_time,
            "utilization": self.utilization,
        }

    @property
    def workload_metrics(self) -> Optional[WorkloadMetrics]:
        """The closed-workload view, or ``None`` if nothing finished."""
        if self.n_finished == 0:
            return None
        return WorkloadMetrics(self.stp, self.antt, self.fairness)


def slowdowns(turnaround: Dict[str, float],
              solo: Dict[str, float]) -> List[float]:
    out = []
    for key, multi in turnaround.items():
        try:
            base = solo[key]
        except KeyError:
            raise MetricsError(f"no solo runtime for kernel {key!r}") from None
        if base <= 0:
            raise MetricsError(f"non-positive solo runtime for {key!r}")
        if multi <= 0:
            raise MetricsError(f"non-positive turnaround for {key!r}")
        out.append(multi / base)
    return out


def evaluate(turnaround: Dict[str, float],
             solo: Dict[str, float]) -> WorkloadMetrics:
    """Compute STP/ANTT/StrictF for one multiprogrammed run.

    ``turnaround`` maps kernel keys to multiprogram turnaround times;
    ``solo`` maps the same keys to their isolated runtimes.  Raises
    :class:`MetricsError` on an empty or degenerate input; for truncated
    open-loop runs use :func:`evaluate_window` instead.
    """
    if not turnaround:
        raise MetricsError(
            "no finished kernels to evaluate "
            "(open-loop/truncated runs: use evaluate_window)")
    sd = slowdowns(turnaround, solo)
    stp = sum(1.0 / s for s in sd)
    antt = sum(sd) / len(sd)
    fairness = min(sd) / max(sd)
    return WorkloadMetrics(stp=stp, antt=antt, fairness=fairness)


def evaluate_window(
    turnaround: Dict[str, float],
    solo: Dict[str, float],
    unfinished: Sequence[str] = (),
    end_time: float = 0.0,
    makespan: Optional[float] = None,
    utilization: float = float("nan"),
) -> WindowMetrics:
    """Evaluate a run over its observation window (open-loop first-class).

    ``turnaround`` covers the kernels that finished inside the window;
    ``unfinished`` lists the keys that did not.  When nothing finished the
    quality metrics are ``nan`` rather than an error.
    """
    if turnaround:
        m = evaluate(turnaround, solo)
        stp, antt, fairness = m.stp, m.antt, m.fairness
    else:
        stp = antt = fairness = float("nan")
    if makespan is None:
        makespan = end_time
    return WindowMetrics(
        stp=stp, antt=antt, fairness=fairness,
        n_finished=len(turnaround), n_unfinished=len(unfinished),
        makespan=makespan, end_time=end_time, utilization=utilization)


@dataclass(frozen=True)
class QueueingMetrics:
    """Steady-state queueing view of one sustained-traffic run.

    All quantities are computed over the post-warmup observation window
    ``[warmup, end_time]``:

    * ``mean_response`` / ``p95_response`` — response (sojourn) time of the
      kernels that arrived after warmup *and* completed inside the window
      (``n_completed`` of ``n_observed`` such arrivals; pre-warmup
      arrivals are excluded because part of their sojourn lies in the
      transient),
    * ``mean_in_system`` — time-averaged number of kernels in the system
      (arrived, not yet finished), counting kernels still in flight,
    * ``throughput`` — **all** departures inside the post-warmup window
      per unit machine time, including kernels that arrived during warmup
      (a backlogged completion is a real steady-state departure).

    By Little's law ``mean_in_system ~= throughput * mean_response`` when
    the run is long enough to be stationary — a useful self-check, not an
    enforced identity.
    """

    mean_response: float
    p95_response: float
    mean_in_system: float
    throughput: float
    n_completed: int
    n_observed: int
    warmup: float
    end_time: float

    def as_dict(self) -> Dict[str, float]:
        return {
            "mean_response": self.mean_response,
            "p95_response": self.p95_response,
            "mean_in_system": self.mean_in_system,
            "throughput": self.throughput,
            "n_completed": self.n_completed,
            "n_observed": self.n_observed,
            "warmup": self.warmup,
            "end_time": self.end_time,
        }


def evaluate_queueing(
    arrival: Dict[str, float],
    finish: Dict[str, float],
    end_time: float,
    warmup_frac: float = 0.2,
) -> QueueingMetrics:
    """Steady-state queueing metrics over one observation window.

    ``arrival`` maps **every** kernel key (finished or in flight) to its
    arrival time; ``finish`` maps the finished subset to completion times;
    ``end_time`` is the machine clock when the run stopped.  The first
    ``warmup_frac`` of the window is trimmed: response-time statistics
    cover kernels arriving at or after ``warmup_frac * end_time`` (and
    inside the window), while the number-in-system integral and the
    departure-counting throughput run over ``[warmup, end_time]`` with
    kernels straddling the warmup edge clipped, not dropped.

    Raises :class:`MetricsError` on degenerate input — no arrivals, a
    non-positive window, ``warmup_frac`` outside ``[0, 1)``, a completion
    before its own arrival, or **zero completions after the warmup trim**
    (a run too short or too truncated to say anything about steady state).
    """
    if not arrival:
        raise MetricsError("no arrivals to evaluate")
    if end_time <= 0.0:
        raise MetricsError(f"non-positive observation window {end_time!r}")
    if not 0.0 <= warmup_frac < 1.0:
        raise MetricsError(
            f"warmup_frac must be in [0, 1); got {warmup_frac!r}")
    for key, t_done in finish.items():
        if key not in arrival:
            raise MetricsError(f"finished kernel {key!r} has no arrival")
        if t_done < arrival[key]:
            raise MetricsError(f"kernel {key!r} finished before it arrived")
    warmup = warmup_frac * end_time
    # Post-warmup arrivals *inside* the window: closed-loop feedback can
    # schedule arrivals past a truncation horizon, and those never entered
    # the observed system.
    observed = [k for k, t in arrival.items() if warmup <= t <= end_time]
    responses = sorted(
        finish[k] - arrival[k] for k in observed
        if k in finish and finish[k] <= end_time)
    if not responses:
        raise MetricsError(
            f"no completions after warmup trim (warmup={warmup:g}, "
            f"end_time={end_time:g}, {len(observed)} observed arrivals): "
            "run longer, truncate later, or lower warmup_frac")
    # time-averaged number in system over [warmup, end_time]: every kernel
    # contributes its in-system overlap with the window, in flight included.
    span = end_time - warmup
    busy = 0.0
    for key, t_in in arrival.items():
        t_out = min(finish.get(key, end_time), end_time)
        busy += max(0.0, t_out - max(t_in, warmup))
    # throughput counts every post-warmup departure (backlog drained from
    # warmup-era arrivals included), not just the response-stat cohort.
    departures = sum(1 for t in finish.values() if warmup < t <= end_time)
    p95_rank = max(0, math.ceil(0.95 * len(responses)) - 1)
    return QueueingMetrics(
        mean_response=sum(responses) / len(responses),
        p95_response=responses[p95_rank],
        mean_in_system=busy / span,
        throughput=departures / span,
        n_completed=len(responses),
        n_observed=len(observed),
        warmup=warmup,
        end_time=end_time)


def geomean(values: Iterable[float]) -> float:
    vals = [v for v in values]
    if not vals:
        raise MetricsError("geomean of an empty sequence")
    if any(v <= 0 or math.isnan(v) for v in vals):
        raise MetricsError(
            "geomean requires positive finite values; got degenerate input "
            f"{[v for v in vals if not v > 0 or math.isnan(v)][:4]!r}")
    return math.exp(sum(math.log(v) for v in vals) / len(vals))


def summarize(per_workload: Sequence[WorkloadMetrics]) -> WorkloadMetrics:
    """Geometric means across workloads (as in the paper's Table 5)."""
    if not per_workload:
        raise MetricsError("summarize of an empty workload list")
    return WorkloadMetrics(
        stp=geomean(m.stp for m in per_workload),
        antt=geomean(m.antt for m in per_workload),
        fairness=geomean(m.fairness for m in per_workload),
    )
