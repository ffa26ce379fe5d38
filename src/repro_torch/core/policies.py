"""Thread block scheduling policies (paper Section 5).

All policies target the formal :class:`repro.core.machine.Machine` protocol
— the only surface they may touch on the machine driving them (DES
simulator, real-JAX lane executor, or any future backend):

* ``bind(machine)``         — attach to a :class:`Machine`,
* ``decide(sm) -> Decision`` — typed scheduling decision for unit ``sm``
  (:class:`IssueGrant` / :class:`SampleOnSM` / :class:`Hold` /
  :class:`PreemptAtBoundary`, see :mod:`repro.core.events`),
* ``residency_cap(key, sm) -> int`` — per-kernel residency limit on ``sm``,
* event hooks ``on_arrival`` / ``on_block_end`` / ``on_kernel_end``
  (driven through :class:`repro.core.machine.SchedulerCore`).

Policies:

* :class:`FIFO`      — Fermi baseline (Section 5.2.1): strict arrival order;
  a later kernel issues only once every block of all earlier kernels has
  been dispatched.
* :class:`SJF` / :class:`LJF` — oracle orderings by true solo runtime
  (Section 2 / Fig. 1).  SJF is the unrealizable upper bound.
* :class:`MPMax`     — Just-in-Time MPMax (Section 5.2.2): FIFO order, but
  each kernel reserves resources for one block of each *currently running*
  co-runner; reservations are dropped when concurrency ceases.
* :class:`SRTF`      — Section 5.1.1: sample newly arrived kernels on one SM,
  broadcast the sampled ``t``, then run the predicted shortest-remaining-time
  kernel exclusively; preemption happens only at block boundaries, so
  hand-off delay emerges naturally (the :class:`PreemptAtBoundary` decision).
* :class:`SRTFAdaptive` — Section 5.1.2: SRTF plus a fairness monitor; when
  the projected slowdown gap exceeds ``unfairness_threshold`` (0.5), switch
  to sharing mode with the fastest kernel's residency capped at
  ``shared_residency`` (3) and co-runners taking the remaining resources.
"""

from __future__ import annotations

import math
import operator
from collections import deque
from typing import Dict, List, Optional

from .events import (
    Decision,
    Hold,
    IssueGrant,
    PreemptAtBoundary,
    SampleOnSM,
)

_INF = float("inf")
MAX_RESIDENCY_DEFAULT = 8

#: Sort key of the fairness rows (index 2 = predicted remaining time).
_BY_REMAINING = operator.itemgetter(2)

# Decisions are frozen dataclasses, so the recurring no-issue verdicts are
# shared module-level singletons: the DES asks for a decision on every
# issue opportunity, and allocating a fresh Hold per ask is pure overhead.
_HOLD_HEAD_OF_LINE = Hold("head-of-line kernel does not fit")
_HOLD_NO_UNDISPATCHED = Hold("no kernel with undispatched blocks")
_HOLD_SAMPLING = Hold("sample in flight on the sampling SM")
_HOLD_NO_ELIGIBLE = Hold("no eligible kernel with a prediction")
_HOLD_MPMAX = Hold("all kernels at their MPMax reservation caps")
_HOLD_ADAPTIVE = Hold("all kernels at their adaptive sharing caps")


class Policy:
    """Base class: unlimited residency, no issue grants."""

    name = "base"

    #: True when :meth:`residency_cap` never constrains below the spec's
    #: ``max_residency`` (the base behavior).  Machines then skip the cap
    #: query entirely on the per-issue fit path.  Subclasses that actually
    #: cap (MPMax, CappedFIFO, the adaptive sharing mode) set this False.
    unlimited_caps = True

    #: True when :meth:`residency_cap` is independent of the ``sm``
    #: argument — every built-in policy caps per *kernel*, so residency
    #: syncs query one unit and fan out the result.  A policy whose caps
    #: differ across units must set this False (the machine then falls
    #: back to the per-(kernel, unit) reference sync).
    uniform_caps = True

    #: True when the policy consumes runtime predictions (the SRTF
    #: family).  Policies that never read the predictor (FIFO, the oracle
    #: orderings, MPMax — the paper's baselines run on prediction-free
    #: hardware) set this False, and machines may then skip the per-block
    #: Algorithm-1 bookkeeping entirely; prediction *recording* or the
    #: reference path forces it back on.  Default True: a custom policy
    #: must opt out explicitly.
    uses_predictor = True

    def __init__(self):
        self.machine = None
        self._grants: Dict[str, IssueGrant] = {}

    def _grant(self, key: str) -> IssueGrant:
        """Shared per-kernel :class:`IssueGrant` (frozen => safe to reuse)."""
        g = self._grants.get(key)
        if g is None:
            g = self._grants[key] = IssueGrant(key)
        return g

    def bind(self, machine) -> None:
        """Attach to a :class:`repro.core.machine.Machine`."""
        self.machine = machine

    # -- event hooks ---------------------------------------------------------
    def on_arrival(self, key: str) -> None:
        pass

    def on_block_end(self, key: str, sm: int) -> None:
        pass

    def on_kernel_end(self, key: str) -> None:
        # Drop the finished kernel's cached decision singletons (subclass
        # hooks call super(): long-lived closed-loop machines inject
        # unboundedly many uniquely-keyed kernels).
        self._grants.pop(key, None)

    # -- decisions ------------------------------------------------------------
    def residency_cap(self, key: str, sm: int) -> int:
        return self._run(key).spec.max_residency

    def decide(self, sm: int) -> Decision:
        """Typed scheduling decision for unit ``sm``.

        Contract: decisions must be side-effect-free, pure functions of
        scheduler state (not of the clock), and an ``IssueGrant`` /
        ``SampleOnSM`` may only name a kernel the policy has verified
        with ``machine.can_fit(key, sm)`` — the DES fast path trusts
        grants and allocates without re-checking (the reference path,
        ``fast_path=False``, keeps a defensive re-check).
        """
        raise NotImplementedError

    # -- Machine-protocol helpers ---------------------------------------------
    def _run(self, key: str):
        return self.machine.run_state(key)

    def _active(self) -> List[str]:
        return self.machine.active_keys()

    def _fits(self, key: str, sm: int) -> bool:
        return self.machine.can_fit(key, sm)


class _OrderedPolicy(Policy):
    """Strict-priority issue: the highest-priority kernel with undispatched
    blocks blocks all later kernels (head-of-line semantics, as on Fermi)."""

    def order(self) -> List[str]:
        raise NotImplementedError

    def decide(self, sm: int) -> Decision:
        machine = self.machine
        for key in self.order():
            run = machine.run_state(key)
            if run.spec.num_blocks > run.issued:
                if machine.can_fit(key, sm):
                    return self._grant(key)
                return _HOLD_HEAD_OF_LINE
        return _HOLD_NO_UNDISPATCHED


class FIFO(_OrderedPolicy):
    name = "fifo"
    uses_predictor = False

    def order(self) -> List[str]:
        return self._active()

    def decide(self, sm: int) -> Decision:
        # Same head-of-line walk as _OrderedPolicy.decide, minus the
        # order() indirection: FIFO's order IS the active list, and this
        # is the single most-executed policy method in the repo.
        machine = self.machine
        for key in machine.active_keys():
            run = machine.run_state(key)
            if run.spec.num_blocks > run.issued:
                if machine.can_fit(key, sm):
                    return self._grant(key)
                return _HOLD_HEAD_OF_LINE
        return _HOLD_NO_UNDISPATCHED


class SJF(_OrderedPolicy):
    """Oracle Shortest Job First: requires true solo runtimes."""

    name = "sjf"
    uses_predictor = False
    _sign = 1.0

    def _runtime(self, key: str) -> float:
        rt = self.machine.oracle_runtime(key)
        if rt is None:
            rt = self._run(key).spec.solo_staircase_runtime()
        return rt

    def order(self) -> List[str]:
        keys = self._active()
        return sorted(keys, key=lambda k: (self._sign * self._runtime(k),
                                           self._run(k).order))


class LJF(SJF):
    name = "ljf"
    _sign = -1.0


class MPMax(Policy):
    """Just-in-Time MPMax (Section 5.2.2).

    In the normalised-resource model one block of kernel ``j`` occupies
    ``1/R_j`` of an SM, so kernel ``k`` reserving one block for each running
    co-runner caps its own residency at
    ``floor(R_k * (1 - sum_j 1/R_j))`` (>= 1).
    """

    name = "mpmax"
    unlimited_caps = False
    uses_predictor = False

    def __init__(self):
        super().__init__()
        self._caps: Dict[str, int] = {}

    def _recompute(self) -> None:
        active = self._active()
        self._caps = {}
        for key in active:
            spec = self._run(key).spec
            reserved = sum(
                self._run(other).spec.resource_fraction
                for other in active if other != key)
            cap = int(math.floor(spec.max_residency * (1.0 - reserved)))
            self._caps[key] = max(1, cap)

    def on_arrival(self, key: str) -> None:
        self._recompute()

    def on_kernel_end(self, key: str) -> None:
        super().on_kernel_end(key)
        self._recompute()

    def residency_cap(self, key: str, sm: int) -> int:
        return self._caps.get(key, self._run(key).spec.max_residency)

    def decide(self, sm: int) -> Decision:
        # FIFO order up to each kernel's MPMax limit; when a kernel hits its
        # limit the next kernel in FIFO order gets to issue (Section 5.2.2).
        machine = self.machine
        for key in machine.active_keys():
            run = machine.run_state(key)
            if run.spec.num_blocks > run.issued and machine.can_fit(key, sm):
                return self._grant(key)
        return _HOLD_MPMAX


class SRTF(Policy):
    """Shortest Remaining Time First with online sampling (Section 5.1.1)."""

    name = "srtf"
    sample_sm = 0

    def __init__(self):
        super().__init__()
        self.eligible: set = set()       # kernels with a usable prediction
        self.sampling: Optional[str] = None
        self.sample_queue: deque = deque()
        self._samples: Dict[str, SampleOnSM] = {}
        self._preempts: Dict[str, PreemptAtBoundary] = {}
        #: True while _remaining is the base implementation — the winner
        #: scan may then query the predictor inline instead of paying the
        #: polymorphic call per candidate (SRTFZeroSampling overrides it).
        self._plain_remaining = type(self)._remaining is SRTF._remaining

    # ------------------------------------------------------------- sampling
    def _start_next_sample(self) -> None:
        while self.sampling is None and self.sample_queue:
            key = self.sample_queue.popleft()
            if key in self.eligible:
                continue
            try:
                run = self._run(key)
            except KeyError:
                continue
            if run.finished:
                continue
            self.sampling = key

    def on_arrival(self, key: str) -> None:
        active = self._active()
        if len(active) == 1:
            # Arrived on an idle machine: runs immediately; its predictions
            # accumulate from its own execution.
            self.eligible.add(key)
        else:
            self.sample_queue.append(key)
            self._start_next_sample()

    def on_block_end(self, key: str, sm: int) -> None:
        if key == self.sampling and sm == self.sample_sm:
            t = self.machine.predictor.sampled_t(key, sm)
            if t is not None:
                self.machine.predictor.broadcast_t(key, t, from_sm=sm)
                self.eligible.add(key)
                self.sampling = None
                self._start_next_sample()

    def on_kernel_end(self, key: str) -> None:
        super().on_kernel_end(key)
        self._samples.pop(key, None)
        self._preempts.pop(key, None)
        self.eligible.discard(key)
        if self.sampling == key:
            self.sampling = None
        if key in self.sample_queue:
            self.sample_queue.remove(key)
        self._start_next_sample()
        # If only one kernel remains un-predicted, it no longer needs a
        # sample to be scheduled.
        active = self._active()
        if len(active) == 1:
            self.eligible.add(active[0])

    # ------------------------------------------------------------- ranking
    def _remaining(self, key: str, sm: int) -> float:
        predictor = self.machine.predictor
        r = predictor.remaining(key, sm)
        if r is None:
            r = predictor.gpu_remaining(key)
        return r if r is not None else _INF

    def _candidates(self, sm: int) -> List[str]:
        keys = [k for k in self._active()
                if k in self.eligible and self._run(k).unissued > 0]
        return sorted(keys, key=lambda k: (self._remaining(k, sm),
                                           self._run(k).order))

    def _best_candidate(self, sm: int) -> Optional[str]:
        """First entry of :meth:`_candidates` without building the sorted
        list — exclusive-mode ``decide`` only ever consults the winner.
        (Manual min over ``(remaining, order)``: same comparison the rank
        tuples performed, without allocating them.)"""
        machine = self.machine
        eligible = self.eligible
        active = machine.active_keys()
        # Candidate census first: a lone candidate wins regardless of its
        # predicted remaining time (the tie-break never fires), so the
        # predictor is only consulted when there is an actual race
        # (prediction reads are pure — skipping them cannot change state).
        sole = None
        count = 0
        for k in active:
            if k not in eligible:
                continue
            run = machine.run_state(k)
            if run.spec.num_blocks > run.issued:
                count += 1
                if count > 1:
                    break
                sole = k
        if count == 0:
            return None
        if count == 1:
            return sole
        predictor = machine.predictor if self._plain_remaining else None
        best_key = None
        best_rem = 0.0
        best_order = 0
        for k in active:
            if k not in eligible:
                continue
            run = machine.run_state(k)
            if run.spec.num_blocks <= run.issued:
                continue
            if predictor is not None:
                # Inline of the base _remaining (public predictor queries).
                rem = predictor.remaining(k, sm)
                if rem is None:
                    rem = predictor.gpu_remaining(k)
                    if rem is None:
                        rem = _INF
            else:
                rem = self._remaining(k, sm)
            if (best_key is None or rem < best_rem
                    or (rem == best_rem and run.order < best_order)):
                best_key, best_rem, best_order = k, rem, run.order
        return best_key

    def _sample(self, key: str) -> SampleOnSM:
        s = self._samples.get(key)
        if s is None:
            s = self._samples[key] = SampleOnSM(key)
        return s

    def _preempt(self, key: str) -> PreemptAtBoundary:
        p = self._preempts.get(key)
        if p is None:
            p = self._preempts[key] = PreemptAtBoundary(key)
        return p

    # --------------------------------------------------------------- decide
    def decide(self, sm: int) -> Decision:
        if self.sampling is not None and sm == self.sample_sm:
            key = self.sampling
            run = self.machine.run_state(key)
            if run.spec.num_blocks > run.issued \
                    and self.machine.can_fit(key, sm):
                return self._sample(key)
            return _HOLD_SAMPLING
        key = self._best_candidate(sm)
        if key is None:
            return _HOLD_NO_ELIGIBLE
        if self.machine.can_fit(key, sm):
            return self._grant(key)
        # Exclusive execution: do not backfill behind the SRTF winner
        # while its blocks (or a draining co-runner's) occupy the SM.
        return self._preempt(key)


class SRTFAdaptive(SRTF):
    """SRTF with fairness-driven adaptive resource sharing (Section 5.1.2)."""

    name = "srtf-adaptive"
    unlimited_caps = False

    def __init__(self, unfairness_threshold: float = 0.5,
                 shared_residency: int = 3, hysteresis: float = 0.05):
        super().__init__()
        self.unfairness_threshold = unfairness_threshold
        self.shared_residency = shared_residency
        self.hysteresis = hysteresis
        self.sharing = False
        self._caps: Dict[str, int] = {}
        self._excl_pred: Dict[str, float] = {}

    # -------------------------------------------------------------- fairness
    def _predictions(self) -> Optional[List[tuple]]:
        """Return [(key, elapsed, remaining, solo_estimate, spec)] or None.

        The spec rides along so the projections below never re-resolve
        runs through the machine (this runs on every block end)."""
        machine = self.machine
        eligible = self.eligible
        active = [k for k in machine.active_keys() if k in eligible]
        if len(active) < 2:
            return None
        predictor = machine.predictor
        now = machine.now
        rows = []
        for key in active:
            rem = predictor.gpu_remaining(key)
            if rem is None:
                return None
            run = machine.run_state(key)
            solo = self._excl_pred.get(key)
            if solo is None:
                solo = predictor.gpu_predicted_total(key, now)
            if solo is None or solo <= 0:
                return None
            rows.append((key, now - run.arrival_time, rem, solo, run.spec))
        return rows

    @staticmethod
    def _gap(slowdowns: List[float]) -> float:
        return max(slowdowns) - min(slowdowns)

    def _project_exclusive(self, rows) -> List[float]:
        # rows arrive sorted by remaining time (the _reevaluate contract;
        # one sort serves both projections).
        slow, acc = [], 0.0
        for _, elapsed, rem, solo, _spec in rows:
            acc += rem
            slow.append((elapsed + acc) / solo)
        return slow

    def _project_sharing(self, rows) -> List[float]:
        winner_key, w_elapsed, w_rem, w_solo, w_spec = rows[0]
        cur_cap = max(1, min(self._cap_now(winner_key, w_spec),
                             w_spec.max_residency))
        shared_w = min(self.shared_residency, w_spec.max_residency)
        ts1 = w_rem * cur_cap / shared_w
        slow = [(w_elapsed + ts1) / w_solo]
        for key, elapsed, rem, solo, spec in rows[1:]:
            full = spec.max_residency
            shared_cap = self._loser_cap(spec, w_spec)
            cur = max(1, min(self._cap_now(key, spec), full))
            s_l = rem * cur / shared_cap      # time to finish at shared cap
            if s_l <= ts1:
                slow.append((elapsed + s_l) / solo)
            else:
                tail = (s_l - ts1) * shared_cap / full
                slow.append((elapsed + ts1 + tail) / solo)
        return slow

    def _cap_now(self, key: str, spec=None) -> int:
        cap = self._caps.get(key)
        if cap is not None:
            return cap
        if spec is None:
            spec = self._run(key).spec
        return spec.max_residency

    def _loser_cap(self, spec, winner_spec) -> int:
        shared_w = min(self.shared_residency, winner_spec.max_residency)
        free_frac = 1.0 - shared_w * winner_spec.resource_fraction
        return max(1, int(math.floor(free_frac * spec.max_residency)))

    def _reevaluate(self) -> None:
        if not self.sharing and len(self.machine.active_keys()) < 2:
            return   # < 2 active kernels can never enter sharing mode
        rows = self._predictions()
        if rows is None:
            if self.sharing:
                self.sharing = False
                self._caps = {}
                self.machine.sync_residency_caps()
            return
        # One stable sort by remaining time serves both projections and
        # the winner pick (stable => same winner as a min() over the
        # arrival-ordered rows).
        rows.sort(key=_BY_REMAINING)
        gap_excl = self._gap(self._project_exclusive(rows))
        gap_shared = self._gap(self._project_sharing(rows))
        want_sharing = (
            gap_excl > self.unfairness_threshold
            and gap_shared < gap_excl - self.hysteresis)
        new_caps: Dict[str, int] = {}
        if want_sharing:
            winner = rows[0][0]
            winner_spec = rows[0][4]
            for key, _elapsed, _rem, _solo, spec in rows:
                if key == winner:
                    new_caps[key] = min(self.shared_residency,
                                        spec.max_residency)
                else:
                    new_caps[key] = self._loser_cap(spec, winner_spec)
        if want_sharing != self.sharing or new_caps != self._caps:
            self.sharing = want_sharing
            self._caps = new_caps
            self.machine.sync_residency_caps()

    # ------------------------------------------------------------------ hooks
    def on_arrival(self, key: str) -> None:
        super().on_arrival(key)
        self._reevaluate()

    def on_block_end(self, key: str, sm: int) -> None:
        super().on_block_end(key, sm)
        machine = self.machine
        if not self.sharing:
            # Remember the exclusive-conditions prediction (Section 5.1.2:
            # "the prediction from the exclusive part of a run").  On a
            # terminally-solo machine — this kernel is the only active one
            # and no arrival can ever come — the stored value is provably
            # unreachable (only _predictions() reads it, and only with
            # >= 2 active kernels), so the Eq. 2 machine sweep is elided.
            if len(machine.active_keys()) > 1 or machine.arrivals_pending():
                pred = machine.predictor.gpu_predicted_total(
                    key, machine.now)
                if pred is not None:
                    self._excl_pred[key] = pred
        self._reevaluate()

    def on_kernel_end(self, key: str) -> None:
        super().on_kernel_end(key)
        self._excl_pred.pop(key, None)
        self._reevaluate()

    # -------------------------------------------------------------- decisions
    def residency_cap(self, key: str, sm: int) -> int:
        if self.sharing and key in self._caps:
            return self._caps[key]
        return self._run(key).spec.max_residency

    def decide(self, sm: int) -> Decision:
        if not self.sharing:
            return super().decide(sm)
        if self.sampling is not None and sm == self.sample_sm:
            key = self.sampling
            run = self.machine.run_state(key)
            if run.spec.num_blocks > run.issued \
                    and self.machine.can_fit(key, sm):
                return self._sample(key)
            return _HOLD_SAMPLING
        # Sharing mode: co-run, shortest first, up to the adaptive caps.
        for key in self._candidates(sm):
            if self._fits(key, sm):
                return self._grant(key)
        return _HOLD_ADAPTIVE


class CappedFIFO(FIFO):
    """FIFO with a fixed residency cap — used to reproduce the paper's
    residency studies (Figs. 7/8/10), where residency is controlled by
    inflating dynamic shared memory."""

    name = "fifo-cap"
    unlimited_caps = False

    def __init__(self, cap: int = MAX_RESIDENCY_DEFAULT):
        super().__init__()
        self.cap = cap

    def residency_cap(self, key: str, sm: int) -> int:
        return self.cap


class SRTFZeroSampling(SRTF):
    """SRTF with oracle-provided runtimes instead of online sampling
    (the paper's zero-sampling experiment, Section 6.2.2): isolates the
    cost of sampling from the cost of hand-off delay.  Unrealizable, like
    SJF, but diagnostic."""

    name = "srtf-zero"

    def __init__(self):
        super().__init__()
        self._oracle_cache: Dict[str, Optional[float]] = {}

    def on_arrival(self, key: str) -> None:
        self.eligible.add(key)              # no sampling phase

    def on_kernel_end(self, key: str) -> None:
        super().on_kernel_end(key)
        self._oracle_cache.pop(key, None)

    def _remaining(self, key: str, sm: int) -> float:
        # Oracle runtimes are fixed per run: memoize the lookup (this is
        # queried per candidate on every decision).
        try:
            rt = self._oracle_cache[key]
        except KeyError:
            rt = self._oracle_cache[key] = self.machine.oracle_runtime(key)
        if rt is None:
            return super()._remaining(key, sm)
        run = self._run(key)
        frac_left = 1.0 - run.done / max(1, run.spec.num_blocks)
        return rt * frac_left


POLICIES = {
    "fifo": FIFO,
    "fifo-cap": CappedFIFO,
    "sjf": SJF,
    "ljf": LJF,
    "mpmax": MPMax,
    "srtf": SRTF,
    "srtf-zero": SRTFZeroSampling,
    "srtf-adaptive": SRTFAdaptive,
}


def make_policy(name: str, **kwargs) -> Policy:
    try:
        return POLICIES[name](**kwargs)
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r}; choose from {sorted(POLICIES)}") from None
