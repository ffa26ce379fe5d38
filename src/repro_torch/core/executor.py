"""Real-JAX lane executor: the TPU-pod adaptation of the paper's thread
block scheduler, driving ACTUAL jit-compiled step functions.

Mapping (DESIGN.md Section 2): the machine is a pod partitioned into
``n_lanes`` gang-scheduled mesh slices; a *job* (training run / serving
batch) is a grid of ``num_blocks`` homogeneous *blocks* (steps); a job's
*residency* is the number of lanes it currently occupies.  Each lane runs
one block at a time, so the executor is the paper's machine with SMs=lanes.

Time model: lanes advance on a virtual clock ordered by *measured* wall
time of each real step execution (this container has one physical device,
so lane parallelism is virtual while every block's duration is a real
measurement — including JIT, cache and memory effects).  On a real pod the
same loop runs with concurrent lanes and wall-clock time.

The executor is the second concrete :class:`repro.core.machine.Machine`
(the DES simulator is the first): the same
:class:`repro.core.machine.SchedulerCore` — unmodified policies and
predictor — schedules both.  Jobs may be present up-front or arrive late
through :meth:`LaneExecutor.add_job` (the async
:mod:`repro.core.scheduler_service` frontend builds on this plus
:meth:`LaneExecutor.step` and :meth:`LaneExecutor.cancel`).

Fault tolerance: ``fail_lane_at`` kills a lane mid-run (its block is lost
and re-executed; the predictor starts a new slice since residency changed);
``straggler`` inflates one lane's durations until quarantined.
"""

from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from .events import BlockEnded, BlockStarted, KernelArrived, KernelEnded, grants_issue
from .machine import KernelRun, MachineBase
from .predictor import Predictor
from .workload import Arrival, KernelSpec


@dataclass
class ExecutorJob:
    """One schedulable job: ``make_block_fn(residency)`` returns a callable
    executing one block (one real jitted step) at that residency.
    ``warmup_fn`` AOT-compiles the job's step functions without mutating its
    state — the executor invokes it before scheduling so that measured block
    durations (and hence the predictor's sampled ``t``) reflect steady-state
    compute, not one-time JIT cost, as on a production system.
    ``tenant`` groups jobs for the multi-tenant service's per-tenant
    metrics; it defaults to the job name."""

    name: str
    num_blocks: int
    max_residency: int
    make_block_fn: Callable[[int], Callable[[], None]]
    arrival: float = 0.0
    est_block_seconds: float = 1.0   # only used by SJF's fallback oracle
    warmup_fn: Optional[Callable[[], None]] = None
    tenant: Optional[str] = None

    def grid_spec(self) -> KernelSpec:
        # Reuse KernelSpec so the unmodified policies see the paper's fields.
        return KernelSpec(
            name=self.name, num_blocks=self.num_blocks,
            max_residency=self.max_residency, threads_per_block=1,
            mean_t=self.est_block_seconds, rsd=0.0)


class _LaneState:
    __slots__ = ("index", "busy", "resident", "failed", "slow_factor")

    def __init__(self, index: int):
        self.index = index
        self.busy: Optional[str] = None       # job key currently running
        self.resident: Dict[int, str] = {}
        self.failed = False
        self.slow_factor = 1.0


@dataclass(frozen=True)
class ExecutorWindow:
    """Observation-window summary of one executor run.

    The executor-side mirror of :class:`repro.core.simulator.SimResult`'s
    window fields: per-job turnaround/finish times for jobs that completed
    inside the window, ``unfinished`` keys (cancelled jobs included) in
    arrival order, the machine clock at stop (``end_time``), a
    truncation-safe ``makespan`` and the busy-lane ``utilization``
    (in-flight blocks clipped at the window edge).  This is the record
    shape the sweep runner shares between both machines.
    """

    turnaround: Dict[str, float]
    finish: Dict[str, float]
    names: Dict[str, str]
    unfinished: Tuple[str, ...]
    end_time: float
    makespan: float
    utilization: float
    #: Arrival time of every job, finished or not (queueing metrics need
    #: the in-flight ones to integrate number-in-system over the window).
    arrival: Dict[str, float] = field(default_factory=dict)


@dataclass
class JobResult:
    key: str
    arrival: float
    finish: float
    blocks: int
    failures_absorbed: int = 0
    cancelled: bool = False

    @property
    def turnaround(self) -> float:
        return self.finish - self.arrival


class LaneExecutor(MachineBase):
    """:class:`Machine` implementation over real JAX step executions.

    Job keys follow the ``{name}#{order}`` convention: the part before the
    last ``#`` is the job/arch name (shared by solo-baseline maps), the part
    after is the machine-wide arrival order.  Split with
    ``key.rsplit("#", 1)[0]`` to recover the name.
    """

    def __init__(self, jobs: Sequence[ExecutorJob] = (), policy=None,
                 n_lanes: int = 4,
                 fail_lane_at: Optional[Tuple[int, float]] = None,
                 straggler: Optional[Tuple[int, float]] = None,
                 straggler_quarantine: float = 2.5,
                 predictor: Union[str, Predictor, None] = None,
                 job_bridge: Optional[Callable[[Arrival], ExecutorJob]] = None):
        super().__init__(n_lanes, policy, predictor=predictor)
        self.n_lanes = n_lanes
        #: Maps a scenario :class:`~repro.core.workload.Arrival` to a
        #: schedulable job — required for :meth:`inject_arrival` (the
        #: closed-loop feedback path; the sweep runner passes the real-JAX
        #: bridge from :mod:`repro.core.scenarios`, which also scales the
        #: arrival time from scenario cycles to lane seconds).
        self.job_bridge = job_bridge
        self.sms = [_LaneState(i) for i in range(n_lanes)]
        self.jobs: Dict[str, ExecutorJob] = {}
        self._block_fns: Dict[Tuple[str, int], Callable] = {}
        self.fail_lane_at = fail_lane_at
        self.straggler = straggler
        self.straggler_quarantine = straggler_quarantine
        self.failures_absorbed = 0
        self.lane_t_ewma: Dict[int, float] = {}
        self.results: Dict[str, JobResult] = {}
        self.trace: List[Tuple[str, int, float, float]] = []

        self._events: List[Tuple[float, int, int, tuple]] = []
        self._seq = itertools.count()
        self._bids = itertools.count()
        self._order = itertools.count()
        self._dead_blocks: set = set()
        self._lane_bid: Dict[int, int] = {}
        for job in sorted(jobs, key=lambda j: j.arrival):
            self.add_job(job, warmup=False)
        if fail_lane_at is not None:
            lane, t = fail_lane_at
            heapq.heappush(self._events, (t, 0, next(self._seq),
                                          ("fail_lane", lane)))
        if straggler is not None:
            self.sms[straggler[0]].slow_factor = straggler[1]
        for job in jobs:
            if job.warmup_fn is not None:
                job.warmup_fn()
        self.core.bind(self)

    # --------------------------------------------------------- job intake
    def add_job(self, job: ExecutorJob, *, key: Optional[str] = None,
                warmup: bool = True) -> str:
        """Register one job, possibly while the machine is running.

        The job arrives at ``max(now, job.arrival)`` — a late submission
        can never arrive in the machine's past.  Returns the job's key
        (``{name}#{order}`` — see the class docstring).
        """
        order = next(self._order)
        if key is None:
            key = f"{job.name}#{order}"
        if key in self.runs:
            raise ValueError(f"duplicate job key {key!r}")
        arrival = max(self.now, job.arrival)
        self.jobs[key] = job
        self.runs[key] = KernelRun(key, job.grid_spec(), arrival, order)
        self._invalidate_active()
        if warmup and job.warmup_fn is not None:
            job.warmup_fn()
        heapq.heappush(self._events,
                       (arrival, 0, next(self._seq), ("arrival", key)))
        return key

    def inject_arrival(self, arrival: Arrival) -> str:
        """Closed-loop feedback: bridge one scenario arrival to a job via
        :attr:`job_bridge` and register it with :meth:`add_job` (which
        clips the arrival to "now" and keeps the scenario uid as the key).
        """
        if self.job_bridge is None:
            raise ValueError(
                "LaneExecutor needs a job_bridge to inject scenario "
                "arrivals (pass job_bridge= at construction)")
        return self.add_job(self.job_bridge(arrival), key=arrival.key)

    def cancel(self, key: str) -> bool:
        """Cancel a job at the next block boundary.

        Already-running blocks complete (state stays consistent — the same
        property that makes preemption safe); no further blocks issue.
        Returns False if the job is unknown or already finished.
        """
        run = self.runs.get(key)
        if run is None or run.finished:
            return False
        run.cancelled = True
        run.finish_time = self.now
        self._invalidate_active(ended=key)
        self.results[key] = JobResult(
            key, run.arrival_time, self.now, run.done,
            self.failures_absorbed, cancelled=True)
        if run.launched:
            self.core.post(KernelEnded(key, self.now))
        self._dispatch()
        return True

    # ------------------------------------------------------------ machine
    def residency(self, key: str, sm: int) -> int:
        return int(self.sms[sm].busy == key)

    def _cap_residency(self, key: str, sm: int) -> int:
        # On the pod the residency cap constrains the machine-wide lane
        # count a job occupies (a lane runs one block at a time).
        return self._residency(key)

    def _fits_resources(self, key: str, sm: int) -> bool:
        lane = self.sms[sm]
        return lane.busy is None and not lane.failed

    def _residency(self, key: str) -> int:
        return sum(1 for ln in self.sms if ln.busy == key)

    # ------------------------------------------------------------ execution
    def _block_fn(self, key: str, residency: int) -> Callable[[], None]:
        job = self.jobs[key]
        residency = max(1, residency)
        ck = (key, residency)
        if ck not in self._block_fns:
            self._block_fns[ck] = job.make_block_fn(residency)
        return self._block_fns[ck]

    def pending_events(self) -> int:
        return len(self._events)

    def step(self) -> bool:
        """Process one machine event (then dispatch); False when idle."""
        if not self._events:
            return False
        t, _, _, payload = heapq.heappop(self._events)
        self.now = max(self.now, t)
        kind = payload[0]
        if kind == "arrival":
            self._on_arrival(payload[1])
        elif kind == "block_end":
            bid = payload[4]
            if bid >= 0 and bid in self._dead_blocks:
                return True                   # zombie event of lost block
            self._on_block_end(*payload[1:])
        elif kind == "fail_lane":
            self._on_fail_lane(payload[1])
        self._dispatch()
        return True

    def run(self, until: Optional[float] = None) -> Dict[str, JobResult]:
        """Drain the event queue; ``until`` truncates at a horizon.

        With ``until`` (seconds of virtual machine time) events past the
        horizon stay queued and the machine clock stops at the last
        processed event — the executor analogue of
        :meth:`repro.core.simulator.Simulator.run`'s open-loop mode.
        """
        while self._events:
            if until is not None and self._events[0][0] > until:
                break
            self.step()
        return self.results

    def window(self) -> "ExecutorWindow":
        """Observation-window view of the machine (see
        :class:`ExecutorWindow`); call after :meth:`run`."""
        turnaround: Dict[str, float] = {}
        finish: Dict[str, float] = {}
        names: Dict[str, str] = {}
        arrival: Dict[str, float] = {}
        unfinished: List[str] = []
        end_time = self.now
        for key, run in sorted(self.runs.items(), key=lambda kv: kv[1].order):
            names[key] = run.spec.name
            arrival[key] = run.arrival_time
            if run.finish_time is None or run.cancelled:
                unfinished.append(key)
                continue
            turnaround[key] = run.finish_time - run.arrival_time
            finish[key] = run.finish_time
        busy = sum(max(0.0, min(t1, end_time) - t0)
                   for _, _, t0, t1 in self.trace if t0 < end_time)
        util = (busy / (self.n_lanes * end_time)) if end_time > 0.0 else 0.0
        makespan = end_time if unfinished else max(finish.values(),
                                                   default=0.0)
        return ExecutorWindow(
            turnaround=turnaround, finish=finish, names=names,
            unfinished=tuple(unfinished), end_time=end_time,
            makespan=makespan, utilization=util, arrival=arrival)

    def _on_arrival(self, key: str) -> None:
        if self.runs[key].finished:
            return      # cancelled before its queued arrival event fired
        self.core.post(KernelArrived(key, self.now))

    def _on_block_end(self, key: str, lane_idx: int, lost: bool,
                      bid: int = -1) -> None:
        lane = self.sms[lane_idx]
        lane.busy = None
        run = self.runs[key]
        if lost:
            # failed lane: block's work is discarded, re-issue it
            run.issued -= 1
            self.failures_absorbed += 1
            self.core.post(BlockEnded(key, lane_idx, 0, self.now, lost=True))
            return
        if run.cancelled:
            # the job was cancelled while this block was in flight; the
            # block's work is kept (state is consistent), so count it and
            # settle the predictor's per-block bookkeeping — but nothing
            # more issues and the policy was already notified at cancel.
            run.done += 1
            self.results[key].blocks = run.done
            self.predictor.on_block_end(key, lane_idx, 0, self.now)
            return
        run.done += 1
        self.core.post(BlockEnded(key, lane_idx, 0, self.now))
        if run.done >= run.spec.num_blocks:
            run.finish_time = self.now
            self.results[key] = JobResult(
                key, run.arrival_time, self.now, run.done,
                self.failures_absorbed)
            self.core.post(KernelEnded(key, self.now))
            # Natural completion only: cancel() posts KernelEnded too, but
            # a frontend cancellation is not the machine finishing work and
            # must not trigger closed-loop resubmission.
            self._feed_completion(key)

    def _on_fail_lane(self, lane_idx: int) -> None:
        lane = self.sms[lane_idx]
        lane.failed = True
        if lane.busy is not None:
            # the in-flight block is lost: kill its completion event and
            # schedule the loss immediately
            key = lane.busy
            self._dead_blocks.add(self._lane_bid.get(lane_idx, -1))
            heapq.heappush(self._events,
                           (self.now, 0, next(self._seq),
                            ("block_end", key, lane_idx, True, -1)))
        # residency of every running job may have changed
        for key in self.active_keys():
            self.predictor.reslice_all(key)
        self.sync_residency_caps()

    def _dispatch(self) -> None:
        progressed = True
        while progressed:
            progressed = False
            for lane in self.sms:
                if lane.busy is not None or lane.failed:
                    continue
                key = grants_issue(self.core.decide(lane.index))
                if key is None or not self.can_fit(key, lane.index):
                    continue
                self._start_block(key, lane)
                progressed = True

    def _start_block(self, key: str, lane: _LaneState) -> None:
        run = self.runs[key]
        residency = self._residency(key) + 1
        fn = self._block_fn(key, residency)
        # Baselined determinism finding (wallclock): real wall time IS this
        # machine's time model — executor cells are measurements, marked
        # measured=True and nonce-keyed out of cross-run cache hits.
        t0 = time.perf_counter()
        fn()                                        # REAL computation
        dur = (time.perf_counter() - t0) * lane.slow_factor
        lane.busy = key
        run.issued += 1
        self.core.post(BlockStarted(key, lane.index, 0, self.now))
        self.trace.append((key, lane.index, self.now, self.now + dur))
        # straggler mitigation: quarantine lanes whose EWMA step time
        # exceeds the cross-lane median by the threshold factor
        ew = self.lane_t_ewma.get(lane.index, dur)
        self.lane_t_ewma[lane.index] = 0.7 * ew + 0.3 * dur
        self._maybe_quarantine()
        bid = next(self._bids)
        self._lane_bid[lane.index] = bid
        heapq.heappush(self._events,
                       (self.now + dur, 1, next(self._seq),
                        ("block_end", key, lane.index, False, bid)))

    def _maybe_quarantine(self) -> None:
        if len(self.lane_t_ewma) < max(3, self.n_lanes):
            return
        # The median covers IN-SERVICE lanes only: stale EWMAs of lanes
        # already failed/quarantined would otherwise anchor it low and let
        # the 2.5x threshold walk onto every healthy survivor in turn.
        vals = sorted(ew for idx, ew in self.lane_t_ewma.items()
                      if not self.sms[idx].failed)
        if not vals:
            return
        med = vals[len(vals) // 2]
        if med <= 0:
            return
        # Backstop: quarantining the last in-service lane would strand
        # pending jobs with a drained event queue (the service then awaits
        # forever), so keep at least one healthy lane no matter how the
        # EWMAs diverge; candidates go slowest-first.
        healthy = sum(1 for ln in self.sms if not ln.failed)
        # Nor the lane a sampling policy samples on (SRTF's sample_sm):
        # quarantined, it could never issue a sample, and the jobs
        # waiting for their predictions would strand the same way.  Its
        # first blocks (a serve job's prefill) run long by design.
        sample_lane = getattr(self.core.policy, "sample_sm", None)
        candidates = sorted(
            ((ew, idx) for idx, ew in self.lane_t_ewma.items()
             if not self.sms[idx].failed and idx != sample_lane
             and ew > self.straggler_quarantine * med),
            reverse=True)
        for _, idx in candidates:
            if healthy <= 1:
                break
            self.sms[idx].failed = True   # quarantined == out of service
            healthy -= 1


def solo_runtime_executor(job: ExecutorJob, policy_factory,
                          n_lanes: int = 4) -> float:
    ex = LaneExecutor([job], policy_factory(), n_lanes=n_lanes)
    res = ex.run()
    return next(iter(res.values())).turnaround
