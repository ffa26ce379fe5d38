"""Event-driven simulator of a multi-SM GPU executing concurrent grids.

This is the GPGPU-Sim analogue used for the paper's evaluation (Section 6):
15 SMs (Table 4), block-granular resource allocation, a pluggable thread
block scheduler (:mod:`repro.core.policies`), and a pluggable structural
runtime predictor (:mod:`repro.core.predictor`) wired to the four
Algorithm-1 events.

The simulator is one concrete :class:`repro.core.machine.Machine`: the
scheduling brain lives in a :class:`repro.core.machine.SchedulerCore`
(policy + predictor) that the simulator drives with typed events and asks
for typed decisions (:mod:`repro.core.events`); the real-JAX lane executor
(:mod:`repro.core.executor`) implements the same protocol, so the identical
core schedules both.

Design notes
------------
* Resources: each SM has 8 block slots, 1536 threads, and one normalised
  "fraction" pool (1 block of kernel k consumes ``1/R_k`` of an SM — see
  ``KernelSpec.resource_fraction``).  A block is issued only if all three fit
  and the policy's residency cap for that kernel allows it.
* Block durations are sampled at issue time from the kernel's duration model
  under the *current* SM conditions (residency, co-resident warps), times a
  per-block noise factor that is indexed by global block number so that solo
  and multiprogrammed runs of the same kernel share an identical noise
  stream (slowdowns then measure scheduling, not sampling luck).
* Staggered starts (Section 3.3): on stagger-affected SMs, first-wave issues
  are serialised by an issue *gate*; the scheduler re-tries when the gate
  opens.
"""

from __future__ import annotations

import heapq
import itertools
import math
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .events import (
    BlockEnded,
    BlockStarted,
    Decision,
    IssueGrant,
    KernelArrived,
    KernelEnded,
    SampleOnSM,
)
from .machine import KernelRun, MachineBase
from .predictor import Predictor
from .workload import (
    Arrival,
    KernelSpec,
    MAX_BLOCK_SLOTS,
    MAX_THREADS_PER_SM,
    MAX_WARPS_PER_SM,
    N_SM,
)

_EPS = 1e-9

#: Memoized per-kernel (noise, stagger) draws keyed by every input of the
#: draws — see Simulator._init_kernel_rng.  Entries never change once
#: stored (the draws are a pure function of the key), so a hit cannot
#: depend on history.
_NOISE_MEMO: Dict[tuple, Tuple[List[float], List[bool]]] = {}


@dataclass
class BlockRecord:
    """One executed thread block (for traces / figure benchmarks)."""

    kernel: str
    sm: int
    slot: int
    start: float
    end: float


@dataclass
class PredictionRecord:
    """One Eq. 2 prediction event (for predictor-accuracy benchmarks)."""

    kernel: str
    sm: int
    time: float            # when the prediction was made
    done_blocks: int       # blocks done on this SM at prediction time
    predicted_total: float # Pred_Cycles (total runtime from kernel start)


class SMState:
    """Resource pools of one streaming multiprocessor (Table 4)."""

    __slots__ = ("index", "used_threads", "used_fraction", "free_slots", "resident")

    def __init__(self, index: int):
        self.index = index
        self.used_threads = 0
        self.used_fraction = 0.0
        self.free_slots = list(range(MAX_BLOCK_SLOTS - 1, -1, -1))
        self.resident: Dict[int, str] = {}  # slot -> kernel key

    def fits(self, spec: KernelSpec) -> bool:
        return (
            bool(self.free_slots)
            and self.used_threads + spec.threads_per_block <= MAX_THREADS_PER_SM
            and self.used_fraction + spec.resource_fraction <= 1.0 + _EPS
        )

    def alloc(self, key: str, spec: KernelSpec) -> int:
        slot = self.free_slots.pop()
        self.resident[slot] = key
        self.used_threads += spec.threads_per_block
        self.used_fraction += spec.resource_fraction
        return slot

    def free(self, slot: int, spec: KernelSpec) -> None:
        del self.resident[slot]
        self.free_slots.append(slot)
        # Both pools clamp at zero: the fraction pool accumulates float
        # rounding, and a mis-specced spec must not drive either negative
        # (a negative pool would over-admit forever after).
        ut = self.used_threads - spec.threads_per_block
        self.used_threads = ut if ut > 0 else 0
        uf = self.used_fraction - spec.resource_fraction
        self.used_fraction = uf if uf > 0.0 else 0.0


# Event kinds, in tie-break priority order (lower sorts first at equal time).
# Heap items are flat tuples — (time, kind, seq, payload...) — where seq is
# unique, so comparison never reaches the payload: arrivals and issue
# retries carry one scalar (key / sm index), block ends carry
# (key, sm, slot, start).
_ARRIVAL, _BLOCK_END, _TRY_ISSUE = 0, 1, 2


class Simulator(MachineBase):
    """Discrete-event GPU simulator — a :class:`Machine` with a pluggable
    scheduling core (policy + predictor)."""

    def __init__(
        self,
        arrivals: Sequence[Arrival],
        policy,
        n_sm: int = N_SM,
        seed: int = 0,
        record_trace: bool = False,
        record_predictions: bool = False,
        record_decisions: bool = False,
        oracle_runtimes: Optional[Dict[str, float]] = None,
        predictor: Union[str, Predictor, None] = None,
        fast_path: bool = True,
    ):
        super().__init__(n_sm, policy, predictor=predictor,
                         oracle_runtimes=oracle_runtimes)
        #: Bit-identical fast paths (DESIGN.md Section 8): fused event
        #: dispatch, the incremental corunner aggregate, decision
        #: memoization and the targeted issue fan-out.  ``fast_path=False``
        #: forces the reference implementations; the equivalence matrix
        #: suite diffs the two end to end.  ``record_decisions=True``
        #: keeps the complete ask pattern (no targeted skips, memoization
        #: still active), so a recorded fast-path log is *identical* to
        #: the reference log — the memoization cross-check contract.
        self.fast_path = fast_path
        self.seed = seed
        self.sms = [SMState(i) for i in range(n_sm)]
        #: Resource-weighted busy time: each executing block contributes
        #: duration * spec.resource_fraction (one block = 1/R of an SM), so
        #: utilization = busy_time / (n_sm * window) lands in [0, 1].
        self.busy_time = 0.0
        self._events: List[tuple] = []   # flat (time, kind, seq, payload...)
        self._seq = itertools.count()
        #: Scheduler-state era: bumped once per processed event and per
        #: block allocation — every mutation a Decision may depend on is
        #: bracketed by a bump, so a memoized per-SM decision is valid
        #: exactly while the era stands still.
        self._era = 0
        self._decision_memo: List[Optional[Tuple[int, Decision]]] = \
            [None] * n_sm
        #: (min threads, min fraction) over active kernels with
        #: undispatched blocks; min threads is -1 when none exist.  The
        #: cheapest possible "could anything issue here?" test.  Dirtied
        #: only by the transitions that can change it: arrivals/kernel
        #: ends (via ``_invalidate_active``) and a kernel's last block
        #: issuing (in ``_allocate_block``).
        self._minfoot: Tuple[int, float] = (-1, 0.0)
        self._minfoot_dirty = True
        self.trace: List[BlockRecord] = [] if record_trace else None
        self.predictions: List[PredictionRecord] = [] if record_predictions else None
        self.decisions: List[Tuple[float, int, Decision]] = \
            [] if record_decisions else None

        #: Queued-but-unprocessed arrival events (for arrivals_pending()).
        self._pending_arrivals = 0
        for order, arr in enumerate(sorted(arrivals, key=lambda a: a.time)):
            run = KernelRun(arr.key, arr.spec, arr.time, order)
            self._init_kernel_rng(run)
            self.runs[arr.key] = run
            self._pending_arrivals += 1
            self._push(arr.time, _ARRIVAL, arr.key)
        # Dynamic (closed-loop) arrivals continue the same order sequence,
        # so injected kernels draw fresh per-order noise streams.
        self._arrival_order = itertools.count(len(self.runs))

        self.core.bind(self)
        # Bound once: the core never swaps its policy/predictor after
        # construction (machine.py documents the same invariant for
        # .policy/.predictor), so the per-block entry points skip the
        # attribute walks.
        self._policy_decide = self.core.policy.decide
        self._policy_on_block_end = self.core.policy.on_block_end
        self._policy_unlimited = self.core.policy.unlimited_caps
        #: Direct binding of the predictor's ONBLOCKEND handler: the fast
        #: block-end path performs SchedulerCore.post_block_end's exact
        #: dispatch (predictor first, then the policy hook) without the
        #: wrapper frame; the conformance suite pins the equivalence.
        self._predictor_on_block_end = self.core.predictor.on_block_end
        self._post_block_start = self.core.post_block_start
        #: Whether the per-block Algorithm-1 predictor bookkeeping runs.
        #: Prediction-free policies (``Policy.uses_predictor`` False) never
        #: read it, so the fast path elides it entirely — unless
        #: predictions are being recorded, or the reference path is forced
        #: (which always drives the full event surface).
        self._drive_predictor = (
            not fast_path
            or record_predictions
            or getattr(self.core.policy, "uses_predictor", True))

    # ------------------------------------------------------------ rng setup
    def _init_kernel_rng(self, run: KernelRun) -> None:
        # Stable per-kernel streams: identical noise per block index across
        # solo and multiprogrammed runs with the same seed, and across
        # processes (zlib.crc32 is stable; Python's hash() is salted).
        name_hash = zlib.crc32(run.spec.name.encode()) % (2 ** 31)
        spec = run.spec
        # SeedSequence expansion + generator construction is ~40us per
        # kernel per cell — dominant in tiny-cell sweeps.  Every draw below
        # (lognormal noise, then the stagger booleans off the SAME stream)
        # is a pure function of this key, so the drawn outputs themselves
        # are memoized; a hit hands back copies of exactly what a fresh
        # generator would produce, draw-for-draw, including the stream
        # position the stagger draw starts from.
        memo_key = (self.seed, name_hash, run.order, spec.rsd,
                    spec.num_blocks, self.n_sm, spec.stagger_frac,
                    spec.stagger_sm_prob)
        drawn = _NOISE_MEMO.get(memo_key)
        if drawn is None:
            rng = np.random.default_rng(np.random.SeedSequence(
                entropy=(self.seed, name_hash, run.order)))
            if spec.rsd > 0.0:
                sigma = math.sqrt(math.log(1.0 + spec.rsd * spec.rsd))
                # Stored as a plain list: the issue loop indexes one factor
                # per block, and float64 -> float via tolist() is exact.
                noise = rng.lognormal(
                    mean=-0.5 * sigma * sigma, sigma=sigma,
                    size=spec.num_blocks).tolist()
            else:
                noise = [1.0] * spec.num_blocks
            stagger = [
                spec.stagger_frac > 0.0 and rng.random() < spec.stagger_sm_prob
                for _ in range(self.n_sm)]
            drawn = (noise, stagger)
            if len(_NOISE_MEMO) >= 4096:
                _NOISE_MEMO.clear()
            _NOISE_MEMO[memo_key] = drawn
        run.noise = list(drawn[0])
        # The per-SM maps are dense on the DES (every SM is a candidate), so
        # they are normalized to flat index-addressed lists here; the
        # KernelRun fields default to dicts for machines with sparse
        # occupancy (the lane executor tracks residency its own way).
        run.resident_per_sm = [0] * self.n_sm
        run.issued_per_sm = [0] * self.n_sm
        run.issue_gate = [0.0] * self.n_sm
        run.stagger_sm = list(drawn[1])

    # --------------------------------------------------------------- events
    def _push(self, time: float, kind: int, payload) -> None:
        heapq.heappush(self._events, (time, kind, next(self._seq), payload))

    def inject_arrival(self, arrival: Arrival) -> str:
        """Schedule one dynamic arrival (the closed-loop feedback edge).

        The kernel arrives at ``max(now, arrival.time)`` — feedback can
        never rewrite the machine's past — and gets the next global arrival
        order, so its noise stream is as process-stable as the up-front
        ones (seed + crc32(name) + order).
        """
        key = arrival.key
        if key in self.runs:
            raise ValueError(f"duplicate kernel key {key!r}")
        time = max(self.now, arrival.time)
        run = KernelRun(key, arrival.spec, time, next(self._arrival_order))
        self._init_kernel_rng(run)
        self.runs[key] = run
        self._invalidate_active()
        self._pending_arrivals += 1
        self._push(time, _ARRIVAL, key)
        return key

    def run(self, until: Optional[float] = None) -> "SimResult":
        events = self._events
        sms = self.sms
        horizon = math.inf if until is None else until
        pop = heapq.heappop
        handle_block_end = self._handle_block_end
        handle_arrival = self._handle_arrival
        try_issue = self._try_issue
        while events:
            item = pop(events)
            time = item[0]
            if time > horizon:
                # Truncated: blocks still in flight have run from their
                # start to the window edge — credit that busy time so
                # utilization stays meaningful for open-loop runs.  The
                # remaining heap is scanned in place (no copy), with the
                # just-popped event credited last, exactly as the old
                # copy-and-append scan ordered it.
                runs = self.runs
                now = self.now
                for it in events:
                    if it[1] == _BLOCK_END:
                        frac = runs[it[3]].spec.resource_fraction
                        self.busy_time += max(0.0, now - it[6]) * frac
                if item[1] == _BLOCK_END:
                    frac = runs[item[3]].spec.resource_fraction
                    self.busy_time += max(0.0, now - item[6]) * frac
                break
            self.now = time
            kind = item[1]
            if kind == _BLOCK_END:
                self._era += 1
                handle_block_end(item[3], item[4], item[5], item[6])
            elif kind == _ARRIVAL:
                self._era += 1
                handle_arrival(item[3])
            else:
                # Gate retries mutate nothing themselves (allocations bump
                # the era): a retry with no intervening event is the one
                # place a memoized decision legitimately hits.
                try_issue(sms[item[3]])
        return SimResult(self)

    def arrivals_pending(self) -> bool:
        """Queued arrival events remain, or a closed-loop source may emit
        more — the DES knows its whole future arrival surface exactly."""
        return self._pending_arrivals > 0 or self._arrival_source is not None

    # ------------------------------------------------------------- handlers
    def _handle_arrival(self, key: str) -> None:
        self._pending_arrivals -= 1
        self.core.post(KernelArrived(key, self.now))
        self._fan_out()

    def _fan_out(self) -> None:
        """Offer an issue opportunity machine-wide (arrival / kernel end).

        The fast-path footprint precheck inside :meth:`_try_issue` makes
        each per-SM offer O(1) for SMs that could not physically accept a
        block of any active kernel (the targeted re-issue of DESIGN.md
        Section 8)."""
        for sm in self.sms:
            self._try_issue(sm)

    def _min_footprint(self) -> Tuple[int, float]:
        """(min threads/block, min resource fraction) over active kernels
        with undispatched blocks (-1 threads when none exist).

        An SM without headroom for even this footprint provably cannot
        receive an issue grant — every grant requires :meth:`can_fit`,
        which requires the resource fit — and decisions are
        side-effect-free, so not *asking* such an SM is schedule-identical
        (the skipped Hold merely goes unrecorded)."""
        min_tpb = -1
        min_frac = 0.0
        for run in self._active_runs():
            spec = run.spec
            if spec.num_blocks > run.issued:
                tpb = spec.threads_per_block
                frac = spec.resource_fraction
                if min_tpb < 0:
                    min_tpb = tpb
                    min_frac = frac
                else:
                    if tpb < min_tpb:
                        min_tpb = tpb
                    if frac < min_frac:
                        min_frac = frac
        mf = (min_tpb, min_frac)
        self._minfoot = mf
        self._minfoot_dirty = False
        return mf

    def _handle_block_end(self, key: str, sm_index: int, slot: int,
                          start: float) -> None:
        run = self.runs[key]
        sm = self.sms[sm_index]
        spec = run.spec
        now = self.now
        self.busy_time += (now - start) * spec.resource_fraction
        if self.fast_path:
            # Inlined SMState.free (same clamps), fused event dispatch.
            del sm.resident[slot]
            sm.free_slots.append(slot)
            ut = sm.used_threads - spec.threads_per_block
            sm.used_threads = ut if ut > 0 else 0
            uf = sm.used_fraction - spec.resource_fraction
            sm.used_fraction = uf if uf > 0.0 else 0.0
            run.resident_per_sm[sm_index] -= 1
            run.done += 1
            if self._drive_predictor:
                # SchedulerCore.post_block_end's exact dispatch, fused.
                pred = self._predictor_on_block_end(key, sm_index, slot,
                                                    now)
                self._policy_on_block_end(key, sm_index)
            else:
                # Prediction-free policy: Algorithm 1 is dead bookkeeping;
                # the policy hook still fires in the core's order.
                pred = None
                self._policy_on_block_end(key, sm_index)
        else:
            sm.free(slot, spec)
            run.resident_per_sm[sm_index] -= 1
            run.done += 1
            pred = self.core.post(BlockEnded(key, sm_index, slot, now))
        if self.predictions is not None and pred is not None:
            self.predictions.append(PredictionRecord(
                key, sm_index, now,
                self.predictor.done_blocks(key, sm_index), pred))
        if run.done == spec.num_blocks:
            run.finish_time = now
            self.core.post(KernelEnded(key, now))
            self._feed_completion(key)
            self._fan_out()
        else:
            self._try_issue(sm)

    def _invalidate_active(self, ended: Optional[str] = None) -> None:
        # Arrivals/kernel ends also change the min-footprint set.
        self._minfoot_dirty = True
        super()._invalidate_active(ended)

    # ---------------------------------------------------------------- issue
    def _cap_residency(self, key: str, sm: int) -> int:
        # On the GPU the residency cap constrains per-SM resident blocks.
        return self.runs[key].resident_per_sm[sm]

    def _fits_resources(self, key: str, sm: int) -> bool:
        return self.sms[sm].fits(self.runs[key].spec)

    def can_fit(self, key: str, sm: int) -> bool:
        # Fused override of MachineBase.can_fit — policies call this on
        # every issue opportunity, so the unissued/cap/resource checks are
        # inlined into one frame (identical semantics to the base
        # implementation driving the two hooks above).
        run = self.runs[key]
        spec = run.spec
        if spec.num_blocks - run.issued <= 0:
            return False
        cap = spec.max_residency
        if not self._policy_unlimited:
            pcap = self.core.policy.residency_cap(key, sm)
            if pcap < cap:
                cap = pcap
        if run.resident_per_sm[sm] >= cap:
            return False
        s = self.sms[sm]
        return (bool(s.free_slots)
                and s.used_threads + spec.threads_per_block
                <= MAX_THREADS_PER_SM
                and s.used_fraction + spec.resource_fraction <= 1.0 + _EPS)

    def _try_issue(self, sm: SMState) -> None:
        # Issue as many blocks as the core grants in this batch, then
        # compute durations with the *post-batch* SM conditions: blocks that
        # start at the same instant all execute at the final residency (as on
        # hardware, where a whole wave is dispatched together) rather than at
        # the transient residency seen mid-dispatch.
        smi = sm.index
        fast = self.fast_path
        record = self.decisions
        batch: List[tuple] = []  # (run, slot, noise_idx, first_wave)
        while True:
            if fast:
                if record is None:
                    # Targeted ask: skip the decision entirely when no
                    # active kernel's smallest block could physically land
                    # here (see :meth:`_min_footprint` for why this is
                    # schedule-safe).  With decision recording on, every
                    # SM is asked so the log stays the complete ask
                    # pattern (the memoization cross-check relies on it).
                    if self._minfoot_dirty:
                        mf = self._min_footprint()
                    else:
                        mf = self._minfoot
                    tpb = mf[0]
                    if (tpb < 0
                            or not sm.free_slots
                            or sm.used_threads + tpb > MAX_THREADS_PER_SM
                            or sm.used_fraction + mf[1] > 1.0 + _EPS):
                        break
                memo = self._decision_memo[smi]
                if memo is not None and memo[0] == self._era:
                    decision = memo[1]
                else:
                    decision = self._policy_decide(smi)
            else:
                decision = self.core.decide(smi)
            if record is not None:
                record.append((self.now, smi, decision))
            if isinstance(decision, (IssueGrant, SampleOnSM)):
                key = decision.key
            else:
                # Non-grant decisions are era-stable: memoize so a re-ask
                # with no intervening event (e.g. a gate retry) is free.
                if fast:
                    self._decision_memo[smi] = (self._era, decision)
                break
            run = self.runs[key]
            gate = run.issue_gate[smi]
            if gate > self.now + _EPS:
                self._push(gate, _TRY_ISSUE, smi)
                break
            if not fast and not self.can_fit(key, smi):
                # Defensive re-check on the reference path only: every
                # shipped policy verifies can_fit before granting, so the
                # fast path trusts the grant (conformance-tested).
                break
            # --- allocate (inlined; one call site, runs once per block) --
            spec = run.spec
            self._era += 1   # issue state changed: memoized decisions expire
            slot = sm.free_slots.pop()
            sm.resident[slot] = run.key
            sm.used_threads += spec.threads_per_block
            sm.used_fraction += spec.resource_fraction
            run.resident_per_sm[smi] += 1
            issued_on_sm = run.issued_per_sm[smi]
            run.issued_per_sm[smi] = issued_on_sm + 1
            if run.first_issue_time is None:
                run.first_issue_time = self.now
            first_wave = issued_on_sm < spec.max_residency
            noise_idx = run.issued
            run.issued += 1
            if run.issued == spec.num_blocks:
                self._minfoot_dirty = True   # last block issued
            if first_wave and run.stagger_sm[smi]:
                run.issue_gate[smi] = \
                    self.now + spec.stagger_frac * spec.mean_t
            batch.append((run, slot, noise_idx, first_wave))
        for run, slot, noise_idx, first_wave in batch:
            self._finalize_block(run, sm, slot, noise_idx, first_wave)

    def _finalize_block(self, run: KernelRun, sm: SMState, slot: int,
                        noise_idx: int, first_wave: bool) -> None:
        spec = run.spec
        smi = sm.index
        residency = run.resident_per_sm[smi]
        runs = self.runs
        # Co-runner pressure, summed in arrival order over the kernels with
        # blocks resident on this SM.  The per-(kernel, sm) residency
        # contributions are maintained incrementally on alloc/free
        # (``resident_per_sm``), so no rescan of the slot map is needed;
        # the reference path below recomputes the same sum from the
        # ground-truth slot map (same order, same per-term association, so
        # the two are bit-identical).
        corunner_warps = 0.0
        if self.fast_path:
            for other in self._active_runs():
                if other is run:
                    continue
                cnt = other.resident_per_sm[smi]
                if cnt:
                    corunner_warps += (
                        (other.spec.corunner_pressure * cnt)
                        * other.spec.warps_per_block)
        else:
            # Baselined determinism finding (set-iteration): the sort key
            # runs[k].order is unique per kernel, so the order is total and
            # the set's salted-hash iteration order can never leak through
            # a tie.  Reference path only (fast path sums unordered).
            resident = sorted(set(sm.resident.values()),
                              key=lambda k: runs[k].order)
            for other_key in resident:
                if other_key == run.key:
                    continue
                other = runs[other_key]
                corunner_warps += (
                    other.spec.corunner_pressure
                    * other.resident(smi) * other.spec.warps_per_block)

        if self.fast_path:
            # Inlined KernelSpec.duration (rng=None), reading the memoized
            # base-duration table: identical arithmetic, no call overhead.
            t = spec.base_t_table[
                residency if residency < spec.max_residency
                else spec.max_residency]
            if corunner_warps > 0.0:
                t *= 1.0 + spec.corunner_sens * (
                    corunner_warps / MAX_WARPS_PER_SM)
            if first_wave and spec.startup_factor > 0.0:
                t *= 1.0 + spec.startup_factor
            base = t if t > 1.0 else 1.0    # max(t, 1.0)
            duration = base * run.noise[noise_idx]
            if self._drive_predictor:
                self._post_block_start(run.key, smi, slot, self.now)
        else:
            base = spec.duration(None, residency, corunner_warps, first_wave)
            duration = base * float(run.noise[noise_idx])
            self.core.post(BlockStarted(run.key, smi, slot, self.now))
        heapq.heappush(self._events,
                       (self.now + duration, _BLOCK_END, next(self._seq),
                        run.key, smi, slot, self.now))
        if self.trace is not None:
            self.trace.append(BlockRecord(
                run.key, smi, slot, self.now, self.now + duration))


class SimResult:
    """Outcome of one simulation: per-kernel turnarounds and traces.

    Truncated (``run(until=...)``) and open-loop runs are first-class:
    kernels that did not finish inside the observation window are listed in
    :attr:`unfinished` (instead of silently dropped), :attr:`end_time` is
    the machine clock when the run stopped, and :attr:`makespan` stays
    well-defined (the window end while work is still in flight).
    """

    def __init__(self, sim: Simulator):
        self.sim = sim
        self.turnaround: Dict[str, float] = {}
        self.finish: Dict[str, float] = {}
        self.arrival: Dict[str, float] = {}
        self.name: Dict[str, str] = {}
        #: Keys of arrived-or-pending kernels without a finish time, in
        #: arrival order (cancelled kernels included — see ``cancelled``).
        self.unfinished: List[str] = []
        #: Machine clock when the run stopped (last processed event time).
        self.end_time: float = sim.now
        for key, run in sorted(sim.runs.items(), key=lambda kv: kv[1].order):
            self.name[key] = run.spec.name
            # Arrivals cover every run, finished or not: the queueing
            # metrics integrate number-in-system over the window, which
            # needs the arrival times of kernels still in flight.
            self.arrival[key] = run.arrival_time
            if run.finish_time is None:
                self.unfinished.append(key)
                continue
            self.turnaround[key] = run.finish_time - run.arrival_time
            self.finish[key] = run.finish_time

    @property
    def complete(self) -> bool:
        return not self.unfinished

    @property
    def cancelled(self) -> List[str]:
        return [k for k in self.unfinished if self.sim.runs[k].cancelled]

    @property
    def makespan(self) -> float:
        """Last finish time for complete runs; for truncated runs (work
        still in flight) the end of the observation window."""
        if self.unfinished:
            return self.end_time
        return max(self.finish.values(), default=0.0)

    @property
    def utilization(self) -> float:
        """Fraction of total SM-time spent executing blocks over the
        observation window (in-flight blocks are clipped at the window
        edge for truncated runs)."""
        if self.end_time <= 0.0:
            return 0.0
        return self.sim.busy_time / (self.sim.n_sm * self.end_time)


def simulate(
    arrivals: Sequence[Arrival],
    policy_factory: Callable[[], object],
    n_sm: int = N_SM,
    seed: int = 0,
    record_trace: bool = False,
    record_predictions: bool = False,
    oracle_runtimes: Optional[Dict[str, float]] = None,
    predictor: Union[str, Predictor, None] = None,
    until: Optional[float] = None,
    arrival_source=None,
    engine: Optional[str] = None,
) -> SimResult:
    """Run one simulation.  ``arrival_source`` attaches a closed-loop
    :class:`~repro.core.events.ArrivalSource` (completion-driven arrivals;
    typically with ``arrivals=[]`` so the source supplies the initial
    ones).

    ``engine`` selects the event-loop implementation: ``"python"`` runs
    the reference loop below, ``"compiled"`` the bit-identical flat-array
    engine (:class:`repro.core.fastsim.FastSimulator`; DESIGN.md
    Section 10), and ``None`` — the default — uses the compiled engine
    exactly when a fast backend is available
    (:func:`repro.core.fastsim.default_engine`).  The imports are lazy so
    the reference module never depends on the engine at import time.
    """
    if engine is None:
        from .fastsim import default_engine
        engine = default_engine()
    if engine == "compiled":
        from .fastsim import FastSimulator
        sim_cls = FastSimulator
    elif engine == "python":
        sim_cls = Simulator
    else:
        raise ValueError(
            f"unknown engine {engine!r}; choose from ('python', 'compiled')")
    sim = sim_cls(
        arrivals, policy_factory(), n_sm=n_sm, seed=seed,
        record_trace=record_trace, record_predictions=record_predictions,
        oracle_runtimes=oracle_runtimes, predictor=predictor)
    if arrival_source is not None:
        sim.attach_arrival_source(arrival_source)
    return sim.run(until=until)


def solo_runtime(
    spec: KernelSpec,
    policy_factory: Callable[[], object],
    n_sm: int = N_SM,
    seed: int = 0,
) -> float:
    """Runtime of ``spec`` running alone (same seed => same noise stream)."""
    res = simulate([Arrival(spec, 0.0, uid=f"{spec.name}#0")],
                   policy_factory, n_sm=n_sm, seed=seed)
    return res.turnaround[f"{spec.name}#0"]
