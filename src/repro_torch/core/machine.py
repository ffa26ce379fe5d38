"""The ``Machine`` protocol and the ``SchedulerCore`` that drives it.

This module formalizes the contract that used to be an informal duck-type
between the policies and the two machines (DES simulator, real-JAX lane
executor):

* :class:`Machine` — the minimal **read surface** a scheduling policy or
  predictor may touch: active runs, per-unit occupancy/fit/residency
  queries, the machine clock, and oracle runtimes.  Both
  :class:`repro.core.simulator.Simulator` and
  :class:`repro.core.executor.LaneExecutor` implement it (and the
  runtime-checkable protocol lets tests assert so).

* :class:`KernelRun` — dynamic per-kernel state shared by every machine;
  its attribute set is the run-level read surface policies see through
  :meth:`Machine.run_state`.

* :class:`MachineBase` — shared implementation of the protocol so machines
  stop re-implementing ``active_keys`` / ``can_fit`` / residency-cap
  propagation independently.  Concrete machines supply two hooks:
  ``_cap_residency`` (which occupancy count the residency cap constrains)
  and ``_fits_resources`` (whether one more block physically fits).  It
  also owns the closed-loop feedback edge: ``attach_arrival_source`` binds
  an :class:`~repro.core.events.ArrivalSource`, ``_feed_completion``
  reports each natural kernel completion to it, and machines that support
  dynamic arrivals implement ``inject_arrival`` to schedule what the
  source emits (DESIGN.md Section 7).

* :class:`SchedulerCore` — the scheduling brain: one
  :class:`~repro.core.policies.Policy` plus one
  :class:`~repro.core.predictor.Predictor`, bound to a machine.  Machines
  post typed events (:mod:`repro.core.events`) and ask for typed decisions;
  the core fans events out to the predictor's Algorithm-1 handlers and the
  policy's hooks in the paper's order.

Anything block-granular that exposes this surface — a GPGPU-Sim-style DES,
a TPU pod of gang-scheduled lanes, a cluster simulator — can be driven by
the unmodified SRTF + Simple Slicing core, which is the paper's central
engineering claim.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import (
    Callable,
    Dict,
    List,
    Optional,
    Protocol,
    Sequence,
    Union,
    runtime_checkable,
)

from .events import (
    ArrivalSource,
    BlockEnded,
    BlockStarted,
    Decision,
    KernelArrived,
    KernelEnded,
    MachineEvent,
)
from .predictor import Predictor, make_predictor
from .workload import Arrival, KernelSpec


@dataclass(slots=True)
class KernelRun:
    """Dynamic state of one kernel instance on a machine.

    Slotted: machines read these fields in their innermost loops, and the
    attribute set IS the run-level read surface — ad-hoc extra attributes
    would bypass the protocol anyway."""

    key: str
    spec: KernelSpec
    arrival_time: float
    order: int
    issued: int = 0
    done: int = 0
    finish_time: Optional[float] = None
    first_issue_time: Optional[float] = None
    cancelled: bool = False
    #: True once the machine posted this run's KernelArrived event.  Until
    #: then the run is invisible to the scheduler even if its arrival
    #: timestamp has passed (two arrivals can share one instant; the second
    #: must not be dispatched before its own launch is processed).
    launched: bool = False
    #: Per-SM occupancy maps.  Dicts by default (sparse machines); a
    #: machine with dense per-unit state may normalize them to flat
    #: index-addressed lists (the DES does, at RNG init).
    issued_per_sm: Union[Dict[int, int], List[int]] = \
        field(default_factory=dict)
    resident_per_sm: Union[Dict[int, int], List[int]] = \
        field(default_factory=dict)
    issue_gate: Union[Dict[int, float], List[float]] = \
        field(default_factory=dict)
    stagger_sm: Union[Dict[int, bool], List[bool]] = \
        field(default_factory=dict)
    #: Per-block duration noise factors, indexed by global block number
    #: (a plain float list: the DES issue loop reads one entry per block).
    noise: Optional[Sequence[float]] = None

    @property
    def finished(self) -> bool:
        return self.finish_time is not None

    @property
    def unissued(self) -> int:
        return self.spec.num_blocks - self.issued

    def resident(self, sm: int) -> int:
        per = self.resident_per_sm
        if isinstance(per, dict):
            return per.get(sm, 0)
        return per[sm]     # machines may normalize the map to a flat list


@runtime_checkable
class Machine(Protocol):
    """Minimal machine read surface for policies and predictors.

    Everything a scheduling policy may legally touch goes through these
    members; machine internals (event queues, SM resource pools, lane
    states) are off-limits.
    """

    n_sm: int
    now: float
    predictor: Predictor

    def active_keys(self) -> List[str]:
        """Arrived, unfinished kernels in arrival order."""
        ...

    def run_state(self, key: str) -> KernelRun:
        """Dynamic state of one kernel (read-only by convention)."""
        ...

    def residency(self, key: str, sm: int) -> int:
        """Blocks of ``key`` currently resident on unit ``sm``."""
        ...

    def can_fit(self, key: str, sm: int) -> bool:
        """Whether one more block of ``key`` may issue on unit ``sm``."""
        ...

    def elapsed(self, key: str) -> float:
        """Machine time since ``key`` arrived."""
        ...

    def oracle_runtime(self, key: str) -> Optional[float]:
        """True solo runtime, if an oracle provided one (SJF/LJF/zero)."""
        ...

    def arrivals_pending(self) -> bool:
        """Whether any not-yet-launched kernel may still arrive (queued
        arrivals, closed-loop sources, external job intake).  Policies may
        use this to elide bookkeeping that only matters under future
        multiprogramming; machines that cannot know must answer True."""
        ...

    def sync_residency_caps(self) -> None:
        """Re-propagate policy residency caps into the predictor
        (Section 3.4.3: residency changes start a new slice)."""
        ...


class SchedulerCore:
    """One policy + one predictor, bound to one machine.

    The single entry point machines use:

    * :meth:`post` — feed a typed event; the core updates the predictor
      (Algorithm 1) and the policy hooks in the paper's order and returns
      the predictor's fresh Eq. 2 estimate for ``BlockEnded`` events.
    * :meth:`post_block_start` / :meth:`post_block_end` — **fused fast
      paths** for the two block-granular events, which dominate every run
      (two per executed block).  They perform the exact dispatch the typed
      branches of :meth:`post` perform, minus the per-block event-object
      allocation and the ``isinstance`` chain; the typed surface stays as
      the protocol seam for custom machines and for the rarer lifecycle
      events (and the fault path, which needs ``lost=True``).  A
      conformance test pins both paths to identical predictor/policy state.
    * :meth:`decide` — ask for a typed :class:`~repro.core.events.Decision`
      for one execution unit.
    * :meth:`residency_cap` — the policy's current per-(kernel, unit) cap.
    """

    def __init__(self, policy, predictor: Union[str, Predictor, None],
                 n_sm: int):
        self.policy = policy
        self.predictor = make_predictor(predictor, n_sm)
        self.machine: Optional[Machine] = None
        self._invalidate_active: Optional[Callable[..., None]] = None

    def bind(self, machine: Machine) -> "SchedulerCore":
        self.machine = machine
        self.policy.bind(machine)
        # Bound-method bindings for the per-block fast paths (skip the
        # attribute walks in the hot loop), plus the machine's active-set
        # invalidation hook, if it has one (MachineBase does; a custom
        # protocol-only machine may not cache and needs no notification).
        self._predictor_on_block_start = self.predictor.on_block_start
        self._predictor_on_block_end = self.predictor.on_block_end
        self._policy_on_block_end = self.policy.on_block_end
        self._invalidate_active = getattr(machine, "_invalidate_active", None)
        return self

    # -- fused per-block fast paths -----------------------------------------
    def post_block_start(self, key: str, sm: int, slot: int,
                         time: float) -> None:
        """Fused ``BlockStarted`` dispatch (no event object, no isinstance)."""
        self._predictor_on_block_start(key, sm, slot, time)

    def post_block_end(self, key: str, sm: int, slot: int,
                       time: float) -> Optional[float]:
        """Fused ``BlockEnded`` dispatch; returns the fresh Eq. 2 estimate.

        Lost blocks (the executor's fault path) must go through the typed
        :meth:`post` with ``lost=True`` — this path is the common case only.
        """
        pred = self._predictor_on_block_end(key, sm, slot, time)
        self._policy_on_block_end(key, sm)
        return pred

    def post(self, event: MachineEvent) -> Optional[float]:
        # Dispatch order: block events first — they dominate (two per
        # executed block vs. two per kernel lifetime).
        if isinstance(event, BlockStarted):
            self.predictor.on_block_start(
                event.key, event.sm, event.slot, event.time)
        elif isinstance(event, BlockEnded):
            if event.lost:
                # Fault path: the block's work is discarded; its duration
                # must not contaminate the estimate — start a new slice.
                self.predictor.reslice_all(event.key)
                return None
            pred = self.predictor.on_block_end(
                event.key, event.sm, event.slot, event.time)
            self.policy.on_block_end(event.key, event.sm)
            return pred
        elif isinstance(event, KernelArrived):
            run = self.machine.run_state(event.key)
            run.launched = True
            if self._invalidate_active is not None:
                self._invalidate_active()
            self.predictor.on_launch(
                event.key, run.spec.num_blocks, run.spec.max_residency)
            self.policy.on_arrival(event.key)
            self.machine.sync_residency_caps()
        elif isinstance(event, KernelEnded):
            if self._invalidate_active is not None:
                self._invalidate_active(ended=event.key)
            self.predictor.on_kernel_end(event.key)
            self.policy.on_kernel_end(event.key)
            self.machine.sync_residency_caps()
        else:  # pragma: no cover - exhaustive over MachineEvent
            raise TypeError(f"unknown machine event {event!r}")
        return None

    def decide(self, sm: int) -> Decision:
        return self.policy.decide(sm)

    def residency_cap(self, key: str, sm: int) -> int:
        return self.policy.residency_cap(key, sm)


class MachineBase:
    """Shared :class:`Machine` implementation for concrete machines.

    Subclasses own their event loop and resource model and provide:

    * ``_cap_residency(key, sm)`` — the occupancy count the policy's
      residency cap constrains (per-SM resident blocks on the GPU,
      machine-wide lane count on the pod),
    * ``_fits_resources(key, sm)`` — whether one more block of ``key``
      physically fits on unit ``sm`` right now.
    """

    def __init__(self, n_sm: int, policy,
                 predictor: Union[str, Predictor, None] = None,
                 oracle_runtimes: Optional[Dict[str, float]] = None):
        self.n_sm = n_sm
        self.now = 0.0
        self.runs: Dict[str, KernelRun] = {}
        self.oracle_runtimes: Dict[str, float] = dict(oracle_runtimes or {})
        self.core = SchedulerCore(policy, predictor, n_sm)
        #: Fast-path master switch (DESIGN.md Section 8).  Every fast path
        #: is bit-identical to the reference path by construction; the
        #: switch exists so the equivalence matrix suite can force the
        #: reference behavior and diff the two end to end.
        self.fast_path = True
        self._key_order: Optional[List[str]] = None  # active_keys() cache
        #: Event-driven active_keys() cache: the filtered list is reused
        #: until an arrival/kernel-end/injection dirties it (see
        #: :meth:`_invalidate_active`).
        self._active_cache: Optional[List[str]] = None
        #: Parallel cache of the KernelRun objects behind active_keys()
        #: (machine-internal: saves the per-key dict hop in hot loops).
        self._active_runs_cache: Optional[List[KernelRun]] = None
        #: Last residency cap pushed into the predictor per kernel
        #: (uniform-cap policies only): lets :meth:`sync_residency_caps`
        #: skip the per-SM fan-out when nothing changed.
        self._synced_caps: Dict[str, int] = {}
        #: Closed-loop feedback edge (None = open loop, the default).
        self._arrival_source: Optional[ArrivalSource] = None
        #: Machine seconds per source time unit (1.0 on the cycle-clocked
        #: DES; the executor attaches with its scenario time_scale).
        self._source_time_scale = 1.0
        # Plain attributes, not properties: policies and predictors read
        # machine.predictor in their innermost loops, and the core never
        # swaps its policy/predictor after construction.
        self.policy = self.core.policy
        self.predictor: Predictor = self.core.predictor

    # -- Machine protocol ---------------------------------------------------
    def active_keys(self) -> List[str]:
        """Arrived (launch event processed), unfinished kernels in arrival
        order.

        Hot path (policies call this on every decision): with
        :attr:`fast_path` on, the *filtered* list is cached under an
        event-driven dirty bit — rebuilt only after an arrival, a kernel
        end, or an injected run (:meth:`_invalidate_active`), since those
        are the only transitions of the launched/finished predicates.  The
        returned list is shared; callers must treat it as read-only (the
        protocol's convention for everything this surface exposes).  With
        :attr:`fast_path` off the launched/finished filter runs per call
        (the reference behavior).
        """
        if self.fast_path:
            cache = self._active_cache
            if cache is not None:
                return cache
        order = self._key_order
        if order is None or len(order) != len(self.runs):
            runs = self.runs
            order = sorted(runs, key=lambda k: runs[k].order)
            self._key_order = order
        runs = self.runs
        out = []
        for k in order:
            r = runs[k]
            if r.launched and r.finish_time is None:
                out.append(k)
        if self.fast_path:
            self._active_cache = out
        return out

    def _invalidate_active(self, ended: Optional[str] = None) -> None:
        """Dirty the :meth:`active_keys` cache (and drop the ended
        kernel's synced-cap memo).  Called by :class:`SchedulerCore` on
        arrival/kernel-end dispatch and by machines when they add runs."""
        self._active_cache = None
        self._active_runs_cache = None
        if ended is not None:
            self._synced_caps.pop(ended, None)

    def _active_runs(self) -> List[KernelRun]:
        """Machine-internal: the runs behind :meth:`active_keys`, cached
        under the same dirty bit (not part of the policy read surface)."""
        cache = self._active_runs_cache
        if cache is None:
            runs = self.runs
            cache = [runs[k] for k in self.active_keys()]
            self._active_runs_cache = cache
        return cache

    def run_state(self, key: str) -> KernelRun:
        return self.runs[key]

    def residency(self, key: str, sm: int) -> int:
        return self.runs[key].resident(sm)

    def can_fit(self, key: str, sm: int) -> bool:
        run = self.runs[key]
        spec = run.spec
        if spec.num_blocks - run.issued <= 0:
            return False
        cap = spec.max_residency
        policy = self.core.policy
        if not policy.unlimited_caps:
            pcap = policy.residency_cap(key, sm)
            if pcap < cap:
                cap = pcap
        if self._cap_residency(key, sm) >= cap:
            return False
        return self._fits_resources(key, sm)

    def elapsed(self, key: str) -> float:
        return self.now - self.runs[key].arrival_time

    def oracle_runtime(self, key: str) -> Optional[float]:
        return self.oracle_runtimes.get(self.runs[key].spec.name)

    def arrivals_pending(self) -> bool:
        # Conservative default: machines with external intake (the
        # executor's add_job, the async service) can gain kernels at any
        # time, so "more arrivals possible" is the safe answer.
        return True

    def sync_residency_caps(self) -> None:
        policy = self.core.policy
        predictor = self.predictor
        if self.fast_path and policy.uniform_caps:
            # Delta sync: built-in policies cap per kernel, not per unit
            # (``Policy.uniform_caps``), so one cap query covers all SMs
            # and the per-(key, sm) predictor fan-out only runs for keys
            # whose cap actually changed since the last sync.  The memo
            # mirrors predictor state exactly — every cap the predictor
            # holds was pushed through this method — so a memo hit is a
            # provable no-op fan-out.
            synced = self._synced_caps
            for key in self.active_keys():
                if not predictor.has_kernel(key):
                    continue
                run = self.runs[key]
                cap = run.spec.max_residency
                if not policy.unlimited_caps:
                    pcap = policy.residency_cap(key, 0)
                    if pcap < cap:
                        cap = pcap
                if synced.get(key) == cap:
                    continue
                for sm in range(self.n_sm):
                    predictor.on_residency_change(key, sm, cap)
                synced[key] = cap
            return
        for key in self.active_keys():
            if not predictor.has_kernel(key):
                # Defensive invariant: active_keys() only returns launched
                # runs, and SchedulerCore.post registers a run with the
                # predictor in the same KernelArrived dispatch that marks
                # it launched, so every key here should be known.  Skip
                # rather than crash if a custom machine drives events in a
                # different order.
                continue
            run = self.runs[key]
            for sm in range(self.n_sm):
                cap = min(run.spec.max_residency,
                          self.core.residency_cap(key, sm))
                predictor.on_residency_change(key, sm, cap)

    # -- closed-loop feedback edge ------------------------------------------
    def attach_arrival_source(self, source: ArrivalSource,
                              time_scale: float = 1.0) -> None:
        """Close the loop: feed ``source`` every natural kernel completion
        and schedule the arrivals it emits (DESIGN.md Section 7).

        ``time_scale`` is machine seconds per source time unit: completion
        times are reported to the source as ``now / time_scale`` and the
        machine's :meth:`inject_arrival` is responsible for scaling emitted
        arrival times back.  The source's :meth:`~repro.core.events
        .ArrivalSource.initial` arrivals are injected immediately; a source
        is single-use, so attaching twice is an error.
        """
        if self._arrival_source is not None:
            raise ValueError("an arrival source is already attached")
        if time_scale <= 0.0:
            raise ValueError("time_scale must be positive")
        self._arrival_source = source
        self._source_time_scale = time_scale
        for arrival in source.initial():
            self.inject_arrival(arrival)

    def _feed_completion(self, key: str) -> None:
        """Report one natural completion to the attached source (if any)
        and inject whatever arrivals it emits.  Machines call this right
        after posting :class:`~repro.core.events.KernelEnded`."""
        source = self._arrival_source
        if source is None:
            return
        now = self.now / self._source_time_scale
        for arrival in source.on_completion(key, now):
            self.inject_arrival(arrival)

    # -- machine-specific hooks ---------------------------------------------
    def inject_arrival(self, arrival: Arrival) -> str:
        """Schedule one dynamic arrival (closed-loop feedback); returns the
        kernel key.  Arrival times are in source units (machine-specific
        scaling applies) and are clipped to "now" — a feedback arrival can
        never land in the machine's past."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support dynamic arrivals")

    def _cap_residency(self, key: str, sm: int) -> int:
        """Occupancy count the residency cap constrains on ``sm``."""
        raise NotImplementedError

    def _fits_resources(self, key: str, sm: int) -> bool:
        """Whether one more block of ``key`` physically fits on ``sm``."""
        raise NotImplementedError


__all__ = [
    "KernelRun",
    "Machine",
    "MachineBase",
    "SchedulerCore",
]
