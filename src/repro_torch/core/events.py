"""Typed machine events and scheduling decisions (DESIGN.md Section 3).

These small frozen dataclasses are the vocabulary of the ``SchedulerCore``
/ ``Machine`` contract:

* **Events** (machine → core) are the paper's Algorithm-1 surface plus the
  TPU-adaptation fault path: :class:`KernelArrived`, :class:`BlockStarted`,
  :class:`BlockEnded` (with ``lost=True`` when a failed lane discards a
  block's work) and :class:`KernelEnded`.  A machine posts them through
  :meth:`repro.core.machine.SchedulerCore.post`, which fans them out to the
  predictor (Algorithm 1 handlers) and the policy (hooks).

* **Decisions** (core → machine) replace the old ``pick() -> key|None``
  duck-type with explicit intent.  A machine asks ``core.decide(sm)``
  whenever execution unit ``sm`` could issue and acts on the answer:

  - :class:`IssueGrant`       — dispatch the next block of ``key`` now.
  - :class:`SampleOnSM`       — dispatch a block of ``key`` for SRTF's
    online sampling phase (Section 5.1.1); an issue, but distinguishable
    so machines/telemetry can attribute sampling cost.
  - :class:`Hold`             — nothing may issue; wait for the next event.
  - :class:`PreemptAtBoundary` — ``key`` should take the unit exclusively,
    but blocks already running must drain first: do not backfill, re-ask at
    the next block boundary.  This is the paper's preemption-at-block-
    boundary made explicit (Section 5.1.1).

Machines only need :func:`grants_issue` to act; the richer types exist for
telemetry, testing and future machines (e.g. real pod lanes) that want to
treat sampling or draining specially.

* **Feedback** (machine → workload): :class:`ArrivalSource` is the
  completion→arrival feedback edge that makes closed-loop workloads
  possible.  A machine with an attached source (see
  :meth:`repro.core.machine.MachineBase.attach_arrival_source`) feeds it
  every natural kernel completion *after* posting the corresponding
  :class:`KernelEnded` event, and schedules whatever
  :class:`~repro.core.workload.Arrival`\\ s the source emits in response —
  the next kernels of an M/G/k offered-load stream, a tenant's think-time
  resubmission, and so on (:mod:`repro.core.scenarios` closed-loop tier).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Protocol, Union, runtime_checkable

from .workload import Arrival

# --------------------------------------------------------------------- events


@dataclass(frozen=True)
class KernelArrived:
    """A kernel/job became visible to the scheduler (Algorithm 1 ONLAUNCH)."""

    key: str
    time: float


@dataclass(frozen=True)
class BlockStarted:
    """One block began executing on unit ``sm`` (Algorithm 1 ONBLOCKSTART)."""

    key: str
    sm: int
    slot: int
    time: float


@dataclass(frozen=True)
class BlockEnded:
    """One block finished on unit ``sm`` (Algorithm 1 ONBLOCKEND).

    ``lost=True`` marks the executor's fault path: the unit failed mid-block,
    the work is discarded and the block will be re-issued; the predictor
    starts a new slice instead of ingesting the bogus duration.
    """

    key: str
    sm: int
    slot: int
    time: float
    lost: bool = False


@dataclass(frozen=True)
class KernelEnded:
    """Every block of the kernel completed (Algorithm 1 ONKERNELEND).

    This event is also the trigger of the completion→arrival feedback
    edge: machines with an attached :class:`ArrivalSource` feed it the
    completed key right after posting this event, so closed-loop arrival
    processes observe completions in machine-event order.
    """

    key: str
    time: float


MachineEvent = Union[KernelArrived, BlockStarted, BlockEnded, KernelEnded]


# ------------------------------------------------------------------ feedback
@runtime_checkable
class ArrivalSource(Protocol):
    """Completion-driven arrival generator (the closed-loop feedback edge).

    A source is *stateful and single-use*: one machine run consumes one
    source.  The machine calls :meth:`initial` exactly once when the source
    is attached and :meth:`on_completion` once per natural kernel
    completion (cancelled kernels do not count — a cancellation is a
    frontend action, not the machine finishing work).  Returned arrivals
    carry times in **source time units**; machines with a different clock
    (the real-JAX executor counts seconds, scenarios count cycles) convert
    via the ``time_scale`` given at attach time.  Arrival times in the past
    are clipped to "now" by the machine, never reordered into its history.
    """

    def initial(self) -> List[Arrival]:
        """Arrivals to schedule before the machine starts running."""
        ...

    def on_completion(self, key: str, now: float) -> List[Arrival]:
        """Arrivals emitted in response to ``key`` completing at ``now``."""
        ...


# ------------------------------------------------------------------ decisions


@dataclass(frozen=True)
class IssueGrant:
    """Dispatch the next block of ``key`` on the asking unit now."""

    key: str
    reason: str = ""


@dataclass(frozen=True)
class SampleOnSM:
    """Dispatch a block of ``key`` on the asking unit for online sampling."""

    key: str
    reason: str = "srtf-sampling"


@dataclass(frozen=True)
class Hold:
    """Nothing may issue on the asking unit until the next event."""

    reason: str = ""


@dataclass(frozen=True)
class PreemptAtBoundary:
    """``key`` must take the unit exclusively; drain running blocks first.

    The machine must not backfill other kernels behind ``key`` — it re-asks
    at the next block boundary, at which point the freed resources go to
    ``key``.  Hand-off delay (Section 6.2.2) emerges from this decision.
    """

    key: str
    reason: str = "draining for exclusive winner"


Decision = Union[IssueGrant, SampleOnSM, Hold, PreemptAtBoundary]


def grants_issue(decision: Decision) -> Optional[str]:
    """Kernel key the machine may issue right now, or ``None`` to wait."""
    if isinstance(decision, (IssueGrant, SampleOnSM)):
        return decision.key
    return None


__all__ = [
    "ArrivalSource",
    "BlockEnded",
    "BlockStarted",
    "Decision",
    "Hold",
    "IssueGrant",
    "KernelArrived",
    "KernelEnded",
    "MachineEvent",
    "PreemptAtBoundary",
    "SampleOnSM",
    "grants_issue",
]
