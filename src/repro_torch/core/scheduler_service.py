"""Async multi-tenant scheduling service on top of the lane executor.

This is the serving frontend the ROADMAP's production story needs: jobs are
not a fixed up-front list but arrive dynamically — ``submit(job)`` returns
a :class:`JobHandle` immediately, ``await handle.result()`` resolves when
the job's last block completes, and submissions made while the machine is
busy become late arrivals that the scheduling core (SRTF + structural
prediction, or any registered policy/predictor) sees exactly like the
paper's staggered kernel launches.

Architecture::

    asyncio world                      driver thread
    -------------                      -------------
    submit(job) ──► pending queue ──►  LaneExecutor.add_job(...)
    handle.result() ◄── Future ◄─────  LaneExecutor.step() loop
    handle.cancel() ──► cancel queue ► LaneExecutor.cancel(key)

A single daemon driver thread owns the :class:`LaneExecutor` (real JAX
computations run inside its ``step()``); the asyncio side communicates only
through thread-safe queues and ``concurrent.futures.Future``.  The executor
is a :class:`repro.core.machine.Machine`, so every policy/predictor in the
registry works unmodified.

Per-tenant accounting: each submission carries a ``tenant`` label (defaults
to the job name); :meth:`SchedulerService.tenant_metrics` reports STP and
ANTT per tenant, using caller-provided solo runtimes when available and the
structural (Eq. 1) estimate from the predictor's sampled ``t`` otherwise.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

from .executor import ExecutorJob, JobResult, LaneExecutor
from .metrics import WorkloadMetrics, evaluate
from .policies import Policy, make_policy
from .predictor import Predictor, staircase_runtime


class JobCancelled(Exception):
    """Raised by ``handle.result()`` when the job was cancelled."""


class JobHandle:
    """Awaitable handle for one submitted job."""

    def __init__(self, key: str, tenant: str, service: "SchedulerService"):
        self.key = key
        self.tenant = tenant
        self._service = service
        self._future: concurrent.futures.Future = concurrent.futures.Future()

    async def result(self) -> JobResult:
        """Await the job's :class:`JobResult` (raises on cancellation)."""
        return await asyncio.wrap_future(self._future)

    def result_blocking(self, timeout: Optional[float] = None) -> JobResult:
        """Synchronous variant of :meth:`result` for non-async callers."""
        return self._future.result(timeout)

    def done(self) -> bool:
        return self._future.done()

    def cancel(self) -> None:
        """Request cancellation at the next block boundary."""
        self._service._request_cancel(self.key)


@dataclass
class _TenantLedger:
    """Finished-job accounting for one tenant."""

    results: List[JobResult] = field(default_factory=list)
    turnaround: Dict[str, float] = field(default_factory=dict)
    solo: Dict[str, float] = field(default_factory=dict)
    solo_estimated: bool = False
    cancelled: int = 0


class SchedulerService:
    """Multi-tenant async frontend over one :class:`LaneExecutor` machine.

    Parameters mirror the executor: ``policy``/``predictor`` accept registry
    names or instances.  Use as a context manager, or call :meth:`close`
    (or ``await aclose()``) when done; ``close`` waits for in-flight jobs
    unless ``cancel_pending=True``.
    """

    def __init__(self, n_lanes: int = 4,
                 policy: Union[str, Policy] = "srtf",
                 predictor: Union[str, Predictor, None] = None):
        if isinstance(policy, str):
            policy = make_policy(policy)
        self._ex = LaneExecutor([], policy, n_lanes=n_lanes,
                                predictor=predictor)
        self._lock = threading.Condition()
        self._pending: deque = deque()       # (job, key, tenant, solo)
        self._cancels: deque = deque()       # keys
        self._handles: Dict[str, JobHandle] = {}
        self._ledgers: Dict[str, _TenantLedger] = {}
        self._resolved: set = set()
        self._closed = False
        self._count = 0
        self._thread = threading.Thread(
            target=self._drive, name="scheduler-service", daemon=True)
        self._thread.start()

    # ----------------------------------------------------------- frontend
    def submit(self, job: ExecutorJob, tenant: Optional[str] = None,
               solo_runtime: Optional[float] = None) -> JobHandle:
        """Submit one job; returns immediately with an awaitable handle.

        ``solo_runtime`` (seconds, measured with the job running alone)
        makes the tenant's STP/ANTT exact; without it the service falls
        back to the predictor's structural estimate.
        Thread-safe; callable from sync or async code.
        """
        tenant = tenant if tenant is not None else job.tenant or job.name
        with self._lock:
            if self._closed:
                raise RuntimeError("service is closed")
            key = f"{job.name}#{self._count}"
            self._count += 1
            handle = JobHandle(key, tenant, self)
            self._handles[key] = handle
            self._pending.append((job, key, tenant, solo_runtime))
            self._lock.notify()
        return handle

    def _request_cancel(self, key: str) -> None:
        with self._lock:
            self._cancels.append(key)
            self._lock.notify()

    async def drain(self) -> List[JobResult]:
        """Await every handle submitted so far; cancelled jobs are skipped."""
        out = []
        for handle in list(self._handles.values()):
            try:
                out.append(await handle.result())
            except JobCancelled:
                pass
        return out

    def close(self, cancel_pending: bool = False) -> None:
        """Stop accepting jobs and shut the driver down.

        With ``cancel_pending`` the machine abandons unfinished jobs at the
        next block boundary; otherwise it runs them to completion.
        """
        with self._lock:
            if self._closed:
                return
            if cancel_pending:
                for key, h in self._handles.items():
                    if not h.done():
                        self._cancels.append(key)
            self._closed = True
            self._lock.notify()
        self._thread.join()

    async def aclose(self, cancel_pending: bool = False) -> None:
        await asyncio.to_thread(self.close, cancel_pending)

    def __enter__(self) -> "SchedulerService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- clocks
    @property
    def machine_time(self) -> float:
        """The machine's virtual clock (advances with executed blocks)."""
        return self._ex.now

    async def wait_until_busy(self, timeout: float = 5.0) -> None:
        """Await until the machine has executed at least one block.

        Useful to guarantee a subsequent :meth:`submit` is a *late* arrival
        (the machine clock has provably advanced past it).
        """
        deadline = time.monotonic() + timeout
        while self._ex.now == 0.0:
            if time.monotonic() > deadline:
                raise TimeoutError("machine never started executing")
            await asyncio.sleep(0.001)

    # ------------------------------------------------------------ metrics
    def tenant_metrics(self) -> Dict[str, WorkloadMetrics]:
        """STP/ANTT/fairness per tenant over finished (uncancelled) jobs."""
        with self._lock:
            ledgers = {t: (dict(led.turnaround), dict(led.solo))
                       for t, led in self._ledgers.items() if led.turnaround}
        return {t: evaluate(turn, solo) for t, (turn, solo) in ledgers.items()}

    def tenant_report(self) -> Dict[str, dict]:
        """Per-tenant summary: metrics plus job counts and estimation flag."""
        metrics = self.tenant_metrics()
        with self._lock:
            out = {}
            for tenant, ledger in self._ledgers.items():
                m = metrics.get(tenant)
                out[tenant] = {
                    "jobs": len(ledger.results),
                    "cancelled": ledger.cancelled,
                    "solo_estimated": ledger.solo_estimated,
                    "metrics": m.as_dict() if m else None,
                }
        return out

    # ------------------------------------------------------------- driver
    def _drive(self) -> None:
        try:
            self._drive_loop()
        except BaseException as exc:       # fail awaiters, don't hang them
            with self._lock:
                self._closed = True
                handles = list(self._handles.values())
            for handle in handles:
                if not handle.done():
                    handle._future.set_exception(exc)
            raise

    def _drive_loop(self) -> None:
        ex = self._ex
        tenants: Dict[str, str] = {}
        solo_hints: Dict[str, Optional[float]] = {}
        while True:
            with self._lock:
                # Block until there is work: every producer (submit,
                # _request_cancel, close) notifies under this lock, and the
                # machine's event queue only changes from this thread, so an
                # untimed wait cannot miss a wakeup.
                while (not self._pending and not self._cancels
                       and not ex.pending_events() and not self._closed):
                    self._lock.wait()
                if (self._closed and not self._pending and not self._cancels
                        and not ex.pending_events()):
                    break
                pending, self._pending = list(self._pending), deque()
                cancels, self._cancels = list(self._cancels), deque()
            for job, key, tenant, solo in pending:
                tenants[key] = tenant
                solo_hints[key] = solo
                ex.add_job(job, key=key)
            for key in cancels:
                ex.cancel(key)
            ex.step()
            self._harvest(tenants, solo_hints)
        self._harvest(tenants, solo_hints)
        # anything never started (e.g. closed with cancel_pending): fail it
        for key, handle in self._handles.items():
            if not handle.done():
                handle._future.set_exception(
                    JobCancelled(f"{key} cancelled at service shutdown"))

    def _harvest(self, tenants: Dict[str, str],
                 solo_hints: Dict[str, Optional[float]]) -> None:
        for key, result in list(self._ex.results.items()):
            if key in self._resolved:
                continue
            self._resolved.add(key)
            self._record(key, result, tenants, solo_hints)

    def _record(self, key: str, result: JobResult, tenants: Dict[str, str],
                solo_hints: Dict[str, Optional[float]]) -> None:
        with self._lock:
            tenant = tenants.get(key, key.rsplit("#", 1)[0])
            ledger = self._ledgers.setdefault(tenant, _TenantLedger())
            handle = self._handles.get(key)
            if result.cancelled:
                ledger.cancelled += 1
                if handle is not None:
                    handle._future.set_exception(
                        JobCancelled(f"{key} cancelled"))
                return
            ledger.results.append(result)
            ledger.turnaround[key] = result.turnaround
            solo = solo_hints.get(key)
            if solo is None:
                solo = self._estimate_solo(key, result)
                ledger.solo_estimated = True
            ledger.solo[key] = max(solo, 1e-9)
        if handle is not None:
            handle._future.set_result(result)

    def _estimate_solo(self, key: str, result: JobResult) -> float:
        """Structural (Eq. 1) solo-runtime estimate from the sampled ``t``.

        Running alone the job spreads over every healthy lane up to its own
        residency limit; with the predictor's per-block ``t`` the staircase
        model gives the isolated runtime.
        """
        run = self._ex.runs[key]
        ts = [t for t in (self._ex.predictor.sampled_t(key, sm)
                          for sm in range(self._ex.n_sm)) if t is not None]
        if not ts:
            return result.turnaround
        lanes = max(1, sum(1 for ln in self._ex.sms if not ln.failed))
        residency = min(run.spec.max_residency, lanes)
        return staircase_runtime(run.spec.num_blocks, residency,
                                 sum(ts) / len(ts))


__all__ = [
    "JobCancelled",
    "JobHandle",
    "SchedulerService",
]
