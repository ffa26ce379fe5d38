"""Structural Runtime Prediction (paper Sections 3-4).

Implements:

* the Staircase model (Eq. 1):          ``T = ceil(N / R) * t``
* the :class:`Predictor` interface      (Algorithm 1 event handlers plus the
  query surface policies consume), with a registry of pluggable
  implementations (``register_predictor`` / ``make_predictor``),
* the Simple Slicing (SS) predictor     (Table 1 state, Algorithm 1 handlers,
  Eq. 2 prediction) — the paper's predictor and the registry default,
* an EWMA baseline predictor            (same interface, blends every block
  duration instead of resampling at slice boundaries) proving the seam.

Predictors are backend-independent: any :class:`repro.core.machine.Machine`
(the discrete-event simulator, the real-JAX lane executor, future cluster
backends) drives them through the four events of Algorithm 1 (``on_launch``
/ ``on_block_start`` / ``on_block_end`` / ``on_kernel_end``) plus the
residency-change reslice of Section 3.4.3.

Terminology note: we keep the paper's names (SM, thread block, kernel,
residency).  In the TPU adaptation SM=lane, block=step, kernel=job; the math
is identical (see DESIGN.md Section 2).
"""

from __future__ import annotations

import math
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Type, Union


def staircase_runtime(num_blocks: int, residency: int, t: float) -> float:
    """Eq. 1: total time for ``num_blocks`` at residency ``residency``.

    ``T = ceil(N / R) * t``.
    """
    if num_blocks <= 0:
        return 0.0
    residency = max(1, int(residency))
    return math.ceil(num_blocks / residency) * float(t)


def staircase_blocks_in(time: float, residency: int, t: float) -> int:
    """Inverse of Eq. 1 (used by SRTF/Adaptive, Section 5.1.2).

    Number of blocks completed within ``time`` at residency ``residency``:
    ``N = T * R / t`` (paper's closed form, non-staircase for tractability).
    """
    if t <= 0 or time <= 0:
        return 0
    return int((time * max(1, residency)) / t)


# ---------------------------------------------------------------- interface


class Predictor(ABC):
    """Online runtime predictor driven by Algorithm-1 events.

    One instance serves a whole machine; state is per ``(kernel, sm)``.
    Machines post events through :class:`repro.core.machine.SchedulerCore`;
    policies query predictions through the read methods.  Implementations
    register with :func:`register_predictor` and are instantiated by name
    via :func:`make_predictor` (machines accept either a name or an
    instance).
    """

    #: Registry name, set by :func:`register_predictor`.
    name: str = "base"

    def __init__(self, n_sm: int):
        self.n_sm = n_sm

    # -- Algorithm 1 event handlers ----------------------------------------
    @abstractmethod
    def on_launch(self, kernel: str, total_blocks: int, residency: int) -> None:
        """ONLAUNCH: a kernel with ``total_blocks`` blocks became visible."""

    @abstractmethod
    def on_block_start(self, kernel: str, sm: int, blkindex: int,
                       now: float) -> None:
        """ONBLOCKSTART: one block of ``kernel`` started on ``sm``."""

    @abstractmethod
    def on_block_end(self, kernel: str, sm: int, blkindex: int,
                     now: float) -> Optional[float]:
        """ONBLOCKEND: returns the updated total-runtime prediction."""

    @abstractmethod
    def on_kernel_end(self, kernel: str) -> None:
        """ONKERNELEND: every block of ``kernel`` completed."""

    @abstractmethod
    def on_residency_change(self, kernel: str, sm: int,
                            new_residency: int) -> None:
        """Section 3.4.3: the residency cap for ``(kernel, sm)`` changed."""

    # -- slice management ---------------------------------------------------
    @abstractmethod
    def reslice_all(self, kernel: Optional[str] = None) -> None:
        """Force a new slice (e.g. co-runner set changed, Section 3.4.4)."""

    @abstractmethod
    def broadcast_t(self, kernel: str, t: float, from_sm: int) -> None:
        """SRTF sampling (Section 5.1.1): seed other units with a sample."""

    # -- queries ------------------------------------------------------------
    @abstractmethod
    def has_kernel(self, kernel: str) -> bool:
        """Whether ``kernel`` has been launched and not dropped."""

    @abstractmethod
    def sampled_t(self, kernel: str, sm: int) -> Optional[float]:
        """Current per-block duration estimate for ``(kernel, sm)``."""

    @abstractmethod
    def done_blocks(self, kernel: str, sm: int) -> int:
        """Blocks of ``kernel`` completed on ``sm`` so far."""

    @abstractmethod
    def remaining(self, kernel: str, sm: int) -> Optional[float]:
        """Predicted remaining cycles for ``(kernel, sm)`` — SRTF's key."""

    @abstractmethod
    def gpu_remaining(self, kernel: str) -> Optional[float]:
        """Machine-level remaining-time estimate across units."""

    @abstractmethod
    def gpu_predicted_total(self, kernel: str, now: float) -> Optional[float]:
        """Machine-level Eq. 2 total-runtime prediction."""


#: Registry of predictor implementations, keyed by their public name.
PREDICTORS: Dict[str, Type[Predictor]] = {}

DEFAULT_PREDICTOR = "simple-slicing"


def register_predictor(name: str):
    """Class decorator registering a :class:`Predictor` under ``name``."""

    def decorate(cls: Type[Predictor]) -> Type[Predictor]:
        cls.name = name
        PREDICTORS[name] = cls
        return cls

    return decorate


def make_predictor(spec: Union[str, Predictor, None], n_sm: int,
                   **kwargs) -> Predictor:
    """Resolve ``spec`` into a predictor instance bound to ``n_sm`` units.

    ``spec`` may be an instance (returned as-is), a registered name, or
    ``None`` for the default (``simple-slicing``, the paper's predictor).
    """
    if isinstance(spec, Predictor):
        return spec
    name = DEFAULT_PREDICTOR if spec is None else spec
    try:
        cls = PREDICTORS[name]
    except KeyError:
        raise ValueError(
            f"unknown predictor {name!r}; choose from {sorted(PREDICTORS)}"
        ) from None
    return cls(n_sm, **kwargs)


# ------------------------------------------------------------ simple slicing


@dataclass(slots=True)
class PerSMState:
    """Table 1: per-kernel state maintained on each SM/lane."""

    total_blocks: int = 0          # Total_Blocks: blocks expected on this SM
    done_blocks: int = 0           # Done_Blocks: blocks completed on this SM
    resident_blocks: int = 1       # Resident_Blocks: residency used in Eq. 2
    t: Optional[float] = None      # duration of a thread block (sampled)
    pred_cycles: Optional[float] = None  # Pred_Cycles: Eq. 2 output
    reslice: bool = True           # Reslice: new slice has started
    # --- bookkeeping for Active_Kernel_Cycles -------------------------------
    active_cycles: float = 0.0     # accumulated cycles with >=1 running block
    running_count: int = 0
    running_since: float = 0.0
    # --- bookkeeping for Block_Start[] --------------------------------------
    block_start: Dict[int, float] = field(default_factory=dict)
    blocks_started: int = 0

    def active_at(self, now: float) -> float:
        if self.running_count > 0:
            return self.active_cycles + (now - self.running_since)
        return self.active_cycles


@register_predictor("simple-slicing")
class SimpleSlicingPredictor(Predictor):
    """The Simple Slicing (SS) online runtime predictor (Section 4).

    One instance serves a whole machine: state is per ``(kernel, sm)``.
    Predictions estimate *total* runtime under current conditions (Eq. 2):

        Pred = Active_Kernel_Cycles
               + (Total_Blocks - Done_Blocks) / Resident_Blocks * t

    ``t`` is resampled at slice boundaries: kernel launch/end (Algorithm 1)
    and residency changes (Section 3.4.3 / 3.4.4).  Per the paper's text
    ("Equation 2 is not [a] step function"), the remaining-work term uses a
    plain division, not the Eq. 1 ceiling.
    """

    def __init__(self, n_sm: int):
        super().__init__(n_sm)
        # Whether _observe must see every measured duration.  Simple
        # Slicing only consumes the first duration of a new slice, so the
        # per-block handler skips the call mid-slice — but ONLY when
        # _observe is the base implementation: any subclass overriding the
        # seam (EWMA, future estimators) is detected here and fed every
        # block, so the optimization can never starve a custom estimator.
        self._observe_every_block = (
            type(self)._observe is not SimpleSlicingPredictor._observe)
        # Per-kernel per-SM Table-1 state, index-addressed: SM ids are
        # dense 0..n_sm-1 on every machine, so a flat list beats a dict in
        # the per-block handlers (state() keeps the lookup API).
        self._state: Dict[str, List[PerSMState]] = {}
        # Version-counter memo for the machine-level remaining estimate:
        # ``gpu_remaining(k)`` is pure over per-(k, sm) state, and that
        # state only changes through the handlers below — each bumps the
        # kernel's version, so an unchanged version returns the memoized
        # float (bit-identical by definition).  SRTF/Adaptive call
        # ``gpu_remaining`` for every active kernel on every block end;
        # most of those calls land between mutations of *other* kernels.
        self._rem_version: Dict[str, int] = {}
        self._rem_memo: Dict[str, tuple] = {}

    def _touch(self, kernel: str) -> None:
        """Invalidate memoized estimates for ``kernel`` (state changed)."""
        self._rem_version[kernel] = self._rem_version.get(kernel, 0) + 1

    # ------------------------------------------------------------------ state
    def state(self, kernel: str, sm: int) -> PerSMState:
        return self._state[kernel][sm]

    def has_kernel(self, kernel: str) -> bool:
        return kernel in self._state

    def drop_kernel(self, kernel: str) -> None:
        self._state.pop(kernel, None)
        self._rem_version.pop(kernel, None)
        self._rem_memo.pop(kernel, None)

    def kernels(self) -> List[str]:
        return list(self._state)

    def sampled_t(self, kernel: str, sm: int) -> Optional[float]:
        if kernel not in self._state:
            return None
        return self._state[kernel][sm].t

    def done_blocks(self, kernel: str, sm: int) -> int:
        if kernel not in self._state:
            return 0
        return self._state[kernel][sm].done_blocks

    # ------------------------------------------------------- Algorithm 1 ----
    def on_launch(self, kernel: str, total_blocks: int, residency: int) -> None:
        """ONLAUNCH: initialise per-SM counters for a newly launched kernel."""
        expected = math.ceil(total_blocks / self.n_sm)
        residency = max(1, residency)
        per_sm = [
            PerSMState(total_blocks=expected, resident_blocks=residency,
                       reslice=True)
            for _ in range(self.n_sm)
        ]
        self._state[kernel] = per_sm
        self._touch(kernel)
        # A launch starts a new slice for every *other* running kernel too
        # (slice boundaries are kernel launches and endings, Section 4).
        # (Reslicing alone does not move any ``t``/``done`` state, so the
        # other kernels' remaining-estimate memos stay valid.)
        for other, states in self._state.items():
            if other == kernel:
                continue
            for st in states:
                st.reslice = True

    def on_kernel_end(self, kernel: str) -> None:
        """ONKERNELEND: mark a new slice for all still-running kernels."""
        for other, states in self._state.items():
            if other == kernel:
                continue
            for st in states:
                st.reslice = True

    def on_block_start(self, kernel: str, sm: int, blkindex: int, now: float) -> None:
        st = self._state[kernel][sm]
        st.block_start[blkindex] = now
        st.blocks_started += 1
        if st.running_count == 0:
            st.running_since = now
        st.running_count += 1

    def on_block_end(self, kernel: str, sm: int, blkindex: int, now: float) -> Optional[float]:
        """ONBLOCKEND + Eq. 2.  Returns the new Pred_Cycles for (kernel, sm).

        The Eq. 2 projection is inlined (same arithmetic as
        :meth:`predict`): this handler runs once per executed block on the
        whole machine.
        """
        st = self._state[kernel][sm]
        st.done_blocks += 1
        start = st.block_start.pop(blkindex, None)
        if st.reslice or st.t is None or self._observe_every_block:
            # Mid-slice Simple Slicing ignores the duration entirely (the
            # `_observe` precondition) — skip the call; estimators that
            # fold every duration set `_observe_every_block`.
            self._observe(st, None if start is None else now - start)
        rc = st.running_count - 1
        st.running_count = rc if rc > 0 else 0
        if rc <= 0:
            st.active_cycles += now - st.running_since
        rv = self._rem_version                     # inlined _touch()
        rv[kernel] = rv.get(kernel, 0) + 1
        t = st.t
        if t is None:
            return None
        remaining_blocks = st.total_blocks - st.done_blocks
        if remaining_blocks < 0:
            remaining_blocks = 0
        res = st.resident_blocks
        remaining = (remaining_blocks / (res if res > 1 else 1)) * t
        active = st.active_cycles
        if st.running_count > 0:
            active += now - st.running_since
        st.pred_cycles = active + remaining
        return st.pred_cycles

    def _observe(self, st: PerSMState, duration: Optional[float]) -> None:
        """Fold one measured block duration into the ``t`` estimate.

        Simple Slicing resamples ``t`` only at slice boundaries (Section 4):
        the first completed block of a new slice sets ``t``; later blocks of
        the same slice are ignored.  Subclasses override this to implement
        other estimators against identical bookkeeping.
        """
        if st.reslice or st.t is None:
            if duration is not None:
                st.t = duration
            st.reslice = False

    # --------------------------------------------------------- reslicing ----
    def on_residency_change(self, kernel: str, sm: int, new_residency: int) -> None:
        """Section 3.4.3: resample ``t`` whenever residency changes."""
        st = self.state(kernel, sm)
        new_residency = max(1, int(new_residency))
        if st.resident_blocks != new_residency:
            st.resident_blocks = new_residency
            st.reslice = True
            self._touch(kernel)

    def reslice_all(self, kernel: Optional[str] = None) -> None:
        """Force a new slice (e.g. co-runner set changed, Section 3.4.4)."""
        targets = [kernel] if kernel is not None else list(self._state)
        for k in targets:
            for st in self._state.get(k, ()):
                st.reslice = True

    def broadcast_t(self, kernel: str, t: float, from_sm: int) -> None:
        """SRTF sampling (Section 5.1.1): copy the sample SM's ``t`` to the
        other SMs as their initial estimate."""
        for sm, st in enumerate(self._state.get(kernel, ())):
            if sm == from_sm:
                continue
            if st.t is None:
                st.t = t
                st.reslice = False
        self._touch(kernel)

    # ------------------------------------------------------- predictions ----
    def predict(self, kernel: str, sm: int, now: float) -> Optional[float]:
        """Eq. 2 prediction of *total* runtime for (kernel, sm)."""
        st = self.state(kernel, sm)
        if st.t is None:
            return None
        remaining_blocks = max(0, st.total_blocks - st.done_blocks)
        remaining = (remaining_blocks / max(1, st.resident_blocks)) * st.t
        st.pred_cycles = st.active_at(now) + remaining
        return st.pred_cycles

    def remaining(self, kernel: str, sm: int) -> Optional[float]:
        """Predicted remaining cycles for (kernel, sm) — the SRTF ranking key."""
        states = self._state.get(kernel)
        if states is None:
            return None
        st = states[sm]
        if st.t is None:
            return None
        remaining_blocks = st.total_blocks - st.done_blocks
        if remaining_blocks < 0:
            remaining_blocks = 0
        res = st.resident_blocks
        return (remaining_blocks / (res if res > 1 else 1)) * st.t

    def gpu_remaining(self, kernel: str) -> Optional[float]:
        """Machine-level remaining-time estimate: mean over SMs with samples.

        Used by SRTF/Adaptive's slowdown projection and for logging; per-SM
        scheduling decisions use :meth:`remaining` directly.  (Inlined
        per-SM arithmetic — this runs for every active kernel on every
        block end under SRTF/Adaptive.)
        """
        states = self._state.get(kernel)
        if states is None:
            return None
        version = self._rem_version.get(kernel, 0)
        memo = self._rem_memo.get(kernel)
        if memo is not None and memo[0] == version:
            return memo[1]
        vals = []
        for st in states:
            if st.t is None:
                continue
            remaining_blocks = st.total_blocks - st.done_blocks
            if remaining_blocks < 0:
                remaining_blocks = 0
            res = st.resident_blocks
            vals.append((remaining_blocks / (res if res > 1 else 1)) * st.t)
        out = (sum(vals) / len(vals)) if vals else None
        self._rem_memo[kernel] = (version, out)
        return out

    def gpu_predicted_total(self, kernel: str, now: float) -> Optional[float]:
        states = self._state.get(kernel)
        if states is None:
            return None
        total = 0.0
        n = 0
        for st in states:
            t = st.t
            if t is None:
                continue
            remaining_blocks = st.total_blocks - st.done_blocks
            if remaining_blocks < 0:
                remaining_blocks = 0
            res = st.resident_blocks
            remaining = (remaining_blocks / (res if res > 1 else 1)) * t
            active = st.active_cycles
            if st.running_count > 0:
                active += now - st.running_since
            st.pred_cycles = active + remaining
            total += st.pred_cycles
            n += 1
        if n == 0:
            return None
        return total / n


# ------------------------------------------------------------ EWMA baseline


@register_predictor("ewma")
class EWMAPredictor(SimpleSlicingPredictor):
    """Exponentially-weighted moving-average baseline predictor.

    Shares Simple Slicing's Table-1 bookkeeping and Eq. 2 projection but
    replaces the slice-boundary resampling of ``t`` with a continuous EWMA
    over *every* measured block duration.  It has no notion of slices, so it
    adapts slowly after residency changes (exactly the failure mode
    Section 3.4.3 motivates) — a useful control to quantify what Simple
    Slicing's reslicing buys, and the proof that the predictor seam is real.
    """

    def __init__(self, n_sm: int, alpha: float = 0.3):
        super().__init__(n_sm)
        self.alpha = alpha

    def _observe(self, st: PerSMState, duration: Optional[float]) -> None:
        st.reslice = False
        if duration is None:
            return
        if st.t is None:
            st.t = duration
        else:
            st.t = self.alpha * duration + (1.0 - self.alpha) * st.t
