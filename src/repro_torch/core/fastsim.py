"""Compiled DES engine behind the Machine protocol (DESIGN.md Section 10).

:class:`FastSimulator` is a :class:`repro.core.simulator.Simulator` whose
``run()`` executes the event loop over flat NumPy arrays via one of three
interchangeable backends of the SAME algorithm
(:mod:`repro.core.fastsim_twin`):

* ``native`` — generated C compiled with ``-ffp-contract=off``
  (:mod:`repro.core.fastsim_c`); the fast one.
* ``numba`` — the twin under ``@njit`` when numba is importable
  (``REPRO_NO_NUMBA=1`` forces it off).
* ``interp`` — the twin interpreted over NumPy arrays: always
  importable, byte-identical, slow (the correctness oracle for the
  other two; never the default).

The engine is bit-identical to the reference ``Simulator.run`` by
construction: every float expression, every container iteration order and
even the event heap's array layout mirror the reference (the twin's
module docstring and DESIGN.md Section 10 spell out the invariants).
Unsupported configurations — custom policy/predictor subclasses,
``fast_path=False``, cancelled runs — transparently fall back to the
reference loop.

Segment protocol: ``run()`` repeatedly (1) gathers all Python-object
state into the twin's array layout, (2) calls ``advance`` until it exits
(completion, horizon truncation, a kernel completion that must feed the
closed-loop arrival source, or buffer-headroom exits), (3) scatters the
arrays back into the Python objects.  After every scatter the simulator
is a valid reference ``Simulator`` mid-run — the two implementations can
hand a simulation to each other at any segment boundary.
"""

from __future__ import annotations

import itertools
import math
import os
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import fastsim_twin as tw
from .events import Hold, IssueGrant, PreemptAtBoundary, SampleOnSM
from .policies import (
    _HOLD_ADAPTIVE,
    _HOLD_HEAD_OF_LINE,
    _HOLD_MPMAX,
    _HOLD_NO_ELIGIBLE,
    _HOLD_NO_UNDISPATCHED,
    _HOLD_SAMPLING,
    CappedFIFO,
    FIFO,
    LJF,
    MPMax,
    SJF,
    SRTF,
    SRTFAdaptive,
    SRTFZeroSampling,
)
from .predictor import EWMAPredictor, PerSMState, SimpleSlicingPredictor
from .machine import KernelRun
from .simulator import (
    _ARRIVAL,
    _BLOCK_END,
    BlockRecord,
    PredictionRecord,
    SimResult,
    Simulator,
)

_NAN = float("nan")

#: Exact-type -> twin policy id.  Exact types only: a user subclass may
#: override any hook, so it must take the reference path.
_POLICY_IDS = {
    FIFO: tw.POL_FIFO,
    CappedFIFO: tw.POL_FIFO_CAP,
    SJF: tw.POL_SJF,
    LJF: tw.POL_LJF,
    MPMax: tw.POL_MPMAX,
    SRTF: tw.POL_SRTF,
    SRTFZeroSampling: tw.POL_SRTF_ZERO,
    SRTFAdaptive: tw.POL_SRTF_ADAPTIVE,
}

_SRTF_FAMILY = (tw.POL_SRTF, tw.POL_SRTF_ZERO, tw.POL_SRTF_ADAPTIVE)

_HOLD_BY_CODE = {
    tw.DEC_HOLD_HEAD: _HOLD_HEAD_OF_LINE,
    tw.DEC_HOLD_NO_UNDISP: _HOLD_NO_UNDISPATCHED,
    tw.DEC_HOLD_SAMPLING: _HOLD_SAMPLING,
    tw.DEC_HOLD_NO_ELIG: _HOLD_NO_ELIGIBLE,
    tw.DEC_HOLD_MPMAX: _HOLD_MPMAX,
    tw.DEC_HOLD_ADAPTIVE: _HOLD_ADAPTIVE,
}


# ------------------------------------------------------ backend resolution
_native_fn = "unresolved"


def _native_advance():
    """The generated-C advance callable, or None (build unavailable)."""
    global _native_fn
    if _native_fn == "unresolved":
        _native_fn = None
        if os.environ.get("REPRO_NO_NATIVE") != "1":
            try:
                from .fastsim_c import native_advance
                _native_fn = native_advance()
            except Exception:
                _native_fn = None
    return _native_fn


def backend_name() -> str:
    """Which backend the compiled engine would use right now."""
    if _native_advance() is not None:
        return "native"
    if tw.NUMBA_AVAILABLE:
        return "numba"
    return "interp"


def default_engine() -> str:
    """``"compiled"`` when a *fast* backend exists, else ``"python"``.

    The interpreted twin is byte-identical but slower than the reference
    loop — it exists as the numba-absent correctness fallback, not as a
    default (import must never hard-require numba).
    """
    return "compiled" if backend_name() != "interp" else "python"


def engine_token(engine: str) -> str:
    """Result-determining engine fingerprint for sweep cache keys.

    All backends are gated bit-identical, but the cache key still records
    which one produced a cell (``compiled-native`` / ``compiled-numba`` /
    ``compiled-interp``) so a gating regression can never silently mix
    provenance across cached results.
    """
    if engine == "compiled":
        return f"compiled-{backend_name()}"
    return "python"


def _decision_object(code: int, key: Optional[str]):
    if code == tw.DEC_GRANT:
        return IssueGrant(key)
    if code == tw.DEC_SAMPLE:
        return SampleOnSM(key)
    if code == tw.DEC_PREEMPT:
        return PreemptAtBoundary(key)
    return _HOLD_BY_CODE[code]


class FastSimulator(Simulator):
    """Simulator whose event loop runs on the compiled flat-array engine.

    Constructor signature matches :class:`Simulator`; ``backend`` pins a
    specific engine backend (``"native"``/``"numba"``/``"interp"``, None =
    best available) — used by the equivalence tests to force each one.
    """

    def __init__(self, *args, backend: Optional[str] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self._backend = backend
        #: Decision-buffer capacity, persisted across segments and doubled
        #: on buffer-headroom exits (decision volume is the one record
        #: stream with no cheap a-priori bound).
        self._dec_cap = 4096
        #: Staged-arrival window handed to a lowered closed-loop source
        #: per rebuild (tests shrink it to force pool-exhaustion resumes).
        self._stage_cap = 4096
        #: uid -> staged KernelRun, reused across rebuilds (uid, order and
        #: RNG draws are all stable under restaging).
        self._staged_memo: Dict[str, KernelRun] = {}
        self._build_staged: List[KernelRun] = []
        self._build_staged_base = 0
        self._build_lower_mode: Optional[str] = None
        self._build_n_tenants = 0
        #: Think-time tenant parked by a pool-exhaustion exit (-1 = none).
        self._src_pend = -1
        #: Exit-code -> count over every engine segment this simulator
        #: ran (the python-boundary crossing histogram; see the twin's
        #: module docstring for the code table).
        self.segment_exits: Dict[int, int] = {}
        #: Result-only mode (the sweep chunk runner): terminal exits take
        #: the lean scatter — the simulator is NOT a valid mid-run
        #: reference afterwards, only its result fields are.
        self._lean_result = False
        #: Shared staging prototype (chunk runner, DESIGN.md Section 13):
        #: a dict shared by sibling cells built from the same body
        #: (arrivals, seed, n_sm, until, oracle) so later siblings clone
        #: the staged arrays instead of rebuilding them.
        self._stage_proto: Optional[dict] = None

    # ------------------------------------------------------------- driver
    def _engine_supported(self) -> bool:
        if not self.fast_path:
            return False
        if type(self.core.policy) not in _POLICY_IDS:
            return False
        if type(self.predictor) not in (SimpleSlicingPredictor,
                                        EWMAPredictor):
            return False
        for run in self.runs.values():
            if run.cancelled:
                return False
        return True

    def _advance_fn(self):
        backend = self._backend
        if backend is None:
            backend = backend_name()
        if backend == "native":
            return _native_advance()
        if backend == "numba" and not tw.NUMBA_AVAILABLE:
            return None
        return tw.advance

    def run(self, until: Optional[float] = None) -> SimResult:
        if not self._engine_supported():
            return Simulator.run(self, until)
        advance = self._advance_fn()
        if advance is None:
            return Simulator.run(self, until)
        resume = False
        first = True
        while True:
            state = None
            if first and self._stage_proto is not None:
                state, keys = self._proto_clone(until)
            if state is None:
                state, keys = self._build_state(until, resume)
                if first and self._stage_proto is not None:
                    self._proto_store(state, keys, until, resume)
            first = False
            resume = False
            rc = int(advance(state))
            self.segment_exits[rc] = self.segment_exits.get(rc, 0) + 1
            if (rc == 0 or rc == 1) and self._lean_result:
                self._scatter_result(state, keys)
                break
            self._scatter(state, keys)
            if rc == 0 or rc == 1:
                break
            if rc == 2:
                # A kernel finished with a python-mediated arrival source
                # attached: the reference calls _feed_completion between
                # KernelEnded and the machine-wide fan-out, so the engine
                # exits there and re-enters with RESUME (= run the
                # pending fan-out first).
                self._feed_completion(keys[int(state[tw.S_SI][tw.SI_EXIT_RUN])])
                resume = True
            elif rc == 7:
                # Lowered source ran its staged variate pool dry mid
                # injection: the rebuild stages a fresh window and the
                # engine resumes the interrupted release before the
                # pending fan-out.
                resume = True
            elif rc == 5:
                self._dec_cap *= 2
            # rc 3/4/6: capacities are recomputed from the just-scattered
            # state on rebuild, so re-entry always has fresh headroom.
        return SimResult(self)

    # ------------------------------------------------- staging prototype
    def _proto_fits(self, pol: Optional[int]) -> bool:
        """Whether this simulator's policy/predictor state is covered by
        the prototype patch set: a policy the clone path knows how to
        re-apply, still in its freshly-constructed (empty) state, over a
        predictor with no per-kernel state.  SJF/LJF bake per-run sort
        keys (``RF_SJFKEY``) into the arrays, so they neither seed nor
        clone a prototype."""
        if pol is None or pol == tw.POL_SJF or pol == tw.POL_LJF:
            return False
        if self.predictor._state:
            return False
        policy = self.core.policy
        if pol in _SRTF_FAMILY and (policy.eligible or policy.sample_queue
                                    or policy.sampling is not None):
            return False
        if pol == tw.POL_MPMAX and policy._caps:
            return False
        if pol == tw.POL_SRTF_ADAPTIVE and (policy._caps
                                            or policy._excl_pred):
            return False
        return True

    def _proto_store(self, state: tuple, keys: List[str],
                     until: Optional[float], resume: bool) -> None:
        """Seed the group's staging prototype from a just-built state.

        Only a fresh, source-free, record-free first segment is general
        enough for siblings to clone; anything else leaves the prototype
        empty and every sibling builds normally."""
        proto = self._stage_proto
        if proto is None or proto.get("state") is not None:
            return
        if (resume or self.now != 0.0 or self._arrival_source is not None
                or self._build_lower_mode is not None
                or self.trace is not None or self.decisions is not None
                or self.predictions is not None):
            return
        if not self._proto_fits(_POLICY_IDS.get(type(self.core.policy))):
            return
        proto["state"] = tuple(arr.copy() for arr in state)
        proto["keys"] = list(keys)
        proto["until"] = until

    def _proto_clone(self, until: Optional[float]):
        """Clone the group's staging prototype instead of rebuilding.

        The chunk runner guarantees every simulator sharing one proto
        dict was constructed from the same body (arrivals, seed, n_sm,
        until, oracle runtimes); only the freshly-built policy/predictor
        differ.  The clone memcpys the staged arrays and re-applies
        exactly the policy/predictor-dependent entries ``_build_state``
        writes; a configuration outside the patch set falls back to a
        normal build (returns ``(None, None)``)."""
        proto = self._stage_proto
        if (proto.get("state") is None or proto["until"] != until
                or self._arrival_source is not None
                or self.trace is not None or self.decisions is not None
                or self.predictions is not None):
            return None, None
        policy = self.core.policy
        predictor = self.predictor
        pol = _POLICY_IDS.get(type(policy))
        if not self._proto_fits(pol):
            return None, None
        # One scratch state per proto, refreshed in place: siblings run
        # strictly serially in the chunk runner and read everything they
        # need out of the arrays before the next cell starts, so reusing
        # the buffers (same tuple object — the native backend caches the
        # ctypes pointers by tuple identity) is safe and skips 31
        # allocations per sibling.
        state = proto.get("scratch")
        if state is None:
            state = tuple(arr.copy() for arr in proto["state"])
            proto["scratch"] = state
        else:
            for dst, src in zip(state, proto["state"]):
                np.copyto(dst, src)
        si, ci, cf = state[0], state[2], state[3]
        si[tw.SI_SEQ] = next(self._seq)
        si[tw.SI_SHARING] = 0
        ci[tw.CI_POLICY] = pol
        ci[tw.CI_UNLIMITED] = 1 if policy.unlimited_caps else 0
        ci[tw.CI_DRIVE_PRED] = 1 if self._drive_predictor else 0
        ci[tw.CI_FIXED_CAP] = 0
        ci[tw.CI_SAMPLE_SM] = 0
        ci[tw.CI_SHARED_RES] = 0
        ci[tw.CI_PRED_KIND] = 0
        cf[tw.CF_THRESHOLD] = 0.0
        cf[tw.CF_HYSTERESIS] = 0.0
        cf[tw.CF_ALPHA] = 0.0
        if pol == tw.POL_FIFO_CAP:
            ci[tw.CI_FIXED_CAP] = policy.cap
        if pol in _SRTF_FAMILY:
            ci[tw.CI_SAMPLE_SM] = policy.sample_sm
        if pol == tw.POL_SRTF_ADAPTIVE:
            ci[tw.CI_SHARED_RES] = policy.shared_residency
            cf[tw.CF_THRESHOLD] = policy.unfairness_threshold
            cf[tw.CF_HYSTERESIS] = policy.hysteresis
            si[tw.SI_SHARING] = 1 if policy.sharing else 0
        if type(predictor) is EWMAPredictor:
            ci[tw.CI_PRED_KIND] = 1
            cf[tw.CF_ALPHA] = predictor.alpha
        self._build_staged = []
        self._build_lower_mode = None
        return state, proto["keys"]

    # -------------------------------------------------------------- build
    def _stage_source(self) -> Tuple[List[KernelRun], Optional[dict]]:
        """Stage a window of pre-drawn future arrivals from a lowered
        closed-loop source.

        Returns ``(staged_runs, lowering)``; ``(.., None)`` when the
        attached source (if any) is not lowerable and completions must
        keep crossing the python boundary (exit 2).  Staged KernelRuns
        carry their final uid/order/RNG state already — the engine only
        decides WHEN (and for think-time, for which tenant) each one is
        injected."""
        source = self._arrival_source
        if source is None or self._source_time_scale != 1.0:
            return [], None
        stage = getattr(source, "engine_stage", None)
        if stage is None:
            return [], None
        lower = stage(self._stage_cap)
        if lower is None:
            return [], None
        base = next(self._arrival_order)
        self._arrival_order = itertools.count(base)
        memo = self._staged_memo
        times = lower.get("times")
        staged: List[KernelRun] = []
        for k, uid in enumerate(lower["uids"]):
            run = memo.get(uid)
            if run is None:
                # Provisional arrival time; _src_inject decides the real
                # one (clipped to `now`) and _scatter copies it back.
                at = times[k] if times is not None else 0.0
                run = KernelRun(uid, lower["specs"][k], at, base + k)
                self._init_kernel_rng(run)
                memo[uid] = run
            staged.append(run)
        self._build_staged_base = base
        return staged, lower

    def _build_state(self, until: Optional[float],
                     resume: bool) -> Tuple[tuple, List[str]]:
        """Gather all simulation state into the twin's array layout."""
        n_sm = self.n_sm
        runs = sorted(self.runs.values(), key=lambda r: r.order)
        staged, lower = self._stage_source()
        n_real = len(runs)
        if staged:
            runs = runs + staged
        self._build_staged = staged
        self._build_lower_mode = None if lower is None else lower["mode"]
        keys = [run.key for run in runs]
        index = {key: i for i, key in enumerate(keys)}
        n = len(runs)
        policy = self.core.policy
        predictor = self.predictor
        pol = _POLICY_IDS[type(policy)]

        si = np.zeros(tw.SI_LEN, np.int64)
        sd = np.zeros(tw.SD_LEN, np.float64)
        ci = np.zeros(tw.CI_LEN, np.int64)
        cf = np.zeros(tw.CF_LEN, np.float64)
        ri = np.zeros((n, tw.RI_LEN), np.int64)
        rf = np.zeros((n, tw.RF_LEN), np.float64)
        psi = np.zeros((n, n_sm, tw.PI_LEN), np.int64)
        psf = np.zeros((n, n_sm, tw.PF_LEN), np.float64)
        bs = np.full((n, n_sm, tw.MAX_BLOCK_SLOTS), _NAN, np.float64)
        sl = np.full((n_sm, tw.MAX_BLOCK_SLOTS), -1, np.int64)
        smi = np.zeros((n_sm, tw.SMI_LEN), np.int64)
        smf = np.zeros((n_sm, 1), np.float64)

        # -- scalars ----------------------------------------------------
        events = self._events
        si[tw.SI_SEQ] = next(self._seq)
        si[tw.SI_HEAP_LEN] = len(events)
        si[tw.SI_PENDING] = self._pending_arrivals
        si[tw.SI_SAMPLING] = -1
        si[tw.SI_ACTIVE_DIRTY] = 1
        si[tw.SI_EXIT_RUN] = -1
        si[tw.SI_RESUME] = 1 if resume else 0
        sd[tw.SD_NOW] = self.now
        sd[tw.SD_BUSY] = self.busy_time
        sd[tw.SD_HORIZON] = math.inf if until is None else until

        # -- configuration ----------------------------------------------
        rec_trace = self.trace is not None
        rec_dec = self.decisions is not None
        rec_pred = self.predictions is not None
        remaining_issue = sum(r.spec.num_blocks - r.issued for r in runs)
        remaining_done = sum(r.spec.num_blocks - r.done for r in runs)
        src_reserve = 0
        if lower is not None:
            src_reserve = (lower["population"] if lower["mode"] == "mgk"
                           else 1)
        heap_cap = max(256, 2 * len(events) + 9 * n_sm + 16 + src_reserve)
        trace_cap = remaining_issue + 8 * n_sm + 32 if rec_trace else 1
        dec_cap = max(self._dec_cap, 9 * n_sm + 64) if rec_dec else 1
        pred_cap = remaining_done + 16 if rec_pred else 1

        ci[tw.CI_POLICY] = pol
        ci[tw.CI_NSM] = n_sm
        ci[tw.CI_NRUNS] = n
        ci[tw.CI_UNLIMITED] = 1 if policy.unlimited_caps else 0
        ci[tw.CI_DRIVE_PRED] = 1 if self._drive_predictor else 0
        ci[tw.CI_REC_TRACE] = 1 if rec_trace else 0
        ci[tw.CI_REC_DEC] = 1 if rec_dec else 0
        ci[tw.CI_REC_PRED] = 1 if rec_pred else 0
        ci[tw.CI_HAS_SOURCE] = 1 if self._arrival_source is not None else 0
        if lower is not None:
            ci[tw.CI_SRC_MODE] = (tw.SRCMODE_MGK if lower["mode"] == "mgk"
                                  else tw.SRCMODE_THINK)
            ci[tw.CI_SRC_RESERVE] = src_reserve
        ci[tw.CI_HEAP_CAP] = heap_cap
        ci[tw.CI_TRACE_CAP] = trace_cap
        ci[tw.CI_DEC_CAP] = dec_cap
        ci[tw.CI_PRED_CAP] = pred_cap
        if pol == tw.POL_FIFO_CAP:
            ci[tw.CI_FIXED_CAP] = policy.cap
        if pol in _SRTF_FAMILY:
            ci[tw.CI_SAMPLE_SM] = policy.sample_sm
        if pol == tw.POL_SRTF_ADAPTIVE:
            ci[tw.CI_SHARED_RES] = policy.shared_residency
            cf[tw.CF_THRESHOLD] = policy.unfairness_threshold
            cf[tw.CF_HYSTERESIS] = policy.hysteresis
        if type(predictor) is EWMAPredictor:
            ci[tw.CI_PRED_KIND] = 1
            cf[tw.CF_ALPHA] = predictor.alpha

        # -- event heap (array layout == reference list layout) ----------
        heap_i = np.zeros((heap_cap, tw.HI_LEN), np.int64)
        heap_f = np.zeros((heap_cap, tw.HF_LEN), np.float64)
        for i, ev in enumerate(events):
            kind = ev[1]
            heap_f[i, tw.HF_TIME] = ev[0]
            heap_i[i, tw.HI_KIND] = kind
            heap_i[i, tw.HI_SEQ] = ev[2]
            if kind == _BLOCK_END:
                heap_i[i, tw.HI_A] = index[ev[3]]
                heap_i[i, tw.HI_B] = ev[4]
                heap_i[i, tw.HI_C] = ev[5]
                heap_f[i, tw.HF_START] = ev[6]
            elif kind == _ARRIVAL:
                heap_i[i, tw.HI_A] = index[ev[3]]
            else:
                heap_i[i, tw.HI_A] = ev[3]

        # -- per-run state + noise / base-duration pools -----------------
        oracle = self.oracle_runtimes
        synced = self._synced_caps
        sign = getattr(policy, "_sign", 1.0)
        noise_parts: List[np.ndarray] = []
        bt_parts: List[np.ndarray] = []
        noise_off = 0
        bt_off = 0
        ri[:, tw.RI_MPCAP] = -1
        ri[:, tw.RI_ADPCAP] = -1
        ri[:, tw.RI_SYNCED] = -1
        ri[:, tw.RI_TENANT] = -1
        for i, run in enumerate(runs):
            spec = run.spec
            ri[i, tw.RI_NUMB] = spec.num_blocks
            ri[i, tw.RI_MAXR] = spec.max_residency
            ri[i, tw.RI_TPB] = spec.threads_per_block
            ri[i, tw.RI_WARPS] = spec.warps_per_block
            ri[i, tw.RI_ISSUED] = run.issued
            ri[i, tw.RI_DONE] = run.done
            ri[i, tw.RI_LAUNCHED] = 1 if run.launched else 0
            cap = synced.get(run.key)
            if cap is not None:
                ri[i, tw.RI_SYNCED] = cap
            ri[i, tw.RI_PKNOWN] = 1 if predictor.has_kernel(run.key) else 0
            ri[i, tw.RI_NOISE_OFF] = noise_off
            ri[i, tw.RI_BT_OFF] = bt_off
            ri[i, tw.RI_EXPECTED] = math.ceil(spec.num_blocks / n_sm)
            noise = np.asarray(run.noise, np.float64)
            noise_parts.append(noise)
            noise_off += len(noise)
            table = np.asarray(spec.base_t_table, np.float64)
            bt_parts.append(table)
            bt_off += len(table)

            rf[i, tw.RF_MEANT] = spec.mean_t
            rf[i, tw.RF_FRAC] = spec.resource_fraction
            rf[i, tw.RF_CSENS] = spec.corunner_sens
            rf[i, tw.RF_CPRESS] = spec.corunner_pressure
            rf[i, tw.RF_STARTUP] = spec.startup_factor
            rf[i, tw.RF_STAGF] = spec.stagger_frac
            rf[i, tw.RF_ARRT] = run.arrival_time
            rf[i, tw.RF_FIN] = (_NAN if run.finish_time is None
                                else run.finish_time)
            rf[i, tw.RF_FIRST] = (_NAN if run.first_issue_time is None
                                  else run.first_issue_time)
            rt = oracle.get(spec.name)
            rf[i, tw.RF_ORACLE] = _NAN if rt is None else rt
            if pol == tw.POL_SJF or pol == tw.POL_LJF:
                if rt is None:
                    rt = spec.solo_staircase_runtime()
                rf[i, tw.RF_SJFKEY] = sign * rt
            rf[i, tw.RF_EXCL] = _NAN

            # Per-SM machine maps are flat lists after RNG init.
            for sm in range(n_sm):
                psi[i, sm, tw.PI_RES] = run.resident_per_sm[sm]
                psi[i, sm, tw.PI_ISSD] = run.issued_per_sm[sm]
                psi[i, sm, tw.PI_STAG] = 1 if run.stagger_sm[sm] else 0
                psf[i, sm, tw.PF_GATE] = run.issue_gate[sm]
            if ri[i, tw.RI_PKNOWN]:
                for sm, st in enumerate(predictor._state[run.key]):
                    psi[i, sm, tw.PI_PDONE] = st.done_blocks
                    psi[i, sm, tw.PI_PRESID] = st.resident_blocks
                    psi[i, sm, tw.PI_PRESLICE] = 1 if st.reslice else 0
                    psi[i, sm, tw.PI_PRUN] = st.running_count
                    psf[i, sm, tw.PF_PT] = _NAN if st.t is None else st.t
                    psf[i, sm, tw.PF_PACT] = st.active_cycles
                    psf[i, sm, tw.PF_PSINCE] = st.running_since
                    for slot, t0 in st.block_start.items():
                        bs[i, sm, slot] = t0
        noise_pool = (np.concatenate(noise_parts) if noise_parts
                      else np.zeros(0, np.float64))
        bt_pool = (np.concatenate(bt_parts) if bt_parts
                   else np.zeros(0, np.float64))

        # -- lowered arrival source (staged variate pool) -----------------
        n_staged = n - n_real
        n_tenants = 0
        if lower is not None and lower["mode"] == "think":
            n_tenants = len(lower["rounds_done"])
        self._build_n_tenants = n_tenants
        srci = np.zeros(tw.SRC_RD0 + n_tenants, np.int64)
        srcf = np.zeros(max(1, n_staged), np.float64)
        srci[tw.SRC_PEND] = -1
        if lower is not None:
            srci[tw.SRC_NSTAGED] = n_staged
            srci[tw.SRC_BASE] = n_real
            srci[tw.SRC_MORE] = 1 if lower["more"] else 0
            if n_staged:
                ri[n_real:, tw.RI_STAGED] = 1
                ri[n_real:, tw.RI_SRC] = 1
            if lower["mode"] == "mgk":
                srci[tw.SRC_INSYS] = lower["in_system"]
                srci[tw.SRC_POP] = lower["population"]
                if n_staged:
                    srcf[:n_staged] = lower["times"]
                live = lower["live"]
                for i in range(n_real):
                    if keys[i] in live:
                        ri[i, tw.RI_SRC] = 1
            else:
                srci[tw.SRC_NROUNDS] = lower["n_rounds"]
                srci[tw.SRC_PEND] = self._src_pend
                for j, done in enumerate(lower["rounds_done"]):
                    srci[tw.SRC_RD0 + j] = done
                if n_staged:
                    srcf[:n_staged] = lower["delays"]
                tenants = lower["tenants"]
                for i in range(n_real):
                    ten = tenants.get(keys[i])
                    if ten is not None:
                        ri[i, tw.RI_TENANT] = ten

        # -- policy-specific state ---------------------------------------
        queue = np.zeros(n + 1, np.int64)
        if pol == tw.POL_MPMAX:
            for key, cap in policy._caps.items():
                ri[index[key], tw.RI_MPCAP] = cap
        if pol in _SRTF_FAMILY:
            for key in policy.eligible:
                ri[index[key], tw.RI_ELIG] = 1
            if policy.sampling is not None:
                si[tw.SI_SAMPLING] = index[policy.sampling]
            for j, key in enumerate(policy.sample_queue):
                queue[j] = index[key]
            si[tw.SI_QTAIL] = len(policy.sample_queue)
        if pol == tw.POL_SRTF_ADAPTIVE:
            si[tw.SI_SHARING] = 1 if policy.sharing else 0
            for key, cap in policy._caps.items():
                ri[index[key], tw.RI_ADPCAP] = cap
            for key, pred in policy._excl_pred.items():
                rf[index[key], tw.RF_EXCL] = pred

        # -- SM resource pools -------------------------------------------
        for s, sm_state in enumerate(self.sms):
            smi[s, tw.SMI_THR] = sm_state.used_threads
            smi[s, tw.SMI_FREETOP] = len(sm_state.free_slots)
            for j, slot in enumerate(sm_state.free_slots):
                smi[s, tw.SMI_FS0 + j] = slot
            smf[s, 0] = sm_state.used_fraction
            for slot, key in sm_state.resident.items():
                sl[s, slot] = index[key]

        # -- record buffers + scratch ------------------------------------
        tri = np.zeros((trace_cap, 3), np.int64)
        trf = np.zeros((trace_cap, 2), np.float64)
        dci = np.zeros((dec_cap, 3), np.int64)
        dcf = np.zeros((dec_cap, 1), np.float64)
        pri = np.zeros((pred_cap, 3), np.int64)
        prf = np.zeros((pred_cap, 2), np.float64)
        act = np.zeros(max(n, 1), np.int64)
        rwi = np.zeros(max(n, 1), np.int64)
        rwf = np.zeros((max(n, 1), 3), np.float64)
        newc = np.zeros(max(n, 1), np.int64)
        cand = np.zeros(max(n, 1), np.int64)
        crem = np.zeros(max(n, 1), np.float64)

        state = (si, sd, ci, cf, ri, rf, psi, psf, bs, sl, smi, smf,
                 heap_i, heap_f, tri, trf, dci, dcf, pri, prf,
                 act, queue, rwi, rwf, newc, cand, crem,
                 noise_pool, bt_pool, srci, srcf)
        return state, keys

    # ------------------------------------------------------------ scatter
    def _scatter(self, state: tuple, keys: List[str]) -> None:
        """Write the complete array state back into the Python objects.

        Runs at EVERY engine exit: afterwards ``self`` is a valid
        reference :class:`Simulator` mid-run (same heap list, same run /
        SM / policy / predictor state the reference loop would hold)."""
        (si, sd, ci, cf, ri, rf, psi, psf, bs, sl, smi, smf,
         heap_i, heap_f, tri, trf, dci, dcf, pri, prf,
         act, queue, rwi, rwf, newc, cand, crem, _np_pool, _bt_pool,
         srci, _srcf) = state
        n_sm = self.n_sm
        policy = self.core.policy
        predictor = self.predictor
        pol = _POLICY_IDS[type(policy)]

        self.now = float(sd[tw.SD_NOW])
        self.busy_time = float(sd[tw.SD_BUSY])
        self._pending_arrivals = int(si[tw.SI_PENDING])
        self._seq = itertools.count(int(si[tw.SI_SEQ]))

        # -- event heap back to reference tuples (same list layout) ------
        events: List[tuple] = []
        for i in range(int(si[tw.SI_HEAP_LEN])):
            kind = int(heap_i[i, tw.HI_KIND])
            seq = int(heap_i[i, tw.HI_SEQ])
            t = float(heap_f[i, tw.HF_TIME])
            if kind == _BLOCK_END:
                events.append((t, kind, seq, keys[int(heap_i[i, tw.HI_A])],
                               int(heap_i[i, tw.HI_B]),
                               int(heap_i[i, tw.HI_C]),
                               float(heap_f[i, tw.HF_START])))
            elif kind == _ARRIVAL:
                events.append((t, kind, seq, keys[int(heap_i[i, tw.HI_A])]))
            else:
                events.append((t, kind, seq, int(heap_i[i, tw.HI_A])))
        self._events = events

        # -- lowered arrival source: commit consumed stagings -------------
        # Engine-injected staged runs enter self.runs in injection order
        # (same dict insertion order the reference's inject_arrival would
        # produce); the source's python state is rolled forward so the
        # simulator remains a valid reference Simulator mid-run.
        staged = self._build_staged
        mode = self._build_lower_mode
        n_live = len(keys)
        if mode is not None:
            consumed = int(srci[tw.SRC_NEXT])
            n_live = len(keys) - len(staged) + consumed
            for k in range(consumed):
                run = staged[k]
                run.arrival_time = float(rf[n_live - consumed + k,
                                            tw.RF_ARRT])
                self.runs[run.key] = run
                self._staged_memo.pop(run.key, None)
            if staged:
                self._arrival_order = itertools.count(
                    self._build_staged_base + consumed)
            source = self._arrival_source
            if mode == "mgk":
                live = {keys[i] for i in range(n_live)
                        if ri[i, tw.RI_SRC]
                        and rf[i, tw.RF_FIN] != rf[i, tw.RF_FIN]}
                source.engine_commit(
                    consumed, int(srci[tw.SRC_INSYS]), live)
            else:
                self._src_pend = int(srci[tw.SRC_PEND])
                nt = self._build_n_tenants
                rounds = [int(v)
                          for v in srci[tw.SRC_RD0:tw.SRC_RD0 + nt]]
                tenants = {keys[i]: int(ri[i, tw.RI_TENANT])
                           for i in range(n_live)
                           if ri[i, tw.RI_TENANT] >= 0
                           and rf[i, tw.RF_FIN] != rf[i, tw.RF_FIN]}
                source.engine_commit(consumed, rounds, tenants)

        # -- runs ---------------------------------------------------------
        finished_now: List[str] = []
        for i in range(n_live):
            key = keys[i]
            run = self.runs[key]
            run.issued = int(ri[i, tw.RI_ISSUED])
            run.done = int(ri[i, tw.RI_DONE])
            run.launched = bool(ri[i, tw.RI_LAUNCHED])
            fin = rf[i, tw.RF_FIN]
            if fin == fin:
                if run.finish_time is None:
                    finished_now.append(key)
                run.finish_time = float(fin)
            else:
                run.finish_time = None
            first = rf[i, tw.RF_FIRST]
            run.first_issue_time = float(first) if first == first else None
            run.resident_per_sm = [int(v) for v in psi[i, :, tw.PI_RES]]
            run.issued_per_sm = [int(v) for v in psi[i, :, tw.PI_ISSD]]
            run.issue_gate = [float(v) for v in psf[i, :, tw.PF_GATE]]

        # -- SM resource pools --------------------------------------------
        for s, sm_state in enumerate(self.sms):
            sm_state.used_threads = int(smi[s, tw.SMI_THR])
            sm_state.used_fraction = float(smf[s, 0])
            sm_state.free_slots = [
                int(smi[s, tw.SMI_FS0 + j])
                for j in range(int(smi[s, tw.SMI_FREETOP]))]
            resident = {}
            for slot in range(tw.MAX_BLOCK_SLOTS):
                r = int(sl[s, slot])
                if r >= 0:
                    resident[slot] = keys[r]
            sm_state.resident = resident

        # -- policy state -------------------------------------------------
        if pol == tw.POL_MPMAX:
            policy._caps = {
                keys[i]: int(ri[i, tw.RI_MPCAP])
                for i in range(len(keys)) if ri[i, tw.RI_MPCAP] >= 0}
        if pol in _SRTF_FAMILY:
            policy.eligible = {
                keys[i] for i in range(len(keys)) if ri[i, tw.RI_ELIG]}
            samp = int(si[tw.SI_SAMPLING])
            policy.sampling = keys[samp] if samp >= 0 else None
            policy.sample_queue = deque(
                keys[int(queue[j])]
                for j in range(int(si[tw.SI_QHEAD]), int(si[tw.SI_QTAIL])))
        if pol == tw.POL_SRTF_ADAPTIVE:
            policy.sharing = bool(si[tw.SI_SHARING])
            policy._caps = {
                keys[i]: int(ri[i, tw.RI_ADPCAP])
                for i in range(len(keys)) if ri[i, tw.RI_ADPCAP] >= 0}
            policy._excl_pred = {
                keys[i]: float(rf[i, tw.RF_EXCL])
                for i in range(len(keys))
                if rf[i, tw.RF_EXCL] == rf[i, tw.RF_EXCL]}
        # Mirror the decision-singleton cache eviction of on_kernel_end.
        for key in finished_now:
            policy._grants.pop(key, None)
            if pol in _SRTF_FAMILY:
                policy._samples.pop(key, None)
                policy._preempts.pop(key, None)
            if pol == tw.POL_SRTF_ZERO:
                policy._oracle_cache.pop(key, None)

        # -- predictor state ----------------------------------------------
        # Rebuilt fresh in run-index order == launch order (arrival events
        # pop in (time, seq) order and seq is assigned in run order), so
        # dict iteration order matches the reference's insertion order.
        pstate = {}
        for i, key in enumerate(keys):
            if not ri[i, tw.RI_PKNOWN]:
                continue
            expected = int(ri[i, tw.RI_EXPECTED])
            per_sm = []
            for sm in range(n_sm):
                t = psf[i, sm, tw.PF_PT]
                st = PerSMState(
                    total_blocks=expected,
                    done_blocks=int(psi[i, sm, tw.PI_PDONE]),
                    resident_blocks=int(psi[i, sm, tw.PI_PRESID]),
                    t=float(t) if t == t else None,
                    reslice=bool(psi[i, sm, tw.PI_PRESLICE]),
                    active_cycles=float(psf[i, sm, tw.PF_PACT]),
                    running_count=int(psi[i, sm, tw.PI_PRUN]),
                    running_since=float(psf[i, sm, tw.PF_PSINCE]),
                )
                st.blocks_started = st.done_blocks + st.running_count
                starts = {}
                for slot in range(tw.MAX_BLOCK_SLOTS):
                    t0 = bs[i, sm, slot]
                    if t0 == t0:
                        starts[slot] = float(t0)
                st.block_start = starts
                per_sm.append(st)
            pstate[key] = per_sm
        predictor._state = pstate
        # Pure version-counter memo: cleared, the next query recomputes
        # the bit-identical value.
        predictor._rem_version.clear()
        predictor._rem_memo.clear()

        # -- machine caches ------------------------------------------------
        self._era += 1
        self._decision_memo = [None] * n_sm
        self._minfoot_dirty = True
        self._invalidate_active()
        self._synced_caps = {
            keys[i]: int(ri[i, tw.RI_SYNCED])
            for i in range(len(keys)) if ri[i, tw.RI_SYNCED] >= 0}

        # -- record streams ------------------------------------------------
        if self.trace is not None:
            trace = self.trace
            for j in range(int(si[tw.SI_TRACE_N])):
                trace.append(BlockRecord(
                    keys[int(tri[j, 0])], int(tri[j, 1]), int(tri[j, 2]),
                    float(trf[j, 0]), float(trf[j, 1])))
        if self.decisions is not None:
            decisions = self.decisions
            for j in range(int(si[tw.SI_DEC_N])):
                r = int(dci[j, 2])
                decisions.append((
                    float(dcf[j, 0]), int(dci[j, 0]),
                    _decision_object(int(dci[j, 1]),
                                     keys[r] if r >= 0 else None)))
        if self.predictions is not None:
            predictions = self.predictions
            for j in range(int(si[tw.SI_PRED_N])):
                predictions.append(PredictionRecord(
                    keys[int(pri[j, 0])], int(pri[j, 1]),
                    float(prf[j, 0]), int(pri[j, 2]), float(prf[j, 1])))

    def _scatter_result(self, state: tuple, keys: List[str]) -> None:
        """Terminal-exit scatter committing only what :class:`SimResult`
        and ``evaluate_window`` read: now, busy_time, the staged-run
        commit, and per-run issued/done/finish/first-issue.  Skips the
        heap, SM pools, policy/predictor state, record streams and
        source ``engine_commit`` — afterwards ``self`` is NOT a valid
        mid-run reference, only its result fields are."""
        si, sd = state[0], state[1]
        ri, rf = state[4], state[5]
        srci = state[29]
        self.now = float(sd[tw.SD_NOW])
        self.busy_time = float(sd[tw.SD_BUSY])
        staged = self._build_staged
        n_live = len(keys)
        if self._build_lower_mode is not None:
            consumed = int(srci[tw.SRC_NEXT])
            n_live = len(keys) - len(staged) + consumed
            for k in range(consumed):
                run = staged[k]
                run.arrival_time = float(rf[n_live - consumed + k,
                                            tw.RF_ARRT])
                self.runs[run.key] = run
        for i in range(n_live):
            run = self.runs[keys[i]]
            run.issued = int(ri[i, tw.RI_ISSUED])
            run.done = int(ri[i, tw.RI_DONE])
            fin = rf[i, tw.RF_FIN]
            run.finish_time = float(fin) if fin == fin else None
            first = rf[i, tw.RF_FIRST]
            run.first_issue_time = float(first) if first == first else None


__all__ = [
    "FastSimulator",
    "backend_name",
    "default_engine",
    "engine_token",
]
