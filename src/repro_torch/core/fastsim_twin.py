"""Flat-array DES engine kernel (the compiled core's algorithm "twin").

This module holds ONE algorithm — :func:`advance` — written in nopython
style (scalar loops over preallocated NumPy arrays, no Python objects,
no dicts) so the same source runs three ways:

* interpreted (always importable): the byte-identical pure-NumPy
  fallback that must exist when numba is absent,
* under numba ``@njit`` when numba is importable (``REPRO_NO_NUMBA=1``
  forces it off),
* as the line-by-line template for the generated-C backend
  (:mod:`repro.core.fastsim_c`), which compiles the identical arithmetic
  with ``-ffp-contract=off`` so every float op matches CPython bit for
  bit.

:mod:`repro.core.fastsim` owns the array build/scatter protocol and the
segment driver; the layout constants below are THE contract between all
three implementations (``fastsim_c`` generates ``#define`` lines from
them).  Every float expression mirrors the reference implementation's
association order exactly (see DESIGN.md Section 10); the heap helpers
replicate CPython's ``heapq`` sift routines so even the heap's *array
layout* matches the reference event list element for element.

``advance`` processes events until it must return control to Python::

    exit 0  heap empty (run complete)
    exit 1  horizon truncation (event discarded, ``now`` not advanced)
    exit 2  kernel completed with an arrival source attached
            (driver feeds the source, rebuilds, re-enters with RESUME)
    exit 3  heap headroom low          } driver re-sizes and
    exit 4  trace buffer headroom low  } re-enters; margins below
    exit 5  decision buffer headroom   } guarantee forward
    exit 6  prediction buffer headroom } progress
    exit 7  staged-arrival variate pool exhausted (driver restages a
            fresh window and re-enters with RESUME)
"""

import math
import os

import numpy as np

# ----------------------------------------------------------------- layout
# SI: engine integer scalars.
SI_SEQ = 0           # next event sequence number (itertools.count twin)
SI_HEAP_LEN = 1
SI_PENDING = 2       # queued-but-unprocessed arrival events
SI_SAMPLING = 3      # SRTF sampling kernel (-1 = None)
SI_QHEAD = 4         # SRTF sample queue head/tail into Q
SI_QTAIL = 5
SI_SHARING = 6       # SRTFAdaptive sharing flag
SI_ACTIVE_N = 7
SI_ACTIVE_DIRTY = 8
SI_EXIT_RUN = 9      # run index reported with exit code 2
SI_TRACE_N = 10
SI_DEC_N = 11
SI_PRED_N = 12
SI_RESUME = 13       # enter with a machine-wide fan-out (post-completion)
SI_LEN = 14

# SD: engine float scalars.
SD_NOW = 0
SD_BUSY = 1
SD_HORIZON = 2       # +inf when until=None
SD_LEN = 3

# CI: integer configuration (never written by the engine).
CI_POLICY = 0
CI_NSM = 1
CI_NRUNS = 2
CI_UNLIMITED = 3     # policy.unlimited_caps
CI_FIXED_CAP = 4     # CappedFIFO.cap
CI_SAMPLE_SM = 5
CI_DRIVE_PRED = 6
CI_REC_TRACE = 7
CI_REC_DEC = 8
CI_REC_PRED = 9
CI_HAS_SOURCE = 10
CI_PRED_KIND = 11    # 0 = simple-slicing, 1 = ewma
CI_SHARED_RES = 12   # SRTFAdaptive.shared_residency
CI_HEAP_CAP = 13
CI_TRACE_CAP = 14
CI_DEC_CAP = 15
CI_PRED_CAP = 16
CI_SRC_MODE = 17     # 0 = python-mediated source, else SRCMODE_*
CI_SRC_RESERVE = 18  # max arrivals a single completion may inject
CI_LEN = 19

# CF: float configuration.
CF_ALPHA = 0         # EWMAPredictor.alpha
CF_THRESHOLD = 1     # SRTFAdaptive.unfairness_threshold
CF_HYSTERESIS = 2    # SRTFAdaptive.hysteresis
CF_LEN = 3

# RI: per-run integer state [nruns, RI_LEN].
RI_NUMB = 0          # spec.num_blocks
RI_MAXR = 1          # spec.max_residency
RI_TPB = 2           # spec.threads_per_block
RI_WARPS = 3         # spec.warps_per_block
RI_ISSUED = 4
RI_DONE = 5
RI_LAUNCHED = 6
RI_ELIG = 7          # SRTF eligible-set membership
RI_MPCAP = 8         # MPMax cap (-1 = absent from _caps)
RI_ADPCAP = 9        # SRTFAdaptive cap (-1 = absent from _caps)
RI_SYNCED = 10       # machine._synced_caps memo (-1 = absent)
RI_PKNOWN = 11       # predictor.has_kernel
RI_NOISE_OFF = 12    # offset into the noise pool
RI_BT_OFF = 13       # offset into the base_t_table pool
RI_EXPECTED = 14     # ceil(num_blocks / n_sm), precomputed at build
RI_SRC = 15          # emitted by the lowered arrival source (live set)
RI_STAGED = 16       # staged arrival row, not yet injected
RI_TENANT = 17       # think-time tenant id (-1 = none)
RI_LEN = 18

# RF: per-run float state [nruns, RF_LEN].
RF_MEANT = 0         # spec.mean_t
RF_FRAC = 1          # spec.resource_fraction
RF_CSENS = 2         # spec.corunner_sens
RF_CPRESS = 3        # spec.corunner_pressure
RF_STARTUP = 4       # spec.startup_factor
RF_STAGF = 5         # spec.stagger_frac
RF_ARRT = 6          # arrival_time
RF_FIN = 7           # finish_time (NaN = None)
RF_FIRST = 8         # first_issue_time (NaN = None)
RF_SJFKEY = 9        # sign * solo runtime (SJF/LJF rank key)
RF_ORACLE = 10       # oracle runtime (NaN = None)
RF_EXCL = 11         # SRTFAdaptive._excl_pred (NaN = absent)
RF_LEN = 12

# PS_I: per-(run, sm) integer state [nruns, nsm, PI_LEN].
PI_RES = 0           # run.resident_per_sm
PI_ISSD = 1          # run.issued_per_sm
PI_STAG = 2          # run.stagger_sm
PI_PDONE = 3         # predictor done_blocks
PI_PRESID = 4        # predictor resident_blocks
PI_PRESLICE = 5      # predictor reslice flag
PI_PRUN = 6          # predictor running_count
PI_LEN = 7

# PS_F: per-(run, sm) float state [nruns, nsm, PF_LEN].
PF_GATE = 0          # run.issue_gate
PF_PT = 1            # predictor t (NaN = None)
PF_PACT = 2          # predictor active_cycles
PF_PSINCE = 3        # predictor running_since
PF_LEN = 4

# SM_I: per-SM integer state [nsm, SMI_LEN]; cols 2.. are the free-slot
# stack, mirroring SMState.free_slots (a Python list used as a stack).
SMI_THR = 0          # used_threads
SMI_FREETOP = 1      # free-slot stack height
SMI_FS0 = 2
SMI_LEN = 2 + 8      # MAX_BLOCK_SLOTS

# SM_F: per-SM float state [nsm, 1].
SMF_FRAC = 0         # used_fraction

# HI/HF: binary heap of events [heap_cap, ...] — exact CPython heapq
# layout over rows compared by (time, kind, seq).
HI_KIND = 0
HI_SEQ = 1
HI_A = 2             # ARRIVAL: run | TRY_ISSUE: sm | BLOCK_END: run
HI_B = 3             # BLOCK_END: sm
HI_C = 4             # BLOCK_END: slot
HI_LEN = 5
HF_TIME = 0
HF_START = 1         # BLOCK_END: block start time
HF_LEN = 2

# TR_I/TR_F: trace records (run, sm, slot) + (start, end).
# DC_I/DC_F: decision records (sm, code, run) + (time,).
# PR_I/PR_F: prediction records (run, sm, done) + (time, pred).

# RWI/RWF: SRTFAdaptive fairness rows (run,) + (rem, elapsed, solo).
RW_REM = 0
RW_ELAPSED = 1
RW_SOLO = 2

# Event kinds (tie-break priority order, as in the reference).
EV_ARRIVAL = 0
EV_BLOCK_END = 1
EV_TRY_ISSUE = 2

# Decision codes (scattered back to events.Decision objects).
DEC_GRANT = 0
DEC_SAMPLE = 1
DEC_HOLD_HEAD = 2        # "head-of-line kernel does not fit"
DEC_HOLD_NO_UNDISP = 3   # "no kernel with undispatched blocks"
DEC_HOLD_SAMPLING = 4    # "sample in flight on the sampling SM"
DEC_HOLD_NO_ELIG = 5     # "no eligible kernel with a prediction"
DEC_HOLD_MPMAX = 6       # "all kernels at their MPMax reservation caps"
DEC_HOLD_ADAPTIVE = 7    # "all kernels at their adaptive sharing caps"
DEC_PREEMPT = 8          # PreemptAtBoundary(key)

# Lowered arrival-source modes (CI_SRC_MODE).
SRCMODE_MGK = 1          # MGkClosed, admission="defer"
SRCMODE_THINK = 2        # ThinkTime

# SRCI: arrival-source integer state (flat); SRCF holds one pre-drawn
# variate per staged row (mgk: offered absolute time; think: delay).
SRC_NEXT = 0         # staged variates consumed so far this staging
SRC_NSTAGED = 1      # staged window size
SRC_BASE = 2         # row index of the first staged run
SRC_MORE = 3         # variates exist beyond the staged window
SRC_INSYS = 4        # mgk: kernels currently in the closed system
SRC_POP = 5          # mgk: population bound
SRC_NROUNDS = 6      # think: rounds per tenant
SRC_PEND = 7         # think: tenant awaiting a variate (-1 = none)
SRC_RD0 = 8          # think: per-tenant rounds-done counters tail

# Policy ids.
POL_FIFO = 0
POL_FIFO_CAP = 1
POL_SJF = 2
POL_LJF = 3
POL_MPMAX = 4
POL_SRTF = 5
POL_SRTF_ZERO = 6
POL_SRTF_ADAPTIVE = 7

_EPS = 1e-9
_INF = float("inf")
MAX_BLOCK_SLOTS = 8
MAX_THREADS_PER_SM = 1536
MAX_WARPS_PER_SM = 48.0

#: None is encoded as NaN in every float cell (tested with ``x != x``).
_NAN = float("nan")

# S tuple layout (argument order of advance() and of the C entry point).
S_SI, S_SD, S_CI, S_CF, S_RI, S_RF = 0, 1, 2, 3, 4, 5
S_PSI, S_PSF, S_BS, S_SL, S_SMI, S_SMF = 6, 7, 8, 9, 10, 11
S_HI, S_HF, S_TRI, S_TRF, S_DCI, S_DCF = 12, 13, 14, 15, 16, 17
S_PRI, S_PRF, S_ACT, S_Q, S_RWI, S_RWF = 18, 19, 20, 21, 22, 23
S_NEWC, S_CAND, S_CREM, S_NP, S_BT = 24, 25, 26, 27, 28
S_SRCI, S_SRCF = 29, 30
S_LEN = 31


def _identity(fn):
    return fn


_jit = _identity
NUMBA_AVAILABLE = False
if os.environ.get("REPRO_NO_NUMBA", "") != "1":   # pragma: no cover
    try:
        import numba

        _jit = numba.njit(cache=True)
        NUMBA_AVAILABLE = True
    except ImportError:
        pass


# ------------------------------------------------------------------- heap
@_jit
def _heap_lt(hi, hf, i, j):
    ti = hf[i, HF_TIME]
    tj = hf[j, HF_TIME]
    if ti != tj:
        return ti < tj
    ki = hi[i, HI_KIND]
    kj = hi[j, HI_KIND]
    if ki != kj:
        return ki < kj
    return hi[i, HI_SEQ] < hi[j, HI_SEQ]


@_jit
def _lt_item(t, kind, seq, hi, hf, j):
    tj = hf[j, HF_TIME]
    if t != tj:
        return t < tj
    kj = hi[j, HI_KIND]
    if kind != kj:
        return kind < kj
    return seq < hi[j, HI_SEQ]


@_jit
def _copy_row(hi, hf, dst, src):
    hi[dst, 0] = hi[src, 0]
    hi[dst, 1] = hi[src, 1]
    hi[dst, 2] = hi[src, 2]
    hi[dst, 3] = hi[src, 3]
    hi[dst, 4] = hi[src, 4]
    hf[dst, 0] = hf[src, 0]
    hf[dst, 1] = hf[src, 1]


@_jit
def _heap_push(si, hi, hf, t, kind, seq, a, b, c, start):
    # CPython heapq.heappush: append then _siftdown(0, len-1) holding the
    # new item out of the array until its final position is known.
    pos = si[SI_HEAP_LEN]
    si[SI_HEAP_LEN] = pos + 1
    while pos > 0:
        parent = (pos - 1) >> 1
        if _lt_item(t, kind, seq, hi, hf, parent):
            _copy_row(hi, hf, pos, parent)
            pos = parent
        else:
            break
    hi[pos, HI_KIND] = kind
    hi[pos, HI_SEQ] = seq
    hi[pos, HI_A] = a
    hi[pos, HI_B] = b
    hi[pos, HI_C] = c
    hf[pos, HF_TIME] = t
    hf[pos, HF_START] = start


@_jit
def _heap_pop(si, hi, hf):
    # CPython heapq.heappop: take the last item, move the root out, then
    # _siftup(0) — unconditional child promotion down to a leaf followed
    # by a _siftdown — so the post-pop ARRAY LAYOUT matches list-based
    # heapq exactly (the truncation scan and the heap scatter rely on it).
    n = si[SI_HEAP_LEN] - 1
    si[SI_HEAP_LEN] = n
    lt = hf[n, HF_TIME]
    lk = hi[n, HI_KIND]
    ls = hi[n, HI_SEQ]
    la = hi[n, HI_A]
    lb = hi[n, HI_B]
    lc = hi[n, HI_C]
    lst = hf[n, HF_START]
    if n == 0:
        return lt, lk, ls, la, lb, lc, lst
    rt = hf[0, HF_TIME]
    rk = hi[0, HI_KIND]
    rs = hi[0, HI_SEQ]
    ra = hi[0, HI_A]
    rb = hi[0, HI_B]
    rc = hi[0, HI_C]
    rst = hf[0, HF_START]
    pos = 0
    childpos = 1
    while childpos < n:
        rightpos = childpos + 1
        if rightpos < n and not _heap_lt(hi, hf, childpos, rightpos):
            childpos = rightpos
        _copy_row(hi, hf, pos, childpos)
        pos = childpos
        childpos = 2 * pos + 1
    while pos > 0:
        parent = (pos - 1) >> 1
        if _lt_item(lt, lk, ls, hi, hf, parent):
            _copy_row(hi, hf, pos, parent)
            pos = parent
        else:
            break
    hi[pos, HI_KIND] = lk
    hi[pos, HI_SEQ] = ls
    hi[pos, HI_A] = la
    hi[pos, HI_B] = lb
    hi[pos, HI_C] = lc
    hf[pos, HF_TIME] = lt
    hf[pos, HF_START] = lst
    return rt, rk, rs, ra, rb, rc, rst


# ----------------------------------------------------- machine primitives
@_jit
def _refresh_active(S):
    """Rebuild the active list (launched, unfinished, arrival order)."""
    si = S[0]
    ci = S[2]
    ri = S[4]
    rf = S[5]
    act = S[20]
    if si[SI_ACTIVE_DIRTY] == 0:
        return
    n = 0
    for r in range(ci[CI_NRUNS]):
        if ri[r, RI_LAUNCHED] != 0 and rf[r, RF_FIN] != rf[r, RF_FIN]:
            act[n] = r
            n += 1
    si[SI_ACTIVE_N] = n
    si[SI_ACTIVE_DIRTY] = 0


@_jit
def _pol_residency_cap(S, r):
    """policy.residency_cap(key, sm) for the uniform built-in policies."""
    ci = S[2]
    ri = S[4]
    pol = ci[CI_POLICY]
    if pol == POL_FIFO_CAP:
        return ci[CI_FIXED_CAP]
    if pol == POL_MPMAX:
        cap = ri[r, RI_MPCAP]
        if cap >= 0:
            return cap
        return ri[r, RI_MAXR]
    if pol == POL_SRTF_ADAPTIVE:
        si = S[0]
        cap = ri[r, RI_ADPCAP]
        if si[SI_SHARING] != 0 and cap >= 0:
            return cap
        return ri[r, RI_MAXR]
    return ri[r, RI_MAXR]


@_jit
def _can_fit(S, r, sm):
    ci = S[2]
    ri = S[4]
    rf = S[5]
    psi = S[6]
    smi = S[10]
    smf = S[11]
    if ri[r, RI_NUMB] - ri[r, RI_ISSUED] <= 0:
        return False
    cap = ri[r, RI_MAXR]
    if ci[CI_UNLIMITED] == 0:
        pcap = _pol_residency_cap(S, r)
        if pcap < cap:
            cap = pcap
    if psi[r, sm, PI_RES] >= cap:
        return False
    if smi[sm, SMI_FREETOP] <= 0:
        return False
    if smi[sm, SMI_THR] + ri[r, RI_TPB] > MAX_THREADS_PER_SM:
        return False
    return smf[sm, SMF_FRAC] + rf[r, RF_FRAC] <= 1.0 + _EPS


# ----------------------------------------------------- predictor queries
@_jit
def _pred_remaining(S, r, sm):
    """predictor.remaining(key, sm); NaN stands in for None."""
    ri = S[4]
    psi = S[6]
    psf = S[7]
    if ri[r, RI_PKNOWN] == 0:
        return math.nan
    t = psf[r, sm, PF_PT]
    if t != t:
        return math.nan
    rb = ri[r, RI_EXPECTED] - psi[r, sm, PI_PDONE]
    if rb < 0:
        rb = 0
    res = psi[r, sm, PI_PRESID]
    if res <= 1:
        res = 1
    return (rb / res) * t


@_jit
def _gpu_remaining(S, r):
    """predictor.gpu_remaining(key): mean over SMs with a sample (NaN=None).

    The reference memoizes this per state version; the query is pure, so
    recomputing it here is bit-identical (same left-fold sum order).
    """
    ci = S[2]
    ri = S[4]
    psi = S[6]
    psf = S[7]
    if ri[r, RI_PKNOWN] == 0:
        return math.nan
    total = 0.0
    count = 0
    for sm in range(ci[CI_NSM]):
        t = psf[r, sm, PF_PT]
        if t != t:
            continue
        rb = ri[r, RI_EXPECTED] - psi[r, sm, PI_PDONE]
        if rb < 0:
            rb = 0
        res = psi[r, sm, PI_PRESID]
        if res <= 1:
            res = 1
        total = total + (rb / res) * t
        count += 1
    if count == 0:
        return math.nan
    return total / count


@_jit
def _gpu_predicted_total(S, r, now):
    """predictor.gpu_predicted_total(key, now) (NaN = None)."""
    ci = S[2]
    ri = S[4]
    psi = S[6]
    psf = S[7]
    if ri[r, RI_PKNOWN] == 0:
        return math.nan
    total = 0.0
    count = 0
    for sm in range(ci[CI_NSM]):
        t = psf[r, sm, PF_PT]
        if t != t:
            continue
        rb = ri[r, RI_EXPECTED] - psi[r, sm, PI_PDONE]
        if rb < 0:
            rb = 0
        res = psi[r, sm, PI_PRESID]
        if res <= 1:
            res = 1
        remaining = (rb / res) * t
        active = psf[r, sm, PF_PACT]
        if psi[r, sm, PI_PRUN] > 0:
            active = active + (now - psf[r, sm, PF_PSINCE])
        total = total + (active + remaining)
        count += 1
    if count == 0:
        return math.nan
    return total / count


# --------------------------------------------------- predictor handlers
@_jit
def _observe(S, r, sm, duration):
    """Predictor._observe — SS resamples at slice starts, EWMA blends."""
    ci = S[2]
    cf = S[3]
    psi = S[6]
    psf = S[7]
    if ci[CI_PRED_KIND] == 1:
        psi[r, sm, PI_PRESLICE] = 0
        if duration != duration:
            return
        t = psf[r, sm, PF_PT]
        if t != t:
            psf[r, sm, PF_PT] = duration
        else:
            alpha = cf[CF_ALPHA]
            psf[r, sm, PF_PT] = alpha * duration + (1.0 - alpha) * t
    else:
        if psi[r, sm, PI_PRESLICE] != 0 or psf[r, sm, PF_PT] != psf[r, sm, PF_PT]:
            if duration == duration:
                psf[r, sm, PF_PT] = duration
            psi[r, sm, PI_PRESLICE] = 0


@_jit
def _pred_on_launch(S, r):
    """SimpleSlicingPredictor.on_launch: fresh per-SM rows + reslice others."""
    ci = S[2]
    ri = S[4]
    psi = S[6]
    psf = S[7]
    bs = S[8]
    nsm = ci[CI_NSM]
    residency = ri[r, RI_MAXR]
    if residency < 1:
        residency = 1
    for sm in range(nsm):
        psi[r, sm, PI_PDONE] = 0
        psi[r, sm, PI_PRESID] = residency
        psi[r, sm, PI_PRESLICE] = 1
        psi[r, sm, PI_PRUN] = 0
        psf[r, sm, PF_PT] = math.nan
        psf[r, sm, PF_PACT] = 0.0
        psf[r, sm, PF_PSINCE] = 0.0
        for slot in range(MAX_BLOCK_SLOTS):
            bs[r, sm, slot] = math.nan
    ri[r, RI_PKNOWN] = 1
    for other in range(ci[CI_NRUNS]):
        if other == r or ri[other, RI_PKNOWN] == 0:
            continue
        for sm in range(nsm):
            psi[other, sm, PI_PRESLICE] = 1


@_jit
def _pred_on_kernel_end(S, r):
    ci = S[2]
    ri = S[4]
    psi = S[6]
    for other in range(ci[CI_NRUNS]):
        if other == r or ri[other, RI_PKNOWN] == 0:
            continue
        for sm in range(ci[CI_NSM]):
            psi[other, sm, PI_PRESLICE] = 1


@_jit
def _pred_on_block_start(S, r, sm, slot, now):
    psi = S[6]
    psf = S[7]
    bs = S[8]
    bs[r, sm, slot] = now
    if psi[r, sm, PI_PRUN] == 0:
        psf[r, sm, PF_PSINCE] = now
    psi[r, sm, PI_PRUN] += 1


@_jit
def _pred_on_block_end(S, r, sm, slot, now):
    """SimpleSlicingPredictor.on_block_end + Eq. 2 (NaN = None)."""
    ci = S[2]
    ri = S[4]
    psi = S[6]
    psf = S[7]
    bs = S[8]
    psi[r, sm, PI_PDONE] += 1
    start = bs[r, sm, slot]
    bs[r, sm, slot] = math.nan
    if (psi[r, sm, PI_PRESLICE] != 0
            or psf[r, sm, PF_PT] != psf[r, sm, PF_PT]
            or ci[CI_PRED_KIND] == 1):
        if start != start:
            _observe(S, r, sm, math.nan)
        else:
            _observe(S, r, sm, now - start)
    rc = psi[r, sm, PI_PRUN] - 1
    psi[r, sm, PI_PRUN] = rc if rc > 0 else 0
    if rc <= 0:
        psf[r, sm, PF_PACT] = psf[r, sm, PF_PACT] + (now - psf[r, sm, PF_PSINCE])
    t = psf[r, sm, PF_PT]
    if t != t:
        return math.nan
    rb = ri[r, RI_EXPECTED] - psi[r, sm, PI_PDONE]
    if rb < 0:
        rb = 0
    res = psi[r, sm, PI_PRESID]
    if res <= 1:
        res = 1
    remaining = (rb / res) * t
    active = psf[r, sm, PF_PACT]
    if psi[r, sm, PI_PRUN] > 0:
        active = active + (now - psf[r, sm, PF_PSINCE])
    return active + remaining


@_jit
def _pred_on_residency_change(S, r, sm, new_residency):
    psi = S[6]
    if new_residency < 1:
        new_residency = 1
    if psi[r, sm, PI_PRESID] != new_residency:
        psi[r, sm, PI_PRESID] = new_residency
        psi[r, sm, PI_PRESLICE] = 1


@_jit
def _broadcast_t(S, r, t, from_sm):
    ci = S[2]
    psi = S[6]
    psf = S[7]
    for sm in range(ci[CI_NSM]):
        if sm == from_sm:
            continue
        if psf[r, sm, PF_PT] != psf[r, sm, PF_PT]:
            psf[r, sm, PF_PT] = t
            psi[r, sm, PI_PRESLICE] = 0


@_jit
def _sync_residency_caps(S):
    """MachineBase.sync_residency_caps, fast/uniform delta branch."""
    si = S[0]
    ci = S[2]
    ri = S[4]
    act = S[20]
    _refresh_active(S)
    for i in range(si[SI_ACTIVE_N]):
        r = act[i]
        if ri[r, RI_PKNOWN] == 0:
            continue
        cap = ri[r, RI_MAXR]
        if ci[CI_UNLIMITED] == 0:
            pcap = _pol_residency_cap(S, r)
            if pcap < cap:
                cap = pcap
        if ri[r, RI_SYNCED] == cap:
            continue
        for sm in range(ci[CI_NSM]):
            _pred_on_residency_change(S, r, sm, cap)
        ri[r, RI_SYNCED] = cap


# ------------------------------------------------------------ policy layer
@_jit
def _mpmax_recompute(S):
    """MPMax._recompute: fresh caps over the active set (arrival order)."""
    si = S[0]
    ci = S[2]
    ri = S[4]
    rf = S[5]
    act = S[20]
    _refresh_active(S)
    for r in range(ci[CI_NRUNS]):
        ri[r, RI_MPCAP] = -1
    n = si[SI_ACTIVE_N]
    for i in range(n):
        r = act[i]
        reserved = 0.0
        for j in range(n):
            other = act[j]
            if other != r:
                reserved = reserved + rf[other, RF_FRAC]
        cap = int(math.floor(ri[r, RI_MAXR] * (1.0 - reserved)))
        if cap < 1:
            cap = 1
        ri[r, RI_MPCAP] = cap


@_jit
def _start_next_sample(S):
    """SRTF._start_next_sample: pop the queue to the next sampling kernel."""
    si = S[0]
    ri = S[4]
    rf = S[5]
    q = S[21]
    while si[SI_SAMPLING] < 0 and si[SI_QHEAD] < si[SI_QTAIL]:
        r = q[si[SI_QHEAD]]
        si[SI_QHEAD] += 1
        if ri[r, RI_ELIG] != 0:
            continue
        if rf[r, RF_FIN] == rf[r, RF_FIN]:   # run.finished
            continue
        si[SI_SAMPLING] = r


@_jit
def _queue_remove(S, r):
    """deque.remove(key): drop the first occurrence, shift the tail left."""
    si = S[0]
    q = S[21]
    head = si[SI_QHEAD]
    tail = si[SI_QTAIL]
    for i in range(head, tail):
        if q[i] == r:
            for j in range(i, tail - 1):
                q[j] = q[j + 1]
            si[SI_QTAIL] = tail - 1
            return


@_jit
def _srtf_remaining(S, r, sm):
    """SRTF._remaining (base) / SRTFZeroSampling._remaining override."""
    ci = S[2]
    ri = S[4]
    rf = S[5]
    if ci[CI_POLICY] == POL_SRTF_ZERO:
        rt = rf[r, RF_ORACLE]
        if rt == rt:
            numb = ri[r, RI_NUMB]
            if numb < 1:
                numb = 1
            frac_left = 1.0 - ri[r, RI_DONE] / numb
            return rt * frac_left
    rem = _pred_remaining(S, r, sm)
    if rem == rem:
        return rem
    rem = _gpu_remaining(S, r)
    if rem == rem:
        return rem
    return _INF


@_jit
def _best_candidate(S, sm):
    """SRTF._best_candidate: census first, then a min scan on
    (remaining, order) — order IS the active-array position's run index
    ordering, and run indices are arrival-ordered."""
    si = S[0]
    ri = S[4]
    act = S[20]
    _refresh_active(S)
    n = si[SI_ACTIVE_N]
    sole = -1
    count = 0
    for i in range(n):
        r = act[i]
        if ri[r, RI_ELIG] == 0:
            continue
        if ri[r, RI_NUMB] > ri[r, RI_ISSUED]:
            count += 1
            if count > 1:
                break
            sole = r
    if count == 0:
        return -1
    if count == 1:
        return sole
    best = -1
    best_rem = 0.0
    for i in range(n):
        r = act[i]
        if ri[r, RI_ELIG] == 0:
            continue
        if ri[r, RI_NUMB] <= ri[r, RI_ISSUED]:
            continue
        rem = _srtf_remaining(S, r, sm)
        # run order is monotone in r, so "rem == best and order < best"
        # can never fire on a later r: strict < suffices.
        if best < 0 or rem < best_rem:
            best = r
            best_rem = rem
    return best


@_jit
def _adaptive_candidates(S, sm):
    """SRTFAdaptive sharing-mode candidate list: eligible actives with
    unissued blocks, stably sorted by predicted remaining time."""
    si = S[0]
    ri = S[4]
    act = S[20]
    cand = S[25]
    crem = S[26]
    _refresh_active(S)
    m = 0
    for i in range(si[SI_ACTIVE_N]):
        r = act[i]
        if ri[r, RI_ELIG] != 0 and ri[r, RI_NUMB] > ri[r, RI_ISSUED]:
            cand[m] = r
            crem[m] = _srtf_remaining(S, r, sm)
            m += 1
    # Stable insertion sort by remaining time == sorted(key=(rem, order))
    # because the gather order above is already the order tie-break.
    for i in range(1, m):
        kr = cand[i]
        kv = crem[i]
        j = i - 1
        while j >= 0 and crem[j] > kv:
            cand[j + 1] = cand[j]
            crem[j + 1] = crem[j]
            j -= 1
        cand[j + 1] = kr
        crem[j + 1] = kv
    return m


@_jit
def _adaptive_loser_cap(S, r, winner):
    """SRTFAdaptive._loser_cap(spec, winner_spec)."""
    ci = S[2]
    ri = S[4]
    rf = S[5]
    shared_w = ci[CI_SHARED_RES]
    wmax = ri[winner, RI_MAXR]
    if wmax < shared_w:
        shared_w = wmax
    free_frac = 1.0 - shared_w * rf[winner, RF_FRAC]
    cap = int(math.floor(free_frac * ri[r, RI_MAXR]))
    if cap < 1:
        cap = 1
    return cap


@_jit
def _adaptive_cap_now(S, r):
    """SRTFAdaptive._cap_now: the stored cap regardless of sharing flag."""
    ri = S[4]
    cap = ri[r, RI_ADPCAP]
    if cap >= 0:
        return cap
    return ri[r, RI_MAXR]


@_jit
def _adaptive_reevaluate(S, now):
    """SRTFAdaptive._reevaluate: fairness projections + cap updates."""
    si = S[0]
    ci = S[2]
    cf = S[3]
    ri = S[4]
    rf = S[5]
    act = S[20]
    rwi = S[22]
    rwf = S[23]
    newc = S[24]
    _refresh_active(S)
    sharing = si[SI_SHARING] != 0
    if not sharing and si[SI_ACTIVE_N] < 2:
        return
    # _predictions(): rows over active-and-eligible kernels, or None.
    nrows = 0
    ok = True
    for i in range(si[SI_ACTIVE_N]):
        r = act[i]
        if ri[r, RI_ELIG] == 0:
            continue
        rwi[nrows] = r
        nrows += 1
    if nrows < 2:
        ok = False
    if ok:
        for i in range(nrows):
            r = rwi[i]
            rem = _gpu_remaining(S, r)
            if rem != rem:
                ok = False
                break
            solo = rf[r, RF_EXCL]
            if solo != solo:
                solo = _gpu_predicted_total(S, r, now)
            if solo != solo or solo <= 0.0:
                ok = False
                break
            rwf[i, RW_REM] = rem
            rwf[i, RW_ELAPSED] = now - rf[r, RF_ARRT]
            rwf[i, RW_SOLO] = solo
    if not ok:
        if sharing:
            si[SI_SHARING] = 0
            for r in range(ci[CI_NRUNS]):
                ri[r, RI_ADPCAP] = -1
            _sync_residency_caps(S)
        return
    # rows.sort(key=remaining) — stable insertion sort (gather order is
    # the arrival order, so ties keep it, exactly like list.sort).
    for i in range(1, nrows):
        kr = rwi[i]
        v0 = rwf[i, RW_REM]
        v1 = rwf[i, RW_ELAPSED]
        v2 = rwf[i, RW_SOLO]
        j = i - 1
        while j >= 0 and rwf[j, RW_REM] > v0:
            rwi[j + 1] = rwi[j]
            rwf[j + 1, RW_REM] = rwf[j, RW_REM]
            rwf[j + 1, RW_ELAPSED] = rwf[j, RW_ELAPSED]
            rwf[j + 1, RW_SOLO] = rwf[j, RW_SOLO]
            j -= 1
        rwi[j + 1] = kr
        rwf[j + 1, RW_REM] = v0
        rwf[j + 1, RW_ELAPSED] = v1
        rwf[j + 1, RW_SOLO] = v2
    # _project_exclusive: cumulative hand-off, gap tracked on the fly
    # (max(list) - min(list) is comparison-only, so no FP difference).
    acc = 0.0
    ex_max = 0.0
    ex_min = 0.0
    for i in range(nrows):
        acc = acc + rwf[i, RW_REM]
        s = (rwf[i, RW_ELAPSED] + acc) / rwf[i, RW_SOLO]
        if i == 0:
            ex_max = s
            ex_min = s
        else:
            if s > ex_max:
                ex_max = s
            if s < ex_min:
                ex_min = s
    gap_excl = ex_max - ex_min
    # _project_sharing.
    winner = rwi[0]
    w_cap_now = _adaptive_cap_now(S, winner)
    wmax = ri[winner, RI_MAXR]
    cur_cap = w_cap_now if w_cap_now < wmax else wmax
    if cur_cap < 1:
        cur_cap = 1
    shared_w = ci[CI_SHARED_RES]
    if wmax < shared_w:
        shared_w = wmax
    ts1 = rwf[0, RW_REM] * cur_cap / shared_w
    s0 = (rwf[0, RW_ELAPSED] + ts1) / rwf[0, RW_SOLO]
    sh_max = s0
    sh_min = s0
    for i in range(1, nrows):
        r = rwi[i]
        full = ri[r, RI_MAXR]
        shared_cap = _adaptive_loser_cap(S, r, winner)
        cur = _adaptive_cap_now(S, r)
        if cur > full:
            cur = full
        if cur < 1:
            cur = 1
        s_l = rwf[i, RW_REM] * cur / shared_cap
        if s_l <= ts1:
            s = (rwf[i, RW_ELAPSED] + s_l) / rwf[i, RW_SOLO]
        else:
            tail = (s_l - ts1) * shared_cap / full
            s = (rwf[i, RW_ELAPSED] + ts1 + tail) / rwf[i, RW_SOLO]
        if s > sh_max:
            sh_max = s
        if s < sh_min:
            sh_min = s
    gap_shared = sh_max - sh_min
    want = (gap_excl > cf[CF_THRESHOLD]
            and gap_shared < gap_excl - cf[CF_HYSTERESIS])
    # new_caps and the dict-inequality test against the current caps.
    if want:
        for i in range(nrows):
            r = rwi[i]
            if r == winner:
                cap = ci[CI_SHARED_RES]
                if ri[r, RI_MAXR] < cap:
                    cap = ri[r, RI_MAXR]
            else:
                cap = _adaptive_loser_cap(S, r, winner)
            newc[i] = cap
    changed = want != sharing
    if not changed:
        old_n = 0
        for r in range(ci[CI_NRUNS]):
            if ri[r, RI_ADPCAP] >= 0:
                old_n += 1
        if want:
            if old_n != nrows:
                changed = True
            else:
                for i in range(nrows):
                    if ri[rwi[i], RI_ADPCAP] != newc[i]:
                        changed = True
                        break
        else:
            changed = old_n != 0
    if changed:
        si[SI_SHARING] = 1 if want else 0
        for r in range(ci[CI_NRUNS]):
            ri[r, RI_ADPCAP] = -1
        if want:
            for i in range(nrows):
                ri[rwi[i], RI_ADPCAP] = newc[i]
        _sync_residency_caps(S)


@_jit
def _decide(S, sm):
    """Policy.decide(sm) → (decision code, kernel index or -1).

    Pure function of scheduler state, mirroring each policy's decide
    method branch for branch.  The engine always asks (no min-footprint
    precheck, no era memo): decisions are side-effect-free and
    era-stable, so the reference's skipped/memoized asks return exactly
    what a fresh ask would — the recorded decision log is identical.
    """
    si = S[0]
    ci = S[2]
    ri = S[4]
    rf = S[5]
    act = S[20]
    cand = S[25]
    pol = ci[CI_POLICY]
    if pol == POL_FIFO or pol == POL_FIFO_CAP:
        _refresh_active(S)
        for i in range(si[SI_ACTIVE_N]):
            r = act[i]
            if ri[r, RI_NUMB] > ri[r, RI_ISSUED]:
                if _can_fit(S, r, sm):
                    return DEC_GRANT, r
                return DEC_HOLD_HEAD, -1
        return DEC_HOLD_NO_UNDISP, -1
    if pol == POL_SJF or pol == POL_LJF:
        # Head-of-line over the (sign * runtime, order) sorted actives ==
        # min over actives WITH undispatched blocks (exhausted kernels
        # are skipped by the reference walk; run index == arrival order,
        # so scanning r ascending makes strict < the whole tie-break).
        _refresh_active(S)
        best = -1
        best_key = 0.0
        for i in range(si[SI_ACTIVE_N]):
            r = act[i]
            if ri[r, RI_NUMB] <= ri[r, RI_ISSUED]:
                continue
            k = rf[r, RF_SJFKEY]
            if best < 0 or k < best_key:
                best = r
                best_key = k
        if best < 0:
            return DEC_HOLD_NO_UNDISP, -1
        if _can_fit(S, best, sm):
            return DEC_GRANT, best
        return DEC_HOLD_HEAD, -1
    if pol == POL_MPMAX:
        _refresh_active(S)
        for i in range(si[SI_ACTIVE_N]):
            r = act[i]
            if ri[r, RI_NUMB] > ri[r, RI_ISSUED] and _can_fit(S, r, sm):
                return DEC_GRANT, r
        return DEC_HOLD_MPMAX, -1
    # SRTF family.
    if pol == POL_SRTF_ADAPTIVE and si[SI_SHARING] != 0:
        if si[SI_SAMPLING] >= 0 and sm == ci[CI_SAMPLE_SM]:
            k = si[SI_SAMPLING]
            if ri[k, RI_NUMB] > ri[k, RI_ISSUED] and _can_fit(S, k, sm):
                return DEC_SAMPLE, k
            return DEC_HOLD_SAMPLING, -1
        m = _adaptive_candidates(S, sm)
        for i in range(m):
            if _can_fit(S, cand[i], sm):
                return DEC_GRANT, cand[i]
        return DEC_HOLD_ADAPTIVE, -1
    if si[SI_SAMPLING] >= 0 and sm == ci[CI_SAMPLE_SM]:
        k = si[SI_SAMPLING]
        if ri[k, RI_NUMB] > ri[k, RI_ISSUED] and _can_fit(S, k, sm):
            return DEC_SAMPLE, k
        return DEC_HOLD_SAMPLING, -1
    k = _best_candidate(S, sm)
    if k < 0:
        return DEC_HOLD_NO_ELIG, -1
    if _can_fit(S, k, sm):
        return DEC_GRANT, k
    # Exclusive execution: no backfilling behind the SRTF winner.
    return DEC_PREEMPT, k


@_jit
def _pol_on_arrival(S, r, now):
    si = S[0]
    ci = S[2]
    ri = S[4]
    q = S[21]
    pol = ci[CI_POLICY]
    if pol == POL_MPMAX:
        _mpmax_recompute(S)
        return
    if pol == POL_SRTF_ZERO:
        ri[r, RI_ELIG] = 1          # no sampling phase
        return
    if pol == POL_SRTF or pol == POL_SRTF_ADAPTIVE:
        _refresh_active(S)
        if si[SI_ACTIVE_N] == 1:
            # Arrived on an idle machine: runs immediately.
            ri[r, RI_ELIG] = 1
        else:
            q[si[SI_QTAIL]] = r
            si[SI_QTAIL] += 1
            _start_next_sample(S)
        if pol == POL_SRTF_ADAPTIVE:
            _adaptive_reevaluate(S, now)


@_jit
def _pol_on_block_end(S, r, sm, now):
    si = S[0]
    ci = S[2]
    ri = S[4]
    rf = S[5]
    psf = S[7]
    pol = ci[CI_POLICY]
    if pol < POL_SRTF:
        return
    # SRTF.on_block_end: the sampling SM finishing a sampled block
    # promotes the sampled kernel to eligible.
    if r == si[SI_SAMPLING] and sm == ci[CI_SAMPLE_SM]:
        t = psf[r, sm, PF_PT]       # predictor.sampled_t(key, sm)
        if t == t:
            _broadcast_t(S, r, t, sm)
            ri[r, RI_ELIG] = 1
            si[SI_SAMPLING] = -1
            _start_next_sample(S)
    if pol == POL_SRTF_ADAPTIVE:
        if si[SI_SHARING] == 0:
            _refresh_active(S)
            if (si[SI_ACTIVE_N] > 1 or si[SI_PENDING] > 0
                    or ci[CI_HAS_SOURCE] != 0):
                pred = _gpu_predicted_total(S, r, now)
                if pred == pred:
                    rf[r, RF_EXCL] = pred
        _adaptive_reevaluate(S, now)


@_jit
def _pol_on_kernel_end(S, r, now):
    si = S[0]
    ci = S[2]
    ri = S[4]
    rf = S[5]
    act = S[20]
    pol = ci[CI_POLICY]
    if pol == POL_MPMAX:
        _mpmax_recompute(S)
        return
    if pol < POL_SRTF:
        return
    ri[r, RI_ELIG] = 0
    if si[SI_SAMPLING] == r:
        si[SI_SAMPLING] = -1
    _queue_remove(S, r)
    _start_next_sample(S)
    # If only one kernel remains un-predicted, it no longer needs a
    # sample to be scheduled.
    _refresh_active(S)
    if si[SI_ACTIVE_N] == 1:
        ri[act[0], RI_ELIG] = 1
    if pol == POL_SRTF_ADAPTIVE:
        rf[r, RF_EXCL] = _NAN
        _adaptive_reevaluate(S, now)


# ------------------------------------------------------------- issue loop
@_jit
def _finalize_block(S, r, sm, slot, noise_idx, first_wave, now):
    """Simulator._finalize_block: duration at post-batch SM conditions."""
    si = S[0]
    ci = S[2]
    ri = S[4]
    rf = S[5]
    psi = S[6]
    act = S[20]
    hi = S[12]
    hf = S[13]
    tri = S[14]
    trf = S[15]
    np_pool = S[27]
    bt_pool = S[28]
    residency = psi[r, sm, PI_RES]
    # Co-runner pressure summed in arrival order over resident kernels.
    corunner_warps = 0.0
    _refresh_active(S)
    for i in range(si[SI_ACTIVE_N]):
        other = act[i]
        if other == r:
            continue
        cnt = psi[other, sm, PI_RES]
        if cnt != 0:
            corunner_warps = corunner_warps + (
                (rf[other, RF_CPRESS] * cnt) * ri[other, RI_WARPS])
    maxr = ri[r, RI_MAXR]
    idx = residency if residency < maxr else maxr
    t = bt_pool[ri[r, RI_BT_OFF] + idx]
    if corunner_warps > 0.0:
        t = t * (1.0 + rf[r, RF_CSENS] * (corunner_warps
                                          / MAX_WARPS_PER_SM))
    if first_wave != 0 and rf[r, RF_STARTUP] > 0.0:
        t = t * (1.0 + rf[r, RF_STARTUP])
    base = t if t > 1.0 else 1.0    # max(t, 1.0)
    duration = base * np_pool[ri[r, RI_NOISE_OFF] + noise_idx]
    if ci[CI_DRIVE_PRED] != 0:
        _pred_on_block_start(S, r, sm, slot, now)
    end = now + duration
    seq = si[SI_SEQ]
    si[SI_SEQ] = seq + 1
    _heap_push(si, hi, hf, end, EV_BLOCK_END, seq, r, sm, slot, now)
    if ci[CI_REC_TRACE] != 0:
        n = si[SI_TRACE_N]
        tri[n, 0] = r
        tri[n, 1] = sm
        tri[n, 2] = slot
        trf[n, 0] = now
        trf[n, 1] = end
        si[SI_TRACE_N] = n + 1


@_jit
def _try_issue(S, sm, now):
    """Simulator._try_issue: batch-grant, then finalize at post-batch
    residency.  The batch is bounded by MAX_BLOCK_SLOTS (every grant
    consumes a slot and grants require a free slot)."""
    si = S[0]
    ci = S[2]
    ri = S[4]
    rf = S[5]
    psi = S[6]
    psf = S[7]
    sl = S[9]
    smi_a = S[10]
    smf = S[11]
    hi = S[12]
    hf = S[13]
    dci = S[16]
    dcf = S[17]
    batch = np.empty((MAX_BLOCK_SLOTS, 4), np.int64)
    nb = 0
    while True:
        code, r = _decide(S, sm)
        if ci[CI_REC_DEC] != 0:
            n = si[SI_DEC_N]
            dci[n, 0] = sm
            dci[n, 1] = code
            dci[n, 2] = r
            dcf[n, 0] = now
            si[SI_DEC_N] = n + 1
        if code > DEC_SAMPLE:
            break
        gate = psf[r, sm, PF_GATE]
        if gate > now + _EPS:
            seq = si[SI_SEQ]
            si[SI_SEQ] = seq + 1
            _heap_push(si, hi, hf, gate, EV_TRY_ISSUE, seq, sm, 0, 0, 0.0)
            break
        # --- allocate (inlined, mirrors the reference field for field) --
        top = smi_a[sm, SMI_FREETOP] - 1
        smi_a[sm, SMI_FREETOP] = top
        slot = smi_a[sm, SMI_FS0 + top]
        sl[sm, slot] = r
        smi_a[sm, SMI_THR] = smi_a[sm, SMI_THR] + ri[r, RI_TPB]
        smf[sm, SMF_FRAC] = smf[sm, SMF_FRAC] + rf[r, RF_FRAC]
        psi[r, sm, PI_RES] += 1
        issued_on_sm = psi[r, sm, PI_ISSD]
        psi[r, sm, PI_ISSD] = issued_on_sm + 1
        if rf[r, RF_FIRST] != rf[r, RF_FIRST]:
            rf[r, RF_FIRST] = now
        first_wave = 1 if issued_on_sm < ri[r, RI_MAXR] else 0
        noise_idx = ri[r, RI_ISSUED]
        ri[r, RI_ISSUED] = noise_idx + 1
        if first_wave != 0 and psi[r, sm, PI_STAG] != 0:
            psf[r, sm, PF_GATE] = now + rf[r, RF_STAGF] * rf[r, RF_MEANT]
        batch[nb, 0] = r
        batch[nb, 1] = slot
        batch[nb, 2] = noise_idx
        batch[nb, 3] = first_wave
        nb += 1
    for i in range(nb):
        _finalize_block(S, batch[i, 0], sm, batch[i, 1], batch[i, 2],
                        batch[i, 3], now)


@_jit
def _fan_out(S, now):
    """Machine-wide issue opportunity (arrival / kernel end)."""
    ci = S[2]
    for sm in range(ci[CI_NSM]):
        _try_issue(S, sm, now)


@_jit
def _src_inject(S, r2, t, now):
    """Inject one staged arrival: the in-engine twin of
    Simulator.inject_arrival (clip to now, push EV_ARRIVAL, invalidate)."""
    si = S[0]
    ri = S[4]
    rf = S[5]
    hi = S[12]
    hf = S[13]
    if t < now:
        t = now
    ri[r2, RI_STAGED] = 0
    rf[r2, RF_ARRT] = t
    si[SI_PENDING] += 1
    seq = si[SI_SEQ]
    si[SI_SEQ] = seq + 1
    _heap_push(si, hi, hf, t, EV_ARRIVAL, seq, r2, 0, 0, 0.0)
    si[SI_ACTIVE_DIRTY] = 1


@_jit
def _src_release_mgk(S, now):
    """Release staged offered arrivals while the population has room.

    Returns 7 when the staged window is exhausted but more offered
    arrivals exist (the driver restages and resumes), else 0."""
    srci = S[29]
    srcf = S[30]
    while srci[SRC_INSYS] < srci[SRC_POP]:
        k = srci[SRC_NEXT]
        if k >= srci[SRC_NSTAGED]:
            if srci[SRC_MORE] != 0:
                return 7
            return 0
        srci[SRC_NEXT] = k + 1
        srci[SRC_INSYS] += 1
        _src_inject(S, srci[SRC_BASE] + k, srcf[k], now)
    return 0


@_jit
def _src_feed_think(S, r, now):
    """Resubmit for the completed kernel's tenant (think-time twin).

    Returns 7 when a variate is needed but the staged pool is empty
    (the tenant is parked in SRC_PEND for the resume), else 0."""
    ri = S[4]
    srci = S[29]
    srcf = S[30]
    ten = ri[r, RI_TENANT]
    if ten < 0:
        return 0
    if srci[SRC_RD0 + ten] >= srci[SRC_NROUNDS]:
        return 0
    k = srci[SRC_NEXT]
    if k >= srci[SRC_NSTAGED]:
        srci[SRC_PEND] = ten
        return 7
    srci[SRC_NEXT] = k + 1
    srci[SRC_RD0 + ten] += 1
    r2 = srci[SRC_BASE] + k
    ri[r2, RI_TENANT] = ten
    _src_inject(S, r2, now + srcf[k], now)
    return 0


@_jit
def _src_on_completion(S, r, now):
    """In-engine ``_feed_completion`` for lowered arrival sources.

    Returns 0 (handled natively), 7 (variate pool exhausted) or 2 (the
    source is not lowered: python must mediate)."""
    ci = S[2]
    ri = S[4]
    srci = S[29]
    mode = ci[CI_SRC_MODE]
    if mode == SRCMODE_MGK:
        if ri[r, RI_SRC] == 0:
            return 0
        srci[SRC_INSYS] -= 1
        return _src_release_mgk(S, now)
    if mode == SRCMODE_THINK:
        return _src_feed_think(S, r, now)
    return 2


@_jit
def _src_resume(S, now):
    """Finish the injection interrupted by a pool-exhaustion exit.

    Runs on RESUME entry after the driver restaged a fresh window;
    returns 7 if the fresh pool is somehow still exhausted, else 0."""
    ci = S[2]
    ri = S[4]
    srci = S[29]
    srcf = S[30]
    mode = ci[CI_SRC_MODE]
    if mode == SRCMODE_MGK:
        return _src_release_mgk(S, now)
    if mode == SRCMODE_THINK:
        ten = srci[SRC_PEND]
        if ten < 0:
            return 0
        k = srci[SRC_NEXT]
        if k >= srci[SRC_NSTAGED]:
            return 7
        srci[SRC_PEND] = -1
        srci[SRC_NEXT] = k + 1
        srci[SRC_RD0 + ten] += 1
        r2 = srci[SRC_BASE] + k
        ri[r2, RI_TENANT] = ten
        _src_inject(S, r2, now + srcf[k], now)
    return 0


@_jit
def _handle_block_end(S, r, sm, slot, start, now):
    """Returns 2 or 7 when a kernel completion must hand control back to
    the driver (feed a python-mediated source / restage the variate
    pool), else -1."""
    si = S[0]
    sd = S[1]
    ci = S[2]
    ri = S[4]
    rf = S[5]
    psi = S[6]
    sl = S[9]
    smi_a = S[10]
    smf = S[11]
    pri = S[18]
    prf = S[19]
    frac = rf[r, RF_FRAC]
    sd[SD_BUSY] = sd[SD_BUSY] + (now - start) * frac
    # Inlined SMState.free (same clamps), fused event dispatch.
    sl[sm, slot] = -1
    top = smi_a[sm, SMI_FREETOP]
    smi_a[sm, SMI_FS0 + top] = slot
    smi_a[sm, SMI_FREETOP] = top + 1
    ut = smi_a[sm, SMI_THR] - ri[r, RI_TPB]
    smi_a[sm, SMI_THR] = ut if ut > 0 else 0
    uf = smf[sm, SMF_FRAC] - frac
    smf[sm, SMF_FRAC] = uf if uf > 0.0 else 0.0
    psi[r, sm, PI_RES] -= 1
    ri[r, RI_DONE] += 1
    pred = _NAN
    if ci[CI_DRIVE_PRED] != 0:
        pred = _pred_on_block_end(S, r, sm, slot, now)
        _pol_on_block_end(S, r, sm, now)
    else:
        _pol_on_block_end(S, r, sm, now)
    if ci[CI_REC_PRED] != 0 and pred == pred:
        n = si[SI_PRED_N]
        pri[n, 0] = r
        pri[n, 1] = sm
        pri[n, 2] = psi[r, sm, PI_PDONE]
        prf[n, 0] = now
        prf[n, 1] = pred
        si[SI_PRED_N] = n + 1
    if ri[r, RI_DONE] == ri[r, RI_NUMB]:
        rf[r, RF_FIN] = now
        # SchedulerCore.post(KernelEnded): invalidate, predictor hook,
        # policy hook, cap sync — all BEFORE the completion feed/fan-out.
        si[SI_ACTIVE_DIRTY] = 1
        ri[r, RI_SYNCED] = -1
        _pred_on_kernel_end(S, r)
        _pol_on_kernel_end(S, r, now)
        _sync_residency_caps(S)
        if ci[CI_HAS_SOURCE] != 0:
            # _feed_completion may inject arrivals: lowered sources are
            # fed in-engine (0 = done, 7 = pool exhausted); otherwise
            # hand control back to the driver, which feeds the source
            # and re-enters with RESUME set (the engine then runs the
            # pending _fan_out).
            si[SI_EXIT_RUN] = r
            rc = _src_on_completion(S, r, now)
            if rc != 0:
                return rc
        _fan_out(S, now)
    else:
        _try_issue(S, sm, now)
    return -1


@_jit
def _handle_arrival(S, r, now):
    si = S[0]
    ri = S[4]
    si[SI_PENDING] -= 1
    # SchedulerCore.post(KernelArrived): launch, invalidate, predictor
    # on_launch, policy on_arrival, cap sync — then the machine-wide
    # issue fan-out.
    ri[r, RI_LAUNCHED] = 1
    si[SI_ACTIVE_DIRTY] = 1
    _pred_on_launch(S, r)
    _pol_on_arrival(S, r, now)
    _sync_residency_caps(S)
    _fan_out(S, now)


@_jit
def advance(S):
    """Process events until an exit condition (module docstring table)."""
    si = S[0]
    sd = S[1]
    ci = S[2]
    rf = S[5]
    hi = S[12]
    hf = S[13]
    nsm = ci[CI_NSM]
    if si[SI_RESUME] != 0:
        si[SI_RESUME] = 0
        rc = _src_resume(S, sd[SD_NOW])
        if rc != 0:
            return rc
        _fan_out(S, sd[SD_NOW])
    while True:
        # Headroom checks BEFORE the pop: one event dispatch can fan out
        # over every SM (<= 8 grants + 1 gate retry each) and record one
        # prediction, so these margins guarantee the buffers never
        # overflow mid-dispatch.
        if si[SI_HEAP_LEN] + 9 * nsm + 8 + ci[CI_SRC_RESERVE] > ci[CI_HEAP_CAP]:
            return 3
        if (ci[CI_REC_TRACE] != 0
                and si[SI_TRACE_N] + 8 * nsm + 8 > ci[CI_TRACE_CAP]):
            return 4
        if (ci[CI_REC_DEC] != 0
                and si[SI_DEC_N] + 9 * nsm + 8 > ci[CI_DEC_CAP]):
            return 5
        if ci[CI_REC_PRED] != 0 and si[SI_PRED_N] + 4 > ci[CI_PRED_CAP]:
            return 6
        if si[SI_HEAP_LEN] == 0:
            return 0
        t, kind, seq, a, b, c, start = _heap_pop(si, hi, hf)
        if t > sd[SD_HORIZON]:
            # Truncated: credit in-flight busy time; the popped event is
            # credited last and ``now`` is NOT advanced, exactly like the
            # reference's in-place scan.  The heap array layout matches
            # the reference event list element for element, so the
            # accumulation order is identical too.
            now = sd[SD_NOW]
            for i in range(si[SI_HEAP_LEN]):
                if hi[i, HI_KIND] == EV_BLOCK_END:
                    frac = rf[hi[i, HI_A], RF_FRAC]
                    d = now - hf[i, HF_START]
                    sd[SD_BUSY] = sd[SD_BUSY] + (d if d > 0.0 else 0.0) * frac
            if kind == EV_BLOCK_END:
                frac = rf[a, RF_FRAC]
                d = now - start
                sd[SD_BUSY] = sd[SD_BUSY] + (d if d > 0.0 else 0.0) * frac
            return 1
        sd[SD_NOW] = t
        if kind == EV_BLOCK_END:
            rc = _handle_block_end(S, a, b, c, start, t)
            if rc >= 0:
                return rc
        elif kind == EV_ARRIVAL:
            _handle_arrival(S, a, t)
        else:
            _try_issue(S, a, t)
