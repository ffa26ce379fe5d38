"""Generated-C backend for the flat-array DES engine.

The C source below is a line-for-line translation of
:mod:`repro.core.fastsim_twin` (the ONE algorithm — see that module's
docstring and DESIGN.md Section 10).  The layout ``#define`` block is
generated from the twin's constants at build time, so the two can never
drift apart silently; the build is content-addressed (source hash in the
file name) and cached under ``REPRO_FASTSIM_CACHE`` or
``src/repro/core/_fastsim_build/`` (gitignored).

Bit-identity notes:

* compiled with ``-ffp-contract=off`` — gcc at ``-O2`` defaults to
  contracting ``a*b+c`` into FMA, which changes results in the last ulp;
  CPython never fuses, so neither may the C.  No ``-ffast-math`` ever.
* every ``int / int`` from the Python side becomes an explicit
  ``(double)x / (double)y`` — C integer division truncates, Python's
  ``/`` is true division.
* None is NaN, tested with ``x != x`` (safe without fast-math).

The only export is :func:`native_advance`, returning an ``advance(S)``
callable over the twin's 29-array state tuple, or raising when no C
compiler is available (callers treat any failure as "backend absent").
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

from . import fastsim_twin as tw


def _c_defines() -> str:
    """#define block generated from the twin's layout constants."""
    lines = []
    for name in sorted(dir(tw)):
        if not name[:1].isupper() or not name.replace("_", "").isalnum():
            continue
        value = getattr(tw, name)
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            continue
        lines.append(f"#define {name} {value!r}")
    lines.append(f"#define FS_EPS {tw._EPS!r}")
    return "\n".join(lines)


_C_BODY = r"""
#include <stdint.h>
#include <math.h>

typedef struct {
    int64_t *si; double *sd; int64_t *ci; double *cf;
    int64_t *ri; double *rf; int64_t *psi; double *psf;
    double *bs; int64_t *sl; int64_t *smi; double *smf;
    int64_t *hi; double *hf; int64_t *tri; double *trf;
    int64_t *dci; double *dcf; int64_t *pri; double *prf;
    int64_t *act; int64_t *q; int64_t *rwi; double *rwf;
    int64_t *newc; int64_t *cand; double *crem;
    double *np_pool; double *bt_pool;
    int64_t *srci; double *srcf;
    int64_t nsm;
} St;

typedef struct {
    double t; int64_t kind, seq, a, b, c; double start;
} Ev;

#define RI(r, c)      (S->ri[(r) * RI_LEN + (c)])
#define RF(r, c)      (S->rf[(r) * RF_LEN + (c)])
#define PSI(r, s, c)  (S->psi[((r) * S->nsm + (s)) * PI_LEN + (c)])
#define PSF(r, s, c)  (S->psf[((r) * S->nsm + (s)) * PF_LEN + (c)])
#define BS(r, s, k)   (S->bs[((r) * S->nsm + (s)) * MAX_BLOCK_SLOTS + (k)])
#define SL(s, k)      (S->sl[(s) * MAX_BLOCK_SLOTS + (k)])
#define SMI(s, c)     (S->smi[(s) * SMI_LEN + (c)])
#define SMF(s)        (S->smf[(s)])
#define HI(i, c)      (S->hi[(i) * HI_LEN + (c)])
#define HF(i, c)      (S->hf[(i) * HF_LEN + (c)])
#define TRI(i, c)     (S->tri[(i) * 3 + (c)])
#define TRF(i, c)     (S->trf[(i) * 2 + (c)])
#define DCI(i, c)     (S->dci[(i) * 3 + (c)])
#define DCF(i)        (S->dcf[(i)])
#define PRI(i, c)     (S->pri[(i) * 3 + (c)])
#define PRF(i, c)     (S->prf[(i) * 2 + (c)])
#define RWF(i, c)     (S->rwf[(i) * 3 + (c)])

/* ------------------------------------------------------------------ heap */
static int heap_lt(const St *S, int64_t i, int64_t j) {
    double ti = HF(i, HF_TIME), tj = HF(j, HF_TIME);
    if (ti != tj) return ti < tj;
    {
        int64_t ki = HI(i, HI_KIND), kj = HI(j, HI_KIND);
        if (ki != kj) return ki < kj;
    }
    return HI(i, HI_SEQ) < HI(j, HI_SEQ);
}

static int lt_item(const St *S, double t, int64_t kind, int64_t seq,
                   int64_t j) {
    double tj = HF(j, HF_TIME);
    if (t != tj) return t < tj;
    {
        int64_t kj = HI(j, HI_KIND);
        if (kind != kj) return kind < kj;
    }
    return seq < HI(j, HI_SEQ);
}

static void copy_row(St *S, int64_t dst, int64_t src) {
    HI(dst, 0) = HI(src, 0);
    HI(dst, 1) = HI(src, 1);
    HI(dst, 2) = HI(src, 2);
    HI(dst, 3) = HI(src, 3);
    HI(dst, 4) = HI(src, 4);
    HF(dst, 0) = HF(src, 0);
    HF(dst, 1) = HF(src, 1);
}

static void heap_push(St *S, double t, int64_t kind, int64_t seq,
                      int64_t a, int64_t b, int64_t c, double start) {
    int64_t pos = S->si[SI_HEAP_LEN];
    S->si[SI_HEAP_LEN] = pos + 1;
    while (pos > 0) {
        int64_t parent = (pos - 1) >> 1;
        if (lt_item(S, t, kind, seq, parent)) {
            copy_row(S, pos, parent);
            pos = parent;
        } else {
            break;
        }
    }
    HI(pos, HI_KIND) = kind;
    HI(pos, HI_SEQ) = seq;
    HI(pos, HI_A) = a;
    HI(pos, HI_B) = b;
    HI(pos, HI_C) = c;
    HF(pos, HF_TIME) = t;
    HF(pos, HF_START) = start;
}

static Ev heap_pop(St *S) {
    int64_t n = S->si[SI_HEAP_LEN] - 1;
    Ev last, root;
    int64_t pos, childpos;
    S->si[SI_HEAP_LEN] = n;
    last.t = HF(n, HF_TIME);
    last.kind = HI(n, HI_KIND);
    last.seq = HI(n, HI_SEQ);
    last.a = HI(n, HI_A);
    last.b = HI(n, HI_B);
    last.c = HI(n, HI_C);
    last.start = HF(n, HF_START);
    if (n == 0) return last;
    root.t = HF(0, HF_TIME);
    root.kind = HI(0, HI_KIND);
    root.seq = HI(0, HI_SEQ);
    root.a = HI(0, HI_A);
    root.b = HI(0, HI_B);
    root.c = HI(0, HI_C);
    root.start = HF(0, HF_START);
    pos = 0;
    childpos = 1;
    while (childpos < n) {
        int64_t rightpos = childpos + 1;
        if (rightpos < n && !heap_lt(S, childpos, rightpos))
            childpos = rightpos;
        copy_row(S, pos, childpos);
        pos = childpos;
        childpos = 2 * pos + 1;
    }
    while (pos > 0) {
        int64_t parent = (pos - 1) >> 1;
        if (lt_item(S, last.t, last.kind, last.seq, parent)) {
            copy_row(S, pos, parent);
            pos = parent;
        } else {
            break;
        }
    }
    HI(pos, HI_KIND) = last.kind;
    HI(pos, HI_SEQ) = last.seq;
    HI(pos, HI_A) = last.a;
    HI(pos, HI_B) = last.b;
    HI(pos, HI_C) = last.c;
    HF(pos, HF_TIME) = last.t;
    HF(pos, HF_START) = last.start;
    return root;
}

/* ---------------------------------------------------- machine primitives */
static void refresh_active(St *S) {
    int64_t n, r;
    if (S->si[SI_ACTIVE_DIRTY] == 0) return;
    n = 0;
    for (r = 0; r < S->ci[CI_NRUNS]; r++) {
        double fin = RF(r, RF_FIN);
        if (RI(r, RI_LAUNCHED) != 0 && fin != fin) {
            S->act[n] = r;
            n += 1;
        }
    }
    S->si[SI_ACTIVE_N] = n;
    S->si[SI_ACTIVE_DIRTY] = 0;
}

static int64_t pol_residency_cap(St *S, int64_t r) {
    int64_t pol = S->ci[CI_POLICY];
    if (pol == POL_FIFO_CAP) return S->ci[CI_FIXED_CAP];
    if (pol == POL_MPMAX) {
        int64_t cap = RI(r, RI_MPCAP);
        if (cap >= 0) return cap;
        return RI(r, RI_MAXR);
    }
    if (pol == POL_SRTF_ADAPTIVE) {
        int64_t cap = RI(r, RI_ADPCAP);
        if (S->si[SI_SHARING] != 0 && cap >= 0) return cap;
        return RI(r, RI_MAXR);
    }
    return RI(r, RI_MAXR);
}

static int can_fit(St *S, int64_t r, int64_t sm) {
    int64_t cap;
    if (RI(r, RI_NUMB) - RI(r, RI_ISSUED) <= 0) return 0;
    cap = RI(r, RI_MAXR);
    if (S->ci[CI_UNLIMITED] == 0) {
        int64_t pcap = pol_residency_cap(S, r);
        if (pcap < cap) cap = pcap;
    }
    if (PSI(r, sm, PI_RES) >= cap) return 0;
    if (SMI(sm, SMI_FREETOP) <= 0) return 0;
    if (SMI(sm, SMI_THR) + RI(r, RI_TPB) > MAX_THREADS_PER_SM) return 0;
    return SMF(sm) + RF(r, RF_FRAC) <= 1.0 + FS_EPS;
}

/* ---------------------------------------------------- predictor queries */
static double pred_remaining(St *S, int64_t r, int64_t sm) {
    double t;
    int64_t rb, res;
    if (RI(r, RI_PKNOWN) == 0) return NAN;
    t = PSF(r, sm, PF_PT);
    if (t != t) return NAN;
    rb = RI(r, RI_EXPECTED) - PSI(r, sm, PI_PDONE);
    if (rb < 0) rb = 0;
    res = PSI(r, sm, PI_PRESID);
    if (res <= 1) res = 1;
    return ((double)rb / (double)res) * t;
}

static double gpu_remaining(St *S, int64_t r) {
    double total = 0.0;
    int64_t count = 0, sm;
    if (RI(r, RI_PKNOWN) == 0) return NAN;
    for (sm = 0; sm < S->ci[CI_NSM]; sm++) {
        double t = PSF(r, sm, PF_PT);
        int64_t rb, res;
        if (t != t) continue;
        rb = RI(r, RI_EXPECTED) - PSI(r, sm, PI_PDONE);
        if (rb < 0) rb = 0;
        res = PSI(r, sm, PI_PRESID);
        if (res <= 1) res = 1;
        total = total + ((double)rb / (double)res) * t;
        count += 1;
    }
    if (count == 0) return NAN;
    return total / (double)count;
}

static double gpu_predicted_total(St *S, int64_t r, double now) {
    double total = 0.0;
    int64_t count = 0, sm;
    if (RI(r, RI_PKNOWN) == 0) return NAN;
    for (sm = 0; sm < S->ci[CI_NSM]; sm++) {
        double t = PSF(r, sm, PF_PT);
        double remaining, active;
        int64_t rb, res;
        if (t != t) continue;
        rb = RI(r, RI_EXPECTED) - PSI(r, sm, PI_PDONE);
        if (rb < 0) rb = 0;
        res = PSI(r, sm, PI_PRESID);
        if (res <= 1) res = 1;
        remaining = ((double)rb / (double)res) * t;
        active = PSF(r, sm, PF_PACT);
        if (PSI(r, sm, PI_PRUN) > 0)
            active = active + (now - PSF(r, sm, PF_PSINCE));
        total = total + (active + remaining);
        count += 1;
    }
    if (count == 0) return NAN;
    return total / (double)count;
}

/* --------------------------------------------------- predictor handlers */
static void observe(St *S, int64_t r, int64_t sm, double duration) {
    if (S->ci[CI_PRED_KIND] == 1) {
        double t;
        PSI(r, sm, PI_PRESLICE) = 0;
        if (duration != duration) return;
        t = PSF(r, sm, PF_PT);
        if (t != t) {
            PSF(r, sm, PF_PT) = duration;
        } else {
            double alpha = S->cf[CF_ALPHA];
            PSF(r, sm, PF_PT) = alpha * duration + (1.0 - alpha) * t;
        }
    } else {
        double t = PSF(r, sm, PF_PT);
        if (PSI(r, sm, PI_PRESLICE) != 0 || t != t) {
            if (duration == duration) PSF(r, sm, PF_PT) = duration;
            PSI(r, sm, PI_PRESLICE) = 0;
        }
    }
}

static void pred_on_launch(St *S, int64_t r) {
    int64_t nsm = S->ci[CI_NSM], sm, slot, other;
    int64_t residency = RI(r, RI_MAXR);
    if (residency < 1) residency = 1;
    for (sm = 0; sm < nsm; sm++) {
        PSI(r, sm, PI_PDONE) = 0;
        PSI(r, sm, PI_PRESID) = residency;
        PSI(r, sm, PI_PRESLICE) = 1;
        PSI(r, sm, PI_PRUN) = 0;
        PSF(r, sm, PF_PT) = NAN;
        PSF(r, sm, PF_PACT) = 0.0;
        PSF(r, sm, PF_PSINCE) = 0.0;
        for (slot = 0; slot < MAX_BLOCK_SLOTS; slot++)
            BS(r, sm, slot) = NAN;
    }
    RI(r, RI_PKNOWN) = 1;
    for (other = 0; other < S->ci[CI_NRUNS]; other++) {
        if (other == r || RI(other, RI_PKNOWN) == 0) continue;
        for (sm = 0; sm < nsm; sm++)
            PSI(other, sm, PI_PRESLICE) = 1;
    }
}

static void pred_on_kernel_end(St *S, int64_t r) {
    int64_t other, sm;
    for (other = 0; other < S->ci[CI_NRUNS]; other++) {
        if (other == r || RI(other, RI_PKNOWN) == 0) continue;
        for (sm = 0; sm < S->ci[CI_NSM]; sm++)
            PSI(other, sm, PI_PRESLICE) = 1;
    }
}

static void pred_on_block_start(St *S, int64_t r, int64_t sm, int64_t slot,
                                double now) {
    BS(r, sm, slot) = now;
    if (PSI(r, sm, PI_PRUN) == 0) PSF(r, sm, PF_PSINCE) = now;
    PSI(r, sm, PI_PRUN) += 1;
}

static double pred_on_block_end(St *S, int64_t r, int64_t sm, int64_t slot,
                                double now) {
    double start, t, remaining, active;
    int64_t rc, rb, res;
    PSI(r, sm, PI_PDONE) += 1;
    start = BS(r, sm, slot);
    BS(r, sm, slot) = NAN;
    {
        double pt = PSF(r, sm, PF_PT);
        if (PSI(r, sm, PI_PRESLICE) != 0 || pt != pt
                || S->ci[CI_PRED_KIND] == 1) {
            if (start != start)
                observe(S, r, sm, NAN);
            else
                observe(S, r, sm, now - start);
        }
    }
    rc = PSI(r, sm, PI_PRUN) - 1;
    PSI(r, sm, PI_PRUN) = rc > 0 ? rc : 0;
    if (rc <= 0)
        PSF(r, sm, PF_PACT) = PSF(r, sm, PF_PACT)
            + (now - PSF(r, sm, PF_PSINCE));
    t = PSF(r, sm, PF_PT);
    if (t != t) return NAN;
    rb = RI(r, RI_EXPECTED) - PSI(r, sm, PI_PDONE);
    if (rb < 0) rb = 0;
    res = PSI(r, sm, PI_PRESID);
    if (res <= 1) res = 1;
    remaining = ((double)rb / (double)res) * t;
    active = PSF(r, sm, PF_PACT);
    if (PSI(r, sm, PI_PRUN) > 0)
        active = active + (now - PSF(r, sm, PF_PSINCE));
    return active + remaining;
}

static void pred_on_residency_change(St *S, int64_t r, int64_t sm,
                                     int64_t new_residency) {
    if (new_residency < 1) new_residency = 1;
    if (PSI(r, sm, PI_PRESID) != new_residency) {
        PSI(r, sm, PI_PRESID) = new_residency;
        PSI(r, sm, PI_PRESLICE) = 1;
    }
}

static void broadcast_t(St *S, int64_t r, double t, int64_t from_sm) {
    int64_t sm;
    for (sm = 0; sm < S->ci[CI_NSM]; sm++) {
        double pt;
        if (sm == from_sm) continue;
        pt = PSF(r, sm, PF_PT);
        if (pt != pt) {
            PSF(r, sm, PF_PT) = t;
            PSI(r, sm, PI_PRESLICE) = 0;
        }
    }
}

static void sync_residency_caps(St *S) {
    int64_t i;
    refresh_active(S);
    for (i = 0; i < S->si[SI_ACTIVE_N]; i++) {
        int64_t r = S->act[i], cap, sm;
        if (RI(r, RI_PKNOWN) == 0) continue;
        cap = RI(r, RI_MAXR);
        if (S->ci[CI_UNLIMITED] == 0) {
            int64_t pcap = pol_residency_cap(S, r);
            if (pcap < cap) cap = pcap;
        }
        if (RI(r, RI_SYNCED) == cap) continue;
        for (sm = 0; sm < S->ci[CI_NSM]; sm++)
            pred_on_residency_change(S, r, sm, cap);
        RI(r, RI_SYNCED) = cap;
    }
}

/* ---------------------------------------------------------- policy layer */
static void mpmax_recompute(St *S) {
    int64_t r, i, n;
    refresh_active(S);
    for (r = 0; r < S->ci[CI_NRUNS]; r++)
        RI(r, RI_MPCAP) = -1;
    n = S->si[SI_ACTIVE_N];
    for (i = 0; i < n; i++) {
        int64_t rr = S->act[i], j, cap;
        double reserved = 0.0;
        for (j = 0; j < n; j++) {
            int64_t other = S->act[j];
            if (other != rr) reserved = reserved + RF(other, RF_FRAC);
        }
        cap = (int64_t)floor((double)RI(rr, RI_MAXR) * (1.0 - reserved));
        if (cap < 1) cap = 1;
        RI(rr, RI_MPCAP) = cap;
    }
}

static void start_next_sample(St *S) {
    while (S->si[SI_SAMPLING] < 0 && S->si[SI_QHEAD] < S->si[SI_QTAIL]) {
        int64_t r = S->q[S->si[SI_QHEAD]];
        double fin;
        S->si[SI_QHEAD] += 1;
        if (RI(r, RI_ELIG) != 0) continue;
        fin = RF(r, RF_FIN);
        if (fin == fin) continue;
        S->si[SI_SAMPLING] = r;
    }
}

static void queue_remove(St *S, int64_t r) {
    int64_t head = S->si[SI_QHEAD], tail = S->si[SI_QTAIL], i, j;
    for (i = head; i < tail; i++) {
        if (S->q[i] == r) {
            for (j = i; j < tail - 1; j++)
                S->q[j] = S->q[j + 1];
            S->si[SI_QTAIL] = tail - 1;
            return;
        }
    }
}

static double srtf_remaining(St *S, int64_t r, int64_t sm) {
    double rem;
    if (S->ci[CI_POLICY] == POL_SRTF_ZERO) {
        double rt = RF(r, RF_ORACLE);
        if (rt == rt) {
            int64_t numb = RI(r, RI_NUMB);
            double frac_left;
            if (numb < 1) numb = 1;
            frac_left = 1.0 - (double)RI(r, RI_DONE) / (double)numb;
            return rt * frac_left;
        }
    }
    rem = pred_remaining(S, r, sm);
    if (rem == rem) return rem;
    rem = gpu_remaining(S, r);
    if (rem == rem) return rem;
    return INFINITY;
}

static int64_t best_candidate(St *S, int64_t sm) {
    int64_t n, sole = -1, count = 0, i, best = -1;
    double best_rem = 0.0;
    refresh_active(S);
    n = S->si[SI_ACTIVE_N];
    for (i = 0; i < n; i++) {
        int64_t r = S->act[i];
        if (RI(r, RI_ELIG) == 0) continue;
        if (RI(r, RI_NUMB) > RI(r, RI_ISSUED)) {
            count += 1;
            if (count > 1) break;
            sole = r;
        }
    }
    if (count == 0) return -1;
    if (count == 1) return sole;
    for (i = 0; i < n; i++) {
        int64_t r = S->act[i];
        double rem;
        if (RI(r, RI_ELIG) == 0) continue;
        if (RI(r, RI_NUMB) <= RI(r, RI_ISSUED)) continue;
        rem = srtf_remaining(S, r, sm);
        if (best < 0 || rem < best_rem) {
            best = r;
            best_rem = rem;
        }
    }
    return best;
}

static int64_t adaptive_candidates(St *S, int64_t sm) {
    int64_t m = 0, i;
    refresh_active(S);
    for (i = 0; i < S->si[SI_ACTIVE_N]; i++) {
        int64_t r = S->act[i];
        if (RI(r, RI_ELIG) != 0 && RI(r, RI_NUMB) > RI(r, RI_ISSUED)) {
            S->cand[m] = r;
            S->crem[m] = srtf_remaining(S, r, sm);
            m += 1;
        }
    }
    for (i = 1; i < m; i++) {
        int64_t kr = S->cand[i], j = i - 1;
        double kv = S->crem[i];
        while (j >= 0 && S->crem[j] > kv) {
            S->cand[j + 1] = S->cand[j];
            S->crem[j + 1] = S->crem[j];
            j -= 1;
        }
        S->cand[j + 1] = kr;
        S->crem[j + 1] = kv;
    }
    return m;
}

static int64_t adaptive_loser_cap(St *S, int64_t r, int64_t winner) {
    int64_t shared_w = S->ci[CI_SHARED_RES];
    int64_t wmax = RI(winner, RI_MAXR), cap;
    double free_frac;
    if (wmax < shared_w) shared_w = wmax;
    free_frac = 1.0 - (double)shared_w * RF(winner, RF_FRAC);
    cap = (int64_t)floor(free_frac * (double)RI(r, RI_MAXR));
    if (cap < 1) cap = 1;
    return cap;
}

static int64_t adaptive_cap_now(St *S, int64_t r) {
    int64_t cap = RI(r, RI_ADPCAP);
    if (cap >= 0) return cap;
    return RI(r, RI_MAXR);
}

static void adaptive_reevaluate(St *S, double now) {
    int sharing, ok = 1, want, changed;
    int64_t nrows = 0, i, winner, w_cap_now, wmax, cur_cap, shared_w;
    double acc, ex_max = 0.0, ex_min = 0.0, gap_excl;
    double ts1, s0, sh_max, sh_min, gap_shared;
    refresh_active(S);
    sharing = S->si[SI_SHARING] != 0;
    if (!sharing && S->si[SI_ACTIVE_N] < 2) return;
    for (i = 0; i < S->si[SI_ACTIVE_N]; i++) {
        int64_t r = S->act[i];
        if (RI(r, RI_ELIG) == 0) continue;
        S->rwi[nrows] = r;
        nrows += 1;
    }
    if (nrows < 2) ok = 0;
    if (ok) {
        for (i = 0; i < nrows; i++) {
            int64_t r = S->rwi[i];
            double rem = gpu_remaining(S, r), solo;
            if (rem != rem) { ok = 0; break; }
            solo = RF(r, RF_EXCL);
            if (solo != solo) solo = gpu_predicted_total(S, r, now);
            if (solo != solo || solo <= 0.0) { ok = 0; break; }
            RWF(i, RW_REM) = rem;
            RWF(i, RW_ELAPSED) = now - RF(r, RF_ARRT);
            RWF(i, RW_SOLO) = solo;
        }
    }
    if (!ok) {
        if (sharing) {
            int64_t r;
            S->si[SI_SHARING] = 0;
            for (r = 0; r < S->ci[CI_NRUNS]; r++)
                RI(r, RI_ADPCAP) = -1;
            sync_residency_caps(S);
        }
        return;
    }
    for (i = 1; i < nrows; i++) {
        int64_t kr = S->rwi[i], j = i - 1;
        double v0 = RWF(i, RW_REM);
        double v1 = RWF(i, RW_ELAPSED);
        double v2 = RWF(i, RW_SOLO);
        while (j >= 0 && RWF(j, RW_REM) > v0) {
            S->rwi[j + 1] = S->rwi[j];
            RWF(j + 1, RW_REM) = RWF(j, RW_REM);
            RWF(j + 1, RW_ELAPSED) = RWF(j, RW_ELAPSED);
            RWF(j + 1, RW_SOLO) = RWF(j, RW_SOLO);
            j -= 1;
        }
        S->rwi[j + 1] = kr;
        RWF(j + 1, RW_REM) = v0;
        RWF(j + 1, RW_ELAPSED) = v1;
        RWF(j + 1, RW_SOLO) = v2;
    }
    acc = 0.0;
    for (i = 0; i < nrows; i++) {
        double s;
        acc = acc + RWF(i, RW_REM);
        s = (RWF(i, RW_ELAPSED) + acc) / RWF(i, RW_SOLO);
        if (i == 0) {
            ex_max = s;
            ex_min = s;
        } else {
            if (s > ex_max) ex_max = s;
            if (s < ex_min) ex_min = s;
        }
    }
    gap_excl = ex_max - ex_min;
    winner = S->rwi[0];
    w_cap_now = adaptive_cap_now(S, winner);
    wmax = RI(winner, RI_MAXR);
    cur_cap = w_cap_now < wmax ? w_cap_now : wmax;
    if (cur_cap < 1) cur_cap = 1;
    shared_w = S->ci[CI_SHARED_RES];
    if (wmax < shared_w) shared_w = wmax;
    ts1 = RWF(0, RW_REM) * (double)cur_cap / (double)shared_w;
    s0 = (RWF(0, RW_ELAPSED) + ts1) / RWF(0, RW_SOLO);
    sh_max = s0;
    sh_min = s0;
    for (i = 1; i < nrows; i++) {
        int64_t r = S->rwi[i];
        int64_t full = RI(r, RI_MAXR);
        int64_t shared_cap = adaptive_loser_cap(S, r, winner);
        int64_t cur = adaptive_cap_now(S, r);
        double s_l, s;
        if (cur > full) cur = full;
        if (cur < 1) cur = 1;
        s_l = RWF(i, RW_REM) * (double)cur / (double)shared_cap;
        if (s_l <= ts1) {
            s = (RWF(i, RW_ELAPSED) + s_l) / RWF(i, RW_SOLO);
        } else {
            double tail = (s_l - ts1) * (double)shared_cap / (double)full;
            s = (RWF(i, RW_ELAPSED) + ts1 + tail) / RWF(i, RW_SOLO);
        }
        if (s > sh_max) sh_max = s;
        if (s < sh_min) sh_min = s;
    }
    gap_shared = sh_max - sh_min;
    want = (gap_excl > S->cf[CF_THRESHOLD]
            && gap_shared < gap_excl - S->cf[CF_HYSTERESIS]);
    if (want) {
        for (i = 0; i < nrows; i++) {
            int64_t r = S->rwi[i], cap;
            if (r == winner) {
                cap = S->ci[CI_SHARED_RES];
                if (RI(r, RI_MAXR) < cap) cap = RI(r, RI_MAXR);
            } else {
                cap = adaptive_loser_cap(S, r, winner);
            }
            S->newc[i] = cap;
        }
    }
    changed = want != sharing;
    if (!changed) {
        int64_t old_n = 0, r;
        for (r = 0; r < S->ci[CI_NRUNS]; r++)
            if (RI(r, RI_ADPCAP) >= 0) old_n += 1;
        if (want) {
            if (old_n != nrows) {
                changed = 1;
            } else {
                for (i = 0; i < nrows; i++) {
                    if (RI(S->rwi[i], RI_ADPCAP) != S->newc[i]) {
                        changed = 1;
                        break;
                    }
                }
            }
        } else {
            changed = old_n != 0;
        }
    }
    if (changed) {
        int64_t r;
        S->si[SI_SHARING] = want ? 1 : 0;
        for (r = 0; r < S->ci[CI_NRUNS]; r++)
            RI(r, RI_ADPCAP) = -1;
        if (want) {
            for (i = 0; i < nrows; i++)
                RI(S->rwi[i], RI_ADPCAP) = S->newc[i];
        }
        sync_residency_caps(S);
    }
}

static int64_t fs_decide(St *S, int64_t sm, int64_t *out_r) {
    int64_t pol = S->ci[CI_POLICY], i, k;
    *out_r = -1;
    if (pol == POL_FIFO || pol == POL_FIFO_CAP) {
        refresh_active(S);
        for (i = 0; i < S->si[SI_ACTIVE_N]; i++) {
            int64_t r = S->act[i];
            if (RI(r, RI_NUMB) > RI(r, RI_ISSUED)) {
                if (can_fit(S, r, sm)) {
                    *out_r = r;
                    return DEC_GRANT;
                }
                return DEC_HOLD_HEAD;
            }
        }
        return DEC_HOLD_NO_UNDISP;
    }
    if (pol == POL_SJF || pol == POL_LJF) {
        int64_t best = -1;
        double best_key = 0.0;
        refresh_active(S);
        for (i = 0; i < S->si[SI_ACTIVE_N]; i++) {
            int64_t r = S->act[i];
            double kk;
            if (RI(r, RI_NUMB) <= RI(r, RI_ISSUED)) continue;
            kk = RF(r, RF_SJFKEY);
            if (best < 0 || kk < best_key) {
                best = r;
                best_key = kk;
            }
        }
        if (best < 0) return DEC_HOLD_NO_UNDISP;
        if (can_fit(S, best, sm)) {
            *out_r = best;
            return DEC_GRANT;
        }
        return DEC_HOLD_HEAD;
    }
    if (pol == POL_MPMAX) {
        refresh_active(S);
        for (i = 0; i < S->si[SI_ACTIVE_N]; i++) {
            int64_t r = S->act[i];
            if (RI(r, RI_NUMB) > RI(r, RI_ISSUED) && can_fit(S, r, sm)) {
                *out_r = r;
                return DEC_GRANT;
            }
        }
        return DEC_HOLD_MPMAX;
    }
    if (pol == POL_SRTF_ADAPTIVE && S->si[SI_SHARING] != 0) {
        int64_t m;
        if (S->si[SI_SAMPLING] >= 0 && sm == S->ci[CI_SAMPLE_SM]) {
            k = S->si[SI_SAMPLING];
            if (RI(k, RI_NUMB) > RI(k, RI_ISSUED) && can_fit(S, k, sm)) {
                *out_r = k;
                return DEC_SAMPLE;
            }
            return DEC_HOLD_SAMPLING;
        }
        m = adaptive_candidates(S, sm);
        for (i = 0; i < m; i++) {
            if (can_fit(S, S->cand[i], sm)) {
                *out_r = S->cand[i];
                return DEC_GRANT;
            }
        }
        return DEC_HOLD_ADAPTIVE;
    }
    if (S->si[SI_SAMPLING] >= 0 && sm == S->ci[CI_SAMPLE_SM]) {
        k = S->si[SI_SAMPLING];
        if (RI(k, RI_NUMB) > RI(k, RI_ISSUED) && can_fit(S, k, sm)) {
            *out_r = k;
            return DEC_SAMPLE;
        }
        return DEC_HOLD_SAMPLING;
    }
    k = best_candidate(S, sm);
    if (k < 0) return DEC_HOLD_NO_ELIG;
    if (can_fit(S, k, sm)) {
        *out_r = k;
        return DEC_GRANT;
    }
    *out_r = k;
    return DEC_PREEMPT;
}

static void pol_on_arrival(St *S, int64_t r, double now) {
    int64_t pol = S->ci[CI_POLICY];
    if (pol == POL_MPMAX) {
        mpmax_recompute(S);
        return;
    }
    if (pol == POL_SRTF_ZERO) {
        RI(r, RI_ELIG) = 1;
        return;
    }
    if (pol == POL_SRTF || pol == POL_SRTF_ADAPTIVE) {
        refresh_active(S);
        if (S->si[SI_ACTIVE_N] == 1) {
            RI(r, RI_ELIG) = 1;
        } else {
            S->q[S->si[SI_QTAIL]] = r;
            S->si[SI_QTAIL] += 1;
            start_next_sample(S);
        }
        if (pol == POL_SRTF_ADAPTIVE)
            adaptive_reevaluate(S, now);
    }
}

static void pol_on_block_end(St *S, int64_t r, int64_t sm, double now) {
    int64_t pol = S->ci[CI_POLICY];
    if (pol < POL_SRTF) return;
    if (r == S->si[SI_SAMPLING] && sm == S->ci[CI_SAMPLE_SM]) {
        double t = PSF(r, sm, PF_PT);
        if (t == t) {
            broadcast_t(S, r, t, sm);
            RI(r, RI_ELIG) = 1;
            S->si[SI_SAMPLING] = -1;
            start_next_sample(S);
        }
    }
    if (pol == POL_SRTF_ADAPTIVE) {
        if (S->si[SI_SHARING] == 0) {
            refresh_active(S);
            if (S->si[SI_ACTIVE_N] > 1 || S->si[SI_PENDING] > 0
                    || S->ci[CI_HAS_SOURCE] != 0) {
                double pred = gpu_predicted_total(S, r, now);
                if (pred == pred) RF(r, RF_EXCL) = pred;
            }
        }
        adaptive_reevaluate(S, now);
    }
}

static void pol_on_kernel_end(St *S, int64_t r, double now) {
    int64_t pol = S->ci[CI_POLICY];
    if (pol == POL_MPMAX) {
        mpmax_recompute(S);
        return;
    }
    if (pol < POL_SRTF) return;
    RI(r, RI_ELIG) = 0;
    if (S->si[SI_SAMPLING] == r) S->si[SI_SAMPLING] = -1;
    queue_remove(S, r);
    start_next_sample(S);
    refresh_active(S);
    if (S->si[SI_ACTIVE_N] == 1)
        RI(S->act[0], RI_ELIG) = 1;
    if (pol == POL_SRTF_ADAPTIVE) {
        RF(r, RF_EXCL) = NAN;
        adaptive_reevaluate(S, now);
    }
}

/* ------------------------------------------------------------ issue loop */
static void finalize_block(St *S, int64_t r, int64_t sm, int64_t slot,
                           int64_t noise_idx, int64_t first_wave,
                           double now) {
    int64_t residency = PSI(r, sm, PI_RES), maxr, idx, i, seq;
    double corunner_warps = 0.0, t, base, duration, end;
    refresh_active(S);
    for (i = 0; i < S->si[SI_ACTIVE_N]; i++) {
        int64_t other = S->act[i], cnt;
        if (other == r) continue;
        cnt = PSI(other, sm, PI_RES);
        if (cnt != 0)
            corunner_warps = corunner_warps
                + ((RF(other, RF_CPRESS) * (double)cnt)
                   * (double)RI(other, RI_WARPS));
    }
    maxr = RI(r, RI_MAXR);
    idx = residency < maxr ? residency : maxr;
    t = S->bt_pool[RI(r, RI_BT_OFF) + idx];
    if (corunner_warps > 0.0)
        t = t * (1.0 + RF(r, RF_CSENS) * (corunner_warps
                                          / MAX_WARPS_PER_SM));
    if (first_wave != 0 && RF(r, RF_STARTUP) > 0.0)
        t = t * (1.0 + RF(r, RF_STARTUP));
    base = t > 1.0 ? t : 1.0;
    duration = base * S->np_pool[RI(r, RI_NOISE_OFF) + noise_idx];
    if (S->ci[CI_DRIVE_PRED] != 0)
        pred_on_block_start(S, r, sm, slot, now);
    end = now + duration;
    seq = S->si[SI_SEQ];
    S->si[SI_SEQ] = seq + 1;
    heap_push(S, end, EV_BLOCK_END, seq, r, sm, slot, now);
    if (S->ci[CI_REC_TRACE] != 0) {
        int64_t n = S->si[SI_TRACE_N];
        TRI(n, 0) = r;
        TRI(n, 1) = sm;
        TRI(n, 2) = slot;
        TRF(n, 0) = now;
        TRF(n, 1) = end;
        S->si[SI_TRACE_N] = n + 1;
    }
}

static void try_issue(St *S, int64_t sm, double now) {
    int64_t batch[MAX_BLOCK_SLOTS][4];
    int64_t nb = 0, i;
    for (;;) {
        int64_t r, code, top, slot, issued_on_sm, noise_idx, first_wave;
        double gate;
        code = fs_decide(S, sm, &r);
        if (S->ci[CI_REC_DEC] != 0) {
            int64_t n = S->si[SI_DEC_N];
            DCI(n, 0) = sm;
            DCI(n, 1) = code;
            DCI(n, 2) = r;
            DCF(n) = now;
            S->si[SI_DEC_N] = n + 1;
        }
        if (code > DEC_SAMPLE) break;
        gate = PSF(r, sm, PF_GATE);
        if (gate > now + FS_EPS) {
            int64_t seq = S->si[SI_SEQ];
            S->si[SI_SEQ] = seq + 1;
            heap_push(S, gate, EV_TRY_ISSUE, seq, sm, 0, 0, 0.0);
            break;
        }
        top = SMI(sm, SMI_FREETOP) - 1;
        SMI(sm, SMI_FREETOP) = top;
        slot = SMI(sm, SMI_FS0 + top);
        SL(sm, slot) = r;
        SMI(sm, SMI_THR) = SMI(sm, SMI_THR) + RI(r, RI_TPB);
        SMF(sm) = SMF(sm) + RF(r, RF_FRAC);
        PSI(r, sm, PI_RES) += 1;
        issued_on_sm = PSI(r, sm, PI_ISSD);
        PSI(r, sm, PI_ISSD) = issued_on_sm + 1;
        {
            double first = RF(r, RF_FIRST);
            if (first != first) RF(r, RF_FIRST) = now;
        }
        first_wave = issued_on_sm < RI(r, RI_MAXR) ? 1 : 0;
        noise_idx = RI(r, RI_ISSUED);
        RI(r, RI_ISSUED) = noise_idx + 1;
        if (first_wave != 0 && PSI(r, sm, PI_STAG) != 0)
            PSF(r, sm, PF_GATE) = now + RF(r, RF_STAGF) * RF(r, RF_MEANT);
        batch[nb][0] = r;
        batch[nb][1] = slot;
        batch[nb][2] = noise_idx;
        batch[nb][3] = first_wave;
        nb += 1;
    }
    for (i = 0; i < nb; i++)
        finalize_block(S, batch[i][0], sm, batch[i][1], batch[i][2],
                       batch[i][3], now);
}

static void fan_out(St *S, double now) {
    int64_t sm;
    for (sm = 0; sm < S->ci[CI_NSM]; sm++)
        try_issue(S, sm, now);
}

static void src_inject(St *S, int64_t r2, double t, double now) {
    int64_t seq;
    if (t < now)
        t = now;
    RI(r2, RI_STAGED) = 0;
    RF(r2, RF_ARRT) = t;
    S->si[SI_PENDING] += 1;
    seq = S->si[SI_SEQ];
    S->si[SI_SEQ] = seq + 1;
    heap_push(S, t, EV_ARRIVAL, seq, r2, 0, 0, 0.0);
    S->si[SI_ACTIVE_DIRTY] = 1;
}

static int64_t src_release_mgk(St *S, double now) {
    while (S->srci[SRC_INSYS] < S->srci[SRC_POP]) {
        int64_t k = S->srci[SRC_NEXT];
        if (k >= S->srci[SRC_NSTAGED]) {
            if (S->srci[SRC_MORE] != 0)
                return 7;
            return 0;
        }
        S->srci[SRC_NEXT] = k + 1;
        S->srci[SRC_INSYS] += 1;
        src_inject(S, S->srci[SRC_BASE] + k, S->srcf[k], now);
    }
    return 0;
}

static int64_t src_feed_think(St *S, int64_t r, double now) {
    int64_t ten = RI(r, RI_TENANT), k, r2;
    if (ten < 0)
        return 0;
    if (S->srci[SRC_RD0 + ten] >= S->srci[SRC_NROUNDS])
        return 0;
    k = S->srci[SRC_NEXT];
    if (k >= S->srci[SRC_NSTAGED]) {
        S->srci[SRC_PEND] = ten;
        return 7;
    }
    S->srci[SRC_NEXT] = k + 1;
    S->srci[SRC_RD0 + ten] += 1;
    r2 = S->srci[SRC_BASE] + k;
    RI(r2, RI_TENANT) = ten;
    src_inject(S, r2, now + S->srcf[k], now);
    return 0;
}

static int64_t src_on_completion(St *S, int64_t r, double now) {
    int64_t mode = S->ci[CI_SRC_MODE];
    if (mode == SRCMODE_MGK) {
        if (RI(r, RI_SRC) == 0)
            return 0;
        S->srci[SRC_INSYS] -= 1;
        return src_release_mgk(S, now);
    }
    if (mode == SRCMODE_THINK)
        return src_feed_think(S, r, now);
    return 2;
}

static int64_t src_resume(St *S, double now) {
    int64_t mode = S->ci[CI_SRC_MODE];
    if (mode == SRCMODE_MGK)
        return src_release_mgk(S, now);
    if (mode == SRCMODE_THINK) {
        int64_t ten = S->srci[SRC_PEND], k, r2;
        if (ten < 0)
            return 0;
        k = S->srci[SRC_NEXT];
        if (k >= S->srci[SRC_NSTAGED])
            return 7;
        S->srci[SRC_PEND] = -1;
        S->srci[SRC_NEXT] = k + 1;
        S->srci[SRC_RD0 + ten] += 1;
        r2 = S->srci[SRC_BASE] + k;
        RI(r2, RI_TENANT) = ten;
        src_inject(S, r2, now + S->srcf[k], now);
    }
    return 0;
}

static int64_t handle_block_end(St *S, int64_t r, int64_t sm, int64_t slot,
                                double start, double now) {
    double frac = RF(r, RF_FRAC), pred = NAN, uf;
    int64_t top, ut;
    S->sd[SD_BUSY] = S->sd[SD_BUSY] + (now - start) * frac;
    SL(sm, slot) = -1;
    top = SMI(sm, SMI_FREETOP);
    SMI(sm, SMI_FS0 + top) = slot;
    SMI(sm, SMI_FREETOP) = top + 1;
    ut = SMI(sm, SMI_THR) - RI(r, RI_TPB);
    SMI(sm, SMI_THR) = ut > 0 ? ut : 0;
    uf = SMF(sm) - frac;
    SMF(sm) = uf > 0.0 ? uf : 0.0;
    PSI(r, sm, PI_RES) -= 1;
    RI(r, RI_DONE) += 1;
    if (S->ci[CI_DRIVE_PRED] != 0) {
        pred = pred_on_block_end(S, r, sm, slot, now);
        pol_on_block_end(S, r, sm, now);
    } else {
        pol_on_block_end(S, r, sm, now);
    }
    if (S->ci[CI_REC_PRED] != 0 && pred == pred) {
        int64_t n = S->si[SI_PRED_N];
        PRI(n, 0) = r;
        PRI(n, 1) = sm;
        PRI(n, 2) = PSI(r, sm, PI_PDONE);
        PRF(n, 0) = now;
        PRF(n, 1) = pred;
        S->si[SI_PRED_N] = n + 1;
    }
    if (RI(r, RI_DONE) == RI(r, RI_NUMB)) {
        RF(r, RF_FIN) = now;
        S->si[SI_ACTIVE_DIRTY] = 1;
        RI(r, RI_SYNCED) = -1;
        pred_on_kernel_end(S, r);
        pol_on_kernel_end(S, r, now);
        sync_residency_caps(S);
        if (S->ci[CI_HAS_SOURCE] != 0) {
            int64_t rc;
            S->si[SI_EXIT_RUN] = r;
            rc = src_on_completion(S, r, now);
            if (rc != 0)
                return rc;
        }
        fan_out(S, now);
    } else {
        try_issue(S, sm, now);
    }
    return -1;
}

static void handle_arrival(St *S, int64_t r, double now) {
    S->si[SI_PENDING] -= 1;
    RI(r, RI_LAUNCHED) = 1;
    S->si[SI_ACTIVE_DIRTY] = 1;
    pred_on_launch(S, r);
    pol_on_arrival(S, r, now);
    sync_residency_caps(S);
    fan_out(S, now);
}

int64_t fs_advance(
    int64_t *si, double *sd, int64_t *ci, double *cf,
    int64_t *ri, double *rf, int64_t *psi, double *psf,
    double *bs, int64_t *sl, int64_t *smi, double *smf,
    int64_t *hi, double *hf, int64_t *tri, double *trf,
    int64_t *dci, double *dcf, int64_t *pri, double *prf,
    int64_t *act, int64_t *q, int64_t *rwi, double *rwf,
    int64_t *newc, int64_t *cand, double *crem,
    double *np_pool, double *bt_pool,
    int64_t *srci, double *srcf) {
    St state;
    St *S = &state;
    int64_t nsm;
    state.si = si; state.sd = sd; state.ci = ci; state.cf = cf;
    state.ri = ri; state.rf = rf; state.psi = psi; state.psf = psf;
    state.bs = bs; state.sl = sl; state.smi = smi; state.smf = smf;
    state.hi = hi; state.hf = hf; state.tri = tri; state.trf = trf;
    state.dci = dci; state.dcf = dcf; state.pri = pri; state.prf = prf;
    state.act = act; state.q = q; state.rwi = rwi; state.rwf = rwf;
    state.newc = newc; state.cand = cand; state.crem = crem;
    state.np_pool = np_pool; state.bt_pool = bt_pool;
    state.srci = srci; state.srcf = srcf;
    state.nsm = ci[CI_NSM];
    nsm = state.nsm;
    if (si[SI_RESUME] != 0) {
        int64_t rc;
        si[SI_RESUME] = 0;
        rc = src_resume(S, sd[SD_NOW]);
        if (rc != 0)
            return rc;
        fan_out(S, sd[SD_NOW]);
    }
    for (;;) {
        Ev ev;
        if (si[SI_HEAP_LEN] + 9 * nsm + 8 + ci[CI_SRC_RESERVE]
                > ci[CI_HEAP_CAP])
            return 3;
        if (ci[CI_REC_TRACE] != 0
                && si[SI_TRACE_N] + 8 * nsm + 8 > ci[CI_TRACE_CAP])
            return 4;
        if (ci[CI_REC_DEC] != 0
                && si[SI_DEC_N] + 9 * nsm + 8 > ci[CI_DEC_CAP])
            return 5;
        if (ci[CI_REC_PRED] != 0 && si[SI_PRED_N] + 4 > ci[CI_PRED_CAP])
            return 6;
        if (si[SI_HEAP_LEN] == 0) return 0;
        ev = heap_pop(S);
        if (ev.t > sd[SD_HORIZON]) {
            double now = sd[SD_NOW];
            int64_t i;
            for (i = 0; i < si[SI_HEAP_LEN]; i++) {
                if (HI(i, HI_KIND) == EV_BLOCK_END) {
                    double frac = RF(HI(i, HI_A), RF_FRAC);
                    double d = now - HF(i, HF_START);
                    sd[SD_BUSY] = sd[SD_BUSY]
                        + (d > 0.0 ? d : 0.0) * frac;
                }
            }
            if (ev.kind == EV_BLOCK_END) {
                double frac = RF(ev.a, RF_FRAC);
                double d = now - ev.start;
                sd[SD_BUSY] = sd[SD_BUSY] + (d > 0.0 ? d : 0.0) * frac;
            }
            return 1;
        }
        sd[SD_NOW] = ev.t;
        if (ev.kind == EV_BLOCK_END) {
            int64_t rc = handle_block_end(S, ev.a, ev.b, ev.c, ev.start,
                                          ev.t);
            if (rc >= 0)
                return rc;
        } else if (ev.kind == EV_ARRIVAL) {
            handle_arrival(S, ev.a, ev.t);
        } else {
            try_issue(S, ev.a, ev.t);
        }
    }
}
"""


def c_source() -> str:
    return (
        "/* GENERATED from repro.core.fastsim_twin — do not edit the build\n"
        "   artifact; edit the twin and fastsim_c.py. */\n"
        + _c_defines() + "\n" + _C_BODY)


def _build_dir() -> Path:
    override = os.environ.get("REPRO_FASTSIM_CACHE")
    if override:
        return Path(override)
    return Path(__file__).resolve().parent / "_fastsim_build"


def _build_library() -> ctypes.CDLL:
    src = c_source()
    digest = hashlib.sha256(src.encode()).hexdigest()[:16]
    build = _build_dir()
    build.mkdir(parents=True, exist_ok=True)
    lib_path = build / f"fastsim_{digest}.so"
    if not lib_path.exists():
        c_path = build / f"fastsim_{digest}.c"
        c_path.write_text(src)
        # Unique temp then atomic replace: concurrent builders (parallel
        # sweep workers) race benignly to the same content-addressed name.
        tmp = build / f".fastsim_{digest}.{os.getpid()}.so"
        cc = os.environ.get("CC", "cc")
        subprocess.run(
            [cc, "-O2", "-fPIC", "-shared", "-ffp-contract=off",
             "-o", str(tmp), str(c_path), "-lm"],
            check=True, capture_output=True)
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path))


def native_advance():
    """Build (or load) the C engine; return ``advance(S) -> exit code``.

    Raises on any failure (no compiler, sandboxed tmp, bad toolchain);
    :mod:`repro.core.fastsim` treats that as "native backend absent" and
    falls back to the twin.
    """
    lib = _build_library()
    fn = lib.fs_advance
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_void_p] * 31

    _addressof = ctypes.addressof
    _from_buffer = ctypes.c_char.from_buffer
    # Pointer cache keyed by state-tuple identity: a numpy array's data
    # pointer is fixed for its lifetime, and an identical tuple object
    # means identical arrays — the chunk runner's reused scratch state
    # (fastsim staging prototype) hits this on every sibling cell.  The
    # entry holds the tuple itself, so a recycled id can never alias.
    cache: dict = {}

    def adv(S):
        entry = cache.get(id(S))
        if entry is not None and entry[0] is S:
            return fn(*entry[1])
        # addressof(c_char.from_buffer(a)) is the cheapest stable route to
        # a.ctypes.data (~4x less overhead: no per-array ctypes interface
        # object, no __array_interface__ dict) — 31 arrays, once per
        # simulation, so this is on the per-cell floor of tiny sweeps.
        ptrs = [_addressof(_from_buffer(arr)) for arr in S]
        if len(cache) >= 8:
            cache.clear()
        cache[id(S)] = (S, ptrs)
        return fn(*ptrs)

    return adv
