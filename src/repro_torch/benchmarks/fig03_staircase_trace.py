"""Figures 3 and 5: staircase execution of an SGEMM-like kernel on one SM.

Fig. 3 (clean staircase): the linear fit to block end times slightly
overestimates the finish time while the Eq. 1 staircase prediction (using the
first finishing block's duration) slightly underestimates it
(paper: +4.8% / -6.04%).

Fig. 5 (staggered SM): staggered first-wave starts make direct application of
Eq. 1 a gross underestimate while the execution remains linear.
"""

import numpy as np

from ..core.policies import make_policy
from ..core.predictor import staircase_runtime
from ..core.simulator import simulate
from ..core.workload import PARBOIL2_LIKE, Arrival, KernelSpec, scaled_spec

from .common import linear_fit_end_prediction


def _trace_one_sm(spec: KernelSpec, sm: int = 0):
    res = simulate([Arrival(spec, 0.0, uid="k#0")],
                   lambda: make_policy("fifo"), n_sm=15, seed=3,
                   record_trace=True)
    blocks = sorted((b for b in res.sim.trace if b.sm == sm),
                    key=lambda b: b.end)
    ends = np.array([b.end for b in blocks])
    first_duration = min(b.end - b.start for b in blocks[: spec.max_residency])
    actual = ends[-1]
    eq1 = staircase_runtime(len(blocks), spec.max_residency, first_duration)
    linfit = linear_fit_end_prediction(ends)
    return actual, eq1, linfit


def run():
    base = PARBOIL2_LIKE["SGEMM"]
    actual, eq1, linfit = _trace_one_sm(base)
    rows = [
        ("fig03.sgemm.linfit_err_pct", f"{100 * (linfit - actual) / actual:+.2f}"),
        ("fig03.sgemm.staircase_err_pct", f"{100 * (eq1 - actual) / actual:+.2f}"),
        ("fig03.paper", "linfit=+4.8;staircase=-6.04"),
    ]
    # Fig. 5: same kernel with staggered first-wave starts on every SM.
    staggered = scaled_spec(base, name="SGEMM-staggered",
                            stagger_frac=0.6, stagger_sm_prob=1.0)
    actual_s, eq1_s, linfit_s = _trace_one_sm(staggered)
    rows += [
        ("fig05.staggered.staircase_norm", f"{eq1_s / actual_s:.3f}"),
        ("fig05.staggered.linfit_norm", f"{linfit_s / actual_s:.3f}"),
        ("fig05.paper", "staircase underestimates (<0.9); linear fit stays accurate"),
    ]
    return rows
