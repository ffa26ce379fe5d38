"""Figure 4: normalized predictions (prediction / actual) from the linear
regression model and the Eq. 1 staircase model, per SM, for ERCBench and
Parboil2-like kernels.

Paper (Fermi): linreg within 0.99x-1.11x (ERCBench) and 0.87x-1.13x
(Parboil2); Eq. 1 within 0.54x-1.18x (ERCBench) and 0.39x-1.49x (Parboil2),
with staggered/startup kernels supplying the outliers.
"""

import numpy as np

from ..core.policies import make_policy
from ..core.predictor import staircase_runtime
from ..core.simulator import simulate
from ..core.workload import ERCBENCH, PARBOIL2_LIKE, Arrival, KernelSpec

from .common import linear_fit_end_prediction


def _normalized_predictions(spec: KernelSpec, n_sm: int = 15, seed: int = 0):
    res = simulate([Arrival(spec, 0.0, uid="k#0")],
                   lambda: make_policy("fifo"), n_sm=n_sm, seed=seed,
                   record_trace=True)
    eq1_norm, lin_norm = [], []
    for sm in range(n_sm):
        blocks = sorted((b for b in res.sim.trace if b.sm == sm),
                        key=lambda b: b.end)
        if len(blocks) < 2:
            continue
        ends = np.array([b.end for b in blocks])
        actual = ends[-1]
        # Eq. 1 with t = duration of the first *finishing* block on this SM.
        first = min(blocks, key=lambda b: b.end)
        t = first.end - first.start
        eq1 = staircase_runtime(len(blocks), spec.max_residency, t)
        eq1_norm.append(eq1 / actual)
        lin_norm.append(linear_fit_end_prediction(ends) / actual)
    return eq1_norm, lin_norm


def _suite_stats(specs):
    eq1_all, lin_all = [], []
    for spec in specs:
        e, lin = _normalized_predictions(spec)
        eq1_all += e
        lin_all += lin
    def q(v):
        a = np.array(v)
        return (f"min={a.min():.2f};q1={np.percentile(a,25):.2f};"
                f"med={np.median(a):.2f};q3={np.percentile(a,75):.2f};"
                f"max={a.max():.2f};n={len(a)}")
    return q(eq1_all), q(lin_all)


def run():
    erc = list(ERCBENCH.values())
    parboil = list(PARBOIL2_LIKE.values())
    erc_eq1, erc_lin = _suite_stats(erc)
    pb_eq1, pb_lin = _suite_stats(parboil)
    return [
        ("fig04.ercbench.eq1_normalized", erc_eq1),
        ("fig04.ercbench.linreg_normalized", erc_lin),
        ("fig04.parboil2like.eq1_normalized", pb_eq1),
        ("fig04.parboil2like.linreg_normalized", pb_lin),
        ("fig04.paper", "erc eq1 0.54-1.18, linreg 0.99-1.11; parboil eq1 0.39-1.49"),
    ]
