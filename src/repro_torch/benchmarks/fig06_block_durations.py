"""Figure 6: distribution of thread block durations (t) normalized to the
kernel's mean — most kernels are near-uniform; RayTracing's render is the
value-dependent outlier (paper: max 4x the mean).
"""

import numpy as np

from ..core.policies import make_policy
from ..core.simulator import simulate
from ..core.workload import ERCBENCH, Arrival


def run():
    rows = []
    for name, spec in ERCBENCH.items():
        res = simulate([Arrival(spec, 0.0, uid="k#0")],
                       lambda: make_policy("fifo"), seed=0, record_trace=True)
        d = np.array([b.end - b.start for b in res.sim.trace])
        d = d / d.mean()
        rows.append((
            f"fig06.t_over_mean.{name}",
            f"q1={np.percentile(d,25):.2f};med={np.median(d):.2f};"
            f"q3={np.percentile(d,75):.2f};max={d.max():.2f}",
        ))
    rows.append(("fig06.paper",
                 "majority within 0.95-1.1 of mean; render max ~4x"))
    return rows
