"""Figures 7 and 8: effect of residency on block duration and total runtime.

t is smallest at residency 1 and grows with residency (Fig. 7), while total
runtime *decreases* and saturates as residency rises (Fig. 8) — the increase
in t is offset by the throughput of more resident blocks.
"""

from ..core.policies import make_policy
from ..core.simulator import solo_runtime
from ..core.workload import ERCBENCH


def run():
    rows = []
    for name in ("AES-e", "SHA1", "ImageDenoising-nlm2", "RayTracing"):
        spec = ERCBENCH[name]
        t1 = spec.base_t(1)
        rt1 = solo_runtime(spec, lambda: make_policy("fifo-cap", cap=1), seed=0)
        t_curve, rt_curve = [], []
        for r in range(1, spec.max_residency + 1):
            t_curve.append(spec.base_t(r) / t1)
            rt = solo_runtime(spec,
                              lambda r=r: make_policy("fifo-cap", cap=r),
                              seed=0)
            rt_curve.append(rt / rt1)
        rows.append((f"fig07.t_vs_residency.{name}",
                     ";".join(f"{v:.2f}" for v in t_curve)))
        rows.append((f"fig08.runtime_vs_residency.{name}",
                     ";".join(f"{v:.2f}" for v in rt_curve)))
    rows.append(("fig07.paper", "t rises with residency (up to ~1.5-4x)"))
    rows.append(("fig08.paper", "runtime falls and saturates with residency"))
    return rows
