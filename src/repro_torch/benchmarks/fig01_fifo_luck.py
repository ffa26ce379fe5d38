"""Figure 1: STP under SJF / FIFO / LJF for the 28 alphabetical-order
two-program workloads — FIFO's performance is an artefact of arrival order.

Paper values (geomean STP): SJF 1.82, FIFO 1.58, LJF 1.16; FIFO matches SJF
for 17/28 workloads and LJF for 8/28.

A thin view over the shared Table-5 sweep (``common.table5_result``): the
28 alphabetical A+B workloads are exactly the pair-stagger cells whose
first kernel sorts before the second, and the sweep already carries the
LJF cells, so this figure costs nothing on a warm cache.
"""

from ..core.metrics import geomean

from .common import table5_result


def _alphabetical(cells):
    out = []
    for c in cells:
        a, b = c.workload.split("+", 1)
        if a < b:
            out.append(c)
    return out


def run():
    result = table5_result()
    stp = {}
    for pol in ("sjf", "fifo", "ljf"):
        cells = _alphabetical(result.select(policy=pol))
        stp[pol] = [c.metrics.stp for c in cells]
    agree_sjf = agree_ljf = neutral = 0
    for s, f, lj in zip(stp["sjf"], stp["fifo"], stp["ljf"]):
        ds, dl = abs(f - s), abs(f - lj)
        if abs(s - lj) < 0.02:
            neutral += 1
        elif ds <= dl:
            agree_sjf += 1
        else:
            agree_ljf += 1
    rows = [(f"fig01.stp_geomean.{p}", f"{geomean(v):.3f}")
            for p, v in stp.items()]
    rows.append(("fig01.fifo_matches",
                 f"sjf={agree_sjf};ljf={agree_ljf};neutral={neutral}"))
    rows.append(("fig01.paper", "sjf=1.82;fifo=1.58;ljf=1.16;matches=17/8/3"))
    return rows
