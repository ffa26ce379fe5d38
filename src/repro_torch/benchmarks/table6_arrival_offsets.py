"""Table 6: sensitivity to arrival time — the second kernel arrives after
25% / 50% of the first kernel's solo runtime.

Paper (25%): FIFO 1.44/2.74/0.27, MPMAX 1.45/2.05/0.38, SRTF 1.62/1.60/0.53,
ADAPTIVE 1.56/1.65/0.56.  (50%): FIFO 1.48/2.36/0.32, MPMAX 1.49/1.93/0.40,
SRTF 1.63/1.56/0.55, ADAPTIVE 1.59/1.58/0.59.  Gaps shrink as kernels start
farther apart.

Both offset grids are one :class:`~repro_torch.core.sweep.SweepSpec` over two
``table6-offset`` scenarios (offsets computed from the simulator-measured
solo runtimes), executed by the cached parallel sweep runner.
"""

from ..core.metrics import summarize
from ..core.scenarios import Table6Offset

from .common import SEED, metric_row, solo_runtimes, sweep

POLICIES = ("fifo", "mpmax", "srtf", "srtf-adaptive")
FRACTIONS = (0.25, 0.50)


def run():
    solo = solo_runtimes(SEED)
    scenarios = tuple(
        Table6Offset(seed=SEED, offset_fraction=frac, solo=solo)
        for frac in FRACTIONS)
    result = sweep(scenarios, POLICIES)
    rows = []
    for scn in scenarios:
        for pol in POLICIES:
            cells = [c for c in result.select(policy=pol)
                     if c.workload.endswith(scn.suffix)]
            ms = [c.metrics for c in cells if c.metrics is not None]
            rows.append(metric_row(
                f"table6.offset{scn.suffix.lstrip('@')}.{pol}",
                summarize(ms)))
    rows.append(("table6.paper",
                 "25%: srtf 1.62/1.60/0.53; 50%: srtf 1.63/1.56/0.55; gaps shrink"))
    return rows
