"""Open-loop and N-program scenario rows (ours, beyond the paper's grid).

The paper evaluates closed two-program workloads; the scenarios the
production story cares about — shared-cloud Poisson kernel streams
(Kernelet-style), bursty many-kernel DL traffic, N-program mixes, replayed
traces — come from the scenario registry and run under every Table-5
policy from a single :class:`~repro_torch.core.sweep.SweepSpec`.  Rows report
completion-window STP/ANTT/fairness (finished kernels), plus machine
utilization and unfinished counts: open-loop results with kernels still
in flight are first-class.
"""

from ..core.metrics import geomean
from ..core.scenarios import Bursty, NProgramMix, PoissonOpen, TraceReplay

from .common import SEED, sweep

POLICIES = ("fifo", "mpmax", "srtf", "srtf-adaptive", "sjf")

#: Short-kernel mix keeps the DES cost of the stream rows modest.
SHORT_MIX = ("AES-d", "AES-e", "JPEG-d", "JPEG-e", "SGEMM", "CUTCP")

#: A hand-written replay trace: a burst of three short kernels while a
#: medium kernel is mid-flight, then a straggler.
SAMPLE_TRACE = [
    {"kernel": "SGEMM", "time": 0.0},
    {"kernel": "JPEG-d", "time": 50_000.0},
    {"kernel": "JPEG-e", "time": 52_000.0},
    {"kernel": "AES-d", "time": 54_000.0},
    {"kernel": "CUTCP", "time": 400_000.0},
]


def _scenarios():
    return (
        PoissonOpen(seed=SEED, names=SHORT_MIX, n_arrivals=6,
                    mean_interarrival=80_000.0, n_workloads=2),
        Bursty(seed=SEED, names=SHORT_MIX, n_bursts=2, max_burst=4,
               n_workloads=2),
        NProgramMix(seed=SEED, names=SHORT_MIX, n_programs=4,
                    n_workloads=3),
        TraceReplay(trace=SAMPLE_TRACE, name="sample"),
    )


def run():
    scenarios = _scenarios()
    # One spec, every scenario x policy; 1.2M-cycle horizon keeps the
    # open-loop streams honestly truncated (unfinished kernels reported).
    result = sweep(scenarios, POLICIES, until=1_200_000.0)
    rows = []
    for scn in scenarios:
        for pol in POLICIES:
            cells = result.select(scenario=scn.name, policy=pol)
            ms = [c.metrics for c in cells if c.metrics is not None]
            util = geomean([max(c.window.utilization, 1e-9) for c in cells])
            unfinished = sum(c.window.n_unfinished for c in cells)
            if ms:
                stp = geomean(m.stp for m in ms)
                antt = geomean(m.antt for m in ms)
                fair = geomean(m.fairness for m in ms)
                derived = (f"stp={stp:.2f};antt={antt:.2f};fair={fair:.2f};"
                           f"util={util:.2f};unfinished={unfinished}")
            else:
                derived = f"util={util:.2f};unfinished={unfinished} (none finished)"
            rows.append((f"scenarios.{scn.name}.{pol}", derived))
    rows.append(("scenarios.note",
                 "completion-window metrics over finished kernels; "
                 "open-loop streams truncated at 1.2M cycles"))
    return rows
