"""Closed-loop load-vs-latency curves (ours, beyond the paper's grid).

The paper evaluates fixed two-program arrivals; these rows put
FIFO/SRTF/SRTF-Adaptive under *completion-driven* traffic — the regime
where SRTF's win over FIFO should widen (short kernels overtaking long
queues) or collapse (prediction error under churn), which no fixed-arrival
sweep can show:

* ``closedloop.mgk.*`` — M/G/k-style offered load with a bounded
  population (``mgk-closed``), swept across three offered-load points
  (mean interarrival shrinking heavy -> saturated).  Each row reports the
  steady-state queueing view: warmup-trimmed mean/p95 response time
  (cycles), time-averaged number in system, throughput (kernels per
  Mcycle), plus machine utilization — geometric means across workloads
  and seeds.
* ``closedloop.think.*`` — the ``think-time`` tenant loop at the same
  policies: offered load tracks service capacity by construction.

All cells run through :mod:`repro_torch.core.sweep` — closed-loop cells are
cached by (process params, seed), so warm reruns are second-scale.
"""

from ..core.metrics import MetricsError, geomean
from ..core.scenarios import MGkClosed, ThinkTime

from .common import SEED, sweep

POLICIES = ("fifo", "srtf", "srtf-adaptive")

#: Short-kernel mix keeps per-cell DES cost modest (same mix as the
#: open-loop scenario rows).
SHORT_MIX = ("AES-d", "AES-e", "JPEG-d", "JPEG-e", "SGEMM", "CUTCP")

#: Offered-load points: mean interarrival in cycles, light -> heavy.
LOAD_POINTS = (120_000.0, 60_000.0, 30_000.0)

SEEDS = (0, 1)

#: Horizon: long enough that moderate loads drain, heavy load stays
#: honestly truncated (unfinished kernels reported).
UNTIL = 3_000_000.0

WARMUP_FRAC = 0.1


def _mgk_scenarios():
    return tuple(
        MGkClosed(seed=SEED, names=SHORT_MIX, n_total=10,
                  mean_interarrival=ia, population=4, n_workloads=2,
                  tag=f"@{int(ia / 1000)}k")
        for ia in LOAD_POINTS)


def _think_scenario():
    return ThinkTime(seed=SEED, names=SHORT_MIX, n_tenants=4,
                     mean_think=50_000.0, n_rounds=3, n_workloads=2)


def _rows(cells_of, label):
    rows = []
    for pol in POLICIES:
        cells = cells_of(pol)
        qs = []
        for c in cells:
            try:
                qs.append(c.queueing(WARMUP_FRAC))
            except MetricsError:
                pass  # nothing completed post-warmup in this cell
        util = geomean([max(c.window.utilization, 1e-9) for c in cells])
        unfinished = sum(c.window.n_unfinished for c in cells)
        if qs:
            mean_rt = geomean([q.mean_response for q in qs])
            p95_rt = geomean([q.p95_response for q in qs])
            in_sys = geomean([max(q.mean_in_system, 1e-9) for q in qs])
            xput = geomean([max(q.throughput, 1e-12) for q in qs]) * 1e6
            derived = (f"mean_rt={mean_rt:.0f};p95_rt={p95_rt:.0f};"
                       f"in_system={in_sys:.2f};xput_per_Mcyc={xput:.2f};"
                       f"util={util:.2f};unfinished={unfinished}")
        else:
            derived = (f"util={util:.2f};unfinished={unfinished} "
                       "(none completed post-warmup)")
        rows.append((f"{label}.{pol}", derived))
    return rows


def run():
    mgk = _mgk_scenarios()
    think = _think_scenario()
    result = sweep(mgk + (think,), POLICIES, seeds=SEEDS, until=UNTIL)
    rows = []
    for scn, ia in zip(mgk, LOAD_POINTS):
        prefix = f"mgk{scn.tag}."
        rows += _rows(
            lambda pol, prefix=prefix: [
                c for c in result.select(policy=pol)
                if c.workload.startswith(prefix)],
            f"closedloop.mgk.ia{int(ia / 1000)}k")
    rows += _rows(
        lambda pol: result.select(scenario=think.name, policy=pol),
        "closedloop.think")
    rows.append(("closedloop.note",
                 f"response times in cycles, warmup_frac={WARMUP_FRAC}, "
                 f"geomeans across workloads x seeds {SEEDS}; offered "
                 f"load rises left to right (ia {LOAD_POINTS} cycles)"))
    return rows
