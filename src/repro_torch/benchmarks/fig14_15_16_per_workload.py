"""Figures 14/15/16: per-workload STP, ANTT and fairness for all policies.

Summarised here as win counts and extremes (the full 56-row sweep is the
same cached :class:`~repro_torch.core.sweep.SweepResult` the Table 5 benchmark
renders).  Paper: SRTF outperforms other non-SJF schedulers in nearly all
workloads; worst FIFO ANTT is 425 (for SHA1+JPEG); MPMax's worst ANTT is
~10 because its reservations avoid hand-off delay.
"""

from .common import TABLE5_POLICIES, table5_sweep


def run():
    sweep = table5_sweep()
    names = [n for n, _ in sweep["fifo"]]
    rows = []
    # Fig. 14: how often SRTF is the best realizable policy on STP.
    realizable = [p for p in TABLE5_POLICIES if p != "sjf"]
    srtf_best = 0
    for i in range(len(names)):
        best = max(realizable, key=lambda p: sweep[p][i][1].stp)
        if best in ("srtf", "srtf-adaptive"):
            srtf_best += 1
    rows.append(("fig14.srtf_best_stp_count", f"{srtf_best}/{len(names)}"))
    # Fig. 15: worst-case ANTT per policy.
    for pol in TABLE5_POLICIES:
        worst = max(sweep[pol], key=lambda r: r[1].antt)
        rows.append((f"fig15.worst_antt.{pol}",
                     f"{worst[1].antt:.1f}@{worst[0]}"))
    # Fig. 16: count of workloads where Adaptive is (within ties) the
    # fairest realizable policy, and where sharing changed the outcome.
    adaptive_fairest = sharing_changed = 0
    for i in range(len(names)):
        f_ad = sweep["srtf-adaptive"][i][1].fairness
        best_other = max(sweep[p][i][1].fairness for p in realizable
                         if p != "srtf-adaptive")
        if f_ad >= best_other - 1e-9:
            adaptive_fairest += 1
        if f_ad > sweep["srtf"][i][1].fairness + 1e-9:
            sharing_changed += 1
    rows.append(("fig16.adaptive_fairest_count",
                 f"{adaptive_fairest}/{len(names)} (paper 34/56)"))
    rows.append(("fig16.sharing_improved_fairness_count",
                 f"{sharing_changed}/{len(names)} (paper: 35/56 ran shared)"))
    rows.append(("fig15.paper", "FIFO worst ~425 (SHA1+JPEG); MPMAX worst ~10"))
    return rows
