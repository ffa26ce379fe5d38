"""Figure 11: accuracy of the Simple Slicing predictor.

Groups (paper Section 4.2):
* single-gpu  — solo runs with hardware-like effects (stagger/startup on),
* single-sim  — solo runs with simulator-like behaviour (stagger off; the
  paper notes staggered executions were absent in GPGPU-Sim),
* mpmax       — two-program workloads under JIT-MPMax; accuracy of the first
  prediction of the *last slice* (after the co-runner ends), in both
  slice-aware ("/SS") and slice-unaware modes.

Predictions are per-SM Eq. 2 outputs normalized to the per-SM actual runtime
(first block start to last block end on that SM).
Paper: single-gpu within 0.48x-1.08x; mpmax majority within 0.5x-2x with SS
correcting the slice-unaware underestimates.
"""

import numpy as np

from ..core.policies import make_policy
from ..core.simulator import simulate
from ..core.workload import (
    ERCBENCH,
    Arrival,
    scaled_spec,
    two_program_workloads,
)


def _per_sm_actual(trace, key):
    spans = {}
    for b in trace:
        if b.kernel != key:
            continue
        s, e = spans.get(b.sm, (b.start, b.end))
        spans[b.sm] = (min(s, b.start), max(e, b.end))
    return {sm: e - s for sm, (s, e) in spans.items()}


def _solo_group(stagger: bool):
    norms = []
    for name, spec in ERCBENCH.items():
        if not stagger:
            spec = scaled_spec(spec, stagger_frac=0.0, stagger_sm_prob=0.0)
        res = simulate([Arrival(spec, 0.0, uid="k#0")],
                       lambda: make_policy("fifo"), seed=0,
                       record_trace=True, record_predictions=True)
        actual = _per_sm_actual(res.sim.trace, "k#0")
        first = {}
        for p in res.sim.predictions:
            first.setdefault(p.sm, p.predicted_total)
        for sm, pred in first.items():
            if sm in actual and actual[sm] > 0:
                norms.append(pred / actual[sm])
    return np.array(norms)


def _mpmax_group(max_workloads: int = 24):
    aware, unaware = [], []
    for _, wl in two_program_workloads()[:max_workloads]:
        res = simulate(wl, lambda: make_policy("mpmax"), seed=0,
                       record_trace=True, record_predictions=True)
        # kernel that finishes last + the other's end time (slice boundary)
        keys = sorted(res.finish, key=res.finish.get)
        first_end, last_key = res.finish[keys[0]], keys[1]
        actual = _per_sm_actual(res.sim.trace, last_key)
        first_after, first_ever = {}, {}
        for p in res.sim.predictions:
            if p.kernel != last_key:
                continue
            first_ever.setdefault(p.sm, p.predicted_total)
            if p.time > first_end:
                first_after.setdefault(p.sm, p.predicted_total)
        for sm, pred in first_after.items():
            if sm in actual and actual[sm] > 0:
                aware.append(pred / actual[sm])
        for sm, pred in first_ever.items():
            if sm in actual and actual[sm] > 0:
                unaware.append(pred / actual[sm])
    return np.array(aware), np.array(unaware)


def _q(a: np.ndarray) -> str:
    if len(a) == 0:
        return "n=0"
    return (f"min={a.min():.2f};q1={np.percentile(a,25):.2f};"
            f"med={np.median(a):.2f};q3={np.percentile(a,75):.2f};"
            f"max={a.max():.2f};n={len(a)}")


def run():
    gpu = _solo_group(stagger=True)
    sim = _solo_group(stagger=False)
    aware, unaware = _mpmax_group()
    frac_2x = float(np.mean((aware > 0.5) & (aware < 2.0))) if len(aware) else 0.0
    return [
        ("fig11.single_gpu", _q(gpu)),
        ("fig11.single_sim", _q(sim)),
        ("fig11.mpmax_ss", _q(aware)),
        ("fig11.mpmax_slice_unaware", _q(unaware)),
        ("fig11.mpmax_ss_frac_within_2x", f"{frac_2x:.2f}"),
        ("fig11.paper", "single-gpu 0.48-1.08; mpmax majority within 0.5-2.0"),
    ]
