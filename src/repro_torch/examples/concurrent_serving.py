"""Concurrent serving under preemptive SRTF vs FIFO — the paper's headline
scenario on the port's real model computation.

A long decode job (many chunks) is already running when a short job
arrives.  FIFO serializes the short job behind the long one; SRTF samples
the newcomer's first chunk on one lane (structural runtime prediction),
learns it is shorter, and hands the machine over — preempting only at
chunk boundaries, exactly like the paper's thread-block-granular
preemption.

Full width on ``cuda`` unless asked otherwise (no fallback)::

    PYTHONPATH=src python -m repro_torch.examples.concurrent_serving
    PYTHONPATH=src python -m repro_torch.examples.concurrent_serving \\
        --device cpu --reduced
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

from .. import resolve_device
from ..configs import get_arch
from ..core.executor import LaneExecutor
from ..core.jobs import make_serve_job
from ..core.metrics import WorkloadMetrics, evaluate
from ..core.policies import make_policy
from ..launch.serve import release_device_memory

LANES = 4


def build(reduced: bool, device):
    def cfg(arch_id: str):
        c = get_arch(arch_id)
        return c.reduced() if reduced else c

    return [
        make_serve_job(cfg("minicpm3-4b"), "long-job",
                       blocks=40, tokens_per_block=16, batch=2,
                       prompt_len=16, max_residency=LANES, seed=0,
                       device=device),
        make_serve_job(cfg("yi-6b"), "short-job",
                       blocks=5, tokens_per_block=16, batch=2,
                       prompt_len=16, max_residency=LANES,
                       arrival=0.01, seed=1, device=device),
    ]


def solo_runtimes(reduced: bool, device) -> Dict[str, float]:
    out = {}
    for job in build(reduced, device):
        res = LaneExecutor([job], make_policy("fifo"), n_lanes=LANES).run()
        out[job.name] = next(iter(res.values())).turnaround
        del job, res
        release_device_memory(device)
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, WorkloadMetrics]:
    """Run the example; returns each policy's metrics."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless asked; no fallback)")
    ap.add_argument("--reduced", action="store_true",
                    help="the archs' reduced configs instead of full width")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    solo = solo_runtimes(args.reduced, device)
    print(f"solo runtimes: " +
          ", ".join(f"{k}={v:.2f}s" for k, v in solo.items()))
    out = {}
    for policy in ("fifo", "srtf", "srtf-adaptive"):
        ex = LaneExecutor(build(args.reduced, device), make_policy(policy),
                          n_lanes=LANES)
        ex.oracle_runtimes.update(solo)
        results = ex.run()
        ta = {k: r.turnaround for k, r in results.items()}
        m = out[policy] = evaluate(
            ta, {k: solo[k.rsplit("#", 1)[0]] for k in ta})
        detail = ", ".join(f"{k}={v:.2f}s" for k, v in sorted(ta.items()))
        print(f"{policy:14s} STP={m.stp:.2f} ANTT={m.antt:.2f} "
              f"fairness={m.fairness:.2f}   [{detail}]")
        del ex, results
        release_device_memory(device)
    print("\nExpected: SRTF rescues the short job's turnaround at a tiny "
          "cost to the long job (paper Fig. 12 / Table 5).")
    return out


if __name__ == "__main__":
    main()
