"""Pod-fleet scheduling at scale: 200 jobs on a 960-lane cluster.

Uses the discrete-event core (same predictor + policies as everywhere else)
to schedule a Poisson stream of heterogeneous jobs over a large machine —
the 1000-node deployment story.  Reports STP/ANTT/fairness and p50/p99
turnaround under FIFO / MPMax / SRTF / SRTF-Adaptive.

Run:  PYTHONPATH=src python -m repro_torch.examples.cluster_sim [--jobs 200]
"""

import argparse

import numpy as np

from ..core.metrics import evaluate
from ..core.policies import make_policy
from ..core.simulator import simulate
from ..core.workload import MAX_BLOCK_SLOTS, Arrival, KernelSpec

#: job archetypes (blocks ~ steps, mean_t ~ step seconds in "cycles")
ARCHETYPES = [
    ("finetune-small", dict(num_blocks=240, max_residency=8,
                            threads_per_block=64, mean_t=2e4, rsd=0.08)),
    ("pretrain-chunk", dict(num_blocks=2400, max_residency=8,
                            threads_per_block=64, mean_t=6e4, rsd=0.05)),
    ("batch-inference", dict(num_blocks=96, max_residency=8,
                             threads_per_block=64, mean_t=8e3, rsd=0.25)),
    ("eval-sweep", dict(num_blocks=480, max_residency=8,
                        threads_per_block=64, mean_t=1.5e4, rsd=0.1)),
]


def build_workload(n_jobs: int, seed: int):
    rng = np.random.default_rng(seed)
    arrivals = []
    t = 0.0
    for i in range(n_jobs):
        t += rng.exponential(3e4)                 # Poisson arrivals
        name, kw = ARCHETYPES[rng.integers(len(ARCHETYPES))]
        spec = KernelSpec(name=f"{name}", **kw)
        arrivals.append(Arrival(spec, t, uid=f"{name}#{i}"))
    return arrivals


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=200)
    ap.add_argument("--lanes", type=int, default=960,
                    help="total lanes = n_sm * slots (120 SMs x 8)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    n_sm = max(1, args.lanes // MAX_BLOCK_SLOTS)

    workload = build_workload(args.jobs, args.seed)
    # solo runtimes (oracle + normalization)
    solo = {}
    for arr in workload:
        if arr.spec.name not in solo:
            res = simulate([Arrival(arr.spec, 0.0, uid="solo#0")],
                           lambda: make_policy("fifo"), n_sm=n_sm,
                           seed=args.seed)
            solo[arr.spec.name] = res.turnaround["solo#0"]

    print(f"cluster: {n_sm} execution units x {MAX_BLOCK_SLOTS} slots "
          f"= {n_sm * MAX_BLOCK_SLOTS} lanes; {args.jobs} jobs")
    for policy in ("fifo", "mpmax", "srtf", "srtf-adaptive"):
        res = simulate(workload, lambda p=policy: make_policy(p),
                       n_sm=n_sm, seed=args.seed, oracle_runtimes=solo)
        ta = res.turnaround
        solo_map = {k: solo[res.name[k]] for k in ta}
        m = evaluate(ta, solo_map)
        sd = sorted(ta[k] / solo_map[k] for k in ta)
        p50 = sd[len(sd) // 2]
        p99 = sd[int(len(sd) * 0.99)]
        print(f"{policy:14s} STP={m.stp:7.2f} ANTT={m.antt:6.2f} "
              f"fair={m.fairness:.3f}  slowdown p50={p50:5.2f} p99={p99:7.2f}")
    print("\nSRTF keeps p99 slowdown bounded as load rises; FIFO's p99 "
          "explodes when short jobs queue behind pretrain chunks.")


if __name__ == "__main__":
    main()
