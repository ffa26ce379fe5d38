"""Concurrent serving driver of the port (``repro.launch.serve``).

Decode jobs (request batches with different generation lengths) share the
device under a thread-block-style scheduling policy.  Jobs are submitted
asynchronously through :class:`repro_torch.core.scheduler_service.
SchedulerService`, each ``--stagger`` seconds after the previous one while
the device is already running.  The structural predictor profiles each
job's first decode chunk and SRTF runs the predicted-shortest job first,
preempting at chunk boundaries; STP/ANTT are reported per tenant (one
tenant per arch).  ``--closed-loop N`` instead keeps N clients each with
one job in flight until ``--requests`` jobs complete, and reports the
steady-state queueing view.

Job keys are ``{arch}#{order}``, as in the JAX package.  Solo baselines are
measured once per distinct (arch, blocks) item.

Unlike the JAX driver, which always serves reduced configs, the model runs
at its full published width unless ``--reduced`` is given, on ``cuda``
unless ``--device cpu`` is.

Submission pacing comes from the scenario registry
(:mod:`repro_torch.core.scenarios`) when ``--scenario`` is given: the
named open-loop arrival process (``poisson-open``, ``bursty``, ...) is
sampled at ``--seed`` and its first workload's arrival times, scaled by
``--time-scale`` seconds a cycle, pace the submissions.  With
``--scenario-kernels`` the scenario supplies the jobs too: its first
workload's arrivals, grids capped at ``--max-blocks``, are bridged to jobs
of synthetic blocks on ``--device``
(:func:`repro_torch.core.scenarios.executor_job`, the bridge executor
sweeps use), and their solo baselines go through the content-addressed
sweep cache in ``--cache-dir``
(:func:`repro_torch.core.sweep.solo_runtime_executor_cached`, keyed by
spec, lane count and device), so a second run measures none.

The archs served are those the port's model runs, in any mix: the dense
GQA ones (yi-6b, yi-34b, mistral-nemo-12b), minicpm3-4b (MLA),
deepseek-v2-lite-16b (MLA + MoE), mamba2-2.7b, recurrentgemma-2b,
pixtral-12b, whisper-large-v3 and dbrx-132b (GQA + MoE).  A serving job
passes the model its prompt's tokens alone, as the JAX package's does:
pixtral serves its text path (no patches) and whisper its decoder, whose
cross attention is skipped without frames.  With ``--reduced`` every arch
serves on the card through the kernels (head dim 32, reduced MLA's qk 48
padded to 64 beside v 32); dbrx-132b runs only reduced, since its ~132 B
parameters (264 GB in bf16) do not fit one card.  recurrentgemma's
local-attention cache holds exactly its window (2048 positions at full
width, 64 reduced), so prompt plus generated tokens must fit in it.

Examples (the reference's default mix; a recurrent pair; pixtral beside
whisper; Poisson arrivals; scenario kernels; the reference's ``make
smoke`` serve line, reduced, on the card; MLA beside MoE on the CPU)::

    PYTHONPATH=src python -m repro_torch.launch.serve --policy srtf \
        --compare-fifo --batch 4 --prompt-len 1024 --tokens-per-block 8
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --jobs mamba2-2.7b:8,recurrentgemma-2b:2 --policy srtf \
        --compare-fifo --batch 4 --prompt-len 1024 --tokens-per-block 8
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --jobs pixtral-12b:8,whisper-large-v3:2 --policy srtf \
        --compare-fifo --batch 4 --prompt-len 1024 --tokens-per-block 8
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --jobs yi-6b:8,minicpm3-4b:4,yi-6b:8 --scenario poisson-open \
        --time-scale 1e-6 --policy srtf --compare-fifo --batch 4 \
        --prompt-len 1024 --tokens-per-block 8
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --scenario poisson-open --scenario-kernels --time-scale 1e-6 \
        --policy srtf --compare-fifo
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --jobs yi-6b:4,minicpm3-4b:2 --policy srtf --compare-fifo \
        --tokens-per-block 4 --prompt-len 8 --batch 1
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --reduced --jobs minicpm3-4b:4,deepseek-v2-lite-16b:2 \
        --policy srtf --compare-fifo --tokens-per-block 4 --prompt-len 8 \
        --batch 1
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_arch
from ..core.executor import LaneExecutor
from ..core.jobs import make_serve_job
from ..core.metrics import evaluate, evaluate_queueing
from ..core.policies import make_policy
from ..core.scenarios import (
    executor_job,
    make_scenario,
    open_loop_names,
    submission_offsets,
)
from ..core.scheduler_service import SchedulerService
from ..core.sweep import solo_runtime_executor_cached
from ..core.workload import Arrival, scaled_spec


def parse_jobs(args) -> List[Tuple[str, int]]:
    out = []
    for item in args.jobs.split(","):
        arch_id, _, blocks = item.partition(":")
        out.append((arch_id, int(blocks or 8)))
    return out


def build_job(args, arch_id: str, blocks: int, seed: int):
    cfg = get_arch(arch_id)
    return make_serve_job(
        cfg.reduced() if args.reduced else cfg, arch_id, blocks=blocks,
        tokens_per_block=args.tokens_per_block, batch=args.batch,
        prompt_len=args.prompt_len, max_residency=args.lanes,
        seed=seed, tenant=arch_id, device=args.device)


def release_device_memory(device: torch.device) -> None:
    """Free the memory of a finished run before the next one starts.

    The executor keeps every job (and so its weights and caches) until it
    is dropped, and it forms a reference cycle with its scheduling core, so
    only a collection frees a finished run's memory."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def scenario_arrivals(args) -> List[Arrival]:
    """First-workload arrivals of the ``--scenario`` arrival process, grids
    capped at ``--max-blocks`` (0: uncapped).  Scenario specs declare
    simulator-scale grids (thousands of blocks) and every bridged block is
    a real measured execution; the cap rescales ``num_blocks`` only."""
    scn = make_scenario(args.scenario, seed=args.seed)
    workloads = scn.workloads()
    if not workloads:
        raise ValueError(f"scenario {scn.name!r} produced no workloads")
    arrivals = workloads[0][1]
    cap = args.max_blocks
    if cap:
        arrivals = [
            Arrival(scaled_spec(a.spec,
                                num_blocks=min(a.spec.num_blocks, cap)),
                    a.time, uid=a.uid)
            for a in arrivals
        ]
    return arrivals


def measure_solo(args) -> Dict[object, float]:
    """Measured isolated runtime per distinct (arch, blocks) item — the
    STP/ANTT baseline, measured once and reused by every policy run.

    With ``--scenario-kernels`` the baselines are keyed by the scenario's
    kernel specs and go through the sweep cache on ``--device``."""
    if args.scenario_kernels:
        return {a.spec: solo_runtime_executor_cached(
                    a.spec, n_lanes=args.lanes, cache_dir=args.cache_dir,
                    device=str(args.device))
                for a in scenario_arrivals(args)}
    solo: Dict[object, float] = {}
    for arch_id, blocks in parse_jobs(args):
        if (arch_id, blocks) in solo:
            continue                  # one baseline per distinct item
        job = build_job(args, arch_id, blocks, args.seed)
        res = LaneExecutor([job], make_policy("fifo"),
                           n_lanes=args.lanes).run()
        solo[(arch_id, blocks)] = next(iter(res.values())).turnaround
        del job, res
        release_device_memory(args.device)
    return solo


def print_tenant_report(service: SchedulerService) -> None:
    for tenant, info in sorted(service.tenant_report().items()):
        tm = info["metrics"]
        if tm is not None:
            print(f"    tenant={tenant}: jobs={info['jobs']} "
                  f"STP={tm['stp']:.3f} ANTT={tm['antt']:.3f}")


def submission_schedule(args) -> List[float]:
    """Per-job submission offsets (seconds since the first submission): a
    fixed ``--stagger`` gap, or with ``--scenario`` the named arrival
    process's first-workload times scaled by ``--time-scale``."""
    n = len(parse_jobs(args))
    if not args.scenario:
        return [i * args.stagger for i in range(n)]
    return submission_offsets(args.scenario, n, time_scale=args.time_scale,
                              seed=args.seed)


def submission_plan(args, solo: Dict[object, float]
                    ) -> List[Tuple[float, Callable, str, float]]:
    """Per-submission ``(offset_s, job_factory, tenant, solo_runtime)``:
    model jobs from ``--jobs``, or with ``--scenario-kernels`` the
    scenario's arrivals bridged to synthetic jobs on ``--device``."""
    if args.scenario_kernels:
        return [
            (a.time * args.time_scale,
             lambda a=a: executor_job(a, n_lanes=args.lanes,
                                      time_scale=args.time_scale,
                                      device=args.device),
             a.spec.name, solo[a.spec])
            for a in scenario_arrivals(args)
        ]
    offsets = submission_schedule(args)
    return [
        (offsets[i],
         lambda arch_id=arch_id, blocks=blocks, i=i: build_job(
             args, arch_id, blocks, args.seed + i),
         arch_id, solo[(arch_id, blocks)])
        for i, (arch_id, blocks) in enumerate(parse_jobs(args))
    ]


async def run_service(args, policy: str, solo: Dict[object, float]):
    """One policy run: paced async submissions against a live service.
    Returns (metrics, job results)."""
    service = SchedulerService(n_lanes=args.lanes, policy=policy,
                               predictor=args.predictor)
    plan = submission_plan(args, solo)
    try:
        handles = []
        solo_by_key: Dict[str, float] = {}
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        for offset, job_factory, tenant, solo_rt in plan:
            delay = t0 + offset - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)  # late arrival, busy machine
            handle = service.submit(job_factory(), tenant=tenant,
                                    solo_runtime=solo_rt)
            solo_by_key[handle.key] = solo_rt
            handles.append(handle)
        results = [await h.result() for h in handles]
    finally:
        service.close()

    m = evaluate({r.key: r.turnaround for r in results}, solo_by_key)
    print(f"[serve] policy={policy:14s} STP={m.stp:.3f} ANTT={m.antt:.3f} "
          f"fairness={m.fairness:.3f}")
    print_tenant_report(service)
    for r in sorted(results, key=lambda r: r.key):
        print(f"    {r.key}: turnaround={r.turnaround:.2f}s "
              f"blocks={r.blocks}")
    return m, results


def closed_loop_items(args, solo: Dict[object, float]):
    """The job menu closed-loop clients cycle through: per item
    ``(make(i) -> job, tenant, solo_runtime)``.  Pacing comes from
    completions (and ``--think``), so scenario-kernel jobs are bridged at
    arrival time 0."""
    if args.scenario_kernels:
        return [
            (lambda i, a=a: executor_job(
                Arrival(a.spec, 0.0), n_lanes=args.lanes,
                time_scale=args.time_scale, device=args.device),
             a.spec.name, solo[a.spec])
            for a in scenario_arrivals(args)
        ]
    return [
        (lambda i, arch_id=arch_id, blocks=blocks: build_job(
            args, arch_id, blocks, args.seed + i),
         arch_id, solo[(arch_id, blocks)])
        for arch_id, blocks in parse_jobs(args)
    ]


async def run_service_closed_loop(args, policy: str,
                                  solo: Dict[object, float]):
    """One closed-loop policy run: ``--closed-loop`` concurrent clients,
    each looping submit -> await -> think, against a live service."""
    service = SchedulerService(n_lanes=args.lanes, policy=policy,
                               predictor=args.predictor)
    items = closed_loop_items(args, solo)
    counter = itertools.count()
    results = []
    solo_by_key: Dict[str, float] = {}

    async def client(cid: int) -> None:
        rng = np.random.default_rng((args.seed, cid))
        while True:
            i = next(counter)
            if i >= args.requests:
                return
            if args.think > 0.0:
                await asyncio.sleep(float(rng.exponential(args.think)))
            make, tenant, solo_rt = items[i % len(items)]
            handle = service.submit(make(i), tenant=tenant,
                                    solo_runtime=solo_rt)
            solo_by_key[handle.key] = solo_rt
            results.append(await handle.result())

    try:
        await asyncio.gather(
            *(client(c) for c in range(args.closed_loop)))
    finally:
        service.close()

    # Machine-time (virtual-clock) arrivals/finishes: the queueing view is
    # of the machine under load, not of wall-clock client latency.
    q = evaluate_queueing({r.key: r.arrival for r in results},
                          {r.key: r.finish for r in results},
                          end_time=service.machine_time,
                          warmup_frac=args.warmup_frac)
    m = evaluate({r.key: r.turnaround for r in results}, solo_by_key)
    print(f"[serve] policy={policy:14s} closed-loop={args.closed_loop} "
          f"requests={q.n_completed} mean_rt={q.mean_response:.3f}s "
          f"p95_rt={q.p95_response:.3f}s in_system={q.mean_in_system:.2f} "
          f"xput={q.throughput:.2f}/s")
    print(f"    STP={m.stp:.3f} ANTT={m.antt:.3f} "
          f"fairness={m.fairness:.3f}")
    print_tenant_report(service)
    return q, results


def _run(args, policy: str, solo) -> Tuple[object, list, Optional[int]]:
    """One policy run, then its memory released.  Returns (metrics, job
    results, peak device bytes or None on the CPU)."""
    cuda = args.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(args.device)
    runner = run_service_closed_loop if args.closed_loop > 0 else run_service
    metrics, results = asyncio.run(runner(args, policy, solo))
    peak = torch.cuda.max_memory_allocated(args.device) if cuda else None
    if peak is not None:
        print(f"    peak device memory: {peak / 2**30:.2f} GiB")
    release_device_memory(args.device)
    return metrics, results, peak


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--jobs", default="yi-6b:24,minicpm3-4b:6",
                    help="arch:decode_blocks,...")
    ap.add_argument("--policy", default="srtf")
    ap.add_argument("--predictor", default="simple-slicing",
                    help="registered predictor name (simple-slicing, ewma)")
    ap.add_argument("--compare-fifo", action="store_true")
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens-per-block", type=int, default=8)
    ap.add_argument("--stagger", type=float, default=0.02,
                    help="seconds between async job submissions")
    ap.add_argument("--closed-loop", type=int, default=0,
                    help="drive the service closed-loop at this target "
                         "concurrency (N clients, each resubmitting when "
                         "its job finishes; 0 = open-loop pacing)")
    ap.add_argument("--requests", type=int, default=12,
                    help="total jobs a closed-loop run completes")
    ap.add_argument("--think", type=float, default=0.0,
                    help="mean Exp think seconds between a closed-loop "
                         "client's completion and its next submission")
    ap.add_argument("--warmup-frac", type=float, default=0.0,
                    help="fraction of the closed-loop window trimmed "
                         "before computing queueing metrics")
    # trace-replay needs a trace the CLI does not take; closed-loop
    # scenarios are left out because this flag paces a fixed submission
    # stream (closed-loop serving is --closed-loop).
    ap.add_argument("--scenario", default=None,
                    choices=sorted(set(open_loop_names()) - {"trace-replay"}),
                    help="draw submission offsets from this registered "
                         "arrival process instead of a fixed stagger "
                         "(e.g. poisson-open, bursty)")
    ap.add_argument("--time-scale", type=float, default=1e-6,
                    help="seconds of wall time per scenario cycle "
                         "(with --scenario)")
    ap.add_argument("--scenario-kernels", action="store_true",
                    help="with --scenario: take the jobs themselves from "
                         "the scenario via the executor bridge (synthetic "
                         "blocks on --device) instead of --jobs archs")
    ap.add_argument("--cache-dir", default="artifacts/sweep_cache",
                    help="sweep cache for --scenario-kernels solo "
                         "baselines (shared with jobs=1 executor sweeps)")
    ap.add_argument("--max-blocks", type=int, default=16,
                    help="cap scenario grids at this many real blocks per "
                         "job (with --scenario-kernels; 0 = uncapped)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless asked; no fallback)")
    ap.add_argument("--reduced", action="store_true",
                    help="serve each arch's reduced config instead of its "
                         "full published width")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    """Run the driver; returns ``{policy: {"metrics", "results",
    "peak_bytes"}}`` for callers that check the run."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.scenario_kernels and not args.scenario:
        ap.error("--scenario-kernels requires --scenario")
    args.device = resolve_device(args.device)
    solo = measure_solo(args)
    runs: Dict[str, dict] = {}
    policies = [args.policy]
    if args.compare_fifo and args.policy != "fifo":
        policies.append("fifo")
    for policy in policies:
        metrics, results, peak = _run(args, policy, solo)
        runs[policy] = {"metrics": metrics, "results": results,
                        "peak_bytes": peak}
    if len(policies) == 2:
        m, mf = runs[args.policy]["metrics"], runs["fifo"]["metrics"]
        if args.closed_loop > 0:
            print(f"[serve] {args.policy} vs fifo at concurrency "
                  f"{args.closed_loop}: mean_rt "
                  f"{mf.mean_response / m.mean_response:.2f}x, p95_rt "
                  f"{mf.p95_response / m.p95_response:.2f}x")
        else:
            print(f"[serve] {args.policy} vs fifo: STP {m.stp / mf.stp:.2f}x, "
                  f"ANTT {mf.antt / m.antt:.2f}x")
    return runs


if __name__ == "__main__":
    main()
