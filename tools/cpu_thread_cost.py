"""What torch's intra-op threads cost the port's small CPU work: a reduced
model's product and ten decode blocks of the concurrent-serving example's
long job, on the process's default intra-op threads and on one, in turns
(default, one, one, default).

    PYTHONPATH=src python3 tools/cpu_thread_cost.py [--load N]

- ``[2, 256] @ [256, 1024]`` in bf16 and in fp32 (a reduced decode
  step's shape), the median µs of a call over REPS calls;
- ten blocks of reduced minicpm3-4b decoding (the example's long job:
  batch 2, prompt 16, 16 tokens a block) through ``LaneExecutor`` on four
  lanes under FIFO, wall seconds.

``--load N`` first starts N processes that run bf16 products on their
default threads until the measurement ends, as N other test workers
would.  Prints the host's CPU count, torch's version and default thread
count, each turn and a JSON line.  CPU only: a CPU time is no chip
number.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import statistics
import time

import torch

from repro_torch import intra_op_threads
from repro_torch.configs import get_arch
from repro_torch.core.executor import LaneExecutor
from repro_torch.core.jobs import make_serve_job
from repro_torch.core.policies import make_policy

REPS = 2000
BLOCKS = 10


def product_us(dtype) -> float:
    """Median µs of one ``[2, 256] @ [256, 1024]`` call in ``dtype``."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 256, generator=gen).to(dtype)
    w = torch.randn(256, 1024, generator=gen).to(dtype)
    for _ in range(50):
        x @ w
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        x @ w
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e6


def blocks_s() -> float:
    """Wall seconds of BLOCKS decode blocks of the example's long job."""
    job = make_serve_job(get_arch("minicpm3-4b").reduced(), "long-job",
                         blocks=BLOCKS, tokens_per_block=16, batch=2,
                         prompt_len=16, max_residency=4, seed=0,
                         device="cpu")
    t0 = time.perf_counter()
    LaneExecutor([job], make_policy("fifo"), n_lanes=4).run()
    return time.perf_counter() - t0


def measure() -> dict:
    return {"bf16_us": product_us(torch.bfloat16),
            "fp32_us": product_us(torch.float32), "blocks_s": blocks_s()}


def _busy(stop) -> None:
    x = torch.randn(2, 256).bfloat16()
    w = torch.randn(256, 1024).bfloat16()
    while not stop.is_set():
        x @ w


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--load", type=int, default=0)
    args = ap.parse_args(argv)
    default = torch.get_num_threads()
    print(f"{os.cpu_count()} CPUs, torch {torch.__version__}, {default} "
          f"intra-op threads by default, {args.load} loading processes",
          flush=True)
    ctx = multiprocessing.get_context("spawn")
    stop = ctx.Event()
    load = [ctx.Process(target=_busy, args=(stop,)) for _ in range(args.load)]
    for p in load:
        p.start()
    turns = []
    try:
        for threads in (default, 1, 1, default):
            with intra_op_threads(threads):
                got = measure()
            turns.append({"threads": threads, **got})
            print(f"{threads} threads: bf16 {got['bf16_us']:.1f} µs, fp32 "
                  f"{got['fp32_us']:.1f} µs a product; {BLOCKS} blocks "
                  f"{got['blocks_s']:.3f} s", flush=True)
    finally:
        stop.set()
        for p in load:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
    print(json.dumps({"load": args.load, "turns": turns}, allow_nan=False))


if __name__ == "__main__":
    main()
