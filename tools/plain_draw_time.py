"""Time the port's plain threefry draws and key tree on the CPU, for this
tree and, in turns, another one, in one process.

    python3 tools/plain_draw_time.py [--baseline TREE] [--threads N]

``--baseline`` takes the root of another tree (for example an unpacked
``git archive`` of the parent commit, in a git-ignored directory); its
modules are imported beside this tree's (``tools/baseline.py``'s
``import_tree``).  Each figure is the least of ROUNDS turns, taken
baseline, this, this, baseline, after one call to warm up:

- ``inits``: each reduced arch's ``lm.init`` on the CPU (fp32, stacked,
  seed 0, as the parity tests build it), and their sum;
- ``splits``: 1000 ``prng.split(prng.key(i), 4)``;
- ``hash``: the bits of 500 000 counters (``prng.bits``);
- ``normal``: one float32 normal draw of 2**19 elements through
  ``threefry.draw``, the op's plain version (a reduced init's volume);
- ``tokens``: one train block's tokens (``core.jobs.train_tokens``) at
  B 4 x 1024 and yi-6b's vocabulary;
- this tree only, ``normal`` again with the op's chunk
  (``threefry.CHUNK``) at each power of two from 2**14 to 2**19.

Prints the thread count and one JSON object of seconds.  Needs no GPU.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from baseline import import_tree
from repro_torch import prng
from repro_torch.configs import ARCHS, get_arch
from repro_torch.core import jobs
from repro_torch.kernels import threefry
from repro_torch.models import lm

ROUNDS = 3


def seconds(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def workloads(prng_, lm_, jobs_, threefry_) -> dict:
    """Name to a callable of one tree's modules."""
    def inits():
        return {arch: seconds(lambda a=arch: lm_.init(
            get_arch(a).reduced(), seed=0, device="cpu",
            dtype=torch.float32, stacked=True)) for arch in sorted(ARCHS)}

    def splits():
        for i in range(1000):
            prng_.split(prng_.key(i), 4)

    key = prng_.key(7)
    cfg = get_arch("yi-6b")
    return {
        "inits": inits,
        "splits": splits,
        "hash": lambda: prng_.bits(key, 500_000),
        "normal": lambda: threefry_.draw(torch.empty(1 << 19), key),
        "tokens": lambda: jobs_.train_tokens(cfg, 0, 3, 4, 1024),
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", type=Path)
    parser.add_argument("--threads", type=int, default=0,
                        help="torch intra-op threads (0: as set)")
    args = parser.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    trees = {"this": workloads(prng, lm, jobs, threefry)}
    if args.baseline is not None:
        trees["baseline"] = workloads(
            *(import_tree(args.baseline, m) for m in (
                "prng", "models.lm", "core.jobs", "kernels.threefry")))
    order = (["baseline", "this", "this", "baseline"]
             if "baseline" in trees else ["this"])
    for fns in trees.values():          # warm up every path once
        for fn in fns.values():
            fn()
    best: dict = {name: {} for name in trees}
    for _ in range(ROUNDS):
        for name in order:
            for what, fn in trees[name].items():
                t0 = time.perf_counter()
                got = fn()
                took = time.perf_counter() - t0
                if what == "inits":
                    for arch, s in got.items():
                        key = f"init {arch}"
                        best[name][key] = min(best[name].get(key, s), s)
                    key = "inits (sum of the least)"
                    best[name][key] = sum(best[name][f"init {a}"]
                                          for a in sorted(ARCHS))
                else:
                    best[name][what] = min(best[name].get(what, took), took)
    default = threefry.CHUNK
    for log2 in range(14, 20):
        threefry.CHUNK = 1 << log2
        fn = trees["this"]["normal"]
        best["this"][f"normal, chunk 2**{log2}"] = min(
            seconds(fn) for _ in range(ROUNDS))
    threefry.CHUNK = default
    print(f"torch {torch.__version__}, {torch.get_num_threads()} intra-op "
          f"threads; least of {ROUNDS} turns (seconds)", flush=True)
    for name, got in best.items():
        for what, s in got.items():
            print(f"  {name:8s} {what:28s} {s:.4f}", flush=True)
    print(json.dumps({"threads": torch.get_num_threads(), **best},
                     allow_nan=False), flush=True)
    return best


if __name__ == "__main__":
    main()
