"""Time full-width yi-34b's seeded init and a train block's token draw on
the card, for this tree and, in turns, another one, in one process.

    python3 tools/init_split_time.py [--baseline TREE] [--rounds N]

``--baseline`` takes the root of another tree (for example an unpacked
``git archive`` of the parent commit, in a git-ignored directory); its
modules are imported beside this tree's (``tools/baseline.py``'s
``import_tree``) and build its kernels into its own git-ignored build
directory.  Each round runs baseline, this, this, baseline:

- yi-34b's serving init (bf16, all 60 layers, seed 0) on the card, wall
  seconds to a synchronised end, and its key tree (``lm.draw_keys``)
  alone, host seconds;
- one yi-6b train block's tokens at ``chip_smoke.py``'s B x PROMPT
  (``core.jobs.train_tokens``): a tree whose ``train_tokens`` takes a
  ``device`` draws them on the card (host ms to issue a draw, device ms by
  CUDA events); an older one draws on the host and copies them to the
  card (wall ms, synchronised, which is also its host ms).  Both trees'
  tokens are checked equal.

Prints the card's name and power limit, every turn and the means.  Needs
a GPU and ``nvcc``.
"""

from __future__ import annotations

import argparse
import gc
import inspect
import json
import time
from pathlib import Path

import torch

from baseline import card, import_tree
from chip_smoke import B, PROMPT, device_ms, wall_ms
from repro_torch.configs import get_arch

TOKEN_CALLS = 20


def tree_fns(lm, jobs) -> dict:
    """The timed calls of one tree's ``models.lm`` and ``core.jobs``."""
    big, small = get_arch("yi-34b"), get_arch("yi-6b")
    on_device = "device" in inspect.signature(jobs.train_tokens).parameters

    def tokens():
        if on_device:
            return jobs.train_tokens(small, 0, 5, B, PROMPT, device="cuda")
        return jobs.train_tokens(small, 0, 5, B, PROMPT).to("cuda")

    def init_s() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = lm.init(big, seed=0, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        del params
        gc.collect()
        torch.cuda.empty_cache()
        return secs

    def keys_s() -> float:
        t0 = time.perf_counter()
        lm.draw_keys(big, 0)
        return time.perf_counter() - t0

    def tokens_ms() -> dict:
        if not on_device:
            return {"wall_ms": wall_ms(tokens, TOKEN_CALLS)}
        tokens()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TOKEN_CALLS):
            tokens()
        host = (time.perf_counter() - t0) * 1e3 / TOKEN_CALLS
        torch.cuda.synchronize()
        return {"host_ms": host, "device_ms": device_ms(tokens,
                                                        TOKEN_CALLS)}

    return {"init_s": init_s, "keys_s": keys_s, "tokens_ms": tokens_ms,
            "tokens": tokens}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", type=Path)
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args(argv)
    smi = card()
    from repro_torch.core import jobs
    from repro_torch.models import lm

    trees = {"this": tree_fns(lm, jobs)}
    order = ["this"]
    if args.baseline is not None:
        trees["baseline"] = tree_fns(
            import_tree(args.baseline, "models.lm"),
            import_tree(args.baseline, "core.jobs"))
        order = ["baseline", "this", "this", "baseline"]
        if not torch.equal(trees["this"]["tokens"]().cpu(),
                           trees["baseline"]["tokens"]().cpu()):
            raise SystemExit("the two trees' train tokens differ")
    got = {name: {"init_s": [], "keys_s": [], "tokens_ms": []}
           for name in trees}
    for _ in range(args.rounds):
        for name in order:
            for what in ("keys_s", "init_s", "tokens_ms"):
                value = trees[name][what]()
                got[name][what].append(value)
                print(f"[init-split] {name} {what}: {value}", flush=True)
    for name, rows in got.items():
        init = sum(rows["init_s"]) / len(rows["init_s"])
        keys = sum(rows["keys_s"]) / len(rows["keys_s"])
        print(f"[init-split] {name}: yi-34b init {init:.4f} s, of which the "
              f"key tree {keys * 1e3:.3f} ms; tokens "
              f"{rows['tokens_ms'][-1]}; {smi}", flush=True)
    print(json.dumps({"card": smi, **got}, allow_nan=False), flush=True)
    return got


if __name__ == "__main__":
    main()
