"""Time the model phase's full-width decode step on the card, in turns with
another tree of the port, in one process.

    python3 tools/decode_step_time.py --baseline TREE [--archs yi-6b,...]

``--baseline`` takes the root of another tree (for example an unpacked
``git archive`` of the parent commit, in a git-ignored directory); its
``models.lm`` is imported beside this tree's (``tools/baseline.py``'s
``import_tree``) and builds that tree's kernels into that tree's
git-ignored ``kernels/_cuda_build/``.  For each arch (default yi-6b and
minicpm3-4b, full width, bf16 random weights from seed 0): one prefill
of B 4 x 1024 tokens into caches of ``chip_smoke.py``'s serving length,
then both trees' ``lm.decode_step`` on the same weights and caches, back
to back as ``chip_smoke.py``'s model phase times it, in ROUNDS rounds of
baseline, this, this, baseline, each turn 10 steps after one to warm up;
so a drift in the host's or the card's pace falls on both.  Then each
tree's ``ops.decode_attention`` (the model's call, one launch) alone at
yi-6b's decode shape, 1000 calls back to back in turns (host-paced where
a call's host time exceeds its ~13 us on the device).

Prints the card's name and power limit, each arch's median wall ms a
step per tree with every turn's, the ratio of the medians, and the
decode call's host us per tree.  Needs a GPU and ``nvcc``.
"""

from __future__ import annotations

import argparse
import statistics
import time
from pathlib import Path

import torch

from baseline import card, import_tree
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models import lm

# chip_smoke.py's B, PROMPT and MAX_SEQ (the serving paths' cache length)
B, PROMPT, MAX_SEQ = 4, 1024, 1024 + 8 * 8 + 8
ROUNDS, STEPS, CALLS = 6, 10, 1000


def wall_ms(fn, n: int) -> float:
    """Wall ms a call of ``fn``, ``n`` calls back to back after one."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def in_turns(fns: dict, n: int, rounds: int) -> dict:
    """``{name: [ms a call per turn]}``, turns baseline, this, this,
    baseline in each round."""
    got = {name: [] for name in fns}
    for _ in range(rounds):
        for name in ("baseline", "this", "this", "baseline"):
            got[name].append(wall_ms(fns[name], n))
    return got


def report(what: str, got: dict, unit: str, scale: float = 1.0) -> None:
    med = {name: statistics.median(v) * scale for name, v in got.items()}
    print(f"[decode] {what}: baseline {med['baseline']:.3f} {unit}, this "
          f"{med['this']:.3f} {unit} (median of {len(got['this'])} turns; "
          f"this / baseline {med['this'] / med['baseline']:.4f}); turns "
          + "; ".join(f"{name} " + ", ".join(f"{v * scale:.3f}" for v in vs)
                      for name, vs in got.items()), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, required=True,
                    help="another tree (its root, holding src/repro_torch)")
    ap.add_argument("--archs", default="yi-6b,minicpm3-4b")
    args = ap.parse_args(argv)
    card()
    other = import_tree(args.baseline, "models.lm")
    other_ops = import_tree(args.baseline, "kernels.ops")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for arch in args.archs.split(","):
        cfg = get_arch(arch)
        params = lm.init(cfg, seed=0, device="cuda")
        prompt = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen,
                               device="cuda")
        tok = torch.randint(0, cfg.vocab_size, (B,), generator=gen,
                            device="cuda")
        _, caches = lm.prefill(cfg, params, prompt, max_seq=MAX_SEQ)
        lengths = torch.full((B,), PROMPT, dtype=torch.int32, device="cuda")
        fns = {"baseline": lambda m=other: m.decode_step(
                   cfg, params, tok, caches, lengths),
               "this": lambda: lm.decode_step(cfg, params, tok, caches,
                                              lengths)}
        report(f"{arch} decode step B {B}, {PROMPT} cached, wall ms",
               in_turns(fns, STEPS, ROUNDS), "ms")
        del params, caches, fns
        torch.cuda.empty_cache()
    # yi-6b's decode attention: B 4, 32 heads over 4 of 128, the serving
    # paths' cache
    q = torch.randn((B, 32, 128), generator=gen, device="cuda").to(
        torch.bfloat16)
    kc = torch.randn((B, MAX_SEQ, 4, 128), generator=gen, device="cuda").to(
        torch.bfloat16)
    n = torch.full((B,), PROMPT, dtype=torch.int32, device="cuda")
    fns = {"baseline": lambda: other_ops.decode_attention(q, kc, kc, n),
           "this": lambda: ops.decode_attention(q, kc, kc, n)}
    report("ops.decode_attention, one launch a call, host us",
           in_turns(fns, CALLS, ROUNDS), "us", 1e3)


if __name__ == "__main__":
    main()
