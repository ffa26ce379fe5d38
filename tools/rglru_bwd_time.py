"""Time the RG-LRU scan backward kernel on the card, against a baseline.

    python3 tools/rglru_bwd_time.py [--baseline TREE]

At recurrentgemma-2b's training shape (B 4, S 1024, 2560 channels), on
bf16 x and dh and fp32 gates and log_a drawn from a seed (copies in
turn, over 100 MB of them, so the 50 MB L2 holds no launch's inputs):

- the device time of one wrapper call (``chip_smoke.device_ms``: CUDA
  events over 50 calls, the host's enqueueing hidden behind a device
  sleep), in turns with the baseline (baseline, kernel, kernel,
  baseline) when one is given, and the largest difference between the
  two versions' gradients;
- each CUDA kernel's own time (torch.profiler over 10 calls);
- the least time the card could take: x, dh and both gates read once, dx
  and both gate gradients written once, at 3.35 TB/s.

``--baseline`` takes the root of another tree of the port (for example
an unpacked ``git archive`` of another commit, or a copy with an edited
``csrc/rglru_scan_bwd.cu``, in a git-ignored directory) and times that
tree's wrapper, ``rglru_bwd_cuda`` of its ``kernels/rglru_scan_bwd.py``,
built into that tree's git-ignored ``kernels/_cuda_build/``.  Prints the
card's name and power limit, one line per measurement and a last JSON
line.  Needs a GPU and ``nvcc``; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

# baseline puts the repo root and src/ on sys.path
from baseline import card, import_tree, in_turns
from chip_smoke import bound, device_ms, kernel_times, nbytes
from repro_torch.kernels.rglru_scan_bwd import rglru_bwd_cuda

B, S, C = 4, 1024, 2560


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = card()
    base = import_tree(args.baseline, "kernels.rglru_scan_bwd").rglru_bwd_cuda \
        if args.baseline else None
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    copies = [((randn(B, S, C) * 0.5).to(torch.bfloat16),
               torch.sigmoid(randn(B, S, C)), torch.sigmoid(randn(B, S, C)),
               -torch.nn.functional.softplus(randn(C)),
               randn(B, S, C).to(torch.bfloat16))
              for _ in range(-(-100_000_000 // (B * S * C * 22)))]
    turn = [0]

    def run(fn):
        a = copies[turn[0] % len(copies)]
        turn[0] += 1
        return fn(*a)

    def kernel():
        return run(rglru_bwd_cuda)

    row = {}
    if base is not None:
        row.update(in_turns(lambda: run(base), kernel, 50))
        got, want = rglru_bwd_cuda(*copies[0]), base(*copies[0])
        torch.cuda.synchronize()
        row["max_abs_diff_vs_baseline"] = max(
            float((x.float() - y.float()).abs().max())
            for x, y in zip(got[:4], want[:4]))
    else:
        row["ms"] = [device_ms(kernel, 50), device_ms(kernel, 50)]
    row["kernels"] = kernel_times(kernel, 10, r"rglru_bwd_\w+")
    x, ga, gi, la, dh = copies[0]
    grads = rglru_bwd_cuda(x, ga, gi, la, dh)
    total = nbytes(x, ga, gi, la, dh) + nbytes(*grads[:4])
    row["bound_ms"] = bound(0.0, total)[0]
    ms = min(row["ms"])
    print(f"[rglru_bwd] B{B} S{S} C{C}: kernel {row['ms']} ms"
          + (f", baseline {row['baseline_ms']} ms (max |diff| "
             f"{row['max_abs_diff_vs_baseline']:.3e})" if base else "")
          + f"; bound {row['bound_ms']:.4f} ms ({total / 1e6:.2f} MB); "
          f"kernel at {row['bound_ms'] / ms:.1%} of it; by CUDA kernel "
          f"{row['kernels']}", flush=True)
    print(json.dumps({"device": smi, "train": row}, allow_nan=False))


if __name__ == "__main__":
    main()
