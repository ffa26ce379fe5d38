"""Time the SSD-scan backward kernel on the card, and mamba2's training peak.

    python3 tools/ssd_bwd_time.py [--baseline TREE] [--depths 16,32,48,56]

At mamba2-2.7b's training shape (B 4, S 1024, 80 heads of P 64, N 128,
G 1, chunk 128), on bf16 x, B, C, dy and fp32 dt, A drawn from a seed:

- the device time of one wrapper call (``chip_smoke.device_ms``: CUDA
  events over 20 calls, the host's enqueueing hidden behind a device
  sleep), in turns with the baseline (baseline, kernel, kernel,
  baseline) when one is given, and the largest difference between the
  two versions' gradients;
- each CUDA kernel's own time (torch.profiler over 10 calls);
- the least time the card could take: the products the gradients need
  (``ssd_scan_bwd.flops``) at 989 TFLOP/s bf16 against the inputs and
  gradients once at 3.35 TB/s, and the same with the design's products.

``--baseline`` takes the root of another tree of the port (for example
an unpacked ``git archive`` of the parent commit, in a git-ignored
directory) and times that tree's wrapper, ``ssd_bwd_cuda`` of its
``kernels/ssd_scan_bwd.py``: it allocates that design's own scratch and
builds that tree's source into that tree's git-ignored
``kernels/_cuda_build/``.  ``--depths`` then
trains full-width mamba2-2.7b for 3 steps at each depth through
``repro_torch.launch.train`` and prints its peak device memory and step
times (a depth that does not fit prints the error).  Prints the card's
name and power limit, one line per measurement and a last JSON line.
Needs a GPU and ``nvcc``; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import gc
import json
from pathlib import Path

import torch
import torch.nn.functional as F

# baseline puts the repo root and src/ on sys.path
from baseline import card, import_tree, in_turns
from chip_smoke import bound, device_ms, kernel_times, nbytes
from repro_torch.kernels import ssd_scan_bwd

B, S, H, P, G, N, CHUNK = 4, 1024, 80, 64, 1, 128, 128


def train_peaks(depths) -> dict:
    from repro_torch.launch import train

    out = {}
    for layers in depths:
        try:
            run = train.main(["--arch", "mamba2-2.7b", "--n-layers",
                              str(layers), "--steps", "3", "--batch", str(B),
                              "--seq", str(S)])
            out[layers] = {"peak_gib": run["peak_bytes"] / 2**30,
                           "step_ms": [r["ms"] for r in run["steps"]]}
        except torch.OutOfMemoryError as exc:
            out[layers] = {"error": str(exc).splitlines()[0]}
        print(f"[depth {layers}] {out[layers]}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--depths", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = card()
    base = import_tree(args.baseline, "kernels.ssd_scan_bwd") \
        if args.baseline else None
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x = (randn(B, S, H, P) * 0.5).to(torch.bfloat16)
    dt, A = F.softplus(randn(B, S, H)), -torch.exp(randn(H))
    Bm = (randn(B, S, G, N) * 0.3).to(torch.bfloat16)
    Cm = (randn(B, S, G, N) * 0.3).to(torch.bfloat16)
    dy = randn(B, S, H, P).to(torch.bfloat16)

    def call(module):
        def fn():
            return module.ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, chunk=CHUNK)
        return fn

    kernel = call(ssd_scan_bwd)
    row = {}
    if base is not None:
        baseline = call(base)
        row.update(in_turns(baseline, kernel))
        got, want = kernel(), baseline()
        torch.cuda.synchronize()
        row["max_abs_diff_vs_baseline"] = max(
            float((u.float() - v.float()).abs().max())
            for u, v in zip(got[:5], want[:5]))
        row["baseline_kernels"] = kernel_times(baseline, 10, r"ssd_bwd_\w+")
    else:
        row["ms"] = [device_ms(kernel, 20), device_ms(kernel, 20)]
    row["kernels"] = kernel_times(kernel, 10, r"ssd_bwd_\w+")
    flops, flops_done = ssd_scan_bwd.flops(
        B, S, H, P, G, N, CHUNK,
        torch.cuda.get_device_properties(0).multi_processor_count)
    total = nbytes(x, dt, A, Bm, Cm, dy) + nbytes(*kernel()[:5])
    row["bound_ms"], row["bound_by"] = bound(flops, total)
    row["design_bound_ms"] = bound(flops_done, total)[0]
    print(f"[mamba2 train] B{B} S{S} H{H} P{P} G{G} N{N} chunk {CHUNK}: "
          f"kernel {row['ms']} ms" + (
              f", baseline {row['baseline_ms']} ms (max |diff| "
              f"{row['max_abs_diff_vs_baseline']:.3e}; by CUDA kernel "
              f"{row['baseline_kernels']})" if base is not None else "")
          + f"; bound {row['bound_ms']:.4f} ms ({row['bound_by']}; the "
          f"design's products {row['design_bound_ms']:.4f} ms); by CUDA "
          f"kernel {row['kernels']}", flush=True)
    result = {"device": smi, "mamba2 train": row}
    if args.depths:
        result["depths"] = train_peaks(int(d) for d in args.depths.split(","))
    print(json.dumps(result, allow_nan=False))


if __name__ == "__main__":
    main()
