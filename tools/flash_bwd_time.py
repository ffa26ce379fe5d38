"""Time the flash backward kernel on the card, against a baseline source.

    python3 tools/flash_bwd_time.py [--baseline OTHER/flash_attention_bwd.cu]

At yi-6b's training shape (B 4, S 1024, 32 heads / 4 KV of 128, causal),
the 100M example's (B 8, S 128, 10 / 2 of 64, causal) and
recurrentgemma-2b's (B 4, S 1024, 10 / 1 of 256; its window of 2048 is
causal at this length), on the same bf16 inputs (the forward kernel's
out and lse):

- the device time of one wrapper call (``chip_smoke.device_ms``: CUDA
  events over 20 calls, the host's enqueueing hidden behind a device
  sleep), in turns with the baseline (baseline, kernel, kernel,
  baseline) when one is given;
- each CUDA kernel's own time (torch.profiler over 10 calls);
- SDPA's backward on the same inputs (``torch.autograd.grad`` through
  ``F.scaled_dot_product_attention``; a yardstick the port never calls);
- the least time the card could take: the formula's five products and
  the design's seven over the causal half at 989 TFLOP/s bf16, against
  the inputs and gradients once at 3.35 TB/s.

``--baseline`` builds another version of the kernel source as it is (for
example the parent commit's, from an unpacked ``git archive``, with its
``hopper.cuh`` beside it) into the git-ignored
``kernels/_cuda_build/flash_bwd_time/``; it must export a
``flash_attention_bwd`` C entry, with or without the (part, splits)
arguments of the (256, 256) kernels (read from its source; it is given
the wrapper's slices and scratch), and is timed only at the pairs it is
built for.  Prints the card's name and power limit, one line per
measurement and a last JSON line.  Needs a GPU and ``nvcc``; exits
non-zero without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import torch

# baseline puts the repo root and src/ on sys.path
from baseline import build_baseline, card, in_turns
from chip_smoke import bound, device_ms, kernel_times, nbytes, sdpa
from repro_torch.kernels.flash_attention import (
    MASK_KINDS,
    flash_attention_cuda,
)
from repro_torch.kernels.flash_attention_bwd import (
    BM,
    WIDE,
    flash_attention_bwd_cuda,
    wide_splits,
)

SHAPES = {   # name: (B, S, H, KV, D)
    "yi-6b train": (4, 1024, 32, 4, 128),
    "example": (8, 128, 10, 2, 64),
    "recurrentgemma-2b train": (4, 1024, 10, 1, 256),
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = card()
    p, i = ctypes.c_void_p, ctypes.c_int
    src = args.baseline.read_text() if args.baseline else ""
    sliced = "int splits" in src           # the (part, splits) arguments
    base = build_baseline(args.baseline, "flash_bwd_time",
                          "flash_attention_bwd",
                          [p] * (10 + sliced) + [i] * (10 + sliced)
                          + [ctypes.c_float, i, p]) \
        if args.baseline else None
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    results = {}
    for name, (b, s, h, kv, d) in SHAPES.items():
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(
                torch.bfloat16)

        q, k, v, dout = randn(b, s, h, d), randn(b, s, kv, d), \
            randn(b, s, kv, d), randn(b, s, h, d)
        out, lse = flash_attention_cuda(q, k, v, return_lse=True)
        grads = [torch.empty_like(t) for t in (q, k, v)]
        pad = -(-s // BM) * BM
        scratch = torch.empty(b * h * 2 * pad, dtype=torch.float32,
                              device="cuda")
        splits, part = 1, None
        if sliced and d >= WIDE:     # the wrapper's slices and their parts
            splits = wide_splits(b, s, s, h, kv, "causal",
                                 sms=torch.cuda.get_device_properties(0)
                                 .multi_processor_count)
            part = torch.empty((2, splits, b, s, kv, d), dtype=torch.float32,
                               device="cuda")

        def kernel():
            flash_attention_bwd_cuda(q, k, v, out, dout, lse)

        def baseline():
            status = base.flash_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
                *(g.data_ptr() for g in grads),
                *((part.data_ptr() if part is not None else None, splits)
                  if sliced else ()), b, s, s, h, kv, d, d,
                MASK_KINDS["causal"], 0, 0, d ** -0.5, 0,
                torch.cuda.current_stream().cuda_stream)
            if status != 0:
                raise SystemExit(f"baseline failed with CUDA error {status}")

        row = {}
        if base is not None and d == 256 and "launch_wide<256>" not in src:
            print(f"[{name}] the baseline is not built for (256, 256)",
                  flush=True)
            base_here = None
        else:
            base_here = base
        if base_here is not None:
            row.update(in_turns(baseline, kernel))
            got = flash_attention_bwd_cuda(q, k, v, out, dout, lse)
            baseline()
            torch.cuda.synchronize()
            row["max_abs_diff_vs_baseline"] = max(
                float((x.float() - y.float()).abs().max())
                for x, y in zip(got, grads))
        else:
            row["ms"] = [device_ms(kernel, 20), device_ms(kernel, 20)]
        row["kernels"] = kernel_times(kernel, 10, r"flash_bwd_\w+")
        if base_here is not None:
            row["baseline_kernels"] = kernel_times(baseline, 10,
                                                   r"flash_bwd_\w+")
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        lib_out = sdpa(qg, kg, vg, causal=True)
        row["sdpa_backward_ms"] = device_ms(lambda: torch.autograd.grad(
            lib_out, (qg, kg, vg), dout.transpose(1, 2), retain_graph=True),
            20)
        pairs = s * (s + 1) // 2
        five = 2.0 * b * h * pairs * 5 * d
        seven = 2.0 * b * h * pairs * 7 * d
        total = nbytes(q, k, v, out, dout, lse, q, k, v)
        row["bound5_ms"] = bound(five, total)[0]
        row["bound7_ms"] = bound(seven, total)[0]
        ms = min(row["ms"])
        print(f"[{name}] B{b} S{s} H{h} KV{kv} D{d} causal: kernel "
              f"{row['ms']} ms" + (f", baseline {row['baseline_ms']} ms "
                                   f"(max |diff| "
                                   f"{row['max_abs_diff_vs_baseline']:.3e})"
                                   if base_here is not None else "")
              + f"; sdpa backward {row['sdpa_backward_ms']:.4f} ms; bounds "
              f"{row['bound5_ms']:.4f} (five products, {five / 1e9:.2f} "
              f"GFLOP) / {row['bound7_ms']:.4f} ms (seven); kernel at "
              f"{row['bound5_ms'] / ms:.1%} / {row['bound7_ms'] / ms:.1%} "
              f"of them; by CUDA kernel {row['kernels']}"
              + (f"; baseline by CUDA kernel {row['baseline_kernels']}"
                 if base_here is not None else ""), flush=True)
        results[name] = row
    print(json.dumps({"device": smi, "shapes": results}, allow_nan=False))


if __name__ == "__main__":
    main()
