"""Time the RG-LRU scan backward kernel on the card, against a baseline.

    python3 tools/rglru_bwd_time.py [--baseline TREE] [--variants]

At recurrentgemma-2b's training shape (B 4, S 1024, 2560 channels), on
bf16 x and dh and fp32 gates and log_a drawn from a seed (copies in
turn, over 100 MB of them, so the 50 MB L2 holds no launch's inputs),
each copy with the forward kernel's fp32 states entering each chunk:

- the device time of one wrapper call (``chip_smoke.device_ms``: CUDA
  events over 50 calls, the host's enqueueing hidden behind a device
  sleep), in turns with the baseline (baseline, kernel, kernel,
  baseline) when one is given, and the largest difference between the
  two versions' gradients;
- each CUDA kernel's own time (torch.profiler over 10 calls);
- ``-Xptxas -v``'s registers and spills of this tree's build, and the
  scan kernel's CTAs an SM (CUDA's occupancy calculator);
- the least time the card could take: x, dh, both gates and the entering
  states read once, dx and both gate gradients written once, at 3.35
  TB/s.

``--baseline`` takes the root of another tree of the port (for example
an unpacked ``git archive`` of another commit, in a git-ignored
directory) and times that tree's wrapper, ``rglru_bwd_cuda`` of its
``kernels/rglru_scan_bwd.py``, built into that tree's git-ignored
``kernels/_cuda_build/``; a wrapper that takes no ``entering`` states
(one that rebuilds them itself) is called without them.

``--variants`` builds this tree's ``csrc/rglru_scan_bwd.cu`` with parts
of the work changed (into the git-ignored
``kernels/_cuda_build/rglru_bwd_variants/``) and times each in turns
with the full kernel, through this tree's wrapper: ``no_stores`` (no TMA
store of the gradients), ``loads_only`` (the TMA ring alone: no
arithmetic, no stores) and ``two_ctas`` (launch bounds of two CTAs an SM
and 100 KB of shared memory a CTA, so that two are resident).  A
variant's gradients are not correct; only its time is read.

Prints the card's name and power limit, one line per measurement and a
last JSON line.  Needs a GPU and ``nvcc``; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import subprocess
from pathlib import Path

import torch

# baseline puts the repo root and src/ on sys.path
from baseline import card, import_tree, in_turns
from chip_smoke import bound, device_ms, kernel_times, nbytes
from repro_torch.kernels import _build
from repro_torch.kernels import rglru_scan_bwd as rb
from repro_torch.kernels.rglru_scan import rglru_cuda

B, S, C = 4, 1024, 2560
OUT = _build.BUILD_DIR / "rglru_bwd_variants"


def _swap(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise SystemExit(f"anchor found {src.count(old)} times, not {count},"
                         f" in rglru_scan_bwd.cu: {old!r}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    """The source of each variant of the backward."""
    no_stores = _swap(src, "hopper::tma_store_3d(&m.",
                      "if (a.S < 0) hopper::tma_store_3d(&m.", 3)
    loads_only = _swap(
        no_stores, "        // Each step's a_t, beta_t, beta's derivative",
        "        if constexpr (TMA) {\n"
        "            __syncthreads();\n"
        "            if (tid == 0 && i + STAGES < nc)\n"
        "                tma_chunk(st, &bars[i % STAGES], m, c - STAGES, c0,"
        " b);\n"
        "            continue;\n"
        "        }\n"
        "        // Each step's a_t, beta_t, beta's derivative")
    two = _swap(src, "__launch_bounds__(THREADS, 3)",
                "__launch_bounds__(THREADS, 2)")
    two = _swap(two, "<<<grid, THREADS, Layout::bytes, st>>>",
                "<<<grid, THREADS, 100 * 1024, st>>>", 2)
    two = _swap(two, "                                Layout::bytes);\n}",
                "                                100 * 1024);\n}")
    two = _swap(two, "THREADS, Layout::bytes)", "THREADS, 100 * 1024)", 2)
    return {"no_stores": no_stores, "loads_only": loads_only,
            "two_ctas": two}


def build_variants() -> dict:
    """Build every variant at once; returns each one's ptxas log."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "hopper.cuh").write_text((_build.CSRC / "hopper.cuh").read_text())
    procs = {}
    for name, text in variants((_build.CSRC / "rglru_scan_bwd.cu")
                               .read_text()).items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(OUT / f"lib{name}.so"), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for name, proc in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on variant {name}:\n{logs[name]}")
    return logs


def ptxas(log: str) -> list:
    """The register, spill and shared-memory lines of a ptxas log."""
    return [line.strip() for line in log.splitlines()
            if any(w in line for w in ("Function properties", "registers",
                                       "spill"))]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--variants", action="store_true")
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

    copies = []
    for _ in range(-(-100_000_000 // (B * S * C * 22))):
        x = (randn(B, S, C) * 0.5).to(torch.bfloat16)
        ga, gi = torch.sigmoid(randn(B, S, C)), torch.sigmoid(randn(B, S, C))
        la = -torch.nn.functional.softplus(randn(C))
        copies.append((x, ga, gi, la, randn(B, S, C).to(torch.bfloat16),
                       rglru_cuda(x, ga, gi, la, entering=True)[2]))
    turn = [0]

    def call(fn, a):
        if "entering" in inspect.signature(fn).parameters:
            return fn(*a[:5], entering=a[5])
        return fn(*a[:5])

    def run(fn):
        a = copies[turn[0] % len(copies)]
        turn[0] += 1
        return call(fn, a)

    def kernel():
        return run(rb.rglru_bwd_cuda)

    row = {}
    if base is not None:
        row.update(in_turns(lambda: run(base), kernel, 50))
        got, want = call(rb.rglru_bwd_cuda, copies[0]), call(base, copies[0])
        torch.cuda.synchronize()
        row["max_abs_diff_vs_baseline"] = max(
            float((x.float() - y.float()).abs().max())
            for x, y in zip(got[:4], want[:4]))
    else:
        row["ms"] = [device_ms(kernel, 50), device_ms(kernel, 50)]
    row["kernels"] = kernel_times(kernel, 10, r"rglru_bwd_\w+")
    log = _build.BUILD_DIR / "rglru_scan_bwd.log"
    row["ptxas"] = ptxas(log.read_text()) if log.exists() else []
    row["ctas_an_sm"] = rb.occupancy(tma=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ctas = B * -(-C // rb.TILE)
    grads = call(rb.rglru_bwd_cuda, copies[0])
    total = nbytes(*copies[0]) + nbytes(*grads[:4])
    row["bound_ms"] = bound(0.0, total)[0]
    ms = min(row["ms"])
    print(f"[rglru_bwd] B{B} S{S} C{C}: kernel {row['ms']} ms"
          + (f", baseline {row['baseline_ms']} ms (max |diff| "
             f"{row['max_abs_diff_vs_baseline']:.3e})" if base else "")
          + f"; bound {row['bound_ms']:.4f} ms ({total / 1e6:.2f} MB); "
          f"kernel at {row['bound_ms'] / ms:.1%} of it; by CUDA kernel "
          f"{row['kernels']}", flush=True)
    for line in row["ptxas"]:
        print(f"[rglru_bwd] ptxas: {line}", flush=True)
    print(f"[rglru_bwd] scan kernel: {row['ctas_an_sm']} CTAs an SM, "
          f"{min(ctas, row['ctas_an_sm'] * sms)} of its {ctas} CTAs resident "
          f"at once on {sms} SMs", flush=True)

    if args.variants:
        own = rb._lib()
        logs = build_variants()

        def with_lib(chosen):
            """A call of this tree's wrapper on the library ``chosen``."""
            def fn():
                rb._lib = lambda: chosen
                return kernel()
            return fn

        row["variants"] = {}
        for name, vlog in logs.items():
            lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
            for entry in ("rglru_scan_bwd", "rglru_scan_bwd_occupancy"):
                getattr(lib, entry).argtypes = getattr(own, entry).argtypes
                getattr(lib, entry).restype = getattr(own, entry).restype
            times = in_turns(with_lib(own), with_lib(lib), 50)
            rb._lib = lambda: lib
            v = {"ms": times["ms"], "full_ms": times["baseline_ms"],
                 "kernels": kernel_times(kernel, 10, r"rglru_bwd_\w+"),
                 "ctas_an_sm": rb.occupancy(tma=True),
                 "ptxas": ptxas(vlog)}
            rb._lib = lambda: own
            row["variants"][name] = v
            print(f"[rglru_bwd] variant {name}: {v['ms']} ms against the "
                  f"full kernel's {v['full_ms']} (in turns); "
                  f"{v['ctas_an_sm']} CTAs an SM; by CUDA kernel "
                  f"{v['kernels']}", flush=True)
            for line in v["ptxas"]:
                print(f"[rglru_bwd]   ptxas: {line}", flush=True)
    print(json.dumps({"device": smi, "train": row}, allow_nan=False))


if __name__ == "__main__":
    main()
