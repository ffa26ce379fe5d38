"""Time the flash backward kernel on the card, against a baseline source,
and time variants of its (256, 256) kernels.

    python3 tools/flash_bwd_time.py [--baseline OTHER/flash_attention_bwd.cu]
    python3 tools/flash_bwd_time.py --variants [SOURCE]

At yi-6b's training shape (B 4, S 1024, 32 heads / 4 KV of 128, causal),
the 100M example's (B 8, S 128, 10 / 2 of 64, causal),
recurrentgemma-2b's (B 4, S 1024, 10 / 1 of 256; its window of 2048 is
causal at this length), minicpm3-4b's (B 4, S 1024, 40 / 40 heads, qk
96 zero-padded to 128 at the scale of 96, v 64) and deepseek-v2-lite's
(B 4, S 1024, 16 / 16 of (192, 128)), and (256, 256) at G 1 (B 4, S
1024, 4 / 4: one slice of heads), on the same bf16 inputs (the forward
kernel's out and lse):

- the device time of one wrapper call (``chip_smoke.device_ms``: CUDA
  events over 20 calls, the host's enqueueing hidden behind a device
  sleep), in turns with the baseline (baseline, kernel, kernel,
  baseline) when one is given and is built for the pair; the gradients
  must be bitwise equal to the baseline's (the tool prints the largest
  difference and exits non-zero otherwise);
- each CUDA kernel's own time (torch.profiler over 10 calls);
- SDPA's backward on the same inputs (``torch.autograd.grad`` through
  ``F.scaled_dot_product_attention``; a yardstick the port never calls);
- the least time the card could take: the formula's five products (at
  the function's own qk) and the design's seven (at the padded D) over
  the causal half at 989 TFLOP/s bf16, against the inputs and gradients
  once at 3.35 TB/s;
- the CTAs of this tree's wide kernels an SM holds at once.

``--baseline`` builds another version of the kernel source as it is (for
example the parent commit's, from an unpacked ``git archive``, with its
``hopper.cuh`` beside it) into the git-ignored
``kernels/_cuda_build/flash_bwd_time/``.  Its C entry is read from its
source: with the (part, splits) arguments of the wide kernels (given
the wrapper's slices and their fp32 scratch, laid out as this tree's
wrapper lays it out) or without; it is timed only at the pairs it is
built for (its ``flash_attention_bwd_smem_bytes`` is not -1).

``--variants`` builds variants of the (256, 256) kernels of SOURCE (by
default this tree's ``csrc/flash_attention_bwd.cu``) into the same
git-ignored directory and times each in turns against SOURCE's full
build at recurrentgemma's shape.  A variant's gradients are not correct;
only its time is read:

- ``loads_only``: the rings and their barriers, no product, no
  exponential, no hand-off;
- ``products_only``: the products and the rings, no exponential, no
  mask, no hand-off between the warpgroups;
- ``no_handoff``: the hand-off without its wait: each warpgroup takes its
  own product as P (the first design keeps its CTA-wide barrier, which
  also gates the ring's refill; this tree's dQ kernel hands nothing over
  and runs in full);
- ``no_sum``: the head slices' sum left out: no fp32 parts written, no
  fourth launch.

The first design (a CTA-wide barrier in every step) is varied by
replacing anchors of its text; this tree's design by compiling its
source with ``-DFLASH_BWD_VARIANT=<n>``.  Prints the card's name and
power limit, the ``-Xptxas -v`` lines of the build, one line per
measurement and a last JSON line.  Needs a GPU and ``nvcc``; exits
non-zero without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

# baseline puts the repo root and src/ on sys.path
from baseline import build_baseline, card, in_turns
from chip_smoke import bound, device_ms, kernel_times, nbytes, sdpa
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (
    MASK_KINDS,
    flash_attention_cuda,
)
from repro_torch.kernels.flash_attention_bwd import (
    BM,
    WIDE_PAIRS,
    _lib,
    flash_attention_bwd_cuda,
    wide_ctas,
    wide_splits,
)

SHAPES = {   # name: (B, S, H, KV, qk, D, Dv)
    "yi-6b train": (4, 1024, 32, 4, 128, 128, 128),
    "example": (8, 128, 10, 2, 64, 64, 64),
    "recurrentgemma-2b train": (4, 1024, 10, 1, 256, 256, 256),
    "minicpm3-4b train": (4, 1024, 40, 40, 96, 128, 64),
    "deepseek-v2-lite train": (4, 1024, 16, 16, 192, 192, 128),
    # (256, 256) at G 1: one slice, whose bf16 epilogue must give the bits
    # of a baseline that sums fp32 parts
    "one slice (256, 256)": (4, 1024, 4, 4, 256, 256, 256),
}
WIDE_SHAPE = "recurrentgemma-2b train"
OUT = _build.BUILD_DIR / "flash_bwd_time"
VARIANTS = ("loads_only", "products_only", "no_handoff", "no_sum")
NEVER = "(Sq < 0)"      # false at run time, unknown to the compiler


def convention(src: str) -> str:
    """The C entry's arguments: "part" (a pointer to fp32 parts and the
    slice count) or "plain" (neither)."""
    return "part" if "int splits" in src else "plain"


def argtypes(kind: str) -> list:
    p, i = ctypes.c_void_p, ctypes.c_int
    extra = kind == "part"
    return [p] * (10 + extra) + [i] * (10 + extra) + [ctypes.c_float, i, p]


def _swap(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"anchor found {src.count(old)} times, not once: "
                         f"{old!r}")
    return src.replace(old, new)


def first_design_variants(src: str) -> dict:
    """The variants of the first (256, 256) design (fp32 parts summed by a
    fourth launch), by replacing anchors of its text."""
    products = [
        "        wgmma_ss_tiles<D>(x, per_step(a_desc), BN * BOX * 2,",
        "            wgmma_rs<D>(acc, xa[kk], desc_at(b_mn, kk * 16 * BOX * 2));",
        "        wgmma_ss_tiles<D>(x, per_step(a_desc), BM * BOX * 2,",
        "            wgmma_ss<HALF, 0, 1>(acc, desc_at(ds_desc, kk * 32),",
    ]
    elementwise = [
        ("        if (wg == 0) {\n            // P^T = exp2",
         f"        if (wg == 0 && {NEVER}) {{\n            // P^T = exp2"),
        ("        if (wg == 1) {\n            // dS^T = P^T",
         f"        if (wg == 1 && {NEVER}) {{\n            // dS^T = P^T"),
        ("        if (wg == 0) {\n            const bool edge =",
         f"        if (wg == 0 && {NEVER}) {{\n            const bool edge ="),
        ("        if (wg == 1) {\n            // dS = P (dP - delta)",
         f"        if (wg == 1 && {NEVER}) {{\n            // dS = P (dP - delta)"),
    ]
    out = {}
    s = src
    for old, new in elementwise:
        s = _swap(s, old, new)
    out["products_only"] = s
    for old in products:
        s = _swap(s, old, old.replace(old.lstrip(),
                                      f"if ({NEVER}) " + old.lstrip()))
    out["loads_only"] = s
    s = _swap(src, "                p_st[j * 128 + ct] = p;",
              "                if (p == -1.f) p_st[j * 128 + ct] = p;")
    s = _swap(s, "x[j] = p_st[j * 128 + ct] * (x[j] - dlt_st[col]);",
              "x[j] = x[j] * (x[j] - dlt_st[col]);")
    s = _swap(s, "                Ps[j * 128 + ct] = p;",
              "                if (p == -1.f) Ps[j * 128 + ct] = p;")
    out["no_handoff"] = _swap(
        s, "x[j] = Ps[j * 128 + ct] * (x[j] - dlt[(j >> 1) & 1]);",
        "x[j] = x[j] * (x[j] - dlt[(j >> 1) & 1]);")
    s = _swap(src, "            if (key < Sk)\n",
              f"            if (key < Sk && {NEVER})\n")
    out["no_sum"] = _swap(s, "    flash_bwd_dkdv_reduce_kernel<<<",
                          "    if (splits < 0) flash_bwd_dkdv_reduce_kernel<<<")
    return out


def build_variants(source: Path) -> tuple:
    """Build SOURCE and its variants at once, each into its own directory
    with SOURCE's ``hopper.cuh``; returns ({name: library}, full's log)."""
    src = source.read_text()
    if "FLASH_BWD_VARIANT" in src:
        jobs = {"full": (src, [])}
        jobs.update({name: (src, [f"-DFLASH_BWD_VARIANT={n}"])
                     for n, name in enumerate(VARIANTS, start=1)})
    else:
        jobs = {"full": (src, [])}
        jobs.update({name: (text, []) for name, text in
                     first_design_variants(src).items()})
    procs = {}
    for name, (text, defines) in jobs.items():
        d = OUT / "variants" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "hopper.cuh").write_text((source.parent / "hopper.cuh")
                                      .read_text())
        (d / "flash_attention_bwd.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, *defines, "-o",
             str(d / "libvariant.so"), str(d / "flash_attention_bwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, log = {}, ""
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on variant {name}:\n{text}")
        if name == "full":
            log = text
        lib = ctypes.CDLL(str(OUT / "variants" / name / "libvariant.so"))
        lib.flash_attention_bwd.argtypes = argtypes(convention(src))
        lib.flash_attention_bwd.restype = ctypes.c_int
        libs[name] = lib
    return libs, log


class Inputs:
    """One shape's bf16 inputs (q and k of width qk zero-padded to d), the
    forward kernel's out and lse, and the scratch and gradients a raw call
    of a C entry writes."""

    def __init__(self, gen, b, s, h, kv, qk, d, dv):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(
                torch.bfloat16)

        def padded(t):
            return torch.cat([t, t.new_zeros(t.shape[:-1] + (d - qk,))], -1)

        self.shape = (b, s, h, kv, qk, d, dv)
        self.scale = qk ** -0.5
        self.q, self.k = padded(randn(b, s, h, qk)), padded(randn(b, s, kv,
                                                                  qk))
        self.v = randn(b, s, kv, dv)
        self.dout = randn(b, s, h, dv)
        self.out, self.lse = flash_attention_cuda(self.q, self.k, self.v,
                                                  scale=self.scale,
                                                  return_lse=True)
        self.grads = [torch.empty_like(t) for t in (self.q, self.k, self.v)]
        self.stats = torch.empty(b * h * 2 * (-(-s // BM) * BM),
                                 dtype=torch.float32, device="cuda")
        self.part = None

    def call(self, lib, kind: str) -> None:
        """Call ``lib``'s C entry with the arguments of its convention."""
        b, s, h, kv, _, d, dv = self.shape
        wide = (d, dv) in WIDE_PAIRS
        extra = ()
        if kind == "part":
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            splits = wide_splits(b, s, s, h, kv, "causal", sms=sms) \
                if wide else 1
            if wide and self.part is None:
                self.part = torch.empty(splits * b * s * kv * (d + dv),
                                        dtype=torch.float32, device="cuda")
            extra = (self.part.data_ptr() if wide else None, splits)
        ptrs = [t.data_ptr() for t in (self.q, self.k, self.v, self.out,
                                       self.dout, self.lse, self.stats,
                                       *self.grads)]
        status = lib.flash_attention_bwd(
            *ptrs, *extra, b, s, s, h, kv, d, dv, MASK_KINDS["causal"], 0, 0,
            self.scale, 0, torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise SystemExit(f"flash_attention_bwd failed with CUDA error "
                             f"{status}")


def time_variants(source: Path, gen) -> dict:
    libs, log = build_variants(source)
    for line in log.splitlines():
        if any(w in line for w in ("Function properties", "registers",
                                   "spill", "wgmma")):
            print(f"[ptxas] {line.strip()}", flush=True)
    kind = convention(source.read_text())
    x = Inputs(gen, *SHAPES[WIDE_SHAPE])
    full = libs["full"]
    rows = {"full": {"kernels": kernel_times(lambda: x.call(full, kind), 10,
                                             r"flash_bwd_\w+")}}
    print(f"[variants] full: by CUDA kernel {rows['full']['kernels']}",
          flush=True)
    for name in VARIANTS:
        lib = libs[name]
        row = in_turns(lambda: x.call(full, kind), lambda: x.call(lib, kind))
        row["kernels"] = kernel_times(lambda: x.call(lib, kind), 10,
                                      r"flash_bwd_\w+")
        rows[name] = row
        print(f"[variants] {name}: {row['ms']} ms against the full "
              f"{row['baseline_ms']} ms in turns; by CUDA kernel "
              f"{row['kernels']}", flush=True)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--variants", type=Path, nargs="?", default=None,
                    const=_build.CSRC / "flash_attention_bwd.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    if args.variants is not None:
        rows = time_variants(args.variants, gen)
        print(json.dumps({"device": smi, "shape": WIDE_SHAPE,
                          "source": str(args.variants), "variants": rows},
                         allow_nan=False))
        return
    src = args.baseline.read_text() if args.baseline else ""
    kind = convention(src)
    base = build_baseline(args.baseline, "flash_bwd_time",
                          "flash_attention_bwd", argtypes(kind)) \
        if args.baseline else None
    if base is not None:
        base.flash_attention_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
        base.flash_attention_bwd_smem_bytes.restype = ctypes.c_long
    log = (_build.BUILD_DIR / "flash_attention_bwd.log")
    _lib()
    for line in log.read_text().splitlines() if log.exists() else []:
        if any(w in line for w in ("Function properties", "registers",
                                   "spill", "wgmma")):
            print(f"[ptxas] {line.strip()}", flush=True)
    results = {"wide_ctas_an_sm": {}}
    for d, dv in WIDE_PAIRS:
        ctas = wide_ctas(torch.device("cuda", 0), d, dv)
        print(f"[occupancy] CTAs an SM of the wide dK/dV and dQ kernels at "
              f"({d}, {dv}): {ctas}", flush=True)
        results["wide_ctas_an_sm"][f"{d},{dv}"] = list(ctas)
    for name, (b, s, h, kv, qk, d, dv) in SHAPES.items():
        x = Inputs(gen, b, s, h, kv, qk, d, dv)
        q, k, v, out, dout, lse = x.q, x.k, x.v, x.out, x.dout, x.lse
        kw = dict(scale=x.scale)

        def kernel():
            flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)

        row = {}
        base_here = base
        if base is not None and \
                base.flash_attention_bwd_smem_bytes(d, dv, 0) < 0:
            print(f"[{name}] the baseline is not built for ({d}, {dv})",
                  flush=True)
            base_here = None
        if base_here is not None:
            row.update(in_turns(lambda: x.call(base, kind), kernel))
            got = flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
            x.call(base, kind)
            torch.cuda.synchronize()
            diffs = [float((g.float() - w.float()).abs().max())
                     for g, w in zip(got, x.grads)]
            row["max_abs_diff_vs_baseline"] = dict(zip(("dq", "dk", "dv"),
                                                       diffs))
            row["bitwise_equal_to_baseline"] = all(
                torch.equal(g, w) for g, w in zip(got, x.grads))
            if not row["bitwise_equal_to_baseline"]:
                raise SystemExit(f"[{name}] gradients differ from the "
                                 f"baseline's: {diffs}")
        else:
            row["ms"] = [device_ms(kernel, 20), device_ms(kernel, 20)]
        row["kernels"] = kernel_times(kernel, 10, r"flash_bwd_\w+")
        if base_here is not None:
            row["baseline_kernels"] = kernel_times(
                lambda: x.call(base, kind), 10, r"flash_bwd_\w+")
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        lib_out = sdpa(qg, kg, vg, causal=True, scale=x.scale)
        row["sdpa_backward_ms"] = device_ms(lambda: torch.autograd.grad(
            lib_out, (qg, kg, vg), dout.transpose(1, 2), retain_graph=True),
            20)
        pairs = s * (s + 1) // 2
        five = 2.0 * b * h * pairs * (3 * qk + 2 * dv)
        seven = 2.0 * b * h * pairs * (4 * d + 3 * dv)
        # inputs and gradients once, q and k at the function's own qk
        total = 2 * 2 * (b * s * h * qk + b * s * kv * (qk + dv)) \
            + nbytes(out, dout, lse)
        row["bound5_ms"] = bound(five, total)[0]
        row["bound7_ms"] = bound(seven, total)[0]
        ms = min(row["ms"])
        print(f"[{name}] B{b} S{s} H{h} KV{kv} qk{qk} D{d} Dv{dv} causal: "
              f"kernel "
              f"{row['ms']} ms" + (f", baseline {row['baseline_ms']} ms "
                                   f"(bitwise equal: "
                                   f"{row['bitwise_equal_to_baseline']}; "
                                   f"max |diff| "
                                   f"{row['max_abs_diff_vs_baseline']})"
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
