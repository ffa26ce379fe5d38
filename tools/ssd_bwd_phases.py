"""Where the time of the SSD-scan backward goes, on the card.

    python3 tools/ssd_bwd_phases.py [--root TREE]

Times variants of the backward in ``TREE``'s ``csrc/ssd_scan_bwd.cu`` (by
default this tree's; for another design, an unpacked ``git archive`` of a
commit that has it).  Each variant is that source with one part of the
chunk kernel's work left out, built with ``nvcc`` into the git-ignored
``kernels/_cuda_build/ssd_bwd_phases/`` and called through ``TREE``'s own
wrapper (which allocates the design's scratch), at mamba2-2.7b's training
shape (B 4, S 1024, 80 heads of P 64, G 1, N 128, chunk 128).  The
variants follow the design the source has:

- the per-head design (one CTA per (batch, head, chunk) on ``mma.sync``,
  per-head fp32 dB / dC partials): ``no_partials``, no stores of the
  partials (the products that feed them still run: the stores sit behind
  a condition the compiler cannot decide); ``no_triangles``, none of the
  16 x 16 triangle blocks (C Bᵀ, x dyᵀ, dy xᵀ and the products they feed);
  ``no_state``, none of the three state products (B dhᵀ, x dh, dy h);
  ``no_state_reads``, no read of the fp32 states and state gradients;
- the head-slice design (one CTA per slice of a group's heads on wgmma,
  one partial a slice): ``no_triangles``, no Zᵀ·C and Z·B;
  ``no_state``, none of the four state products (B dhᵀ, C hᵀ, dy h,
  x dh); ``no_masks``, no scaling of L' and Zᵀ (no exp2, no C Bᵀ read, L'
  zeros); ``no_scan``, no da scan (nor ddt, nor dA).

For each it prints the device time of the whole call (CUDA events over 20
calls) and of each CUDA kernel (torch.profiler over 10 calls), and for
``full`` the ``-Xptxas -v`` lines of every kernel (registers, spills,
shared memory).  A variant's gradients are not correct; only its time is
read.  Prints the card's name and power limit first and a JSON line
last.  Needs a GPU and ``nvcc``; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

# baseline puts the repo root and src/ on sys.path
from baseline import ROOT, card, import_tree
from chip_smoke import device_ms, kernel_times
from repro_torch.kernels import _build

OUT = _build.BUILD_DIR / "ssd_bwd_phases"
B, S, H, P, G, N, CHUNK = 4, 1024, 80, 64, 1, 128, 128
# A condition that is false at run time but that the compiler cannot fold.
NEVER = "(a.S < 0)"


def _swap(src: str, old: str, new: str, count: int) -> str:
    if src.count(old) != count:
        raise SystemExit(f"anchor found {src.count(old)} times, not {count},"
                         f" in the chunk kernel: {old!r}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    """The source of each variant, for the design the source has."""
    out = {"full": src}
    if "G x slices" in src:
        out["no_triangles"] = _swap(
            src, "for (int kk = 0; kk < 4 * T; ++kk) {\n"
            "                wgmma_ss<NA, 0, 1>(dB",
            "for (int kk = 0; kk < 0; ++kk) {\n"
            "                wgmma_ss<NA, 0, 1>(dB", 1)
        s = src
        for product in ("wgmma_ss_tiles<NW>(u, ", "wgmma_ss_tiles<NW>(v, ",
                        "wgmma_rs<NA>(dC, fa[kk]", "wgmma_rs<NA>(dB, xa[kk]"):
            s = _swap(s, product, "if (0) " + product, 1)
        out["no_state"] = s
        out["no_masks"] = _swap(src, "if (j >= rt) {", "if (j < 0) {", 2)
        out["no_scan"] = _swap(src, "if (warp == 0) {\n            // ... then",
                               "if (warp < 0) {\n            // ... then", 1)
        return out
    s = _swap(src, "if (n < N) dst[0] = acc[j][2 * half];",
              f"if (n < N && {NEVER}) dst[0] = acc[j][2 * half];", 2)
    out["no_partials"] = _swap(
        s, "if (n + 1 < N) dst[1] = acc[j][2 * half + 1];",
        f"if (n + 1 < N && {NEVER}) dst[1] = acc[j][2 * half + 1];", 2)
    s = _swap(src, "for (int tb = r; tb < Qp / 16; ++tb) {",
              "for (int tb = r; tb < 0; ++tb) {", 2)
    out["no_triangles"] = _swap(s, "for (int sb = 0; sb <= r; ++sb) {",
                                "for (int sb = 0; sb < 0; ++sb) {", 1)
    s = _swap(src, "for (int kk = 0; kk < Np / 16; ++kk) {",
              "for (int kk = 0; kk < 0; ++kk) {", 1)
    s = _swap(s, "for (int kk = 0; kk < Pp / 16; ++kk) {\n"
              "                uint32_t af[4];\n"
              "                hopper::ldmatrix_x4(af, xrow",
              "for (int kk = 0; kk < 0; ++kk) {\n"
              "                uint32_t af[4];\n"
              "                hopper::ldmatrix_x4(af, xrow", 1)
    out["no_state"] = _swap(s, "mma_rows_kn(acc, DYs, LDX, r0, Hs, LDB, Pp,"
                            " Np);", "mma_rows_kn(acc, DYs, LDX, r0, Hs, LDB,"
                            " 0, Np);", 1)
    out["no_state_reads"] = _swap(
        src, "for (int i = tid * 4; i < Pp * Np; i += THREADS * 4) {",
        "for (int i = tid * 4; i < 0; i += THREADS * 4) {", 1)
    return out


def build(csrc: Path) -> dict:
    """Build every variant at once; returns each variant's ptxas log."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "hopper.cuh").write_text((csrc / "hopper.cuh").read_text())
    procs = {}
    for name, text in variants((csrc / "ssd_scan_bwd.cu").read_text()
                               ).items():
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = card()
    tree = import_tree(args.root, "kernels.ssd_scan_bwd")
    logs = build(Path(tree._build.CSRC))
    for line in logs["full"].splitlines():
        if any(w in line for w in ("Function properties", "registers",
                                   "spill", "smem")):
            print(f"[ptxas] {line.strip()}", flush=True)
    own = tree._lib()          # the tree's build: its argument types
    entry = own.ssd_scan_bwd

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x = (randn(B, S, H, P) * 0.5).to(torch.bfloat16)
    dt, A = F.softplus(randn(B, S, H)), -torch.exp(randn(H))
    Bm = (randn(B, S, G, N) * 0.3).to(torch.bfloat16)
    Cm = (randn(B, S, G, N) * 0.3).to(torch.bfloat16)
    dy = randn(B, S, H, P).to(torch.bfloat16)
    rows = {}
    for name in logs:
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        lib.ssd_scan_bwd.argtypes = entry.argtypes
        lib.ssd_scan_bwd.restype = entry.restype
        tree._lib = lambda lib=lib: lib

        def call():
            return tree.ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, chunk=CHUNK)

        call()
        torch.cuda.synchronize()
        rows[name] = {"ms": device_ms(call, 20),
                      "kernels": kernel_times(call, 10, r"ssd_bwd_\w+")}
        print(f"[ssd_bwd_phases] {name}: {rows[name]['ms']:.4f} ms; by CUDA "
              f"kernel {rows[name]['kernels']}", flush=True)
    print(json.dumps({"device": smi, "shape": f"B{B} S{S} H{H} P{P} G{G} "
                      f"N{N} chunk {CHUNK}", "variants": rows},
                     allow_nan=False))


if __name__ == "__main__":
    main()
