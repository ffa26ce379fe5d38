"""Where the SSD scan kernel's time goes, on the card.

    python3 tools/ssd_phases.py

Builds instrumented copies of ``src/repro_torch/kernels/csrc/ssd_scan.cu``
(into the git-ignored ``kernels/_cuda_build/phases/``) and runs them at
mamba2-2.7b's serve shape (B 4, S 1024, H 80, P 64, G 1, N 128, chunk 128),
which takes the fixed-shape kernel:

- ``clock64`` stamps, per warp of CTA (0, 0) in its third chunk, of the
  phases of a chunk: issuing the next chunk's loads, the cumsum, the y
  tiles (C state^T, the triangle, the store), the state product, the
  barrier, the bf16 state copy, and the wait for the next chunk;
- the kernel's device time (CUDA events over 20 launches) in full and with
  the triangle, C state^T, the state product, or all three skipped, so
  that each product's share and the floor the loads set can be read off.
  (The loads themselves cannot be skipped: the waits on their mbarriers
  would poll for minutes before trapping.)

A variant's results are not correct; only its time is read.  Needs a GPU
and ``nvcc``; exits non-zero without them.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

OUT = _build.BUILD_DIR / "phases"
B, S, H, P, G, N, Q = 4, 1024, 80, 64, 1, 128, 128
VARIANTS = {"full": [], "skip_triangle": ["-DSKIP_TRIANGLE"],
            "skip_inter": ["-DSKIP_INTER"], "skip_state": ["-DSKIP_STATE"],
            "loads_only": ["-DSKIP_TRIANGLE", "-DSKIP_INTER", "-DSKIP_STATE"]}
PHASES = ("issue loads", "cumsum", "y tiles", "state", "barrier",
          "state copy", "wait next")


def _insert(src: str, anchor: str, text: str, before: bool = True) -> str:
    if src.count(anchor) != 1:
        raise SystemExit(f"anchor not found once in ssd_scan.cu: {anchor!r}")
    return src.replace(anchor, text + anchor if before else anchor + text)


def instrumented() -> str:
    """The kernel source with stamps (STAMP(k) into g_prof[warp][k]) and
    the SKIP_* switches."""
    s = (_build.CSRC / "ssd_scan.cu").read_text()
    s = _insert(s, "namespace {\n", """__device__ long long g_prof[8 * 16];
#ifdef SKIP_INTER
#define INTER 0
#else
#define INTER 1
#endif
#ifdef SKIP_TRIANGLE
#define SB_END sb0
#else
#define SB_END sb1
#endif
#ifdef SKIP_STATE
#define STATE_K 0
#else
#define STATE_K (Qp / 16)
#endif
""")
    s = _insert(s, 'extern "C" long ssd_scan_smem_bytes',
                'extern "C" int prof_read(long long* h) { return (int)'
                'cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof)); }\n')
    s = _insert(s, "    const float a2 = a.A[h] * LOG2E;\n",
                "#define STAMP(k) if (b == 0 && h == 0 && lane == 0 && c == 2)"
                " g_prof[warp * 16 + (k)] = clock64();\n", before=False)
    stamps = [
        ("        if (c + 1 < nc) load(c + 1);\n", 0, True),
        ("        if (c + 1 < nc) load(c + 1);\n", 1, False),
        ("        // -- y = exp(cum_t) (C state^T)", 2, True),
        ("        // -- state = state exp(cum_Q)", 3, True),
        ("        __syncthreads();                 // every read of the "
         "entering", 4, True),
        ("        if (owns_state) write_state(st, Sts, LDB, sm, sn0, tiles);"
         "\n        hopper", 5, True),
        ("        hopper::cp_async_wait_all();\n        __syncthreads();    "
         "             // the next chunk", 6, True),
        ("// the next chunk and its state are in place\n", 7, False),
    ]
    for anchor, k, before in stamps:
        s = _insert(s, anchor, f"        STAMP({k})\n", before)
    for old, new in [("            if (inter) {\n",
                      "            if (inter && INTER) {\n"),
                     ("kk < Qp / 16; ++kk) {\n                const int k0",
                      "kk < STATE_K; ++kk) {\n                const int k0"),
                     ("if (sb0 < sb1) cb_block", "if (sb0 < SB_END) cb_block")]:
        if s.count(old) != 1:
            raise SystemExit(f"anchor not found once in ssd_scan.cu: {old!r}")
        s = s.replace(old, new)
    if s.count("sb < sb1; ++sb) {") != 2:
        raise SystemExit("anchor not found twice in ssd_scan.cu: sb loops")
    return s.replace("sb < sb1; ++sb) {", "sb < SB_END; ++sb) {")


def build() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "hopper.cuh").write_text((_build.CSRC / "hopper.cuh").read_text())
    (OUT / "phases.cu").write_text(instrumented())
    procs = {name: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o",
         str(OUT / f"lib{name}.so"), str(OUT / "phases.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in VARIANTS.items()}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on variant {name}:\n{log}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x = (randn(B, S, H, P) * 0.5).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(randn(B, S, H))
    A = -torch.exp(randn(H))
    Bm = (randn(B, S, G, N) * 0.3).to(torch.bfloat16)
    Cm = (randn(B, S, G, N) * 0.3).to(torch.bfloat16)
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), device="cuda")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in VARIANTS:
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        lib.ssd_scan_fwd.argtypes = [p] * 8 + [i] * 8 + [p]
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            status = lib.ssd_scan_fwd(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), None, y.data_ptr(), state.data_ptr(), B, S, H,
                P, G, N, Q, x.device.index, stream)
            if status:
                raise SystemExit(f"{name}: launch failed with CUDA error "
                                 f"{status}")

        run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            run()
        end.record()
        torch.cuda.synchronize()
        print(f"[ssd_phases] {name}: {start.elapsed_time(end) / 20:.4f} ms "
              f"on the device", flush=True)
        if name == "full":
            stamps = (ctypes.c_longlong * 128)()
            lib.prof_read(stamps)
            print("[ssd_phases] cycles per phase of chunk 2, CTA (0, 0): "
                  + " | ".join(PHASES), flush=True)
            for w in range(8):
                t = [stamps[w * 16 + k] for k in range(8)]
                cycles = " ".join(f"{t[k + 1] - t[k]:6d}" for k in range(7))
                print(f"[ssd_phases]   warp {w}: {cycles}", flush=True)


if __name__ == "__main__":
    main()
