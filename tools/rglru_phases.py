"""Where the RG-LRU scan kernel's time goes, on the card.

    python3 tools/rglru_phases.py [--baseline OTHER/rglru_scan.cu]

Builds instrumented copies of ``src/repro_torch/kernels/csrc/rglru_scan.cu``
(into the git-ignored ``kernels/_cuda_build/rglru_phases/``) and runs them
at recurrentgemma-2b's prefill shape (B 4, S 1024, C 2560) and at one
request's (B 1), which take the TMA route:

- the CTAs an SM holds at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)
  of both instantiations;
- ``clock64`` stamps, per warp of CTA (0, 0) in its third chunk, of the
  phases of a chunk: the wait for its TMA loads, reading the buffer and
  computing the maps, the barrier, and applying the maps, rescanning into
  the staging tile, the second barrier and (thread 0) the TMA store;
- the kernel's device time (CUDA events over 100 launches, input copies
  in turn so that the 50 MB L2 holds none of them) in full; with h stored
  as the plain-load route stores it, a 2-byte store of every step from
  every thread, instead of through the staging tile and a TMA store
  ("plain stores"); with the exponentials and the square root left out
  ("loads and stores": a = the scaled gate, b = i x); and with the stores
  left out as well ("loads only"; the final state still depends on every
  step, so nothing is dropped as dead code).

``--baseline`` builds another version of the kernel source as it is (for
example the parent commit's, from an unpacked ``git archive``; it must
export the same ``rglru_scan_fwd``) and times it first, beside the
variants, on the same inputs.

A variant's results are not correct; only its time is read.  Needs a GPU
and ``nvcc``; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

OUT = _build.BUILD_DIR / "rglru_phases"
SHAPES = {"serve": (4, 1024, 2560), "one request": (1, 1024, 2560)}
VARIANTS = {"full": [], "plain_stores": ["-DPLAIN_STORES"],
            "loads_stores": ["-DSKIP_MATH"],
            "loads_only": ["-DSKIP_MATH", "-DSKIP_STORES"]}
PHASES = ("wait loads", "read + maps", "barrier", "apply, rescan, store")


def _replace(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"anchor not found once in rglru_scan.cu: {old!r}")
    return src.replace(old, new)


def instrumented() -> str:
    """The kernel source with stamps (STAMP(k) into g_prof[warp][k]), the
    SKIP_* switches and an occupancy query."""
    s = (_build.CSRC / "rglru_scan.cu").read_text()
    s = _replace(s, "namespace {\n", """__device__ long long g_prof[8 * 8];
#ifdef SKIP_STORES
#define STORE 0
#else
#define STORE 1
#endif
#ifdef PLAIN_STORES
#define TMA_STORE 0
#else
#define TMA_STORE 1
#endif
namespace {
""")
    s = _replace(s, "    const long long row0 = (long long)b * S;\n",
                 "    const long long row0 = (long long)b * S;\n"
                 "#define STAMP(k) if (b == 0 && blockIdx.x == 0 && lane == 0"
                 " && c == 2) g_prof[warp * 8 + (k)] = clock64();\n")
    s = _replace(s, "        if constexpr (TMA) hopper::mbar_wait(",
                 "        STAMP(0)\n        if constexpr (TMA) hopper::mbar_wait(")
    s = _replace(s, "#pragma unroll\n        for (int k = 0; k < SUB; ++k) {\n"
                 "            float xv, ra, iv;\n",
                 "        STAMP(1)\n#pragma unroll\n        for (int k = 0; k < SUB;"
                 " ++k) {\n            float xv, ra, iv;\n")
    s = _replace(s, "        __syncthreads();\n        if constexpr (TMA)\n",
                 "        STAMP(2)\n        __syncthreads();\n        STAMP(3)\n"
                 "        if constexpr (TMA)\n")
    s = _replace(s, "        if (warp == WARPS - 1) {\n            carry[",
                 "        STAMP(4)\n        if (warp == WARPS - 1) {\n"
                 "            carry[")
    s = _replace(s, "            av[k] = expf(log_at);\n            bv[k] = sqrtf("
                 "fmaxf(1.f - expf(2.f * log_at), 0.f)) * (iv * xv);\n",
                 "#ifdef SKIP_MATH\n            av[k] = log_at;\n"
                 "            bv[k] = iv * xv;\n#else\n"
                 "            av[k] = expf(log_at);\n            bv[k] = sqrtf("
                 "fmaxf(1.f - expf(2.f * log_at), 0.f)) * (iv * xv);\n#endif\n")
    s = _replace(s, "            if (live && t0 + k < S) a.h[",
                 "            if (STORE && live && t0 + k < S) a.h[")
    s = _replace(s, "                hopper::tma_store_3d(",
                 "                if (STORE) hopper::tma_store_3d(")
    s = _replace(s, "        if constexpr (TMA) {\n            // Through a staging",
                 "        if constexpr (TMA && TMA_STORE) {\n            // Through"
                 " a staging")
    s = _replace(s, 'extern "C" int rglru_scan_fwd',
                 'extern "C" int prof_read(long long* h) { return (int)'
                 'cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof)); }\n'
                 'extern "C" int blocks_per_sm(int tma) {\n'
                 '    const auto k = tma ? rglru_scan_kernel<true> : '
                 'rglru_scan_kernel<false>;\n'
                 '    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicShared'
                 'MemorySize, Layout::bytes);\n'
                 '    int n = -1;\n'
                 '    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, '
                 'THREADS, Layout::bytes);\n    return n;\n}\n'
                 'extern "C" int rglru_scan_fwd')
    return s


def build(baseline: Path | None) -> list:
    """Build the variants (and the baseline) in parallel; their names."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "hopper.cuh").write_text((_build.CSRC / "hopper.cuh").read_text())
    (OUT / "phases.cu").write_text(instrumented())
    sources = {name: [*flags, str(OUT / "phases.cu")]
               for name, flags in VARIANTS.items()}
    if baseline is not None:
        sources = {"baseline": ["-I", str(baseline.parent), str(baseline)],
                   **sources}
    procs = {name: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
         str(OUT / f"lib{name}.so"), *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, args in sources.items()}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on variant {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[rglru_phases] {name}: {line.strip()}", flush=True)
    return list(sources)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another rglru_scan.cu to time beside the variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    names = build(args.baseline)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    p, i = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for name in names:
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        # A source before the optional entering states takes one pointer
        # fewer.
        source = args.baseline if name == "baseline" else OUT / "phases.cu"
        ptrs = 8 if "void* entering" in source.read_text() else 7
        lib.rglru_scan_fwd.argtypes = [p] * ptrs + [i] * 3 + [
            ctypes.c_float, i, p]
        libs[name] = (lib, ptrs)
    print(f"[rglru_phases] CTAs an SM holds: TMA route "
          f"{libs['full'][0].blocks_per_sm(1)}, plain loads "
          f"{libs['full'][0].blocks_per_sm(0)}", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    for label, (B, S, C) in SHAPES.items():
        copies = [((randn(B, S, C) * 0.5).to(torch.bfloat16),
                   torch.sigmoid(randn(B, S, C)),
                   torch.sigmoid(randn(B, S, C)),
                   -torch.nn.functional.softplus(randn(C)))
                  for _ in range(-(-100_000_000 // (B * S * C * 10)))]
        h = torch.empty((B, S, C), dtype=torch.bfloat16, device="cuda")
        state = torch.empty((B, C), device="cuda")
        for name, (lib, ptrs) in libs.items():
            turn = [0]

            def run():
                x, ga, gi, la = copies[turn[0] % len(copies)]
                turn[0] += 1
                status = lib.rglru_scan_fwd(
                    x.data_ptr(), ga.data_ptr(), gi.data_ptr(), la.data_ptr(),
                    None, h.data_ptr(), state.data_ptr(),
                    *[None] * (ptrs - 7), B, S, C, 8.0, x.device.index,
                    stream)
                if status:
                    raise SystemExit(f"{name}: launch failed with CUDA error "
                                     f"{status}")

            for _ in range(3):
                run()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(100_000_000)    # the host enqueues meanwhile
            start.record()
            for _ in range(100):
                run()
            end.record()
            torch.cuda.synchronize()
            print(f"[rglru_phases] {label} B{B} S{S} C{C} {name}: "
                  f"{start.elapsed_time(end) / 100:.4f} ms on the device",
                  flush=True)
            if name == "full":
                stamps = (ctypes.c_longlong * 64)()
                lib.prof_read(stamps)
                print("[rglru_phases] cycles per phase of chunk 2, CTA (0, "
                      "0): " + " | ".join(PHASES), flush=True)
                for w in range(8):
                    t = [stamps[w * 8 + k] for k in range(5)]
                    cycles = " ".join(f"{t[k + 1] - t[k]:6d}"
                                      for k in range(4))
                    print(f"[rglru_phases]   warp {w}: {cycles}", flush=True)


if __name__ == "__main__":
    main()
