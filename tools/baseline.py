"""What the kernel timing tools share: the card's name, another version of
a kernel source built for comparison, another tree's wrapper module, and
two versions timed in turns.

Imported by ``tools/flash_bwd_time.py``, ``tools/ssd_bwd_time.py`` and
``tools/ssd_bwd_phases.py``; needs a GPU and ``nvcc`` when its functions
run.
"""

from __future__ import annotations

import ctypes
import importlib
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import device_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402


def card() -> str:
    """``nvidia-smi``'s name and power limit of the first card, printed."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return smi


def build_baseline(source: Path, out: str, entry: str,
                   argtypes: list) -> ctypes.CDLL:
    """Build ``source`` as it is (with its ``hopper.cuh`` beside it) into
    the git-ignored ``kernels/_cuda_build/<out>/`` and bind its C
    ``entry`` (returning an int status) with ``argtypes``."""
    out_dir = _build.BUILD_DIR / out
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libbaseline.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(source.parent),
           "-o", str(lib), str(source)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise SystemExit(f"baseline build failed:\n{done.stdout}{done.stderr}")
    dll = ctypes.CDLL(str(lib))
    fn = getattr(dll, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return dll


def import_tree(root: Path, module: str, alias: str = "baseline_port"):
    """Import ``module`` (e.g. ``kernels.ssd_scan_bwd``) of the port in
    another tree (``root/src/repro_torch``, for example an unpacked
    ``git archive`` of the parent commit) as ``<alias>.<module>``, beside
    this tree's ``repro_torch``.  Its relative imports resolve inside that
    tree, so its wrapper allocates its own scratch and builds its own
    sources into that tree's git-ignored ``kernels/_cuda_build/``."""
    if alias not in sys.modules:
        init = Path(root).resolve() / "src" / "repro_torch" / "__init__.py"
        if not init.exists():
            raise SystemExit(f"no port package under {root}")
        spec = importlib.util.spec_from_file_location(
            alias, init, submodule_search_locations=[str(init.parent)])
        package = importlib.util.module_from_spec(spec)
        sys.modules[alias] = package
        spec.loader.exec_module(package)
    return importlib.import_module(f"{alias}.{module}")


def in_turns(baseline, kernel, iters: int = 20) -> dict:
    """Device ms of each version, timed baseline, kernel, kernel,
    baseline so that a drift in the card's clock falls on both."""
    times = [device_ms(f, iters) for f in (baseline, kernel, kernel,
                                            baseline)]
    return {"baseline_ms": [times[0], times[3]], "ms": [times[1], times[2]]}
