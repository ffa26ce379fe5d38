"""Where a test's time goes: the JAX package and jax, or the port and
torch, by cProfile.

    python3 tools/test_time_split.py TEST_ID [TEST_ID ...]

Collects the ids' files once (their imports), then runs each pytest id
(``tests/f.py::test[param]``) twice in this process: cold, timed by the
wall clock (what a fresh worker pays: jax's tracing and compilation of
the test's shapes, the first torch calls), then warm under ``cProfile``,
summing each function's own time by where it lives: ``jax`` (jax, jaxlib
and the JAX package, ``src/repro/``), ``port`` (torch and
``src/repro_torch/``) or ``other`` (numpy, pytest, ``gc``, the
interpreter).  Prints each id's cold and warm wall seconds and the three
sums.  cProfile adds a cost to every Python call, so the split is a
guide to which side to cut, not a timing.  Needs no GPU; the tests it
runs import jax themselves.
"""

from __future__ import annotations

import cProfile
import pstats
import sys
import time

import pytest


def side(filename: str, name: str) -> str:
    where = f"{filename} {name}"
    if "/src/repro/" in where or "jax" in where:
        return "jax"
    if "repro_torch" in where or "torch" in where:
        return "port"
    return "other"


def main(argv=None) -> dict:
    ids = list(argv or sys.argv[1:])
    args = ["-q", "-p", "no:cacheprovider", "-p", "no:randomly"]
    pytest.main(args + ["--collect-only"] + sorted({t.split("::")[0]
                                                    for t in ids}))
    out = {}
    for test in ids:
        t0 = time.perf_counter()
        pytest.main(args + [test])
        cold = time.perf_counter() - t0
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        code = pytest.main(args + [test])
        prof.disable()
        wall = time.perf_counter() - t0
        sums = {"jax": 0.0, "port": 0.0, "other": 0.0}
        for (filename, _, name), row in pstats.Stats(prof).stats.items():
            sums[side(filename, name)] += row[2]        # own time
        out[test] = {"cold_s": cold, "wall_s": wall, "exit": int(code),
                     **sums}
        print(f"[split] {test}: cold {cold:.2f} s, warm {wall:.2f} s wall "
              f"(exit {int(code)}); warm own time jax {sums['jax']:.2f} s, "
              f"port {sums['port']:.2f} s, other {sums['other']:.2f} s",
              flush=True)
    return out


if __name__ == "__main__":
    main()
