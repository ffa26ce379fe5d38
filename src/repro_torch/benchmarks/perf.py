"""Persistent DES perf-benchmark lane (DESIGN.md Section 8).

Measures the discrete-event simulator's hot-path throughput (blocks/sec)
and the cold/warm wall time of the flagship sweep on standardized
workloads, and writes ``BENCH_des_torch.json`` in the working directory
(never the reference's ``BENCH_des.json``)::

    {"commit": "<git sha>", "created": ..., "smoke": false,
     "baseline": {...the port's own baseline measurements...},
     "rows": [{"name": ..., ...}, ...]}

Workloads (full mode):

* ``table5`` — the paper's flagship grid (56 pair-stagger workloads x all
  Table-5 policies + the multi-seed CI rows), run exactly as
  ``repro_torch.benchmarks.run table5 --jobs 4`` runs it: one cold pass
  against a fresh cache directory and one warm rerun against the same
  directory.  This is the wall-time lane every perf PR reports against.
* ``blocks_per_sec.*`` — single-process simulator throughput on three
  shapes: a heavy ERCBench pair (SHA1+SAD), a 10x-scaled four-program
  mix, and a near-saturation closed-loop M/G/k cell.

``--smoke`` keeps the lane shape but shrinks every workload (CI runs it
per push and uploads the JSON as an artifact, so the perf trajectory
accumulates).  The ``baseline`` block pins the port's own measurements,
taken with this same protocol on the host of an NVIDIA H100 machine — the
reference every later run compares against; superseded baselines move
under ``history`` (empty so far) so the whole trajectory stays readable
from one file.

Throughput rows run per engine: the reference Python event loop
(``blocks_per_sec.<wl>``, comparable to the baseline block) and the
compiled flat-array engine (``blocks_per_sec.<wl>.compiled``, with its
``speedup_vs_baseline``); ``--engine`` restricts the lane to one of them
(``make bench-compiled``).

Usage::

    PYTHONPATH=src python -m repro_torch.benchmarks.perf [--smoke]
        [--jobs 4] [--out BENCH_des_torch.json] [--repeat 2]
        [--engine both|python|compiled]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from ..core.fastsim import FastSimulator, backend_name
from ..core.policies import make_policy
from ..core.scenarios import MGkClosed, NProgramMix
from ..core.simulator import Simulator, solo_runtime
from ..core.workload import Arrival, ERCBENCH, scaled_spec

#: The port's own measurements (tools/perf_baseline.py): this lane in full
#: mode, ``--jobs 4 --repeat 3``, on the host of an NVIDIA H100 machine, at
#: the last commit that changed the port's ``core`` — the floor the
#: compiled engine is measured against (best-of-3; the host's CPUs are
#: shared, so the best — least-contended — observation is the comparable
#: one).
BASELINE = {
    "commit": "f2ed5ff",
    "protocol": ("best-of-3 measurements of `python -m "
                 "repro_torch.benchmarks.perf --jobs 4 --repeat 3` "
                 "(tools/perf_baseline.py; blocks/sec of the python engine, "
                 "table5 walls under compiled-native) of "
                 "src/repro_torch/core at f2ed5ff, on GenuineIntel family 6 "
                 "model 207 stepping unknown (model name unknown), 8 "
                 "processors in /proc/cpuinfo, 8 usable, beside NVIDIA H100 "
                 "80GB HBM3, 700.00 W; best = least-contended observation"),
    "table5.cold.jobs4.wall_s.best": 2.88,
    "table5.warm.jobs4.wall_s.best": 2.14,
    "blocks_per_sec.table5_pair": 71_479.3,
    "blocks_per_sec.mix4_10x": 179_938.5,
    "blocks_per_sec.mgk_saturated": 14_088.5,
}

#: Superseded baseline blocks, oldest first (each was ``BASELINE`` for a
#: span of commits; re-baselining moves the old block here).
HISTORY = []


def _git_commit() -> str:
    root = Path(__file__).resolve().parents[3]
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, check=True,
            cwd=root).stdout.strip()
        dirty = subprocess.run(
            ["git", "status", "--porcelain"],
            capture_output=True, text=True, check=True,
            cwd=root).stdout.strip()
        # A dirty tree's rows must not be attributed to the commit alone —
        # the trajectory would claim HEAD produced numbers it didn't.
        return f"{sha}-dirty" if dirty else sha
    except Exception:
        return "unknown"


def _blocks(sim: Simulator) -> int:
    return sum(run.done for run in sim.runs.values())


#: Engine name -> simulator class for the throughput rows.
_SIM_CLS = {"python": Simulator, "compiled": FastSimulator}


def _engine_label(engine: str) -> str:
    return "python" if engine == "python" else f"compiled-{backend_name()}"


_backend_detail_memo = None


def _backend_detail() -> str:
    """Toolchain provenance of the active compiled backend: the exact cc
    version line (native), numba's version (jit), or "" for the
    interpreted twin, which has no toolchain to record."""
    global _backend_detail_memo
    if _backend_detail_memo is not None:
        return _backend_detail_memo
    backend = backend_name()
    if backend == "native":
        cc = os.environ.get("CC", "cc")
        try:
            line = subprocess.run(
                [cc, "--version"], capture_output=True, text=True,
                check=True).stdout.splitlines()[0].strip()
        except Exception:
            line = f"{cc} (version unavailable)"
        detail = line
    elif backend == "numba":
        import numba
        detail = f"numba {numba.__version__}"
    else:
        detail = ""
    _backend_detail_memo = detail
    return detail


def _throughput(label: str, build, repeat: int, engine: str,
                smoke: bool) -> dict:
    """Best-of-``repeat`` blocks/sec for one simulation builder.

    The python-engine row keeps the bare ``blocks_per_sec.<label>`` name
    (continuous with the whole trajectory); the compiled-engine row is
    ``.compiled``-suffixed and carries its speedup against the baseline
    block's python-engine floor.
    """
    best = None
    blocks = 0
    for _ in range(repeat):
        sim, until = build(_SIM_CLS[engine])
        t0 = time.perf_counter()
        sim.run(until=until)
        dt = time.perf_counter() - t0
        blocks = _blocks(sim)
        rate = blocks / dt if dt > 0 else float("inf")
        if best is None or rate > best:
            best = rate
    name = f"blocks_per_sec.{label}"
    row = {"name": name if engine == "python" else f"{name}.compiled",
           "blocks": blocks, "blocks_per_sec": round(best, 1),
           "engine": _engine_label(engine)}
    base = None if smoke else BASELINE.get(name)
    if base:
        row["speedup_vs_baseline"] = round(best / base, 2)
    return row


def _throughput_rows(smoke: bool, repeat: int, engines) -> list:
    scale = 1 if smoke else 10
    solos = {name: solo_runtime(spec, lambda: make_policy("fifo"))
             for name, spec in ERCBENCH.items()}

    def pair(cls):
        names = ("JPEG-d", "SAD") if smoke else ("SHA1", "SAD")
        arrivals = [Arrival(ERCBENCH[names[0]], 0.0, uid=f"{names[0]}#0"),
                    Arrival(ERCBENCH[names[1]], 100.0, uid=f"{names[1]}#1")]
        return cls(arrivals, make_policy("srtf-adaptive"),
                   oracle_runtimes=solos), None

    #: 10x-scaled four-program mix: the Section-6-scale shape that the
    #: load-curve story needs (each spec's grid is 10x the Table-2 one).
    big = {n: scaled_spec(s, num_blocks=s.num_blocks * scale)
           for n, s in ERCBENCH.items() if n != "SHA1"}

    def mix(cls):
        scn = NProgramMix(seed=0, names=sorted(big), specs=big,
                          n_programs=4, n_workloads=1)
        (_, arrivals), = scn.workloads()
        return cls(arrivals, make_policy("srtf"),
                   oracle_runtimes=solos), None

    def mgk(cls):
        scn = MGkClosed(seed=0, n_total=(8 if smoke else 60),
                        mean_interarrival=20_000.0, population=8)
        sim = cls([], make_policy("srtf-adaptive"),
                  oracle_runtimes=solos)
        sim.attach_arrival_source(scn.make_process(scn.process_names()[0]))
        return sim, None

    rows = []
    for engine in engines:
        rows += [
            _throughput("table5_pair", pair, repeat, engine, smoke),
            _throughput("mix4_10x" if not smoke else "mix4", mix, repeat,
                        engine, smoke),
            _throughput("mgk_saturated", mgk, repeat, engine, smoke),
        ]
    if "compiled" in engines:
        rows.append(_segment_exit_row(mgk))
    return rows


def _segment_exit_row(build) -> dict:
    """Exit-code histogram of one compiled-engine closed-loop run — the
    boundary-amortization measurement itself.  Each count is one engine
    segment and the code says why it ended (0/1 done, 2 completion
    handoff, 5 decision-buffer regrow, 7 variate-pool regrow); fewer
    segments per run means fewer Python boundary crossings."""
    sim, until = build(FastSimulator)
    sim.run(until=until)
    exits = {str(code): n for code, n in sorted(sim.segment_exits.items())}
    return {"name": "segment_exits.mgk_saturated",
            "engine": _engine_label("compiled"),
            "exits": exits,
            "segments": sum(sim.segment_exits.values())}


#: Worker count of the dispatch lane — mirrors ``make smoke-dispatch``
#: (a 2-worker localhost farm) and keeps the comparison meaningful on
#: single-CPU CI runners, where extra pool workers only add contention.
DISPATCH_LANE_WORKERS = 2


def _dispatch_rows(smoke: bool, repeat: int) -> list:
    """Cold-sweep cells/sec of the *dispatch tier* under local vs. queue
    dispatch at equal worker count (the PR-9 lane: chunked compiled-engine
    reuse vs. per-cell pool dispatch).

    The workload is many *tiny* DES cells — a four-program mix truncated
    to two blocks per kernel on four SMs — so per-cell dispatch overhead
    (pool task + pickle + one JSON file per record) dominates simulation
    time; that is exactly the regime large sweeps with a fast engine live
    in (DESIGN.md Section 12).  The rate divides computed cells by the
    sweep's ``dispatch_s`` stat — the bracket around the dispatch tier
    alone (pending list -> committed records).  Grid keying and result
    assembly run identical code under either dispatcher and would only
    dilute the comparison; ``total_s`` still records the end-to-end wall
    time of each best pass.  Every pass starts from a fresh cache
    directory; the queue row carries ``speedup_vs_local``.
    """
    from ..core.scenarios import NProgramMix
    from ..core.sweep import SweepSpec, clear_cache_memo, run_sweeps

    workers = DISPATCH_LANE_WORKERS
    tiny = {n: scaled_spec(s, num_blocks=2)
            for n, s in ERCBENCH.items() if n != "SHA1"}
    scn = NProgramMix(seed=0, names=sorted(tiny), specs=tiny,
                      n_programs=2, n_workloads=(12 if smoke else 300))
    spec = SweepSpec(
        scenarios=(scn,),
        policies=("fifo", "srtf", "srtf-adaptive", "mpmax"),
        seeds=(0,), n_sm=4)

    # Both rates ride the container's CPU-frequency drift, and the lane is
    # cheap (~2 s/pass) next to the heavy sweep rows — so it takes more
    # best-of passes for the least-contended observation to surface on
    # each side of the ratio.
    passes = repeat if smoke else max(repeat, 4)
    rows = []
    local_rate = None
    for disp in ("local", "queue"):
        best = best_total = None
        cells = chunk = 0
        for _ in range(passes):
            cache_dir = Path(tempfile.mkdtemp(prefix="bench_dispatch_"))
            try:
                clear_cache_memo()
                t0 = time.perf_counter()
                (res,) = run_sweeps([spec], jobs=workers,
                                    cache_dir=cache_dir, dispatcher=disp,
                                    workers=workers)
                dt = time.perf_counter() - t0
            finally:
                shutil.rmtree(cache_dir, ignore_errors=True)
            cells = int(res.stats["computed"])
            chunk = int(res.stats.get("queue_chunk", 0))
            dispatch_s = float(res.stats["dispatch_s"])
            rate = cells / dispatch_s if dispatch_s > 0 else float("inf")
            if best is None or rate > best:
                best, best_total = rate, dt
        row = {"name": f"sweep_cells_per_sec.{disp}", "cells": cells,
               "cells_per_sec": round(best, 1), "workers": workers,
               "total_s": round(best_total, 3),
               "engine": _engine_label(
                   "python" if backend_name() == "interp" else "compiled")}
        if disp == "local":
            local_rate = best
        else:
            row["chunk"] = chunk
            if local_rate:
                row["speedup_vs_local"] = round(best / local_rate, 2)
        rows.append(row)
    return rows


def _sweep_rows(smoke: bool, jobs: int, repeat: int,
                engine: str = "auto") -> list:
    """Cold + warm wall time of the flagship table5 sweep, exactly as the
    benchmark driver runs it (``benchmarks.run table5 --jobs N``) — under
    ``engine`` (``auto`` = the driver's compiled-when-available default).

    Each phase is measured ``repeat`` times and the best run is recorded
    (the container's CPU allocation fluctuates; the least-contended
    observation is the comparable one — the baseline uses the same rule).
    A cold pass always starts from a fresh cache directory.
    """
    rows = []
    # The child runs from an empty temporary directory, where no package of
    # the reference can be imported, with the port's ``src`` first on its
    # path (a relative ``PYTHONPATH`` would not resolve from there).
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))

    def one_pass(cache_dir: Path) -> float:
        argv = [sys.executable, "-m", "repro_torch.benchmarks.run", "table5",
                "--jobs", str(jobs), "--cache-dir", str(cache_dir),
                "--engine", engine]
        if smoke:
            argv += ["--subset", "4"]
        with tempfile.TemporaryDirectory(prefix="bench_cwd_") as cwd:
            t0 = time.perf_counter()
            subprocess.run(argv, check=True, cwd=cwd, env=env,
                           stdout=subprocess.DEVNULL)
            return time.perf_counter() - t0

    cold = warm = None
    warm_dir = None
    try:
        for _ in range(repeat):
            cache_dir = Path(tempfile.mkdtemp(prefix="bench_des_"))
            wall = one_pass(cache_dir)
            if cold is None or wall < cold:
                cold = wall
            if warm_dir is not None:
                shutil.rmtree(warm_dir, ignore_errors=True)
            warm_dir = cache_dir
        for _ in range(repeat):
            wall = one_pass(warm_dir)
            if warm is None or wall < warm:
                warm = wall
    finally:
        if warm_dir is not None:
            shutil.rmtree(warm_dir, ignore_errors=True)
    for phase, wall in (("cold", cold), ("warm", warm)):
        row = {"name": f"table5.{phase}.jobs{jobs}",
               "wall_s": round(wall, 2), "best_of": repeat,
               # "auto" resolves the same way in the subprocess as here:
               # compiled unless only the interpreted twin is available.
               "engine": ("python"
                          if engine == "python" or backend_name() == "interp"
                          else _engine_label("compiled"))}
        if not smoke:
            best = BASELINE.get(f"table5.{phase}.jobs{jobs}.wall_s.best")
            if best is not None:
                row["baseline_wall_s_best"] = best
                row["speedup_vs_baseline_best"] = round(best / wall, 2)
        rows.append(row)
    return rows


def run(smoke: bool = False, jobs: int = 4, repeat: int = 2,
        out: Path = Path("BENCH_des_torch.json"),
        engine: str = "both") -> dict:
    engines = ("python", "compiled") if engine == "both" else (engine,)
    rows = _throughput_rows(smoke, repeat, engines)
    # The sweep lane drives benchmarks.run, whose default is the compiled
    # engine when a fast backend exists; pin python only when this whole
    # lane is pinned to it.
    rows += _sweep_rows(smoke, jobs, repeat,
                        engine=("python" if engine == "python" else "auto"))
    rows += _dispatch_rows(smoke, repeat)
    detail = _backend_detail()
    if detail:
        for row in rows:
            if str(row.get("engine", "")).startswith("compiled"):
                row["backend_detail"] = detail
    commit = _git_commit()
    payload = {
        "commit": commit,
        "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "smoke": smoke,
        "compiled_backend": backend_name(),
        "history": [dict(block) for block in HISTORY],
        "rows": rows,
    }
    # A baseline block pins reference measurements to an exact commit;
    # a dirty or unknown tree has no such commit to attribute them to,
    # so the pin is refused rather than written with false provenance.
    if commit != "unknown" and not commit.endswith("-dirty"):
        payload["baseline"] = dict(BASELINE)
    else:
        payload["baseline_omitted"] = (
            "tree is dirty or of unknown commit: baseline blocks are "
            "only pinned from a clean checkout")
    out.write_text(json.dumps(payload, indent=1, sort_keys=True) + "\n")
    return payload


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced workloads (CI tier)")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--repeat", type=int, default=2,
                    help="best-of-N for the throughput rows")
    ap.add_argument("--out", default="BENCH_des_torch.json",
                    help="output JSON, in the working directory unless a "
                         "path is given (never the reference's "
                         "BENCH_des.json)")
    ap.add_argument("--engine", choices=("both", "python", "compiled"),
                    default="both",
                    help="restrict the throughput rows to one DES engine "
                         "(make bench-compiled uses 'compiled')")
    args = ap.parse_args()
    if args.repeat < 1:
        ap.error("--repeat must be >= 1")
    if args.jobs < 1:
        ap.error("--jobs must be >= 1")
    payload = run(smoke=args.smoke, jobs=args.jobs, repeat=args.repeat,
                  out=Path(args.out), engine=args.engine)
    for row in payload["rows"]:
        print(json.dumps(row, sort_keys=True))
    print(f"wrote {args.out} @ {payload['commit']}")


if __name__ == "__main__":
    main()
