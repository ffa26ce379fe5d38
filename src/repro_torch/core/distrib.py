"""Distributed sweep fan-out: cell execution, the packed record cache, and
a pull-based cell dispatcher with worker cache sync.

This module is the *execution tier* under :mod:`repro.core.sweep`.  The
sweep runner owns cache **keys** (what a cell is); this module owns cache
**bytes** (how a record is stored) and cell **execution** (how a record is
produced), on either machine, under either dispatcher:

* **cell runners** — :func:`run_des_cell` / :func:`run_executor_cell` /
  :func:`run_cell` are the functions every dispatch path executes.  They
  live here (not in ``sweep.py``) so the dispatcher/runner tier is part of
  every machine's code fingerprint: an edit to how records are produced
  invalidates cached records, whichever dispatcher produced them
  (DESIGN.md Section 12; ``repro.analysis`` pins the closure).
* **record store** — per-key ``<sha256>.json`` files plus per-chunk
  ``<digest>.pack.jsonl`` packfiles (one atomic write per result chunk
  instead of one per cell), an LRU in-memory mirror with a size cap, and a
  startup scavenge for ``.<key>.<pid>.tmp`` orphans left by writers that
  died between ``write_text`` and ``os.replace``.
* **queue dispatcher** — :class:`QueueDispatcher` serializes the sweep's
  pending cells into self-contained tasks and serves them to N pull-based
  workers (local spawned ``python -m repro.launch.worker`` processes
  and/or remote workers connected over TCP), LPT-ordered, with
  heartbeat/death detection, bounded re-dispatch of a dead worker's
  in-flight cells, and two-way cache sync: each worker receives the run's
  queued-key manifest on connect and *prefills* any records its own local
  cache already holds; the parent ingests **only** keys it queued
  (duplicate and unqueued results are counted and dropped).
* **batched in-worker runner** — :func:`worker_serve` keeps one long-lived
  engine process per worker: the compiled DES backend, imports and ctypes
  setup are paid once, then every dispatched *chunk* of cells runs
  in-process and returns as one packed result frame (and one local
  packfile write when the worker keeps a cache), amortizing per-cell
  dispatch overhead by the chunk size.

The queue tier is DES-only by design: executor cells are wall-clock
measurements whose solo baselines are calibrated against local pool
contention (DESIGN.md Section 6); shipping them to other machines would
silently mix measurement conditions.  ``run_sweep(dispatcher="local")``
remains the bit-identical default path for both machines.

Everything on a result path here is deterministic; the wall-clock reads
are confined to the dispatcher/worker *control plane* (heartbeats, death
timeouts, stall detection) and are baselined individually in
``repro.analysis`` — they never shape a record or a key.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import heapq
import itertools
import json
import math
import os
import pickle
import socket
import struct
import subprocess
import sys
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from .metrics import evaluate_window
from .policies import make_policy
from .scenarios import executor_job, executor_workload
from .simulator import simulate

# =====================================================================
# Record store: NaN-safe JSON, LRU memo, packfiles, tmp scavenge
# =====================================================================


def nan_to_null(obj):
    """Replace float NaN with ``None``, recursively.

    ``json.dumps`` would otherwise emit the non-standard ``NaN`` token
    (rejected by strict parsers) into cache records and digest payloads;
    nothing-finished cells carry NaN STP/ANTT/fairness by design.
    """
    if isinstance(obj, float):
        return None if math.isnan(obj) else obj
    if isinstance(obj, dict):
        return {k: nan_to_null(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [nan_to_null(v) for v in obj]
    return obj


def canonical_digest(payload: dict) -> str:
    """SHA-256 over the canonical (sorted, compact, NaN-free) JSON form."""
    try:
        # Fast path: NaN-free payloads (the overwhelming majority) dump
        # directly; ``allow_nan=False`` makes json raise on the rest, and
        # only those pay the recursive nan_to_null rebuild.  Identical
        # bytes either way (tuples serialize as JSON arrays regardless).
        blob = json.dumps(payload, sort_keys=True,
                          separators=(",", ":"), allow_nan=False)
    except ValueError:
        blob = json.dumps(nan_to_null(payload), sort_keys=True,
                          separators=(",", ":"), allow_nan=False)
    return hashlib.sha256(blob.encode()).hexdigest()


def record_text(record: dict) -> str:
    """THE serialized form of a cache record.

    Every store path — per-key file, packfile line — must produce exactly
    these bytes, so records are byte-identical across dispatchers and the
    equivalence gate can compare text, not just parsed floats.
    """
    try:
        # Same fast path as canonical_digest: NaN-free records (the
        # common case — only nothing-finished cells carry NaN metrics)
        # skip the recursive rebuild; json raises on NaN/inf and the
        # exceptional records take nan_to_null.
        return json.dumps(record, sort_keys=True, allow_nan=False)
    except ValueError:
        return json.dumps(nan_to_null(record), sort_keys=True,
                          allow_nan=False)


#: Entry cap of the in-memory record mirror.  Multi-spec batch drivers
#: (the benchmark suite runs every table over one shared cache) used to
#: grow the mirror without bound; an LRU keeps warm-rerun hits for the
#: records still in play while old sweeps age out.
MEMO_CAP = int(os.environ.get("REPRO_SWEEP_MEMO_CAP", "4096"))


class RecordMemo:
    """Bounded LRU mirror of the on-disk cache, keyed (cache_dir, key).

    Content-addressed records never legitimately change, so a hit is
    always valid; the cap only bounds memory.  Thread-safe: dispatcher
    handler threads commit records concurrently.
    """

    def __init__(self, cap: int = MEMO_CAP):
        self.cap = max(1, int(cap))
        self._d: "OrderedDict[Tuple[str, str], dict]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: Tuple[str, str]) -> Optional[dict]:
        with self._lock:
            hit = self._d.get(key)
            if hit is None:
                self.misses += 1
                return None
            self._d.move_to_end(key)
            self.hits += 1
            return hit

    def put(self, key: Tuple[str, str], record: dict) -> None:
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
            self._d[key] = record
            while len(self._d) > self.cap:
                # Baselined determinism finding (dict-popitem): on an
                # OrderedDict, popitem(last=False) IS the explicit
                # least-recently-used order — and eviction only bounds
                # memory; a record re-reads identically from disk.
                self._d.popitem(last=False)
                self.evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._d), "cap": self.cap,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}


#: The per-process record mirror (``sweep`` re-exports ``clear_cache_memo``).
_MEMO = RecordMemo()


def cache_memo_stats() -> Dict[str, int]:
    """Counters of the in-memory record mirror (exposed in sweep stats)."""
    return _MEMO.stats()


#: Per-cache-dir packfile index: dir -> {"files": set of seen pack paths,
#: "keys": key -> pack path}.  Rebuilt lazily when the dir's packfile set
#: changes (another process may append packs between reads).
_PACK_INDEX: Dict[str, Dict] = {}
_PACK_LOCK = threading.Lock()

PACK_SUFFIX = ".pack.jsonl"


def clear_cache_memo() -> None:
    """Drop the in-memory record mirror and the packfile index (tests that
    mutate cache files on disk out-of-band call this to force re-reads)."""
    _MEMO.clear()
    with _PACK_LOCK:
        _PACK_INDEX.clear()


def _pack_path_for(cache_dir: Path, key: str) -> Optional[Path]:
    """Packfile holding ``key``, per the (lazily refreshed) index."""
    ds = str(cache_dir)
    try:
        snapshot = {str(p) for p in cache_dir.glob(f"*{PACK_SUFFIX}")}
    except OSError:
        return None
    with _PACK_LOCK:
        entry = _PACK_INDEX.get(ds)
        if entry is None or entry["files"] != snapshot:
            keys = dict(entry["keys"]) if entry is not None else {}
            known = entry["files"] if entry is not None else set()
            new_files = sorted(snapshot - known)
            stale = known - snapshot
            if stale:
                keys = {k: p for k, p in keys.items() if p not in stale}
            for path in new_files:
                try:
                    with open(path, "r") as fh:
                        for line in fh:
                            k, _, _ = line.partition("\t")
                            keys[k] = path
                except OSError:
                    continue
            entry = {"files": snapshot, "keys": keys}
            _PACK_INDEX[ds] = entry
        hit = entry["keys"].get(key)
    return Path(hit) if hit is not None else None


def cache_read(cache_dir: Optional[Path], key: str) -> Optional[dict]:
    """Read one record: memo -> per-key file -> packfile."""
    if cache_dir is None:
        return None
    memo_key = (str(cache_dir), key)
    hit = _MEMO.get(memo_key)
    if hit is not None:
        return hit
    path = cache_dir / f"{key}.json"
    try:
        record = json.loads(path.read_text())
    except (FileNotFoundError, json.JSONDecodeError):
        record = None
    if record is not None:
        _MEMO.put(memo_key, record)
        return record
    pack = _pack_path_for(cache_dir, key)
    if pack is None:
        return None
    found = None
    try:
        with open(pack, "r") as fh:
            for line in fh:
                k, _, text = line.partition("\t")
                try:
                    rec = json.loads(text)
                except json.JSONDecodeError:
                    continue
                # Chunk locality: neighbours in a pack are neighbours in a
                # sweep — memo the whole pack while it is in hand.
                _MEMO.put((str(cache_dir), k), rec)
                if k == key:
                    found = rec
    except OSError:
        return None
    return found


def cache_write(cache_dir: Optional[Path], key: str, record: dict) -> None:
    """Atomically write one per-key record file and mirror it in memory."""
    if cache_dir is None:
        return
    cache_dir.mkdir(parents=True, exist_ok=True)
    path = cache_dir / f"{key}.json"
    tmp = cache_dir / f".{key}.{os.getpid()}.tmp"
    tmp.write_text(record_text(record))
    os.replace(tmp, path)  # atomic under concurrent writers
    # Mirror what a reader would decode (NaN -> null -> NaN round-trips in
    # the consumers), so a same-process warm hit is indistinguishable from
    # a disk hit.
    _MEMO.put((str(cache_dir), key), record)


def write_pack(cache_dir: Optional[Path],
               records: Dict[str, dict]) -> Optional[Path]:
    """Atomically write one packfile holding a whole chunk of records.

    One ``write + rename`` per chunk replaces one per cell — the queue
    dispatcher's ingest path and the worker's local cache both use this.
    The pack name is content-addressed over the contained keys, so two
    writers racing on the same chunk converge on the same file.  Each line
    is ``<key>\\t<record_text>``: the record bytes are exactly what
    :func:`cache_write` would have put in the per-key file.
    """
    if cache_dir is None or not records:
        return None
    cache_dir.mkdir(parents=True, exist_ok=True)
    body = "".join(f"{k}\t{record_text(records[k])}\n"
                   for k in sorted(records))
    digest = hashlib.sha256("\n".join(sorted(records)).encode()).hexdigest()
    path = cache_dir / f"{digest[:16]}{PACK_SUFFIX}"
    tmp = cache_dir / f".{path.name}.{os.getpid()}.tmp"
    tmp.write_text(body)
    os.replace(tmp, path)
    for k, rec in records.items():
        _MEMO.put((str(cache_dir), k), rec)
    with _PACK_LOCK:
        entry = _PACK_INDEX.get(str(cache_dir))
        if entry is not None:
            entry["files"].add(str(path))
            for k in records:
                entry["keys"][k] = str(path)
    return path


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    return True


def scavenge_cache_dir(cache_dir: Optional[Path]) -> int:
    """Remove ``.<name>.<pid>.tmp`` orphans whose writer pid is dead.

    A worker killed between ``write_text`` and ``os.replace`` leaves its
    tmp file behind forever (the committed ``<key>.json`` it was about to
    replace — if any — stays intact: readers only ever open the final
    name, so a crashed writer can neither corrupt nor shadow a committed
    record).  The pid is part of the tmp name, so liveness is decidable;
    a live writer's in-flight tmp is left alone.  Returns the number of
    files removed; callers run this once per sweep before dispatch.
    """
    if cache_dir is None or not cache_dir.is_dir():
        return 0
    removed = 0
    for path in sorted(cache_dir.glob(".*.tmp")):
        parts = path.name[:-len(".tmp")].rsplit(".", 1)
        if len(parts) != 2 or not parts[1].isdigit():
            continue
        if _pid_alive(int(parts[1])):
            continue
        try:
            path.unlink()
            removed += 1
        except FileNotFoundError:
            pass
    return removed


# =====================================================================
# Cell runners (every dispatcher executes cells through these)
# =====================================================================


def _cell_record(res, solo: Dict[str, float]) -> dict:
    """Assemble the label-free cell record from a :class:`SimResult`."""
    solo_by_key = {k: solo[res.name[k]] for k in res.turnaround}
    window = evaluate_window(
        res.turnaround, solo_by_key, unfinished=res.unfinished,
        end_time=res.end_time, makespan=res.makespan,
        utilization=res.utilization)
    return {
        # WindowMetrics is a flat scalar dataclass; vars() is asdict()
        # without the per-field deepcopy recursion (hot: once per cell).
        "window": dict(vars(window)),
        "turnaround": dict(res.turnaround),
        "finish": dict(res.finish),
        "unfinished": list(res.unfinished),
        "names": dict(res.name),
        "arrival": dict(res.arrival),
    }


def run_des_cell(payload: dict) -> dict:
    """One DES simulation, evaluated over its observation window.

    Open-loop payloads carry materialized ``arrivals``; closed-loop
    payloads carry the scenario + workload name, and the worker builds a
    fresh single-use arrival process (the completions of *this* cell's
    policy drive it — that coupling is the experiment).
    """
    solo: Dict[str, float] = payload["solo"]
    if payload.get("closed_loop"):
        scn = payload["scenario_obj"]
        arrivals, source = [], scn.make_process(payload["workload_name"])
    else:
        arrivals, source = payload["arrivals"], None
    res = simulate(
        arrivals,
        lambda: make_policy(payload["policy"]),
        n_sm=payload["n_sm"],
        seed=payload["seed"],
        oracle_runtimes=solo,
        predictor=payload["predictor"],
        until=payload["until"],
        arrival_source=source,
        engine=payload.get("engine"),
    )
    return _cell_record(res, solo)


def _same_body(a: dict, b: dict) -> bool:
    """Whether two open-loop DES payloads share one simulation *body* —
    arrivals, solo oracle, seed, n_sm, until, engine — so only the
    policy/predictor axes differ.  Identity (not equality) on the shared
    objects: sibling payloads hold fresh list shells around one
    workload's :class:`Arrival` objects, and pickle preserves that
    sharing within one chunk frame.  Oracle-reordered siblings (SJF/LJF)
    share the same arrivals in a different order — order is part of the
    body, so the element-wise zip rejects them."""
    if a.get("closed_loop") or b.get("closed_loop"):
        return False
    arr_a, arr_b = a["arrivals"], b["arrivals"]
    return (len(arr_a) == len(arr_b)
            and all(x is y for x, y in zip(arr_a, arr_b))
            and a["solo"] is b["solo"]
            and a["seed"] == b["seed"]
            and a["n_sm"] == b["n_sm"]
            and a["until"] == b["until"]
            and a.get("engine") == b.get("engine"))


def _run_des_cell_fast(payload: dict, proto: Optional[dict]) -> dict:
    """:func:`run_des_cell` for the chunk runner: result-only mode.

    Compiled open-loop cells build the simulator directly (the exact
    construction :func:`~repro.core.simulator.simulate` performs) so the
    chunk runner can enable the two in-chunk amortizations: the lean
    terminal scatter (commit only what the record reads) and the shared
    staging prototype ``proto`` (siblings memcpy the staged arrays
    instead of rebuilding — DESIGN.md Section 13).  Everything else —
    closed-loop cells, the reference engine — takes the plain per-cell
    path; records are byte-identical either way.
    """
    from .fastsim import FastSimulator, default_engine

    engine = payload.get("engine") or default_engine()
    if engine != "compiled" or payload.get("closed_loop"):
        return run_des_cell(payload)
    solo: Dict[str, float] = payload["solo"]
    sim = FastSimulator(
        payload["arrivals"], make_policy(payload["policy"]),
        n_sm=payload["n_sm"], seed=payload["seed"],
        oracle_runtimes=solo, predictor=payload["predictor"])
    sim._lean_result = True
    if proto is not None:
        sim._stage_proto = proto
    return _cell_record(sim.run(until=payload["until"]), solo)


def run_des_chunk(payloads: Sequence[dict],
                  cache_dir: Optional[Path] = None, *,
                  read_cache: bool = True,
                  on_computed: Optional[Callable[[str], None]] = None
                  ) -> Dict[str, dict]:
    """Run a whole chunk of DES cell payloads in one call.

    The chunk is the amortization unit of both dispatch tiers: one
    packfile write for all computed records (instead of one file per
    cell), and one staging prototype shared by each run of adjacent
    same-body payloads (the sweep emits policy siblings adjacently, and
    LPT tie-breaks preserve that adjacency).  ``read_cache=False`` skips
    the per-cell cache probe — the local dispatcher resolves hits before
    queueing, so its pending cells are known misses.  ``on_computed`` is
    called with the key after each computed (non-hit) cell; the worker
    loop uses it for ``die_after`` failure injection.  Records are
    byte-identical to per-cell :func:`run_des_cell` runs.
    """
    records: Dict[str, dict] = {}
    fresh: Dict[str, dict] = {}
    proto: dict = {}
    prev: Optional[dict] = None
    # Cycle collection off for the chunk: each cell retires one simulator
    # object graph (cyclic through core.bind), and letting the collector
    # walk those mid-chunk costs ~10% of tiny-cell throughput.  The
    # garbage is bounded by the chunk and collected normally afterwards.
    gc_was_enabled = gc.isenabled()
    if gc_was_enabled:
        gc.disable()
    try:
        for payload in payloads:
            key = payload["key"]
            if read_cache:
                hit = cache_read(cache_dir, key)
                if hit is not None:
                    records[key] = hit
                    continue
            if prev is None or not _same_body(prev, payload):
                proto = {}
            prev = payload
            records[key] = fresh[key] = _run_des_cell_fast(payload, proto)
            if on_computed is not None:
                on_computed(key)
    finally:
        if gc_was_enabled:
            gc.enable()
    write_pack(cache_dir, fresh)
    return records


def _run_chunk(args: Tuple[Sequence[dict], Optional[Path]]
               ) -> Dict[str, dict]:
    """Module-level chunk entry point (pickles into pool workers)."""
    payloads, cache_dir = args
    return run_des_chunk(payloads, cache_dir, read_cache=False)


def run_executor_cell(payload: dict) -> dict:
    """One real-JAX executor run over the bridged workload.

    Same label-free record shape as the DES path (``window`` /
    ``turnaround`` / ``finish`` / ``unfinished`` / ``names`` /
    ``arrival``), plus ``measured: true`` — every float here is a
    wall-clock measurement.  Closed-loop payloads attach the arrival
    process through the same feedback edge as the DES, with the bridge
    scaling scenario cycles to lane seconds in both directions.
    """
    from .executor import LaneExecutor

    solo: Dict[str, float] = payload["solo"]
    n_lanes = payload["n_sm"]
    time_scale = payload["time_scale"]
    device = payload["device"]
    ex = LaneExecutor([], make_policy(payload["policy"]),
                      n_lanes=n_lanes,
                      predictor=payload["predictor"],
                      job_bridge=lambda a: executor_job(
                          a, n_lanes=n_lanes, time_scale=time_scale, device=device))
    ex.oracle_runtimes.update(solo)
    if payload.get("closed_loop"):
        scn = payload["scenario_obj"]
        ex.attach_arrival_source(scn.make_process(payload["workload_name"]),
                                 time_scale=time_scale)
    else:
        for key, job in executor_workload(payload["arrivals"],
                                          n_lanes=n_lanes,
                                          time_scale=time_scale, device=device):
            ex.add_job(job, key=key)
    ex.run(until=payload["until"])
    w = ex.window()
    solo_by_key = {k: solo[w.names[k]] for k in w.turnaround}
    window = evaluate_window(
        w.turnaround, solo_by_key, unfinished=w.unfinished,
        end_time=w.end_time, makespan=w.makespan,
        utilization=w.utilization)
    return {
        "window": dataclasses.asdict(window),
        "turnaround": dict(w.turnaround),
        "finish": dict(w.finish),
        "unfinished": list(w.unfinished),
        "names": dict(w.names),
        "arrival": dict(w.arrival),
        "measured": True,
    }


def run_cell(payload: dict) -> dict:
    """Execute one cell (module-level: pickles into worker processes).

    The payload carries *effective* arrivals/policy and the solo-runtime
    oracle; the returned record is label-free.  This is the local
    dispatcher's unit of work: DES records are written to the cache here,
    in the pool worker (the queue dispatcher instead ingests whole chunks
    parent-side through :func:`write_pack`).
    """
    if payload["machine"] == "executor":
        # Not written to disk: the key folds in a per-run nonce, so the
        # record could never be read back — persisting it would only grow
        # the cache directory without bound.
        return run_executor_cell(payload)
    record = run_des_cell(payload)
    cache_write(payload["cache_dir"], payload["key"], record)
    return record


def payload_cost(payload: dict) -> float:
    """LPT dispatch cost of one cell: total block count (DES cell cost
    tracks it); closed-loop cells are unknown-cost and go first."""
    arrivals = payload.get("arrivals")
    if arrivals is None:
        return math.inf
    return float(sum(a.spec.num_blocks for a in arrivals))


# =====================================================================
# Wire protocol: length-prefixed pickle frames over TCP
# =====================================================================

PROTOCOL_VERSION = 1

#: Refuse frames beyond this size — a corrupt length prefix must not
#: allocate unbounded memory.
_MAX_FRAME = 1 << 30

_HEADER = struct.Struct(">I")


class DispatchError(RuntimeError):
    """The queue dispatcher could not complete the sweep."""


def send_frame(sock: socket.socket, obj: dict,
               lock: Optional[threading.Lock] = None) -> None:
    blob = pickle.dumps(obj)
    if len(blob) > _MAX_FRAME:
        raise DispatchError(f"frame of {len(blob)} bytes exceeds the "
                            f"{_MAX_FRAME}-byte protocol cap")
    data = _HEADER.pack(len(blob)) + blob
    if lock is not None:
        with lock:
            sock.sendall(data)
    else:
        sock.sendall(data)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


def recv_frame(sock: socket.socket) -> Optional[dict]:
    """One frame, or ``None`` on clean EOF.  Raises ``socket.timeout``
    when the peer goes silent past the socket timeout (the dispatcher
    treats that as worker death — no mid-frame resync is attempted)."""
    header = _recv_exact(sock, _HEADER.size)
    if header is None:
        return None
    (length,) = _HEADER.unpack(header)
    if length > _MAX_FRAME:
        raise DispatchError(f"peer announced a {length}-byte frame "
                            f"(cap {_MAX_FRAME}); stream corrupt")
    blob = _recv_exact(sock, length)
    if blob is None:
        return None
    return pickle.loads(blob)


# =====================================================================
# The pull-based queue dispatcher
# =====================================================================

#: Upper bound on cells per task frame; chunks smaller than this are used
#: when the worklist is short so every worker stays busy (see
#: :func:`chunk_size_for`).  384 balances the parent's per-turn cost
#: (each chunk is one result frame + one pack ingest, and with the
#: in-engine chunk runner the parent turn is a visible fraction of a
#: tiny-cell sweep) against re-dispatch granularity when a worker dies
#: mid-chunk and the task-frame size (a tiny-cell chunk of 384 is well
#: under 100 ms of work and ~100 KB of frame).
DEFAULT_CHUNK_MAX = 384

#: A chunk target of ~2 chunks per worker: LPT puts the heavy cells in
#: the first chunk of each worker, so the second-round chunks form the
#: tail — at most half a worker's share, while every committed chunk
#: amortizes one parent ingest turn over more cells.
_CHUNKS_PER_WORKER = 2


def chunk_size_for(n_cells: int, workers: int,
                   chunk_cells: Optional[int] = None,
                   chunk_max: int = DEFAULT_CHUNK_MAX) -> int:
    """The chunking policy (DESIGN.md Section 12): explicit override, else
    ``ceil(n / (4 * workers))`` clamped to [1, chunk_max]."""
    if chunk_cells is not None:
        return max(1, int(chunk_cells))
    per = math.ceil(n_cells / max(1, _CHUNKS_PER_WORKER * max(1, workers)))
    return max(1, min(chunk_max, per))


class _WorkerConn:
    """Dispatcher-side state of one connected worker."""

    _ids = itertools.count(1)

    def __init__(self, sock: socket.socket, addr):
        self.sock = sock
        self.addr = addr
        self.wid = next(self._ids)
        self.pid: Optional[int] = None
        self.hostname = "?"
        self.inflight: List[str] = []   # keys of the task in flight

    def label(self) -> str:
        return f"worker#{self.wid} pid={self.pid} @ {self.hostname}"


class QueueDispatcher:
    """Pull-based cell dispatcher: serve pending sweep cells to workers.

    ``pending`` is the sweep runner's list of self-contained cell payloads
    (each carries its cache ``key``).  Workers connect over TCP — either
    the ``workers`` local processes this dispatcher spawns
    (``spawn_workers=True``) or external ``python -m repro.launch.worker
    --connect host:port`` processes on any machine that shares the code
    fingerprint.  Cells are handed out in LPT order, ``chunk`` cells per
    task; a worker that dies (EOF, error, or heartbeat silence past
    ``heartbeat_timeout_s``) gets its un-committed in-flight cells
    re-queued, at most ``max_requeues`` times each before the run aborts.

    Cache sync: the welcome frame carries the run's queued-key manifest;
    a worker with a local cache immediately *prefills* the records it
    already holds and persists newly computed chunks locally, so a farm
    warms across runs.  The parent ingests only queued keys — duplicate
    or unqueued results are counted and dropped — and writes one packfile
    per result chunk.
    """

    def __init__(self, pending: Sequence[dict], *,
                 cache_dir: Optional[Union[str, Path]] = None,
                 workers: int = 2,
                 host: str = "127.0.0.1", port: int = 0,
                 chunk_cells: Optional[int] = None,
                 spawn_workers: bool = True,
                 heartbeat_s: float = 1.0,
                 heartbeat_timeout_s: Optional[float] = None,
                 stall_timeout_s: float = 120.0,
                 max_requeues: int = 3,
                 fingerprints: Optional[Dict[str, str]] = None,
                 worker_cache_dir: Optional[Union[str, Path]] = None,
                 worker_argv_extra: Sequence[str] = (),
                 spawn_mode: Optional[str] = None):
        for p in pending:
            if p.get("machine") == "executor":
                raise ValueError(
                    "the queue dispatcher is DES-only: executor cells are "
                    "wall-clock measurements calibrated against local pool "
                    "contention (DESIGN.md Section 6); run them with "
                    "dispatcher='local'")
        self.cache_dir = Path(cache_dir) if cache_dir is not None else None
        self.workers = max(1, int(workers))
        self.host, self.port = host, port
        self.spawn_workers = spawn_workers
        self.heartbeat_s = heartbeat_s
        self.heartbeat_timeout_s = (heartbeat_timeout_s
                                    if heartbeat_timeout_s is not None
                                    else max(10.0, 10.0 * heartbeat_s))
        self.stall_timeout_s = stall_timeout_s
        self.max_requeues = max_requeues
        self.fingerprints = dict(fingerprints or {})
        self.worker_cache_dir = (Path(worker_cache_dir)
                                 if worker_cache_dir is not None else None)
        self.worker_argv_extra = list(worker_argv_extra)
        # Local workers fork from the parent by default: the interpreter,
        # NumPy, and the loaded compiled DES engine (ctypes .so / numba
        # dispatcher) are inherited instead of re-imported, so a farm is
        # serving chunks within milliseconds — the same amortization the
        # local fork pool already relies on.  "subprocess" spawns fresh
        # ``python -m repro.launch.worker`` processes (required when
        # ``worker_argv_extra`` carries CLI-only options, and the shape
        # remote workers use).
        if spawn_mode is None:
            spawn_mode = ("subprocess" if (worker_argv_extra or
                                           not hasattr(os, "fork"))
                          else "fork")
        if spawn_mode not in ("fork", "subprocess"):
            raise ValueError(f"unknown spawn_mode {spawn_mode!r}")
        if spawn_mode == "fork" and worker_argv_extra:
            raise ValueError(
                "worker_argv_extra needs spawn_mode='subprocess' (forked "
                "workers never re-parse the CLI)")
        self.spawn_mode = spawn_mode

        self._bykey: Dict[str, dict] = {}
        for p in pending:
            self._bykey.setdefault(p["key"], p)
        # LPT order: heaviest cells first; seq breaks ties deterministically
        # in queue order.  Dispatch order never affects record content —
        # results are keyed — only the straggler tail.
        self._heap: List[Tuple[float, int, str]] = sorted(
            (-payload_cost(p), seq, key)
            for seq, (key, p) in enumerate(self._bykey.items()))
        self._state: Dict[str, str] = {k: "queued" for k in self._bykey}
        self._requeues: Dict[str, int] = {}
        self.records: Dict[str, dict] = {}
        self.chunk = chunk_size_for(len(self._bykey), self.workers,
                                    chunk_cells)
        self.stats: Dict[str, int] = {
            "queue_workers": 0, "queue_chunk": self.chunk,
            "queue_tasks": 0, "queue_requeued_cells": 0,
            "queue_dead_workers": 0, "queue_duplicate_results": 0,
            "queue_unqueued_results": 0, "queue_prefilled": 0,
            "queue_packs_written": 0,
        }
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._done = len(self._bykey) == 0
        self._fatal: Optional[str] = None
        self._n_done = 0
        self._live = 0
        # Baselined determinism finding (wallclock): control-plane progress
        # stamp for stall detection only; never enters a record or a key.
        self._last_progress = time.monotonic()
        self._listener: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []
        self._procs: List[subprocess.Popen] = []
        self._fork_pids: List[int] = []

    # ------------------------------------------------------------- setup
    def start(self) -> int:
        """Bind, listen, start the accept loop (and local workers).
        Returns the bound port."""
        if self.cache_dir is not None:
            scavenge_cache_dir(self.cache_dir)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self.host, self.port))
        self._listener.listen(self.workers + 8)
        self._listener.settimeout(0.25)
        self.port = self._listener.getsockname()[1]
        # Workers are spawned BEFORE the accept/handler threads exist:
        # forking a process whose other threads may hold locks can deadlock
        # the child.  Early connections just sit in the listen backlog.
        if self.spawn_workers and not self._done:
            for _ in range(self.workers):
                if self.spawn_mode == "fork":
                    self._fork_pids.append(self._fork_worker())
                else:
                    self._procs.append(self._spawn_worker())
        acceptor = threading.Thread(target=self._accept_loop,
                                    name="dispatch-accept", daemon=True)
        acceptor.start()
        self._threads.append(acceptor)
        return self.port

    def _fork_worker(self) -> int:
        pid = os.fork()
        if pid != 0:
            return pid
        # Child: drop the inherited listener, serve over a fresh TCP
        # connection like any remote worker, and never return into the
        # parent's stack.  The handshake is vacuous (same process image ⇒
        # same fingerprints) but still exercised — the frames are the
        # protocol conformance surface the tests pin.
        code = 1
        try:
            self._listener.close()
            code = worker_serve(
                self.host or "127.0.0.1", self.port,
                cache_dir=self.worker_cache_dir,
                fingerprints=self.fingerprints,
                heartbeat_s=self.heartbeat_s)
        except BaseException:
            code = 1
        finally:
            os._exit(code)

    def _spawn_worker(self) -> subprocess.Popen:
        argv = [sys.executable, "-m", "repro_torch.launch.worker",
                "--connect", f"{self.host or '127.0.0.1'}:{self.port}",
                "--heartbeat", str(self.heartbeat_s)]
        if self.worker_cache_dir is not None:
            argv += ["--cache-dir", str(self.worker_cache_dir)]
        argv += self.worker_argv_extra
        env = dict(os.environ)
        # The worker must resolve the same code tree as the parent (the
        # fingerprint handshake would reject anything else anyway).
        env["PYTHONPATH"] = os.pathsep.join(
            [p for p in sys.path if p] +
            ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        return subprocess.Popen(argv, env=env, stdout=subprocess.DEVNULL)

    # ----------------------------------------------------------- serving
    def serve(self) -> Tuple[Dict[str, dict], Dict[str, int]]:
        """Block until every queued cell is committed; return
        ``(records, stats)``.  Raises :class:`DispatchError` on fatal
        conditions (fingerprint mismatch, a cell exceeding its re-dispatch
        budget, or no progress for ``stall_timeout_s``)."""
        try:
            with self._cond:
                while not self._done and self._fatal is None:
                    self._cond.wait(timeout=0.25)
                    # Baselined determinism finding (wallclock): stall
                    # watchdog on the control plane.
                    idle = time.monotonic() - self._last_progress
                    if not self._done and idle > self.stall_timeout_s:
                        self._fatal = (
                            f"no dispatch progress for {idle:.0f}s with "
                            f"{len(self._bykey) - self._n_done} cells left "
                            f"and {self._live} live worker(s)")
        finally:
            self._shutdown()
        if self._fatal is not None:
            raise DispatchError(self._fatal)
        return self.records, dict(self.stats)

    def run(self) -> Tuple[Dict[str, dict], Dict[str, int]]:
        self.start()
        return self.serve()

    def _shutdown(self) -> None:
        with self._cond:
            if self._fatal is None and not self._done:
                self._fatal = "dispatcher shut down with cells outstanding"
            self._cond.notify_all()
        # Closing the listener does not wake a thread already blocked in
        # accept(); a throwaway self-connection does, immediately —
        # otherwise every run pays the accept timeout as shutdown latency.
        if self._listener is not None:
            try:
                with socket.create_connection(
                        (self.host or "127.0.0.1", self.port), timeout=1.0):
                    pass
            except OSError:
                pass
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=10.0)
        for proc in self._procs:
            try:
                proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                proc.terminate()
                try:
                    proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    proc.kill()
        for pid in self._fork_pids:
            self._reap(pid)
        self._fork_pids = []

    @staticmethod
    def _reap(pid: int, grace_s: float = 5.0) -> None:
        """waitpid with a polling grace period, then SIGTERM/SIGKILL."""
        import signal
        for sig in (None, signal.SIGTERM, signal.SIGKILL):
            if sig is not None:
                try:
                    os.kill(pid, sig)
                except (OSError, ProcessLookupError):
                    return
            # Exponential backoff from 1 ms: a worker honouring the
            # shutdown frame exits within a millisecond or two, and this
            # runs inside the dispatch bracket — a fixed 50 ms poll would
            # tax every run's shutdown for the rare straggler's sake.
            waited, pause = 0.0, 0.001
            while waited < grace_s:
                try:
                    done, _status = os.waitpid(pid, os.WNOHANG)
                except ChildProcessError:
                    return
                if done == pid:
                    return
                time.sleep(pause)
                waited += pause
                pause = min(pause * 2, 0.05)

    # ------------------------------------------------------ accept/handle
    def _accept_loop(self) -> None:
        while True:
            with self._lock:
                if self._done or self._fatal is not None:
                    return
            try:
                sock, addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with self._lock:
                if self._done or self._fatal is not None:
                    # The _shutdown wake-up connection (or a worker racing
                    # the end of the run) — drop it and retire.
                    try:
                        sock.close()
                    except OSError:
                        pass
                    return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(self.heartbeat_timeout_s)
            conn = _WorkerConn(sock, addr)
            handler = threading.Thread(target=self._handle, args=(conn,),
                                       name=f"dispatch-w{conn.wid}",
                                       daemon=True)
            handler.start()
            self._threads.append(handler)

    def _handle(self, conn: _WorkerConn) -> None:
        alive_counted = False
        try:
            hello = recv_frame(conn.sock)
            if not isinstance(hello, dict) or hello.get("t") != "hello":
                return
            conn.pid = hello.get("pid")
            conn.hostname = hello.get("host", "?")
            with self._lock:
                self._live += 1
                self.stats["queue_workers"] += 1
                # Baselined determinism finding (wallclock): control-plane
                # progress stamp (a worker arriving is progress).
                self._last_progress = time.monotonic()
                alive_counted = True
                manifest = sorted(self._bykey)
            send_frame(conn.sock, {
                "t": "welcome", "version": PROTOCOL_VERSION,
                "fingerprints": self.fingerprints,
                "heartbeat_s": self.heartbeat_s,
                "queued": manifest,
            })
            # Drain prefill frames until the worker reports ready, so local
            # cache hits land before the first chunk is assembled.
            while True:
                frame = recv_frame(conn.sock)
                if frame is None:
                    return
                t = frame.get("t")
                if t == "ready":
                    break
                if t == "reject":
                    with self._cond:
                        self._fatal = (f"{conn.label()} rejected the run: "
                                       f"{frame.get('reason', '?')}")
                        self._cond.notify_all()
                    return
                self._consume(frame, prefill=True)
            while True:
                chunk = self._next_chunk(conn)
                if chunk is None:
                    self._farewell(conn)
                    return
                send_frame(conn.sock, {"t": "task", "id": conn.wid,
                                       "cells": chunk})
                if not self._await_result(conn):
                    return
        except (OSError, socket.timeout, pickle.PickleError, EOFError,
                DispatchError):
            pass
        finally:
            self._abandon(conn, alive_counted)
            try:
                conn.sock.close()
            except OSError:
                pass

    def _farewell(self, conn: _WorkerConn) -> None:
        try:
            send_frame(conn.sock, {"t": "shutdown"})
            conn.sock.settimeout(5.0)
            while True:
                frame = recv_frame(conn.sock)
                if frame is None or frame.get("t") == "bye":
                    return
        except (OSError, socket.timeout, pickle.PickleError, EOFError):
            return

    def _await_result(self, conn: _WorkerConn) -> bool:
        """Frames until the in-flight task's result lands.  Heartbeats and
        prefills are consumed in passing; silence past the socket timeout
        (or EOF) means the worker is dead."""
        while True:
            frame = recv_frame(conn.sock)
            if frame is None:
                return False
            t = frame.get("t")
            if t == "hb":
                continue
            if t == "result":
                self._consume(frame)
                with self._lock:
                    conn.inflight = []
                return True
            self._consume(frame, prefill=(t == "prefill"))

    def _consume(self, frame: dict, prefill: bool = False) -> None:
        """Ingest one result/prefill frame: commit queued keys, drop the
        rest, write one packfile per frame."""
        got = frame.get("records")
        if not isinstance(got, dict):
            return
        committed: Dict[str, dict] = {}
        with self._cond:
            for key, record in got.items():
                state = self._state.get(key)
                if state is None:
                    self.stats["queue_unqueued_results"] += 1
                    continue
                if state == "done":
                    self.stats["queue_duplicate_results"] += 1
                    continue
                self._state[key] = "done"
                self._n_done += 1
                self.records[key] = record
                committed[key] = record
                if prefill:
                    self.stats["queue_prefilled"] += 1
            if committed:
                # Baselined determinism finding (wallclock): progress
                # stamp; the committed records themselves are untouched.
                self._last_progress = time.monotonic()
            if self._n_done == len(self._bykey):
                self._done = True
            self._cond.notify_all()
        if committed:
            if write_pack(self.cache_dir, committed) is not None:
                with self._lock:
                    self.stats["queue_packs_written"] += 1

    def _next_chunk(self, conn: _WorkerConn) -> Optional[List[dict]]:
        """Pull up to ``self.chunk`` queued cells for this worker; blocks
        while the queue is empty but cells are still in flight elsewhere
        (their worker may die and requeue them).  ``None`` = run over."""
        with self._cond:
            while True:
                if self._done or self._fatal is not None:
                    return None
                keys: List[str] = []
                while self._heap and len(keys) < self.chunk:
                    _, _, key = heapq.heappop(self._heap)
                    if self._state.get(key) != "queued":
                        continue  # committed while queued (e.g. prefill)
                    self._state[key] = "inflight"
                    keys.append(key)
                if keys:
                    conn.inflight = keys
                    self.stats["queue_tasks"] += 1
                    return [self._task_payload(k) for k in keys]
                self._cond.wait(timeout=0.25)

    def _task_payload(self, key: str) -> dict:
        # Self-contained: the worker never sees the parent's cache dir.
        payload = {k: v for k, v in self._bykey[key].items()
                   if k != "cache_dir"}
        payload["cache_dir"] = None
        return payload

    def _abandon(self, conn: _WorkerConn, alive_counted: bool) -> None:
        """Requeue a dead worker's un-committed in-flight cells (each at
        most ``max_requeues`` times) and retire the connection."""
        with self._cond:
            if alive_counted:
                self._live -= 1
            requeued = 0
            for key in conn.inflight:
                if self._state.get(key) != "inflight":
                    continue
                n = self._requeues.get(key, 0) + 1
                self._requeues[key] = n
                if n > self.max_requeues:
                    self._fatal = (
                        f"cell {key[:12]}… was re-dispatched {n} times "
                        "without completing (poison cell or a dying farm)")
                    self._cond.notify_all()
                    return
                self._state[key] = "queued"
                heapq.heappush(self._heap,
                               (-payload_cost(self._bykey[key]), 0, key))
                requeued += 1
            conn.inflight = []
            if requeued:
                self.stats["queue_requeued_cells"] += requeued
                # Baselined determinism finding (wallclock): a requeue
                # restarts the stall watchdog; cells are re-run from their
                # self-contained payloads, bit-identically.
                self._last_progress = time.monotonic()
            if alive_counted and not self._done:
                self.stats["queue_dead_workers"] += 1
            self._cond.notify_all()


# =====================================================================
# The batched in-worker cell runner
# =====================================================================


def worker_serve(host: str, port: int, *,
                 cache_dir: Optional[Union[str, Path]] = None,
                 fingerprints: Optional[Dict[str, str]] = None,
                 heartbeat_s: float = 1.0,
                 connect_timeout_s: float = 10.0,
                 die_after: Optional[int] = None,
                 log: Callable[[str], None] = lambda msg: None) -> int:
    """One worker: connect, handshake, then pull and run cell chunks until
    the dispatcher says shutdown.  Returns a process exit code.

    The process is long-lived on purpose: interpreter start-up, NumPy, the
    compiled DES engine (ctypes ``.so`` load or numba JIT) are paid once,
    then every chunk reuses them — the amortization the queue tier exists
    for.  With a local ``cache_dir`` the worker prefills queued keys it
    already holds (manifest sync) and persists each computed chunk as one
    packfile.

    ``fingerprints`` are this worker's own code fingerprints; a mismatch
    against the dispatcher's welcome frame aborts the run (a farm running
    mixed code would poison the parent cache with records keyed by the
    wrong fingerprint).  ``die_after`` is failure injection for the
    re-dispatch tests: hard-exit after computing that many cells.
    """
    cache_dir = Path(cache_dir) if cache_dir is not None else None
    if cache_dir is not None:
        scavenge_cache_dir(cache_dir)
    deadline_tries = max(1, int(connect_timeout_s / 0.1))
    sock = None
    for attempt in range(deadline_tries):
        try:
            sock = socket.create_connection((host, port), timeout=30.0)
            break
        except OSError:
            if attempt == deadline_tries - 1:
                raise
            time.sleep(0.1)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.settimeout(None)
    send_lock = threading.Lock()
    computed = 0
    try:
        send_frame(sock, {"t": "hello", "pid": os.getpid(),
                          "host": socket.gethostname(),
                          "version": PROTOCOL_VERSION}, send_lock)
        welcome = recv_frame(sock)
        if not isinstance(welcome, dict) or welcome.get("t") != "welcome":
            return 1
        theirs = welcome.get("fingerprints") or {}
        ours = fingerprints or {}
        drift = sorted(m for m in set(theirs) & set(ours)
                       if theirs[m] != ours[m])
        if drift:
            send_frame(sock, {
                "t": "reject",
                "reason": ("code fingerprint mismatch on "
                           f"{'/'.join(drift)}: worker and dispatcher run "
                           "different result-determining code")}, send_lock)
            return 3
        hb_s = float(welcome.get("heartbeat_s", heartbeat_s))

        # Manifest sync: offer every queued record the local cache holds.
        if cache_dir is not None:
            have = {}
            for key in welcome.get("queued", ()):
                hit = cache_read(cache_dir, key)
                if hit is not None:
                    have[key] = hit
            if have:
                send_frame(sock, {"t": "prefill", "records": have},
                           send_lock)
                log(f"prefilled {len(have)} record(s) from local cache")
        send_frame(sock, {"t": "ready"}, send_lock)

        stop_hb = threading.Event()

        def _heartbeat() -> None:
            while not stop_hb.wait(hb_s):
                try:
                    send_frame(sock, {"t": "hb"}, send_lock)
                except OSError:
                    return

        hb_thread = threading.Thread(target=_heartbeat, name="worker-hb",
                                     daemon=True)
        hb_thread.start()
        try:
            while True:
                frame = recv_frame(sock)
                if frame is None:
                    return 1
                t = frame.get("t")
                if t == "shutdown":
                    send_frame(sock, {"t": "bye"}, send_lock)
                    return 0
                if t != "task":
                    continue

                def _tick(_key: str) -> None:
                    nonlocal computed
                    computed += 1
                    if die_after is not None and computed >= die_after:
                        # Failure injection: a worker crashing mid-chunk
                        # (no result frame ever sent).
                        os._exit(17)

                # The whole chunk runs in-engine (shared staging
                # prototype, lean result scatter), then one packed local
                # write and one result frame.
                before = computed
                records = run_des_chunk(frame["cells"], cache_dir,
                                        on_computed=_tick)
                send_frame(sock, {"t": "result", "id": frame.get("id"),
                                  "records": records}, send_lock)
                log(f"chunk of {len(records)} done "
                    f"({computed - before} computed)")
        finally:
            stop_hb.set()
    finally:
        try:
            sock.close()
        except OSError:
            pass


__all__ = [
    "DispatchError",
    "MEMO_CAP",
    "PROTOCOL_VERSION",
    "QueueDispatcher",
    "RecordMemo",
    "cache_memo_stats",
    "cache_read",
    "cache_write",
    "canonical_digest",
    "chunk_size_for",
    "clear_cache_memo",
    "nan_to_null",
    "payload_cost",
    "record_text",
    "recv_frame",
    "run_cell",
    "run_des_cell",
    "run_des_chunk",
    "run_executor_cell",
    "scavenge_cache_dir",
    "send_frame",
    "worker_serve",
    "write_pack",
]
