"""Multi-pod dry-run (``repro.launch.dryrun``): trace every (architecture
x input shape) step on the production meshes without any device, and
record its roofline terms per device.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
        --shape train_4k [--backend kernel|ref]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
        [--out artifacts/dryrun_torch] [--scenario poisson-open --seed 3]

A cell runs in a process group of 512 fake ranks (``torch.distributed``'s
fake backend: collectives return at once, nothing is sent) under
``FakeTensorMode`` (tensors have shapes and dtypes and no storage), as
the reference compiles for 512 placeholder host devices.  The step is
built on the (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) with
``--multi-pod``; its arguments are DTensors whose local shards are fake
tensors of each rank's shape; it is traced once, eagerly, on the step's
default backend, ``kernel``, as the reference traces its own default
(``backend="xla"``): ``local_map`` hands rank 0's fake shards to each
kernel's operator (``torch.ops.repro_torch.*``; the model's ops send a
fake tensor there on any device), whose fake implementation allocates
the launch's outputs and scratch.  The mesh and the fake tensors are
``cpu`` ones: a CPU-only build cannot run autograd or indexing on fake
CUDA tensors.  ``--backend ref`` traces the kernels' plain versions
instead (their S x S attention scores included): the parity trace,
written under ``<out>/ref/``.
A dispatch mode under DTensor sees the local ops of rank 0 and counts:

* ``cost_analysis.flops``: per-device flops of every product
  (``torch.utils.flop_counter``'s formulas on local shapes; a counter at
  the DTensor level would count global shapes, the mesh size too many);
* ``cost_analysis["bytes accessed"]``: op-level bytes, each op's inputs
  and outputs counted once per op, unfused (views excluded): an upper
  bound on what fused kernels move;
* ``memory_analysis``: the local bytes of the arguments (params,
  optimizer state, batch or caches), of the outputs, of outputs that are
  arguments updated in place (``alias``), and the peak of live storages
  made during the trace (``temp``; ``peak_bytes`` adds the arguments),
  a kernel's scratch live beside its outputs at its launch;
* ``collectives``: bytes (each collective's local result) and counts by
  kind, and ``collectives_by_axis`` by mesh axis;
* ``trace_s``: the trace's wall time on the host.

Eager tracing runs every layer, so the totals are the whole step (the
reference corrects XLA's once-per-loop count with its probes).  The
probes (``lm.apply_unit`` / ``decode_unit`` / the encoder's layer, one
repeat each) are traced too, for the per-unit view and as a consistency
check.  Each cell writes ``<out>/<mesh>/<arch>__<shape>.json`` (a
``ref`` trace ``<out>/ref/<mesh>/...``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from ..configs import ARCHS, SHAPES, get_arch
from ..configs.base import ArchConfig
from ..configs.shapes import SHAPE_ORDER, InputShape, shape_applicable
from ..core.predictor import staircase_runtime
from ..core.scenarios import make_scenario, open_loop_names
from ..kernels import _build
from ..tree import leaves, leaves_with_path, tree_map
from .mesh import _mesh, make_production_mesh
from .steps import Struct, build_step, build_unit_probes

#: The fake world: enough ranks for the multi-pod mesh.
WORLD = 512
#: The backends a cell is traced on (``--backend``).
BACKENDS = ("kernel", "ref")
TRACED = {
    "kernel": "eager, backend=kernel (the CUDA kernels' operators through "
              "their fake implementations, each launch's scratch counted), "
              "FakeTensorMode, fake process group; counts are rank 0's "
              "local ops",
    "ref": "eager, backend=ref (plain versions), FakeTensorMode, fake "
           "process group; counts are rank 0's local ops",
}

_KINDS = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "all_to_all_single": "all-to-all", "broadcast": "broadcast"}
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd")


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


class _Trace:
    """Counts the local ops of one traced call (see the module docstring).
    Built lazily so that importing this module pulls in no dispatch
    machinery."""

    def __init__(self, mesh):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        groups = {mesh.get_group(a).group_name: a
                  for a in mesh.mesh_dim_names}
        trace = self
        self.flops = 0
        self.bytes = 0
        self.collectives = {k: {"bytes": 0, "count": 0}
                            for k in _KINDS.values()}
        self.by_axis: Dict[str, Dict[str, Dict[str, int]]] = {}
        self.live = 0
        self.peak = 0
        self._sizes: Dict[int, int] = {}
        self._meta = 0
        self._scratch = 0
        #: The op at which the peak was last raised (not recorded).
        self.peak_op = ""

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented      # DTensor runs the local ops
                out = func(*args, **kwargs)
                if trace._meta:                # DTensor's shape inference
                    return out
                trace._count(func, args, kwargs, out, groups,
                             flop_registry)
                return out

        self.mode = Mode()

    def _count(self, func, args, kwargs, out, groups, flop_registry):
        from torch.utils._pytree import tree_leaves

        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if func.namespace in _COLLECTIVE_NS:
            name = func.__name__.split(".")[0]
            if name != "wait_tensor":
                kind = _KINDS.get(name, name)
                group = next((a for a in tree_leaves((args, kwargs))
                              if isinstance(a, str) and a in groups), None)
                axis = groups.get(group, "?")
                n = sum(_nbytes(t) for t in outs)
                for rec in (self.collectives.setdefault(
                        kind, {"bytes": 0, "count": 0}),
                        self.by_axis.setdefault(axis, {}).setdefault(
                            kind, {"bytes": 0, "count": 0})):
                    rec["bytes"] += n
                    rec["count"] += 1
        if func.is_view:
            return
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        self.bytes += sum(_nbytes(t) for t in ins + outs)
        peak = self.peak
        for t in outs:
            self.hold(t)
        if self._scratch:           # a launch's scratch, freed on return
            self.peak = max(self.peak, self.live + self._scratch)
            self._scratch = 0
        if self.peak > peak:
            self.peak_op = f"{func} in {_port_frame()}"

    def _add_scratch(self, tensors) -> None:
        if not self._meta:
            self._scratch += sum(_nbytes(t) for t in tensors)

    def hold(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it is freed."""
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._sizes:
            return
        n = storage.nbytes()
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    @contextlib.contextmanager
    def active(self):
        """The counting mode, with DTensor's own bookkeeping left out: its
        sharding propagation (which may run an op's decomposition on meta
        tensors to find its strategy, only where the propagation is not
        cached yet: counted, it made the first trace of a process differ
        from the next), its shape inference (which runs the op on fake
        global tensors) and the shard sizes of a strided shard (a view
        merging two sharded dims), which it reads from a small index
        tensor -- a real one here, since a fake one has no values to
        read."""
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        from torch.distributed.tensor.placement_types import _StridedShard

        trace = self

        def bookkeeping(fn, real: bool):
            def wrapped(*args, **kwargs):
                trace._meta += 1
                try:
                    if not real:
                        return fn(*args, **kwargs)
                    with unset_fake_temporarily():
                        return fn(*args, **kwargs)
                finally:
                    trace._meta -= 1
            return wrapped

        patched = [(ShardingPropagator, "propagate_op_sharding_non_cached",
                    False),
                   (ShardingPropagator, "_propagate_tensor_meta_non_cached",
                    False),
                   (_StridedShard, "local_shard_size_and_offset", True)]
        saved = [(cls, name, getattr(cls, name)) for cls, name, _ in patched]
        for cls, name, real in patched:
            setattr(cls, name, bookkeeping(getattr(cls, name), real))
        try:
            with self.mode, _build.watch_scratch(self._add_scratch):
                yield self
        finally:
            for cls, name, fn in saved:
                setattr(cls, name, fn)

    def collectives_record(self) -> dict:
        return {k: dict(v) for k, v in self.collectives.items()}


def _port_frame() -> str:
    """``file:line (function)`` of the innermost frame of the port's model
    code on the stack (the dry-run and the kernels' wrappers left out)."""
    frame = sys._getframe(1)
    while frame is not None:
        name = frame.f_code.co_filename
        if "repro_torch" in name and not name.endswith(
                ("dryrun.py", "local.py", "_build.py")):
            where = name[name.rindex("repro_torch"):]
            return f"{where}:{frame.f_lineno} ({frame.f_code.co_name})"
        frame = frame.f_back
    return "?"


def _local_shape(s: Struct, mesh) -> Tuple[int, ...]:
    shape = list(s.shape)
    names = list(mesh.mesh_dim_names)
    for dim, entry in enumerate(s.spec or ()):
        for axis in (entry if isinstance(entry, tuple)
                     else () if entry is None else (entry,)):
            shape[dim] //= mesh.size(names.index(axis))
    return tuple(shape)


def fake_args(arg_specs, mesh, grad: bool = False):
    """DTensors on ``mesh`` for a bundle's argument structs, each rank's
    shard a fresh (fake, under ``FakeTensorMode``) tensor; with ``grad``
    the first argument's leaves (the params) require grad."""
    from torch.distributed.tensor import DTensor

    from ..sharding.specs import placements

    def one(s: Struct):
        local = torch.zeros(_local_shape(s, mesh), dtype=s.dtype)
        stride = tuple(math.prod(s.shape[i + 1:]) for i in range(len(s.shape)))
        return DTensor.from_local(local, mesh, placements(s.spec, mesh),
                                  run_check=False, shape=s.shape,
                                  stride=stride)

    out = [tree_map(one, tree) for tree in arg_specs]
    if grad:
        for leaf in leaves(out[0]):
            leaf.requires_grad_()
    return out


def _arg_bytes(args) -> int:
    return sum(_nbytes(t.to_local()) for t in leaves(list(args)))


@contextlib.contextmanager
def fake_world(n: int = WORLD):
    """A process group of ``n`` fake ranks (this process is rank 0)."""
    import torch.distributed as dist
    # registers the "fake" backend and its store
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _traced(fn, args, mesh) -> Tuple[object, _Trace, float]:
    trace = _Trace(mesh)
    for t in leaves(list(args)):
        trace.hold(t.to_local())
    base = trace.live
    trace.peak = base
    t0 = time.perf_counter()
    with trace.active():
        out = fn(*args)
    wall = time.perf_counter() - t0
    trace.temp = trace.peak - base
    return out, trace, wall


def _outputs(out, args) -> Tuple[int, int]:
    """(output bytes, bytes of outputs that are arguments) per device."""
    from torch.distributed.tensor import DTensor

    arg_ids = {id(t) for t in leaves(list(args))}
    total = alias = 0
    for _, t in leaves_with_path(out if isinstance(out, (list, tuple))
                                 else [out]):
        if not isinstance(t, torch.Tensor):
            continue
        n = _nbytes(t.to_local() if isinstance(t, DTensor) else t)
        total += n
        if id(t) in arg_ids:
            alias += n
    return total, alias


def mesh_name_of(multi_pod: bool, mesh_shape: Optional[Tuple[int, ...]]):
    if mesh_shape is not None:
        return "mesh" + "x".join(str(n) for n in mesh_shape)
    return "pod2x16x16" if multi_pod else "pod16x16"


def trace_step(cfg: ArchConfig, shape: InputShape, mesh, backend: str,
               probes: bool = True, verbose: bool = False) -> dict:
    """Trace ``build_step(cfg, shape, mesh=mesh, backend=backend)`` (and,
    with ``probes``, its unit probes) under ``FakeTensorMode``; the
    record's measured fields.  ``verbose`` prints the op at which the
    peak was reached.  Needs a fake process group."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    train = shape.kind == "train"
    bundle = build_step(cfg, shape, mesh=mesh, backend=backend)
    record: dict = {}
    with FakeTensorMode():
        args = fake_args(bundle.arg_specs, mesh, grad=train)
        out, trace, wall = _traced(bundle.fn, args, mesh)
        out_bytes, alias = _outputs(out, args)
        del out
        record["status"] = "ok"
        record["trace_s"] = wall
        record["cost_analysis"] = {"flops": trace.flops,
                                   "bytes accessed": trace.bytes}
        record["memory_analysis"] = {
            "argument_size_in_bytes": _arg_bytes(args),
            "output_size_in_bytes": out_bytes,
            "alias_size_in_bytes": alias,
            "temp_size_in_bytes": trace.temp,
            "peak_bytes": trace.peak,
        }
        record["collectives"] = trace.collectives_record()
        record["collectives_by_axis"] = trace.by_axis
        del args
        if verbose:
            print(f"[dryrun] {backend}: the peak was reached at "
                  f"{trace.peak_op}", flush=True)
        if not probes:
            return record
        record["probes"] = {}
        for key, (pb, repeats) in build_unit_probes(
                cfg, shape, mesh=mesh, backend=backend).items():
            pargs = fake_args(pb.arg_specs, mesh, grad=train)
            if train:
                for t in leaves(pargs[1:]):
                    t.requires_grad_()
            _, ptrace, pwall = _traced(pb.fn, pargs, mesh)
            record["probes"][key] = {
                "repeats": repeats, "flops": ptrace.flops,
                "bytes_accessed": ptrace.bytes,
                "collectives": ptrace.collectives_record(),
                "temp_bytes": ptrace.temp, "trace_s": pwall,
            }
    return record


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             out_dir: Path, verbose: bool = True, *, reduced: bool = False,
             mesh_shape: Optional[Tuple[int, ...]] = None,
             backend: str = "kernel") -> dict:
    """Trace one cell on ``backend`` and write its record.  ``reduced``
    takes the arch's ``.reduced()`` config; ``mesh_shape`` (a ``("data",
    "model")`` shape) replaces the production mesh (tests)."""
    cfg = get_arch(arch_id)
    if reduced:
        cfg = cfg.reduced()
    shape = SHAPES[shape_name]
    mesh_name = mesh_name_of(multi_pod, mesh_shape)
    record = {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_name,
        "kind": shape.kind, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch, "reduced": reduced,
        "n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(),
        "traced": TRACED[backend],
    }
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        record["status"] = "skipped"
        record["why"] = why
        _write(out_dir, mesh_name, arch_id, shape_name, record, backend)
        return record

    world = math.prod(mesh_shape) if mesh_shape is not None else WORLD
    with fake_world(world):
        mesh = _mesh(mesh_shape, ("data", "model"), "cpu") \
            if mesh_shape is not None \
            else make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        record["mesh_shape"] = list(mesh.shape)
        record.update(trace_step(cfg, shape, mesh, backend,
                                 verbose=verbose))

    _write(out_dir, mesh_name, arch_id, shape_name, record, backend)
    if verbose:
        ma = record["memory_analysis"]
        coll = sum(v["bytes"] for v in record["collectives"].values())
        print(f"[dryrun] {mesh_name} {arch_id} {shape_name} {backend}: "
              f"trace={record['trace_s']:.1f}s "
              f"flops/dev={record['cost_analysis']['flops']:.4g} "
              f"args/dev={ma['argument_size_in_bytes'] / 2**30:.2f}GiB "
              f"peak/dev={ma['peak_bytes'] / 2**30:.2f}GiB "
              f"coll/dev={coll / 2**30:.3f}GiB", flush=True)
    return record


def record_path(out_dir: Path, mesh_name: str, arch: str, shape: str,
                backend: str = "kernel") -> Path:
    """Where a cell's record goes: ``<out>/<mesh>/`` for the kernel
    backend, ``<out>/ref/<mesh>/`` for the parity trace."""
    root = Path(out_dir) if backend == "kernel" else Path(out_dir) / backend
    return root / mesh_name / f"{arch}__{shape}.json"


def _write(out_dir: Path, mesh_name: str, arch: str, shape: str,
           record: dict, backend: str = "kernel") -> None:
    path = record_path(out_dir, mesh_name, arch, shape, backend)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1, sort_keys=True, allow_nan=False)


def _scenario_order(cells: list, scenario: str, seed: int) -> list:
    """Order the cells as a submission stream from the scenario registry
    (``repro.launch.dryrun._scenario_order``): the named scenario's seeded
    RNG stream draws the order, so the same ``--scenario --seed`` pair
    replays the same stream anywhere."""
    scn = make_scenario(scenario, seed=seed)
    order = scn.rng(len(cells)).permutation(len(cells))
    return [cells[i] for i in order]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), help="single arch")
    ap.add_argument("--shape", choices=list(SHAPE_ORDER), help="single shape")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the 2x16x16 multi-pod mesh (default 16x16)")
    ap.add_argument("--reduced", action="store_true",
                    help="trace the archs' .reduced() configs")
    ap.add_argument("--backend", choices=BACKENDS, default="kernel",
                    help="kernel: the step's default path, the kernels' "
                         "operators through their fake implementations; "
                         "ref: the plain versions (the parity trace, "
                         "under <out>/ref/)")
    ap.add_argument("--out", default="artifacts/dryrun_torch", type=Path)
    ap.add_argument("--skip-existing", action="store_true")
    # trace-replay needs a trace the CLI doesn't take; closed-loop
    # scenarios have no fixed submission stream
    ap.add_argument("--scenario", default=None,
                    choices=sorted(set(open_loop_names()) - {"trace-replay"}),
                    help="order the cells as a submission stream drawn "
                         "from this registered arrival process "
                         "(deterministic per --seed)")
    ap.add_argument("--seed", type=int, default=0,
                    help="scenario seed (with --scenario)")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, shape) for arch in sorted(ARCHS)
                 for shape in SHAPE_ORDER]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    elif args.arch:
        cells = [(args.arch, s) for s in SHAPE_ORDER]
    else:
        ap.error("pass --all or --arch [--shape]")
    if args.scenario:
        cells = _scenario_order(cells, args.scenario, args.seed)

    mesh_name = mesh_name_of(args.multi_pod, None)
    failures = done = 0
    for i, (arch, shape) in enumerate(cells):
        path = record_path(args.out, mesh_name, arch, shape, args.backend)
        if args.skip_existing and path.exists():
            st = json.loads(path.read_text()).get("status")
            if st in ("ok", "skipped"):
                print(f"[dryrun] skip existing {arch} {shape} ({st})",
                      flush=True)
                continue
        t_cell0 = time.perf_counter()
        try:
            run_cell(arch, shape, args.multi_pod, args.out,
                     reduced=args.reduced, backend=args.backend)
            done += 1
            remaining = len(cells) - i - 1
            if done == 1 and remaining:
                # structural runtime prediction for the sweep itself: the
                # cells are its homogeneous blocks (one lane) -- profile
                # one, extrapolate the rest (an upper bound)
                t_cell = time.perf_counter() - t_cell0
                pred = staircase_runtime(remaining, 1, t_cell)
                print(f"[dryrun] predictor: t={t_cell:.1f}s/cell -> "
                      f"<={pred:.0f}s for the up to {remaining} remaining "
                      f"cells", flush=True)
        except Exception:   # a failed cell is recorded; the sweep goes on
            failures += 1
            print(f"[dryrun] FAILED {arch} {shape}", flush=True)
            traceback.print_exc()
            _write(args.out, mesh_name, arch, shape, {
                "arch": arch, "shape": shape, "mesh": mesh_name,
                "status": "failed", "error": traceback.format_exc(),
            }, args.backend)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
