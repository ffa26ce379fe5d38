"""The port's serving path and scheduler copy, on the CPU.

* Serving jobs of reduced yi-6b, a mix of reduced mamba2-2.7b and
  recurrentgemma-2b, and one of reduced minicpm3-4b (MLA) and
  deepseek-v2-lite-16b (MLA + MoE), run through the port's
  SchedulerService under srtf and fifo, and through ``python -m
  repro_torch.launch.serve``, whose default mix is the JAX package's.
* The port's copies of the scheduler modules are held to the JAX
  package's: the files are identical, and both ``LaneExecutor``s produce
  the same trace and results for the same jobs under one fake clock.
* The port imports neither JAX nor the JAX package, and its entry points
  refuse to run without a card unless asked for the CPU.
"""

import ast
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

import repro.core.executor as j_executor
from repro.core.executor import ExecutorJob as JJob, LaneExecutor as JLane
from repro.core.policies import POLICIES, make_policy as j_make_policy
from repro_torch.configs import get_arch
from repro_torch.core import executor as t_executor
from repro_torch.core.executor import ExecutorJob as TJob, LaneExecutor as TLane
from repro_torch.core.jobs import make_serve_job
from repro_torch.core.policies import make_policy as t_make_policy
from repro_torch.core.scheduler_service import SchedulerService
from repro_torch.launch import serve
from repro_torch.models import lm

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
COPIED = ["configs/" + p.name for p in sorted(
    (ROOT / "src" / "repro" / "configs").glob("*.py"))] + [
    f"core/{m}.py" for m in ("workload", "events", "predictor", "machine",
                             "policies", "executor", "metrics",
                             "scheduler_service")]


# ------------------------------------------------------------- serving
@pytest.mark.parametrize("policy", ["srtf", "fifo"])
def test_serve_jobs_finish_through_the_service(policy):
    cfg = get_arch("yi-6b").reduced()
    blocks = {"long": 4, "short": 2}
    with SchedulerService(n_lanes=2, policy=policy) as service:
        handles = {
            name: service.submit(make_serve_job(
                cfg, name, blocks=n, tokens_per_block=2, batch=1,
                prompt_len=8, seed=i, device="cpu"))
            for i, (name, n) in enumerate(sorted(blocks.items()))}
        results = {name: h.result_blocking(timeout=120)
                   for name, h in handles.items()}
    for name, res in results.items():
        assert res.blocks == blocks[name] and not res.cancelled


def test_serve_job_takes_a_given_prompt_and_keeps_state_through_warmup():
    cfg = get_arch("yi-6b").reduced()
    prompt = torch.arange(16).reshape(2, 8) % cfg.vocab_size
    job = make_serve_job(cfg, "p", blocks=1, tokens_per_block=1, batch=2,
                         prompt_len=8, prompt=prompt.numpy(), device="cpu")
    job.warmup_fn()
    job.make_block_fn(1)()
    with pytest.raises(ValueError, match="prompt shape"):
        make_serve_job(cfg, "p", blocks=1, batch=1, prompt_len=8,
                       prompt=prompt, device="cpu")


@pytest.mark.parametrize("extra,blocks", [
    ([], [2, 3]),
    (["--closed-loop", "2", "--requests", "3"], [2, 3, 3]),
], ids=["open-loop", "closed-loop"])
def test_serve_cli_reduced_on_cpu(extra, blocks, capsys):
    runs = serve.main(["--device", "cpu", "--reduced",
                       "--jobs", "yi-6b:3,yi-6b:2", "--policy", "srtf",
                       "--compare-fifo", "--tokens-per-block", "2",
                       "--prompt-len", "8", "--batch", "1", "--lanes", "2",
                       "--stagger", "0"] + extra)
    assert sorted(runs) == ["fifo", "srtf"]
    for run in runs.values():
        assert run["peak_bytes"] is None
        assert sorted(r.blocks for r in run["results"]) == blocks
    assert "srtf vs fifo" in capsys.readouterr().out


def test_serve_cli_mixes_recurrent_archs_on_cpu(capsys):
    """The mixed tenants of the chip run, reduced: a pure-SSM model and the
    RG-LRU / local-attention hybrid share the service."""
    runs = serve.main(["--device", "cpu", "--reduced",
                       "--jobs", "mamba2-2.7b:3,recurrentgemma-2b:2",
                       "--policy", "srtf", "--compare-fifo",
                       "--tokens-per-block", "4", "--prompt-len", "8",
                       "--batch", "2", "--lanes", "2", "--stagger", "0"])
    assert sorted(runs) == ["fifo", "srtf"]
    for run in runs.values():
        assert sorted((r.key.split("#")[0], r.blocks, r.cancelled)
                      for r in run["results"]) == [
            ("mamba2-2.7b", 3, False), ("recurrentgemma-2b", 2, False)]
    out = capsys.readouterr().out
    assert "tenant=mamba2-2.7b" in out and "tenant=recurrentgemma-2b" in out


def test_serve_cli_mixes_mla_and_moe_archs_on_cpu(capsys):
    """The MLA / MoE tenants of the chip run, reduced."""
    runs = serve.main(["--device", "cpu", "--reduced",
                       "--jobs", "minicpm3-4b:4,deepseek-v2-lite-16b:2",
                       "--policy", "srtf", "--compare-fifo",
                       "--tokens-per-block", "4", "--prompt-len", "8",
                       "--batch", "1", "--lanes", "2", "--stagger", "0"])
    for run in runs.values():
        assert sorted((r.key.split("#")[0], r.blocks, r.cancelled)
                      for r in run["results"]) == [
            ("deepseek-v2-lite-16b", 2, False), ("minicpm3-4b", 4, False)]
    out = capsys.readouterr().out
    assert "tenant=minicpm3-4b" in out and "tenant=deepseek-v2-lite-16b" in out


def test_serve_default_mix_is_the_references():
    """``--jobs`` defaults to ``repro.launch.serve``'s mix,
    ``yi-6b:24,minicpm3-4b:6`` (read from its source, which builds its
    parser inside ``main``), and that mix runs, reduced, on the CPU."""
    tree = ast.parse((ROOT / "src" / "repro" / "launch" / "serve.py")
                     .read_text())
    want = next(kw.value.value for node in ast.walk(tree)
                if isinstance(node, ast.Call) and node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value == "--jobs"
                for kw in node.keywords if kw.arg == "default")
    assert want == "yi-6b:24,minicpm3-4b:6"
    assert serve.build_parser().get_default("jobs") == want
    runs = serve.main(["--device", "cpu", "--reduced", "--policy", "fifo",
                       "--tokens-per-block", "1", "--prompt-len", "4",
                       "--batch", "1", "--stagger", "0"])
    assert sorted(r.blocks for r in runs["fifo"]["results"]) == [6, 24]


def test_serve_job_refuses_to_outgrow_the_local_window():
    cfg = get_arch("recurrentgemma-2b").reduced()
    job = make_serve_job(cfg, "long", blocks=20, tokens_per_block=4,
                         batch=1, prompt_len=8, device="cpu")
    with pytest.raises(ValueError, match="window"):
        job.warmup_fn()


# ------------------------------------------------- scheduler-copy parity
JOBS = [
    # (name, blocks, max_residency, arrival s, block seconds)
    ("a", 7, 2, 0.0, 0.30),
    ("b", 3, 4, 0.05, 0.10),
    ("c", 5, 1, 0.40, 0.20),
    ("d", 2, 3, 0.45, 0.70),
]


def _drive(job_cls, lane_cls, make_policy, module, predictor, policy,
           monkeypatch):
    clock = [0.0]
    monkeypatch.setattr(module, "time",
                        types.SimpleNamespace(perf_counter=lambda: clock[0]))

    def job(name, blocks, res, arrival, secs):
        calls = [0]

        def make_block_fn(residency):
            def block():
                calls[0] += 1
                # deterministic, slightly uneven block times
                clock[0] += secs * (1.0 + 0.1 * (calls[0] % 3))
            return block
        return job_cls(name=name, num_blocks=blocks, max_residency=res,
                       make_block_fn=make_block_fn, arrival=arrival,
                       est_block_seconds=secs)

    ex = lane_cls([job(*spec) for spec in JOBS], make_policy(policy),
                  n_lanes=4, predictor=predictor)
    results = ex.run()
    return ex.trace, {k: (r.arrival, r.finish, r.blocks, r.cancelled)
                      for k, r in sorted(results.items())}


@pytest.mark.parametrize("predictor", ["simple-slicing", "ewma"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_scheduler_copy_matches_reference(policy, predictor, monkeypatch):
    want = _drive(JJob, JLane, j_make_policy, j_executor, predictor, policy,
                  monkeypatch)
    got = _drive(TJob, TLane, t_make_policy, t_executor, predictor, policy,
                 monkeypatch)
    assert got == want
    assert len(want[0]) == sum(spec[1] for spec in JOBS)


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_is_identical_to_reference(rel):
    assert (PORT / rel).read_bytes() == \
        (ROOT / "src" / "repro" / rel).read_bytes()


# ------------------------------------------------------ package boundary
def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} "
                               f"imports {name}")
    assert not bad, bad
    assert len(_port_files()) > 20


def test_entry_points_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    cfg = get_arch("yi-6b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.init(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_serve_job(cfg, "x", blocks=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--reduced", "--jobs", "yi-6b:1"])


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_a_card(alone, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = ROOT / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_bytes(script.read_bytes())
        script = tmp_path / "chip_smoke.py"
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
