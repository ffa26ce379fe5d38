"""The port's examples on the CPU (in a file of their own, so that they
run beside the serving tests): the concurrent-serving example, reduced (a
long MLA decode job and a short dense one under FIFO, SRTF and adaptive
SRTF), and the quickstart (its staircase prediction from step 1, and its
loop against the reference's train steps)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten
from repro.configs import get_arch as j_get_arch
from repro.configs.shapes import InputShape
from repro.data import pipeline as jdata
from repro.launch import steps as jsteps
from repro.launch.steps import build_train_step as j_build_train_step
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch import tree
from repro_torch.configs import get_arch
from repro_torch.core.predictor import staircase_runtime
from repro_torch.examples import concurrent_serving, quickstart
from repro_torch.launch import steps as tsteps
from repro_torch.launch.steps import build_train_step
from repro_torch.models import lm
from repro_torch.models.bridge import params_from_numpy
from repro_torch.optim import adamw


def test_concurrent_serving_example_reduced_on_cpu(capsys):
    out = concurrent_serving.main(["--device", "cpu", "--reduced"])
    assert sorted(out) == ["fifo", "srtf", "srtf-adaptive"]
    assert all(m.stp > 0 and m.antt > 0 for m in out.values())
    out = capsys.readouterr().out
    assert "solo runtimes: long-job=" in out and "Expected: SRTF" in out


# ------------------------------------------------------------- quickstart
@pytest.mark.parametrize("arch", ["yi-6b", "deepseek-v2-lite-16b"])
def test_quickstart_on_cpu_predicts_from_step_one(arch, capsys):
    run = quickstart.main(["--device", "cpu", "--steps", "3", "--arch",
                           arch])
    assert len(run["nll"]) == len(run["ms"]) == 3
    assert all(np.isfinite(run["nll"]))
    assert run["predicted_s"] == staircase_runtime(2, 1, run["dt_1"])
    out = capsys.readouterr().out
    assert f"arch={arch} (reduced:" in out
    assert "[staircase] t=" in out and "predicted" in out
    assert "[staircase] total wall" in out


def test_quickstart_loop_matches_the_reference_steps(monkeypatch):
    """Three steps of the quickstart's loop against three of the
    reference's ``build_train_step`` with the quickstart's optimizer
    settings, from the same weights (the reference's ``lm.init``, bridged
    through ``params_from_numpy``) on the same numpy batches, both losses
    in float32: each step's nll within 1e-4 relative (the packages do the
    same fp32 arithmetic in another order, ~1e-6; a wrong schedule, decay
    or update moves the second and third nll by far more)."""
    steps = 3
    monkeypatch.setattr(jsteps.lm, "loss_fn", functools.partial(
        jlm.loss_fn, dtype=jnp.float32))
    monkeypatch.setattr(tsteps.lm, "loss_fn", functools.partial(
        lm.loss_fn, dtype=torch.float32))
    cfg = j_get_arch("yi-6b").reduced()
    tcfg = get_arch("yi-6b").reduced()
    shape = InputShape(**dataclasses.asdict(quickstart.SHAPE))
    batches = [{"tokens": np.array(jdata.batch_for_step(cfg, shape,
                                                          s)["tokens"])}
               for s in range(steps)]
    opt = quickstart.opt_config(steps)
    bundle = j_build_train_step(cfg, shape, mesh=None, remat=False,
                                opt_cfg=jadamw.OptConfig(
                                    lr=opt.lr, warmup_steps=opt.warmup_steps,
                                    total_steps=opt.total_steps))
    params = jlm.init(cfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v, np.float32)
            for k, v in _flatten(params).items()}
    jp, js, want = params, jadamw.init(params), []
    for b in batches:
        jp, js, m = bundle.fn(jp, js, {"tokens": jnp.asarray(b["tokens"])})
        want.append(float(m["nll"]))

    tp = params_from_numpy(tcfg, flat, device="cpu", dtype=torch.float32,
                           stacked=True)
    for p in tree.leaves(tp):
        p.requires_grad_()
    tbundle = build_train_step(tcfg, quickstart.SHAPE, mesh=None,
                               remat=False, opt_cfg=opt)
    run = quickstart.run_steps(
        tbundle, tp, adamw.init(tp),
        ({"tokens": torch.from_numpy(b["tokens"]).long()} for b in batches),
        steps, torch.device("cpu"))
    np.testing.assert_allclose(run["nll"], want, rtol=1e-4)
