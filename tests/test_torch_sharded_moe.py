"""The sharded steps of deepseek-v2-lite-16b (MLA + MoE, capacity factor
16) against the unsharded port (fp32, ``LocalTensorMode``; the bounds of
``test_torch_sharded_steps.py``).  A MoE arch keeps the cp plan (batch
over the data axes, sequence over ``model``): the expert-parallel path
(capacity over each rank's tokens, all_to_all over ``model``) runs in
the loss, the forward and the prefill, the per-row dispatch on each
rank's rows in the decode steps.  At capacity 16 nothing is dropped, and
only then are the two formulations the same function."""

from __future__ import annotations

import pytest
from test_torch_sharded_steps import check_arch, time_limit  # noqa: F401
from repro_torch import intra_op_threads


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The module's CPU work on one intra-op thread: its small products
    would wake every thread, which under the suite's parallel workers
    makes them many times slower (the rule of ``README.md``'s "Tests on
    the CPU")."""
    with intra_op_threads(1):
        yield


MOE_CASES = [("deepseek-v2-lite-16b", (2, 2), 2, "cp"),
             ("deepseek-v2-lite-16b", (4, 2), 4, "cp")]


@pytest.mark.parametrize("arch,mesh_shape,B,plan", MOE_CASES)
def test_sharded_moe_steps_match_the_unsharded_port(arch, mesh_shape, B,
                                                    plan):
    check_arch(arch, mesh_shape, B, 16, plan)
