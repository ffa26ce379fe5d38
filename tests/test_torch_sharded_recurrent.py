"""The sharded steps of the recurrent archs against the unsharded port
(fp32, ``LocalTensorMode``; the cases and bounds of
``test_torch_sharded_steps.py``): mamba2-2.7b (the SSD scan on head
shards) and recurrentgemma-2b (the RG-LRU scan on channel shards, local
attention), under the tp plan (batch over the data axes, heads or
channels over ``model``) and the full-mesh batch plan."""

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


RECURRENT_CASES = [
    ("mamba2-2.7b", (2, 2), 2, "tp"), ("mamba2-2.7b", (4, 2), 8, "full"),
    ("recurrentgemma-2b", (2, 2), 2, "tp"),
    ("recurrentgemma-2b", (4, 2), 8, "full"),
]


@pytest.mark.parametrize("arch,mesh_shape,B,plan", RECURRENT_CASES)
def test_sharded_recurrent_steps_match_the_unsharded_port(arch, mesh_shape,
                                                          B, plan):
    check_arch(arch, mesh_shape, B, 16, plan)
