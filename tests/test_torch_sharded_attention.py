"""The sharded steps of minicpm3-4b (MLA) and whisper-large-v3 (the
encoder and cross attention) against the unsharded port (fp32,
``LocalTensorMode``; the cases and bounds of
``test_torch_sharded_steps.py``), under the cp plan (sequence over
``model``) and the full-mesh batch plan."""

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


CASES = [
    ("minicpm3-4b", (4, 2), 4, "cp"), ("minicpm3-4b", (2, 2), 4, "full"),
    ("whisper-large-v3", (2, 2), 2, "cp"),
    ("whisper-large-v3", (4, 2), 8, "full"),
]


@pytest.mark.parametrize("arch,mesh_shape,B,plan", CASES)
def test_sharded_attention_steps_match_the_unsharded_port(arch, mesh_shape,
                                                          B, plan):
    check_arch(arch, mesh_shape, B, 16, plan)
