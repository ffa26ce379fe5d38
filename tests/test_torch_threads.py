"""``repro_torch.intra_op_threads``: the block's intra-op thread count and
the one it gives back.

Every port test module enters the helper at one thread for its whole run
(its ``_one_intra_op_thread`` fixture), so the counts here are taken
against that, and the helper is entered at another count to tell the two
apart.  The plain threefry draws run on one thread whatever the caller's
count, and give the caller's count back.
"""

import pytest
import torch

from repro_torch import intra_op_threads, prng
from repro_torch.kernels import threefry


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The module's CPU work on one intra-op thread: its small products
    would wake every thread, which under the suite's parallel workers
    makes them many times slower (the rule of ``README.md``'s "Tests on
    the CPU")."""
    with intra_op_threads(1):
        yield


def test_the_module_runs_on_one_intra_op_thread():
    assert torch.get_num_threads() == 1


def test_the_count_is_given_back_after_the_block():
    with intra_op_threads(3):
        assert torch.get_num_threads() == 3
    assert torch.get_num_threads() == 1


def test_the_count_is_given_back_when_the_block_raises():
    with pytest.raises(ValueError, match="inside"):
        with intra_op_threads(3):
            assert torch.get_num_threads() == 3
            raise ValueError("inside")
    assert torch.get_num_threads() == 1


def test_a_nested_block_gives_back_the_outer_count():
    with intra_op_threads(3):
        with intra_op_threads(2):
            assert torch.get_num_threads() == 2
        assert torch.get_num_threads() == 3
    assert torch.get_num_threads() == 1


@pytest.mark.parametrize("dist", ["bits", "normal"])
def test_plain_threefry_draws_on_one_thread_and_keeps_the_callers_count(
        dist, monkeypatch):
    counts = []
    real = threefry.threefry_plain

    def counted(*args, **kwargs):
        counts.append(torch.get_num_threads())
        return real(*args, **kwargs)

    monkeypatch.setattr(threefry, "threefry_plain", counted)
    key = prng.key(7)
    dtype = torch.int32 if dist == "bits" else torch.float32
    # Three chunks, so the op walks its chunk loop.
    out = torch.empty(2 * threefry.CHUNK + 5, dtype=dtype)
    with intra_op_threads(3):
        threefry.draw(out, key, dist, scale=0.5)
        assert torch.get_num_threads() == 3
    assert counts == [1, 1, 1]
    want = real(key, out.numel(), dist, scale=0.5)
    assert torch.equal(out, want.to(dtype))
