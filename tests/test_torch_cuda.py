"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips where there is no CUDA device.  On a
GPU machine::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Inputs are bf16; the plain versions run in float32 on the same values.
Tolerance |kernel - plain| <= 2e-2 + 2e-2 |plain|: the kernels round
probabilities (flash) and outputs to bf16, ~0.4% relative each, and 2e-2
is the bf16 tolerance of ``tests/test_kernels.py``.
"""

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (
    decode_attention_cuda,
    decode_attention_plain,
)
from repro_torch.kernels.flash_attention import (
    flash_attention_cuda,
    flash_attention_plain,
)

pytestmark = pytest.mark.cuda
TOL = 2e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def _close(got, want):
    assert got.shape == want.shape and torch.isfinite(got).all()
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= TOL + TOL * want.float().abs()).all()), \
        float(diff.max())


FLASH = [
    # (B, Sq, Sk, H, KV, D, Dv, mask_kind, window, q_offset)
    (1, 64, 64, 2, 2, 64, 64, "causal", 0, 0),
    (2, 100, 100, 8, 2, 128, 128, "causal", 0, 0),
    (1, 37, 129, 4, 1, 128, 128, "none", 0, 0),
    (2, 50, 130, 4, 4, 64, 64, "causal", 0, 80),
    (1, 300, 300, 4, 2, 128, 128, "window", 33, 0),
    (1, 65, 65, 2, 1, 128, 64, "causal", 0, 0),
    (1, 65, 65, 2, 1, 64, 128, "window", 64, 0),
    (1, 8, 8, 2, 2, 64, 64, "window", 2, 20),    # rows see no key: zeros
]


@pytest.mark.parametrize("case", FLASH, ids=str)
def test_flash_kernel_matches_plain(case, gen):
    B, Sq, Sk, H, KV, D, Dv, kind, window, off = case
    q, k, v = _randn(gen, B, Sq, H, D), _randn(gen, B, Sk, KV, D), \
        _randn(gen, B, Sk, KV, Dv)
    kw = dict(mask_kind=kind, window=window, q_offset=off)
    got = flash_attention_cuda(q, k, v, **kw)
    want = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    _close(got, want)


DECODE = [
    # (B, S, H, KV, D, Dv, lengths)
    (1, 8, 2, 2, 64, 64, [8]),
    (4, 1096, 32, 4, 128, 128, [1, 300, 777, 1096]),
    (3, 200, 8, 8, 128, 128, [64, 65, 129]),
    (2, 70, 16, 1, 64, 128, [0, 70]),
]


@pytest.mark.parametrize("case", DECODE, ids=str)
def test_decode_kernel_matches_plain(case, gen):
    B, S, H, KV, D, Dv, lens = case
    q = _randn(gen, B, H, D)
    kc, vc = _randn(gen, B, S, KV, D), _randn(gen, B, S, KV, Dv)
    length = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = decode_attention_cuda(q, kc, vc, length)
    want = decode_attention_plain(q.float(), kc.float(), vc.float(), length)
    torch.cuda.synchronize()
    _close(got, want)


def test_ops_route_cuda_tensors_to_the_kernels(gen):
    ops.reset_launch_counts()
    q, k = _randn(gen, 1, 16, 4, 64), _randn(gen, 1, 16, 2, 64)
    ops.flash_attention(q, k, k)
    ops.decode_attention(q[:, 0].contiguous(), k, k,
                         torch.tensor([5], dtype=torch.int32, device="cuda"))
    ops.flash_attention(q, k, k, backend="ref")
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"flash_attention": 1,
                                   "decode_attention": 1}


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q, k = _randn(gen, 1, 16, 4, 64), _randn(gen, 1, 16, 2, 64)
    with pytest.raises(TypeError):
        flash_attention_cuda(q.float(), k.float(), k.float())
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_cuda(_randn(gen, 1, 16, 4, 96),
                             _randn(gen, 1, 16, 2, 96),
                             _randn(gen, 1, 16, 2, 96))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q.transpose(1, 2), k, k)
    with pytest.raises(ValueError, match="length"):
        decode_attention_cuda(q[:, 0].contiguous(), k, k,
                              torch.tensor([5], device="cuda"))
