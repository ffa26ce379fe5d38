"""The port's attention ops against the JAX package's, on the CPU.

The same numpy inputs (drawn from ``default_rng``) go through the port's
ops (which take the kernels' plain versions for CPU tensors) and through
the JAX reference oracle, the XLA formulation and the Pallas kernel in
interpret mode, with the cases and tolerances of ``tests/test_kernels.py``.
The CUDA kernels themselves are held to the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models.layers import causal_mask, window_mask
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda

# The sweeps of tests/test_kernels.py, dtypes by name.
ATTN_SWEEP = [
    # (B, Sq, Sk, H, KV, D, mask_kind, window, dtype)
    (1, 8, 8, 2, 2, 8, "causal", 0, "float32"),
    (2, 16, 16, 4, 2, 16, "causal", 0, "float32"),
    (2, 16, 24, 4, 1, 8, "none", 0, "float32"),
    (1, 24, 24, 8, 4, 32, "window", 7, "float32"),
    (2, 16, 16, 4, 4, 16, "causal", 0, "bfloat16"),
    (1, 32, 16, 2, 2, 64, "causal", 0, "float32"),   # Sq > Sk
]
DECODE_SWEEP = [
    # (B, S, H, KV, D, dtype)
    (1, 8, 2, 2, 8, "float32"),
    (2, 32, 8, 4, 16, "float32"),
    (3, 17, 4, 1, 32, "float32"),
    (2, 16, 4, 4, 16, "bfloat16"),
]
# tests/test_kernels.py: TOL / TOL32 times 10 for attention, 2e-2 / 1e-4
# for decode.  bf16 inputs are rounded to bf16 identically on both sides;
# the tolerance covers the bf16 rounding of the outputs.
ATTN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DECODE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JAX_REFS = ["ref", "xla", "pallas"]


def _pair(a: np.ndarray, dtype: str):
    """One numpy array as a (jax, torch) pair of the same dtype and bits."""
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("impl", JAX_REFS)
@pytest.mark.parametrize("case", ATTN_SWEEP, ids=str)
def test_flash_attention_matches_jax(case, impl):
    B, Sq, Sk, H, KV, D, kind, window, dtype = case
    rng = np.random.default_rng(ATTN_SWEEP.index(case))
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.standard_normal(s, dtype=np.float32), dtype)
        for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D)))
    if impl == "ref":
        mask = {"causal": causal_mask(Sq, Sk, 0),
                "window": window_mask(Sq, Sk, 0, window)}.get(kind)
        want = jref.attention(jq, jk, jv, mask)
    elif impl == "xla":
        want = jops.flash_attention(jq, jk, jv, mask_kind=kind,
                                    window=window, kv_chunk=7)
    else:
        want = flash_attention_pallas(jq, jk, jv, mask_kind=kind,
                                      window=window, block_q=8, block_k=8)
    got = ops.flash_attention(tq, tk, tv, mask_kind=kind, window=window)
    assert got.dtype == tq.dtype and tuple(got.shape) == (B, Sq, H, D)
    tol = ATTN_TOL[dtype]
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("impl", JAX_REFS)
@pytest.mark.parametrize("case", DECODE_SWEEP, ids=str)
def test_decode_attention_matches_jax(case, impl):
    B, S, H, KV, D, dtype = case
    rng = np.random.default_rng(100 + DECODE_SWEEP.index(case))
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.standard_normal(s, dtype=np.float32), dtype)
        for s in ((B, H, D), (B, S, KV, D), (B, S, KV, D)))
    length = rng.integers(1, S + 1, size=B).astype(np.int32)
    jl, tl = jnp.asarray(length), torch.from_numpy(length)
    if impl == "ref":
        want = jref.decode_attention(jq, jk, jv, jl)
    elif impl == "xla":
        want = jops.decode_attention(jq, jk, jv, jl)
    else:
        want = decode_attention_pallas(jq, jk, jv, jl, block_k=8)
    got = ops.decode_attention(tq, tk, tv, tl)
    assert got.dtype == tq.dtype and tuple(got.shape) == (B, H, D)
    tol = DECODE_TOL[dtype]
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=tol, atol=tol)


def test_decode_attention_zero_length_gives_zeros_like_pallas():
    rng = np.random.default_rng(7)
    B, S, H, KV, D = 3, 16, 4, 2, 8
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.standard_normal(s, dtype=np.float32), "float32")
        for s in ((B, H, D), (B, S, KV, D), (B, S, KV, D)))
    length = np.array([0, 5, 0], np.int32)
    want = np.asarray(decode_attention_pallas(jq, jk, jv, jnp.asarray(length),
                                              block_k=8))
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(length)).numpy()
    assert np.all(want[[0, 2]] == 0.0) and np.all(got[[0, 2]] == 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_fully_masked_rows_give_zeros():
    """A window query row with q_offset past every key sees nothing."""
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((1, 4, 2, 8), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 4, 2, 8), dtype=np.float32))
    out = ops.flash_attention(q, k, k, mask_kind="window", window=2,
                              q_offset=8)
    assert torch.count_nonzero(out) == 0


def test_cpu_calls_leave_launch_counters_at_zero():
    ops.reset_launch_counts()
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((1, 8, 4, 16), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 8, 2, 16), dtype=np.float32))
    ops.flash_attention(q, k, k)
    ops.decode_attention(q[:, 0], k, k, torch.tensor([3], dtype=torch.int32))
    assert ops.launch_counts() == {"flash_attention": 0,
                                   "decode_attention": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros((1, 8, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda(q[:, 0], k, k,
                              torch.tensor([3], dtype=torch.int32))
    assert ops.launch_counts() == {"flash_attention": 0,
                                   "decode_attention": 0}


def test_unknown_backend_raises():
    q = torch.zeros((1, 2, 2, 8))
    with pytest.raises(ValueError, match="backend"):
        ops.flash_attention(q, q, q, backend="xla")
