"""The MoE backward: the port's gradients against ``jax.vjp`` of the JAX
package's ``ops.moe_apply``, ``moe_dispatch`` and ``moe_combine``, on the
CPU.

Inputs are numpy arrays from ``default_rng``; both packages take them.  The
port dispatches every batch row at once; the JAX package one row at a
time (``jax.vmap``), so its weight gradients are summed over the rows.

The dispatch's and the combine's row gathers are autograd functions whose
backward is a gather summed over a token's K entries in ascending expert
order: autograd's own backward of ``gather`` is a ``scatter_add``, which
sums with atomics on CUDA and so gives other bits on every run there.  On
the CPU that cannot be seen to vary, so the tests also read the autograd
graph and the ops the backward runs.

Tolerances: float32 ``F32_TOL`` 1e-4 (as ``tests/test_torch_mla_moe.py``:
the same float32 arithmetic in another order, ~1e-6 relative).  The
backwards of the dispatch and the combine alone (dx and dy) are bitwise
equal in bf16 too: each is a gather and a sum of a token's K entries in
the order in which XLA's scatter-add visits them, rounding after each add
as it does.
Through the experts in bf16, each gradient within ``BF16_REL_L2`` 3e-2
relative L2 (the bound the models are held to): the expert products'
gradients are matrix products that accumulate in another order before
they round to bf16, so a bf16 ulp (~0.4%) of difference per product
carries into every sum downstream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.kernels import ops as jops
from repro_torch.kernels import ops

F32_TOL = 1e-4
BF16_REL_L2 = 3e-2

# capacity 2 drops entries (T * K / E = 7.5 a row on average); 20 none.
# K 3: the order of a token's contributions matters from 3 on.
CAPACITIES = [2, 20]
DTYPES = ["float32", "bfloat16"]
B, T, D, E, K, FF = 3, 10, 8, 4, 3, 16


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    # distinct experts per token (as top-k gives them), gates in (0, 1)
    idx = np.argsort(rng.random((B, T, E)), axis=-1)[..., :K].astype(
        np.int32)
    gate = rng.random((B, T, K)).astype(np.float32)
    weights = tuple((rng.standard_normal(s) * 0.3).astype(np.float32)
                    for s in ((E, D, FF), (E, D, FF), (E, FF, D)))
    return rng, x, idx, gate, weights


def _torch(a, dtype, grad=True):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    return t.requires_grad_(grad)


def _assert_close(name, got, want, dtype):
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape, name
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=name)
    else:
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel < BF16_REL_L2, (name, rel)


@pytest.mark.parametrize("capacity", CAPACITIES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_apply_gradients_match_jax_vjp(capacity, dtype):
    """dx, the three expert weights' and the gates' gradients of
    ``moe_apply`` for one cotangent of its output, against ``jax.vjp``."""
    rng, x, idx, gate, (gw, uw, dw) = _inputs(50 + capacity)
    dout = rng.standard_normal((B, T, D)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jax_fn(x, gw, uw, dw, gate):
        return jax.vmap(lambda a, i, g: jops.moe_apply(
            a, gw, uw, dw, i, g, capacity, dtype=jdt),
            in_axes=(0, 0, 0))(x, idx, gate)

    jx, jg = jnp.asarray(x).astype(jdt), jnp.asarray(gate).astype(jdt)
    want_out, vjp = jax.vjp(jax_fn, jx, jnp.asarray(gw), jnp.asarray(uw),
                            jnp.asarray(dw), jg)
    want = vjp(jnp.asarray(dout).astype(want_out.dtype))

    tx, tg = _torch(x, tdt), _torch(gate, tdt)
    tw = [_torch(w, torch.float32) for w in (gw, uw, dw)]
    out = ops.moe_apply(tx, *tw, torch.from_numpy(idx).long(), tg,
                        capacity, dtype=tdt)
    assert out.dtype == tdt
    got = torch.autograd.grad(out, [tx, *tw, tg],
                              _torch(dout, tdt, grad=False))
    for name, g, w in zip(("x", "gate_w", "up_w", "down_w", "topk_gate"),
                          got, want):
        assert g.dtype == (torch.float32 if name.endswith("_w") else tdt)
        _assert_close(name, g, w, dtype)


@pytest.mark.parametrize("capacity", CAPACITIES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_dispatch_backward_matches_jax_vjp(capacity, dtype):
    """dx of the dispatch for a cotangent of the buffers: each token's
    filled slots summed in ascending expert order, bitwise in bf16."""
    rng, x, idx, gate, _ = _inputs(60 + capacity)
    dbuf = rng.standard_normal((B, E, capacity, D)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jax_fn(x):
        return jax.vmap(lambda a, i, g: jops.moe_dispatch(
            a, i, g, E, capacity)[0])(x, idx, jnp.asarray(gate))

    _, vjp = jax.vjp(jax_fn, jnp.asarray(x).astype(jdt))
    (want,) = vjp(jnp.asarray(dbuf).astype(jdt))
    tx = _torch(x, tdt)
    buf, _ = ops.moe_dispatch(tx, torch.from_numpy(idx).long(),
                              torch.from_numpy(gate), E, capacity)
    (got,) = torch.autograd.grad(buf, tx, _torch(dbuf, tdt, grad=False))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np32(got), _np32(want))
    else:
        _assert_close("x", got, want, dtype)


@pytest.mark.parametrize("capacity", CAPACITIES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_combine_backward_matches_jax_vjp(capacity, dtype):
    """dy and the gates' gradient of the combine for a cotangent of its
    output: each filled slot takes its one entry's weighted cotangent,
    bitwise in bf16.  The gates' gradient is a sum over D of y times the
    cotangent (autograd's, not the port's own), which the two packages
    accumulate at different precisions: bf16 within BF16_REL_L2."""
    rng, x, idx, gate, _ = _inputs(70 + capacity)
    y = rng.standard_normal((B, E, capacity, D)).astype(np.float32)
    dout = rng.standard_normal((B, T, D)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jax_row(a, i, g, yr):
        _, meta = jops.moe_dispatch(a, i, g, E, capacity)
        return jops.moe_combine(yr, meta, T)

    def jax_fn(y, g):
        return jax.vmap(jax_row)(jnp.asarray(x).astype(jdt), idx, g, y)

    _, vjp = jax.vjp(jax_fn, jnp.asarray(y).astype(jdt),
                     jnp.asarray(gate).astype(jdt))
    want = vjp(jnp.asarray(dout).astype(jdt))
    ty, tg = _torch(y, tdt), _torch(gate, tdt)
    _, meta = ops.moe_dispatch(_torch(x, tdt, grad=False),
                               torch.from_numpy(idx).long(), tg, E, capacity)
    out = ops.moe_combine(ty, meta)
    got = torch.autograd.grad(out, [ty, tg], _torch(dout, tdt, grad=False))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np32(got[0]), _np32(want[0]))
    else:
        _assert_close("y", got[0], want[0], dtype)
    _assert_close("topk_gate", got[1], want[1], dtype)


def _graph(out):
    """Every node of ``out``'s autograd graph."""
    seen, stack = [], [out.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or any(node is n for n in seen):
            continue
        seen.append(node)
        stack.extend(n for n, _ in node.next_functions)
    return seen


def _moe_out(capacity, gate_grad):
    _, x, idx, gate, weights = _inputs(80 + capacity)
    tx = _torch(x, torch.float32)
    tw = [_torch(w, torch.float32) for w in weights]
    tg = _torch(gate, torch.float32, grad=gate_grad)
    out = ops.moe_apply(tx, *tw, torch.from_numpy(idx).long(), tg, capacity,
                        dtype=torch.float32)
    return out, tx, tw, tg


@pytest.mark.parametrize("capacity", CAPACITIES)
def test_moe_graph_has_no_gather_backward_on_the_rows(capacity):
    """No ``GatherBackward0`` (autograd's scatter-add backward of
    ``gather``) feeds the dispatch's buffers or the combine's y: the two
    row gathers are the port's own backward nodes.  The one
    ``GatherBackward0`` left is the gates' permutation into expert order,
    and it leads to the gates alone."""
    out, tx, _, tg = _moe_out(capacity, gate_grad=False)
    names = [type(n).__name__ for n in _graph(out)]
    assert "GatherBackward0" not in names, names
    assert names.count("MoEDispatchGatherBackward") == 1, names
    assert names.count("MoECombineGatherBackward") == 1, names

    out, tx, _, tg = _moe_out(capacity, gate_grad=True)
    gathers = [n for n in _graph(out)
               if type(n).__name__ == "GatherBackward0"]
    assert len(gathers) == 1
    (leaf,) = [n for n, _ in gathers[0].next_functions if n is not None]
    assert type(leaf).__name__ == "AccumulateGrad" and leaf.variable is tg


class _Ops(TorchDispatchMode):
    """Records every aten op called under it, with its overload's name."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func.overloadpacket)
        if name.startswith("aten.index_put") and (
                kwargs.get("accumulate") or (len(args) > 3 and args[3])):
            name += "(accumulate)"
        self.names.append(name)
        return func(*args, **kwargs)


@pytest.mark.parametrize("capacity", CAPACITIES)
def test_moe_backward_runs_no_scatter_add(capacity):
    """The backward of ``moe_apply`` (the gates given, as the router's
    gradient reaches them through their own permutation) calls no
    ``scatter_add``, ``index_add`` or accumulating ``index_put``, and two
    backwards give the same bits."""
    out, tx, tw, _ = _moe_out(capacity, gate_grad=False)
    cot = torch.from_numpy(np.random.default_rng(capacity).standard_normal(
        tuple(out.shape)).astype(np.float32))
    with _Ops() as mode:
        first = torch.autograd.grad(out, [tx, *tw], cot, retain_graph=True)
    bad = [n for n in mode.names
           if "scatter_add" in n or "index_add" in n or "accumulate" in n]
    assert not bad, bad
    assert "aten.gather" in mode.names
    again = torch.autograd.grad(out, [tx, *tw], cot)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
