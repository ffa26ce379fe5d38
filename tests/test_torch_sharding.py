"""The port's sharding specs against the JAX package's.

For every arch of the zoo at full width, on the reference's production
meshes (16, 16) and (2, 16, 16) and the test meshes (2, 2) and (4, 2),
the spec of every parameter leaf, batch leaf and decode-cache leaf from
``repro_torch.sharding.specs`` equals the reference's ``param_spec``,
``batch_shardings`` and ``cache_shardings``.  The reference reads only the
mesh's axis names and sizes, so it gets ``jax.sharding.AbstractMesh``es
(no devices); the port gets ``{axis: size}``.  Also: a spec's DTensor
placements, the unit helpers, the mesh builders' refusal of a small
world.
"""

from __future__ import annotations

import jax
import pytest
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.data import pipeline as jdata
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.sharding import specs as jspecs
from repro_torch import intra_op_threads
from repro_torch.configs import get_arch
from repro_torch.configs.shapes import SHAPES
from repro_torch.data import pipeline as tdata
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm
from repro_torch.sharding import specs
from repro_torch.sharding.annotate import profile_for
from repro_torch.tree import leaves_with_path


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The module's CPU work on one intra-op thread: its small products
    would wake every thread, which under the suite's parallel workers
    makes them many times slower (the rule of ``README.md``'s "Tests on
    the CPU")."""
    with intra_op_threads(1):
        yield


MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (2, 2): ("data", "model"), (4, 2): ("data", "model")}
ARCH_IDS = sorted(J_ARCHS)


def _norm(spec) -> tuple:
    """A spec as ``PartitionSpec`` keeps it: a one-axis tuple is the axis."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _meshes(shape):
    names = MESHES[shape]
    return AbstractMesh(shape, names), dict(zip(names, shape))


@pytest.fixture(scope="module")
def ref_params():
    """The reference's parameter structs (``eval_shape``: nothing is
    allocated), by path, per arch."""
    out = {}
    for arch in ARCH_IDS:
        struct = jax.eval_shape(
            lambda a=arch: jlm.init(J_ARCHS[a], jax.random.PRNGKey(0)))
        out[arch] = {jspecs._path_str(p): tuple(leaf.shape) for p, leaf in
                     jax.tree_util.tree_flatten_with_path(struct)[0]}
    return out


@pytest.mark.parametrize("mesh_shape", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(ref_params, arch, mesh_shape):
    jmesh, sizes = _meshes(mesh_shape)
    shapes = {p: s for p, (s, _) in lm.param_shapes(get_arch(arch)).items()}
    assert shapes == ref_params[arch]
    for path, shape in shapes.items():
        want = tuple(jspecs.param_spec(path.split("/"), shape, jmesh))
        got = _norm(specs.param_spec(path, shape, sizes))
        assert got == want, (arch, path, shape)


@pytest.mark.parametrize("mesh_shape", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_equal_the_reference(arch, mesh_shape):
    jmesh, sizes = _meshes(mesh_shape)
    jcfg, cfg = J_ARCHS[arch], get_arch(arch)
    for name, shape in SHAPES.items():
        jstruct = jdata.batch_spec(jcfg, J_SHAPES[name])
        want = jspecs.batch_shardings(jstruct, jmesh, jcfg,
                                      profile_for(cfg))
        tstruct = tdata.batch_spec(cfg, shape)
        assert sorted(tstruct) == sorted(jstruct)
        for key, (tshape, _) in tstruct.items():
            assert tshape == tuple(jstruct[key].shape)
            got = _norm(specs.batch_spec(tshape, sizes, cfg,
                                         profile_for(cfg)))
            assert got == tuple(want[key].spec), (arch, name, key)


@pytest.fixture(scope="module")
def ref_caches():
    """The reference's decode caches at decode_32k (``eval_shape`` of its
    prefill), by path, per arch."""
    out = {}
    for arch in ARCH_IDS:
        bundle = jsteps.build_decode_step(J_ARCHS[arch],
                                          J_SHAPES["decode_32k"])
        out[arch] = {jspecs._path_str(p): leaf for p, leaf in
                     jax.tree_util.tree_flatten_with_path(
                         bundle.arg_specs[2])[0]}
    return out


@pytest.mark.parametrize("mesh_shape", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_reference(ref_caches, arch, mesh_shape):
    jmesh, sizes = _meshes(mesh_shape)
    cfg, shape = get_arch(arch), SHAPES["decode_32k"]
    ref = ref_caches[arch]
    want = jspecs.cache_shardings(
        {"c": {k: v for k, v in ref.items()}}, jmesh, J_ARCHS[arch])["c"]
    struct = dict(leaves_with_path(tsteps.cache_struct(
        cfg, shape.global_batch, shape.seq_len)))
    assert sorted(struct) == sorted(ref)
    for path, s in struct.items():
        assert s.shape == tuple(ref[path].shape), path
        got = _norm(specs.cache_spec(path, s.shape, sizes))
        assert got == tuple(want[path].spec), (arch, path)


def test_placements_put_each_axis_on_its_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

    got = specs.placements(((("pod", "data")), None, "model"), Mesh())
    assert got == [Shard(0), Shard(0), Shard(2)]
    assert specs.placements((None, None), Mesh()) == [Replicate()] * 3


def test_unit_helpers_drop_the_stacked_axis():
    cfg = get_arch("yi-6b")
    shapes = {p: s for p, (s, _) in lm.param_shapes(cfg).items()}
    sizes = {"data": 16, "model": 16}
    by_path = {p: specs.param_spec(p, s, sizes) for p, s in shapes.items()}
    unit = specs.unit_shardings(by_path, "stage0")
    struct = specs.unit_struct(shapes, "stage0")
    assert sorted(unit) == sorted(struct)
    assert unit["u0/mixer/wq"] == by_path["stage0/u0/mixer/wq"][1:]
    assert struct["u0/mixer/wq"] == shapes["stage0/u0/mixer/wq"][1:]


def test_production_mesh_refuses_a_small_world():
    from repro_torch.launch import mesh

    with pytest.raises(RuntimeError, match="need 256 ranks"):
        mesh.make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="need 512 ranks"):
        mesh.make_production_mesh(multi_pod=True, device_type="cpu")
