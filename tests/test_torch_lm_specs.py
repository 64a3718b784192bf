"""The port's LM sharding specs, held against the JAX package's.

For every architecture of the zoo, smoke and full config, under the four
built-in policies and on four meshes — (4, 2) and (2, 4) ``(data,
model)``, the 16 x 16 production mesh and the 2 x 16 x 16 ``(pod, data,
model)`` one — the port's ``fit_specs(params, model.param_specs(policy),
mesh)`` and ``model.cache_spec(policy)`` (raw, and fitted to a decode
cache's shapes) equal the reference's entry for entry.

No world and no process group: both sides read only a mesh's axis names
and sizes.  The reference runs under ``jax.sharding.use_abstract_mesh`` of
an ``AbstractMesh``, the port under ``set_mesh`` of a stand-in with
``axis_names`` and a ``shape`` mapping.  Parameter shapes are the
reference's ``jax.eval_shape`` of its ``init`` (a full config is never
materialised); for the smoke configs the port's own ``init`` shapes are
fitted too.  A spec entry is compared as ``None``, a mesh axis name, or a
tuple of names (a one-name tuple as its name, as ``PartitionSpec`` and the
port's ``P`` both read it).
"""
import dataclasses
import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro import configs as r_configs
from repro.models import get_model as r_get_model
from repro.sharding.policy import POLICIES as R_POLICIES
from repro.sharding.utils import fit_specs as r_fit_specs
from repro_torch import configs as p_configs
from repro_torch.launch.mesh import set_mesh
from repro_torch.models import cache as C
from repro_torch.models.registry import get_model as p_get_model
from repro_torch.sharding.policy import POLICIES as P_POLICIES
from repro_torch.sharding.policy import P
from repro_torch.sharding.utils import fit_specs as p_fit_specs

ARCHS = r_configs.list_archs()
MESHES = {
    "4x2": ((4, 2), ("data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
CACHE_BATCH, CACHE_SEQ = 32, 64


@dataclasses.dataclass(frozen=True)
class StandInMesh:
    """The reference's ``Mesh`` interface: axis names and a shape mapping."""

    axis_names: tuple
    sizes: tuple

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.sizes))


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return e[0] if len(e) == 1 else e
    return e


def _norm(tree):
    """Spec trees of either package as nested dicts of tuples of entries."""
    if isinstance(tree, (JP, P)):
        return tuple(_entry(e) for e in tree)
    if isinstance(tree, dict):
        return {str(k): _norm(v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return {f.name: _norm(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    if isinstance(tree, (list, tuple)):
        return [_norm(v) for v in tree]
    raise TypeError(type(tree))


def _shapes(tree):
    """The shape tuples of a tree of arrays, tensors or ShapeDtypeStructs."""
    if hasattr(tree, "shape"):
        return tuple(int(s) for s in tree.shape)
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return {f.name: _shapes(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    raise TypeError(type(tree))


def _configs(arch, smoke):
    get_r = r_configs.get_smoke_config if smoke else r_configs.get_config
    get_p = p_configs.get_smoke_config if smoke else p_configs.get_config
    return get_r(arch), get_p(arch)


@functools.lru_cache(maxsize=None)
def _ref_param_shapes(arch, smoke):
    rcfg, _ = _configs(arch, smoke)
    return jax.eval_shape(r_get_model(rcfg).init, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_param_shapes(arch):
    _, pcfg = _configs(arch, True)
    return _shapes(p_get_model(pcfg).init(torch.Generator().manual_seed(0), "cpu"))


def _ref_specs(arch, smoke, policy, mesh_name):
    rcfg, _ = _configs(arch, smoke)
    sizes, names = MESHES[mesh_name]
    mesh = AbstractMesh(sizes, names)
    model = r_get_model(rcfg)
    with jax.sharding.use_abstract_mesh(mesh):
        params = r_fit_specs(_ref_param_shapes(arch, smoke), model.param_specs(R_POLICIES[policy]),
                             mesh)
        cache = model.cache_spec(R_POLICIES[policy])
        shapes = model.cache_shape(CACHE_BATCH, CACHE_SEQ)
        fitted = r_fit_specs(shapes, cache, mesh)
    return _norm(params), _norm(cache), _norm(fitted)


def _port_specs(arch, smoke, policy, mesh_name, param_shapes):
    _, pcfg = _configs(arch, smoke)
    sizes, names = MESHES[mesh_name]
    mesh = StandInMesh(names, sizes)
    model = p_get_model(pcfg)
    with set_mesh(mesh):
        params = p_fit_specs(param_shapes, model.param_specs(P_POLICIES[policy]), mesh)
        cache = model.cache_spec(P_POLICIES[policy])
        shapes = model.cache_shape(CACHE_BATCH, CACHE_SEQ)
        fitted = C.map_cache(lambda t, sp: p_fit_specs(tuple(t.shape), sp, mesh), shapes, cache)
    return _norm(params), _norm(cache), _norm(fitted)


def _jax_shape_tree(tree):
    return jax.tree_util.tree_map(lambda s: tuple(int(d) for d in s.shape), tree)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("policy", list(R_POLICIES))
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_match_reference(arch, smoke, policy, mesh_name):
    want = _ref_specs(arch, smoke, policy, mesh_name)
    ref_shapes = _jax_shape_tree(_ref_param_shapes(arch, smoke))
    got = _port_specs(arch, smoke, policy, mesh_name, ref_shapes)
    assert got[0] == want[0], "fitted param specs"
    assert got[1] == want[1], "cache_spec"
    assert got[2] == want[2], "cache_spec fitted to a decode cache"
    if smoke:
        # The port's own parameter shapes fit to the same specs.
        own = _port_specs(arch, smoke, policy, mesh_name, _port_param_shapes(arch))
        assert own[0] == want[0]


def _kv_spec(cfg, policy, sizes, names):
    with set_mesh(StandInMesh(names, sizes)):
        return tuple(C.kv_cache_spec(cfg, P_POLICIES[policy]).k)


@pytest.mark.parametrize("n_kv,sizes,sharded", [
    (2, (4, 2), "heads"), (2, (2, 4), "seq"), (8, (16, 16), "seq"),
    (16, (16, 16), "heads"), (1, (4, 2), "seq"), (3, (1, 1), "heads"),
])
def test_kv_cache_spec_branches(n_kv, sizes, sharded):
    """Both branches of the mesh-adaptive KV layout, against the reference:
    heads over ``model`` where the KV heads divide it, else the sequence;
    off a mesh (and on a one-way model axis) heads."""
    names = ("data", "model")
    rcfg = dataclasses.replace(r_configs.get_smoke_config("mistral-nemo-12b"), n_kv_heads=n_kv)
    pcfg = dataclasses.replace(p_configs.get_smoke_config("mistral-nemo-12b"), n_kv_heads=n_kv)
    from repro.models.cache import kv_cache_spec as r_kv_cache_spec

    with jax.sharding.use_abstract_mesh(AbstractMesh(sizes, names)):
        want = _norm(r_kv_cache_spec(rcfg, R_POLICIES["tp"]).k)
    got = _norm(P(*_kv_spec(pcfg, "tp", sizes, names)))
    assert got == want
    batch = ("pod", "data")
    assert got == ((None, batch, "model", None, None) if sharded == "seq"
                   else (None, batch, None, "model", None))
    assert _norm(P(*tuple(C.kv_cache_spec(pcfg, P_POLICIES["tp"]).k))) == (
        None, batch, None, "model", None)


@pytest.mark.parametrize("policy", list(R_POLICIES))
def test_spec_moe_mlp_with_and_without_expert(policy):
    """Experts over ``model`` with ``policy.expert``, tensor-parallel inside
    each expert without it; the shared experts tensor-parallel either way."""
    from repro.models.moe import spec_moe_mlp as r_spec
    from repro_torch.models.moe import spec_moe_mlp as p_spec

    rcfg = r_configs.get_config("qwen2-moe-a2.7b")
    pcfg = p_configs.get_config("qwen2-moe-a2.7b")
    got, want = _norm(p_spec(pcfg, P_POLICIES[policy])), _norm(r_spec(rcfg, R_POLICIES[policy]))
    assert got == want
    f = "data" if "fsdp" in policy else None
    if P_POLICIES[policy].expert is not None:
        assert got["w_gu"] == ("model", f, None, None)
    else:
        assert got["w_gu"] == (None, f, None, "model")
    assert got["shared"]["w_down"] == ("model", f)


def test_param_specs_cover_every_leaf():
    """Every parameter leaf of every smoke config has a spec of its rank."""
    for arch in ARCHS:
        _, pcfg = _configs(arch, True)
        model = p_get_model(pcfg)
        shapes = _port_param_shapes(arch)
        specs = model.param_specs(P_POLICIES["fsdp_tp"])

        def walk(s, sp):
            if isinstance(sp, P):
                assert len(sp) == len(s), (arch, s, sp)
                return
            assert set(s) == set(sp), arch
            for k in s:
                walk(s[k], sp[k])

        walk(shapes, specs)
