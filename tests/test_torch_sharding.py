"""The port's sharding rules (``repro_torch.launch.sharding``) against the
reference's (``repro.launch.sharding``) on the CPU.

The reference's rules run on ``jax.sharding.AbstractMesh`` (the
production meshes without devices) and the port's on
``mesh.make_production_mesh``'s descriptor; the one-shard smoke mesh is
the reference's ``make_smoke_mesh`` against the port's ``DataMesh(1)``.
Spec trees are compared by path (dict keys and list indices joined with
'/'), never by leaf order. ``repro.launch.dryrun`` is never imported: it
sets ``XLA_FLAGS`` for 512 host devices when imported. Its
``_tree_bytes_per_device`` is restated here (``_ref_tree_bytes``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as RefNamedSharding
from jax.sharding import PartitionSpec as RefP

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import sharding as RSH
from repro.launch.mesh import make_smoke_mesh as ref_smoke_mesh
from repro.models import model as RM
from repro.train.optim import abstract_opt_state as ref_abstract_opt_state
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh
from repro_torch.models import model as M
from repro_torch.train.optim import abstract_opt_state

MESHES = ("smoke", "16x16", "2x16x16")


def _meshes(name):
    """(reference mesh, port mesh) of one of ``MESHES``."""
    if name == "smoke":
        return ref_smoke_mesh(), make_smoke_mesh("cpu")
    multi = name == "2x16x16"
    ref = (AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi
           else AbstractMesh((16, 16), ("data", "model")))
    return ref, make_production_mesh(multi_pod=multi)


def _ref_by_path(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(str(k.key if hasattr(k, "key") else k.idx) for k in path): leaf
            for path, leaf in flat}


def _ref_specs(tree):
    return {k: tuple(s) for k, s in _ref_by_path(tree, lambda x: isinstance(x, RefP)).items()}


def _port_specs(tree):
    return {k: tuple(s) for k, s in M.tree_leaves_with_path(tree)}


def _ref_tree_bytes(abstract, specs, mesh):
    """The reference's ``dryrun._tree_bytes_per_device``."""
    total = 0.0
    flat_a = jax.tree.leaves(abstract)
    flat_s = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, RefP))
    for a, s in zip(flat_a, flat_s):
        shards = 1
        for ax in s:
            if ax is None:
                continue
            for name in ax if isinstance(ax, tuple) else (ax,):
                shards *= mesh.shape[name]
        total += a.size * a.dtype.itemsize / shards
    return total


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return RM.abstract_params(ref_get_config(arch), jnp.bfloat16)


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return M.abstract_params(get_config(arch))


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, mesh_name):
    ref_mesh, mesh = _meshes(mesh_name)
    want = _ref_specs(RSH.param_specs(ref_get_config(arch), ref_mesh, _ref_params(arch)))
    got = _port_specs(SH.param_specs(get_config(arch), mesh, _port_params(arch)))
    assert got == want
    # the reference's own structural test: a spec per leaf, no longer than it
    for key, leaf in M.tree_leaves_with_path(_port_params(arch)):
        assert len(got[key]) <= leaf.dim()


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ["stablelm-3b", "dbrx-132b", "rwkv6-7b"])
def test_opt_specs_match_reference(arch, mesh_name):
    ref_mesh, mesh = _meshes(mesh_name)
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    rps = RSH.param_specs(rcfg, ref_mesh, _ref_params(arch))
    ro = ref_abstract_opt_state(_ref_params(arch), rcfg.optimizer)
    want = _ref_specs(RSH.opt_specs(rcfg, ref_mesh, ro, rps))
    ps = SH.param_specs(cfg, mesh, _port_params(arch))
    ao = abstract_opt_state(_port_params(arch), cfg.optimizer)
    got = _port_specs(SH.opt_specs(cfg, mesh, ao, ps))
    assert got == want
    assert got["step"] == ()
    assert set(k.split("/")[0] for k in got) == (
        {"step", "m", "v", "master"} if cfg.optimizer == "adamw" else {"step", "m", "v"})


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ["stablelm-3b", "pixtral-12b", "seamless-m4t-large-v2"])
def test_batch_specs_match_reference(arch, mesh_name):
    ref_mesh, mesh = _meshes(mesh_name)
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        want = _ref_specs(RSH.batch_specs(ref_mesh, RM.input_specs(ref_get_config(arch),
                                                                   REF_SHAPES[shape])))
        got = _port_specs(SH.batch_specs(mesh, M.input_specs(get_config(arch), SHAPES[shape])))
        assert got == want, shape


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference(arch, mesh_name):
    ref_mesh, mesh = _meshes(mesh_name)
    for shape in ("decode_32k", "long_500k"):
        B, S = SHAPES[shape]["global_batch"], SHAPES[shape]["seq_len"]
        want = _ref_specs(RSH.cache_specs(ref_get_config(arch), ref_mesh,
                                          RM.abstract_cache(ref_get_config(arch), B, S)))
        got = _port_specs(SH.cache_specs(get_config(arch), mesh,
                                         M.abstract_cache(get_config(arch), B, S)))
        assert got == want, shape


@pytest.mark.parametrize("mesh_name", MESHES)
def test_act_spec_matches_reference(mesh_name):
    ref_mesh, mesh = _meshes(mesh_name)
    for arch in ARCH_IDS:
        for seq in (1, 100, 4096, 32768):
            want = RSH.act_spec(ref_get_config(arch), ref_mesh, seq)
            got = SH.act_spec(get_config(arch), mesh, seq)
            assert (got is None) == (want is None)
            if want is not None:
                assert tuple(got) == tuple(want), (arch, seq)


def test_shard_shape_matches_reference():
    for mesh_name in ("16x16", "2x16x16"):
        ref_mesh, mesh = _meshes(mesh_name)
        for arch in ("stablelm-3b", "dbrx-132b", "recurrentgemma-9b"):
            rs = _ref_specs(RSH.param_specs(ref_get_config(arch), ref_mesh, _ref_params(arch)))
            shardings = SH.to_shardings(mesh, SH.param_specs(get_config(arch), mesh,
                                                             _port_params(arch)))
            for key, leaf in M.tree_leaves_with_path(_port_params(arch)):
                want = RefNamedSharding(ref_mesh, RefP(*rs[key])).shard_shape(tuple(leaf.shape))
                sh = dict(M.tree_leaves_with_path(shardings))[key]
                assert isinstance(sh, SH.NamedSharding)
                assert sh.shard_shape(tuple(leaf.shape)) == tuple(want), key
    mesh = make_production_mesh()
    with pytest.raises(ValueError, match="does not divide"):
        SH.NamedSharding(mesh, SH.P("model")).shard_shape((24, 8))
    assert SH.NamedSharding(mesh, SH.P(("data", "model"))).shard_shape((512, 3)) == (2, 3)


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_bytes_per_device_match_reference(arch, mesh_name):
    """The dry run's ``analytic_bytes_per_device`` terms: parameters,
    optimizer state and batch (train), the cache (decode), each equal to
    the reference's formula over the reference's trees and specs."""
    ref_mesh, mesh = _meshes(mesh_name)
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    rp, p = _ref_params(arch), _port_params(arch)
    rps, ps = RSH.param_specs(rcfg, ref_mesh, rp), SH.param_specs(cfg, mesh, p)
    assert D.tree_bytes_per_device(p, ps, mesh) == _ref_tree_bytes(rp, rps, ref_mesh)
    if arch in ("stablelm-3b", "dbrx-132b", "rwkv6-7b"):
        ro = ref_abstract_opt_state(rp, rcfg.optimizer)
        ao = abstract_opt_state(p, cfg.optimizer)
        assert D.tree_bytes_per_device(ao, SH.opt_specs(cfg, mesh, ao, ps), mesh) == (
            _ref_tree_bytes(ro, RSH.opt_specs(rcfg, ref_mesh, ro, rps), ref_mesh))
    rb = RM.input_specs(rcfg, REF_SHAPES["train_4k"])
    b = M.input_specs(cfg, SHAPES["train_4k"])
    assert D.tree_bytes_per_device(b, SH.batch_specs(mesh, b), mesh) == (
        _ref_tree_bytes(rb, RSH.batch_specs(ref_mesh, rb), ref_mesh))
    B, S = SHAPES["decode_32k"]["global_batch"], SHAPES["decode_32k"]["seq_len"]
    rc, c = RM.abstract_cache(rcfg, B, S), M.abstract_cache(cfg, B, S)
    got = D.tree_bytes_per_device(c, SH.cache_specs(cfg, mesh, c), mesh)
    assert got == _ref_tree_bytes(rc, RSH.cache_specs(rcfg, ref_mesh, rc), ref_mesh)
    assert np.isfinite(got) and got > 0
