"""The production mesh's metadata (``repro_torch.distributed.sharding``,
the abstract specs of ``launch/specs.py``, ``models.params`` and
``models.model``) against the JAX package, exactly, on one CPU.

The JAX side runs over ``jax.sharding.AbstractMesh``es, which need no
devices; the port's over its own ``AbstractMesh``.  For each of the ten
assigned architectures at full size every leaf's placement tuple equals
``tuple(PartitionSpec)`` on the 16 x 16 and 2 x 16 x 16 production
meshes under both rule tables (the MoE archs under both dispatch
layouts), ``sharding_report`` equals the JAX dict, the batch and cache
placements agree for every applicable input shape, and the abstract
specs agree by shape, dtype and axes.
"""

import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JR  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.launch import specs as TSP  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402

from test_torch_helpers import one_torch_thread  # noqa: E402,F401

ARCHS = JR.list_archs(assigned_only=True)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
RULES = {"default": (JS.DEFAULT_RULES, S.DEFAULT_RULES),
         "tp_only": (JS.TP_ONLY_RULES, S.TP_ONLY_RULES)}
# the MoE archs under both dispatch layouts (mixtral's default is "auto",
# deepseek's and jamba's "unconstrained")
LAYOUTS = [(a, None) for a in ARCHS] + [
    (a, lay) for a in ("mixtral-8x7b", "deepseek-v3-671b")
    for lay in ("auto", "ep_full")]


def meshes(name):
    shape, names = MESHES[name]
    return jax.sharding.AbstractMesh(shape, names), S.AbstractMesh(shape,
                                                                   names)


def configs(arch, layout=None):
    jcfg, tcfg = JR.get_config(arch), TR.get_config(arch)
    if layout is not None:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, layout=layout))
        tcfg = dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, layout=layout))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def jax_specs(tree):
    """keystr path -> tuple(PartitionSpec) of a NamedSharding tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
    return {jax.tree_util.keystr(p): tuple(s.spec) for p, s in leaves}


def dtype_name(x):
    return str(x.dtype).removeprefix("torch.")


def applicable(arch):
    return [s for s in JR.INPUT_SHAPES if JR.shape_applicable(arch, s)]


# --------------------------------------------------------------------------- #
# Rule tables
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch,layout", LAYOUTS,
                         ids=[f"{a}-{l}" if l else a for a, l in LAYOUTS])
def test_param_shardings_equal_jax(arch, layout, mesh, rules):
    jcfg, tcfg = configs(arch, layout)
    jmesh, tmesh = meshes(mesh)
    jrules, trules = RULES[rules]
    ref = jax_specs(JS.param_shardings(jcfg, jmesh, jrules))
    got = dict(bridge.flatten(S.param_shardings(tcfg, tmesh, trules)))
    assert got == ref


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharding_report_equals_jax(arch, mesh, rules):
    jcfg, tcfg = configs(arch)
    jmesh, tmesh = meshes(mesh)
    jrules, trules = RULES[rules]
    assert S.sharding_report(tcfg, tmesh, trules) == \
        JS.sharding_report(jcfg, jmesh, jrules)


def test_report_of_full_qwen2_7b():
    """The number the production table gives a 16 x 16 device."""
    rep = S.sharding_report(TR.get_config("qwen2-7b"),
                            S.AbstractMesh((16, 16), ("data", "model")))
    assert rep["param_bytes_per_device"] == 156_115_904


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_shardings_equal_jax(arch, mesh):
    jcfg, tcfg = configs(arch)
    jmesh, tmesh = meshes(mesh)
    for shape in applicable(arch):
        jspecs = JSP.input_specs(jcfg, JR.input_shape(shape))
        tspecs = TSP.input_specs(tcfg, TR.input_shape(shape))
        ref = {k: tuple(v.spec)
               for k, v in JS.batch_shardings(jmesh, jspecs).items()}
        assert S.batch_shardings(tmesh, tspecs) == ref, shape
        assert S.batch_spec(tmesh, TR.input_shape(shape).global_batch) == \
            tuple(JS.batch_spec(jmesh, JR.input_shape(shape).global_batch))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_equal_jax(arch, mesh):
    jcfg, tcfg = configs(arch)
    jmesh, tmesh = meshes(mesh)
    for shape in ("decode_32k", "long_500k"):
        if not JR.shape_applicable(arch, shape):
            continue
        ish = JR.input_shape(shape)
        jcache = JM.abstract_cache(jcfg, ish.global_batch,
                                   JSP.cache_len(jcfg, ish))
        tcache = TM.abstract_cache(tcfg, ish.global_batch,
                                   TSP.cache_len(tcfg, TR.input_shape(shape)))
        ref = jax_specs(JS.cache_shardings(jcfg, jmesh, jcache,
                                           ish.global_batch))
        got = dict(bridge.flatten(S.cache_shardings(tcfg, tmesh, tcache,
                                                    ish.global_batch)))
        assert got == ref, shape


def test_replicated_is_the_empty_spec():
    jmesh, tmesh = meshes("16x16")
    assert S.replicated(tmesh) == tuple(JS.replicated(jmesh).spec) == ()


@pytest.mark.parametrize("shape,dims", [((8, 12, 5), ("a", "b", None)),
                                        ((12, 7), ("b", "a"))])
def test_spec_for_axes_first_fit_and_divisibility(shape, dims):
    """Hand-made tables: a mesh axis used once, the first dim wins, and a
    dim the extent does not divide stays whole."""
    rules = {"a": ("data", "model"), "b": ("model",)}
    jmesh, tmesh = meshes("16x16")
    small_j = jax.sharding.AbstractMesh((2, 4), ("data", "model"))
    small_t = S.AbstractMesh((2, 4), ("data", "model"))
    for jm, tm in ((jmesh, tmesh), (small_j, small_t)):
        assert S.spec_for_axes(dims, shape, tm, rules) == \
            tuple(JS.spec_for_axes(dims, shape, jm, rules))


# --------------------------------------------------------------------------- #
# Abstract specs
# --------------------------------------------------------------------------- #

def _shapes_dtypes(tree):
    return {k: (tuple(v.shape), dtype_name(v))
            for k, v in bridge.flatten(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_specs_equal_jax(arch):
    jcfg, tcfg = configs(arch)
    axes = dict(bridge.flatten(TP.param_axes(tcfg)))
    jaxes = jax.tree_util.tree_flatten_with_path(
        JP.param_axes(jcfg), is_leaf=lambda x: isinstance(x, tuple))[0]
    assert axes == {jax.tree_util.keystr(p): a for p, a in jaxes}
    tparams = TP.abstract_params(tcfg)
    assert all(v.device.type == "meta" for v in TP.tree_leaves(tparams))
    ref = {k: (tuple(v.shape), v.dtype.name) for k, v in bridge.flatten(
        JP.abstract_params(jcfg))}
    assert _shapes_dtypes(tparams) == ref
    for shape in applicable(arch):
        jsh, tsh = JR.input_shape(shape), TR.input_shape(shape)
        assert dataclasses.asdict(jsh) == dataclasses.asdict(tsh)
        for jf, tf in ((JSP.input_specs, TSP.input_specs),
                       (JSP.decode_specs, TSP.decode_specs)):
            ref = {k: (tuple(v.shape), v.dtype.name)
                   for k, v in bridge.flatten(jf(jcfg, jsh))}
            got = tf(tcfg, tsh)
            assert all(v.device.type == "meta" for v in got.values())
            assert _shapes_dtypes(got) == ref, (shape, jf.__name__)
        assert TSP.cache_len(tcfg, tsh) == JSP.cache_len(jcfg, jsh)
    ish = JR.input_shape("decode_32k")
    batch, T = 2, JSP.cache_len(jcfg, ish)        # the layout, at batch 2
    ref = {k: (tuple(v.shape), v.dtype.name) for k, v in bridge.flatten(
        JM.abstract_cache(jcfg, batch, T))}
    tcache = TM.abstract_cache(tcfg, batch, T)
    assert all(v.device.type == "meta" for v in TP.tree_leaves(tcache))
    assert _shapes_dtypes(tcache) == ref


def test_registry_shapes_equal_jax():
    assert sorted(TR.list_archs(assigned_only=True)) == sorted(ARCHS)
    assert TR.list_archs() == JR.list_archs()
    assert TR.LONG_CONTEXT_OK == JR.LONG_CONTEXT_OK
    assert {k: dataclasses.asdict(v) for k, v in TR.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in JR.INPUT_SHAPES.items()}
    for arch in JR.list_archs():
        for shape in JR.INPUT_SHAPES:
            assert TR.shape_applicable(arch, shape) == \
                JR.shape_applicable(arch, shape)


# --------------------------------------------------------------------------- #
# Placement tuples -> DTensor placements
# --------------------------------------------------------------------------- #

def test_placements_shard_each_named_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert S.placements(("data", None, "model"), mesh) == \
        [Replicate(), Shard(0), Shard(2)]
    assert S.placements((("pod", "data"), "model"), mesh) == \
        [Shard(0), Shard(0), Shard(1)]
    assert S.placements((None, None), mesh) == [Replicate()] * 3
    assert S.placements((), mesh) == [Replicate()] * 3


def test_mesh_shape_reads_both_kinds_of_mesh():
    dev = SimpleNamespace(mesh_dim_names=("data", "model"),
                          size=lambda i: (2, 3)[i])
    assert dict(S.mesh_shape(dev)) == {"data": 2, "model": 3}
    am = S.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert am.shape == {"pod": 2, "data": 16, "model": 16}
    with pytest.raises(ValueError):
        S.AbstractMesh((2, 16), ("pod", "data", "model"))
    np.testing.assert_equal(list(am.shape), ["pod", "data", "model"])
