"""The port's logical-axis rules, held against the JAX package's
(``repro.distributed.sharding``): the resolution cases of
``tests/test_sharding_analysis.py``, a property over random logical
tuples, dims and meshes, the placements DTensor takes, and the param and
cache introspection (``shape_tree``, ``spec_tree``, ``count_params``,
``cache_axes``) and shape cells the distribution stands on."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("hypothesis", reason="the rule property needs hypothesis")

from hypothesis import given, settings, strategies as st  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_full  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.configs import shapes_for as ref_shapes_for  # noqa: E402
from repro.distributed import sharding as ref  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro_torch.configs import SHAPES, SUBQUADRATIC, get_config, get_smoke_config, \
    list_archs, shapes_for  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.sharding import (DEFAULT_RULES, PartitionSpec,  # noqa: E402
                                              axis_rules, logical_to_pspec,
                                              make_abstract_mesh, shard_as,
                                              spec_tree_to_shardings, to_placements,
                                              use_mesh)
from repro_torch.models import build_model, shape_tree, spec_tree  # noqa: E402
from repro_torch.models.common import cache_axes, count_params, flatten  # noqa: E402

MESH_1POD = make_abstract_mesh((16, 16), ("data", "model"))
MESH_2POD = make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
REF_1POD = ref.make_abstract_mesh((16, 16), ("data", "model"))
REF_2POD = ref.make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))


def _both(logical, shape, multi_pod, rules=DEFAULT_RULES):
    port = logical_to_pspec(logical, shape, MESH_2POD if multi_pod else MESH_1POD, rules)
    want = ref.logical_to_pspec(logical, shape, REF_2POD if multi_pod else REF_1POD, rules)
    assert isinstance(port, PartitionSpec) and tuple(port) == tuple(want)
    return port


def test_basic_resolution():
    spec = _both(("batch", None, "ffn"), (256, 128, 4096), False)
    assert tuple(spec) == tuple(P("data", None, "model"))


def test_multi_pod_batch_spans_pod_and_data():
    spec = _both(("batch", None), (256, 128), True)
    assert tuple(spec) == tuple(P(("pod", "data"), None))


def test_divisibility_guard_replicates():
    # 4 heads cannot shard over 16-way model axis
    spec = _both(("batch", "heads", None, None), (32, 4, 128, 64), False)
    assert tuple(spec) == tuple(P("data", None, None, None))


def test_divisibility_guard_drops_pod_prefix():
    # batch 16 divides data(16) but not pod*data(32): guard drops "pod"
    spec = _both(("batch",), (16,), True)
    assert tuple(spec) == tuple(P("data"))


def test_axis_used_once_per_tensor():
    rules = dict(DEFAULT_RULES)
    rules["embed"] = ("data",)
    spec = _both(("batch", "seq", "embed"), (256, 128, 4096), False, rules)
    # batch claims "data"; embed must fall back to replication
    assert tuple(spec) == tuple(P("data", None, None))


def test_batch_one_replicates():
    spec = _both(("batch", "kv_heads", "kv_seq", None), (1, 32, 524288, 112), False,
                 {**DEFAULT_RULES, "kv_seq": ("data",)})
    assert tuple(spec) == tuple(P(None, "model", "data", None))


MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (1, 1): ("data", "model"), (4, 2): ("data", "model")}
NAMES = sorted(DEFAULT_RULES) + [None, "unknown"]
DIMS = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 100, 128, 256, 512, 4096]


@settings(max_examples=150, deadline=None)
@given(mesh=st.sampled_from(sorted(MESHES)),
       logical=st.lists(st.sampled_from(NAMES), min_size=1, max_size=5),
       data=st.data(), fsdp_embed=st.booleans(), no_shape=st.booleans())
def test_logical_to_pspec_matches_reference(mesh, logical, data, fsdp_embed, no_shape):
    shape = None if no_shape else tuple(
        data.draw(st.sampled_from(DIMS)) for _ in logical)
    rules = {**DEFAULT_RULES, "embed": ("data",)} if fsdp_embed else DEFAULT_RULES
    port = logical_to_pspec(tuple(logical), shape, make_abstract_mesh(mesh, MESHES[mesh]),
                            rules)
    want = ref.logical_to_pspec(tuple(logical), shape,
                                ref.make_abstract_mesh(mesh, MESHES[mesh]), rules)
    assert tuple(port) == tuple(want)


def test_no_mesh_and_no_rules_resolve_to_replication():
    assert tuple(logical_to_pspec(("batch", "heads"), (8, 8))) == (None, None)
    with use_mesh(MESH_1POD):
        assert tuple(logical_to_pspec(("batch", "heads"), (32, 32))) == ("data", "model")
    x = torch.ones(32, 32)
    with axis_rules(DEFAULT_RULES), use_mesh(MESH_1POD):
        assert shard_as(x, "batch", "heads") is x         # a plain tensor: no-op
    assert sharding.current_rules() is None and sharding._active_mesh() is None


def test_use_mesh_puts_torch_implicit_replication_back():
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    flag = lambda: DTensor._op_dispatcher._allow_implicit_replication  # noqa: E731
    assert not flag()
    with use_mesh(MESH_1POD):
        assert flag()
        with use_mesh(MESH_2POD):
            assert flag() and sharding._active_mesh() is MESH_2POD
        assert flag() and sharding._active_mesh() is MESH_1POD
    assert not flag()
    with implicit_replication():
        with use_mesh(MESH_1POD):
            pass
        assert flag()                   # the caller's own context outlives use_mesh
    assert not flag()


def test_to_placements_in_mesh_order():
    spec = logical_to_pspec(("batch", None, "ffn"), (256, 8, 4096), MESH_2POD)
    assert tuple(spec) == (("pod", "data"), None, "model")
    assert to_placements(spec, MESH_2POD) == (Shard(0), Shard(0), Shard(2))
    assert to_placements(PartitionSpec(None, "data"), MESH_1POD) == (Shard(1), Replicate())
    assert to_placements(PartitionSpec("model", None), MESH_1POD) == (Replicate(), Shard(0))
    assert to_placements(PartitionSpec(None, None), MESH_1POD) == (Replicate(), Replicate())


@pytest.mark.parametrize("arch", list_archs())
def test_param_trees_match_the_reference_without_allocating(arch):
    """spec_tree, count_params and shape_tree of each full config equal
    the reference's; shape_tree's leaves live on ``meta``, and the
    placements on a (16, 16) mesh are the reference pspecs'."""
    defs, rdefs = build_model(get_config(arch)).param_defs(), ref_build(
        ref_full(arch)).param_defs()
    assert count_params(defs) == ref_common.count_params(rdefs)
    assert get_config(arch).n_param_estimate == ref_full(arch).n_param_estimate == 0
    rspecs = {"/".join(str(k.key) for k in p): v for p, v in jax.tree_util.tree_flatten_with_path(
        ref_common.spec_tree(rdefs), is_leaf=lambda x: isinstance(x, tuple))[0]}
    rshapes = {"/".join(str(k.key) for k in p): v for p, v in
               jax.tree_util.tree_flatten_with_path(
                   ref_common.shape_tree(rdefs, ref_full(arch).pdtype()))[0]}
    specs = {"/".join(p): v for p, v in flatten(spec_tree(defs))}
    shapes = {"/".join(p): v for p, v in flatten(shape_tree(defs, get_config(arch).pdtype()))}
    assert specs == rspecs
    assert {k: (tuple(t.shape), str(t.dtype).removeprefix("torch.")) for k, t in
            shapes.items()} == {k: (tuple(s.shape), str(s.dtype)) for k, s in rshapes.items()}
    assert all(t.device.type == "meta" for t in shapes.values())
    places = {"/".join(p): v for p, v in flatten(
        spec_tree_to_shardings(spec_tree(defs), shape_tree(defs), MESH_1POD))}
    for k, spec in specs.items():
        want = ref.logical_to_pspec(spec, rshapes[k].shape, REF_1POD, ref.DEFAULT_RULES)
        assert places[k] == to_placements(PartitionSpec(*want), MESH_1POD), k


@pytest.mark.parametrize("arch", list_archs())
def test_cache_axes_match_the_reference(arch):
    pm = build_model(get_smoke_config(arch))
    jm = ref_build(ref_smoke(arch))
    got, want = cache_axes(pm.cache_specs()), ref_common.cache_axes(jm.cache_specs())
    for g, w in zip(got, want):
        assert jax.tree_util.tree_leaves(g) == jax.tree_util.tree_leaves(w)
        assert jax.tree_util.tree_structure(g) == jax.tree_util.tree_structure(w)


def test_shape_cells_match_the_reference():
    assert {k: vars(v) for k, v in SHAPES.items()} == {
        k: vars(v) for k, v in REF_SHAPES.items()}
    from repro.configs import SUBQUADRATIC as REF_SUB
    assert SUBQUADRATIC == REF_SUB
    for arch in list_archs():
        assert [vars(c) for c in shapes_for(arch)] == [vars(c) for c in ref_shapes_for(arch)]


def test_cast_tree_casts_floating_leaves_only():
    from repro_torch.models.common import cast_tree
    tree = {"w": torch.ones(2, dtype=torch.float32), "n": {"i": torch.ones(2, dtype=torch.int32)}}
    out = cast_tree(tree, "bfloat16")
    assert out["w"].dtype == torch.bfloat16 and out["n"]["i"].dtype == torch.int32
    np.testing.assert_array_equal(out["w"].float().numpy(), np.ones(2))
