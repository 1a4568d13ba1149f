"""The sharding rules (`sharding.py`), the models' logical spec trees and the
cells (`launch/cells.py`) against the JAX package, on the CPU.

The rules resolve every logical spec of every arch's reference `init` as
the reference resolves it, on the production meshes 16x16 (data, model) and
2x16x16 (pod, data, model) and on one card (a duck-typed mesh: the
reference reads only `axis_names` and `devices.shape`). Each port model's
spec tree equals its reference `init`'s. For one cell of each builder kind
the port's arguments have the reference cell's shapes and dtypes, and its
model FLOPs agree; the reference cells are built on a one-device mesh,
where they only trace `eval_shape`."""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro import sharding as rsharding  # noqa: E402
from repro.launch import cells as rcells  # noqa: E402
from repro.kernels import compat  # noqa: E402
from repro.models import bert4rec as rbert  # noqa: E402
from repro.models import gnn as rgnn  # noqa: E402
from repro.models import transformer as rtransformer  # noqa: E402
from repro_torch import configs, sharding  # noqa: E402
from repro_torch.configs.base import GNNConfig, LMConfig  # noqa: E402
from repro_torch.launch import abstract, cells  # noqa: E402
from repro_torch.models.bert4rec import Bert4Rec  # noqa: E402
from repro_torch.models.gnn import GNN  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.optim.tree import leaves  # noqa: E402
from torch_train_util import few_torch_threads  # noqa: E402,F401

MESHES = [sharding.SINGLE_POD, sharding.MULTI_POD, sharding.ONE_CARD]


def _duck(mesh):
    return types.SimpleNamespace(axis_names=mesh.axis_names,
                                 devices=np.empty(mesh.shape, dtype=object))


def _spec_leaves(tree):
    if sharding.is_spec_leaf(tree):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [s for v in items for s in _spec_leaves(v)]


def _reference_init(arch):
    """(spec tree, shapes) of the reference's `init` at the smoke config,
    traced with eval_shape (no allocation)."""
    cfg = rconfigs.get_arch(arch).smoke()
    box = {}

    def init(key):
        if isinstance(cfg, rconfigs.base.LMConfig):
            params, specs = rtransformer.init(key, cfg)
        elif isinstance(cfg, rconfigs.base.GNNConfig):
            params, specs = rgnn.init(key, cfg, 8, 3)
        else:
            params, specs = rbert.init(key, cfg)
        box["specs"] = specs
        return params

    shapes = jax.eval_shape(init, jax.random.key(0))
    return box["specs"], shapes


def _port_model(arch):
    cfg = configs.get_arch(arch).smoke()
    if isinstance(cfg, LMConfig):
        return Transformer(cfg, device="meta")
    if isinstance(cfg, GNNConfig):
        return GNN(cfg, 8, 3, device="meta")
    return Bert4Rec(cfg, device="meta")


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_rules_resolve_every_spec_as_the_reference(arch):
    specs, shapes = _reference_init(arch)
    logical = _spec_leaves(specs)
    dims = [tuple(x.shape) for x in jax.tree.leaves(shapes)]
    assert len(logical) == len(dims) > 0
    for mesh in MESHES:
        duck = _duck(mesh)
        for spec, shape in zip(logical, dims):
            assert sharding.logical_to_physical(spec, mesh) == tuple(
                rsharding.logical_to_physical(spec, duck)), (spec, mesh)
            assert sharding.resolve_axis_spec(shape, spec, mesh) == tuple(
                rsharding.resolve_axis_spec(shape, spec, duck)), (spec, shape, mesh)
            # the full-width dims that the rules shard: divisible ones kept
            wide = tuple(4096 * 16 for _ in shape)
            assert sharding.resolve_axis_spec(wide, spec, mesh) == tuple(
                rsharding.resolve_axis_spec(wide, spec, duck))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_model_spec_trees_equal_the_reference_init(arch):
    specs, shapes = _reference_init(arch)
    model = _port_model(arch)
    assert model.param_specs() == specs
    # the meta model holds the reference's shapes in its tree's order
    from repro_torch.train.step import param_tree
    got = [tuple(t.shape) for t in leaves(param_tree(model))]
    assert got == [tuple(x.shape) for x in jax.tree.leaves(shapes)]
    assert all(t.is_meta for t in leaves(param_tree(model)))


def test_one_card_resolves_every_rule_to_none_and_constrain_is_the_identity():
    for name in sharding.DEFAULT_RULES:
        assert sharding.logical_to_physical((name, None), sharding.ONE_CARD) == (None, None)
        assert sharding.resolve_axis_spec((16, 16), (name, name),
                                          sharding.ONE_CARD) == (None, None)
    x = torch.ones(3)
    with sharding.active_mesh(sharding.SINGLE_POD) as mesh:
        assert mesh is sharding.SINGLE_POD
        assert sharding.constrain(x, "batch") is x
    tree = {"w": ("embed", "heads"), "layers": [{"b": (None,)}]}
    assert sharding.tree_shardings(tree, sharding.SINGLE_POD) == {
        "w": ("data", "model"), "layers": [{"b": (None,)}]}


def test_abstract_init_allocates_nothing():
    cfg = configs.get_arch("deepseek-v3-671b").CONFIG

    def init(device):
        m = Transformer(cfg, device=device)
        from repro_torch.train.step import param_tree
        return param_tree(m), m.param_specs()

    tree, specs = abstract.abstract_init(init)
    assert all(t.is_meta for t in leaves(tree))
    assert sum(t.numel() for t in leaves(tree)) > 6e11
    sh = abstract.shardings_for(tree, specs, sharding.SINGLE_POD)
    assert sh["embed"] == ("model", "data")


# one cell of each builder kind: (arch, shape, chips, config overrides)
CELL_KINDS = [
    ("qwen2-1.5b", "train_4k", {}),
    ("qwen3-8b", "prefill_32k", {}),
    ("deepseek-v2-lite-16b", "decode_32k", {}),
    ("pna", "full_graph_sm", {}),
    ("graphsage-reddit", "minibatch_lg", {}),
    ("gat-cora", "minibatch_lg", {}),
    ("pna", "ogb_products", {"distributed": True}),
    ("bert4rec", "train_batch", {}),
    ("bert4rec", "serve_p99", {}),
    ("bert4rec", "retrieval_cand", {}),
]


def _sig(x):
    if isinstance(x, int):  # the port's decode cache keeps its position on the host
        return ((), "int32")
    return (tuple(x.shape), str(x.dtype).split(".")[-1])


def _flat(tree):
    if isinstance(tree, dict):
        return {f"{k}/{p}": v for k, sub in tree.items() for p, v in _flat(sub).items()}
    if isinstance(tree, (list, tuple)):
        return {f"{i}/{p}": v for i, sub in enumerate(tree) for p, v in _flat(sub).items()}
    return {"": tree}


@pytest.mark.parametrize("arch,shape,overrides", CELL_KINDS)
def test_cells_take_the_reference_cells_arguments(arch, shape, overrides):
    """Smoke configs at the shapes of the cell: the same argument tree,
    shapes and dtypes, and the same model FLOPs."""
    smoke = dataclasses.asdict(configs.get_arch(arch).smoke())
    rsmoke = dataclasses.asdict(rconfigs.get_arch(arch).smoke())
    mine = cells.build_cell(arch, shape, cfg_overrides={**smoke, **overrides})
    mesh = compat.make_mesh((1, 1), ("data", "model"), axis_types=("auto", "auto"))
    theirs = rcells.build_cell(arch, shape, mesh,
                               cfg_overrides={**rsmoke, **overrides})
    assert mine.step_kind == theirs.step_kind
    got = {k: _sig(v) for k, v in _flat(mine.args).items()}
    want = {k: (tuple(v.shape), v.dtype.name) for k, v in _flat(theirs.args_sds).items()}
    assert got == want
    assert mine.model_flops_fn() == pytest.approx(theirs.model_flops_fn(), rel=1e-9)
    if mine.mesh == sharding.ONE_CARD:  # no sharding at all on one card
        assert all(a is None for s in _spec_leaves(list(mine.shardings)) for a in s)
