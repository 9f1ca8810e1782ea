"""The port's sharding layer against the JAX package's.

``parallel.axes.ShardingRules.spec_for`` (the divisibility and
one-mesh-axis-per-spec rails) equal the reference's on FakeMeshes, with
shapes that the mesh axes divide and shapes they do not;
``placements_for`` turns a spec into one DTensor placement per mesh dim;
the rule tables equal the reference's for four RunConfigs; and every
parameter's, optimizer-state leaf's and decode-cache leaf's logical axes
equal the reference's, tree path by tree path, for every registered arch
at ``reduced``. All exact: these are tables, not numerics.
"""

import itertools

import jax
import pytest
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCHS as J_ARCHS
from repro.configs import RunConfig as JRunConfig
from repro.configs import reduced as j_reduced
from repro.models.common import split_params
from repro.models.transformer import Model as JModel
from repro.optim.optimizers import make_optimizer as j_make_optimizer
from repro.parallel import sharding as jshd
from repro.parallel.axes import ShardingRules as JRules
from repro_torch.configs import ARCHS, RunConfig, reduced
from repro_torch.models.common import flatten_tree
from repro_torch.models.transformer import Model
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.axes import ShardingRules, current_ctx, logical_spec, shard, sharding_ctx

pytestmark = pytest.mark.torch_port


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESHES = [{"data": 2, "model": 4}, {"pod": 2, "data": 16, "model": 16}]
RUN_CFGS = {"default": {}, "fsdp": {"fsdp": True}, "dp_only": {"parallelism": "dp_only"},
            "seq_parallel": {"seq_parallel": True}}
AXES = [("batch", None, "heads", None), ("batch", "seq_tp", "heads_r", None),
        ("batch", "seq_act", "embed_act"), ("layers", "embed", "mlp"),
        ("experts", "embed", None), ("batch", "kv_seq", None, None),
        ("batch", "experts", None, None), ("vocab", "embed"), ("embed", "embed2"),
        ("batch", "inner_heads", None, None), ("heads", "mlp")]
SHAPES = [(32, 4096, 32, 64), (6, 100, 12, 7), (512, 2048, 16, 128), (1, 1, 1, 1)]


def _norm(spec) -> tuple:
    """A spec as a tuple, a one-axis tuple entry as that axis (jax's
    PartitionSpec stores ``("data",)`` as ``"data"``)."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in spec)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def _paths(tree) -> dict:
    """The reference's tree as {"a/0/b": leaf} with axes tuples as leaves."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=_is_axes)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in flat}


@pytest.mark.parametrize("mesh_shape", MESHES, ids=["2x4", "2x16x16"])
@pytest.mark.parametrize("run", list(RUN_CFGS))
def test_rule_tables_equal_the_reference(mesh_shape, run):
    mesh = FakeMesh(mesh_shape)
    port_cfg, ref_cfg = RunConfig(**RUN_CFGS[run]), JRunConfig(**RUN_CFGS[run])
    for name in ("param_rules", "zero1_rules", "activation_rules"):
        assert getattr(shd, name)(mesh, port_cfg) == getattr(jshd, name)(mesh, ref_cfg), name
    assert shd._dp_axes(mesh, port_cfg) == jshd._dp_axes(mesh, ref_cfg)


@pytest.mark.parametrize("mesh_shape", MESHES, ids=["2x4", "2x16x16"])
@pytest.mark.parametrize("run", list(RUN_CFGS))
def test_spec_for_equals_the_reference(mesh_shape, run):
    mesh = FakeMesh(mesh_shape)
    for table in ("param_rules", "zero1_rules", "activation_rules"):
        rules = getattr(shd, table)(mesh, RunConfig(**RUN_CFGS[run]))
        port, ref = ShardingRules(mesh, rules), JRules(mesh, rules)
        for axes, shape in itertools.product(AXES, SHAPES):
            shape = shape[: len(axes)] + (8,) * (len(axes) - len(shape))
            assert _norm(port.spec_for(axes, shape)) == _norm(ref.spec_for(axes, shape)), (
                table, axes, shape)


def test_rails_and_placements():
    mesh = FakeMesh({"data": 2, "model": 4})
    rules = ShardingRules(mesh, {"heads": "model", "batch": ("data",), "a": "model",
                                 "b": "model"})
    assert rules.spec_for(("batch", "heads"), (6, 8)) == (("data",), "model")
    assert rules.spec_for(("batch", "heads"), (8, 6))[1] is None     # 6 % 4: replicated
    assert rules.spec_for(("a", "b"), (8, 8)) == ("model", None)     # model once per spec
    assert rules.placements_for(("batch", "heads"), (6, 8)) == (Shard(0), Shard(1))
    assert rules.placements_for(("heads", "batch"), (6, 8)) == (Shard(1), Replicate())
    pod = ShardingRules(FakeMesh({"pod": 2, "data": 16, "model": 16}),
                        {"batch": ("pod", "data"), "mlp": "model"})
    assert pod.placements_for(("batch", None, "mlp"), (64, 3, 32)) == (
        Shard(0), Shard(0), Shard(2))


def test_shard_is_the_identity_without_a_context_and_for_plain_tensors():
    import torch

    x = torch.ones(4, 8)
    assert current_ctx() is None and shard(x, "batch", "heads") is x
    assert logical_spec(("batch",), (4,)) == ()
    rules = ShardingRules(FakeMesh({"data": 2, "model": 4}), {"batch": "data"})
    with sharding_ctx(rules):
        assert current_ctx() is rules and shard(x, "batch", None) is x
        assert logical_spec(("batch",), (4,)) == ("data",)
    assert current_ctx() is None


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_state_and_cache_axes_equal_the_reference(arch):
    cfg, jcfg = reduced(ARCHS[arch]), j_reduced(J_ARCHS[arch])
    model, jmodel = Model(cfg, device="meta"), JModel(jcfg)
    _, jaxes = split_params(jax.eval_shape(lambda: jmodel.init(0)))
    port_axes = model.param_axes()
    assert port_axes == _paths(jaxes)
    assert set(port_axes) == set(flatten_tree(model.values()))
    for opt, master in itertools.product(("adamw", "adafactor", "sgdm"), (True, False)):
        port = make_optimizer(RunConfig(optimizer=opt, master_fp32=master)).state_axes(port_axes)
        ref = j_make_optimizer(JRunConfig(optimizer=opt, master_fp32=master)).state_axes(jaxes)
        assert flatten_tree(port, is_leaf=_is_axes) == _paths(ref), (opt, master)
    for tp in (None, 4, 16):
        port = model.cache_axes(2, 64, tp=tp)
        ref = jmodel.cache_axes(2, 64, tp=tp)
        assert flatten_tree(port, is_leaf=_is_axes) == _paths(ref), tp
        shapes = flatten_tree([{k: s for k, (s, _) in e.items()} for e in model.cache_specs(2, 64)],
                              is_leaf=lambda x: isinstance(x, tuple))
        assert {k: len(v) for k, v in shapes.items()} == {
            k: len(v) for k, v in flatten_tree(port, is_leaf=_is_axes).items()}
