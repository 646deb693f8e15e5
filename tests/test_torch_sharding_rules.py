"""The port's logical-axis resolver (``repro_torch.runtime.sharding``)
against the JAX package's (``repro.runtime.sharding``): every param,
optimizer-state and cache leaf of the ten configs at CONFIG width on the
production meshes and a (2, 2) one, the reference suite's own cases, and
the specs as ``torch.distributed.tensor`` placements on a (16, 16)
``DeviceMesh`` of the ``"fake"`` backend. Specs must be equal, entry by
entry: the resolver is integer arithmetic on shapes, with no tolerance.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import (DTensor, Replicate, Shard,  # noqa: E402
                                      distribute_tensor)

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.runtime import sharding as jshd  # noqa: E402
from repro.train import abstract_train_state as jabstract_state  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402
from repro_torch.train import (abstract_train_state,  # noqa: E402
                               train_state_axes)

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2": ((2, 2), ("data", "model")),
}
CACHE = (32, 64)        # batch and max_seq of the cache trees


def _leaves(tree, axes, path=""):
    """{path: (shape, axes)} over dicts and NamedTuples of either package;
    None leaves are dropped."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_leaves(tree[k], axes[k], f"{path}/{k}"))
        return out
    if hasattr(tree, "_fields"):
        out = {}
        for f in tree._fields:
            out.update(_leaves(getattr(tree, f), getattr(axes, f),
                               f"{path}/{f}"))
        return out
    return {path: (tuple(tree.shape), tuple(axes))}


def _reference_trees(arch):
    model = jbuild(jget_config(arch))
    state, state_axes = jabstract_state(model)
    caches, cache_axes = model.abstract_cache(*CACHE)
    return {**_leaves(state.params, state_axes.params, "params"),
            **_leaves(state.opt, state_axes.opt, "opt"),
            **_leaves(caches, cache_axes, "cache")}


def _port_trees(model, state, state_axes):
    caches, cache_axes = model.init_cache(*CACHE)
    return {**_leaves(state.params, state_axes.params, "params"),
            **_leaves(state.opt, state_axes.opt, "opt"),
            **_leaves(caches, cache_axes, "cache")}


def _specs(pkg, leaves, mesh, cfg):
    resolver = jshd if pkg == "jax" else shd
    with resolver.use_mesh(mesh, overrides=cfg.sharding_overrides):
        return {p: tuple(resolver.logical_to_spec(ax, shape, mesh,
                                                  fsdp=cfg.fsdp))
                for p, (shape, ax) in leaves.items()}


@pytest.fixture(scope="module")
def reference_specs():
    """The reference's spec of every leaf, per arch and mesh (built once)."""
    out = {}
    for arch in ARCH_IDS:
        leaves, cfg = _reference_trees(arch), jget_config(arch)
        out[arch] = {"leaves": leaves}
        for name, (sizes, names) in MESHES.items():
            out[arch][name] = _specs("jax", leaves,
                                     jshd.abstract_mesh(sizes, names), cfg)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_leaf_resolves_as_the_reference(arch, reference_specs):
    want, cfg = reference_specs[arch], get_config(arch)
    model = Model(cfg, "meta")
    state, state_axes = abstract_train_state(model), train_state_axes(model)
    leaves = _port_trees(model, state, state_axes)
    # the same leaves with the same shapes and axes (the generator state
    # is a PRNG key in one package and a byte tensor in the other: not here)
    assert leaves == want["leaves"]
    assert {p.split("/")[0] for p in leaves} == {"params", "opt", "cache"}
    for name, (sizes, names) in MESHES.items():
        mesh = shd.abstract_mesh(sizes, names)
        got = _specs("torch", leaves, mesh, cfg)
        assert got == want[name], name
        # tree_shardings: the same specs as placements, over the whole state
        with shd.use_mesh(mesh, overrides=cfg.sharding_overrides):
            placed = shd.tree_shardings(state, state_axes, mesh,
                                        fsdp=cfg.fsdp)
        for p, spec in want[name].items():
            if p.startswith("cache"):
                continue
            node = placed
            for k in p.split("/"):
                node = getattr(node, k) if hasattr(node, "_fields") \
                    else node[k]
            assert node == shd.spec_to_placements(spec, mesh), (name, p)


# ---------------------------------------------------------------------------
# the reference suite's cases (tests/test_sharding.py)
# ---------------------------------------------------------------------------
SMALL = {"4x4": ((4, 4), ("data", "model")),
         "pod": ((2, 4, 4), ("pod", "data", "model"))}
CASES = {
    "heads_shard_when_divisible":
        (("embed", "heads", "head_dim"), (64, 8, 16), "4x4", False,
         (None, "model", None)),
    "heads_fall_back_to_embed_when_not_divisible":
        (("embed", "heads", "head_dim"), (64, 9, 16), "4x4", False,
         ("model", None, None)),
    "vocab_not_divisible_replicates":
        (("vocab", "embed"), (122753, 2304), "4x4", False, (None, "model")),
    "batch_uses_pod_and_data":
        (("batch", "seq"), (256, 4096), "pod", False,
         (("pod", "data"), None)),
    "batch_of_one_replicates":
        (("batch", "seq"), (1, 4096), "4x4", False, (None, None)),
    "kv_seq_shards_on_model":
        (("batch", "kv_seq", "kv_heads", "head_dim"), (128, 32768, 10, 128),
         "4x4", False, ("data", "model", None, None)),
    "expert_parallelism":
        (("expert", "embed", "mlp"), (64, 2048, 1408), "4x4", False,
         ("model", None, None)),
    "fsdp_shards_largest_free_dim":
        (("expert", "embed", "mlp"), (16, 8192, 24576), "4x4", True,
         ("model", None, "data")),
    "fsdp_skips_small_params":
        (("embed",), (2048,), "4x4", True, (None,)),
    "no_axis_used_twice":
        (("vocab", "mlp"), (4096, 4096), "4x4", False, ("model", None)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_suite_cases(case):
    axes, shape, mesh, fsdp, expect = CASES[case]
    sizes, names = SMALL[mesh]
    got = shd.logical_to_spec(axes, shape, shd.abstract_mesh(sizes, names),
                              fsdp=fsdp)
    want = jshd.logical_to_spec(axes, shape,
                                jshd.abstract_mesh(sizes, names), fsdp=fsdp)
    assert tuple(got) == tuple(want) == expect
    assert isinstance(got, shd.Spec)


def test_tree_shardings_handles_none_and_scalars():
    mesh = shd.abstract_mesh((4, 4), ("data", "model"))
    tree = {"a": torch.empty((8, 8), device="meta"), "b": None, "s": ()}
    sh = shd.tree_shardings(tree, {"a": ("batch", "embed"), "b": None,
                                   "s": ()}, mesh)
    assert sh["b"] is None
    # 2-D leaf with an "embed" dim gets the TP fallback on top of batch
    assert sh["a"] == (Shard(0), Shard(1))
    assert sh["s"] == (Replicate(), Replicate())
    jsh = jshd.tree_shardings(
        {"a": jax.ShapeDtypeStruct((8, 8), jnp.float32)},
        {"a": ("batch", "embed")}, jshd.abstract_mesh((4, 4),
                                                      ("data", "model")))
    assert sh["a"] == shd.spec_to_placements(tuple(jsh["a"].spec), mesh)


def test_constrain_noop_without_a_mesh_or_on_one_rank():
    x = torch.ones((4, 4))
    assert shd.constrain(x, ("batch", None)) is x
    with shd.use_mesh(tmesh.make_host_mesh("cpu")):
        assert shd.active_mesh().size == 1
        assert shd.constrain(x, ("batch", None)) is x
    assert shd.active_mesh() is None


def test_an_abstract_mesh_has_no_process_group():
    mesh = shd.abstract_mesh((16, 16), ("data", "model"))
    assert mesh.size == 256 and mesh.rank == 0
    with pytest.raises(ValueError, match="abstract"):
        mesh.group


# ---------------------------------------------------------------------------
# placements on a fake-backend (16, 16) DeviceMesh
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fake_256():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        yield tmesh.make_production_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


PLACEMENTS = [
    (("data", "model"), (Shard(0), Shard(1))),
    ((None, "model"), (Replicate(), Shard(1))),
    (("model", None), (Replicate(), Shard(0))),
    ((("data", "model"), None), (Shard(0), Shard(0))),
    ((None, None), (Replicate(), Replicate())),
]


def test_spec_to_placements_on_the_production_mesh(fake_256):
    mesh = fake_256
    assert mesh.shape == {"data": 16, "model": 16}
    assert mesh.device_mesh is not None and mesh.group is dist.group.WORLD
    x = torch.arange(512 * 32, dtype=torch.float32).reshape(512, 32)
    for spec, want in PLACEMENTS:
        got = shd.spec_to_placements(shd.Spec(*spec), mesh)
        assert got == want, spec
        local = distribute_tensor(x, mesh.device_mesh, got).to_local()
        split = [1, 1]
        for entry, dim in zip(spec, (0, 1)):
            split[dim] = 1 if entry is None else (
                16 if isinstance(entry, str) else 256)
        assert tuple(local.shape) == (512 // split[0], 32 // split[1])
    for bad, match in (((("model", "data"), None), "order"),
                       (("pod", None), "not in the mesh"),
                       ((("data", "model"), "model"), "twice")):
        with pytest.raises(ValueError, match=match):
            shd.spec_to_placements(bad, mesh)
    with pytest.raises(ValueError, match="512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")


def test_constrain_redistributes_a_dtensor(fake_256):
    mesh = fake_256
    x = distribute_tensor(torch.zeros((64, 48)), mesh.device_mesh,
                          (Replicate(), Replicate()))
    with shd.use_mesh(mesh):
        y = shd.constrain(x, ("batch", "embed"))
        plain = torch.zeros(3)
        assert shd.constrain(plain, ("batch",)) is plain
    assert isinstance(y, DTensor)
    assert tuple(y.placements) == (Shard(0), Shard(1))
    assert tuple(y.to_local().shape) == (4, 3)


def test_param_shardings_leave_plain_tensors_unchanged():
    """make_train_step(param_shardings=): on plain tensors the step is the
    step without it, bit for bit (REDUCED smollm, f32, CPU)."""
    import dataclasses

    from repro_torch.train import (OptimizerConfig, TrainState,
                                   init_opt_state, make_train_step)
    cfg = dataclasses.replace(get_config("smollm-135m", reduced=True),
                              dtype="float32")
    model = Model(cfg, "cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 17),
                                     generator=torch.Generator()
                                     .manual_seed(1))}
    mesh = shd.abstract_mesh((2, 2), ("data", "model"))
    placements = shd.tree_shardings(*model.abstract_init(), mesh,
                                    fsdp=cfg.fsdp)
    out = []
    for shardings in (None, placements):
        params, _ = model.init(torch.Generator().manual_seed(0))
        state = TrainState(params, init_opt_state(params),
                           torch.Generator().manual_seed(0).get_state())
        out.append(make_train_step(model, OptimizerConfig(), 2,
                                   param_shardings=shardings)(state, batch))
    (a, ma), (b, mb) = out
    assert torch.equal(ma["loss"], mb["loss"])
    assert all(torch.equal(x, y) for x, y in zip(
        tree_leaves(a.params), tree_leaves(b.params)))


def test_dtensor_gradients_go_onto_the_params_placements(fake_256):
    from repro_torch.train import train_step
    mesh = fake_256
    g = distribute_tensor(torch.zeros((64, 48)), mesh.device_mesh,
                          (Replicate(), Replicate()))
    plain = torch.ones(3)
    placed, same = train_step._placed([g, plain],
                                      [(Shard(0), Shard(1)), None])
    assert tuple(placed.placements) == (Shard(0), Shard(1))
    assert same is plain
