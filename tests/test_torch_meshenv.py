"""``MeshEnvironment`` and ``EGIEnvironment`` of the port
(``repro_torch.core.environment``) against the JAX package's on the CPU:
an ants ``TorchTask`` explored over a one-rank host mesh gives, context by
context, the outputs of the port's ``LocalEnvironment`` and of the
reference's ``MeshEnvironment(make_host_mesh())`` (the reference's Gumbel
draws replayed into the port's task); over two gloo ranks each rank runs
its block and returns every context's outputs. The production meshes are
built on the ``"fake"`` backend. Objectives are integer ticks: equal, no
tolerance."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.ants import model as jmodel  # noqa: E402
from repro.configs.ants_netlogo import REDUCED as J_REDUCED  # noqa: E402
from repro.core import JaxTask  # noqa: E402
from repro.core import MeshEnvironment as JMeshEnvironment  # noqa: E402
from repro.launch.mesh import make_host_mesh as jmake_host_mesh  # noqa: E402
from repro_torch.ants import simulate_batch  # noqa: E402
from repro_torch.configs.ants_netlogo import REDUCED  # noqa: E402
from repro_torch.core import (EGIEnvironment, LocalEnvironment,  # noqa: E402
                              MeshEnvironment, PyTask, TorchTask, Val)
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402
from test_torch_ants import _replayed_gumbel  # noqa: E402
from test_torch_mesh import _run_ranks  # noqa: E402

INPUTS = (Val("gDiffusionRate", float), Val("gEvaporationRate", float),
          Val("seed", int))
FOODS = tuple(Val(f"food{i}", float) for i in (1, 2, 3))
CONTEXTS = [{"gDiffusionRate": d, "gEvaporationRate": e, "seed": s}
            for d, e, s in ((30.0, 10.0, 3), (70.0, 40.0, 5),
                            (50.0, 5.0, 7), (90.0, 20.0, 11))]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def noise():
    """{seed: (ticks, 1, P, 8)}: the Gumbel draws the reference's
    ``simulate`` makes from ``jax.random.key(seed)``."""
    draw = jax.jit(_replayed_gumbel, static_argnums=(1, 2))
    return {c["seed"]: torch.from_numpy(np.array(draw(
        jax.random.key(c["seed"])[None], REDUCED.max_ticks,
        REDUCED.population))) for c in CONTEXTS}


def _port_task(noise):
    def ants(gDiffusionRate, gEvaporationRate, seed):
        obj = simulate_batch(
            REDUCED, torch.tensor([gDiffusionRate], dtype=torch.float32),
            torch.tensor([gEvaporationRate], dtype=torch.float32),
            noise=noise[int(seed)])[0]
        return {"food1": obj[0], "food2": obj[1], "food3": obj[2]}
    return TorchTask("ants", ants, inputs=INPUTS, outputs=FOODS,
                     device="cpu")


def _reference_outputs():
    def ants(gDiffusionRate, gEvaporationRate, seed):
        obj = jmodel.simulate(J_REDUCED, jax.random.key(seed),
                              gDiffusionRate, gEvaporationRate)
        return {"food1": obj[0], "food2": obj[1], "food3": obj[2]}
    task = JaxTask("ants", ants, inputs=INPUTS, outputs=FOODS)
    env = JMeshEnvironment(jmake_host_mesh())
    return [{k: float(v) for k, v in o.items()}
            for o in env.map_explore(task, CONTEXTS)]


def _floats(outs):
    return [{k: float(v) for k, v in o.items()} for o in outs]


def test_one_rank_mesh_equals_local_and_the_reference(noise):
    task = _port_task(noise)
    env = MeshEnvironment(tmesh.make_host_mesh("cpu"))
    got = env.map_explore(task, CONTEXTS)
    local = LocalEnvironment().map_explore(task, CONTEXTS)
    for g, lo in zip(got, local):
        assert set(g) == {"food1", "food2", "food3"}
        for k in g:
            assert torch.equal(g[k], lo[k])
    assert env.last_lanes == range(4)          # one rank: replicated
    assert env.stats.submitted == env.stats.completed == 4
    want = _reference_outputs()
    assert _floats(got) == want
    # the signal: some source empties within the horizon
    assert min(min(o.values()) for o in want) < REDUCED.max_ticks


def test_ragged_contexts_and_other_tasks_go_to_the_base_class(noise):
    env = MeshEnvironment(tmesh.make_host_mesh("cpu"))
    task = _port_task(noise).set(gEvaporationRate=40.0)
    ragged = [dict(CONTEXTS[1]), {"gDiffusionRate": 70.0, "seed": 5}]
    out = env.map_explore(task, ragged)     # the second takes the default
    assert env.last_lanes is None and env.stats.submitted == 2
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k])
    py = PyTask("py", lambda ctx: {"y": ctx["x"] * 2}, inputs=(Val("x"),),
                outputs=(Val("y"),))
    assert [o["y"] for o in env.map_explore(py, [{"x": 1}, {"x": 2}])] \
        == [2, 4]
    assert env.last_lanes is None


def test_jit_installs_the_mesh():
    env = MeshEnvironment(tmesh.make_host_mesh("cpu"))
    assert env.jit(shd.active_mesh)() is env.mesh
    assert shd.active_mesh() is None


def test_the_production_mesh_needs_its_ranks():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="256 ranks"):
        MeshEnvironment(device="cpu")
    with pytest.raises(ValueError, match="512 ranks"):
        EGIEnvironment("biomed", openMOLEMemory=1200, device="cpu")


@pytest.fixture
def fake_512():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_egi_environment_is_the_two_pod_mesh(fake_512):
    env = EGIEnvironment("biomed", openMOLEMemory=1200, wallTime="4:00:00",
                         device="cpu")
    assert isinstance(env, MeshEnvironment) and env.name == "multipod"
    assert env.mesh.shape == {"pod": 2, "data": 16, "model": 16}
    assert env.mesh.device_mesh is not None
    # the island rule puts 1024 lanes on (pod, data), 32 shards of 32
    assert shd.logical_to_spec(("island",), (1024,), env.mesh)[0] \
        == ("pod", "data")


RANKS = """
from repro_torch.core import MeshEnvironment, TorchTask, Val
from repro_torch.ants import simulate_batch
from repro_torch.configs.ants_netlogo import REDUCED
from repro_torch.launch import mesh as tmesh
noise = torch.load(f"{out}/noise.pt")
FOODS = tuple(Val(f"food{i}", float) for i in (1, 2, 3))

def ants(gDiffusionRate, gEvaporationRate, seed):
    obj = simulate_batch(
        REDUCED, torch.tensor([gDiffusionRate], dtype=torch.float32),
        torch.tensor([gEvaporationRate], dtype=torch.float32),
        noise=noise[int(seed)])[0]
    return {"food1": obj[0], "food2": obj[1], "food3": obj[2]}

task = TorchTask("ants", ants, inputs=(Val("gDiffusionRate", float),
                 Val("gEvaporationRate", float), Val("seed", int)),
                 outputs=FOODS, device="cpu")
contexts = torch.load(f"{out}/contexts.pt")
env = MeshEnvironment(tmesh.make_host_mesh("cpu"))
res = {"sharded": env.map_explore(task, contexts),
       "sharded_lanes": env.last_lanes}
res["replicated"] = env.map_explore(task, contexts[:1])
res["replicated_lanes"] = env.last_lanes
res["stats"] = (env.stats.submitted, env.stats.completed)
torch.save(res, f"{out}/rank{rank}.pt")
"""


def test_two_ranks_each_run_their_block_and_return_every_context(
        noise, tmp_path):
    torch.save(noise, tmp_path / "noise.pt")
    torch.save(CONTEXTS, tmp_path / "contexts.pt")
    ranks = _run_ranks(RANKS, 2, tmp_path, timeout=300.0)
    local = LocalEnvironment().map_explore(_port_task(noise), CONTEXTS)
    for r, res in enumerate(ranks):
        assert res["sharded_lanes"] == range(2 * r, 2 * r + 2)
        assert res["replicated_lanes"] == range(1)
        assert res["stats"] == (5, 5)
        for kind, n in (("sharded", 4), ("replicated", 1)):
            assert len(res[kind]) == n
            for g, lo in zip(res[kind], local):
                for k in lo:
                    assert torch.equal(g[k], lo[k]), (r, kind, k)
