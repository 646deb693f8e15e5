"""Device-set pool members of the port (``DeviceEnvironment``,
``make_device_members``, ``make_init_pool(pool_devices=k)``) on the CPU,
mirroring the reference's partitioning cases (``tests/test_devicepool.py``):
the split and its errors, each attempt and each lane block run under its
member's device (read back from what the member and the task record), and
the streaming init through device-set members bitwise equal to the inline
init."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import make_device_members as j_make_device_members  # noqa: E402,E501
from repro_torch.configs.ants_netlogo import REDUCED  # noqa: E402
from repro_torch.core import (Context, DeviceEnvironment,  # noqa: E402
                              EnvironmentPool, PyTask, TorchTask, Val,
                              make_device_members, pinned_device)
from repro_torch.core.environment import local_devices  # noqa: E402
from repro_torch.evolution import ga, nsga2  # noqa: E402
from repro_torch.launch import explore  # noqa: E402
from repro_torch.runtime.sharding import Mesh  # noqa: E402

# four CUDA device names: a split needs no card, only running on one does
CARDS = [torch.device("cuda", i) for i in range(4)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: at these sizes it is faster than many, and it
    leaves the cores to the pool's threads and the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("k,sizes", [(1, [4]), (2, [2, 2]), (3, [2, 1, 1]),
                                     (4, [1, 1, 1, 1])])
def test_make_device_members_partitions_disjointly(k, sizes):
    members = make_device_members(CARDS, k)
    assert [len(m.devices) for m in members] == sizes
    # the reference splits the same way
    assert sizes == [len(m.devices) for m in
                     j_make_device_members(list(range(4)), k)]
    assert [d for m in members for d in m.devices] == CARDS    # a cover
    if k == 2:
        assert [m.name for m in members] == ["dev0[0,1]", "dev1[2,3]"]
    for m in members:
        assert m.capacity == 2 * len(m.devices)
    with pytest.raises(ValueError, match="cannot partition"):
        make_device_members(CARDS, 5)
    with pytest.raises(ValueError, match="k must be"):
        make_device_members(CARDS, 0)


def test_make_device_members_accepts_a_mesh_and_the_local_devices():
    mesh = Mesh((("data", 1),), torch.device("cpu"))
    (m,) = make_device_members(mesh, 1)
    assert m.devices == (torch.device("cpu"),) and m.name == "dev0[cpu]"
    assert local_devices("cpu") == [torch.device("cpu")]
    (m,) = make_device_members(None, 1, device="cpu")
    assert m.devices == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="cannot partition"):
        make_device_members(None, 2, device="cpu")
    with pytest.raises(ValueError):
        DeviceEnvironment([])


def test_faults_callable_seeds_each_member():
    from repro_torch.core import FaultSpec
    members = make_device_members(
        CARDS, 2, faults=lambda i: FaultSpec(fail_rate=0.5, seed=10 + i))
    assert [m.faults.seed for m in members] == [10, 11]


# two CPU "devices" stand in for two cards: pinning a CPU device sets only
# what pinned_device() reads
HOSTS = [torch.device("cpu", 0), torch.device("cpu", 1)]


def test_each_attempt_runs_under_its_members_device():
    probe = PyTask("probe", lambda ctx: {"y": 2.0 * ctx["x"],
                                         "dev": str(pinned_device())},
                   inputs=(Val("x", float),),
                   outputs=(Val("y", float), Val("dev", str)))
    env = DeviceEnvironment(HOSTS)
    seen = [env.submit(probe, Context(x=float(i)))["dev"] for i in range(4)]
    assert seen == ["cpu:0", "cpu:1", "cpu:0", "cpu:1"]     # round-robin
    assert pinned_device() is None                            # unpinned after
    # through a pool: every attempt lands on one of its member's devices
    members = make_device_members(HOSTS, 2)
    pool = EnvironmentPool(members)
    try:
        for i in range(6):
            out, meta = pool.submit_traced(probe, Context(x=float(i)))
            (a,) = meta["attempts"]
            member = next(m for m in members if m.name == a["environment"])
            assert out["dev"] in {str(d) for d in member.devices}
    finally:
        pool.shutdown()


def test_map_explore_places_lane_blocks_on_the_members_devices():
    task = TorchTask("lane", lambda x: {"y": x * 2.0,
                                        "dev": str(pinned_device())},
                     inputs=(Val("x"),), outputs=(Val("y"), Val("dev")),
                     device="cpu")
    env = DeviceEnvironment(HOSTS)
    outs = env.map_explore(task, [Context(x=torch.tensor(float(i)))
                                  for i in range(4)])
    assert [o["dev"] for o in outs] == ["cpu:0", "cpu:0", "cpu:1", "cpu:1"]
    assert [float(o["y"]) for o in outs] == [0.0, 2.0, 4.0, 6.0]
    assert env.last_lane_devices == tuple(HOSTS)
    # lanes that do not divide evenly go to one device, round-robin
    outs = env.map_explore(task, [Context(x=torch.tensor(1.0))] * 3)
    assert len({o["dev"] for o in outs}) == 1
    assert env.last_lane_devices in ((HOSTS[0],), (HOSTS[1],))
    assert env.stats.submitted == env.stats.completed == 7


@pytest.mark.parametrize("fault_rate", [0.0, 0.35])
def test_pool_devices_streaming_init_equals_the_inline_init(fault_rate):
    cfg = nsga2.NSGA2Config(mu=4, genome_dim=2,
                            bounds=((0.0, 99.0), (0.0, 99.0)))
    eval_fn = explore.ants_eval_fn(REDUCED, 1)
    kw = dict(n_total=48, chunk=16, device="cpu")
    inline = ga.evaluate_population_streaming(cfg, eval_fn, 3, **kw)
    pool = explore.make_init_pool(fault_rate, pool_devices=1, device="cpu")
    assert [m.name for m in pool.members] == ["dev0[cpu]"]
    try:
        got = ga.evaluate_population_streaming(cfg, eval_fn, 3,
                                               environment=pool, **kw)
    finally:
        pool.shutdown()
    np.testing.assert_array_equal(got.genomes, inline.genomes)
    np.testing.assert_array_equal(got.objectives, inline.objectives)
    assert got.attempts >= got.chunks_total == 3
