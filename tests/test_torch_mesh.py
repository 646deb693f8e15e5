"""Several ranks on the CPU: the port's row-sharded dominance sweep against
the JAX package's oracles, and the island run over a two-rank mesh bit for
bit against the one-rank run, both schedules and a resume.

Ranks are gloo processes started here (``python -c``), joined through a
FileStore under the test's ``tmp_path`` (never a fixed port: several xdist
workers run at once), each group under a timeout of its own; a rank that
fails fails the test. Their results come back as ``torch.save`` files.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch import checkpoint  # noqa: E402
from repro_torch.evolution import island, nsga2  # noqa: E402
from repro_torch.launch import explore, mesh as tmesh  # noqa: E402
from repro_torch.runtime import sharding  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BOUNDS = ((0.0, 99.0), (0.0, 99.0))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: at these sizes it is faster than many, and it
    leaves the cores to the spawned ranks and the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# every rank script starts here: argv = rank, world, store, out
PREAMBLE = """
import datetime, functools, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=300))
"""


def _run_ranks(script: str, world: int, tmp_path: Path,
               timeout: float = 600.0) -> list:
    """Run ``script`` as ``world`` gloo ranks; -> each rank's saved dict."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    code = PREAMBLE + textwrap.dedent(script)
    logs = [open(tmp_path / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world),
         str(tmp_path / "store"), str(tmp_path)],
        env=env, stdout=logs[r], stderr=subprocess.STDOUT, cwd=ROOT)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (tmp_path / f"rank{r}.log").read_text()
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# the sharded sweep against the reference's oracles
# ---------------------------------------------------------------------------
SWEEP = """
from repro_torch.evolution import nsga2
from repro_torch.runtime import sharding
calls = [0]
all_reduce = dist.all_reduce

def counted(*a, **kw):
    calls[0] += 1
    return all_reduce(*a, **kw)

dist.all_reduce = counted
group = dist.group.WORLD
sweep = functools.partial(sharding.sharded_dominance_pass, mesh=group)
res = {}
for n in (997, 1001):
    f = torch.from_numpy(
        np.random.default_rng(n).random((n, 3), dtype=np.float32))
    g = torch.arange(n, dtype=torch.int32) % 3
    calls[0] = 0
    counts, block = sweep(f, groups=g)
    pass_calls = calls[0]
    # the whole bitmap, for the check: every rank's rows, zero-padded
    rows = -(-n // (world * 32)) * 32
    mine = block.words.new_zeros((rows, block.words.shape[1]))
    mine[:len(block.words)] = block.words
    bitmap = sharding.all_gather_rows(mine, group)[:n]
    calls[0] = 0
    ranks = nsga2.nondominated_ranks(f, pass_fn=sweep)
    res[n] = dict(counts=counts, bitmap=bitmap, row0=block.row0,
                  block_rows=len(block.words), pass_calls=pass_calls,
                  ranks=ranks, rank_calls=calls[0],
                  grouped=nsga2.nondominated_ranks(f, groups=g,
                                                   pass_fn=sweep))
torch.save(res, f"{out}/rank{rank}.pt")
"""


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_pass_equals_the_reference_oracles(world, tmp_path):
    got = _run_ranks(SWEEP, world, tmp_path)
    for n in (997, 1001):
        f = np.random.default_rng(n).random((n, 3), dtype=np.float32)
        g = (np.arange(n) % 3).astype(np.int32)
        cnt_ref, bm_ref = jref.dominance_pass_ref(jnp.asarray(f),
                                                  groups=jnp.asarray(g))
        ranks_ref = jref.nondominated_ranks_ref(f)
        grouped = nsga2.nondominated_ranks(torch.from_numpy(f),
                                           groups=torch.from_numpy(g))
        rows = -(-n // (world * 32)) * 32      # padded rows per rank
        for r, res in enumerate(got):
            x = res[n]
            np.testing.assert_array_equal(x["counts"].numpy(),
                                          np.asarray(cnt_ref))
            np.testing.assert_array_equal(
                x["bitmap"].numpy(), np.asarray(bm_ref).view(np.int32))
            np.testing.assert_array_equal(x["ranks"].numpy(), ranks_ref)
            assert torch.equal(x["grouped"], grouped)
            # padded sizes shard: one all_reduce for the counts, and every
            # rank sweeps its own block of rows
            assert x["pass_calls"] == 1
            assert x["row0"] == r * rows
            assert x["block_rows"] == max(0, min(rows, n - r * rows))
            # one all_reduce a front: every rank left the loop together
            assert x["rank_calls"] == 1 + int(ranks_ref.max()) + 1
        assert len({res[n]["rank_calls"] for res in got}) == 1


def test_sharded_pass_without_a_group_is_the_single_pass():
    f = torch.from_numpy(
        np.random.default_rng(5).random((300, 3), dtype=np.float32))
    for mesh in (None, sharding.Mesh((("data", 1),), torch.device("cpu"))):
        cnt, bm = sharding.sharded_dominance_pass(f, mesh=mesh)
        ref_cnt, ref_bm = sharding.kops.dominance_pass(f)
        assert torch.equal(cnt, ref_cnt) and torch.equal(bm, ref_bm)
        assert not isinstance(bm, sharding.RowBlock)


# ---------------------------------------------------------------------------
# the island run over a two-rank mesh
# ---------------------------------------------------------------------------
# the one island run both sides make: the ranks in their script, the test
# here (the same source, so the two runs cannot drift apart)
ISLAND_RUN = """
from repro_torch.configs.ants_netlogo import REDUCED
from repro_torch.evolution import island, nsga2
from repro_torch.launch import explore


def run(n_islands=4, start=None, gen=None, snaps=None, mesh=None, **kw):
    cfg = nsga2.NSGA2Config(mu=4, genome_dim=2,
                            bounds=((0.0, 99.0), (0.0, 99.0)))
    gen = gen or torch.Generator().manual_seed(0)

    def keep(snap, rng):
        snaps[snap.epoch] = (snap, rng)

    flags = dict(lam=4, steps_per_epoch=1, epochs=2, archive_size=16,
                 merge_top_k=2)
    flags.update(kw)
    return island.run_islands(
        cfg, explore.ants_eval_fn(REDUCED, 2), gen, n_islands=n_islands,
        checkpoint_fn=keep if snaps is not None else None,
        start_state=start, device="cpu", mesh=mesh, **flags)
"""
_ns = {"torch": torch}
exec(ISLAND_RUN, _ns)
_islands = _ns["run"]


ISLANDS = ISLAND_RUN + """
from repro_torch import checkpoint
from repro_torch.launch import mesh as tmesh
mesh = tmesh.make_island_mesh(data=2, device="cpu")
assert mesh.shape == {"data": 2} and mesh.rank == rank
res = {}
for name, kw in (("superstep", {}), ("pipeline", {"pipeline": True}),
                 ("three_islands", {"n_islands": 3})):
    snaps = {}
    res[name] = run(mesh=mesh, snaps=snaps, **kw)
    res[name + "_snaps"] = sorted(snaps)
    if name == "superstep" and rank == 0:
        snap, rng = snaps[1]
        checkpoint.save(out + "/ckpt", 1, {"state": snap,
                                           "rng": rng.numpy()})
    dist.barrier()
# every rank resumes the superstep run from rank 0's epoch-1 checkpoint
saved = checkpoint.restore(out + "/ckpt", 1,
                           {"state": res["superstep"], "rng": None})
gen = torch.Generator().manual_seed(0)
gen.set_state(torch.from_numpy(saved["rng"]))
res["resumed"] = run(mesh=mesh, start=saved["state"], gen=gen)
torch.save(res, f"{out}/rank{rank}.pt")
"""


def _assert_states_equal(a, b):
    for x, y in zip(list(a.islands) + list(a.archive),
                    list(b.islands) + list(b.archive)):
        assert torch.equal(x, y)
    assert (a.epoch, a.total_evaluations) == (b.epoch, b.total_evaluations)


def test_two_rank_islands_equal_the_one_rank_run_and_resume(tmp_path):
    got = _run_ranks(ISLANDS, 2, tmp_path)
    snaps = {}
    want = {"superstep": _islands(snaps=snaps),
            "pipeline": _islands(pipeline=True),
            "three_islands": _islands(n_islands=3)}
    assert want["superstep"].archive.valid.any()
    for res in got:
        for name, state in want.items():
            _assert_states_equal(res[name], state)
        _assert_states_equal(res["resumed"], want["superstep"])
    # rank 0 alone called the checkpoint function, at every epoch
    assert got[0]["superstep_snaps"] == [1, 2]
    assert got[1]["superstep_snaps"] == []
    saved = checkpoint.restore(str(tmp_path / "ckpt"), 1,
                               {"state": snaps[1][0], "rng": None})
    _assert_states_equal(saved["state"], snaps[1][0])
    np.testing.assert_array_equal(saved["rng"], snaps[1][1].numpy())


def test_place_island_state_on_one_rank_keeps_every_island():
    cfg = nsga2.NSGA2Config(mu=4, genome_dim=2, bounds=BOUNDS)
    state = island.init_island_state(cfg, torch.Generator().manual_seed(1),
                                     n_islands=4, archive_size=8,
                                     device="cpu")
    one = sharding.Mesh((("data", 1),), torch.device("cpu"))
    assert island.place_island_state(state, None) is state
    placed = island.place_island_state(state, one)
    _assert_states_equal(placed, state)
    assert island.island_shard(one, 4) == island.Shard(
        island.ga.Rows(0, 4, 4), one, None)


def test_init_distributed_is_a_noop_single_process():
    assert tmesh.init_distributed() is False
    assert not torch.distributed.is_initialized()
    mesh = tmesh.make_island_mesh(device="cpu")
    assert mesh.shape == {"data": 1} and mesh.size == 1 and mesh.rank == 0
    assert mesh.device_mesh is None and mesh.group is None
    assert tmesh.make_host_mesh("cpu").shape == {"data": 1}
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        tmesh.make_island_mesh(data=2, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.make_island_mesh(pod=2, device="cpu")


def test_local_device_keeps_an_explicit_card(monkeypatch):
    """Two cards, mocked: without a process group ``cuda:1`` stays card 1
    and the current device is left alone; in one, the rank's card is made
    current and a device naming another card raises."""
    current = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert tmesh.local_device("cuda:1") == torch.device("cuda", 1)
    assert tmesh.local_device("cuda") == torch.device("cuda")
    assert current == []
    mesh = tmesh.make_host_mesh("cuda:1")
    assert mesh.device == torch.device("cuda", 1) and mesh.size == 1
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    assert tmesh.local_device("cuda") == torch.device("cuda", 1)
    assert tmesh.local_device("cuda:1") == torch.device("cuda", 1)
    assert current == [torch.device("cuda", 1)] * 2
    with pytest.raises(ValueError, match="runs on cuda:1"):
        tmesh.local_device("cuda:0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert tmesh.local_device("cuda:0") == torch.device("cuda", 0)


# ---------------------------------------------------------------------------
# the launcher over two ranks: --distributed --mesh data=2
# ---------------------------------------------------------------------------
TINY = ["--device", "cpu", "--reduced", "--islands", "2", "--mu", "4",
        "--lam", "4", "--steps-per-epoch", "1", "--epochs", "2",
        "--replicates", "1"]

CLI = """
from repro_torch.launch import explore
dist.destroy_process_group()      # the launcher joins a group of its own
explore.main(%r + ["--distributed", "--coordinator", "127.0.0.1:%d",
                   "--num-processes", "2", "--process-id", str(rank),
                   "--mesh", "data=2", "--out", out + "/run"])
assert not dist.is_initialized()
torch.save({}, f"{out}/rank{rank}.pt")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_two_ranks_write_the_one_rank_front(tmp_path):
    _run_ranks(CLI % (TINY, _free_port()), 2, tmp_path)
    explore.main(TINY + ["--out", str(tmp_path / "one")])
    run, one = tmp_path / "run", tmp_path / "one"
    with open(run / "pareto_front.json") as f:
        front = json.load(f)
    with open(one / "pareto_front.json") as f:
        want = json.load(f)
    assert (front["genomes"], front["objectives"], front["evaluations"]) \
        == (want["genomes"], want["objectives"], want["evaluations"])
    with open(run / "provenance.json") as f:
        record = json.load(f)
    assert record["environment"] == "mesh{'data': 2}"
    assert [t["capsule"] for t in record["tasks"]] == [1, 2]
    assert sorted(os.listdir(run / "checkpoints")) == sorted(
        os.listdir(one / "checkpoints"))
    assert sorted(os.listdir(run / "populations")) == sorted(
        os.listdir(one / "populations"))
    # a rerun resumes the two-rank checkpoints in one process
    state, again = explore.calibrate(
        reduced=True, n_islands=2, mu=4, lam=4, steps_per_epoch=1,
        epochs=2, replicates=1, out_dir=str(run), device="cpu",
        printer=lambda *_: None)
    assert again["objectives"] == want["objectives"]
