"""The slice end to end on the CPU: the port's island-model calibration
against the JAX package's with the same flags, checkpoint resume, moving a
JAX island state into the port, and the rule that the port imports neither
JAX nor the JAX package."""
import ast
import json
import os
import socket
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.evolution import island as jisland  # noqa: E402
from repro.evolution import nsga2 as jnsga2  # noqa: E402
from repro.launch import explore as jexplore  # noqa: E402
from repro_torch import checkpoint  # noqa: E402
from repro_torch.evolution import island, nsga2  # noqa: E402
from repro_torch.launch import explore  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FLAGS = dict(reduced=True, n_islands=2, mu=8, lam=8, steps_per_epoch=1,
             epochs=2, replicates=2)
BOUNDS = ((0.0, 99.0), (0.0, 99.0))


def _quiet(*_):
    pass


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_calibrate")
    state, front = jexplore.calibrate(out_dir=str(out), printer=_quiet,
                                      **FLAGS)
    return state, front, out


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_calibrate")
    state, front = explore.calibrate(out_dir=str(out), device="cpu",
                                     printer=_quiet, **FLAGS)
    return state, front, out


def _mutually_nondominated(obj):
    obj = np.asarray(obj)
    le = (obj[None, :, :] <= obj[:, None, :]).all(-1)
    lt = (obj[None, :, :] < obj[:, None, :]).any(-1)
    return not (le & lt).any()


def test_calibrate_matches_reference_accounting(reference_run, port_run):
    _, jfront, jout = reference_run
    state, front, out = port_run
    assert front["evaluations"] == jfront["evaluations"] \
        == state.total_evaluations == 2 * (8 + 2 * 8)
    for name in ("pareto_front.json", "provenance.json"):
        with open(jout / name) as f:
            jkeys = set(json.load(f))
        with open(out / name) as f:
            assert set(json.load(f)) == jkeys, name
    assert sorted(os.listdir(out / "populations")) == sorted(
        os.listdir(jout / "populations"))
    assert front["objectives"] and _mutually_nondominated(
        front["objectives"])
    with open(out / "provenance.json") as f:
        record = json.load(f)
    assert [t["capsule"] for t in record["tasks"]] == [1, 2]


def test_rerun_resumes_on_the_identical_archive(port_run):
    state, front, out = port_run
    lines = []
    again, front2 = explore.calibrate(out_dir=str(out), device="cpu",
                                      printer=lines.append, **FLAGS)
    assert lines[0] == "[explore] resumed at epoch 2"
    for a, b in zip(again.archive, state.archive):
        assert torch.equal(a, b)
    assert front2["objectives"] == front["objectives"]
    assert front2["evaluations"] == front["evaluations"]


def test_resume_continues_bitwise(port_run, tmp_path):
    state, _, _ = port_run
    flags = dict(FLAGS, epochs=1)
    explore.calibrate(out_dir=str(tmp_path), device="cpu", printer=_quiet,
                      **flags)
    resumed, _ = explore.calibrate(out_dir=str(tmp_path), device="cpu",
                                   printer=_quiet, **FLAGS)
    for a, b in zip(resumed.archive + resumed.islands,
                    state.archive + state.islands):
        assert torch.equal(a, b)
    assert resumed.total_evaluations == state.total_evaluations


@pytest.mark.parametrize("change", [
    {"reduced": False}, {"replicates": 3}, {"reseed_frac": 0.25}])
def test_resume_refuses_a_run_of_other_settings(port_run, change):
    # the same GA widths, so the saved leaves fit; only the settings differ
    _, _, out = port_run
    with pytest.raises(ValueError, match="other settings"):
        explore.calibrate(out_dir=str(out), device="cpu", printer=_quiet,
                          **dict(FLAGS, **change))


def test_cli_default_out_is_under_the_temporary_directory(monkeypatch,
                                                          tmp_path):
    seen = {}
    monkeypatch.setattr(explore.tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(explore, "calibrate", lambda **kw: seen.update(kw))
    explore.main(["--device", "cpu", "--reduced"])
    assert Path(seen["out_dir"]).parent == tmp_path


def test_reference_state_carries_over(reference_run):
    jstate = reference_run[0]
    jcfg = jnsga2.NSGA2Config(mu=8, genome_dim=2, bounds=BOUNDS)
    tcfg = nsga2.NSGA2Config(mu=8, genome_dim=2, bounds=BOUNDS)
    host = jax.tree.map(np.asarray, jstate._replace(
        islands=jstate.islands._replace(rng=None)))
    tstate = island.state_from_arrays(host, device="cpu")
    assert tstate.epoch == 2 and tstate.total_evaluations == 48
    expect = jax.jit(jisland.make_merge(jcfg, merge_top_k=4))(
        jstate.archive, jstate.islands)
    got = island.make_merge(tcfg, merge_top_k=4)(tstate.archive,
                                                 tstate.islands)
    for g, e in zip(got, expect):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    flat_o = np.array(host.islands.objectives.reshape(16, 3))
    flat_v = np.array(host.islands.valid.reshape(16))
    groups = np.repeat(np.arange(2), 8).astype(np.int32)
    jranks = jax.jit(jnsga2.nondominated_ranks)(flat_o, flat_v, groups)
    tranks = nsga2.nondominated_ranks(torch.from_numpy(flat_o),
                                      torch.from_numpy(flat_v),
                                      torch.from_numpy(groups))
    np.testing.assert_array_equal(tranks.numpy(), np.asarray(jranks))


def test_calibrate_refuses_missing_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        explore.calibrate(out_dir=str(tmp_path), **FLAGS)


@pytest.mark.parametrize("argv", [
    ["--method", "surrogate-mo"],
    ["--method", "service", "--init-population", "32"]])
def test_cli_flags_not_ported_yet(argv, capsys, tmp_path):
    """Both methods are ported now: each runs on the CPU at a tiny size
    (one round of two Sobol points) and writes its result."""
    explore.main(argv + ["--device", "cpu", "--reduced", "--rounds", "1",
                         "--q", "2", "--n-init", "2", "--replicates", "1",
                         "--out", str(tmp_path)])
    result = {"surrogate-mo": "surrogate_mo_result.json",
              "service": "service_result.json"}[argv[1]]
    assert (tmp_path / result).exists()
    assert "not ported" not in capsys.readouterr().err


TINY = ["--device", "cpu", "--reduced", "--islands", "2", "--mu", "4",
        "--lam", "4", "--steps-per-epoch", "1", "--epochs", "2",
        "--replicates", "1"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def one_thread():
    """One intra-op thread: at these sizes it is faster than many, and it
    leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the reference's multi-device flags, run through the CLI in one process
@pytest.mark.parametrize("argv", [
    ["--mesh", "data=1"],
    ["--pool-devices", "1", "--init-population", "16", "--init-chunk", "8"],
    ["--distributed", "--coordinator", "127.0.0.1:{port}",
     "--num-processes", "1", "--process-id", "0"],
    ["--mesh", "data=2"]])
def test_cli_runs_the_multi_device_flags(argv, capsys, tmp_path,
                                        one_thread):
    argv = [a.format(port=_free_port()) for a in argv]
    if argv == ["--mesh", "data=2"]:
        # two ranks asked of a process without a process group
        with pytest.raises(SystemExit) as e:
            explore.main(TINY + argv + ["--out", str(tmp_path)])
        assert e.value.code == 2
        err = capsys.readouterr().err
        assert "torchrun --nproc-per-node 2" in err and "--distributed" in err
        assert not os.path.exists(tmp_path / "pareto_front.json")
        return
    explore.main(TINY + argv + ["--out", str(tmp_path)])
    assert not torch.distributed.is_initialized()
    with open(tmp_path / "pareto_front.json") as f:
        front = json.load(f)
    with open(tmp_path / "provenance.json") as f:
        record = json.load(f)
    assert record["environment"] == "mesh{'data': 1}"
    assert front["objectives"] and _mutually_nondominated(
        front["objectives"])
    if "--pool-devices" in argv:
        chunks = [t for t in record["tasks"] if t["task"] == "init_chunk"]
        assert len(chunks) == 2 and front["init"]["n_individuals"] == 16
        assert {a["environment"] for t in chunks
                for a in t["attempts"]} == {"dev0[cpu]"}


# each flag of the reference's --method islands that the port runs, end to
# end through the CLI at a tiny size: (argv, what it must leave behind)
@pytest.mark.parametrize("argv,expect", [
    (["--pipeline"], {"scheduler": "islands-pipelined", "steps": [1, 2]}),
    (["--superstep", "2"], {"scheduler": "islands", "steps": [2]}),
    (["--init-population", "32"], {"init": 32, "chunks": 1}),
    (["--init-population", "32", "--init-chunk", "16"],
     {"init": 32, "chunks": 2}),
    (["--init-population", "32", "--init-chunk", "8", "--fault-rate", "0.3"],
     {"init": 32, "chunks": 4, "fault_rate": 0.3})])
def test_cli_runs_each_ported_flag(argv, expect, tmp_path):
    explore.main(TINY + argv + ["--out", str(tmp_path)])
    with open(tmp_path / "pareto_front.json") as f:
        front = json.load(f)
    with open(tmp_path / "provenance.json") as f:
        record = json.load(f)
    epochs = [t["capsule"] for t in record["tasks"]
              if t["task"] == "island_epoch"]
    # one record per checkpoint: every epoch, or every superstep
    assert epochs == expect.get("steps", [1, 2]) and front["objectives"]
    assert _mutually_nondominated(front["objectives"])
    if "scheduler" in expect:
        assert record["scheduler"] == expect["scheduler"]
        assert sorted(os.listdir(tmp_path / "checkpoints")) == [
            f"step_{s:08d}" for s in expect["steps"]]
        assert "init" not in front and front["evaluations"] == 2 * (4 + 8)
    if "init" in expect:
        chunks = [t for t in record["tasks"] if t["task"] == "init_chunk"]
        assert len(chunks) == expect["chunks"]
        assert front["init"]["n_individuals"] == expect["init"]
        assert front["init"]["fault_rate"] == expect.get("fault_rate", 0.0)
        assert front["init"]["attempts"] == sum(
            len(t["attempts"]) for t in chunks) >= expect["chunks"]
        assert front["evaluations"] == expect["init"] + 2 * 2 * 4


def test_run_islands_defaults_to_the_card(monkeypatch):
    # the GA entry points resolve device="cuda" unless told otherwise, so
    # a caller that names no device never runs on the CPU unawares
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = nsga2.NSGA2Config(mu=4, genome_dim=2, bounds=BOUNDS)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        island.run_islands(cfg, None, torch.Generator(), n_islands=1, lam=1,
                           steps_per_epoch=1, epochs=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        island.init_island_state(cfg, torch.Generator(), n_islands=1,
                                 archive_size=4)


def test_checkpoint_roundtrip(tmp_path):
    gen = torch.Generator().manual_seed(3)
    tree = {"state": island.init_island_state(
        nsga2.NSGA2Config(mu=4, genome_dim=2, bounds=BOUNDS), gen,
        n_islands=2, archive_size=6, device="cpu"),
        "rng": gen.get_state().numpy()}
    for step in (1, 2, 3):
        checkpoint.save(str(tmp_path), step, tree)
    assert checkpoint.latest_step(str(tmp_path)) == 3
    checkpoint.prune(str(tmp_path), keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000003"]
    back = checkpoint.restore(str(tmp_path), 3, tree)
    assert back["state"].epoch == 0
    for a, b in zip(back["state"].islands, tree["state"].islands):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(back["rng"], tree["rng"])
    with pytest.raises(ValueError, match="expected"):
        checkpoint.restore(str(tmp_path), 3, {"state": tree["state"]})


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, mod)
