"""Task packaging (``repro_torch.core.packaging``, ``torch.export``) against
the reference's (``repro.core.packaging``, ``jax.export``), and B1 and B2
as ``torch.library`` operators, on the CPU: a packaged task re-executes
from its bundle alone, bit for bit equal to the direct run, through the
ops' plain versions here (their kernels on the card)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import packaging as jpackaging  # noqa: E402
from repro_torch.ants import simulate_state  # noqa: E402
from repro_torch.configs.ants_netlogo import REDUCED  # noqa: E402
from repro_torch.core import packaging  # noqa: E402
from repro_torch.kernels import library, ops, ref  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

TICKS = 12          # export traces one graph node group a tick
CFG = dataclasses.replace(REDUCED, max_ticks=TICKS)


def test_reference_round_trip_is_bitwise_in_both_packages(tmp_path):
    """tests/test_system.py's round trip: a packaged task re-executes
    without its source, in each package."""
    def jtask(x):
        return jnp.sin(x) * 2.0 + jnp.cumsum(x)

    def task(x):
        return torch.sin(x) * 2.0 + torch.cumsum(x, 0)

    x = np.asarray(jax.random.normal(jax.random.key(0), (32,)))
    jpackaging.package(jtask, [jax.ShapeDtypeStruct((32,), jnp.float32)],
                       str(tmp_path / "jax"), name="sin-task")
    np.testing.assert_array_equal(
        np.asarray(jpackaging.load(str(tmp_path / "jax"))(x)),
        np.asarray(jtask(x)))
    path = packaging.package(task, [torch.empty(32, device="meta")],
                             str(tmp_path / "torch"), name="sin-task")
    xt = torch.from_numpy(x)
    assert torch.equal(packaging.load(path)(xt), task(xt))
    m = packaging.manifest(path)
    assert m["name"] == "sin-task" and m["nbytes"] > 0
    assert m["in_specs"] == m["out_specs"] == ["float32[32]"]
    assert m["device"] == "meta" and m["custom_ops"] == []


def ants_apply(diffusion, evaporation, noise):
    """The ants model in its apply form: the objectives and the final
    chemical field of a run from given Gumbel noise."""
    state = simulate_state(CFG, diffusion, evaporation, noise=noise)
    return state.ticks_empty.to(torch.float32), state.chem


class _Ops(TorchDispatchMode):
    """Records every operator the code under it dispatches."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append(func)
        return func(*args, **(kwargs or {}))


def test_packaged_ants_run_equals_the_direct_run(tmp_path):
    rng = np.random.default_rng(0)
    n = 4
    args = (torch.from_numpy(rng.uniform(0, 99, n).astype(np.float32)),
            torch.from_numpy(rng.uniform(0, 99, n).astype(np.float32)),
            torch.from_numpy(rng.gumbel(size=(TICKS, n, CFG.population, 8))
                             .astype(np.float32)))
    path = packaging.package(ants_apply, args, str(tmp_path / "ants"),
                             name="ants")
    m = packaging.manifest(path)
    assert m == {"name": "ants", "nbytes": m["nbytes"], "device": "cpu",
                 "in_specs": ["float32[4]", "float32[4]",
                              f"float32[{TICKS}, 4, {CFG.population}, 8]"],
                 "out_specs": ["float32[4, 3]", "float32[4, 32, 32]"],
                 "custom_ops": ["repro_torch::diffuse_evaporate"]}
    assert m["nbytes"] > 0
    run = packaging.load(path)
    with _Ops() as ops_seen:
        got = run(*args)
    assert ops_seen.seen.count(library.diffuse_evaporate) == TICKS
    want = ants_apply(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert want[1].abs().max() > 0        # the field carries the run
    # the same bundle on other inputs of the same shapes
    other = (args[0].flip(0), args[1], args[2] * 0.5)
    assert all(torch.equal(g, w) for g, w in zip(run(*other),
                                                 ants_apply(*other)))


def test_packaged_dominance_pass_equals_the_direct_call(tmp_path):
    rng = np.random.default_rng(1)
    obj = torch.from_numpy(np.round(rng.random((200, 3)) * 8)
                           .astype(np.float32))            # with ties
    path = packaging.package(lambda x: ops.dominance_pass(x), [obj],
                             str(tmp_path / "dom"), name="dominance")
    m = packaging.manifest(path)
    assert m["custom_ops"] == ["repro_torch::dominance_pass"]
    assert m["out_specs"] == ["int32[200]", "int32[200, 7]"]
    for x in (obj, obj.flip(0)):
        got, want = packaging.load(path)(x), ops.dominance_pass(x)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(want[0], ref.dominance_pass_ref(x)[0])


def test_the_custom_ops_route_by_device_and_have_fake_shapes():
    rng = np.random.default_rng(2)
    chem = torch.from_numpy(rng.random((3, 9, 9), dtype=np.float32))
    rate = torch.tensor([0.1, 0.5, 0.9])
    evap = torch.tensor([0.0, 0.2, 1.0])
    assert torch.equal(ops.diffuse_evaporate(chem, rate, evap),
                       ref.diffuse_evaporate_ref(chem, rate, evap))
    rows = torch.from_numpy(rng.random((70, 3), dtype=np.float32))
    g = torch.arange(70, dtype=torch.int32) % 3
    for got, want in zip(ops.dominance_pass(rows, rows[:40], g, g[:40]),
                         ref.dominance_pass_ref(rows, rows[:40], g, g[:40])):
        assert torch.equal(got, want)
    meta = torch.empty((70, 3), device="meta")
    counts, bitmap = library.dominance_pass(meta, meta[:40])
    assert counts.shape == (70,) and bitmap.shape == (70, 2)
    assert bitmap.dtype == counts.dtype == torch.int32
    assert library.diffuse_evaporate(chem.to("meta"), rate.to("meta"),
                                     evap.to("meta")).shape == (3, 9, 9)
    torch.library.opcheck(library.diffuse_evaporate, (chem, rate, evap))
    torch.library.opcheck(library.dominance_pass, (rows, None, g, None))
