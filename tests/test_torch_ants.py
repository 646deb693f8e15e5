"""The port's ants simulator against the JAX package on the CPU, with the
JAX package's own Gumbel stream replayed into the port: tick by tick, and
over the whole REDUCED horizon through ``replicated_batch``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ants import model as jmodel  # noqa: E402
from repro.configs.ants_netlogo import REDUCED as J_REDUCED  # noqa: E402
from repro.explore.replication import replicated_batch as j_replicated  # noqa: E402
from repro_torch.ants import model  # noqa: E402
from repro_torch.configs.ants_netlogo import REDUCED  # noqa: E402
from repro_torch.explore.replication import median, replicated_batch  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))


def _replayed_gumbel(keys, ticks, population):
    """(ticks, N, P, 8): the Gumbel draws the reference simulator makes from
    lane keys ``keys`` — per tick each lane key splits into (next key, move
    key) and the move key draws a (P, 8) Gumbel tensor."""
    def body(rng, _):
        k = jax.vmap(jax.random.split)(rng)
        g = jax.vmap(lambda kk: jax.random.gumbel(kk, (population, 8)))(
            k[:, 1])
        return k[:, 0], g

    return jax.lax.scan(body, keys, None, length=ticks)[1]


TICKS = 120
DIFF = np.array([20.0, 50.0, 85.0], np.float32)
EVAP = np.array([5.0, 10.0, 30.0], np.float32)


@pytest.fixture(scope="module")
def reference_ticks():
    """The reference's states after each of TICKS ticks, and its noise."""
    keys = jax.random.split(jax.random.key(0), len(DIFF))
    diffusion = jnp.clip(jnp.asarray(DIFF) / 100.0, 0.0, 1.0)
    evaporation = jnp.clip(jnp.asarray(EVAP) / 100.0, 0.0, 1.0)

    @jax.jit
    def run(keys):
        step = jmodel.make_step(J_REDUCED)

        def body(s, tick):
            s = step(s, tick, diffusion, evaporation)
            return s, s._replace(rng=None)

        states = jax.lax.scan(body, jmodel.init_state(J_REDUCED, keys),
                              jnp.arange(TICKS, dtype=jnp.int32))[1]
        return states, _replayed_gumbel(keys, TICKS, J_REDUCED.population)

    states, gumbel = run(keys)
    return jax.tree.map(np.asarray, states), np.asarray(gumbel)


def test_ticks_match_reference(reference_ticks):
    states, gumbel = reference_ticks
    n = len(DIFF)
    step = model.make_step(REDUCED, "cpu")
    diffusion = _t(DIFF / 100.0)
    evaporation = _t(EVAP / 100.0)
    prev = model.init_state(REDUCED, n, "cpu")
    for tick in range(TICKS):
        got = step(prev, tick, diffusion, evaporation, _t(gumbel[tick]))
        for name in ("ant_pos", "carrying", "food", "ticks_empty"):
            np.testing.assert_array_equal(
                getattr(got, name).numpy(), getattr(states, name)[tick],
                err_msg=f"{name} at tick {tick}")
        np.testing.assert_allclose(got.chem.numpy(), states.chem[tick],
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"chem at tick {tick}")
        # continue from the reference's state, so each tick is tested alone
        prev = model.AntsState(*(_t(getattr(states, f)[tick])
                                 for f in model.AntsState._fields))
    assert states.carrying[-1].any() and states.chem[-1].max() > 1.0


def test_simulate_batch_matches_reference_through_replication():
    """The whole REDUCED horizon, 2 genomes x 2 replicates = 4 lanes, fed
    the reference's Gumbel stream: first-empty ticks and medians equal."""
    genomes = np.array([[30.0, 10.0], [70.0, 40.0]], np.float32)
    keys = jax.random.split(jax.random.key(1), 2)
    reps = 2

    def jax_lanes(k, g):
        return jmodel.simulate_batch(J_REDUCED, k, g[:, 0], g[:, 1])

    expect_med = np.asarray(jax.jit(j_replicated(jax_lanes, reps))(
        keys, jnp.asarray(genomes)))
    # the lane keys replicated_batch hands the simulator, and their noise
    flat_keys = jax.vmap(lambda k: jax.random.split(k, reps))(keys).reshape(
        len(genomes) * reps)
    noise = _t(jax.jit(_replayed_gumbel, static_argnums=(1, 2))(
        flat_keys, J_REDUCED.max_ticks, J_REDUCED.population))
    lanes = []

    def port_lanes(gen, g):
        out = model.simulate_batch(REDUCED, g[:, 0], g[:, 1], noise=noise)
        lanes.append(out)
        return out

    got_med = replicated_batch(port_lanes, reps)(None, _t(genomes))
    np.testing.assert_array_equal(got_med.numpy(), expect_med)
    expect_lanes = np.asarray(jax.jit(jax_lanes)(
        flat_keys, jnp.asarray(np.repeat(genomes, reps, axis=0))))
    np.testing.assert_array_equal(lanes[0].numpy(), expect_lanes)
    # the nearest source empties within the horizon on some lane
    assert (expect_lanes[:, 0] < J_REDUCED.max_ticks).any()


def test_median_averages_the_middle_pair():
    x = torch.tensor([[4.0, 1.0, 3.0, 2.0], [5.0, 5.0, 9.0, 1.0]])
    np.testing.assert_array_equal(
        median(x, dim=1).numpy(), np.asarray(jnp.median(x.numpy(), axis=1)))
    np.testing.assert_array_equal(median(x[:, :3], dim=1).numpy(), [3.0, 5.0])


def test_food_layout_matches_reference():
    food, masks = model.food_sources(REDUCED)
    jfood, jmasks = jmodel.food_sources(J_REDUCED)
    np.testing.assert_array_equal(food.numpy(), np.asarray(jfood))
    np.testing.assert_array_equal(masks.numpy(), np.asarray(jmasks))
    np.testing.assert_array_equal(model.nest_mask(REDUCED).numpy(),
                                  np.asarray(jmodel.nest_mask(J_REDUCED)))


def test_simulate_needs_one_noise_source():
    rates = torch.full((2,), 50.0)
    with pytest.raises(ValueError, match="exactly one"):
        model.simulate_batch(REDUCED, rates, rates)
