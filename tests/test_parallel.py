"""Multi-chip tests on the 8-virtual-CPU-device mesh (conftest).

The strongest oracle available: the sharded step must reproduce the
single-chip step (same scene, same seed) up to f32 reduction order.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from fluidsim_tpu.models.flip import FlipSim
from fluidsim_tpu.parallel.flip_sharded import ShardedFlipSim, SENTINEL
from fluidsim_tpu.parallel.halo import exchange_halo, halo_reduce
from fluidsim_tpu.scenes import get_scene
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("x",))


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_halo_exchange_roundtrip(ndev):
    mesh = _mesh(ndev)
    nl = 4
    x = jnp.arange(ndev * nl * 3, dtype=jnp.float32).reshape(ndev * nl, 3)
    xs = jax.device_put(x, NamedSharding(mesh, P("x")))

    def body(sl):
        return exchange_halo(sl, 1, "x")

    out = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("x"),),
                            out_specs=P("x")))(xs)
    out = np.asarray(out).reshape(ndev, nl + 2, 3)
    ref = np.asarray(x).reshape(ndev, nl, 3)
    for d in range(ndev):
        np.testing.assert_array_equal(out[d, 1:-1], ref[d])
        if d > 0:
            np.testing.assert_array_equal(out[d, 0], ref[d - 1, -1])
        else:
            np.testing.assert_array_equal(out[d, 0], 0)
        if d < ndev - 1:
            np.testing.assert_array_equal(out[d, -1], ref[d + 1, 0])
        else:
            np.testing.assert_array_equal(out[d, -1], 0)


def test_halo_reduce_inverts_scatter():
    ndev, nl, w = 4, 4, 2
    mesh = _mesh(ndev)
    rng = np.random.default_rng(0)
    ext = rng.normal(size=(ndev, nl + 2 * w, 3)).astype(np.float32)
    ext_j = jax.device_put(jnp.asarray(ext.reshape(-1, 3)),
                           NamedSharding(mesh, P("x")))

    def body(sl):
        return halo_reduce(sl, w, "x")

    out = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("x"),),
                            out_specs=P("x")))(ext_j)
    out = np.asarray(out).reshape(ndev, nl, 3)
    # expected: interior + contributions shipped from neighbours' halos
    for d in range(ndev):
        exp = ext[d, w:-w].copy()
        if d > 0:
            exp[:w] += ext[d - 1, -w:]
        if d < ndev - 1:
            exp[-w:] += ext[d + 1, :w]
        np.testing.assert_allclose(out[d], exp, rtol=1e-6)


def test_sharded_matches_single_chip():
    scene = get_scene("water_cube_drop", bound=12, density=3.0)
    single = FlipSim(scene)
    sharded = ShardedFlipSim(scene, mesh=_mesh(4))
    assert sharded.num_particles == single.num_particles

    for i in range(5):
        ms = single.step()
        mp = sharded.step()
        np.testing.assert_allclose(float(mp["kinetic_energy"]),
                                   float(ms["kinetic_energy"]),
                                   rtol=2e-3)
        np.testing.assert_allclose(float(mp["dt"]), float(ms["dt"]), rtol=1e-3)
        assert int(mp["num_fluid_cells"]) == int(ms["num_fluid_cells"])
        assert int(mp["lost"]) == 0

    # particle clouds must coincide as sets (order differs across shards)
    pos_s = np.asarray(single.state.pos)
    alive = np.asarray(sharded.state.alive)
    pos_p = np.asarray(sharded.state.pos)[alive]
    assert pos_p.shape == pos_s.shape
    # compare sorted by a stable key
    key_s = np.lexsort(pos_s.T)
    key_p = np.lexsort(pos_p.T)
    np.testing.assert_allclose(pos_p[key_p], pos_s[key_s], atol=5e-3)


def test_migration_preserves_particles():
    scene = get_scene("water_cube_drop", bound=12, density=3.0)
    sim = ShardedFlipSim(scene, mesh=_mesh(8))
    n0 = sim.num_particles
    total_migrated = 0
    for _ in range(10):
        m = sim.step()
        total_migrated += int(m["migrated"])
        assert int(m["lost"]) == 0
        assert int(m["num_alive"]) == n0
    assert total_migrated > 0, "expected some cross-slab migration while falling"
    pos = np.asarray(sim.state.pos)
    alive = np.asarray(sim.state.alive)
    assert (np.abs(pos[alive]) <= scene.spec.bound + 1).all()
    assert (pos[~alive] == SENTINEL).all()


def test_migration_tail_insert_path():
    """Exercise the contiguous dead-tail (dynamic_update_slice) insert —
    the production branch (``tail_insert``) — with real cross-slab
    arrivals (an injected x-drift makes migration immediate), and check
    the same conservation + parity invariants as the scatter branch."""
    import dataclasses as dc

    scene = get_scene("water_cube_drop", bound=24, density=4.0)
    sim = ShardedFlipSim(scene, mesh=_mesh(8), cap_factor=2.0,
                         mig_frac=0.15)
    assert sim.tail_insert, "config must take the dus-insert branch"
    single = FlipSim(scene)
    # identical x-drift in both sims: particles cross slab boundaries
    # from frame 1 on
    drift = jnp.asarray([5.0, 0.0, 0.0], jnp.float32)
    single.state = dc.replace(single.state, vel=single.state.vel + drift)
    sim.state = dc.replace(
        sim.state, vel=jnp.where(sim.state.alive[:, None],
                                 sim.state.vel + drift, 0.0))
    n0 = sim.num_particles
    total_migrated = 0
    for _ in range(6):
        ms = single.step()
        m = sim.step()
        total_migrated += int(m["migrated"])
        assert int(m["lost"]) == 0
        assert int(m["num_alive"]) == n0
        np.testing.assert_allclose(float(m["kinetic_energy"]),
                                   float(ms["kinetic_energy"]), rtol=2e-3)
    assert total_migrated > 0, "expected cross-slab migration while drifting"


def test_sharded_runs_on_two_devices():
    scene = get_scene("water_cube_drop", bound=10, density=2.0)
    sim = ShardedFlipSim(scene, mesh=_mesh(2))
    m = sim.step()
    assert np.isfinite(float(m["kinetic_energy"]))


@pytest.mark.parametrize("ndev", [2, 3, 8])
def test_sharded_matches_single_chip_slab_widths(ndev):
    """Slab widths other than 4 devices, including one that does not
    divide the grid (25 rows over 3 devices pads the last slab)."""
    scene = get_scene("water_cube_drop", bound=12, density=3.0)
    single = FlipSim(scene)
    sharded = ShardedFlipSim(scene, mesh=_mesh(ndev))
    assert sharded.num_particles == single.num_particles
    for _ in range(3):
        ms = single.step()
        mp = sharded.step()
        np.testing.assert_allclose(float(mp["kinetic_energy"]),
                                   float(ms["kinetic_energy"]), rtol=2e-3)
        assert int(mp["num_fluid_cells"]) == int(ms["num_fluid_cells"])
        assert int(mp["lost"]) == 0
