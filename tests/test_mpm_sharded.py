"""Sharded MPM vs single-chip equivalence on the virtual CPU mesh."""

import numpy as np
import jax
import pytest
from jax.sharding import Mesh

from fluidsim_tpu.models.mpm import MpmSim
from fluidsim_tpu.parallel.mpm_sharded import ShardedMpmSim
from fluidsim_tpu.scenes import get_scene


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("x",))


def test_sharded_mpm_matches_single_chip():
    scene = get_scene("mpm_cone")
    single = MpmSim(scene)
    sharded = ShardedMpmSim(scene, mesh=_mesh(4))
    assert sharded.num_particles == single.num_particles

    for i in range(5):
        ms = single.step()
        mp = sharded.step()
        np.testing.assert_allclose(float(mp["kinetic_energy"]),
                                   float(ms["kinetic_energy"]), rtol=3e-3)
        np.testing.assert_allclose(float(mp["dt"]), float(ms["dt"]), rtol=1e-3)
        assert int(mp["num_active_cells"]) == int(ms["num_active_cells"])
        assert int(mp["lost"]) == 0

    # deformation state stays sane across shards
    alive = np.asarray(sharded.state.alive)
    fe = np.asarray(sharded.state.FE)[alive]
    assert np.isfinite(fe).all()
    det = np.linalg.det(fe)
    assert (det > 0.5).all() and (det < 2.0).all()


def test_sharded_mpm_conserves_particles():
    scene = get_scene("mpm_cone")
    sim = ShardedMpmSim(scene, mesh=_mesh(8))
    n0 = sim.num_particles
    for _ in range(8):
        m = sim.step()
        assert int(m["lost"]) == 0
        assert int(m["num_alive"]) == n0
    assert np.isfinite(float(m["kinetic_energy"]))


@pytest.mark.parametrize("ndev", [2, 3])
def test_sharded_mpm_matches_single_chip_slab_widths(ndev):
    scene = get_scene("mpm_cone", density=100.0)
    single = MpmSim(scene)
    sharded = ShardedMpmSim(scene, mesh=_mesh(ndev))
    assert sharded.num_particles == single.num_particles
    for _ in range(3):
        ms = single.step()
        mp_ = sharded.step()
        np.testing.assert_allclose(float(mp_["kinetic_energy"]),
                                   float(ms["kinetic_energy"]), rtol=3e-3)
        assert int(mp_["num_active_cells"]) == int(ms["num_active_cells"])
        assert int(mp_["lost"]) == 0
