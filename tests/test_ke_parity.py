"""Cross-implementation kinetic-energy parity (the BASELINE north-star
signal): the Python/JAX step and the independent C++ pipeline port
(``native/ref_cpu.cc``) run the identical initial particle set; their
per-frame KE traces must track each other.

They are NOT bit-identical — f32 reduction order and solver iteration
counts differ — so the oracle is trajectory-level: small relative KE error
during free fall, bounded drift through impact.
"""

import json
import os
import subprocess

import numpy as np
import pytest

from fluidsim_tpu.io.native import NATIVE_DIR, build_native
from fluidsim_tpu.models.flip import FlipSim
from fluidsim_tpu.scenes import get_scene
from fluidsim_tpu.seeding import seed_particles


def _native_tool(name):
    if not build_native(name):
        pytest.skip(f"{name} not buildable (make -C native {name})")
    return os.path.join(NATIVE_DIR, name)


@pytest.fixture
def ref_cpu():
    return _native_tool("ref_cpu")


@pytest.fixture
def ref_mpm():
    return _native_tool("ref_mpm")


def test_ke_trace_matches_cpp_port(tmp_path, ref_cpu):
    bound, density, frames = 16, 4.0, 25
    scene = get_scene("water_cube_drop", bound=bound, density=density)
    pos, vel = seed_particles(scene, seed=0)

    pfile = str(tmp_path / "particles.f32")
    np.ascontiguousarray(pos, np.float32).tofile(pfile)

    out = subprocess.check_output(
        [ref_cpu, str(bound), str(density), str(frames), pfile], text=True)
    cpp = [json.loads(l) for l in out.strip().splitlines()]
    assert len(cpp) == frames

    sim = FlipSim(scene)
    # same particles (seed_particles is deterministic, but assert anyway)
    np.testing.assert_array_equal(np.asarray(sim.state.pos), pos)

    ours = []
    for _ in range(frames):
        m = sim.step()
        ours.append((float(m["kinetic_energy"]), float(m["dt"])))

    ke_cpp = np.asarray([r["ke"] for r in cpp])
    ke_py = np.asarray([k for k, _ in ours])

    # free fall (pre-impact): traces must agree tightly
    fall = slice(0, 8)
    rel = np.abs(ke_py[fall] - ke_cpp[fall]) / np.maximum(ke_cpp[fall], 1.0)
    assert rel.max() < 0.05, f"free-fall KE mismatch: {rel}"

    # through impact/splash: allow solver-divergence growth but the traces
    # must stay the same order of magnitude and correlated
    full_rel = np.abs(ke_py - ke_cpp) / np.maximum(ke_cpp, 1.0)
    assert np.median(full_rel) < 0.25, f"KE drift: {full_rel}"
    c = np.corrcoef(ke_py, ke_cpp)[0, 1]
    assert c > 0.99, f"KE traces decorrelated: r={c}"


def test_mpm_ke_trace_matches_cpp_port(tmp_path, ref_mpm):
    """MPM counterpart (``native/ref_mpm.cc``) on the headline cone scene.

    MPM parity is *much* tighter than FLIP's because the frame has a single
    well-converged CG (rtol 1e-6) instead of the reference's loose 0.1 outer
    loop: the full 120-frame run measures median rel KE err 5.6e-5
    (docs/mpm_parity_cone.json); the 12-frame CI check allows 10x slack.
    """
    from fluidsim_tpu.models.mpm import MpmSim

    frames = 12
    sim = MpmSim("mpm_cone", density=100.0)
    pos = np.asarray(sim.state.pos, np.float32)
    pfile = str(tmp_path / "particles.f32")
    np.ascontiguousarray(pos).tofile(pfile)

    out = subprocess.check_output(
        [ref_mpm, "15", "100", str(frames), pfile], text=True)
    cpp = [json.loads(l) for l in out.strip().splitlines()
           if l.startswith("{")]
    assert len(cpp) == frames

    ke_py, dt_py = [], []
    for _ in range(frames):
        m = sim.step()
        ke_py.append(float(m["kinetic_energy"]))
        dt_py.append(float(m["dt"]))

    ke_cpp = np.asarray([r["ke"] for r in cpp])
    ke_py = np.asarray(ke_py)
    rel = np.abs(ke_py - ke_cpp) / np.maximum(ke_cpp, 1.0)
    assert np.median(rel) < 5e-4, f"MPM KE mismatch: {rel}"
    assert rel.max() < 5e-3, f"MPM KE mismatch: {rel}"
    np.testing.assert_allclose(dt_py, [r["dt"] for r in cpp], rtol=1e-4)
