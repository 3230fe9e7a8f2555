"""MPM solver tests: force consistency, Hessian symmetry-by-construction,
elastic response, and end-to-end cone-drop behaviour."""

import numpy as np
import jax
import jax.numpy as jnp

from fluidsim_tpu.models.mpm import MpmSim, MpmParams, mpm_step, make_force_fn
from fluidsim_tpu.models.flip import FlipState  # noqa: F401 (pytree reg)
from fluidsim_tpu.scenes import get_scene


def _sim(scene="mpm_cone", **kw):
    return MpmSim(scene, **kw)


def test_initial_state():
    sim = _sim()
    assert sim.num_particles > 1000
    eye = np.broadcast_to(np.eye(3), (sim.num_particles, 3, 3))
    np.testing.assert_array_equal(np.asarray(sim.state.FE), eye)
    np.testing.assert_array_equal(np.asarray(sim.state.vel)[:, 1], -50.0)


def test_identity_fe_gives_zero_force():
    # With FE = FP = I the corotated stress vanishes -> zero explicit forces.
    sim = _sim()
    from fluidsim_tpu.models.mpm import _particle_nodes
    from fluidsim_tpu.ops.svd3 import hardening, det3
    p = sim.params
    n = 2 * p.bound + 1
    ids, inb, not_solid, w, gradw = _particle_nodes(
        sim.state.pos, sim.solid, p.bound)
    mu, lam = hardening(p.mu0, p.lam0, p.hardening_eps, det3(sim.state.FP))
    vol = jnp.full((sim.num_particles,), 0.02, jnp.float32)
    forces = make_force_fn(ids, inb, not_solid, gradw, sim.state.FE, vol,
                           mu, lam, n ** 3)
    f0 = forces(jnp.zeros((n ** 3, 3), jnp.float32))
    # lam ~ 2.6e5 so allow f32 roundoff scaled by the moduli
    assert float(jnp.max(jnp.abs(f0))) < 1e-2


def test_explicit_limit_matches_gravity():
    # beta = 0 turns the solve into the identity: with FE = I (zero force)
    # the grid velocity update is exactly v + dt*g, and particles pick up
    # ~dt*g via the FLIP delta (diluted only at the free surface).
    sim = _sim(params=MpmParams(beta=0.0))
    state, m = jax.jit(lambda s, st: mpm_step(sim.params, s, st))(
        sim.solid, sim.state)
    vy = np.asarray(state.vel)[:, 1]
    expected = -50.0 + float(m["dt_used"]) * (-10.0)
    np.testing.assert_allclose(np.median(vy), expected, atol=0.005)


def test_volume_positive_after_first_step():
    sim = _sim()
    sim.step()
    vol = np.asarray(sim.state.volume)
    assert (vol > 0).all()
    assert np.isfinite(vol).all()


def test_cone_drop_runs_and_plasticity_bounded():
    sim = _sim()
    for _ in range(10):
        m = sim.step()
    assert np.isfinite(float(m["kinetic_energy"]))
    # FP determinant stays positive and near 1 early in the fall
    assert float(m["min_det_fp"]) > 0.5
    assert float(m["max_det_fp"]) < 2.0
    pos = np.asarray(sim.state.pos)
    assert np.isfinite(pos).all()
    assert (np.abs(pos) <= sim.params.bound + 1).all()


def test_impact_produces_deformation():
    # v0 = -50, floor ~3 cells below the cone: impact within ~6 frames
    # (dt <= 0.001, CFL-limited to ~0.02/frame of travel). Run enough frames
    # and check FE departs from identity somewhere.
    sim = _sim()
    for _ in range(60):
        m = sim.step()
    fe = np.asarray(sim.state.FE)
    dev = np.abs(fe - np.eye(3)).max()
    assert dev > 1e-4, f"no deformation after impact (max dev {dev})"
    assert np.isfinite(fe).all()


def test_force_fn_against_direct_oracle():
    # Direct numpy evaluation of f_i = -sum_p V_p sigma_p gradW_i for a tiny
    # particle set, vs the batched scatter.  (Note: the reference kernel is
    # NOT a partition of unity, so total force does not vanish — no
    # momentum-free assertion is possible, matching the reference.)
    from fluidsim_tpu.models.mpm import _particle_nodes
    from fluidsim_tpu.ops.svd3 import hardening, det3, piola_corotated
    from fluidsim_tpu.core.splines import grad_w_mpm
    from fluidsim_tpu.scenes import get_scene

    scene = get_scene("mpm_cone")
    solid = jnp.asarray(scene.solid)
    B = scene.spec.bound
    n = 2 * B + 1
    rng = np.random.default_rng(0)
    pos = jnp.asarray(rng.uniform(-3, 3, size=(3, 3)), jnp.float32)
    fe = jnp.asarray(np.eye(3) + 0.05 * rng.normal(size=(3, 3, 3)), jnp.float32)
    fp = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (3, 3, 3))
    vol = jnp.asarray([0.01, 0.02, 0.03], jnp.float32)
    mu, lam = hardening(100.0, 200.0, 10.0, det3(fp))

    ids, inb, not_solid, w, gradw = _particle_nodes(pos, solid, B)
    forces = make_force_fn(ids, inb, not_solid, gradw, fe, vol, mu, lam, n ** 3)
    f0 = np.asarray(forces(jnp.zeros((n ** 3, 3), jnp.float32))).reshape(n, n, n, 3)

    sigma = np.asarray(piola_corotated(fe, mu, lam) @ jnp.swapaxes(fe, -1, -2))
    expected = np.zeros((n, n, n, 3))
    pos_np = np.asarray(pos, np.float64)
    for i in range(3):
        base = np.floor(np.abs(pos_np[i]) + 0.5) * np.sign(pos_np[i])
        for dx_ in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    c = base + [dx_, dy, dz]
                    _, gw = grad_w_mpm(jnp.asarray(pos_np[i] - c, jnp.float32))
                    f = -float(vol[i]) * sigma[i] @ np.asarray(gw)
                    ci = (c + B).astype(int)
                    expected[ci[0], ci[1], ci[2]] += f
    np.testing.assert_allclose(f0, expected, atol=1e-3, rtol=1e-3)


def test_matvec_linearity():
    # The JVP Hessian-vector product must be linear in its argument.
    sim = _sim()
    sim.step()  # populate volume
    state = sim.state
    from fluidsim_tpu.models.mpm import _particle_nodes
    from fluidsim_tpu.ops.svd3 import hardening, det3
    from fluidsim_tpu.ops import transfer
    p = sim.params
    n = 2 * p.bound + 1
    mass = transfer.p2g_mass(state.pos, sim.solid, p.bound, p.kernel)
    active = (mass > p.mass_threshold) & (~sim.solid)
    ids, inb, not_solid, w, gradw = _particle_nodes(state.pos, sim.solid, p.bound)
    mu, lam = hardening(p.mu0, p.lam0, p.hardening_eps, det3(state.FP))
    gather = active.reshape(-1)[ids] & inb
    forces = make_force_fn(ids, gather, not_solid, gradw, state.FE,
                           state.volume, mu, lam, n ** 3)
    z = jnp.zeros((n ** 3, 3), jnp.float32)
    rng = np.random.default_rng(1)
    w1 = jnp.asarray(rng.normal(size=(n ** 3, 3)), jnp.float32)
    w2 = jnp.asarray(rng.normal(size=(n ** 3, 3)), jnp.float32)
    _, d1 = jax.jvp(forces, (z,), (w1,))
    _, d2 = jax.jvp(forces, (z,), (w2,))
    _, d12 = jax.jvp(forces, (z,), (w1 + 2.0 * w2,))
    np.testing.assert_allclose(np.asarray(d12), np.asarray(d1 + 2.0 * d2),
                               atol=2e-2, rtol=1e-3)


def test_spd_hessian_positive_semidefinite():
    """The "spd" implicit operator (ops/svd3.py:piola_linearized) must give
    w^T (A - I) w >= 0 for arbitrary w at a DEFORMED state — the property
    the full corotated Hessian loses under compression (the measured cause
    of the impact-frame CG stagnation of the 127^3 cone)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from fluidsim_tpu.models.mpm import MpmSim, mpm_step

    rng = np.random.default_rng(5)
    sim = MpmSim("mpm_cone")
    # drive into a deformed state quickly: big downward velocity
    sim.state.vel = jnp.asarray(
        np.full((sim.num_particles, 3), [0.0, -80.0, 0.0], np.float32))
    for _ in range(30):
        sim.step()

    for hess, allow_negative in (("spd", False), ("full", True)):
        params = dataclasses.replace(sim.params, hessian=hess)
        # squeeze FE to strong compression so the full Hessian's indefinite
        # terms (-2 mu dR, lam (J-1) dcof) are active
        state = dataclasses.replace(
            sim.state, FE=sim.state.FE * 0.8)

        quad_signs = []
        for trial in range(5):
            key = jax.random.PRNGKey(trial)

            def quad_form(state=state, params=params, key=key):
                from fluidsim_tpu.models import mpm as M
                B = params.bound
                n = 2 * B + 1
                solid = sim.solid
                # rebuild the force linearization exactly as mpm_step does
                pos, vel = state.pos, state.vel
                from fluidsim_tpu.ops.svd3 import hardening, det3
                mu, lam = hardening(params.mu0, params.lam0,
                                    params.hardening_eps, det3(state.FP),
                                    exponent_cap=params.hardening_max)
                ids, inb, not_solid, w, gradw = M._particle_nodes(
                    pos, solid, B)
                volume = jnp.maximum(state.volume, 1e-6)
                mask = inb
                forces = M.make_force_fn(ids, mask, not_solid, gradw,
                                         state.FE, volume, mu, lam,
                                         n * n * n, hessian=params.hessian)
                wvec = jax.random.normal(key, (n * n * n, 3),
                                         dtype=jnp.float32)
                zeros = jnp.zeros_like(wvec)
                _, df = jax.jvp(forces, (zeros,), (wvec,))
                # u^T K u = -u . f (K = -dforce/du); normalize by |w|^2
                return -jnp.vdot(wvec, df) / jnp.vdot(wvec, wvec)

            quad_signs.append(float(quad_form()))

        if not allow_negative:
            assert all(q >= -1e-3 * max(abs(x) for x in quad_signs)
                       for q in quad_signs), (hess, quad_signs)


def test_jacobi_precond_same_solution():
    """precond="jacobi" changes the CG iteration path, never the solution
    bar (ops/pcg.py terminates on the TRUE residual): the reference-cone
    trajectory must match precond="none" to solver-noise tolerance."""
    import dataclasses

    from fluidsim_tpu.models.mpm import MpmSim

    kes = {}
    for pc in ("none", "jacobi"):
        sim = MpmSim("mpm_cone")
        sim = MpmSim("mpm_cone",
                     params=dataclasses.replace(sim.params, precond=pc))
        ke = []
        for _ in range(12):
            ke.append(float(sim.step()["kinetic_energy"]))
        kes[pc] = np.asarray(ke)
    rel = np.abs(kes["jacobi"] - kes["none"]) / np.maximum(
        np.abs(kes["none"]), 1e-9)
    assert rel.max() < 1e-3, rel


def test_hybrid_equals_full_while_cg_converges():
    """hessian="hybrid" must reproduce the "full" (reference-operator)
    trajectory exactly on frames where CG converges within cg_hybrid_cap —
    the lax.cond fallback only changes frames where the indefinite system
    stagnates (docs/mpm_deviation.json rationale)."""
    import dataclasses
    from functools import partial

    scene = get_scene("mpm_cone", bound=18, density=40.0)
    out = {}
    for hess in ("full", "hybrid"):
        sim = MpmSim(scene)
        sim.params = dataclasses.replace(sim.params, hessian=hess)
        sim._step = jax.jit(partial(mpm_step, sim.params),
                            donate_argnums=(1,))
        fallbacks = 0
        for _ in range(5):
            m = sim.step()
            fallbacks += int(m["spd_fallback"])
        out[hess] = (np.asarray(sim.state.pos),
                     np.asarray(sim.state.vel), fallbacks)

    assert out["hybrid"][2] == 0, "fallback unexpectedly triggered"
    np.testing.assert_allclose(out["hybrid"][0], out["full"][0],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(out["hybrid"][1], out["full"][1],
                               rtol=0, atol=1e-5)


def test_hybrid_falls_back_on_tiny_cap():
    """With cg_hybrid_cap=0 the full solve can never converge (cap < 1
    iteration while the warm-start residual is nonzero), so EVERY frame
    must take the SPD branch and still produce finite physics."""
    import dataclasses
    from functools import partial

    scene = get_scene("mpm_cone", bound=18, density=40.0)
    sim = MpmSim(scene)
    sim.params = dataclasses.replace(sim.params, hessian="hybrid",
                                     cg_hybrid_cap=0)
    sim._step = jax.jit(partial(mpm_step, sim.params), donate_argnums=(1,))
    fallbacks = 0
    for _ in range(3):
        m = sim.step()
        fallbacks += int(m["spd_fallback"])
    assert fallbacks == 3
    assert np.isfinite(float(m["kinetic_energy"]))
    assert np.isfinite(np.asarray(sim.state.pos)).all()
