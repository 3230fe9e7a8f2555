"""Multigrid V-cycle preconditioner tests."""

import numpy as np
import jax.numpy as jnp

from fluidsim_tpu.core.gridspec import GridSpec
from fluidsim_tpu.ops import pressure as pr
from fluidsim_tpu.ops.pcg import pcg, jacobi_preconditioner
from fluidsim_tpu.ops.multigrid import (mg_preconditioner, build_hierarchy,
                                        coarsen_masks, restrict, prolong)
from fluidsim_tpu.models.flip import FlipSim, FlipParams
from fluidsim_tpu.scenes import get_scene


def _system(bound=24, inner=15):
    spec = GridSpec(bound=bound, wall=bound - 2)
    solid = jnp.asarray(spec.wall_mask())
    fluid = jnp.asarray(spec.within_mask(inner)) & ~solid
    dt, rho, dx = 0.1, 1.0, 1.0
    adiag = pr.laplacian_diag(fluid, solid, dt, rho, dx)
    apply_a = lambda p: pr.apply_laplacian(p, adiag, fluid, dt, rho, dx)
    return spec, fluid, solid, adiag, apply_a, (dt, rho, dx)


def test_coarsen_masks():
    spec, fluid, solid, *_ = _system()
    fc, sc = coarsen_masks(fluid, solid)
    assert fc.shape[0] == (spec.n + 1) // 2
    assert bool(fc.any()) and bool(sc.any())
    assert not bool((fc & sc).any())


def test_restrict_prolong_adjoint():
    # <R r, e> == (1/8) <r, P e>   (P = piecewise-constant, R = block mean)
    rng = np.random.default_rng(0)
    r = jnp.asarray(rng.normal(size=(16, 16, 16)), jnp.float32)
    e = jnp.asarray(rng.normal(size=(8, 8, 8)), jnp.float32)
    lhs = float(jnp.sum(restrict(r) * e))
    rhs = float(jnp.sum(r * prolong(e, 16)) / 8.0)
    np.testing.assert_allclose(lhs, rhs, rtol=1e-5)


def test_mg_cuts_iterations_and_converges():
    spec, fluid, solid, adiag, apply_a, (dt, rho, dx) = _system()
    rng = np.random.default_rng(1)
    x_true = jnp.where(fluid, jnp.asarray(rng.normal(size=spec.shape),
                                          jnp.float32), 0)
    b = apply_a(x_true)
    res_j = pcg(apply_a, b, precond=jacobi_preconditioner(adiag, mask=fluid),
                rtol=1e-5, maxiter=500)
    res_m = pcg(apply_a, b, precond=mg_preconditioner(fluid, solid, dt, rho, dx),
                rtol=1e-5, maxiter=500)
    assert int(res_m.iters) < int(res_j.iters) // 3
    r = b - apply_a(res_m.x)
    rel = float(jnp.linalg.norm(r.ravel()) / jnp.linalg.norm(b.ravel()))
    assert rel < 2e-5


def test_mg_preconditioner_is_symmetric():
    spec, fluid, solid, adiag, apply_a, (dt, rho, dx) = _system()
    mg = mg_preconditioner(fluid, solid, dt, rho, dx)
    rng = np.random.default_rng(2)
    z1 = jnp.where(fluid, jnp.asarray(rng.normal(size=spec.shape), jnp.float32), 0)
    z2 = jnp.where(fluid, jnp.asarray(rng.normal(size=spec.shape), jnp.float32), 0)
    a1 = float(jnp.sum(mg(z1) * z2))
    a2 = float(jnp.sum(mg(z2) * z1))
    np.testing.assert_allclose(a1, a2, rtol=1e-4)


def test_flip_with_multigrid_matches_jacobi():
    scene = get_scene("water_cube_drop", bound=12, density=3.0)
    a = FlipSim(scene, params=FlipParams(bound=12, wall=10,
                                         preconditioner="multigrid"))
    b = FlipSim(scene, params=FlipParams(bound=12, wall=10,
                                         preconditioner="jacobi"))
    for _ in range(4):
        ma = a.step()
        mb = b.step()
        np.testing.assert_allclose(float(ma["kinetic_energy"]),
                                   float(mb["kinetic_energy"]), rtol=2e-3)


def test_chebyshev_cuts_iterations_and_converges():
    spec, fluid, solid, adiag, apply_a, (dt, rho, dx) = _system()
    from fluidsim_tpu.ops.pcg import chebyshev_preconditioner
    rng = np.random.default_rng(3)
    x_true = jnp.where(fluid, jnp.asarray(rng.normal(size=spec.shape),
                                          jnp.float32), 0)
    b = apply_a(x_true)
    jac = jacobi_preconditioner(adiag, mask=fluid)
    res_j = pcg(apply_a, b, precond=jac, rtol=1e-5, maxiter=500)
    res_c = pcg(apply_a, b,
                precond=chebyshev_preconditioner(apply_a, jac, degree=3),
                rtol=1e-5, maxiter=500)
    # degree-3 polynomial => ~4 applies per iteration => ~4x fewer iterations
    assert int(res_c.iters) <= int(res_j.iters) // 2
    r = b - apply_a(res_c.x)
    rel = float(jnp.linalg.norm(r.ravel()) / jnp.linalg.norm(b.ravel()))
    assert rel < 2e-5


def test_chebyshev_preconditioner_is_symmetric():
    spec, fluid, solid, adiag, apply_a, (dt, rho, dx) = _system()
    from fluidsim_tpu.ops.pcg import chebyshev_preconditioner
    jac = jacobi_preconditioner(adiag, mask=fluid)
    ch = chebyshev_preconditioner(apply_a, jac, degree=4)
    rng = np.random.default_rng(4)
    z1 = jnp.where(fluid, jnp.asarray(rng.normal(size=spec.shape), jnp.float32), 0)
    z2 = jnp.where(fluid, jnp.asarray(rng.normal(size=spec.shape), jnp.float32), 0)
    a1 = float(jnp.sum(ch(z1) * z2))
    a2 = float(jnp.sum(ch(z2) * z1))
    np.testing.assert_allclose(a1, a2, rtol=1e-4)


def test_flip_with_chebyshev_matches_jacobi():
    scene = get_scene("water_cube_drop", bound=12, density=3.0)
    a = FlipSim(scene, params=FlipParams(bound=12, wall=10,
                                         preconditioner="chebyshev"))
    b = FlipSim(scene, params=FlipParams(bound=12, wall=10,
                                         preconditioner="jacobi"))
    for _ in range(4):
        ma = a.step()
        mb = b.step()
        np.testing.assert_allclose(float(ma["kinetic_energy"]),
                                   float(mb["kinetic_energy"]), rtol=2e-3)
