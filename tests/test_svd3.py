"""Tests for batched 3x3 SVD / polar / corotated stress (ops.svd3), checked
against numerical differentiation — the oracle for the custom-JVP rotation
that replaces ``deformHeader.h:133-147``."""

import numpy as np
import jax
import jax.numpy as jnp

from fluidsim_tpu.ops.svd3 import (
    svd3, polar_rotation, det3, cofactor3, piola_corotated, hardening,
    clamp_singular)


def _random_f(n=8, scale=0.3, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(np.eye(3) + scale * rng.normal(size=(n, 3, 3)),
                       jnp.float32)


def test_polar_rotation_orthogonal():
    F = _random_f()
    R = polar_rotation(F)
    eye = np.broadcast_to(np.eye(3), R.shape)
    np.testing.assert_allclose(np.asarray(R @ jnp.swapaxes(R, -1, -2)), eye,
                               atol=1e-5)
    # R is the closest rotation: S = R^T F symmetric
    S = jnp.swapaxes(R, -1, -2) @ F
    np.testing.assert_allclose(np.asarray(S), np.asarray(jnp.swapaxes(S, -1, -2)),
                               atol=1e-5)


def test_polar_jvp_matches_numerical():
    F = _random_f(4)
    rng = np.random.default_rng(1)
    dF = jnp.asarray(rng.normal(size=F.shape), jnp.float32)
    _, dR = jax.jvp(polar_rotation, (F,), (dF,))
    h = 1e-3
    num = (np.asarray(polar_rotation(F + h * dF), np.float64)
           - np.asarray(polar_rotation(F - h * dF), np.float64)) / (2 * h)
    np.testing.assert_allclose(np.asarray(dR), num, atol=2e-2, rtol=2e-2)


def test_polar_grad_of_corotated_energy():
    # Psi = mu ||F - R||^2 + lam/2 (J-1)^2; since <F - R, dR> = 0, the exact
    # gradient is P = 2mu(F-R) + lam(J-1) J F^{-T}. jax.grad must agree —
    # this exercises the custom JVP through transposition.
    mu, lam = 1.7, 2.3

    def psi(F):
        R = polar_rotation(F)
        J = det3(F)
        return jnp.sum((F - R) ** 2) * mu + 0.5 * lam * jnp.sum((J - 1.0) ** 2)

    F = _random_f(4, seed=2)
    gr = jax.grad(lambda f: jnp.sum(psi(f)))(F)
    p = piola_corotated(F, jnp.full(F.shape[:1], mu), jnp.full(F.shape[:1], lam))
    np.testing.assert_allclose(np.asarray(gr), np.asarray(p), atol=1e-3, rtol=1e-3)


def test_det_and_cofactor():
    F = _random_f(6, seed=3)
    np.testing.assert_allclose(np.asarray(det3(F)),
                               np.linalg.det(np.asarray(F)), rtol=1e-4)
    # cof(F) = J F^{-T}
    J = np.linalg.det(np.asarray(F, np.float64))
    finv_t = np.linalg.inv(np.asarray(F, np.float64)).transpose(0, 2, 1)
    np.testing.assert_allclose(np.asarray(cofactor3(F)),
                               J[:, None, None] * finv_t, rtol=1e-3, atol=1e-4)


def test_sigma_matches_reference_form():
    # getSigma (deformHeader.h:273-313): 2mu(FE-R)FE^T + lam(Je-1)Je I
    F = _random_f(5, seed=4)
    mu = jnp.asarray([1.0, 2.0, 0.5, 3.0, 1.5], jnp.float32)
    lam = jnp.asarray([2.0, 1.0, 1.5, 0.5, 3.0], jnp.float32)
    sigma = piola_corotated(F, mu, lam) @ jnp.swapaxes(F, -1, -2)
    R = polar_rotation(F)
    J = det3(F)
    ref = (2 * mu[:, None, None] * (F - R) @ jnp.swapaxes(F, -1, -2)
           + (lam * (J - 1) * J)[:, None, None] * jnp.eye(3))
    np.testing.assert_allclose(np.asarray(sigma), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


def test_hardening():
    mu, lam = hardening(10.0, 20.0, 10.0, jnp.asarray([1.0, 0.9]))
    np.testing.assert_allclose(np.asarray(mu), [10.0, 10.0 * np.exp(1.0)],
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(lam), [20.0, 20.0 * np.exp(1.0)],
                               rtol=1e-5)


def test_svd3_stress_cases():
    """Closed-form svd3 vs numpy f64 SVD across regimes: random,
    near-identity, tiny-singular-value, rank-1, zero, reflections, large
    deformation.  Orthogonality is strict everywhere; reconstruction /
    singular values are f32-tight except rank-deficient inputs, where the
    F^T F squaring costs ~sqrt(eps_f32) (the spurious values carry no
    physical weight — MPM keeps det F near 1)."""
    rng = np.random.default_rng(0)
    cases = [
        ("random", np.eye(3) + 0.3 * rng.normal(size=(512, 3, 3)), 2e-5),
        ("near-id", np.eye(3) + 1e-4 * rng.normal(size=(256, 3, 3)), 2e-5),
        ("tiny-s2", rng.normal(size=(256, 3, 3))
         * np.array([1, 1, 1e-7])[None, None, :], 2e-5),
        ("rank-1", np.einsum("bi,bj->bij", rng.normal(size=(128, 3)),
                             rng.normal(size=(128, 3))), 5e-4),
        ("zero", np.zeros((4, 3, 3)), 2e-5),
        ("reflect", -np.eye(3)[None] + 0.1 * rng.normal(size=(128, 3, 3)),
         2e-5),
        ("large", np.eye(3) + 0.99 * rng.normal(size=(512, 3, 3)), 1e-4),
    ]
    eye = np.eye(3)
    for name, m, tol in cases:
        F = jnp.asarray(m, jnp.float32)
        U, s, Vt = svd3(F)
        scale = max(1.0, np.abs(m).max())
        rec = np.asarray(U @ (s[..., :, None] * Vt), np.float64)
        assert np.abs(rec - np.asarray(F, np.float64)).max() / scale < tol, name
        assert np.abs(np.asarray(U @ jnp.swapaxes(U, -1, -2),
                                 np.float64) - eye).max() < 5e-5, name
        assert np.abs(np.asarray(jnp.swapaxes(Vt, -1, -2) @ Vt,
                                 np.float64) - eye).max() < 5e-5, name
        s_ref = np.linalg.svd(np.asarray(m, np.float64), compute_uv=False)
        assert np.abs(np.asarray(s, np.float64) - s_ref).max() / scale < tol, name
        assert (np.asarray(s) >= 0).all() and (
            np.diff(np.asarray(s), axis=-1) <= 1e-6).all(), name


def test_clamp_singular_bounds_and_reconstruction():
    F = _random_f(8, scale=0.6, seed=5)
    minv, maxv = 1 - 0.025, 1 + 0.0075
    fe, v_sinv_ut = clamp_singular(F, minv, maxv)
    _, s, _ = svd3(fe)
    assert (np.asarray(s) >= minv - 1e-4).all()
    assert (np.asarray(s) <= maxv + 1e-4).all()
    # FP update invariant (mpm.cc:554-555): FE @ (V S^-1 U^T @ F) == F when
    # nothing clamps; in general FE @ v_sinv_ut @ F preserves F:
    # U S* V^T  @  V S*^-1 U^T @ F = F.
    recon = fe @ v_sinv_ut @ F
    np.testing.assert_allclose(np.asarray(recon), np.asarray(F),
                               rtol=1e-3, atol=1e-3)


def test_no_default_precision_matmuls_in_physics_modules():
    """Regression guard for the TF32 hazard on the H100: a bare ``@`` (or a
    default-precision einsum) on f32 operands may run on the tensor cores
    in TF32, which keeps about three decimal digits (~1e-3 relative
    error).  Reduced-precision products of that kind once corrupted the
    MPM deformation-gradient update until the C++-oracle parity run caught
    it.  Physics modules must route small products through
    ``svd3.mm3``/``mv3`` (unrolled elementwise) or pin a precision."""
    import pathlib
    import re

    root = pathlib.Path(__file__).resolve().parent.parent / "fluidsim_tpu"
    physics = ["models/flip.py", "models/mpm.py", "ops/svd3.py",
               "ops/apic.py", "ops/mpm_fast.py", "ops/smallmat.py",
               "ops/transfer.py", "ops/transfer_fast.py",
               "ops/pressure.py", "ops/pcg.py",
               "parallel/flip_sharded.py", "parallel/mpm_sharded.py"]
    offenders = []
    for rel in physics:
        src = (root / rel).read_text()
        # strip comments/docstrings crudely: drop comment tails and
        # triple-quoted blocks
        src = re.sub(r'"""[\s\S]*?"""', "", src)
        src = "\n".join(line.split("#")[0] for line in src.splitlines())
        for i, line in enumerate(src.splitlines(), 1):
            if re.search(r"[\w\])]\s@\s[\w\[(]", line):
                offenders.append(f"{rel}:{i}: bare @ -> {line.strip()}")
        for m in re.finditer(r"jnp\.einsum\(([^)]*)\)", src, re.S):
            if "precision" not in m.group(1):
                offenders.append(f"{rel}: default-precision einsum -> "
                                 f"{m.group(1)[:60]}")
    assert not offenders, "\n".join(offenders)
