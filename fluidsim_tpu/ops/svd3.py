"""Batched 3x3 SVD, polar decomposition, and corotated stress.

Replaces the reference's per-particle ``Eigen::JacobiSVD`` calls
(``deformHeader.h:22-36``, ``mpm.cc:545-555``) with batched ``jnp`` ops, and
the hand-derived rotation differential (``getDelR``,
``deformHeader.h:133-147``) with a ``custom_jvp`` on the polar rotation —
which is exactly what makes ``jax.jvp`` of the grid-force function reproduce
the reference's analytic force Hessian (``dPsydFdF``/``getdPsydx2``,
``deformHeader.h:241-272``) without assembling anything.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp



def mm3(a, b):
    """Batched 3x3 matmul, unrolled to f32 elementwise ops.  A bare ``@``
    runs at DEFAULT precision, which may be reduced precision (TF32 on the
    H100, ~1e-3 relative error); reduced-precision products of the SVD
    outputs once wrecked MPM's C++-oracle KE parity (0.6 median vs 1e-4).
    Every product in this module goes through here."""
    return jnp.stack(
        [jnp.stack([a[..., i, 0] * b[..., 0, j]
                    + a[..., i, 1] * b[..., 1, j]
                    + a[..., i, 2] * b[..., 2, j]
                    for j in range(3)], axis=-1)
         for i in range(3)], axis=-2)


def mv3(a, x):
    """Batched 3x3 @ 3-vector, unrolled (see ``mm3``)."""
    return jnp.stack([a[..., i, 0] * x[..., 0] + a[..., i, 1] * x[..., 1]
                      + a[..., i, 2] * x[..., 2] for i in range(3)], axis=-1)

def _rot_apply(a, v, p: int, q: int, c, s):
    """Apply the Givens rotation J(p,q; c,s) as A <- J^T A J, V <- V J,
    all in batched elementwise ops (A symmetric (...,3,3)): ~30 flops,
    no matrix unit involved (see ops/smallmat.py)."""
    r = 3 - p - q
    app, aqq, apq = a[..., p, p], a[..., q, q], a[..., p, q]
    arp, arq = a[..., r, p], a[..., r, q]
    app_n = c * c * app - 2.0 * s * c * apq + s * s * aqq
    aqq_n = s * s * app + 2.0 * s * c * apq + c * c * aqq
    arp_n = c * arp - s * arq
    arq_n = s * arp + c * arq
    zero = jnp.zeros_like(app)
    ent = {(p, p): app_n, (q, q): aqq_n, (r, r): a[..., r, r],
           (p, q): zero, (q, p): zero,
           (r, p): arp_n, (p, r): arp_n, (r, q): arq_n, (q, r): arq_n}
    a_n = jnp.stack([jnp.stack([ent[(i, j)] for j in range(3)], axis=-1)
                     for i in range(3)], axis=-2)
    vp, vq = v[..., :, p], v[..., :, q]
    cn, sn = c[..., None], s[..., None]
    vp_n = cn * vp - sn * vq
    vq_n = sn * vp + cn * vq
    cols = [v[..., :, 0], v[..., :, 1], v[..., :, 2]]
    cols[p], cols[q] = vp_n, vq_n
    return a_n, jnp.stack(cols, axis=-1)


def _jacobi_eigh3(a, sweeps: int = 5):
    """Batched symmetric 3x3 eigendecomposition by UNROLLED cyclic Jacobi
    (no data-dependent control flow — ``jnp.linalg`` routines lower to
    iterative loops; five unrolled sweeps reach f32 machine precision).
    Returns (w, V) with A ~= V diag(w) V^T, V orthogonal."""
    v = jnp.broadcast_to(jnp.eye(3, dtype=a.dtype), a.shape)
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            apq = a[..., p, q]
            diff = a[..., q, q] - a[..., p, p]
            # tan(2 theta) = 2 apq / diff, robust small-angle form
            safe = jnp.where(jnp.abs(apq) > 0, apq, 1.0)
            tau = diff / (2.0 * safe)
            # tau == 0 (equal diagonal) takes the full 45-degree rotation:
            # sign(0) would skip it while the update still zeroes apq by
            # construction, silently deleting off-diagonal mass
            sgn = jnp.where(tau >= 0, 1.0, -1.0)
            t = sgn / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
            t = jnp.where(jnp.abs(apq) > 0, t, 0.0)
            c = 1.0 / jnp.sqrt(1.0 + t * t)
            a, v = _rot_apply(a, v, p, q, c, t * c)
    return jnp.stack([a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]], axis=-1), v


def _sort_desc3(w, v):
    """Descending 3-element sort network on eigenvalues, permuting V's
    columns along."""
    cols = [v[..., :, 0], v[..., :, 1], v[..., :, 2]]
    ws = [w[..., 0], w[..., 1], w[..., 2]]
    for i, j in ((0, 1), (0, 2), (1, 2)):
        sw = ws[i] < ws[j]
        ws[i], ws[j] = (jnp.where(sw, ws[j], ws[i]),
                        jnp.where(sw, ws[i], ws[j]))
        cols[i], cols[j] = (jnp.where(sw[..., None], cols[j], cols[i]),
                            jnp.where(sw[..., None], cols[i], cols[j]))
    return jnp.stack(ws, axis=-1), jnp.stack(cols, axis=-1)


def _cross(a, b):
    return jnp.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                      a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                      a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], axis=-1)


def _unit(x, fallback):
    n = jnp.sqrt(jnp.sum(x * x, axis=-1, keepdims=True))
    ok = n > 1e-20
    return jnp.where(ok, x / jnp.where(ok, n, 1.0), fallback)


def svd3(F):
    """Batched closed-form SVD of (..., 3, 3): eigendecomposition of F^T F
    by unrolled Jacobi, U from F V / s with orthonormal completion for
    (near-)singular values.  Same contract as
    ``jnp.linalg.svd(F, full_matrices=False)``: s >= 0 descending, U/V
    orthogonal with ``det(U V^T) = sign(det F)`` (Eigen::JacobiSVD
    semantics — ``deformHeader.h:22-36`` takes R = U V^T unmodified)."""
    a = mm3(jnp.swapaxes(F, -1, -2), F)
    w, v = _jacobi_eigh3(a)
    w, v = _sort_desc3(w, v)
    s = jnp.sqrt(jnp.clip(w, 0.0, None))

    # proper V (det +1): the sort's column swaps flip the determinant;
    # eigenvector signs are free, so flip the last column to compensate
    # (keeps u2 = sign(det F) * u0 x u1 exact below)
    detv = det3(v)
    v = v.at[..., :, 2].multiply(jnp.where(detv < 0, -1.0, 1.0)[..., None])

    # U columns: F v_i = s_i u_i.  u0 from F v0; u1 by Gram-Schmidt of
    # F v1 against u0 (exact in exact math, cleans f32 rounding, and
    # degrades gracefully to SOME unit vector orthogonal to u0 when
    # s1 ~ 0, where the column is arbitrary anyway); u2 exactly as
    # sign(det F) * u0 x u1 (det V = +1, s >= 0).  No division by s, so
    # near-singular values need no thresholds.
    fv = mm3(F, v)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=F.dtype), F.shape)
    u0 = _unit(fv[..., :, 0], eye[..., :, 0])
    f1 = fv[..., :, 1]
    g1 = f1 - jnp.sum(u0 * f1, axis=-1, keepdims=True) * u0
    # rank-1 fallback: cross u0 with the axis least aligned with it
    k = jnp.argmin(jnp.abs(u0), axis=-1)
    ek = jax.nn.one_hot(k, 3, dtype=F.dtype)
    u1_fb = _unit(_cross(u0, ek), eye[..., :, 1])
    n1 = jnp.sqrt(jnp.sum(g1 * g1, axis=-1, keepdims=True))
    ok1 = n1 > 1e-12 * jnp.maximum(s[..., 0:1], 1e-30)
    u1 = jnp.where(ok1, g1 / jnp.where(ok1, n1, 1.0), u1_fb)
    sgn = jnp.where(det3(F) < 0, -1.0, 1.0)[..., None]
    u2 = sgn * _unit(_cross(u0, u1), eye[..., :, 2])

    u = jnp.stack([u0, u1, u2], axis=-1)
    return u, s, jnp.swapaxes(v, -1, -2)


def svd3_xla(F):
    """The ``jnp.linalg.svd`` route (iterative) — kept as the
    cross-validation oracle for ``svd3``."""
    return jnp.linalg.svd(F, full_matrices=False)


@jax.custom_jvp
def polar_rotation(F):
    """R = U V^T (``getR``, ``deformHeader.h:22-28``), batched (..., 3, 3)."""
    U, _, Vt = svd3(F)
    return mm3(U, Vt)


def polar_rs(F):
    """(R, S) of the polar decomposition F = R S (one SVD)."""
    U, s, Vt = svd3(F)
    R = mm3(U, Vt)
    V = jnp.swapaxes(Vt, -1, -2)
    S = mm3(V, s[..., :, None] * Vt)
    return R, S


def polar_delta(R, S, dF):
    """Rotation differential dR for a perturbation dF of F = R S — the 3x3
    skew system of ``getDelR`` (``deformHeader.h:133-147``): ``R^T dF -
    dF^T R`` is skew; solve ``M x = [rhs01, rhs02, rhs12]`` with ``M`` built
    from S, then ``dR = R @ skew(x)``.  Linear in ``dF``.

    The 3x3 solve uses the closed-form adjugate inverse (M is symmetric and
    well-conditioned away from degenerate S).
    """
    rhs = (mm3(jnp.swapaxes(R, -1, -2), dF)
           - mm3(jnp.swapaxes(dF, -1, -2), R))
    v = jnp.stack([rhs[..., 0, 1], rhs[..., 0, 2], rhs[..., 1, 2]], axis=-1)
    m = jnp.stack([
        jnp.stack([S[..., 0, 0] + S[..., 1, 1], S[..., 1, 2], -S[..., 0, 2]], axis=-1),
        jnp.stack([S[..., 1, 2], S[..., 0, 0] + S[..., 2, 2], S[..., 0, 1]], axis=-1),
        jnp.stack([-S[..., 0, 2], S[..., 0, 1], S[..., 1, 1] + S[..., 2, 2]], axis=-1),
    ], axis=-2)
    det = det3(m)
    minv = jnp.swapaxes(cofactor3(m), -1, -2) / jnp.where(
        det != 0, det, 1.0)[..., None, None]
    x = mv3(minv, v)
    zeros = jnp.zeros_like(x[..., 0])
    k = jnp.stack([
        jnp.stack([zeros, x[..., 0], x[..., 1]], axis=-1),
        jnp.stack([-x[..., 0], zeros, x[..., 2]], axis=-1),
        jnp.stack([-x[..., 1], -x[..., 2], zeros], axis=-1),
    ], axis=-2)
    return mm3(R, k)


@polar_rotation.defjvp
def _polar_rotation_jvp(primals, tangents):
    """dR via ``polar_delta`` (linear in dF, so JAX can transpose it)."""
    (F,), (dF,) = primals, tangents
    R, S = polar_rs(F)
    return R, polar_delta(R, S, dF)


def det3(F):
    """Batched determinant of (..., 3, 3)."""
    return (F[..., 0, 0] * (F[..., 1, 1] * F[..., 2, 2] - F[..., 1, 2] * F[..., 2, 1])
            - F[..., 0, 1] * (F[..., 1, 0] * F[..., 2, 2] - F[..., 1, 2] * F[..., 2, 0])
            + F[..., 0, 2] * (F[..., 1, 0] * F[..., 2, 1] - F[..., 1, 1] * F[..., 2, 0]))


def cofactor3(F):
    """J F^{-T} as the cofactor matrix (``getJFmt``, ``deformHeader.h:227-239``)."""
    c = jnp.stack([
        jnp.stack([F[..., 1, 1] * F[..., 2, 2] - F[..., 1, 2] * F[..., 2, 1],
                   F[..., 1, 2] * F[..., 2, 0] - F[..., 1, 0] * F[..., 2, 2],
                   F[..., 1, 0] * F[..., 2, 1] - F[..., 1, 1] * F[..., 2, 0]], axis=-1),
        jnp.stack([F[..., 0, 2] * F[..., 2, 1] - F[..., 0, 1] * F[..., 2, 2],
                   F[..., 0, 0] * F[..., 2, 2] - F[..., 0, 2] * F[..., 2, 0],
                   F[..., 0, 1] * F[..., 2, 0] - F[..., 0, 0] * F[..., 2, 1]], axis=-1),
        jnp.stack([F[..., 0, 1] * F[..., 1, 2] - F[..., 0, 2] * F[..., 1, 1],
                   F[..., 0, 2] * F[..., 1, 0] - F[..., 0, 0] * F[..., 1, 2],
                   F[..., 0, 0] * F[..., 1, 1] - F[..., 0, 1] * F[..., 1, 0]], axis=-1),
    ], axis=-2)
    return c


def piola_corotated(F, mu, lam):
    """First Piola-Kirchhoff stress of the fixed-corotated energy:
    ``P = 2 mu (F - R) + lambda (J - 1) J F^{-T}``.

    With ``sigma = P @ F0^T`` this reproduces ``getSigma``
    (``deformHeader.h:273-313``): ``2mu(FE-R)FE^T + lambda(Je-1)Je I``.
    Differentiating through it (polar_rotation has a custom JVP) reproduces
    ``dPsydFdF`` (``deformHeader.h:241-249``).
    """
    R = polar_rotation(F)
    J = det3(F)
    cof = cofactor3(F)
    return (2.0 * mu[..., None, None] * (F - R)
            + (lam * (J - 1.0))[..., None, None] * cof)


def piola_linearized(FE, mu, lam, hessian: str = "full"):
    """Precompute the corotated Piola stress P0 at FE plus a *linear*
    differential closure dP(dF) — one SVD total, hoisted out of the implicit
    solve (the naive route re-ran the SVD + its JVP inside every CG matvec).

    ``hessian="full"`` matches ``dPsydFdF`` (``deformHeader.h:241-249``):
    ``2 mu dF - 2 mu dR + lam (cof:dF) cof + lam (J-1) dcof``.

    ``hessian="spd"`` keeps only the POSITIVE-SEMIDEFINITE Gauss-Newton part
    ``2 mu dF + lam (cof:dF) cof`` (quadratic form 2mu|dF|^2 +
    lam (cof:dF)^2 >= 0).  The dropped terms — ``-2 mu dR`` and
    ``lam (J-1) dcof`` — are exactly what makes the corotated Hessian
    indefinite under strong compression (J < 1), i.e. at impact, where the
    measured 127^3 anatomy shows CG stagnating into its 1000-iteration cap
    (frame 114 of the cone).  With the SPD operator,
    ``A = I + beta dt^2 H/m`` has spectrum >= 1, so CG is unconditionally
    convergent and the semi-implicit update cannot amplify ``b``.  P0 (the
    explicit force) is exact in both modes; only the implicit operator is
    approximated (a Gauss-Newton step instead of a full Newton step for the
    same backward-Euler-weighted system).
    """
    R, S = polar_rs(FE)
    J = det3(FE)
    cof = cofactor3(FE)
    P0 = (2.0 * mu[..., None, None] * (FE - R)
          + (lam * (J - 1.0))[..., None, None] * cof)

    def dP_full(dF):
        dR = polar_delta(R, S, dF)
        _, dcof = jax.jvp(cofactor3, (FE,), (dF,))   # polynomial jvp: cheap
        cof_dF = jnp.einsum("...ij,...ij->...", cof, dF,
                            precision=jax.lax.Precision.HIGHEST)
        return (2.0 * mu[..., None, None] * (dF - dR)
                + lam[..., None, None] * (cof_dF[..., None, None] * cof
                                          + (J - 1.0)[..., None, None] * dcof))

    def dP_spd(dF):
        cof_dF = jnp.einsum("...ij,...ij->...", cof, dF,
                            precision=jax.lax.Precision.HIGHEST)
        return (2.0 * mu[..., None, None] * dF
                + lam[..., None, None] * cof_dF[..., None, None] * cof)

    return P0, (dP_spd if hessian == "spd" else dP_full)


def hardening(mu0, lam0, eps, Jp, exponent_cap: float | None = None):
    """Exponential hardening (``getSigma``, ``deformHeader.h:275-277``):
    ``mu = mu0 exp(eps (1 - Jp))`` and likewise for lambda.

    ``exponent_cap`` clamps the exponent (a stabiliser beyond the reference:
    runaway plasticity with Jp far from 1 otherwise produces e^40-scale
    stiffness and NaNs; healthy trajectories keep the exponent in [-2, 2]).
    """
    e = eps * (1.0 - Jp)
    if exponent_cap is not None:
        e = jnp.clip(e, -exponent_cap, exponent_cap)
    h = jnp.exp(e)
    return mu0 * h, lam0 * h


def clamp_singular(F, minv, maxv):
    """SVD singular-value clamp (``mpm.cc:545-555``): returns (FE, Vsinv_Ut)
    where ``FE = U clamp(S) V^T`` and ``Vsinv_Ut = V clamp(S)^{-1} U^T``
    (used for ``FP = Vsinv_Ut @ F``)."""
    U, s, Vt = svd3(F)
    sc = jnp.clip(s, minv, maxv)
    fe = mm3(U, sc[..., :, None] * Vt)
    v_sinv_ut = mm3(jnp.swapaxes(Vt, -1, -2),
                    jnp.swapaxes(U, -1, -2) / sc[..., :, None])
    return fe, v_sinv_ut
