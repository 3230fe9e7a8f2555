"""Finite-difference scheme family — ``openvdb/math/FiniteDifference.h`` as dense passes.

The reference ships a menu of first-derivative schemes (``DScheme``,
``FiniteDifference.h:59-77``: central 2nd/4th/6th order, one-sided
1st/2nd/3rd order, and 5th-order WENO / Hamilton-Jacobi WENO), biased
gradient selection (``BiasedGradientScheme``, ``:207-219``), TVD
Runge-Kutta temporal schemes (``TemporalIntegrationScheme``, ``:259-268``)
and the Godunov upwind norm (``GodunovsNormSqrd``, ``:353-374``), all as
per-voxel stencil accessors threaded over sparse-tree leaves.  Those feed
``tools::LevelSetAdvect``/``LevelSetTracker``'s scheme options.

Here each scheme is a whole-grid dense pass: edge-clamped shifted-array
arithmetic that XLA fuses into one HBM sweep per stencil (no
data-dependent control flow, so everything jits and vmaps).  Derivatives
are returned in physical units (divided by ``dx``), unlike the reference's
index-space ``D1::difference`` values; ``cd_2ndt``'s documented "result
must be divided by 2" quirk is preserved relative to ``cd_2nd``.

WENO formulas follow Jiang & Shu (and Shu, ICASE 97-65), the same source
the reference cites; the reference's stencil orientation (its forward
scheme feeds samples far-to-near, ``FiniteDifference.h`` ``D1<FD_WENO5>``/
``D1<FD_HJWENO5>``) and its regularization ``eps = 1e-6 * scale2`` with
default ``scale2 = 0.01`` are matched exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "DSCHEMES", "weno5", "d1", "biased_gradient", "godunov_norm_sqrd",
    "advect_hj", "tvd_rk", "shift_edge",
]


def shift_edge(a, d: int, s: int):
    """Shift so result[i] = a[i+s] along axis ``d``, edge-clamped (the
    reference's accessors read the tree background out of band; for the
    SDF/fog fields these schemes serve, repeating the boundary value is
    the faithful dense analogue — zero-background would create spurious
    interface gradients at the box faces)."""
    if s == 0:
        return a
    pad = [(0, 0)] * a.ndim
    sl = [slice(None)] * a.ndim
    if s > 0:
        pad[d] = (0, s)
        sl[d] = slice(s, None)
    else:
        pad[d] = (-s, 0)
        sl[d] = slice(0, s)
    return jnp.pad(a, pad, mode="edge")[tuple(sl)]


def weno5(v1, v2, v3, v4, v5, scale2: float = 0.01):
    """5th-order WENO flux interpolation (Shu, ICASE 97-65): given samples
    v1..v5 of f at x-2dx..x+2dx, returns f(x+dx/2) such that
    (f(x+dx/2) - f(x-dx/2))/dx = f'(x) + O(dx^5) in smooth regions.
    ``scale2`` is the squared reference magnitude of f entering the
    smoothness regularizer (reference default 0.01, ``FiniteDifference.h:332``).
    """
    c = 13.0 / 12.0
    eps = 1e-6 * scale2
    b1 = c * (v1 - 2.0 * v2 + v3) ** 2 + 0.25 * (v1 - 4.0 * v2 + 3.0 * v3) ** 2
    b2 = c * (v2 - 2.0 * v3 + v4) ** 2 + 0.25 * (v2 - v4) ** 2
    b3 = c * (v3 - 2.0 * v4 + v5) ** 2 + 0.25 * (3.0 * v3 - 4.0 * v4 + v5) ** 2
    a1 = 0.1 / (b1 + eps) ** 2
    a2 = 0.6 / (b2 + eps) ** 2
    a3 = 0.3 / (b3 + eps) ** 2
    num = (a1 * (2.0 * v1 - 7.0 * v2 + 11.0 * v3)
           + a2 * (-v2 + 5.0 * v3 + 2.0 * v4)
           + a3 * (2.0 * v3 + 5.0 * v4 - v5))
    return num / (6.0 * (a1 + a2 + a3))


def _d1_weno5(phi, d, dx, sign: int):
    # Reference orientation: the forward scheme feeds WENO5 far-to-near
    # (D1<FD_WENO5>::inX reads +3..-2), giving the downwind-biased
    # derivative (f^(i+1/2)-f^(i-1/2))/dx on the axis-reversed stencil;
    # the backward scheme is its mirror image negated (D1<BD_WENO5>).
    f = [shift_edge(phi, d, sign * s) for s in (3, 2, 1, 0, -1, -2)]
    return sign * (weno5(f[0], f[1], f[2], f[3], f[4])
                   - weno5(f[1], f[2], f[3], f[4], f[5])) / dx


def _d1_hjweno5(phi, d, dx, sign: int):
    # HJ-WENO on the stencil's consecutive first differences
    # (D1<FD_HJWENO5>::difference); backward = mirrored and negated.
    f = [shift_edge(phi, d, sign * s) for s in (3, 2, 1, 0, -1, -2)]
    return sign * weno5(f[0] - f[1], f[1] - f[2], f[2] - f[3],
                        f[3] - f[4], f[4] - f[5]) / dx


# name -> derivative function of (phi, axis, dx); per-dx physical units.
DSCHEMES = {
    "cd_2ndt": lambda p, d, dx: (shift_edge(p, d, 1) - shift_edge(p, d, -1)) / dx,
    "cd_2nd": lambda p, d, dx: (shift_edge(p, d, 1) - shift_edge(p, d, -1)) / (2 * dx),
    "cd_4th": lambda p, d, dx: (8.0 * (shift_edge(p, d, 1) - shift_edge(p, d, -1))
                                - (shift_edge(p, d, 2) - shift_edge(p, d, -2))) / (12 * dx),
    "cd_6th": lambda p, d, dx: (45.0 * (shift_edge(p, d, 1) - shift_edge(p, d, -1))
                                - 9.0 * (shift_edge(p, d, 2) - shift_edge(p, d, -2))
                                + (shift_edge(p, d, 3) - shift_edge(p, d, -3))) / (60 * dx),
    "fd_1st": lambda p, d, dx: (shift_edge(p, d, 1) - p) / dx,
    "fd_2nd": lambda p, d, dx: (-3.0 * p + 4.0 * shift_edge(p, d, 1)
                                - shift_edge(p, d, 2)) / (2 * dx),
    "fd_3rd": lambda p, d, dx: (shift_edge(p, d, 3) / 3.0 - 1.5 * shift_edge(p, d, 2)
                                + 3.0 * shift_edge(p, d, 1) - (11.0 / 6.0) * p) / dx,
    "fd_weno5": lambda p, d, dx: _d1_weno5(p, d, dx, +1),
    "fd_hjweno5": lambda p, d, dx: _d1_hjweno5(p, d, dx, +1),
}
DSCHEMES["bd_1st"] = lambda p, d, dx: (p - shift_edge(p, d, -1)) / dx
DSCHEMES["bd_2nd"] = lambda p, d, dx: (3.0 * p - 4.0 * shift_edge(p, d, -1)
                                       + shift_edge(p, d, -2)) / (2 * dx)
DSCHEMES["bd_3rd"] = lambda p, d, dx: -(shift_edge(p, d, -3) / 3.0
                                        - 1.5 * shift_edge(p, d, -2)
                                        + 3.0 * shift_edge(p, d, -1)
                                        - (11.0 / 6.0) * p) / dx
DSCHEMES["bd_weno5"] = lambda p, d, dx: _d1_weno5(p, d, dx, -1)
DSCHEMES["bd_hjweno5"] = lambda p, d, dx: _d1_hjweno5(p, d, dx, -1)


def d1(phi, axis: int, dx: float = 1.0, scheme: str = "cd_2nd"):
    """First derivative of a dense scalar grid along ``axis`` with the
    named ``DScheme`` (``dsSchemeToString`` names, ``FiniteDifference.h:82-101``)."""
    try:
        fn = DSCHEMES[scheme]
    except KeyError:
        raise ValueError(f"unknown scheme {scheme!r}; one of {sorted(DSCHEMES)}")
    return fn(phi, axis, dx)


# BiasedGradientScheme -> (backward, forward) DScheme pair, as the
# reference's gradient-biased operators pair them (FIRST_BIAS..HJWENO5_BIAS,
# FiniteDifference.h:207-219).
_BIAS_PAIRS = {
    "first": ("bd_1st", "fd_1st"),
    "second": ("bd_2nd", "fd_2nd"),
    "third": ("bd_3rd", "fd_3rd"),
    "weno5": ("bd_weno5", "fd_weno5"),
    "hjweno5": ("bd_hjweno5", "fd_hjweno5"),
}


def biased_gradient(phi, direction, scheme: str = "first", dx: float = 1.0):
    """Upwind-biased gradient, ``(N,N,N,3)``: per component, picks the
    backward scheme where ``direction > 0`` (information flows from
    behind) and the forward scheme otherwise — the selection rule of
    ``math::GradientBiased`` / the level-set advect tools.  ``direction``
    is an ``(N,N,N,3)`` field (e.g. the advecting velocity)."""
    try:
        bd_name, fd_name = _BIAS_PAIRS[scheme]
    except KeyError:
        raise ValueError(f"unknown bias scheme {scheme!r}; one of {sorted(_BIAS_PAIRS)}")
    comps = []
    for d in range(3):
        gb = d1(phi, d, dx, bd_name)
        gf = d1(phi, d, dx, fd_name)
        comps.append(jnp.where(direction[..., d] > 0, gb, gf))
    return jnp.stack(comps, axis=-1)


def godunov_norm_sqrd(is_outside, grad_minus, grad_plus):
    """|∇φ|² with Godunov upwinding — ``math::GodunovsNormSqrd``
    (``FiniteDifference.h:353-374``).  ``is_outside`` is a boolean grid
    (φ > 0); ``grad_minus``/``grad_plus`` are ``(N,N,N,3)`` one-sided
    gradients (any scheme from this module)."""
    zero = jnp.zeros(())
    out = jnp.zeros(grad_minus.shape[:-1], grad_minus.dtype)
    inn = jnp.zeros_like(out)
    for d in range(3):
        dm, dp = grad_minus[..., d], grad_plus[..., d]
        out = out + jnp.maximum(jnp.maximum(dm, zero) ** 2,
                                jnp.minimum(dp, zero) ** 2)
        inn = inn + jnp.maximum(jnp.minimum(dm, zero) ** 2,
                                jnp.maximum(dp, zero) ** 2)
    return jnp.where(is_outside, out, inn)


def tvd_rk(phi, rhs_fn, dt, order: int = 3):
    """One TVD (strong-stability-preserving) Runge-Kutta step of
    ``φ_t = -rhs_fn(φ)`` — ``TemporalIntegrationScheme`` TVD_RK1/2/3
    (``FiniteDifference.h:259-268``), Shu–Osher convex combinations."""
    p1 = phi - dt * rhs_fn(phi)
    if order == 1:
        return p1
    p2_euler = p1 - dt * rhs_fn(p1)
    if order == 2:
        return 0.5 * phi + 0.5 * p2_euler
    if order != 3:
        raise ValueError("temporal order must be 1, 2 or 3")
    p2 = 0.75 * phi + 0.25 * p2_euler
    return (1.0 / 3.0) * phi + (2.0 / 3.0) * (p2 - dt * rhs_fn(p2))


def advect_hj(phi, vc, dt, spatial: str = "hjweno5", temporal: int = 3,
              dx: float = 1.0):
    """One Hamilton-Jacobi advection step ``φ_t + v·∇φ = 0`` with upwind
    spatial scheme ``spatial`` (a ``BiasedGradientScheme`` name) and
    TVD-RK``temporal`` time integration — the Eulerian scheme menu of
    ``tools::LevelSetAdvect`` (its ``EnrightField``/velocity-field
    advection with HJWENO5_BIAS + TVD_RK2 defaults), complementing the
    semi-Lagrangian path in ``ops/advect_volume.py``.

    ``vc``: cell-centred velocity ``(N,N,N,3)``.
    """
    def rhs(p):
        g = biased_gradient(p, vc, scheme=spatial, dx=dx)
        return jnp.sum(vc * g, axis=-1)

    return tvd_rk(phi, rhs, dt, order=temporal)
