"""Dense grid differential operators (GridOperators.h / math/Operators.h
analogs).

The reference vendors a full operator family in
``openvdb/tools/GridOperators.h`` (cpt, curl, divergence, gradient,
laplacian, meanCurvature, magnitude, normalize) built on the index-space
stencils of ``openvdb/math/Operators.h`` (``ISGradient<CD_2ND>``,
``ISLaplacian<CD_SECOND>``, ``ISDivergence``, ...).  The apps never call
them (SURVEY.md §2.2) but they are part of the library surface, so the
framework provides the same capability as fused dense-array
ops: every operator is a handful of shifted adds that XLA fuses into one
HBM pass, instead of a TBB leaf-node sweep.

Conventions:
  * all operators are index-space (divide by ``dx`` powers as documented)
    and use 2nd-order central differences, matching the reference's
    ``CD_2ND`` default;
  * arrays are dense ``(N, N, N)`` scalar or ``(N, N, N, 3)`` vector
    fields; out-of-box neighbor reads see the OpenVDB background (zero),
    exactly like the reference's ``ValueAccessor`` on an empty voxel;
  * everything is jit-safe and differentiable.
"""

from __future__ import annotations

import jax.numpy as jnp

from fluidsim_tpu.core.gridspec import shift_to_plus, shift_to_minus

__all__ = [
    "gradient", "divergence", "curl", "laplacian", "mean_curvature",
    "magnitude", "normalize", "closest_point_transform",
]


def _central(a, d, dx: float):
    """(a[c+e_d] - a[c-e_d]) / (2 dx) — ``ISGradient<CD_2ND>``."""
    return (shift_to_plus(a, d) - shift_to_minus(a, d)) / (2.0 * dx)


def gradient(f, dx: float = 1.0):
    """Central-difference gradient of a scalar field -> ``(N,N,N,3)``.

    Analog of ``tools::gradient`` (``openvdb/tools/GridOperators.h``).
    """
    return jnp.stack([_central(f, d, dx) for d in range(3)], axis=-1)


def divergence(v, dx: float = 1.0):
    """Central-difference divergence of a collocated vector field.

    Analog of ``tools::divergence``.  For MAC (staggered) fields the
    simulator uses the tighter two-point form in ``ops/pressure.py``;
    this is the collocated library operator.
    """
    return sum(_central(v[..., d], d, dx) for d in range(3))


def curl(v, dx: float = 1.0):
    """Central-difference curl of a collocated vector field.

    Analog of ``tools::curl``.
    """
    ddx = lambda comp, d: _central(v[..., comp], d, dx)
    return jnp.stack([
        ddx(2, 1) - ddx(1, 2),
        ddx(0, 2) - ddx(2, 0),
        ddx(1, 0) - ddx(0, 1),
    ], axis=-1)


def laplacian(f, dx: float = 1.0):
    """7-point Laplacian of a scalar field (``ISLaplacian<CD_SECOND>``).

    Analog of ``tools::laplacian``.  This is the plain operator; the
    pressure system's variable-coefficient Laplacian (free surface +
    solid cuts, ``fluid.cc:304-412``) lives in ``ops/pressure.py``.
    """
    acc = -6.0 * f
    for d in range(3):
        acc = acc + shift_to_plus(f, d) + shift_to_minus(f, d)
    return acc / (dx * dx)


def magnitude(v):
    """Per-cell Euclidean norm of a vector field (``tools::magnitude``)."""
    return jnp.sqrt(jnp.sum(v * v, axis=-1))


def normalize(v, eps: float = 1e-12):
    """Per-cell unit vectors; zero vectors stay zero (``tools::normalize``)."""
    m = magnitude(v)
    return v / jnp.maximum(m, eps)[..., None]


def mean_curvature(f, dx: float = 1.0, eps: float = 1e-12):
    """Mean curvature ``κ = (κ₁+κ₂)/2`` of the level sets of ``f``.

    Analog of ``tools::meanCurvature`` / ``math::MeanCurvature``: the
    OpenVDB convention is the *average* of the principal curvatures, i.e.
    ``div(∇f/|∇f|) / 2`` — a radius-``r`` sphere SDF gives ``1/r``.
    Computed from first and second central differences in one pass.
    """
    fx = [_central(f, d, dx) for d in range(3)]
    # second derivatives
    fxx = [(shift_to_plus(f, d) + shift_to_minus(f, d) - 2.0 * f) / (dx * dx)
           for d in range(3)]
    # mixed derivatives: central difference of the central difference
    fxy = _central(fx[0], 1, dx)
    fxz = _central(fx[0], 2, dx)
    fyz = _central(fx[1], 2, dx)
    gx, gy, gz = fx
    g2 = gx * gx + gy * gy + gz * gz
    num = (gx * gx * (fxx[1] + fxx[2]) +
           gy * gy * (fxx[0] + fxx[2]) +
           gz * gz * (fxx[0] + fxx[1]) -
           2.0 * (gx * gy * fxy + gx * gz * fxz + gy * gz * fyz))
    return num / (2.0 * jnp.maximum(g2, eps) ** 1.5)


def closest_point_transform(sdf, bound: int, dx: float = 1.0):
    """Closest-point transform of a signed distance field -> ``(N,N,N,3)``.

    Analog of ``tools::cpt`` (``openvdb/tools/GridOperators.h`` /
    ``math::CPT``): for each cell center ``x`` returns the closest point
    on the zero level set, ``x - φ(x) ∇φ/|∇φ|``, in *grid coordinates*
    ``[-B, B]`` (the reference returns world-space positions; with the
    apps' identity transform the two coincide).
    """
    n = normalize(gradient(sdf, dx))
    c = jnp.arange(-bound, bound + 1, dtype=sdf.dtype) * dx
    x = jnp.stack(jnp.meshgrid(c, c, c, indexing="ij"), axis=-1)
    return x - sdf[..., None] * n
