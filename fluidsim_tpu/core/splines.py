"""Quadratic-support B-spline transfer kernels.

The reference uses a cubic B-spline compressed to support ``|x| < 1`` (i.e.
``B3(2x)``), in two flavours:

* FLIP kernel (``fluid.cc:22-37``): ``w(x) = 1.5 * B(|x|)`` where for
  ``a = |x|``::

      a < 0.5 : 1.5 * (4a^3 - 4a^2 + 2/3)
      a < 1.0 : 1.5 * (-8a^3/6 + 4a^2 - 4a + 4/3)      # == 1.5*(4/3)(1-a)^3
      else    : 0

* MPM kernel (``mpm.cc:25-41`` with ``factor = 1``): the same shape without
  the 1.5 prefactor, evaluated at ``|x - 0.5|`` (staggered half-cell shift).

* ``spline2`` (``deformHeader.h:38-53``): the unshifted, unscaled base
  function, used by the MPM weight gradients.

* ``getSplineGradient`` (``deformHeader.h:54-88``): the signed derivative of
  ``spline2``.

All functions are pure jnp element-wise ops (fusible).
"""

from __future__ import annotations

import jax.numpy as jnp


def bspline_base(a):
    """Base kernel piece for ``a = |arg| >= 0`` (support ``a < 1``).

    ``a < 0.5 -> 4a^3 - 4a^2 + 2/3``;  ``a <= 1 -> -(4/3)a^3 + 4a^2 - 4a + 4/3``.
    Both reference branch conventions (``< 1`` and ``<= 1``) agree because the
    second piece vanishes at ``a = 1``.
    """
    a2 = a * a
    a3 = a2 * a
    inner = 4.0 * a3 - 4.0 * a2 + 2.0 / 3.0
    outer = -4.0 / 3.0 * a3 + 4.0 * a2 - 4.0 * a + 4.0 / 3.0
    return jnp.where(a < 0.5, inner, jnp.where(a < 1.0, outer, 0.0))


def spline_flip(x):
    """FLIP transfer weight, ``fluid.cc:22-37``: ``1.5 * bspline_base(|x|)``."""
    return 1.5 * bspline_base(jnp.abs(x))


def spline_mpm(x):
    """MPM transfer weight, ``mpm.cc:25-41`` (factor=1): ``bspline_base(|x-0.5|)``."""
    return bspline_base(jnp.abs(x - 0.5))


def spline2(x):
    """Unshifted base kernel, ``deformHeader.h:38-53`` (factor=1)."""
    return bspline_base(jnp.abs(x))


def dspline2(x):
    """Signed derivative of ``spline2``, ``deformHeader.h:54-88`` (factor=1)."""
    a = jnp.abs(x)
    a2 = a * a
    mag = jnp.where(a < 0.5, 12.0 * a2 - 8.0 * a,
                    jnp.where(a <= 1.0, -4.0 * a2 + 8.0 * a - 4.0, 0.0))
    return jnp.sign(x) * mag


def grad_w_mpm(delta):
    """MPM weight gradient wrt the *grid node* coordinate.

    ``deformHeader.h:90-105`` (``getGradW``): with ``delta = p - c`` (particle
    minus node, per axis), the scalar weight along each axis is
    ``spline2(delta_d - 0.5)`` and the gradient component is
    ``-dspline2(delta_d - 0.5)`` times the other two axes' weights.

    Args:
      delta: (..., 3) array of ``p - c``.
    Returns:
      (w, grad): weight (...,) and gradient (..., 3) wrt node position.
    """
    s = delta - 0.5
    wd = spline2(s)                     # (..., 3) per-axis weights
    gd = -dspline2(s)                   # (..., 3) per-axis signed gradients
    w = wd[..., 0] * wd[..., 1] * wd[..., 2]
    gx = gd[..., 0] * wd[..., 1] * wd[..., 2]
    gy = wd[..., 0] * gd[..., 1] * wd[..., 2]
    gz = wd[..., 0] * wd[..., 1] * gd[..., 2]
    return w, jnp.stack([gx, gy, gz], axis=-1)


def cround(x):
    """C ``round()``: round half away from zero (``fluid.cc:127-129`` et al.)."""
    return jnp.where(x >= 0, jnp.floor(x + 0.5), -jnp.floor(-x + 0.5))


def cround_out(x):
    """MPM FLIPadvect rounding, ``mpm.cc:940-942``: ceil for positive, floor else."""
    return jnp.where(x > 0, jnp.ceil(x), jnp.floor(x))
