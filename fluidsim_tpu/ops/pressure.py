"""Matrix-free pressure Poisson projection (the reference's Eigen solve).

The reference builds an explicit sparse matrix per outer iteration
(``setA``/``setA2``, ``fluid.cc:304-412,481-541``) and solves it with Eigen
IncompleteCholesky-PCG (``fluid.cc:1352,1473-1474``).  Here the
variable-coefficient 7-point Laplacian is applied matrix-free with shifted
dense arrays (XLA fuses the shifts+adds into a single stencil pass), and the
CG runs fully jitted (see ``ops.pcg``).  Semantics are kept faithful:

* rows = fluid cells (occupancy > 0 and not solid; ``fluid.cc:326``),
* Neumann at solid cells (walls), Dirichlet p=0 at air cells,
* diag(c) = scale * #non-solid 6-neighbours, off-diag -scale between
  fluid-fluid neighbours (scale = dt / (rho dx^2), ``fluid.cc:306``),
* the RHS carries the reference's solid-wall terms with ``g*dt`` folded in
  (``setRHS``, ``fluid.cc:414-479``) minus the masked divergence
  (``setDiver``, ``fluid.cc:566-610``),
* the velocity update applies the gradient at 1/10 strength and re-adds
  gravity every outer pass (``velUpdate`` called with ``dt/10``,
  ``fluid.cc:612-703,1475``) — faithful to the reference's quirks.
"""

from __future__ import annotations

import jax.numpy as jnp

from fluidsim_tpu.core.gridspec import shift_to_plus, shift_to_minus


def set_rhs(vel, fluid, solid, gravity, dt, dx):
    """Solid-wall RHS terms (``setRHS``, ``fluid.cc:414-479``).

    For each fluid cell, for each axis d: if the minus-neighbour is solid,
    subtract ``(v[c,d] + g_d*dt)/dx``; if the plus-neighbour is solid, add
    ``(v[c+e_d,d] + g_d*dt)/dx``.  Out-of-box neighbours read as non-solid
    (OpenVDB background 0), reproduced by zero-padded shifts.
    """
    scale = 1.0 / dx
    rhs = jnp.zeros(fluid.shape, vel.dtype)
    solid_f = solid.astype(vel.dtype)
    for d in range(3):
        g_d = gravity[d] * dt
        vd = vel[..., d]
        sm = shift_to_minus(solid_f, d)    # solid(c - e_d)
        sp = shift_to_plus(solid_f, d)     # solid(c + e_d)
        vp = shift_to_plus(vd, d)          # v[c + e_d, d]
        rhs = rhs - scale * sm * (vd + g_d) + scale * sp * (vp + g_d)
    return jnp.where(fluid, rhs, 0.0)


def divergence_rhs(vel, rhs, fluid, solid, dx):
    """``diver = rhs - div(v)`` on fluid cells (``setDiver``, ``fluid.cc:566-610``).

    Per the reference quirk, the whole axis term ``(v[c+e_d,d] - v[c,d])/dx``
    is dropped when the plus-neighbour is solid.
    """
    div = jnp.zeros(fluid.shape, vel.dtype)
    for d in range(3):
        vd = vel[..., d]
        vp = shift_to_plus(vd, d)
        open_p = ~shift_to_plus(solid, d)  # pad False == non-solid outside
        div = div + jnp.where(open_p, (vp - vd) / dx, 0.0)
    return jnp.where(fluid, rhs - div, 0.0)


def laplacian_diag(fluid, solid, dt, rho, dx, dtype=jnp.float32):
    """Adiag (``setA``, ``fluid.cc:304-412``): scale * #non-solid neighbours,
    on fluid cells (both symmetric halves of the reference's assembly fold to
    this count)."""
    scale = dt / (rho * dx * dx)
    ns = (~solid).astype(dtype)
    count = jnp.zeros(fluid.shape, dtype)
    for d in range(3):
        count = count + shift_to_plus(ns, d) + shift_to_minus(ns, d)
    return jnp.where(fluid, scale * count, 0.0)


def apply_laplacian(p, adiag, fluid, dt, rho, dx):
    """Matrix-free ``A @ p``: diag minus fluid-fluid neighbour couplings."""
    scale = dt / (rho * dx * dx)
    pf = jnp.where(fluid, p, 0.0)
    acc = adiag * pf
    for d in range(3):
        acc = acc - scale * (shift_to_plus(pf, d) + shift_to_minus(pf, d))
    return jnp.where(fluid, acc, 0.0)


def vel_update(vel, p, fluid, solid, gravity, dt, rho, dx,
               gradient_scale: float = 0.1, add_gravity: bool = True):
    """Pressure-gradient + gravity + solid-BC velocity update
    (``velUpdate``, ``fluid.cc:612-703``; invoked with ``dt/10``,
    ``fluid.cc:1475`` — hence the default ``gradient_scale=0.1`` and
    per-pass gravity).  The clean (non-compat) projection calls this with
    ``gradient_scale=1.0, add_gravity=False``.

    Per fluid cell c: all three components at c get ``-= scale*p(c)`` (and
    ``+= g*dt`` in compat mode); component d at ``c+e_d`` gets
    ``+= scale*p(c)``.  Then solid enforcement zeroes component d at solid
    cells and at cells whose minus-d neighbour is solid.
    """
    scale = (dt * gradient_scale) / (rho * dx)
    pf = jnp.where(fluid, p, 0.0) * scale
    fl = fluid.astype(vel.dtype)
    out = []
    for d in range(3):
        vd = vel[..., d]
        vd = vd - pf + shift_to_minus(pf, d)
        if add_gravity:
            vd = vd + gravity[d] * dt * fl
        blocked = solid | shift_to_minus(solid, d)
        out.append(jnp.where(blocked, 0.0, vd))
    return jnp.stack(out, axis=-1)
