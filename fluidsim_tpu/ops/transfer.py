"""Particle <-> grid transfer operators (P2G scatter, G2P gather, FLIP delta).

Batched reformulation of the reference's mutex-guarded per-particle
scatters (``fluid.cc:265-299`` ``p2gCatmullRom``, ``fluid.cc:843-882``
``PointList::interpolate``) and per-particle gathers (``fluid.cc:125-263``
``clampedCatmullRom`` / ``CatmullRomFLIP``): every particle touches the fixed
3^3 stencil around ``round(p)``, so transfers become one batched
scatter-add / gather over ``(P, 27)`` index arrays — no locks, no data races,
fully jittable.  This is the plain oracle the fused schedules
(``ops.transfer_fast``, ``ops.apic``, ``ops.mpm_fast``) are tested against;
particle order is never relied upon.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from fluidsim_tpu.core.splines import spline_flip, spline_mpm, cround
from fluidsim_tpu.core.gridspec import flat_index

# 27 stencil offsets, x-major (iteration order is irrelevant to the sums).
_OFFSETS = np.array([(i, j, k)
                     for i in (-1, 0, 1)
                     for j in (-1, 0, 1)
                     for k in (-1, 0, 1)], dtype=np.int32)

_KERNELS = {"flip": spline_flip, "mpm": spline_mpm}


def particle_stencil(pos, bound: int):
    """Stencil cells for each particle.

    Reference semantics (``fluid.cc:127-136``): the loop range
    ``round(p) - 1 .. round(p) + 1`` is *clipped* to ``[-bound, bound]``;
    cells outside simply don't exist, so we mask them out rather than clamp.

    Args:
      pos: (P, 3) positions in index space.
      bound: B.
    Returns:
      cells: (P, 27, 3) int32 grid coordinates (un-offset, may be invalid).
      inb:   (P, 27) bool — cell within ``[-bound, bound]^3``.
    """
    base = cround(pos).astype(jnp.int32)
    cells = base[:, None, :] + jnp.asarray(_OFFSETS)[None, :, :]
    inb = jnp.all(jnp.abs(cells) <= bound, axis=-1)
    return cells, inb


def stencil_weights(pos, cells, kernel: str):
    """Tensor-product spline weight per (particle, cell): ``fluid.cc:291``."""
    d = pos[:, None, :] - cells.astype(pos.dtype)
    w = _KERNELS[kernel](d)
    return w[..., 0] * w[..., 1] * w[..., 2]


def _flat_ids(cells, bound: int):
    n = 2 * bound + 1
    idx = jnp.clip(cells + bound, 0, n - 1)
    return flat_index(idx, n)


def p2g_velocity(pos, vel, solid, bound: int, kernel: str = "flip"):
    """Momentum/weight P2G (``p2gCatmullRom``, ``fluid.cc:265-299``).

    Scatter target mask: cell in range, not solid, and within ``bound - 2``
    (``fluid.cc:288``).

    Returns:
      weights: (N,N,N) sum of spline weights.
      mom:     (N,N,N,3) sum of ``w * v_p``.
    """
    n = 2 * bound + 1
    cells, inb = particle_stencil(pos, bound)
    w = stencil_weights(pos, cells, kernel)
    within = jnp.all(jnp.abs(cells) < bound - 1, axis=-1)  # |c| <= bound-2
    ids = _flat_ids(cells, bound)
    not_solid = ~solid.reshape(-1)[ids]
    mask = inb & within & not_solid
    wm = jnp.where(mask, w, 0.0)

    flat = ids.reshape(-1)
    weights = jnp.zeros((n * n * n,), pos.dtype).at[flat].add(wm.reshape(-1))
    mv = wm[..., None] * vel[:, None, :]
    mom = jnp.zeros((n * n * n, 3), pos.dtype).at[flat].add(mv.reshape(-1, 3))
    return weights.reshape(n, n, n), mom.reshape(n, n, n, 3)


def p2g_mass(pos, solid, bound: int, kernel: str = "flip"):
    """Occupancy/mass P2G (``PointList::interpolate``, ``fluid.cc:843-882``).

    Scatter target mask: cell in range, not solid, and ``w > 0``
    (``fluid.cc:870``) — note: *no* ``bound - 2`` restriction here.
    """
    n = 2 * bound + 1
    cells, inb = particle_stencil(pos, bound)
    w = stencil_weights(pos, cells, kernel)
    ids = _flat_ids(cells, bound)
    not_solid = ~solid.reshape(-1)[ids]
    mask = inb & not_solid & (w > 0)
    wm = jnp.where(mask, w, 0.0)
    mass = jnp.zeros((n * n * n,), pos.dtype).at[ids.reshape(-1)].add(wm.reshape(-1))
    return mass.reshape(n, n, n)


def normalize_velocity(weights, mom):
    """Weight-normalise the momentum grid (``fluid.cc:1131-1146``)."""
    w = weights[..., None]
    return jnp.where(w > 0, mom / jnp.where(w > 0, w, 1.0), mom)


def g2p_gather(pos, vc, bound: int, wall: int, kernel: str = "flip"):
    """PIC gather of cell-centred velocity (``clampedCatmullRom``,
    ``fluid.cc:125-207``): contributions only from cells within ``|c| <= wall``,
    normalised by the summed weight; zero where the weight vanishes.

    Args:
      vc: (N,N,N,3) *cell-centred* velocity (see ``cell_center_velocity``).
    """
    cells, inb = particle_stencil(pos, bound)
    w = stencil_weights(pos, cells, kernel)
    within = jnp.all(jnp.abs(cells) <= wall, axis=-1)
    mask = inb & within
    wm = jnp.where(mask, w, 0.0)
    ids = _flat_ids(cells, bound)
    vals = vc.reshape(-1, 3)[ids]
    num = jnp.sum(wm[..., None] * vals, axis=1)
    den = jnp.sum(wm, axis=1)
    return jnp.where(den[:, None] != 0, num / jnp.where(den[:, None] != 0, den[:, None], 1.0), 0.0)


def g2p_flip_delta(pos, vc_new, vc_old, bound: int, wall: int, kernel: str = "flip"):
    """FLIP delta gather (``CatmullRomFLIP``, ``fluid.cc:210-263``):
    ``sum(w * (vc_new - vc_old)) / sum(w)`` over in-wall stencil cells."""
    cells, inb = particle_stencil(pos, bound)
    w = stencil_weights(pos, cells, kernel)
    within = jnp.all(jnp.abs(cells) <= wall, axis=-1)
    mask = inb & within
    wm = jnp.where(mask, w, 0.0)
    ids = _flat_ids(cells, bound)
    dv = (vc_new - vc_old).reshape(-1, 3)[ids]
    num = jnp.sum(wm[..., None] * dv, axis=1)
    den = jnp.sum(wm, axis=1)
    return jnp.where(den[:, None] != 0, num / jnp.where(den[:, None] != 0, den[:, None], 1.0), 0.0)
