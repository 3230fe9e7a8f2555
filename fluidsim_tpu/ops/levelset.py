"""Level-set utilities — the dense-array answers to the capability-relevant
``openvdb/tools`` level-set family the reference vendors
(``LevelSetSphere.h``, ``ParticlesToLevelSet.h``, ``LevelSetUtil`` fog
conversion, ``LevelSetMeasure``): SDF construction, CSG, particle surface
extraction, and fog conversion, all as dense jnp ops.

``particles_to_levelset`` is the piece that matters in practice: it turns
the solver's particle cloud into a renderable signed-distance surface (the
reference renders occupancy instead, hence its blobby screenshots).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from fluidsim_tpu.core.splines import cround
from fluidsim_tpu.ops.transfer import _OFFSETS


def sphere_sdf(spec_shape, bound: int, center, radius: float, dtype=jnp.float32):
    """Dense SDF of a sphere (``tools::createLevelSetSphere``)."""
    c = jnp.arange(-bound, bound + 1, dtype=dtype)
    x = c[:, None, None] - center[0]
    y = c[None, :, None] - center[1]
    z = c[None, None, :] - center[2]
    return jnp.sqrt(x * x + y * y + z * z) - radius


def box_sdf(spec_shape, bound: int, lo, hi, dtype=jnp.float32):
    """Dense SDF of an axis-aligned box."""
    c = jnp.arange(-bound, bound + 1, dtype=dtype)
    grids = jnp.stack(jnp.meshgrid(c, c, c, indexing="ij"), axis=-1)
    center = (jnp.asarray(lo, dtype) + jnp.asarray(hi, dtype)) / 2
    half = (jnp.asarray(hi, dtype) - jnp.asarray(lo, dtype)) / 2
    q = jnp.abs(grids - center) - half
    outside = jnp.linalg.norm(jnp.maximum(q, 0.0), axis=-1)
    inside = jnp.minimum(jnp.max(q, axis=-1), 0.0)
    return outside + inside


def csg_union(a, b):
    return jnp.minimum(a, b)


def csg_intersection(a, b):
    return jnp.maximum(a, b)


def csg_difference(a, b):
    return jnp.maximum(a, -b)


def offset(sdf, d: float):
    """Erode (d<0) / dilate (d>0) — ``tools::LevelSetFilter::offset``."""
    return sdf - d


def fracture(sdf, cutter):
    """Split a level set with a cutter level set —
    ``tools::LevelSetFracture::fracture``: the fragment is the part of
    ``sdf`` inside the cutter, the residual is what remains.  The
    reference additionally re-tracks each piece's narrow band; callers
    wanting true distances away from the cut run
    ``levelset_tools.redistance`` on the outputs (CSG max/min fields are
    only lower bounds off the surface, same as the reference pre-rebuild).
    Returns ``(fragment, residual)``.
    """
    return csg_intersection(sdf, cutter), csg_difference(sdf, cutter)


def particles_to_levelset(pos, bound: int, radius: float = 1.0,
                          background: float = 3.0):
    """Union-of-spheres SDF from a particle cloud
    (``tools::ParticlesToLevelSet``): for every grid cell within the 3^3
    neighbourhood of a particle's cell, keep the minimum of
    ``|x_cell - p| - radius``.  Uses a sorted scatter-min, so it shares the
    fast-transfer schedule.

    Cells never touched stay at ``+background``.
    """
    n = 2 * bound + 1
    base = cround(pos).astype(jnp.int32)
    offs = jnp.asarray(_OFFSETS)
    cells = base[:, None, :] + offs[None]
    inb = jnp.all(jnp.abs(cells) <= bound, axis=-1)
    d = jnp.linalg.norm(cells.astype(pos.dtype) - pos[:, None, :], axis=-1) - radius
    d = jnp.where(inb, d, background)
    idx = jnp.clip(cells + bound, 0, n - 1)
    flat = ((idx[..., 0] * n + idx[..., 1]) * n + idx[..., 2]).reshape(-1)
    order = jnp.argsort(flat)
    sdf = jnp.full((n * n * n,), jnp.asarray(background, pos.dtype))
    sdf = sdf.at[flat[order]].min(d.reshape(-1)[order], indices_are_sorted=True)
    return sdf.reshape(n, n, n)


def sdf_to_fog(sdf, half_width: float = 1.5):
    """SDF -> fog volume density in [0,1] (``tools::sdfToFogVolume``):
    1 deep inside, linear ramp across the narrow band, 0 outside."""
    return jnp.clip(-sdf / half_width, 0.0, 1.0)


def levelset_volume(sdf, dx: float = 1.0):
    """Enclosed volume estimate (``tools::levelSetVolume``): sharp count of
    inside cells with a first-order interface correction."""
    inside = (sdf < 0).astype(jnp.float32)
    band = jnp.clip(0.5 - sdf, 0.0, 1.0) * (jnp.abs(sdf) < 0.5)
    return (jnp.sum(inside) + jnp.sum(band * (1 - inside))) * dx ** 3
