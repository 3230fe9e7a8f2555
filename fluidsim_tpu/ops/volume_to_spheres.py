"""Sphere packing & closest surface points
(``openvdb/tools/VolumeToSpheres.h`` analog).

The reference's ``fillWithSpheres`` greedily drops up to N non-overlapping
spheres inside an iso-surface, each centered at the interior point with
the largest remaining clearance (distance to surface AND to the spheres
already placed), stopping below a minimum radius; ``ClosestSurfacePoint``
answers closest-point queries against the iso-surface.  Here the
interior clearance field is the (negated) SDF itself, updated after each
placement with one fused ``min(d, |x−c|−r)`` pass — a fixed-trip
``lax.fori_loop`` of argmax+update steps, no ray sampling needed because
the dense SDF already is the distance oracle.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from fluidsim_tpu.ops.gridops import gradient

__all__ = ["fill_with_spheres", "closest_surface_points"]


@functools.partial(jax.jit, static_argnames=("count", "bound", "overlap"))
def _fill(phi, count: int, bound: int, min_radius: float, overlap: bool):
    n = phi.shape[0]
    c = jnp.arange(-bound, bound + 1, dtype=phi.dtype)
    xx, yy, zz = jnp.meshgrid(c, c, c, indexing="ij")
    pts = jnp.stack([xx, yy, zz], axis=-1).reshape(-1, 3)
    clearance = (-phi).reshape(-1)  # distance to surface, >0 inside

    def body(i, carry):
        clear, spheres, radii = carry
        k = jnp.argmax(clear)
        r = clear[k]
        ctr = pts[k]
        ok = r >= min_radius
        spheres = spheres.at[i].set(jnp.where(ok, ctr, jnp.nan))
        radii = radii.at[i].set(jnp.where(ok, r, 0.0))
        # new clearance: spheres must stay inside the surface and (unless
        # overlap is allowed) outside every placed sphere
        d_new = jnp.linalg.norm(pts - ctr, axis=-1) - (
            0.0 if overlap else r)
        clear = jnp.where(ok, jnp.minimum(clear, d_new), clear - jnp.inf)
        return clear, spheres, radii

    spheres = jnp.zeros((count, 3), phi.dtype)
    radii = jnp.zeros((count,), phi.dtype)
    _, spheres, radii = jax.lax.fori_loop(
        0, count, body, (clearance, spheres, radii))
    return spheres, radii


def fill_with_spheres(phi, count: int, bound: int, min_radius: float = 1.0,
                      overlap: bool = False):
    """``tools::fillWithSpheres``: up to ``count`` spheres inside the zero
    iso-surface of SDF ``phi``.  Returns ``(centers (count,3),
    radii (count,))`` — unused slots have radius 0 (and NaN centers),
    matching the reference's "up to N" contract with static shapes.
    ``overlap=True`` only requires spheres to stay inside the surface.
    """
    return _fill(phi, count, bound, float(min_radius), bool(overlap))


def closest_surface_points(phi, pos, bound: int, dx: float = 1.0):
    """``tools::ClosestSurfacePoint::search``: for query points ``pos``
    (P,3, centered index coords), the closest point on the zero
    iso-surface and the distance to it.

    Uses the SDF property directly: ``closest = x − φ(x)·∇φ(x)/|∇φ|``,
    sampled trilinearly — one gather instead of the reference's
    sphere-ray BVH.
    """
    from fluidsim_tpu.ops.advect_volume import sample_trilinear

    g = gradient(phi, dx)
    d = sample_trilinear(phi, pos, bound)
    comp = [sample_trilinear(g[..., i], pos, bound) for i in range(3)]
    nrm = jnp.stack(comp, axis=-1)
    nrm = nrm / jnp.maximum(jnp.linalg.norm(nrm, axis=-1, keepdims=True),
                            1e-12)
    closest = pos - d[..., None] * nrm
    return closest, jnp.abs(d)
