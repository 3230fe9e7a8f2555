"""Triangle mesh -> signed distance volume (the ``MeshToVolume`` tool family
of the vendored OpenVDB, ``reference/openvdb/tools/MeshToVolume.h``).

Dense formulation: instead of the reference's per-voxel BVH walks and
scanline sign sweeps, the whole grid is resolved with two fully batched
reductions over triangles —

  * unsigned distance: min over triangles of the exact point-triangle
    distance (clamped-barycentric closest point), vectorised as
    ``(chunk_of_points, T)`` tiles;
  * sign: the generalized winding number (sum of signed solid angles,
    van Oosterom-Strackee via atan2), which is robust to open edges and
    non-manifold junk where pseudo-normal tests are not.

Both are pure dense math — no trees, no traversal — so XLA fuses the
``(Q, T)`` tiles and the point dimension can be sharded.  Triangle counts in the low tens of thousands at 128^3 fit in one
pass; larger meshes chunk over the query dimension via ``lax.map``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def point_triangle_distance(p, a, b, c):
    """Exact unsigned distance from points ``p`` (..., 3) to triangles
    (a, b, c) (..., 3) — broadcasting, region-based closest point
    (Ericson, Real-Time Collision Detection §5.1.5 layout)."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = jnp.sum(ab * ap, -1)
    d2 = jnp.sum(ac * ap, -1)
    bp = p - b
    d3 = jnp.sum(ab * bp, -1)
    d4 = jnp.sum(ac * bp, -1)
    cp = p - c
    d5 = jnp.sum(ab * cp, -1)
    d6 = jnp.sum(ac * cp, -1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    # interior barycentric point
    denom = jnp.where(va + vb + vc != 0, va + vb + vc, 1.0)
    v_in = vb / denom
    w_in = vc / denom
    q_face = a + v_in[..., None] * ab + w_in[..., None] * ac

    # edge/vertex candidates
    t_ab = jnp.clip(d1 / jnp.where(d1 - d3 != 0, d1 - d3, 1.0), 0.0, 1.0)
    q_ab = a + t_ab[..., None] * ab
    t_ac = jnp.clip(d2 / jnp.where(d2 - d6 != 0, d2 - d6, 1.0), 0.0, 1.0)
    q_ac = a + t_ac[..., None] * ac
    t_bc = jnp.clip((d4 - d3) / jnp.where((d4 - d3) + (d5 - d6) != 0,
                                          (d4 - d3) + (d5 - d6), 1.0), 0.0, 1.0)
    q_bc = b + t_bc[..., None] * (c - b)

    q = q_face
    q = jnp.where((vc <= 0)[..., None] & (d1 >= 0)[..., None] & (d3 <= 0)[..., None], q_ab, q)
    q = jnp.where((vb <= 0)[..., None] & (d2 >= 0)[..., None] & (d6 <= 0)[..., None], q_ac, q)
    q = jnp.where((va <= 0)[..., None] & ((d4 - d3) >= 0)[..., None]
                  & ((d5 - d6) >= 0)[..., None], q_bc, q)
    q = jnp.where((d1 <= 0)[..., None] & (d2 <= 0)[..., None], a, q)
    q = jnp.where((d3 >= 0)[..., None] & (d4 <= d3)[..., None], b, q)
    q = jnp.where((d6 >= 0)[..., None] & (d5 <= d6)[..., None], c, q)
    return jnp.linalg.norm(p - q, axis=-1)


def winding_number(p, a, b, c):
    """Generalized winding number of points ``p`` (Q, 3) wrt triangles
    (T, 3): sum of signed solid angles / 4pi.  ~0 outside, ~1 inside a
    closed mesh (van Oosterom & Strackee 1983)."""
    ra = a[None] - p[:, None]
    rb = b[None] - p[:, None]
    rc = c[None] - p[:, None]
    la = jnp.linalg.norm(ra, axis=-1)
    lb = jnp.linalg.norm(rb, axis=-1)
    lc = jnp.linalg.norm(rc, axis=-1)
    num = jnp.sum(ra * jnp.cross(rb, rc), axis=-1)
    den = (la * lb * lc + jnp.sum(ra * rb, -1) * lc
           + jnp.sum(rb * rc, -1) * la + jnp.sum(rc * ra, -1) * lb)
    omega = 2.0 * jnp.arctan2(num, den)
    return jnp.sum(omega, axis=-1) / (4.0 * jnp.pi)


def mesh_to_sdf(verts, tris, bound: int, chunk: int = 8192,
                dtype=jnp.float32):
    """Signed distance grid of a triangle mesh on the ``[-bound, bound]^3``
    index-space lattice (OpenVDB ``meshToLevelSet``; consumed the same way
    as ``particles_to_levelset`` output).

    Args:
      verts: (V, 3) float vertices in index space.
      tris:  (T, 3) int vertex indices (outward CCW orientation).
      chunk: grid points per batched tile (memory knob: chunk x T floats).
    Returns:
      (N, N, N) signed distance, negative inside.
    """
    verts = jnp.asarray(verts, dtype)
    tris = np.asarray(tris)
    a, b, c = (verts[tris[:, i]] for i in range(3))

    n = 2 * bound + 1
    coords = jnp.arange(-bound, bound + 1, dtype=dtype)
    pts = jnp.stack(jnp.meshgrid(coords, coords, coords, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    n3 = pts.shape[0]
    pad = (-n3) % chunk
    pts_p = jnp.pad(pts, ((0, pad), (0, 0)))

    def one_chunk(p):
        d = jnp.min(point_triangle_distance(p[:, None], a[None], b[None],
                                            c[None]), axis=1)
        inside = winding_number(p, a, b, c) > 0.5
        return jnp.where(inside, -d, d)

    sdf = jax.lax.map(one_chunk, pts_p.reshape(-1, chunk, 3))
    return sdf.reshape(-1)[:n3].reshape(n, n, n)


# ---- simple primitive meshes (test + demo fodder) ----

def icosphere(center, radius: float, subdivisions: int = 2):
    """Triangulated sphere: octahedron subdivided + projected.  Returns
    (verts (V,3) float64 np, tris (T,3) int np), outward orientation."""
    verts = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
    tris = [(0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4),
            (2, 0, 5), (1, 2, 5), (3, 1, 5), (0, 3, 5)]
    verts = [np.array(v, np.float64) for v in verts]
    for _ in range(subdivisions):
        cache, new_tris = {}, []
        def mid(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = verts[i] + verts[j]
                verts.append(m / np.linalg.norm(m))
                cache[key] = len(verts) - 1
            return cache[key]
        for (i, j, k) in tris:
            ij, jk, ki = mid(i, j), mid(j, k), mid(k, i)
            new_tris += [(i, ij, ki), (j, jk, ij), (k, ki, jk), (ij, jk, ki)]
        tris = new_tris
    v = np.stack(verts) * radius + np.asarray(center, np.float64)
    return v, np.asarray(tris, np.int32)


def box_mesh(lo, hi):
    """Axis-aligned box as 12 outward-facing triangles."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    corners = np.array([[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
                        [hi[0], hi[1], lo[2]], [lo[0], hi[1], lo[2]],
                        [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
                        [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]]])
    quads = [(0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4),
             (2, 3, 7, 6), (1, 2, 6, 5), (3, 0, 4, 7)]
    tris = []
    for (i, j, k, l) in quads:
        tris += [(i, j, k), (i, k, l)]
    return corners, np.asarray(tris, np.int32)
