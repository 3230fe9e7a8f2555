"""Iso-surface mesh extraction (``openvdb/tools/VolumeToMesh.h`` analog).

The reference's ``tools::volumeToMesh`` walks the sparse tree's leaf nodes
with TBB, placing one vertex per sign-changing dual cell and emitting quads
across sign-changing grid edges (dual contouring, adaptivity 0).  The
dense formulation is the same dual-contouring scheme (naive Surface
Nets) as a single dense jitted pass: every (N−1)³ dual cell computes its
vertex as the mean of its cube-edge iso-crossings, and every grid edge with
a sign change emits the quad of its four surrounding dual cells — all
fixed-shape masked arrays, no data-dependent control flow.  Host-side
compaction (one ``cumsum`` remap) turns the masked arrays into packed
``(V,3)`` vertices and ``(Q,4)`` quads, the exact output shape of the
reference tool (points + quads; triangle fan-out provided separately).

Round-trip partner of ``ops/mesh.py:mesh_to_sdf`` (MeshToVolume analog).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["volume_to_mesh_arrays", "volume_to_mesh", "quads_to_triangles",
           "mesh_area"]

# The 8 cube corners of a dual cell, in offset coordinates.
_CORNERS = [(ci, cj, ck) for ci in (0, 1) for cj in (0, 1) for ck in (0, 1)]
# The 12 cube edges as corner-index pairs.
_EDGES = [
    (a, b)
    for ia, a in enumerate(_CORNERS)
    for b in _CORNERS[ia + 1:]
    if sum(abs(x - y) for x, y in zip(a, b)) == 1
]


def _corner(phi, off):
    """(N-1)³ view of the sample at cube-corner offset ``off``."""
    n = phi.shape[0]
    sl = tuple(slice(o, n - 1 + o) for o in off)
    return phi[sl]


@functools.partial(jax.jit, static_argnames=("iso",))
def volume_to_mesh_arrays(phi, iso: float = 0.0):
    """Dense dual-contouring pass over an ``(N,N,N)`` scalar field.

    Returns a dict of fixed-shape arrays:
      ``vertex``: (N-1,N-1,N-1,3) per-dual-cell vertex in sample-index
        space (mean of the cell's edge iso-crossings; 0 where inactive);
      ``cell_active``: (N-1,)³ bool — cell straddles the iso-contour;
      ``quad[d]``: (N-1,N-1,N-1,4) flat dual-cell ids of the quad dual to
        the grid edge leaving sample (i,j,k) along axis ``d``, wound so
        the face normal points toward increasing φ (outside for an SDF);
      ``quad_active[d]``: matching bool mask (edge sign change, and all
        four neighboring dual cells in range).
    """
    n = phi.shape[0]
    m = n - 1
    f = phi - iso

    corners = {off: _corner(f, off) for off in _CORNERS}

    # --- per-cell vertex: mean of edge iso-crossings --------------------
    acc = jnp.zeros((m, m, m, 3), f.dtype)
    cnt = jnp.zeros((m, m, m), f.dtype)
    for a, b in _EDGES:
        va, vb = corners[a], corners[b]
        crossing = (va > 0) != (vb > 0)
        t = va / jnp.where(va - vb == 0, 1.0, va - vb)
        t = jnp.clip(t, 0.0, 1.0)
        pa = jnp.asarray(a, f.dtype)
        pb = jnp.asarray(b, f.dtype)
        point = pa + t[..., None] * (pb - pa)
        acc = acc + jnp.where(crossing[..., None], point, 0.0)
        cnt = cnt + crossing.astype(f.dtype)

    cell_active = cnt > 0
    vertex = acc / jnp.maximum(cnt, 1.0)[..., None]
    # offset of the cell origin (sample index of corner (0,0,0))
    base = jnp.stack(
        jnp.meshgrid(*[jnp.arange(m, dtype=f.dtype)] * 3, indexing="ij"),
        axis=-1)
    vertex = jnp.where(cell_active[..., None], vertex + base, 0.0)

    # --- quads dual to sign-changing grid edges -------------------------
    # The edge leaving sample (i,j,k) along axis d is shared by the four
    # dual cells (i - (d!=0? 0 or 1 in the other axes) ...): cells whose
    # index equals the sample index minus {0,1} along each axis ≠ d.
    quads = []
    quad_active = []
    ids = jnp.arange(m * m * m, dtype=jnp.int32).reshape(m, m, m)
    for d in range(3):
        # cyclic transverse order so (o1, o2, d) is right-handed and the
        # base winding's geometric normal is +e_d for every axis
        o1, o2 = (d + 1) % 3, (d + 2) % 3
        ea = f
        eb = jnp.roll(f, -1, axis=d)
        sign_change = (ea > 0) != (eb > 0)
        # samples on the far face have no +d neighbor
        edge_ok = jnp.ones(f.shape, bool)
        idx = [slice(None)] * 3
        idx[d] = n - 1
        edge_ok = edge_ok.at[tuple(idx)].set(False)
        # the 4 surrounding dual cells exist only for interior samples
        # along the transverse axes (1 <= s <= N-2) and s <= N-2 along d
        coordd = [jnp.arange(n).reshape(
            [-1 if ax == a else 1 for ax in range(3)]) for a in range(3)]
        interior = (coordd[o1] >= 1) & (coordd[o1] <= n - 2) & \
                   (coordd[o2] >= 1) & (coordd[o2] <= n - 2) & \
                   (coordd[d] <= n - 2)
        active = sign_change & edge_ok & interior
        active = active[tuple(slice(0, m) for _ in range(3))]

        # gather the 4 cell ids around each edge; clamp indices (masked out
        # where not interior anyway)
        def cell_id(du1, du2, d=d, o1=o1, o2=o2):
            shift = [0, 0, 0]
            shift[o1] = du1
            shift[o2] = du2
            # cell index = sample index - shift  (shift in {0,1})
            rolled = ids
            for ax, s in enumerate(shift):
                if s:
                    rolled = jnp.roll(rolled, 1, axis=ax)
            return rolled

        # counter-clockwise loop around the edge: (0,0) -> (1,0) -> (1,1)
        # -> (0,1) in (o1,o2) cell-offset space
        q = jnp.stack([cell_id(0, 0), cell_id(1, 0),
                       cell_id(1, 1), cell_id(0, 1)], axis=-1)
        # wind toward increasing phi: if phi increases along +d (ea<eb),
        # keep; else reverse
        flip = (ea > 0)[tuple(slice(0, m) for _ in range(3))]
        q = jnp.where(flip[..., None], q[..., ::-1], q)
        quads.append(q)
        quad_active.append(active)

    return {
        "vertex": vertex,
        "cell_active": cell_active,
        "quads": quads,
        "quad_active": quad_active,
    }


def volume_to_mesh(phi, iso: float = 0.0, bound: int | None = None):
    """Extract a packed quad mesh from an iso-surface — the
    ``tools::volumeToMesh(grid, points, quads)`` entry point.

    Returns ``(verts, quads)`` numpy arrays of shape (V,3) and (Q,4).
    ``bound`` recenters vertices to the framework's centered voxel
    coordinates (positions in [-bound, bound], like every other op);
    ``None`` leaves them in sample-index space.
    """
    out = volume_to_mesh_arrays(phi, iso=iso)
    vertex = np.asarray(out["vertex"]).reshape(-1, 3)
    active = np.asarray(out["cell_active"]).reshape(-1)
    # dense cell id -> packed vertex id
    remap = np.cumsum(active) - 1
    verts = vertex[active]
    quad_list = []
    for q, qa in zip(out["quads"], out["quad_active"]):
        q = np.asarray(q).reshape(-1, 4)
        qa = np.asarray(qa).reshape(-1)
        quad_list.append(remap[q[qa]])
    quads = (np.concatenate(quad_list, axis=0)
             if quad_list else np.zeros((0, 4), np.int64))
    if bound is not None:
        verts = verts - float(bound)
    return verts, quads


def quads_to_triangles(quads):
    """Fan each quad into two triangles (the reference tool's optional
    triangle output)."""
    quads = np.asarray(quads)
    return np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]], axis=0)


def mesh_area(verts, faces):
    """Total surface area of a triangle or quad mesh (host-side helper,
    used by tests against ``levelset_area``)."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces)
    if faces.shape[1] == 4:
        faces = quads_to_triangles(faces)
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1).sum()
