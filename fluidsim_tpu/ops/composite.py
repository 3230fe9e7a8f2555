"""Grid compositing, masking and topology utilities.

Dense-array answers to a family of small OpenVDB tool headers the apps never
call but the library exposes (SURVEY.md §2.2 "40 headers"):

  * ``openvdb/tools/Composite.h`` — ``compMax/compMin/compSum/compMul/
    compDiv/compReplace`` and the level-set CSG ops (CSG lives in
    ``ops/levelset.py``; the comp* family is here);
  * ``openvdb/tools/Mask.h`` — ``interiorMask`` (SDF/fog interior → bool);
  * ``openvdb/tools/Clip.h`` — ``clip`` by bbox or mask;
  * ``openvdb/tools/PointsToMask.h`` — particle positions → occupancy;
  * ``openvdb/tools/SignedFloodFill.h`` — propagate narrow-band signs to
    the far field;
  * ``openvdb/tools/TopologyToLevelSet.h`` — active mask → SDF;
  * ``openvdb/tools/ChangeBackground.h`` — swap the background value of
    inactive cells.

On sparse trees each of these is a topology-union tree walk; on dense
device-resident arrays each is one fused elementwise pass (plus, for the
flood fill, a fixed-trip sweep).  "Active" is an explicit bool mask — the
dense stand-in for tree topology.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from fluidsim_tpu.ops.morphology import dilate, NN_FACE
from fluidsim_tpu.ops.levelset_tools import redistance

__all__ = [
    "comp_max", "comp_min", "comp_sum", "comp_mul", "comp_div",
    "comp_replace", "interior_mask", "clip_to_box", "clip_to_mask",
    "points_to_mask", "signed_flood_fill", "topology_to_levelset",
    "change_background",
]


# ---- Composite.h comp* family ------------------------------------------
# Reference semantics: combine grid b into grid a over the union of their
# active topologies; inactive cells contribute their background.  Dense
# analog: masks select where each operand is defined.

def _masked(a, b, a_active, b_active, op, background=0.0):
    if a_active is None and b_active is None:
        return op(a, b)
    a_active = jnp.ones(a.shape, bool) if a_active is None else a_active
    b_active = jnp.ones(b.shape, bool) if b_active is None else b_active
    av = jnp.where(a_active, a, background)
    bv = jnp.where(b_active, b, background)
    out = op(av, bv)
    only_a = a_active & ~b_active
    only_b = b_active & ~a_active
    out = jnp.where(only_a, a, out)
    out = jnp.where(only_b, b, out)
    return jnp.where(a_active | b_active, out, background)


def comp_max(a, b, a_active=None, b_active=None, background=0.0):
    """``tools::compMax`` — pointwise max over the topology union."""
    return _masked(a, b, a_active, b_active, jnp.maximum, background)


def comp_min(a, b, a_active=None, b_active=None, background=0.0):
    """``tools::compMin``."""
    return _masked(a, b, a_active, b_active, jnp.minimum, background)


def comp_sum(a, b, a_active=None, b_active=None, background=0.0):
    """``tools::compSum``."""
    return _masked(a, b, a_active, b_active, jnp.add, background)


def comp_mul(a, b, a_active=None, b_active=None, background=0.0):
    """``tools::compMul``."""
    return _masked(a, b, a_active, b_active, jnp.multiply, background)


def comp_div(a, b, a_active=None, b_active=None, background=0.0):
    """``tools::compDiv`` (divide-by-zero yields 0, like the reference's
    zeroVal fallback for non-finite results)."""
    def safe_div(x, y):
        out = x / jnp.where(y == 0, 1.0, y)
        return jnp.where(y == 0, 0.0, out)
    return _masked(a, b, a_active, b_active, safe_div, background)


def comp_replace(a, b, b_active=None):
    """``tools::compReplace`` — copy b's active values over a."""
    if b_active is None:
        return b
    return jnp.where(b_active, b, a)


# ---- Mask.h / Clip.h / PointsToMask.h -----------------------------------

def interior_mask(grid, iso: float = 0.0, levelset: bool = True):
    """``tools::interiorMask``: bool mask of the interior — ``φ < iso``
    for level sets, ``value > iso`` for fog/density volumes."""
    return (grid < iso) if levelset else (grid > iso)


def clip_to_box(grid, lo, hi, bound: int, background=0.0):
    """``tools::clip`` by an index-space bbox (centered coordinates,
    inclusive): values outside become background."""
    n = grid.shape[0]
    coords = [jnp.arange(-bound, bound + 1).reshape(
        [-1 if ax == d else 1 for ax in range(3)]) for d in range(3)]
    inside = jnp.ones((n, n, n), bool)
    for d in range(3):
        inside = inside & (coords[d] >= lo[d]) & (coords[d] <= hi[d])
    if grid.ndim == 4:
        inside = inside[..., None]
    return jnp.where(inside, grid, background)


def clip_to_mask(grid, mask, background=0.0):
    """``tools::clip`` by a mask grid."""
    m = mask.astype(bool)
    if grid.ndim == 4 and m.ndim == 3:
        m = m[..., None]
    return jnp.where(m, grid, background)


def points_to_mask(pos, bound: int):
    """``tools::PointsToMask``: scatter particle positions into a bool
    occupancy grid (nearest-voxel, the same ``Coord::round`` convention as
    the transfers)."""
    n = 2 * bound + 1
    cells = jnp.clip(jnp.round(pos).astype(jnp.int32) + bound, 0, n - 1)
    grid = jnp.zeros((n, n, n), jnp.int32)
    grid = grid.at[cells[:, 0], cells[:, 1], cells[:, 2]].max(1)
    return grid.astype(bool)


# ---- SignedFloodFill.h / TopologyToLevelSet.h / ChangeBackground.h ------

def signed_flood_fill(phi, band: float, iterations: int | None = None,
                      outside: float | None = None):
    """``tools::signedFloodFill``: a narrow-band SDF stores real values
    only where ``|φ| < band``; propagate consistent signs outward so the
    far field becomes ``±outside`` (default ``±band``).

    Dense sweep: iteratively copy the sign of any already-signed neighbor
    into unsigned cells (cells at exactly the fill value).  ``iterations``
    defaults to enough sweeps to cross the whole box.
    """
    n = phi.shape[0]
    out_mag = band if outside is None else outside
    known = jnp.abs(phi) < band
    sign = jnp.where(phi < 0, -1.0, 1.0) * known  # 0 = unknown
    iters = iterations if iterations is not None else (n + 1)

    def body(_, s):
        neigh = jnp.zeros_like(s)
        for d in range(3):
            for shift in (1, -1):
                r = jnp.roll(s, shift, axis=d)
                idx = [slice(None)] * 3
                idx[d] = 0 if shift == 1 else n - 1
                r = r.at[tuple(idx)].set(0.0)
                # first nonzero neighbor wins (they agree away from the
                # band by construction)
                neigh = jnp.where(neigh == 0, r, neigh)
        return jnp.where(s == 0, neigh, s)

    sign = jax.lax.fori_loop(0, iters, body, sign)
    sign = jnp.where(sign == 0, 1.0, sign)  # isolated regions: outside
    return jnp.where(known, phi, sign * out_mag)


def topology_to_levelset(mask, half_width: float = 3.0, dilation: int = 0,
                         smooth_iterations: int = 0, iterations: int = 30):
    """``tools::topologyToLevelSet``: convert an active mask to a
    narrow-band SDF whose zero crossing wraps the active voxels
    (optionally dilated / smoothed first, matching the reference tool's
    ``dilation``/``smoothingSteps`` knobs)."""
    m = mask.astype(bool)
    if dilation:
        m = dilate(m, dilation, NN_FACE)
    seed = jnp.where(m, -0.5, 0.5)
    phi = redistance(seed, iterations=iterations)
    if smooth_iterations:
        from fluidsim_tpu.ops.levelset_tools import filter_mean
        for _ in range(smooth_iterations):
            phi = filter_mean(phi, 3)
        phi = redistance(phi, iterations=max(4, iterations // 4))
    w = half_width
    return jnp.clip(phi, -w, w)


def change_background(grid, active, new_background, levelset: bool = False):
    """``tools::changeBackground``: rewrite inactive cells' value.  With
    ``levelset=True`` the cell's sign is preserved and only the magnitude
    changes, matching ``changeLevelSetBackground``."""
    inactive = ~active.astype(bool)
    if levelset:
        newv = jnp.where(grid < 0, -1.0, 1.0) * abs(new_background)
    else:
        newv = jnp.full_like(grid, new_background)
    return jnp.where(inactive, newv, grid)
