"""Grid resampling between transforms (``openvdb/tools/GridTransformer.h``)
and multi-resolution sampling (``openvdb/tools/MultiResGrid.h``).

The reference's ``GridTransformer`` applies a decomposed affine map
(scale → rotate → translate) voxel-by-voxel with point/box/quadratic
samplers over TBB leaf ranges; ``MultiResGrid`` stores a mip pyramid and
interpolates between levels.  Here resampling is one gather —
generate the target lattice, push it through the affine map into source
index space, and trilinearly sample; a mip pyramid is repeated 2× mean
pooling (one reshape-mean each) with fractional-level sampling as a lerp
of two pyramid gathers.  Everything jit-safe, fixed shapes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from fluidsim_tpu.ops.advect_volume import sample_trilinear

__all__ = ["affine_resample", "resample_to_match", "mean_pool2",
           "build_pyramid", "sample_pyramid"]


def _target_lattice(bound: int, dtype=jnp.float32):
    c = jnp.arange(-bound, bound + 1, dtype=dtype)
    return jnp.stack(jnp.meshgrid(c, c, c, indexing="ij"), axis=-1)


def affine_resample(src, matrix, translate, bound: int, order: int = 1):
    """Resample ``src`` under the affine map ``x_world = A·x_index + t``
    relative to the identity target lattice: the output at target index
    ``i`` is ``src`` sampled at ``A⁻¹(i − t)`` — i.e. the grid carrying
    ``src`` is transformed *forward* by (A, t), like
    ``GridTransformer::transformGrid`` with an inverse-map gather.

    Args:
      src: (N,N,N) source values on the centered index lattice.
      matrix: (3,3) forward map A (need not be orthogonal).
      translate: (3,) forward translation t, in index units.
      order: 0 = nearest (PointSampler), 1 = trilinear (BoxSampler).
    Out-of-range samples read the background (0), like the reference.
    """
    a = jnp.asarray(matrix, src.dtype)
    t = jnp.asarray(translate, src.dtype)
    n = src.shape[0]
    lattice = _target_lattice(bound, src.dtype).reshape(-1, 3)
    src_pos = jnp.einsum("...i,ji->...j", lattice - t,
                         jnp.linalg.inv(a),
                         precision=jax.lax.Precision.HIGHEST)
    if order == 0:
        cells = jnp.round(src_pos).astype(jnp.int32) + bound
        ok = jnp.all((cells >= 0) & (cells <= n - 1), axis=-1)
        cells = jnp.clip(cells, 0, n - 1)
        vals = src[cells[:, 0], cells[:, 1], cells[:, 2]]
        vals = jnp.where(ok, vals, 0.0)
    else:
        vals = sample_trilinear(src, src_pos, bound)
    return vals.reshape(n, n, n)


def resample_to_match(src, src_dx: float, dst_dx: float, bound: int,
                      order: int = 1):
    """``tools::resampleToMatch``: re-voxelize a grid whose voxel size is
    ``src_dx`` onto a target lattice with voxel size ``dst_dx`` (same
    world origin)."""
    s = dst_dx / src_dx
    return affine_resample(src, jnp.eye(3) / s, jnp.zeros(3), bound,
                           order=order)


def mean_pool2(a):
    """One 2× mean-pooling step (odd trailing slices are dropped), the
    pyramid constructor MultiResGrid uses."""
    n = [d - d % 2 for d in a.shape[:3]]
    a = a[: n[0], : n[1], : n[2]]
    return a.reshape(n[0] // 2, 2, n[1] // 2, 2, n[2] // 2, 2).mean(
        axis=(1, 3, 5))


def build_pyramid(a, levels: int):
    """Mip pyramid [level0 .. level(levels-1)], level 0 = input."""
    out = [a]
    for _ in range(levels - 1):
        out.append(mean_pool2(out[-1]))
    return out


def sample_pyramid(pyramid, pos, bound: int, level: float):
    """``MultiResGrid::sampleValue`` at a fractional ``level``: trilinear
    sample the two bracketing levels in their own index spaces and lerp.

    ``pos`` is (P,3) in level-0 centered index coordinates.
    """
    lo = int(jnp.floor(level))
    lo = max(0, min(lo, len(pyramid) - 1))
    hi = min(lo + 1, len(pyramid) - 1)
    frac = jnp.clip(level - lo, 0.0, 1.0)

    def sample_level(lv):
        grid = pyramid[lv]
        scale = 2.0 ** lv
        # level-lv cell i covers level-0 raw indices [i·s, (i+1)·s), so its
        # center sits at raw0 = (i + 0.5)·s − 0.5; invert for the sample
        # coordinate (exact identity at lv = 0)
        p = (jnp.asarray(pos) + bound + 0.5) / scale - 0.5
        return _sample_raw(grid, p)

    va = sample_level(lo)
    if hi == lo:
        return va
    vb = sample_level(hi)
    return va * (1.0 - frac) + vb * frac


def _sample_raw(grid, p):
    """Trilinear sample in raw (corner-origin) index coordinates for
    even-sized pyramid levels."""
    n0, n1, n2 = grid.shape
    i = jnp.floor(p).astype(jnp.int32)
    f = p - i
    val = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (jnp.where(dx, f[:, 0], 1 - f[:, 0])
                     * jnp.where(dy, f[:, 1], 1 - f[:, 1])
                     * jnp.where(dz, f[:, 2], 1 - f[:, 2]))
                ix = i[:, 0] + dx
                iy = i[:, 1] + dy
                iz = i[:, 2] + dz
                ok = ((ix >= 0) & (ix < n0) & (iy >= 0) & (iy < n1)
                      & (iz >= 0) & (iz < n2))
                ix = jnp.clip(ix, 0, n0 - 1)
                iy = jnp.clip(iy, 0, n1 - 1)
                iz = jnp.clip(iz, 0, n2 - 1)
                val = val + jnp.where(ok, w * grid[ix, iy, iz], 0.0)
    return val
