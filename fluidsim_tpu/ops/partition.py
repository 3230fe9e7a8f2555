"""Particle-by-cell partitioning (``openvdb/tools/PointIndexGrid.h`` /
``PointPartitioner.h`` analogs).

The reference library builds acceleration structures mapping voxels to the
points inside them: ``PointIndexGrid`` stores per-leaf sorted point-index
lists for range queries, and ``PointPartitioner`` bucket-sorts points by
voxel/page for cache-coherent streaming.  The apps never call either
(SURVEY.md §2.2), but the same capability is what makes device transfers
fast, so the framework exposes it as a first-class op: a dense
counts/offsets (CSR) partition built from one sort — the same idiom the
fused transfer kernels use internally (``ops/transfer_fast.py``).

Everything is jit-safe with static shapes: queries return fixed-capacity
index windows rather than Python lists.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from fluidsim_tpu.core.gridspec import flat_index

__all__ = ["CellPartition", "partition_by_cell", "cells_of", "points_in_cell",
           "neighbor_counts"]


class CellPartition(NamedTuple):
    """CSR layout of particle ids grouped by owning cell.

    Attributes:
      order:   (P,) particle ids sorted by flat cell id (the permutation).
      cell_of: (P,) flat cell id per *sorted* slot (``flat[order]``).
      counts:  (N³,) particles per cell.
      offsets: (N³+1,) exclusive prefix sum — cell ``c`` owns sorted slots
               ``offsets[c] : offsets[c+1]``.
    """
    order: jax.Array
    cell_of: jax.Array
    counts: jax.Array
    offsets: jax.Array


def cells_of(pos, bound: int):
    """Owning cell (nearest voxel, OpenVDB ``Coord::round`` convention used
    by the transfers) as flat ids into the dense ``N³`` box."""
    n = 2 * bound + 1
    cells = jnp.clip(jnp.round(pos).astype(jnp.int32) + bound, 0, n - 1)
    return flat_index(cells, n)


def partition_by_cell(pos, bound: int) -> CellPartition:
    """Build the cell partition of a particle set in one sort + one
    scatter-add (the dense replacement for PointPartitioner's bucket radix
    sort)."""
    n = 2 * bound + 1
    flat = cells_of(pos, bound)
    p = pos.shape[0]
    ids = jnp.arange(p, dtype=jnp.int32)
    cell_sorted, order = jax.lax.sort((flat, ids), num_keys=1)
    counts = jnp.zeros((n * n * n,), jnp.int32).at[flat].add(
        1, indices_are_sorted=False)
    offsets = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts, dtype=jnp.int32)])
    return CellPartition(order=order, cell_of=cell_sorted,
                         counts=counts, offsets=offsets)


def points_in_cell(part: CellPartition, flat_cell, capacity: int):
    """Fixed-capacity range query (``PointIndexIterator`` analog): particle
    ids in ``flat_cell``, padded with ``-1`` beyond the true count.

    ``capacity`` is the static max particles per cell (the reference apps
    seed 10/voxel FLIP, 400/voxel MPM — bounded by construction).
    """
    start = part.offsets[flat_cell]
    count = part.counts[flat_cell]
    slots = start + jnp.arange(capacity, dtype=jnp.int32)
    valid = jnp.arange(capacity, dtype=jnp.int32) < count
    p = part.order.shape[0]
    ids = part.order[jnp.clip(slots, 0, p - 1)]
    return jnp.where(valid, ids, -1), count


def neighbor_counts(part: CellPartition, bound: int, radius: int = 1):
    """Dense per-cell count of particles within the ``(2r+1)³`` cell
    neighborhood — the aggregate query PointIndexGrid accelerates (used
    e.g. for density estimation / resampling decisions).  Pure shifted
    adds on the dense counts grid."""
    n = 2 * bound + 1
    c = part.counts.reshape(n, n, n)
    out = jnp.zeros_like(c)
    for dx in range(-radius, radius + 1):
        for dy in range(-radius, radius + 1):
            for dz in range(-radius, radius + 1):
                v = c
                for axis, s in enumerate((dx, dy, dz)):
                    v = jnp.roll(v, s, axis=axis)
                    # zero the wrapped slab (out-of-box reads background 0)
                    if s > 0:
                        idx = [slice(None)] * 3
                        idx[axis] = slice(0, s)
                        v = v.at[tuple(idx)].set(0)
                    elif s < 0:
                        idx = [slice(None)] * 3
                        idx[axis] = slice(s, None)
                        v = v.at[tuple(idx)].set(0)
                out = out + v
    return out
