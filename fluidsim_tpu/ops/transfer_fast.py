"""Sorted, channel-fused particle transfers — FLIP's production path.

The naive ``ops.transfer`` P2G issues a 27-point scatter-add with heavily
colliding, unsorted indices: 27 index fan-outs per particle into the grid.

This module restructures the transfers around three observations:

1. **Sorting makes neighbours contiguous.**  Sorting the particles by their
   base cell id puts every scatter AND gather on sorted indices
   (``indices_are_sorted=True``); particle order is semantically free.

2. **All 27 stencil targets are constant shifts of the base cell**, so the
   entire P2G reduces to ONE sorted scatter of a 108-channel value vector
   (27 offsets x [w, w*vx, w*vy, w*vz]) into the base cell, followed by 27
   *dense* shifted adds — pure stencil arithmetic XLA vectorises fully.

3. **Every mask in the reference is a property of the target cell only**
   (in-box, not-solid, within bound-2: ``fluid.cc:288,870``; within-wall for
   gathers: ``fluid.cc:162,237``), so masking moves to the dense side after
   aggregation — no per-(particle, offset) mask gathers are needed.  As a
   corollary, with the standard wall geometry the occupancy grid
   (``PointList::interpolate``) and the P2G weight grid are the same dense
   field under two different cell masks, so occupancy is free.

G2P runs the trick in reverse: 27 dense shifts pack each cell's neighbourhood
(values + validity mask) into a 108-channel table, and each particle does ONE
sorted row-gather plus a 27-point weighted reduction.

Semantics are identical to ``ops.transfer`` (tested against it); only the
schedule differs.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from fluidsim_tpu.core.splines import cround
from fluidsim_tpu.ops.transfer import _OFFSETS, _KERNELS


def _shift3(a, d):
    """result[j] = a[j - d] with zero padding, d a static (dx, dy, dz)."""
    out = a
    for ax in range(3):
        s = int(d[ax])
        if s == 0:
            continue
        n_ax = out.shape[ax]
        pad = [(0, 0)] * out.ndim
        idx = [slice(None)] * out.ndim
        if s > 0:
            pad[ax] = (s, 0)
            idx[ax] = slice(0, n_ax)
        else:
            pad[ax] = (0, -s)
            idx[ax] = slice(-s, n_ax - s)
        out = jnp.pad(out, pad)[tuple(idx)]
    return out


def sort_by_cell(pos, vel, bound: int, extra=None):
    """Sort particles by base-cell flat id.

    Returns ``(pos_s, vel_s, flat_s)`` or ``(pos_s, vel_s, flat_s, extra_s)``
    when an additional ``(P, K)`` payload (e.g. APIC C matrices flattened)
    is given.  Out-of-box particles (e.g. migration sentinels) clip to the
    boundary cell; their transfer weights vanish anyway.
    """
    n = 2 * bound + 1
    base = cround(pos).astype(jnp.int32)
    bc = jnp.clip(base + bound, 0, n - 1)
    flat = (bc[:, 0] * n + bc[:, 1]) * n + bc[:, 2]
    ops = [flat, pos[:, 0], pos[:, 1], pos[:, 2], vel[:, 0], vel[:, 1], vel[:, 2]]
    k = 0
    if extra is not None:
        k = extra.shape[1]
        ops += [extra[:, i] for i in range(k)]
    out = jax.lax.sort(ops, num_keys=1)
    flat_s = out[0]
    pos_s = jnp.stack(out[1:4], axis=-1)
    vel_s = jnp.stack(out[4:7], axis=-1)
    if extra is None:
        return pos_s, vel_s, flat_s
    extra_s = jnp.stack(out[7:7 + k], axis=-1)
    return pos_s, vel_s, flat_s, extra_s


def _stencil_w(pos, kernel: str):
    """(P, 27) tensor-product weights for the 27 offsets around round(pos)."""
    base = cround(pos)
    offs = jnp.asarray(_OFFSETS, pos.dtype)
    d = pos[:, None, :] - (base[:, None, :] + offs[None])
    w = _KERNELS[kernel](d)
    return w[..., 0] * w[..., 1] * w[..., 2]


def p2g_fused(pos_s, vel_s, flat_s, solid, bound: int, kernel: str = "flip"):
    """Full P2G (weights + momentum + occupancy) in one sorted scatter.

    The inner scatter bound is ``bound - 2`` exactly as the reference
    hardcodes it (``fluid.cc:288``), independent of the scene's wall
    threshold; with the standard wall geometry (wall == bound - 2, both
    reference apps) occupancy shares the weight field under its own mask.

    Args:
      pos_s/vel_s/flat_s: sorted particle arrays from ``sort_by_cell``.
    Returns:
      weights (N,N,N), mom (N,N,N,3), occ (N,N,N).
    """
    n = 2 * bound + 1
    w27 = _stencil_w(pos_s, kernel)                                # (P, 27)
    # kill particles whose base cell is outside the box (e.g. migration
    # sentinels): their clipped flat id would otherwise deposit at the edge.
    valid = jnp.all(jnp.abs(cround(pos_s)) <= bound, axis=-1)
    w27 = jnp.where(valid[:, None], w27, 0.0)
    u = jnp.concatenate([w27[..., None],
                         w27[..., None] * vel_s[:, None, :]], axis=-1)  # (P,27,4)
    d = jnp.zeros((n * n * n, 27 * 4), pos_s.dtype).at[flat_s].add(
        u.reshape(-1, 27 * 4), indices_are_sorted=True)
    d = d.reshape(n, n, n, 27, 4)

    acc = jnp.zeros((n, n, n, 4), pos_s.dtype)
    for o in range(27):
        acc = acc + _shift3(d[..., o, :], _OFFSETS[o])

    coords = np.abs(np.arange(-bound, bound + 1))
    within_in = ((coords <= bound - 2)[:, None, None]
                 & (coords <= bound - 2)[None, :, None]
                 & (coords <= bound - 2)[None, None, :])
    p2g_mask = jnp.asarray(within_in) & (~solid)        # fluid.cc:288
    occ_mask = ~solid                                    # fluid.cc:870
    weights = jnp.where(p2g_mask, acc[..., 0], 0.0)
    mom = jnp.where(p2g_mask[..., None], acc[..., 1:4], 0.0)
    occ = jnp.where(occ_mask, acc[..., 0], 0.0)
    return weights, mom, occ


def _neighborhood_table(fields, mask, n):
    """Pack each cell's 27-neighbourhood of ``fields`` (C channels) plus the
    27 validity-mask channels into an (N^3, 27*(C+1)) table via dense shifts:
    table[k, o, :] = [fields[k+o] * mask[k+o], mask[k+o]]."""
    c = fields.shape[-1]
    fm = jnp.concatenate([
        jnp.where(mask[..., None], fields, 0.0),
        mask[..., None].astype(fields.dtype)], axis=-1)            # (N,N,N,C+1)
    cols = []
    for o in range(27):
        cols.append(_shift3(fm, -_OFFSETS[o]))
    table = jnp.stack(cols, axis=-2)                               # (N,N,N,27,C+1)
    return table.reshape(n * n * n, 27 * (c + 1))


def g2p_fused(pos_s, flat_s, fields, bound: int, wall: int,
              kernel: str = "flip"):
    """Weighted 27-point gather of cell-level ``fields`` (C channels),
    normalised by the summed weight over valid (within-wall) cells — the
    shared core of ``clampedCatmullRom``/``CatmullRomFLIP``
    (``fluid.cc:125-263``).
    """
    n = 2 * bound + 1
    c = fields.shape[-1]
    coords = np.abs(np.arange(-bound, bound + 1))
    ok = coords <= wall
    within = jnp.asarray(ok[:, None, None] & ok[None, :, None]
                         & ok[None, None, :])
    table = _neighborhood_table(fields, within, n)                 # (N^3, 27*(C+1))
    rows = table[flat_s]                                           # sorted gather
    rows = rows.reshape(-1, 27, c + 1)
    w27 = _stencil_w(pos_s, kernel)
    valid = jnp.all(jnp.abs(cround(pos_s)) <= bound, axis=-1)
    w27 = jnp.where(valid[:, None], w27, 0.0)
    wm = w27 * rows[..., c]                  # zero where neighbour invalid
    num = jnp.sum(wm[..., None] * rows[..., :c], axis=1)
    den = jnp.sum(wm, axis=1)
    safe = jnp.where(den != 0, den, 1.0)
    return jnp.where(den[:, None] != 0, num / safe[:, None], 0.0)
