"""Halo exchange primitives for 1-D slab domain decomposition.

The reference is strictly single-machine shared memory (SURVEY.md §2.4); its
spatial-scaling analog here is slab decomposition of the grid's x-axis over a
``jax.sharding.Mesh``, with 1- or 2-cell halos exchanged via
``jax.lax.ppermute`` — which XLA lowers to neighbour sends between devices
(NCCL over NVLink on a multi-GPU host).  All
helpers are written to run *inside* ``shard_map`` over a named mesh axis.

Boundary devices exchange with nobody; ``ppermute`` fills missing links with
zeros, which exactly matches the solver's "outside the box reads as
background 0 / non-solid" convention (``fluid.cc:447-471`` bounds checks).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _perm(n, shift):
    """Non-cyclic neighbour permutation: device i sends to i+shift."""
    return [(i, i + shift) for i in range(n) if 0 <= i + shift < n]


def exchange_halo(slab, width: int, axis: str):
    """(Nl, ...) -> (Nl + 2*width, ...): append both neighbours' edges.

    Zeros beyond the physical domain ends.
    """
    n = jax.lax.axis_size(axis)
    right_edge = slab[-width:]          # goes to right neighbour's left halo
    left_edge = slab[:width]            # goes to left neighbour's right halo
    from_left = jax.lax.ppermute(right_edge, axis, _perm(n, 1))
    from_right = jax.lax.ppermute(left_edge, axis, _perm(n, -1))
    return jnp.concatenate([from_left, slab, from_right], axis=0)


def halo_reduce(ext, width: int, axis: str):
    """(Nl + 2*width, ...) -> (Nl, ...): fold halo contributions back into
    the owning neighbours (the scatter-side counterpart of exchange_halo).

    Device i's left halo holds contributions to device i-1's right interior;
    ship it left and add, and vice versa.
    """
    n = jax.lax.axis_size(axis)
    left_halo = ext[:width]
    right_halo = ext[-width:]
    interior = ext[width:-width]
    add_right = jax.lax.ppermute(right_halo, axis, _perm(n, 1))   # from left nb
    add_left = jax.lax.ppermute(left_halo, axis, _perm(n, -1))    # from right nb
    interior = interior.at[:width].add(add_right)
    interior = interior.at[-width:].add(add_left)
    return interior


def migrate_edge_bands(band_l, mask_l, band_r, mask_r, axis: str):
    """Ship raw *sorted edge-band* rows to the two neighbours.

    When the caller keeps its particles sorted by cell (dead slots at the
    tail) and the CFL bound caps moves at one cell per step, every
    left-sender lives in the first ``F`` sorted rows and every right-sender
    in the last ``F`` rows of the alive prefix — so migration can ship the
    raw band slices with their sender masks and skip compaction entirely.
    This replaces the full-P cumsum/scatter pack of ``migrate_neighbors``,
    whose work grows with every row of the shard, with work of O(F).

    ``band_l``/``mask_l`` go to the LEFT neighbour, ``band_r``/``mask_r``
    to the RIGHT.  Returns ``(incoming (2F, D), valid (2F,))`` — rows from
    the left neighbour first.  Missing links (domain ends) arrive as zeros,
    i.e. ``valid = False``.
    """
    n = jax.lax.axis_size(axis)
    in_from_left = (jax.lax.ppermute(band_r, axis, _perm(n, 1)),
                    jax.lax.ppermute(mask_r, axis, _perm(n, 1)))
    in_from_right = (jax.lax.ppermute(band_l, axis, _perm(n, -1)),
                     jax.lax.ppermute(mask_l, axis, _perm(n, -1)))
    incoming = jnp.concatenate([in_from_left[0], in_from_right[0]], axis=0)
    valid = jnp.concatenate([in_from_left[1], in_from_right[1]], axis=0)
    return incoming, valid


def migrate_neighbors(payload, send_left, send_right, capacity: int, axis: str):
    """Fixed-size nearest-neighbour particle migration.

    Args:
      payload: (P, D) particle payload rows.
      send_left/send_right: (P,) bool masks (disjoint).
      capacity: max rows shipped per direction per step (static).
    Returns:
      (incoming_payload (2*capacity, D), incoming_valid (2*capacity,),
       dropped: number of rows that exceeded capacity).
    """
    n = jax.lax.axis_size(axis)

    def pack(mask):
        # cumsum-rank compaction: one scan + one masked scatter, ~2
        # passes over the mask/payload (the jnp.nonzero(size=capacity)
        # form is a sort-like pass).
        rank = jnp.cumsum(mask) - 1                      # (P,) int
        tgt = jnp.where(mask & (rank < capacity), rank, capacity)
        rows = jnp.zeros((capacity, payload.shape[1]),
                         payload.dtype).at[tgt].set(payload, mode="drop")
        nvalid = jnp.minimum(jnp.sum(mask), capacity)
        valid = jnp.arange(capacity) < nvalid
        return rows, valid

    rows_l, valid_l = pack(send_left)
    rows_r, valid_r = pack(send_right)
    in_from_right = (jax.lax.ppermute(rows_l, axis, _perm(n, -1)),
                     jax.lax.ppermute(valid_l, axis, _perm(n, -1)))
    in_from_left = (jax.lax.ppermute(rows_r, axis, _perm(n, 1)),
                    jax.lax.ppermute(valid_r, axis, _perm(n, 1)))
    incoming = jnp.concatenate([in_from_left[0], in_from_right[0]], axis=0)
    valid = jnp.concatenate([in_from_left[1], in_from_right[1]], axis=0)
    dropped = (jnp.sum(send_left) - jnp.sum(valid_l)
               + jnp.sum(send_right) - jnp.sum(valid_r))
    return incoming, valid, dropped
