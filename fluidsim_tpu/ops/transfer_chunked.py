"""Chunked fused transfers for large single-device grids.

The fused schedule's dense 128-channel f32 tables cost ``N^3 x 512`` bytes
each — ~8.7 GB at 257^3, more than a small device can hold next to the rest
of the frame.  This variant processes the grid
in ``n_chunks`` x-slabs inside a ``lax.fori_loop``: per slab it scatters only
that slab's (sorted, hence contiguous) particles into a slab-local table and
writes the slab's dense output, so peak memory drops by ~``n_chunks``x.

Particle ranges per slab are dynamic; slices use a static per-slab capacity
(``cap = ceil(chunk_factor * P / n_chunks)``).  Overflow is NOT silent: the
number of particles beyond capacity is returned so callers can surface it
(the default 4x headroom covers the measured worst case of the headline
scenes; the 257^3 cube concentrates ~39% of particles in its central slabs).  Sharded execution remains the preferred
route at this scale; this exists so one chip can still run it.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from fluidsim_tpu.core.splines import cround
from fluidsim_tpu.ops.transfer import _OFFSETS
from fluidsim_tpu.ops.transfer_fast import _stencil_w, _shift3


def _slab_bounds(flat_s, n, rows_per_chunk, n_chunks):
    """Start index of each slab's particle range in the sorted order."""
    slab_first_id = (jnp.arange(n_chunks + 1) * rows_per_chunk) * n * n
    return jnp.searchsorted(flat_s, slab_first_id)


def p2g_fused_chunked(pos_s, vel_s, flat_s, solid, bound: int,
                      kernel: str = "flip", n_chunks: int = 8,
                      chunk_factor: float = 4.0):
    """Chunked equivalent of ``transfer_fast.p2g_fused``.

    Returns (weights, mom, occ, overflow) — ``overflow`` counts particles
    that exceeded the per-slab capacity and were dropped from the transfer.
    """
    n = 2 * bound + 1
    p_total = pos_s.shape[0]
    rows = -(-n // n_chunks)               # grid rows per slab
    cap = int(np.ceil(chunk_factor * p_total / n_chunks))
    npad = rows * n_chunks

    w27 = _stencil_w(pos_s, kernel)
    valid = jnp.all(jnp.abs(cround(pos_s)) <= bound, axis=-1)
    w27 = jnp.where(valid[:, None], w27, 0.0)
    u = jnp.concatenate([w27[..., None],
                         w27[..., None] * vel_s[:, None, :]], axis=-1)
    u_flat = u.reshape(p_total, 27 * 4)

    starts = _slab_bounds(flat_s, n, rows, n_chunks)
    counts = starts[1:] - starts[:-1]
    overflow = jnp.sum(jnp.maximum(counts - cap, 0))

    # output with one halo row per side per slab handled by shifting within
    # an extended slab then accumulating into the global array
    out = jnp.zeros((npad + 2, n, n, 4), pos_s.dtype)

    def body(k, out):
        s = starts[k]
        cnt = jnp.minimum(counts[k], cap)
        idx = jnp.clip(s + jnp.arange(cap), 0, p_total - 1)
        sel = jnp.arange(cap) < cnt
        uu = jnp.where(sel[:, None], u_flat[idx], 0.0)
        local_flat = flat_s[idx] - k * rows * n * n     # offset into slab
        local_flat = jnp.clip(local_flat, 0, rows * n * n - 1)
        d = jnp.zeros((rows * n * n, 27 * 4), pos_s.dtype).at[local_flat].add(
            uu, indices_are_sorted=True)
        d = d.reshape(rows, n, n, 27, 4)
        # pad one halo row each side so shifted contributions land locally
        ext = jnp.pad(d, ((1, 1), (0, 0), (0, 0), (0, 0), (0, 0)))
        acc = jnp.zeros((rows + 2, n, n, 4), pos_s.dtype)
        for o in range(27):
            acc = acc + _shift3(ext[..., o, :], _OFFSETS[o])
        return jax.lax.dynamic_update_slice(
            out, acc + jax.lax.dynamic_slice(
                out, (k * rows, 0, 0, 0), (rows + 2, n, n, 4)),
            (k * rows, 0, 0, 0))

    out = jax.lax.fori_loop(0, n_chunks, body, out)
    acc = out[1:n + 1]

    coords = np.abs(np.arange(-bound, bound + 1))
    wi = coords <= bound - 2
    p2g_mask = jnp.asarray(wi[:, None, None] & wi[None, :, None]
                           & wi[None, None, :]) & (~solid)
    weights = jnp.where(p2g_mask, acc[..., 0], 0.0)
    mom = jnp.where(p2g_mask[..., None], acc[..., 1:4], 0.0)
    occ = jnp.where(~solid, acc[..., 0], 0.0)
    return weights, mom, occ, overflow


def g2p_fused_chunked(pos_s, flat_s, fields, bound: int, wall: int,
                      kernel: str = "flip", n_chunks: int = 8,
                      chunk_factor: float = 4.0):
    """Chunked equivalent of ``transfer_fast.g2p_fused`` (C field channels).

    Builds each slab's neighbourhood table from a halo-padded slice of the
    dense fields and gathers only that slab's particles.
    """
    n = 2 * bound + 1
    c = fields.shape[-1]
    p_total = pos_s.shape[0]
    rows = -(-n // n_chunks)
    cap = int(np.ceil(chunk_factor * p_total / n_chunks))
    npad = rows * n_chunks

    coords = np.abs(np.arange(-bound, bound + 1))
    ok = coords <= wall
    within = jnp.asarray(ok[:, None, None] & ok[None, :, None]
                         & ok[None, None, :])
    fm = jnp.concatenate([jnp.where(within[..., None], fields, 0.0),
                          within[..., None].astype(fields.dtype)], axis=-1)
    fm = jnp.pad(fm, ((1, npad - n + 1), (0, 0), (0, 0), (0, 0)))

    w27 = _stencil_w(pos_s, kernel)
    valid = jnp.all(jnp.abs(cround(pos_s)) <= bound, axis=-1)
    w27v = jnp.where(valid[:, None], w27, 0.0)

    starts = _slab_bounds(flat_s, n, rows, n_chunks)
    counts = starts[1:] - starts[:-1]
    overflow = jnp.sum(jnp.maximum(counts - cap, 0))
    result = jnp.zeros((p_total, c), pos_s.dtype)

    def body(k, result):
        s = starts[k]
        cnt = jnp.minimum(counts[k], cap)
        idx = jnp.clip(s + jnp.arange(cap), 0, p_total - 1)
        sel = jnp.arange(cap) < cnt
        # slab fields with 1-row halo each side (fm is x-padded by 1)
        slab = jax.lax.dynamic_slice(fm, (k * rows, 0, 0, 0),
                                     (rows + 2, n, n, c + 1))
        cols = [_shift3(slab, -_OFFSETS[o]) for o in range(27)]
        table = jnp.stack(cols, axis=-2)[1:-1].reshape(
            rows * n * n, 27 * (c + 1))
        local_flat = jnp.clip(flat_s[idx] - k * rows * n * n, 0,
                              rows * n * n - 1)
        rws = table[local_flat].reshape(cap, 27, c + 1)
        wm = w27v[idx] * rws[..., c]
        num = jnp.sum(wm[..., None] * rws[..., :c], axis=1)
        den = jnp.sum(wm, axis=1)
        safe = jnp.where(den != 0, den, 1.0)
        vals = jnp.where((den[:, None] != 0) & sel[:, None],
                         num / safe[:, None], 0.0)
        return result.at[idx].add(jnp.where(sel[:, None], vals, 0.0),
                                  indices_are_sorted=True)

    result = jax.lax.fori_loop(0, n_chunks, body, result)
    return result, overflow
