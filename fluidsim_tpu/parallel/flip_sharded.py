"""Multi-device FLIP: slab domain decomposition over a 1-D device mesh.

This is the scaling story the reference cannot tell (it is a single-process
TBB program, SURVEY.md §2.4): the grid's x-axis is sharded into slabs over a
``jax.sharding.Mesh``, every step runs SPMD under ``shard_map``, and the only
cross-device traffic is

* 2-cell halo exchange of grid fields (``ppermute``) around the
  P2G scatter and G2P gather,
* 1-cell halo exchange of the pressure field per CG iteration,
* ``psum``/``pmax`` for CG dot products, outer-loop norms, and the CFL dt,
* fixed-capacity nearest-neighbour particle migration after advection.

Particles live on the shard that owns their cell slab; dead/padding slots
are parked at a sentinel position far outside the box so every transfer op
masks them out naturally (their stencil fails the in-bounds test).

Numerics match the single-chip ``models.flip`` step exactly up to f32
reduction order (see ``tests/test_parallel.py``).
"""

from __future__ import annotations

import dataclasses
import math
import os
import warnings
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from fluidsim_tpu.core.splines import cround
from fluidsim_tpu.ops import pressure as pr
from fluidsim_tpu.ops import transfer
from fluidsim_tpu.ops.pcg import pcg, jacobi_preconditioner
from fluidsim_tpu.models.flip import (FlipParams, advect_bounce,
                                      auto_pcg_rtol)
from fluidsim_tpu.parallel.halo import (exchange_halo, halo_reduce,
                                        migrate_edge_bands,
                                        migrate_neighbors)
from fluidsim_tpu.scenes import Scene, get_scene
from fluidsim_tpu.seeding import seed_particles

AX = "x"          # mesh axis name
W = 2             # transfer halo width (stencil 1 + cell-centre average 1)
SENTINEL = 1.0e6  # parking position for dead particle slots


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ShardedFlipState:
    pos: jax.Array      # (ndev*cap, 3), sharded on axis 0
    vel: jax.Array      # (ndev*cap, 3)
    alive: jax.Array    # (ndev*cap,) bool
    dt: jax.Array       # () replicated
    t: jax.Array
    frame: jax.Array
    pressure: jax.Array | None = None  # (ndev*nl, n, n) slab-sharded warm start


def _local_scatter(cells, values, weights_mask, x0, nl, n, width):
    """Scatter (P, 27) values into a halo-extended local slab.

    cells: (P, 27, 3) global grid coordinates (may be invalid; masked).
    Returns (nl + 2*width, n, n) accumulated array.
    """
    gx = cells[..., 0]
    lx = gx - x0 + width
    in_slab = (lx >= 0) & (lx < nl + 2 * width)
    mask = weights_mask & in_slab
    lxc = jnp.clip(lx, 0, nl + 2 * width - 1)
    gy = jnp.clip(cells[..., 1], 0, n - 1)
    gz = jnp.clip(cells[..., 2], 0, n - 1)
    flat = (lxc * n + gy) * n + gz
    vals = jnp.where(mask, values, 0.0)
    out = jnp.zeros(((nl + 2 * width) * n * n,), values.dtype)
    return out.at[flat.reshape(-1)].add(vals.reshape(-1)).reshape(
        nl + 2 * width, n, n)


def _local_gather(ext, cells, x0, nl, n, width):
    """Gather per-(particle, stencil-cell) rows from a halo-extended slab.

    ext: (nl + 2*width, n, n, C).  Invalid cells must be masked by the caller.
    """
    lx = jnp.clip(cells[..., 0] - x0 + width, 0, nl + 2 * width - 1)
    gy = jnp.clip(cells[..., 1], 0, n - 1)
    gz = jnp.clip(cells[..., 2], 0, n - 1)
    flat = (lx * n + gy) * n + gz
    return ext.reshape(-1, ext.shape[-1])[flat]


def _cell_center_ext(vel_ext):
    """Cell-centred velocity on an extended slab (valid except the last row)."""
    from fluidsim_tpu.core.gridspec import cell_center_velocity
    return cell_center_velocity(vel_ext)


def _sort_local(pos, vel, alive, x0, nl, n, bound):
    """Sort the local particle slots by their ext-slab flat cell id.

    Dead (sentinel) slots sort to the end (their clipped id is the max);
    returns sorted (pos, vel, alive, flat_ext) with flat ids valid for the
    (nl + 2W, n, n) extended slab.
    """
    base = cround(pos).astype(jnp.int32)
    lx = jnp.clip(base[:, 0] + bound - x0 + W, 0, nl + 2 * W - 1)
    gy = jnp.clip(base[:, 1] + bound, 0, n - 1)
    gz = jnp.clip(base[:, 2] + bound, 0, n - 1)
    flat = (lx * n + gy) * n + gz
    ops = [flat, pos[:, 0], pos[:, 1], pos[:, 2],
           vel[:, 0], vel[:, 1], vel[:, 2], alive.astype(jnp.float32)]
    out = jax.lax.sort(ops, num_keys=1)
    return (jnp.stack(out[1:4], -1), jnp.stack(out[4:7], -1),
            out[7] > 0.5, out[0])


def _p2g_fused_local(pos_s, vel_s, flat_s, x0, nl, n, bound):
    """Fused 108-channel scatter into the extended slab + 27 dense shifts,
    before halo reduction and cell masking (the sharded analogue of
    ``transfer_fast.p2g_fused``)."""
    from fluidsim_tpu.ops.transfer_fast import _stencil_w, _shift3
    from fluidsim_tpu.ops.transfer import _OFFSETS as OFFS
    w27 = _stencil_w(pos_s, "flip")
    valid = jnp.all(jnp.abs(cround(pos_s)) <= bound, axis=-1)
    w27 = jnp.where(valid[:, None], w27, 0.0)
    u = jnp.concatenate([w27[..., None],
                         w27[..., None] * vel_s[:, None, :]], axis=-1)
    rows = nl + 2 * W
    d = jnp.zeros((rows * n * n, 27 * 4), pos_s.dtype).at[flat_s].add(
        u.reshape(-1, 27 * 4), indices_are_sorted=True)
    d = d.reshape(rows, n, n, 27, 4)
    acc = jnp.zeros((rows, n, n, 4), pos_s.dtype)
    for o in range(27):
        acc = acc + _shift3(d[..., o, :], OFFS[o])
    return acc       # (nl+2W, n, n, 4): [w, w*vx, w*vy, w*vz]


def _g2p_fused_local(pos_s, flat_s, fields_ext, within_wall_ext, bound):
    """Sharded analogue of ``transfer_fast.g2p_fused`` over an extended
    slab: 27 shifts pack neighbourhood tables, one sorted row-gather."""
    from fluidsim_tpu.ops.transfer_fast import _stencil_w, _shift3
    from fluidsim_tpu.ops.transfer import _OFFSETS as OFFS
    rows, n = fields_ext.shape[0], fields_ext.shape[1]
    c = fields_ext.shape[-1]
    fm = jnp.concatenate([
        jnp.where(within_wall_ext[..., None], fields_ext, 0.0),
        within_wall_ext[..., None].astype(fields_ext.dtype)], axis=-1)
    cols = [_shift3(fm, -OFFS[o]) for o in range(27)]
    table = jnp.stack(cols, axis=-2).reshape(rows * n * n, 27 * (c + 1))
    rws = table[flat_s].reshape(-1, 27, c + 1)
    w27 = _stencil_w(pos_s, "flip")
    valid = jnp.all(jnp.abs(cround(pos_s)) <= bound, axis=-1)
    wm = jnp.where(valid[:, None], w27, 0.0) * rws[..., c]
    num = jnp.sum(wm[..., None] * rws[..., :c], axis=1)
    den = jnp.sum(wm, axis=1)
    safe = jnp.where(den != 0, den, 1.0)
    return jnp.where(den[:, None] != 0, num / safe[:, None], 0.0)


def _sharded_step(params: FlipParams, nl: int, cap: int, mig_cap: int,
                  solid_full, solid_pad_ext, state: ShardedFlipState,
                  tail_insert: bool = True):
    """SPMD body: runs per device under shard_map."""
    B, wall, n = params.bound, params.wall, 2 * params.bound + 1
    dx, rho = params.dx, params.rho
    g = jnp.asarray(params.gravity, state.pos.dtype)
    me = jax.lax.axis_index(AX)
    ndev = jax.lax.axis_size(AX)
    x0 = me * nl
    pos, vel, alive, dt = state.pos, state.vel, state.alive, state.dt

    def psum(x):
        return jax.lax.psum(x, AX)

    # ---- static local geometry ----
    solid_ext = jax.lax.dynamic_slice(
        solid_pad_ext, (x0, 0, 0), (nl + 2 * W, n, n))       # bool, halo W
    solid_loc = solid_ext[W:-W]
    solid_ext1 = solid_ext[W - 1:nl + W + 1]                 # halo-1 view

    # ---- P2G (fluid.cc:1384) ----
    if params.fast_transfer:
        # fused path: sort by ext-slab cell, one 108-ch scatter + shifts.
        # With the standard wall geometry (wall == bound-2, the only layout
        # the sharded solver supports) the within-(B-2) and occupancy masks
        # both collapse to ~solid, so occupancy shares the weight field.
        pos, vel, alive, flat_ext = _sort_local(pos, vel, alive, x0, nl,
                                                n, B)
        acc = _p2g_fused_local(pos, vel, flat_ext, x0, nl, n, B)
        red = jnp.stack([halo_reduce(acc[..., c], W, AX) for c in range(4)],
                        axis=-1)
        ns_loc = (~solid_loc)[..., None]
        weights = jnp.where(ns_loc[..., 0], red[..., 0], 0.0)
        mom = jnp.where(ns_loc, red[..., 1:4], 0.0)
        occ = weights
        velg = transfer.normalize_velocity(weights, mom)
    else:
        cells, inb = transfer.particle_stencil(pos, B)
        w = transfer.stencil_weights(pos, cells, params.kernel)
        within_in = jnp.all(jnp.abs(cells) < B - 1, axis=-1)  # |c| <= B-2
        sflat = solid_full.reshape(-1)
        gidx = jnp.clip(cells + B, 0, n - 1)
        cell_solid = sflat[(gidx[..., 0] * n + gidx[..., 1]) * n + gidx[..., 2]]
        p2g_mask = inb & within_in & ~cell_solid

        wm = jnp.where(p2g_mask, w, 0.0)
        weights = halo_reduce(_local_scatter(cells + B,
                                             wm, p2g_mask, x0, nl, n, W), W, AX)
        mom = jnp.stack([
            halo_reduce(_local_scatter(cells + B,
                                       wm * vel[:, None, d], p2g_mask,
                                       x0, nl, n, W), W, AX)
            for d in range(3)], axis=-1)
        velg = transfer.normalize_velocity(weights, mom)

        # occupancy (fluid.cc:1413): mask = in-bounds & not solid & w > 0
        occ_mask = inb & ~cell_solid & (w > 0)
        occ = halo_reduce(_local_scatter(cells + B,
                                         jnp.where(occ_mask, w, 0.0), occ_mask,
                                         x0, nl, n, W), W, AX)
    fluid = (occ > 0) & (~solid_loc)
    velb = velg

    # ---- pressure projection do-while (fluid.cc:1457-1484) ----
    adiag_scale = dt / (rho * dx * dx)
    ns = (~solid_ext1).astype(velg.dtype)
    count = jnp.zeros_like(ns)
    from fluidsim_tpu.core.gridspec import shift_to_plus, shift_to_minus
    for d in range(3):
        count = count + shift_to_plus(ns, d) + shift_to_minus(ns, d)
    adiag = jnp.where(fluid, adiag_scale * count[1:-1], 0.0)

    def apply_a(p):
        p_ext = exchange_halo(jnp.where(fluid, p, 0.0), 1, AX)
        fl_ext = exchange_halo(fluid, 1, AX)
        ad_ext = exchange_halo(adiag, 1, AX)
        out = pr.apply_laplacian(p_ext, ad_ext, fl_ext, dt, rho, dx)
        return out[1:-1]

    precond = jacobi_preconditioner(adiag, mask=fluid)
    if params.preconditioner == "chebyshev":
        # Polynomial preconditioning is even better multi-device than
        # single: the d+1 in-precond applies only exchange 1-cell halos,
        # while cutting ~(d+1)x the number of CG iterations — i.e. the
        # number of GLOBAL psum dot-product rounds per solve.
        from fluidsim_tpu.ops.pcg import chebyshev_preconditioner
        precond = chebyshev_preconditioner(apply_a, precond,
                                           degree=params.cheb_degree,
                                           ratio=params.cheb_ratio)

    def norm(x):
        return jnp.sqrt(psum(jnp.sum((x * x).astype(jnp.float32))))

    fluid_ext = exchange_halo(fluid, 1, AX)

    def one_pass(vg, px0):
        vg_ext = exchange_halo(vg, 1, AX)
        rhs = pr.set_rhs(vg_ext, fluid_ext, solid_ext1, g, dt, dx)[1:-1]
        rhs_ext = exchange_halo(rhs, 1, AX)
        b = pr.divergence_rhs(vg_ext, rhs_ext, fluid_ext, solid_ext1, dx)[1:-1]
        res = pcg(apply_a, b, x0=px0, precond=precond,
                  rtol=params.pcg_rtol or auto_pcg_rtol(n),
                  maxiter=params.pcg_maxiter, reduce_fn=psum)
        x, iters = res.x, res.iters
        p_ext = exchange_halo(jnp.where(fluid, x, 0.0), 1, AX)
        vg2 = pr.vel_update(vg_ext, p_ext, fluid_ext, solid_ext1, g, dt,
                            rho, dx)[1:-1]
        vg2_ext = exchange_halo(vg2, 1, AX)
        rhs2 = pr.set_rhs(vg2_ext, fluid_ext, solid_ext1, g, dt, dx)[1:-1]
        rhs2_ext = exchange_halo(rhs2, 1, AX)
        b2 = pr.divergence_rhs(vg2_ext, rhs2_ext, fluid_ext, solid_ext1,
                               dx)[1:-1]
        bn = norm(b)
        err = jnp.where(bn > 0, norm(b - b2) / jnp.where(bn > 0, bn, 1.0), 0.0)
        return vg2, err, iters, x

    # warm start: previous frame's slab pressure, masked to current fluid
    # cells (see models/flip.py:project); later passes reuse the previous
    # pass's solution
    p_prev = (jnp.zeros_like(fluid, dtype=velg.dtype)
              if state.pressure is None
              else jnp.where(fluid, state.pressure, 0.0))

    def body(carry):
        vg, _, it, cg_tot, px = carry
        vg, err, iters, px = one_pass(vg, px)
        return vg, err, it + 1, cg_tot + iters, px

    carry = body((velg, jnp.inf, jnp.zeros((), jnp.int32),
                  jnp.zeros((), jnp.int32), p_prev))
    velg, err, n_outer, cg_iters, pressure = jax.lax.while_loop(
        lambda c: (c[1] > params.outer_tol) & (c[2] < params.max_outer),
        body, carry)

    # ---- FLIP delta gather (fluid.cc:1490, CatmullRomFLIP 210-263) ----
    # cell-centre averaging is linear, so the delta field needs ONE halo
    # exchange + ONE centring of (velg - velb) instead of two of each
    # (ulp-level reordering vs the two-field form; the parity oracles'
    # 2e-3 KE tolerance covers it)
    dvc = _cell_center_ext(exchange_halo(velg - velb, W, AX))
    if params.fast_transfer:
        # within-wall mask on the extended slab, from global coordinates
        gi = jax.lax.broadcasted_iota(jnp.int32, (nl + 2 * W, n, n), 0) \
            + x0 - W - B
        cy = np.abs(np.arange(-B, B + 1)) <= wall
        wall_yz = jnp.asarray(cy[:, None] & cy[None, :])
        within_ext = (jnp.abs(gi) <= wall) & wall_yz[None, :, :]
        delta = _g2p_fused_local(pos, flat_ext, dvc, within_ext, B)
    else:
        within_wall = jnp.all(jnp.abs(cells) <= wall, axis=-1)
        gmask = inb & within_wall
        wg = jnp.where(gmask, w, 0.0)
        dv = _local_gather(dvc, cells + B,
                           x0, nl, n, W)
        num = jnp.sum(wg[..., None] * dv, axis=1)
        den = jnp.sum(wg, axis=1)
        delta = jnp.where(den[:, None] != 0,
                          num / jnp.where(den[:, None] != 0, den[:, None], 1.0),
                          0.0)
    vel = jnp.where(alive[:, None], vel + delta, 0.0)

    # ---- CFL (pmax over shards) ----
    speed = jnp.sqrt(jnp.sum(vel * vel, axis=-1))
    max_speed = jax.lax.pmax(jnp.max(jnp.where(alive, speed, 0.0)), AX)
    dt_new = jnp.where(max_speed != 0,
                       jnp.minimum(params.max_dt, dx / max_speed),
                       params.max_dt)

    # ---- advect + bounce (solid replicated; positions are global) ----
    e = 0.0 if params.mode == "flip" else 0.5
    pos_new, vel_new = advect_bounce(
        pos, vel, dt_new, solid_full, B, e, rounding="round",
        analytic_wall=params.wall if params.walls_only_solid else None)
    pos = jnp.where(alive[:, None], pos_new, SENTINEL)
    vel = jnp.where(alive[:, None], vel_new, 0.0)

    # ---- nearest-neighbour migration ----
    owner = jnp.clip((cround(pos[:, 0]).astype(jnp.int32) + B) // nl, 0,
                     ndev - 1)
    send_left = alive & (owner == me - 1)
    send_right = alive & (owner == me + 1)
    payload = jnp.concatenate([pos, vel], axis=-1)
    if params.fast_transfer:
        # Sorted-band migration.  The step-start sort leaves this shard's
        # rows in ascending cell order with every dead slot at the tail,
        # and the CFL bound (|dx_move| <= dx, advect above) means owner
        # can change by at most one slab row per step — so all
        # left-senders sit in the first F sorted rows and all
        # right-senders in the last F rows of the alive prefix
        # [0, A0).  Ship the raw band slices + sender masks and insert
        # the arrivals straight into the dead tail [A0, cap): total work
        # is O(F), no full-P cumsum/argsort/scatter.
        F = min(mig_cap, cap)
        A0 = jnp.sum(alive.astype(jnp.int32))      # alive prefix length
        band_l = payload[:F]
        mask_l = send_left[:F]
        start_r = jnp.clip(A0 - F, 0, cap - F)
        band_r = jax.lax.dynamic_slice_in_dim(payload, start_r, F, 0)
        mask_r = jax.lax.dynamic_slice_in_dim(send_right, start_r, F, 0)
        incoming, valid = migrate_edge_bands(band_l, mask_l, band_r,
                                             mask_r, AX)
        # senders outside their band (CFL violation or band overflow) are
        # dropped — detected exactly by full-vs-band mask counts
        dropped = (jnp.sum(send_left) - jnp.sum(mask_l)
                   + jnp.sum(send_right) - jnp.sum(mask_r))
        moved = send_left | send_right
        alive = alive & ~moved
        pos = jnp.where(alive[:, None], pos, SENTINEL)
        vel = jnp.where(alive[:, None], vel, 0.0)
        if tail_insert:
            # contiguous tail insert: rows [A0, A0+2F) are dead (the dead
            # tail starts at A0; removal above only adds holes BELOW A0),
            # so one dynamic_update_slice per array lands every arrival
            # (a copy, where the 2F-row scatter form is one indexed write
            # per row).  Invalid rows write the dead pattern.
            # Interleaved alive flags are fine: the next step's sort
            # restores the alive-prefix invariant before anyone relies on
            # it.  On overflow (A0 > cap - 2F) the clamped write clobbers
            # up to A0 - A0c of the highest-cell rows; counted as lost.
            A0c = jnp.clip(A0, 0, cap - 2 * F)
            pos = jax.lax.dynamic_update_slice_in_dim(
                pos, jnp.where(valid[:, None], incoming[:, :3], SENTINEL),
                A0c, 0)
            vel = jax.lax.dynamic_update_slice_in_dim(
                vel, jnp.where(valid[:, None], incoming[:, 3:], 0.0),
                A0c, 0)
            alive = jax.lax.dynamic_update_slice_in_dim(alive, valid, A0c, 0)
            lost = psum(dropped + (A0 - A0c))
        else:
            # capacity too tight for a guaranteed-dead 2F tail window
            # (tiny test configs where mig_cap ~ cap): paired scatter
            rank = jnp.cumsum(valid) - 1           # (2F,) — small
            tgt = jnp.where(valid, A0 + rank, cap)
            overflow = jnp.sum(valid & (tgt >= cap))
            pos = pos.at[tgt].set(incoming[:, :3], mode="drop")
            vel = vel.at[tgt].set(incoming[:, 3:], mode="drop")
            alive = alive.at[tgt].set(True, mode="drop")
            lost = psum(dropped + overflow)
    else:
        # unsorted path (slow-transfer reference mode): fixed-capacity
        # compaction pack + free-slot pairing over the full array
        incoming, valid, dropped = migrate_neighbors(
            payload, send_left, send_right, mig_cap, AX)
        moved = send_left | send_right
        alive = alive & ~moved
        pos = jnp.where(alive[:, None], pos, SENTINEL)
        vel = jnp.where(alive[:, None], vel, 0.0)
        rank_in = jnp.cumsum(valid) - 1
        ci = jnp.where(valid, rank_in, 2 * mig_cap)
        incoming = jnp.zeros_like(incoming).at[ci].set(incoming,
                                                       mode="drop")
        valid = jnp.arange(2 * mig_cap) < jnp.sum(valid)
        dead_rank = jnp.cumsum(~alive) - 1
        slot = jnp.where((~alive) & (dead_rank < 2 * mig_cap), dead_rank,
                         2 * mig_cap)
        free_idx = jnp.full((2 * mig_cap,), cap, jnp.int32).at[slot].set(
            jnp.arange(cap, dtype=jnp.int32), mode="drop")
        tgt = jnp.where(valid & (free_idx < cap), free_idx, cap)
        pos = pos.at[tgt].set(incoming[:, :3], mode="drop")
        vel = vel.at[tgt].set(incoming[:, 3:], mode="drop")
        alive = alive.at[tgt].set(True, mode="drop")
        lost = psum(dropped + jnp.sum(valid & (free_idx >= cap)))

    new_state = ShardedFlipState(pos=pos, vel=vel, alive=alive, dt=dt_new,
                                 t=state.t + dt_new, frame=state.frame + 1,
                                 pressure=pressure)
    metrics = {
        "error": err,
        "dt": dt_new,
        "dt_used": dt,
        "outer_iters": n_outer,
        "cg_iters": cg_iters,
        "max_speed": max_speed,
        "kinetic_energy": 0.5 * psum(jnp.sum((vel * vel).astype(jnp.float32))),
        "num_fluid_cells": psum(jnp.sum(fluid)),
        "num_alive": psum(jnp.sum(alive)),
        "migrated": psum(jnp.sum(moved)),
        "lost": lost,
        "occupancy": occ,
    }
    return new_state, metrics


class LostParticleMonitor:
    """Surfaces the silent-degradation mode of fixed-capacity migration.

    The sorted-band fast path can drop valid migrants (senders outside
    the first/last F sorted rows when a slab boundary cell-row holds
    more than F particles) and the tail-insert clamp can clobber rows on
    shard overflow — both only increment the per-step ``lost`` metric.
    This monitor checks the PREVIOUS step's counter at the top of the
    next ``step()`` (by then the value is computed, so the ``int()``
    fetch never stalls the dispatch pipeline) and emits a runtime
    warning whenever lost > 0; with ``FLUIDSIM_STRICT_MIGRATION=1`` it
    raises instead (debug runs).  ``lost_total`` accumulates the count.
    """

    def _init_lost_monitor(self):
        self._pending_lost = None
        self.lost_total = 0

    def _note_lost(self, metrics):
        prev, self._pending_lost = self._pending_lost, metrics.get("lost")
        if prev is None:
            return
        lost = int(np.asarray(prev))
        if lost > 0:
            self.lost_total += lost
            msg = (f"{type(self).__name__}: migration dropped {lost} "
                   f"particle(s) this step ({self.lost_total} total) — "
                   "slab-boundary band overflow or shard capacity "
                   "exhausted; raise mig_frac / cap_factor (physics is "
                   "silently losing mass)")
            if os.environ.get("FLUIDSIM_STRICT_MIGRATION"):
                raise RuntimeError(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=3)

    def _flush_lost(self):
        """Force the last pending counter check (end of a run)."""
        if self._pending_lost is not None:
            self._note_lost({"lost": None})
            self._pending_lost = None


class ShardedFlipSim(LostParticleMonitor):
    """Host driver for the multi-device FLIP solver.

    Works on any 1-D mesh: GPUs, or virtual CPU devices via
    ``--xla_force_host_platform_device_count`` (how CI exercises this).
    """

    def __init__(self, scene: Scene | str = "water_cube_drop",
                 params: FlipParams | None = None, mesh: Mesh | None = None,
                 seed: int = 0, dtype=jnp.float32, cap_factor: float = 1.6,
                 mig_frac: float | None = None, **scene_kwargs):
        if isinstance(scene, str):
            scene = get_scene(scene, **scene_kwargs)
        if params is None:
            params = FlipParams(bound=scene.spec.bound, wall=scene.spec.wall,
                                dx=scene.spec.dx, gravity=tuple(scene.gravity))
        if mesh is None:
            mesh = Mesh(np.asarray(jax.devices()), (AX,))
        if (not params.walls_only_solid
                and params.wall == scene.spec.wall
                and params.bound == scene.spec.bound
                and np.array_equal(np.asarray(scene.solid),
                                   scene.spec.wall_mask())):
            params = dataclasses.replace(params, walls_only_solid=True)
        self.scene, self.params, self.mesh = scene, params, mesh
        ndev = mesh.devices.size
        n = scene.spec.n
        self.nl = math.ceil(n / ndev)
        npad = self.nl * ndev

        solid_np = np.asarray(scene.solid)
        solid_pad_ext = np.zeros((npad + 2 * W, n, n), bool)
        solid_pad_ext[W:W + n] = solid_np

        pos, vel = seed_particles(scene, seed=seed,
                                  dtype=np.dtype(dtype).name)
        owner = np.clip((np.floor(np.abs(pos[:, 0]) + 0.5)
                         * np.sign(pos[:, 0]) + scene.spec.bound).astype(int)
                        // self.nl, 0, ndev - 1)
        counts = np.bincount(owner, minlength=ndev)
        self.cap = int(math.ceil(counts.max() * cap_factor / 8) * 8)
        # Migration capacity: the CFL cap (dt <= dx/max_speed,
        # models/flip.py) bounds every particle's move to <= 1 cell/frame,
        # so only particles in a slab's two edge rows can change owner.
        # Default = 4x the uniform-density edge-band population (plus the
        # ``lost`` counter as the overflow detector); 5% of cap is ~10x
        # oversized and makes the fixed-capacity pack/insert machinery
        # the most expensive phase of the sharded step.
        if mig_frac is None:
            self.mig_cap = max(64, min(self.cap,
                                       8 * (self.cap // max(self.nl, 1))))
        else:
            self.mig_cap = max(64, int(self.cap * mig_frac))
        # Insert strategy (static): arrivals go into the contiguous dead
        # tail [A0, A0+2F) via dynamic_update_slice when the capacity
        # slack can always hold the 2F-row block — otherwise (tiny caps)
        # the paired-scatter fallback.
        self.tail_insert = (2 * min(self.mig_cap, self.cap)
                            <= self.cap - int(counts.max() * 1.15))

        pos_all = np.full((ndev, self.cap, 3), SENTINEL, dtype)
        vel_all = np.zeros((ndev, self.cap, 3), dtype)
        alive_all = np.zeros((ndev, self.cap), bool)
        for d in range(ndev):
            sel = owner == d
            k = int(sel.sum())
            pos_all[d, :k] = pos[sel]
            vel_all[d, :k] = vel[sel]
            alive_all[d, :k] = True

        shard = NamedSharding(mesh, P(AX))
        rep = NamedSharding(mesh, P())
        self.solid_full = jax.device_put(jnp.asarray(solid_np), rep)
        self.solid_pad_ext = jax.device_put(jnp.asarray(solid_pad_ext), rep)
        self.state = ShardedFlipState(
            pos=jax.device_put(jnp.asarray(pos_all.reshape(-1, 3)), shard),
            vel=jax.device_put(jnp.asarray(vel_all.reshape(-1, 3)), shard),
            alive=jax.device_put(jnp.asarray(alive_all.reshape(-1)), shard),
            dt=jax.device_put(jnp.asarray(params.max_dt, dtype), rep),
            t=jax.device_put(jnp.zeros((), dtype), rep),
            frame=jax.device_put(jnp.zeros((), jnp.int32), rep),
            pressure=jax.device_put(
                jnp.zeros((npad, n, n), dtype), shard))

        state_specs = ShardedFlipState(
            pos=P(AX), vel=P(AX), alive=P(AX), dt=P(), t=P(), frame=P(),
            pressure=P(AX))
        metric_specs = {k: P() for k in
                        ("error", "dt", "dt_used", "outer_iters", "cg_iters",
                         "max_speed", "kinetic_energy", "num_fluid_cells",
                         "num_alive", "migrated", "lost")}
        metric_specs["occupancy"] = P(AX)
        body = partial(_sharded_step, params, self.nl, self.cap, self.mig_cap,
                       tail_insert=self.tail_insert)
        self._step = jax.jit(shard_map(
            body, mesh=mesh,
            in_specs=(P(), P(), state_specs),
            out_specs=(state_specs, metric_specs)))
        self._init_lost_monitor()

    @property
    def num_particles(self) -> int:
        return int(np.asarray(jnp.sum(self.state.alive)))

    def step(self):
        self.state, metrics = self._step(self.solid_full, self.solid_pad_ext,
                                         self.state)
        self._note_lost(metrics)
        return metrics

    def run(self, frames: int, callback=None):
        out = None
        for _ in range(frames):
            out = self.step()
            if callback is not None:
                callback(int(self.state.frame) - 1, self.state, out)
        self._flush_lost()
        return out
