"""Multi-device MPM: slab domain decomposition over a 1-D device mesh.

Same decomposition as ``parallel.flip_sharded`` (grid x-axis sharded,
particles owned by their slab, solid replicated), extended to the MPM
pipeline.  The implicit velocity solve stays matrix-free: each CG matvec
exchanges a 2-cell halo of the trial grid velocity (a particle's force
stencil couples cells up to two apart through its 27-node gather + 27-node
scatter), runs the per-shard ``jax.jvp`` Hessian-vector product, and
halo-reduces the scattered force differentials; dot products ``psum``.

Particle migration ships the full MPM payload (position, velocity, F_E,
F_P, volume = 26 channels).  MPM moves at most ~dx per step (CFL-capped dt),
so nearest-neighbour exchange suffices, as in the FLIP path.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from fluidsim_tpu.core.splines import cround, grad_w_mpm
from fluidsim_tpu.core.gridspec import cell_center_velocity
from fluidsim_tpu.ops import transfer
from fluidsim_tpu.ops.pcg import pcg
from fluidsim_tpu.ops.svd3 import (piola_corotated, piola_linearized,
                                   hardening, clamp_singular, det3, mm3)
from fluidsim_tpu.models.flip import advect_bounce
from fluidsim_tpu.models.mpm import MpmParams
from fluidsim_tpu.parallel.halo import (exchange_halo, halo_reduce,
                                        migrate_neighbors)
from fluidsim_tpu.parallel.flip_sharded import (AX, W, SENTINEL,
                                                LostParticleMonitor,
                                                _local_scatter, _local_gather)
from fluidsim_tpu.scenes import Scene, get_scene
from fluidsim_tpu.seeding import seed_particles


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ShardedMpmState:
    pos: jax.Array       # (ndev*cap, 3)
    vel: jax.Array
    FE: jax.Array        # (ndev*cap, 3, 3)
    FP: jax.Array
    volume: jax.Array    # (ndev*cap,)
    alive: jax.Array     # (ndev*cap,) bool
    dt: jax.Array
    t: jax.Array
    frame: jax.Array


def _sharded_mpm_step(params: MpmParams, nl: int, cap: int, mig_cap: int,
                      solid_full, solid_pad_ext, state: ShardedMpmState):
    """SPMD body (per device under shard_map)."""
    B, n = params.bound, 2 * params.bound + 1
    rows = nl + 2 * W
    me = jax.lax.axis_index(AX)
    ndev = jax.lax.axis_size(AX)
    x0 = me * nl
    pos, vel, alive, dt = state.pos, state.vel, state.alive, state.dt
    g = jnp.asarray(params.gravity, pos.dtype)

    def psum(x):
        return jax.lax.psum(x, AX)

    solid_ext = jax.lax.dynamic_slice(solid_pad_ext, (x0, 0, 0),
                                      (rows, n, n))
    solid_loc = solid_ext[W:-W]
    thr = params.mass_threshold
    fe_in, fp_in, volume_in = state.FE, state.FP, state.volume

    # ---- stencil data (MPM kernel + gradients, deformHeader.h:90-105) --
    cells, inb = transfer.particle_stencil(pos, B)
    delta = pos[:, None, :] - cells.astype(pos.dtype)
    w27, gradw = grad_w_mpm(delta)
    sflat = solid_full.reshape(-1)
    gidx = jnp.clip(cells + B, 0, n - 1)
    cell_solid = sflat[(gidx[..., 0] * n + gidx[..., 1]) * n
                       + gidx[..., 2]]
    not_solid = ~cell_solid & inb
    within_in = jnp.all(jnp.abs(cells) < B - 1, axis=-1)

    # local ext flat ids for gathers/scatters
    lx = jnp.clip(cells[..., 0] + B - x0 + W, 0, rows - 1)
    gy = jnp.clip(cells[..., 1] + B, 0, n - 1)
    gz = jnp.clip(cells[..., 2] + B, 0, n - 1)
    ids_ext = (lx * n + gy) * n + gz

    # ---- mass P2G (interpolate) + velocity P2G normalised by mass ----
    mass_mask = not_solid & (w27 > 0)
    mass = halo_reduce(_local_scatter(cells + B,
                                      jnp.where(mass_mask, w27, 0.0),
                                      mass_mask, x0, nl, n, W), W, AX)
    p2g_mask = not_solid & within_in
    wm = jnp.where(p2g_mask, w27, 0.0)
    mom = jnp.stack([
        halo_reduce(_local_scatter(cells + B, wm * vel[:, None, d],
                                   p2g_mask, x0, nl, n, W), W, AX)
        for d in range(3)], axis=-1)
    velg = jnp.where((mass > thr)[..., None],
                     mom / jnp.where(mass > thr, mass, 1.0)[..., None],
                     0.0)

    # ---- per-particle volume at frame 0 (findVolume) ----
    mass_ext = exchange_halo(mass, W, AX)
    mass_at = _local_gather(mass_ext[..., None], cells + B,
                            x0, nl, n, W)[..., 0]
    dens = jnp.sum(jnp.where(not_solid, w27 * mass_at, 0.0), axis=1)

    vol0 = 1.0 / jnp.where(dens > 0, dens, 1.0)
    volume = jnp.where(state.frame == 0,
                       jnp.where(alive, vol0, 0.0), volume_in)

    active = (mass > thr) & (~solid_loc)
    active_ext = exchange_halo(active, W, AX)
    velb = velg

    # ---- force function over halo-extended displacement fields ----
    mu, lam = hardening(params.mu0, params.lam0, params.hardening_eps,
                        det3(fp_in), exponent_cap=params.hardening_max)
    fe_t = jnp.swapaxes(fe_in, -1, -2)
    vol_alive = jnp.where(alive, volume, 0.0)

    hess = (params.hessian if params.hessian != "auto"
            else ("full" if params.bound <= 15 else "hybrid"))
    hybrid = hess == "hybrid"
    dforce_spd = None
    gather_mask = (active_ext.reshape(-1)[ids_ext]
                   & inb)[..., None].astype(pos.dtype)
    scatter_mask = not_solid[..., None].astype(pos.dtype)

    def forces_ext(u_ext_flat):
        """u: (rows*n*n, 3) halo-extended displacement; returns scattered
        force differentials on the extended slab (pre halo-reduce)."""
        u_nodes = u_ext_flat[ids_ext] * gather_mask
        gmat = jnp.einsum("pkd,pke->pde", u_nodes, gradw,
                          precision=jax.lax.Precision.HIGHEST)
        fe_new = fe_in + mm3(gmat, fe_in)
        p_stress = piola_corotated(fe_new, mu, lam)
        sigma = mm3(p_stress, fe_t)
        f_pk = -vol_alive[:, None, None] * jnp.einsum(
            "pde,pke->pkd", sigma, gradw,
            precision=jax.lax.Precision.HIGHEST)
        f_pk = f_pk * scatter_mask
        return jnp.zeros((rows * n * n, 3), pos.dtype).at[
            ids_ext.reshape(-1)].add(f_pk.reshape(-1, 3))

    zeros_u = jnp.zeros((rows * n * n, 3), pos.dtype)
    f0 = jnp.stack([halo_reduce(
        forces_ext(zeros_u).reshape(rows, n, n, 3)[..., d], W, AX)
        for d in range(3)], axis=-1)

    if hybrid:
        # linear SPD Gauss-Newton chain (same gather/scatter scaffold
        # as forces_ext, dP from piola_linearized "spd"; no p0 term —
        # the differential is all the matvec uses)
        _, dp_spd = piola_linearized(fe_in, mu, lam, "spd")

        def dforce_spd(wv_loc):
            u_ext_flat = exchange_halo(wv_loc, W, AX).reshape(
                rows * n * n, 3)
            u_nodes = u_ext_flat[ids_ext] * gather_mask
            gmat = jnp.einsum("pkd,pke->pde", u_nodes, gradw,
                              precision=jax.lax.Precision.HIGHEST)
            dsig = mm3(dp_spd(mm3(gmat, fe_in)), fe_t)
            f_pk = -vol_alive[:, None, None] * jnp.einsum(
                "pde,pke->pkd", dsig, gradw,
                precision=jax.lax.Precision.HIGHEST) * scatter_mask
            df_ext = jnp.zeros((rows * n * n, 3), pos.dtype).at[
                ids_ext.reshape(-1)].add(f_pk.reshape(-1, 3))
            return jnp.stack([halo_reduce(
                df_ext.reshape(rows, n, n, 3)[..., d], W, AX)
                for d in range(3)], axis=-1)

    mass_safe = jnp.where(active, mass, 1.0)[..., None]
    b = jnp.where(active[..., None], velg + dt * (f0 / mass_safe + g), 0.0)

    beta_dt2 = params.beta * dt * dt

    def matvec(wv):
        wm_ = jnp.where(active[..., None], wv, 0.0)
        w_ext = exchange_halo(wm_, W, AX).reshape(rows * n * n, 3)
        _, df_ext = jax.jvp(forces_ext, (zeros_u,), (w_ext,))
        df = jnp.stack([halo_reduce(
            df_ext.reshape(rows, n, n, 3)[..., d], W, AX)
            for d in range(3)], axis=-1)
        out = wv + beta_dt2 * (-df) / mass_safe
        return jnp.where(active[..., None], out, wv)

    def matvec_spd(wv):
        wm_ = jnp.where(active[..., None], wv, 0.0)
        df = dforce_spd(wm_)
        out = wv + beta_dt2 * (-df) / mass_safe
        return jnp.where(active[..., None], out, wv)

    # x0 = b warm start, matching the single-chip mpm_step (b is within
    # O(beta*dt^2) of the solution; saves 1-3 Hessian-vector products)
    if hybrid:
        # exact operator first with a bounded budget, SPD Gauss-Newton
        # re-solve on non-convergence — mirrors mpm_step (the cond
        # predicate is a psum-reduced global, identical on every shard)
        res_f = pcg(matvec, b, x0=b, rtol=params.cg_rtol,
                    maxiter=params.cg_hybrid_cap, reduce_fn=psum)
        bnorm2 = psum(jnp.sum((b * b).astype(jnp.float32)))
        ok = (res_f.residual.astype(jnp.float32) ** 2
              <= jnp.float32(params.cg_rtol) ** 2 * bnorm2)

        def _keep(_):
            return res_f.x, res_f.iters, res_f.residual

        def _respd(_):
            r = pcg(matvec_spd, b, x0=b, rtol=params.cg_rtol,
                    maxiter=params.cg_maxiter, reduce_fn=psum)
            return r.x, res_f.iters + r.iters, r.residual

        solve_x, cg_iters, cg_resid = jax.lax.cond(ok, _keep, _respd, None)
        spd_used = (~ok).astype(jnp.int32)
    else:
        res = pcg(matvec, b, x0=b, rtol=params.cg_rtol,
                  maxiter=params.cg_maxiter, reduce_fn=psum)
        solve_x, cg_iters, cg_resid = res.x, res.iters, res.residual
        spd_used = jnp.asarray(1 if hess == "spd" else 0, jnp.int32)
    velg = jnp.where(active[..., None], solve_x, 0.0)

    # ---- deformation gradient update ----
    velg_ext = exchange_halo(velg, W, AX)
    v_nodes = _local_gather(velg_ext, cells + B, x0, nl, n, W) \
        * not_solid[..., None].astype(pos.dtype)
    gradv = jnp.einsum("pkd,pke->pde", v_nodes, gradw,
                       precision=jax.lax.Precision.HIGHEST)
    gmax = jnp.max(jnp.abs(gradv), axis=(-2, -1))
    scale_g = jnp.minimum(1.0, params.max_gradv_dt
                          / jnp.maximum(dt * gmax, 1e-12))
    gradv = gradv * scale_g[:, None, None]
    eye = jnp.eye(3, dtype=pos.dtype)
    t_fe = mm3(eye + dt * gradv, fe_in)
    f_total = mm3(t_fe, fp_in)
    fe_new, v_sinv_ut = clamp_singular(t_fe, 1.0 - params.theta_c,
                                       1.0 + params.theta_s)
    fp_new = mm3(v_sinv_ut, f_total)
    fe_new = jnp.where(alive[:, None, None], fe_new, eye)
    fp_new = jnp.where(alive[:, None, None], fp_new, eye)

    # ---- FLIP advect ----
    vc_new = cell_center_velocity(exchange_halo(velg, W, AX))
    vc_old = cell_center_velocity(exchange_halo(velb, W, AX))
    within_wall = jnp.all(jnp.abs(cells) <= params.wall, axis=-1)
    wg = jnp.where(within_wall & inb, w27, 0.0)
    dv = _local_gather(vc_new - vc_old, cells + B, x0, nl, n, W)
    den = jnp.sum(wg, axis=1)
    safe = jnp.where(den != 0, den, 1.0)
    delta_v = jnp.where(den[:, None] != 0,
                        jnp.sum(wg[..., None] * dv, axis=1)
                        / safe[:, None], 0.0)
    vel = jnp.where(alive[:, None], vel + delta_v, 0.0)

    speed = jnp.sqrt(jnp.sum(vel * vel, axis=-1))
    max_speed = jax.lax.pmax(jnp.max(jnp.where(alive, speed, 0.0)), AX)
    dt_new = jnp.where(max_speed != 0,
                       jnp.minimum(params.max_dt, params.dx / max_speed),
                       params.max_dt)
    pos_new, vel_new = advect_bounce(
        pos, vel, dt_new, solid_full, B, 0.0, rounding="out",
        analytic_wall=params.wall if params.walls_only_solid else None)
    pos = jnp.where(alive[:, None], pos_new, SENTINEL)
    vel = jnp.where(alive[:, None], vel_new, 0.0)

    # ---- migration with full MPM payload ----
    owner = jnp.clip((cround(pos[:, 0]).astype(jnp.int32) + B) // nl, 0,
                     ndev - 1)
    send_left = alive & (owner == me - 1)
    send_right = alive & (owner == me + 1)
    payload = jnp.concatenate([pos, vel, fe_new.reshape(-1, 9),
                               fp_new.reshape(-1, 9), volume[:, None]], axis=-1)
    incoming, valid, dropped = migrate_neighbors(payload, send_left,
                                                 send_right, mig_cap, AX)
    moved = send_left | send_right
    alive = alive & ~moved
    pos = jnp.where(alive[:, None], pos, SENTINEL)
    vel = jnp.where(alive[:, None], vel, 0.0)

    # cumsum-rank compaction + free-slot pairing over the full array
    rank_in = jnp.cumsum(valid) - 1
    ci = jnp.where(valid, rank_in, 2 * mig_cap)
    incoming = jnp.zeros_like(incoming).at[ci].set(incoming, mode="drop")
    valid = jnp.arange(2 * mig_cap) < jnp.sum(valid)
    dead_rank = jnp.cumsum(~alive) - 1
    slot = jnp.where((~alive) & (dead_rank < 2 * mig_cap), dead_rank,
                     2 * mig_cap)
    free_idx = jnp.full((2 * mig_cap,), cap, jnp.int32).at[slot].set(
        jnp.arange(cap, dtype=jnp.int32), mode="drop")
    tgt = jnp.where(valid & (free_idx < cap), free_idx, cap)
    lost = psum(dropped + jnp.sum(valid & (free_idx >= cap)))
    pos = pos.at[tgt].set(incoming[:, 0:3], mode="drop")
    vel = vel.at[tgt].set(incoming[:, 3:6], mode="drop")
    fe_new = fe_new.at[tgt].set(incoming[:, 6:15].reshape(-1, 3, 3),
                                mode="drop")
    fp_new = fp_new.at[tgt].set(incoming[:, 15:24].reshape(-1, 3, 3),
                                mode="drop")
    volume = volume.at[tgt].set(incoming[:, 24], mode="drop")
    alive = alive.at[tgt].set(True, mode="drop")

    new_state = ShardedMpmState(pos=pos, vel=vel, FE=fe_new, FP=fp_new,
                                volume=volume, alive=alive, dt=dt_new,
                                t=state.t + dt_new, frame=state.frame + 1)
    metrics = {
        "cg_iters": cg_iters,
        "spd_fallback": spd_used,
        "dt": dt_new,
        "dt_used": dt,
        "max_speed": max_speed,
        "kinetic_energy": 0.5 * psum(jnp.sum((vel * vel).astype(jnp.float32))),
        "num_active_cells": psum(jnp.sum(active)),
        "num_alive": psum(jnp.sum(alive)),
        "migrated": psum(jnp.sum(moved)),
        "lost": lost,
        "occupancy": mass,
    }
    return new_state, metrics


class ShardedMpmSim(LostParticleMonitor):
    """Host driver mirroring ``ShardedFlipSim`` for the MPM solver."""

    def __init__(self, scene: Scene | str = "mpm_cone",
                 params: MpmParams | None = None, mesh: Mesh | None = None,
                 seed: int = 0, dtype=jnp.float32, cap_factor: float = 1.35,
                 mig_frac: float = 0.06, **scene_kwargs):
        # cap_factor/mig_frac default tighter than FLIP's (1.6/0.1): the
        # MPM dt is CFL-capped at <= 1 cell/step and the cone's x-profile
        # is static (no splash), while every row-proportional stage (SVD3
        # in piola_linearized, per-CG mm3 chains, advect) pays for the
        # padding.  The LostParticleMonitor warns on any overflow.
        if isinstance(scene, str):
            scene = get_scene(scene, **scene_kwargs)
        if params is None:
            params = MpmParams(bound=scene.spec.bound, wall=scene.spec.wall,
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

        pos, vel = seed_particles(scene, seed=seed, dtype=np.dtype(dtype).name)
        xcell = np.clip((np.floor(np.abs(pos[:, 0]) + 0.5)
                         * np.sign(pos[:, 0])
                         + scene.spec.bound).astype(int), 0, npad - 1)
        owner = np.clip(xcell // self.nl, 0, ndev - 1)
        counts = np.bincount(owner, minlength=ndev)
        cap0 = int(math.ceil(max(counts.max(), 8) * cap_factor / 8) * 8)
        # Migration ships at most mig_cap senders per side, and under the
        # CFL bound every sender starts the step in its shard's EDGE
        # x-row; a blind cap fraction under-sizes that for dense rows (the
        # cone's widest row sits exactly on the center slab boundary at
        # even ndev).  Size mig_cap from the seed-time histogram of the
        # actual boundary rows with 1.5x drift headroom — zero boundaries
        # at ndev=1 — then grow cap so 2*mig_cap arrivals always find
        # free slots.  The LostParticleMonitor still warns if a run
        # outgrows the band.
        row_pop = np.bincount(xcell, minlength=npad)
        edge_rows = [r for d in range(1, ndev)
                     for r in (d * self.nl - 1, d * self.nl) if r < npad]
        edge_pop = int(row_pop[edge_rows].max()) if edge_rows else 0
        self.mig_cap = max(64, int(cap0 * mig_frac),
                           min(int(1.5 * edge_pop), cap0))
        need = int(counts.max() * 1.15) + 2 * self.mig_cap
        self.cap = max(cap0, int(math.ceil(need / 8) * 8))

        def alloc(shape, fill=0.0):
            return np.full((ndev, self.cap) + shape, fill, dtype)

        pos_all = alloc((3,), SENTINEL)
        vel_all = alloc((3,))
        fe_all = np.broadcast_to(np.eye(3, dtype=dtype),
                                 (ndev, self.cap, 3, 3)).copy()
        fp_all = fe_all.copy()
        vol_all = alloc(())
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
        self.state = ShardedMpmState(
            pos=jax.device_put(jnp.asarray(pos_all.reshape(-1, 3)), shard),
            vel=jax.device_put(jnp.asarray(vel_all.reshape(-1, 3)), shard),
            FE=jax.device_put(jnp.asarray(fe_all.reshape(-1, 3, 3)), shard),
            FP=jax.device_put(jnp.asarray(fp_all.reshape(-1, 3, 3)), shard),
            volume=jax.device_put(jnp.asarray(vol_all.reshape(-1)), shard),
            alive=jax.device_put(jnp.asarray(alive_all.reshape(-1)), shard),
            dt=jax.device_put(jnp.asarray(params.max_dt, dtype), rep),
            t=jax.device_put(jnp.zeros((), dtype), rep),
            frame=jax.device_put(jnp.zeros((), jnp.int32), rep))

        specs = ShardedMpmState(pos=P(AX), vel=P(AX), FE=P(AX), FP=P(AX),
                                volume=P(AX), alive=P(AX), dt=P(), t=P(),
                                frame=P())
        mspecs = {k: P() for k in ("cg_iters", "spd_fallback", "dt",
                                   "dt_used", "max_speed",
                                   "kinetic_energy", "num_active_cells",
                                   "num_alive", "migrated", "lost")}
        mspecs["occupancy"] = P(AX)
        body = partial(_sharded_mpm_step, params, self.nl, self.cap,
                       self.mig_cap)
        # check_vma=False: the varying-axes checker mis-flags the jax.jvp
        # inside the CG matvec (jvp-of-closure over device-varying FE).
        self._step = jax.jit(shard_map(body, mesh=mesh,
                                       in_specs=(P(), P(), specs),
                                       out_specs=(specs, mspecs),
                                       check_vma=False))
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
