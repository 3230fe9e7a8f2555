"""Semi-implicit snow-style Material Point Method — ``mpm.cc`` in JAX.

One fully-jitted ``step`` reproduces the reference frame
(``mpm.cc:1301-1434``):

  mass P2G -> velocity P2G (mass-normalised) -> [volume at frame 0] ->
  explicit grid forces -> implicit velocity solve -> deformation-gradient
  update with SVD-clamped plasticity -> FLIP advect

The headline simplification: the reference assembles the force
Hessian particle-by-particle into a ``std::map`` of 3x3 blocks through ~170
lines of hand-derived tensor calculus (``deformHeader.h:107-272``,
``mpm.cc:647-701``, serial, O(27^2) node pairs per particle).  Here the
implicit system ``A v = v + beta dt^2 (1/m) d2Psi/dx2 v`` is applied
matrix-free: ``jax.jvp`` of the grid-force function (with a custom-JVP polar
rotation, ``ops.svd3``) yields the exact same Hessian-vector product, fully
batched, inside a jitted CG.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fluidsim_tpu.core.gridspec import cell_center_velocity, flat_index
from fluidsim_tpu.core.splines import grad_w_mpm
from fluidsim_tpu.ops import transfer
from fluidsim_tpu.ops.pcg import pcg
from fluidsim_tpu.ops.svd3 import (piola_corotated, piola_linearized,
                                   hardening, clamp_singular, det3, mm3)
from fluidsim_tpu.models.flip import advect_bounce
from fluidsim_tpu.ops.smallmat import apply_mat27, outer_sum27
from fluidsim_tpu.scenes import Scene, get_scene
from fluidsim_tpu.seeding import seed_particles


@dataclasses.dataclass(frozen=True)
class MpmParams:
    """Reference constants: ``mpm.cc:1298,1395-1399,1412`` and walls at
    ``|c| > 13`` (``mpm.cc:1193``)."""

    bound: int = 15
    wall: int = 13
    dx: float = 1.0
    E: float = 48000.0
    nu: float = 0.47
    beta: float = 0.5               # semi-implicitness (mpm.cc:1397)
    hardening_eps: float = 10.0     # epsilon (mpm.cc:1399)
    theta_c: float = 0.025          # compression clamp (mpm.cc:1412)
    theta_s: float = 0.0075         # stretch clamp (mpm.cc:1412)
    max_dt: float = 0.001           # dt cap (mpm.cc:1298,1418)
    gravity: Tuple[float, float, float] = (0.0, -10.0, 0.0)
    mass_threshold: float = 0.1     # active-cell cut (mpm.cc:392,1359)
    # Stabilisers beyond the reference (which prints "FP determinant
    # negative!!!" when its own plasticity inverts, mpm.cc:567-569, and goes
    # NaN by frame ~490 of the 500-frame cone run in f32): cap the hardening
    # exponent and the per-step deformation increment.  Both are inert on
    # healthy trajectories (hardening exponent stays in [-2, 2], dt*|gradv|
    # well below the cap).
    hardening_max: float = 10.0     # cap on eps*(1 - Jp) in exp()
    max_gradv_dt: float = 0.5       # cap on dt * max|gradv| per particle
    cg_rtol: float = 1e-6    # do NOT loosen: rtol 1e-4 saves CG
    # iterations at 127^3 (3 -> 2) and tracks the 1e-6 KE trajectory
    # within 1% pre-impact — but the under-converged implicit
    # elasticity INJECTS ENERGY after impact: by frame ~195 the 1e-4 run
    # sits at |v|max ~6400, KE 1.27e10 and flat, where the 1e-6 run
    # peaked at 9.2e9 (frame 175) and decays.  Tight tolerance is a
    # correctness requirement here, unlike FLIP's pressure solve where
    # the outer do-while bounds the error and rtol auto-scales
    # (models/flip.py:auto_pcg_rtol).
    cg_maxiter: int = 1000
    # Preconditioner for A = I + beta dt^2 H/m (the reference uses
    # IncompleteCholesky on its assembled sparse A, mpm.cc:1283).  "jacobi"
    # uses a mass-lumped stiffness-density diagonal proxy
    #   d_i = 1 + beta dt^2 gamma (2 mu0 + lam0) / m_i * sum_p w_pi V_p h_p
    # (one extra scalar P2G per frame; h = hardening factor, the only
    # spatially-varying stiffness term).  PCG terminates on the TRUE
    # residual (ops/pcg.py), so the solution quality bar is unchanged —
    # only the iteration path differs.  The win appears exactly where the
    # soak is slow: post-impact frames where hardened/compressed regions
    # make A strongly non-uniform.
    precond: str = "none"           # "none" | "jacobi" — measured NEUTRAL
    # on the 127^3 cone (CG iterations 6614 -> 6483 over 500 frames):
    # diag(A) ~= 1 + 3.6e-4*h deviates from
    # identity only via hardening, by which point the off-diagonal
    # structure dominates.  Kept as an option for stiffer material setups.
    precond_gamma: float = 1.0      # diag proxy scale
    # Implicit operator: "full" = the reference's exact corotated Hessian
    # (deformHeader.h:241-272, indefinite under compression — the measured
    # cause of the impact-frame CG blowup into the 1000-iteration cap at
    # 127^3, frame 114 of the cone); "spd" = its
    # positive-semidefinite Gauss-Newton part (ops/svd3.py:
    # piola_linearized), unconditionally CG-convergent; "hybrid" = the
    # exact operator with a cg_hybrid_cap iteration budget, falling back
    # to one SPD re-solve on the (rare) frames where the indefinite
    # system stagnates (lax.cond, so converged frames pay nothing extra).
    # "auto" (default): MpmSim keeps "full" at the reference class
    # (bound <= 15, exact parity with mpm.cc) and uses "hybrid" for
    # scaled-up scenes — the always-SPD substitution measured a MATERIAL
    # trajectory deviation at 127^3 (occupancy IoU ~0.4 post-impact,
    # pos RMS ~10 cells at frame 500; docs/mpm_deviation.json), so
    # production stays on the reference operator whenever it converges.
    hessian: str = "auto"           # "auto" | "full" | "spd" | "hybrid"
    cg_hybrid_cap: int = 150        # hybrid: full-operator CG budget per
    # frame before the SPD fallback re-solve (settle frames converge in
    # <10; the cap only binds in the impact phase)
    kernel: str = "mpm"
    fast_transfer: bool = False  # sorted channel-fused transfers
    # (ops.mpm_fast) instead of the naive 27-point scatter/gather.  The
    # naive path, with particles left unsorted, measured fastest on the
    # H100 at the reference's 31^3 and at 127^3 (PERF.md).
    walls_only_solid: bool = False  # scene solid == box walls exactly;
    # enables the analytic bounce probe (auto-detected by MpmSim)

    @property
    def mu0(self) -> float:
        return self.E / (2.0 * (1.0 + self.nu))

    @property
    def lam0(self) -> float:
        return self.E * self.nu / ((1.0 + self.nu) * (1.0 - 2.0 * self.nu))


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class MpmState:
    pos: jax.Array        # (P, 3)
    vel: jax.Array        # (P, 3)
    FE: jax.Array         # (P, 3, 3) elastic deformation gradient
    FP: jax.Array         # (P, 3, 3) plastic deformation gradient
    volume: jax.Array     # (P,) per-particle volume (mpm.cc:739-772)
    dt: jax.Array         # ()
    t: jax.Array          # ()
    frame: jax.Array      # () int32


def _particle_nodes(pos, solid, bound: int):
    """Shared stencil data: node ids, validity masks, MPM weights+gradients."""
    n = 2 * bound + 1
    cells, inb = transfer.particle_stencil(pos, bound)
    delta = pos[:, None, :] - cells.astype(pos.dtype)
    w, gradw = grad_w_mpm(delta)           # deformHeader.h:90-105 convention
    idx = jnp.clip(cells + bound, 0, n - 1)
    ids = flat_index(idx, n)
    not_solid = ~solid.reshape(-1)[ids] & inb
    return ids, inb, not_solid, w, gradw


def make_force_fn(ids, gather_mask, scatter_mask, gradw, FE, volume, mu, lam,
                  n3, hessian="full"):
    """Grid elastic force as a function of a grid displacement increment ``u``.

    ``forces(0)`` is the reference's explicit force scatter
    (``populateGridForces``, ``mpm.cc:596-644``): ``f_i -= V sigma gradW_i``
    with ``sigma = P(FE) FE^T`` (== ``getSigma``).  ``jax.jvp`` at 0 is the
    reference's Hessian-vector product: moving node j by ``u_j`` perturbs
    ``FE`` by ``(u_j gradW_j^T) FE`` (``getDelFE``), and the custom-JVP polar
    rotation supplies ``dR`` (``getDelR``) — so the chain rule reproduces
    ``dPsydFdF``/``getdPsydx2`` (``deformHeader.h:241-272``) exactly.

    ``hessian="hybrid"`` returns ``(forces_full, forces_spd)``.
    """
    fe_t = jnp.swapaxes(FE, -1, -2)
    gm = gather_mask[..., None].astype(FE.dtype)
    sm = scatter_mask[..., None].astype(FE.dtype)
    hybrid = hessian == "hybrid"
    # one SVD per frame: P is evaluated as P0 + dP(dFE) (exact for the
    # force at u=0 and for the jvp, which is all the solve uses)
    p0, dp = piola_linearized(FE, mu, lam, "full" if hybrid else hessian)

    def _forces_with(dp_):
        def forces(u_flat):
            u_nodes = u_flat[ids] * gm                  # (P, 27, 3)
            g = outer_sum27(u_nodes, gradw)             # velocity-gradient-like
            p_stress = p0 + dp_(mm3(g, FE))
            sigma = mm3(p_stress, fe_t)
            f_pk = -volume[:, None, None] * apply_mat27(sigma, gradw)
            return jnp.zeros((n3, 3), FE.dtype).at[ids.reshape(-1)].add(
                (f_pk * sm).reshape(-1, 3))
        return forces

    if hybrid:
        _, dp_spd = piola_linearized(FE, mu, lam, "spd")
        return _forces_with(dp), _forces_with(dp_spd)
    return _forces_with(dp)


def mpm_step(params: MpmParams, solid, state: MpmState):
    """One frame (``mpm.cc:1301-1434``). Fully jittable."""
    B, n = params.bound, 2 * params.bound + 1
    n3 = n * n * n
    pos, vel, dt = state.pos, state.vel, state.dt
    g = jnp.asarray(params.gravity, pos.dtype)
    thr = params.mass_threshold
    fe_in, fp_in = state.FE, state.FP
    hess = (params.hessian if params.hessian != "auto"
            else ("full" if params.bound <= 15 else "hybrid"))
    hybrid = hess == "hybrid"
    fast = params.fast_transfer

    if fast:
        from fluidsim_tpu.ops import mpm_fast as mf
        pos, vel, fe_in, fp_in, volume_in, flat_s = mf.sort_mpm(
            pos, vel, state.FE, state.FP, state.volume, B)
        mass, mom = mf.p2g_mpm(pos, vel, flat_s, solid, B)
        velg = jnp.where((mass > thr)[..., None],
                         mom / jnp.where(mass > thr, mass, 1.0)[..., None], 0.0)
        w, gradw = mf.stencil_mpm(pos)
        valid = jnp.all(jnp.abs(jnp.round(pos)) <= B, axis=-1)
        rows_m = mf.gather_table(mass[..., None], ~solid, flat_s)
        dens = jnp.sum(jnp.where(valid[:, None], w, 0.0)
                       * rows_m[..., 0] * rows_m[..., 1], axis=1)
    else:
        volume_in = state.volume
        # -- mass P2G (PointList::interpolate, mpm.cc:1343) --
        mass = transfer.p2g_mass(pos, solid, B, params.kernel)

        # -- velocity P2G normalised by the MASS grid with threshold
        #    (P2Gtransfer, mpm.cc:1344,996-1015) --
        _, mom = transfer.p2g_velocity(pos, vel, solid, B, params.kernel)
        velg = jnp.where((mass > thr)[..., None],
                         mom / jnp.where(mass > thr, mass, 1.0)[..., None], 0.0)

        # -- per-particle volume, frame 0 only (findVolume, mpm.cc:1345-1348) --
        ids, inb, not_solid, w, gradw = _particle_nodes(pos, solid, B)
        dens = jnp.sum(jnp.where(not_solid, w * mass.reshape(-1)[ids], 0.0),
                       axis=1)

    vol0 = 1.0 / jnp.where(dens > 0, dens, 1.0)
    volume = jnp.where(state.frame == 0, vol0, volume_in)

    active = (mass > thr) & (~solid)
    velb = velg                                    # velBeforeUpdate (mpm.cc:1394)

    # -- explicit forces + implicit solve (mpm.cc:1399-1405) --
    mu, lam = hardening(params.mu0, params.lam0, params.hardening_eps,
                        det3(fp_in), exponent_cap=params.hardening_max)
    zeros_u = jnp.zeros((n3, 3), pos.dtype)
    apply_spd = None
    if fast:
        from fluidsim_tpu.ops import mpm_fast as mf
        fd = mf.make_force_fn_fused(
            pos, flat_s, gradw, valid[:, None].astype(pos.dtype),
            fe_in, volume, mu, lam, active, solid, B,
            hessian=hess)
        fd_pair = fd if hybrid else (fd, None)
        mk = lambda f: (None if f is None else (
            lambda u_flat: f(u_flat.reshape(n, n, n, 3)).reshape(n3, 3)))
        forces0, forces_spd = mk(fd_pair[0]), mk(fd_pair[1])
    else:
        active_flat = active.reshape(-1)
        gather_mask = active_flat[ids] & inb   # Hessian column mask (mpm.cc:681)
        out = make_force_fn(ids, gather_mask, not_solid, gradw,
                            fe_in, volume, mu, lam, n3,
                            hessian=hess)
        forces0, forces_spd = out if hybrid else (out, None)

    def _apply_of(forces_fn):
        def apply_h(wm):
            _, df = jax.jvp(forces_fn, (zeros_u,),
                            (wm.reshape(n3, 3),))
            return df.reshape(n, n, n, 3)
        return apply_h

    apply_full = _apply_of(forces0)
    if hybrid:
        apply_spd = _apply_of(forces_spd)
    f0 = forces0(zeros_u)

    mass_safe = jnp.where(active, mass, 1.0)[..., None]
    b = jnp.where(active[..., None],
                  velg + dt * (f0.reshape(n, n, n, 3) / mass_safe + g), 0.0)

    beta_dt2 = params.beta * dt * dt

    precond = None
    if params.precond == "jacobi":
        # mass-lumped stiffness-density diagonal proxy (see MpmParams):
        # rho_i = sum_p w_pi V_p h_p, scattered through the same P2G
        # machinery as momentum (h rides in the first velocity channel)
        h_fac = mu / params.mu0
        s = volume * h_fac
        svec = jnp.stack([s, jnp.zeros_like(s), jnp.zeros_like(s)], axis=-1)
        if fast:
            _, mom_d = mf.p2g_mpm(pos, svec, flat_s, solid, B)
        else:
            _, mom_d = transfer.p2g_velocity(pos, svec, solid, B,
                                             params.kernel)
        rho = mom_d[..., 0]
        dscale = params.precond_gamma * (2.0 * params.mu0 + params.lam0)
        diag = 1.0 + beta_dt2 * dscale * rho / mass_safe[..., 0]

        def precond(r):
            return jnp.where(active[..., None], r / diag[..., None], r)

    def _matvec_of(apply_h):
        # apply_h: jax.jvp of the force function (Hessian-vector product)
        def matvec(wv):
            wm = jnp.where(active[..., None], wv, 0.0)
            df = apply_h(wm)
            out = wv + beta_dt2 * (-df) / mass_safe
            return jnp.where(active[..., None], out, wv)
        return matvec

    # Start CG at x0 = b: A = I + beta*dt^2*H/m, so b is within O(beta*dt^2)
    # of the solution and the initial residual starts a factor |A-I| smaller.
    # Measured on the 97^3 cone (rtol 1e-6): 5->4 iterations early, 7->4 at
    # frame 80, 10->8 at frame 150 — each iteration saved is a full
    # gather+scatter Hessian-vector product, ~14% of the whole frame at
    # scale.  The solution bar is unchanged (same rtol on the same system;
    # the C++-oracle KE parity and soak tolerances are trajectory-level).
    if hybrid:
        # The reference's EXACT operator first (deformHeader.h:241-272),
        # bounded by cg_hybrid_cap; on cap-hit without convergence (the
        # corotated Hessian goes indefinite under impact compression and
        # CG stagnates — frame 114 of the 127^3 cone),
        # re-solve with the unconditionally-convergent SPD Gauss-Newton
        # operator.  Field-level full-vs-spd deviation is material at
        # 127^3 (occupancy IoU ~0.4 post-impact, docs/mpm_deviation.json),
        # so production frames use the exact operator whenever it solves.
        res_f = pcg(_matvec_of(apply_full), b, x0=b, precond=precond,
                    rtol=params.cg_rtol, maxiter=params.cg_hybrid_cap)
        bnorm2 = jnp.sum((b * b).astype(jnp.float32))
        ok = (res_f.residual.astype(jnp.float32) ** 2
              <= jnp.float32(params.cg_rtol) ** 2 * bnorm2)

        def _keep(_):
            return res_f.x, res_f.iters, res_f.residual

        def _respd(_):
            r = pcg(_matvec_of(apply_spd), b, x0=b, precond=precond,
                    rtol=params.cg_rtol, maxiter=params.cg_maxiter)
            return r.x, res_f.iters + r.iters, r.residual

        solve_x, cg_iters, cg_resid = jax.lax.cond(ok, _keep, _respd, None)
        spd_used = (~ok).astype(jnp.int32)
    else:
        res = pcg(_matvec_of(apply_full), b, x0=b, precond=precond,
                  rtol=params.cg_rtol, maxiter=params.cg_maxiter)
        solve_x, cg_iters, cg_resid = res.x, res.iters, res.residual
        spd_used = jnp.asarray(1 if hess == "spd" else 0, jnp.int32)
    velg = jnp.where(active[..., None], solve_x, 0.0)  # updateVelocity, mpm.cc:705-737

    # -- deformation gradient update (mpm.cc:493-586) --
    if fast:
        gradv = mf.g2p_gradv(velg, flat_s, gradw, solid, B)
    else:
        v_nodes = velg.reshape(n3, 3)[ids] * not_solid[..., None].astype(pos.dtype)
        gradv = outer_sum27(v_nodes, gradw)
    # deformation-increment limiter (stabiliser; see MpmParams)
    gmax = jnp.max(jnp.abs(gradv), axis=(-2, -1))
    scale_g = jnp.minimum(1.0, params.max_gradv_dt / jnp.maximum(dt * gmax, 1e-12))
    gradv = gradv * scale_g[:, None, None]
    eye = jnp.eye(3, dtype=pos.dtype)
    t_fe = mm3(eye + dt * gradv, fe_in)
    f_total = mm3(t_fe, fp_in)
    fe_new, v_sinv_ut = clamp_singular(t_fe, 1.0 - params.theta_c,
                                       1.0 + params.theta_s)
    fp_new = mm3(v_sinv_ut, f_total)

    # -- FLIP advect (mpm.cc:1418, FLIPadvect 906-968) --
    vc_new = cell_center_velocity(velg)
    vc_old = cell_center_velocity(velb)
    if fast:
        delta = mf.g2p_flip_mpm(pos, flat_s, vc_new - vc_old, B, params.wall)
    else:
        delta = transfer.g2p_flip_delta(pos, vc_new, vc_old, B, params.wall,
                                        params.kernel)
    vel = vel + delta
    speed = jnp.sqrt(jnp.sum(vel * vel, axis=-1))
    max_speed = jnp.max(speed)
    dt_new = jnp.where(max_speed != 0,
                       jnp.minimum(params.max_dt, params.dx / max_speed),
                       params.max_dt)
    pos, vel = advect_bounce(
        pos, vel, dt_new, solid, B, e=0.0, rounding="out",
        analytic_wall=params.wall if params.walls_only_solid else None)

    new_state = MpmState(pos=pos, vel=vel, FE=fe_new, FP=fp_new, volume=volume,
                         dt=dt_new, t=state.t + dt_new, frame=state.frame + 1)
    metrics = {
        "cg_iters": cg_iters,
        "cg_residual": cg_resid,
        "spd_fallback": spd_used,
        "dt": dt_new,
        "dt_used": dt,
        "max_speed": max_speed,
        "kinetic_energy": 0.5 * jnp.sum((vel * vel).astype(jnp.float32)),
        "max_gradv": jnp.max(jnp.abs(gradv)),
        "max_det_fp": jnp.max(det3(fp_new)),
        "min_det_fp": jnp.min(det3(fp_new)),
        "max_det_fe": jnp.max(det3(fe_new)),
        "num_active_cells": jnp.sum(active),
        "occupancy": mass,
    }
    return new_state, metrics


class MpmSim:
    """Host-side driver mirroring ``FlipSim``."""

    def __init__(self, scene: Scene | str = "mpm_cone",
                 params: MpmParams | None = None, seed: int = 0,
                 dtype=jnp.float32, seeder=seed_particles, **scene_kwargs):
        if isinstance(scene, str):
            scene = get_scene(scene, **scene_kwargs)
        if params is None:
            params = MpmParams(bound=scene.spec.bound, wall=scene.spec.wall,
                               dx=scene.spec.dx, gravity=tuple(scene.gravity))
        if (not params.walls_only_solid
                and params.wall == scene.spec.wall
                and params.bound == scene.spec.bound
                and np.array_equal(np.asarray(scene.solid),
                                   scene.spec.wall_mask())):
            params = dataclasses.replace(params, walls_only_solid=True)
        if params.hessian == "auto":
            # reference class -> exact reference Hessian; scaled scenes ->
            # the hybrid full-then-SPD operator (see MpmParams.hessian)
            params = dataclasses.replace(
                params, hessian="full" if params.bound <= 15 else "hybrid")
        self.scene = scene
        self.params = params
        self.solid = jnp.asarray(scene.solid)
        pos, vel = seeder(scene, seed=seed, dtype=np.dtype(dtype).name)
        p = pos.shape[0]
        eye = np.broadcast_to(np.eye(3, dtype=dtype), (p, 3, 3)).copy()
        self.state = MpmState(
            pos=jnp.asarray(pos, dtype), vel=jnp.asarray(vel, dtype),
            FE=jnp.asarray(eye), FP=jnp.asarray(eye),
            volume=jnp.zeros((p,), dtype),
            dt=jnp.asarray(params.max_dt, dtype),
            t=jnp.zeros((), dtype), frame=jnp.zeros((), jnp.int32))
        self._step = jax.jit(partial(mpm_step, params), donate_argnums=(1,))
        self._scan = {}

    @property
    def num_particles(self) -> int:
        return int(self.state.pos.shape[0])

    def step(self):
        self.state, metrics = self._step(self.solid, self.state)
        return metrics

    def steps(self, k: int):
        """Run ``k`` frames in ONE device dispatch (see ``FlipSim.steps``).
        At the reference's 31^3 workload a frame's compute is short next to
        its host dispatch, so this is the production path there."""
        if k not in self._scan:
            params = self.params

            def runk(solid, state):
                def body(state, _):
                    state, metrics = mpm_step(params, solid, state)
                    metrics.pop("occupancy")
                    return state, metrics

                return jax.lax.scan(body, state, None, length=k)

            self._scan[k] = jax.jit(runk, donate_argnums=(1,))
        self.state, metrics = self._scan[k](self.solid, self.state)
        return metrics

    def run(self, frames: int, callback=None, check: bool = True,
            chunk: int = 1):
        from fluidsim_tpu.utils.profiling import check_finite
        out = None
        if chunk > 1:
            done = 0
            while done < frames:
                k = min(chunk, frames - done)
                metrics = self.steps(k)
                done += k
                frame = int(self.state.frame) - 1
                if check:
                    check_finite({m: v[-1] for m, v in metrics.items()}, frame)
                if callback is not None:
                    callback(frame, self.state, metrics)
                out = metrics
            return out
        for _ in range(frames):
            metrics = self.step()
            frame = int(self.state.frame) - 1
            if check:
                check_finite(metrics, frame)
            if callback is not None:
                callback(frame, self.state, metrics)
            out = metrics
        return out
