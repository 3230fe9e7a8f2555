"""PIC+FLIP incompressible liquid solver — ``fluid.cc`` in JAX.

One fully-jitted ``step`` reproduces the reference frame
(``fluid.cc:1368-1506``):

  P2G transfer -> occupancy -> [pressure projection do-while] ->
  FLIP delta gather -> CFL dt -> advect with solid bounce

All state lives in one pytree of dense device arrays; there are no host
round-trips inside a frame.  The pressure projection keeps the reference's
outer divergence-correction loop (rel-err <= 0.1, ``fluid.cc:1484``) and its
quirks (``velUpdate`` at ``dt/10`` strength, gravity re-applied per outer
pass) — this is the behaviour the reference's renders exhibit, so parity
requires it.  The Eigen IncompleteCholesky-PCG is replaced by a matrix-free
Jacobi-PCG over the dense grid (``ops.pressure`` + ``ops.pcg``).
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from functools import partial
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fluidsim_tpu.core.gridspec import cell_center_velocity, flat_index
from fluidsim_tpu.core.splines import cround, cround_out
from fluidsim_tpu.ops import transfer
from fluidsim_tpu.ops import pressure as pr
from fluidsim_tpu.ops.pcg import pcg, jacobi_preconditioner
from fluidsim_tpu.scenes import Scene, get_scene
from fluidsim_tpu.seeding import seed_particles


@dataclasses.dataclass(frozen=True)
class FlipParams:
    """Static solver configuration (hashable; closed over by the jitted step).

    Defaults mirror the reference constants: dt cap 0.1 (``fluid.cc:1367``),
    rho=1, dx=1 (``fluid.cc:1358,1471``), gravity (0,-10,0)
    (``fluid.cc:1357``), outer tolerance 0.1 (``fluid.cc:1484``), bounce
    restitution 0 for FLIP / 0.5 for PIC (``fluid.cc:974,906``).
    """

    bound: int = 60
    wall: int = 58
    dx: float = 1.0
    rho: float = 1.0
    max_dt: float = 0.1
    gravity: Tuple[float, float, float] = (0.0, -10.0, 0.0)
    outer_tol: float = 0.1
    max_outer: int = 100
    pcg_rtol: float = 0.0       # 0 = auto by grid size (auto_pcg_rtol)
    pcg_maxiter: int = 400
    mode: str = "flip"          # "flip" (e=0) or "pic" (e=0.5)
    kernel: str = "flip"
    compat_projection: bool = True   # keep dt/10 + per-pass gravity quirks
    fast_transfer: bool = True       # sorted channel-fused transfers (ops.transfer_fast)
    transfer_chunks: int = 0         # >0: x-slab-chunked tables (ops.transfer_chunked)
                                     # for grids whose fused tables exceed
                                     # device memory (FlipSim sets it from
                                     # the device's memory limit)
    walls_only_solid: bool = False   # scene solid == box walls exactly;
                                     # enables the analytic bounce probe
                                     # (auto-detected by FlipSim)
    preconditioner: str = "chebyshev"  # "jacobi", "chebyshev" (polynomial)
    # or "multigrid" (V-cycle).  Chebyshev-Jacobi d3 cuts CG iterations
    # 113 -> 39 at 129^3 (the d+1 in-precond stencil applies amortize the
    # dots/axpys/while-step cost per iteration); multigrid cuts them ~10x
    # (110 -> 11) but its V-cycle overhead outweighs that on these easy
    # systems (right tool for deep columns / tight tolerances).
    cheb_degree: int = 3     # chebyshev: polynomial degree (applies/precond)
    cheb_ratio: float = 30.0  # chebyshev: lam_max / lam_min target interval


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FlipState:
    pos: jax.Array       # (P, 3) positions, index space
    vel: jax.Array       # (P, 3) velocities
    dt: jax.Array        # () — CFL dt carried across frames (fluid.cc:1490)
    t: jax.Array         # () — accumulated simulation time
    frame: jax.Array     # () int32
    aff: jax.Array | None = None   # (P, 3, 3) APIC affine matrices (mode="apic")
    pressure: jax.Array | None = None  # (N,N,N) last pressure solution —
                                       # warm-starts the next frame's PCG


def lookup_bool(grid, cells, bound: int):
    """Read a bool grid at integer coords; out-of-box reads the OpenVDB
    background (False)."""
    n = 2 * bound + 1
    inb = jnp.all(jnp.abs(cells) <= bound, axis=-1)
    idx = jnp.clip(cells + bound, 0, n - 1)
    return grid.reshape(-1)[flat_index(idx, n)] & inb


def advect_bounce(pos, vel, dt, solid, bound: int, e: float, rounding: str,
                  analytic_wall: int | None = None):
    """Advection with per-axis solid bounce (``FLIPadvect``,
    ``fluid.cc:1000-1036`` / ``mpm.cc:934-966``).

    ``rounding``: "round" = C round() (fluid.cc), "out" = ceil/floor away
    from zero (mpm.cc FLIPadvect).  The per-axis probe mixes the rounded
    moved coordinate on the probed axis with the *truncated* original
    position on the others (the reference passes doubles to the int Coord
    constructor, ``fluid.cc:951-959``).

    ``analytic_wall``: when the scene's solid mask is exactly the box walls
    (``|c| > wall`` on any axis, the reference's default geometry,
    ``fluid.cc:1256-1260``), the four per-particle solid *gathers* below
    collapse to elementwise coordinate tests (no per-particle gathers).
    ``FlipSim``/``MpmSim``
    auto-detect this and pass the wall radius; scenes with obstacles keep
    the general grid probe.
    """
    rnd = cround if rounding == "round" else cround_out

    if analytic_wall is not None:
        def probe_solid(c):
            inb = jnp.all(jnp.abs(c) <= bound, axis=-1)
            return jnp.any(jnp.abs(c) > analytic_wall, axis=-1) & inb
    else:
        def probe_solid(c):
            return lookup_bool(solid, c, bound)

    pnew = pos + dt * vel
    r = rnd(pnew).astype(jnp.int32)
    hit = probe_solid(r)

    ptrunc = jnp.trunc(pos).astype(jnp.int32)
    velm = []
    for d in range(3):
        probe = ptrunc.at[:, d].set(r[:, d])
        hit_d = probe_solid(probe)
        velm.append(jnp.where(hit & hit_d, -e * vel[:, d], vel[:, d]))
    velm = jnp.stack(velm, axis=-1)
    pos_out = jnp.where(hit[:, None], pos + velm * dt, pnew)
    return pos_out, velm


def auto_pcg_rtol(n: int) -> float:
    """CG tolerance auto-scale (used when ``params.pcg_rtol == 0``).

    1e-5 at the reference class (n <= 129) keeps the recorded KE-parity
    trace stable (``docs/parity_full_121cube.json``: 1.6e-5 vs the C++
    port at rtol 1e-5).  Scaled grids get 1e-3: measured at 255^3/9.8M
    the outer divergence error and div_rms are IDENTICAL to 3 digits
    (0.0658 / 1.60 — the do-while's err <= 0.1 contract, ``fluid.cc:1484``,
    is enforced regardless), KE differs by 2e-4 relative, and CG
    iterations drop 62 -> 31."""
    return 1e-5 if n <= 129 else 1e-3


def project(params: FlipParams, velg, fluid, solid, dt, p0=None):
    """Pressure projection.

    ``compat_projection=True`` (default): the reference's do-while
    (``fluid.cc:1457-1484``) with its quirks — ``velUpdate`` at 1/10 gradient
    strength and gravity re-applied per outer pass — iterated until the
    relative divergence change is <= ``outer_tol``.

    ``compat_projection=False``: the textbook projection — gravity applied
    once up front, a single solve, and the full-strength gradient update.
    Produces markedly better volume conservation (hydrostatic pools hold
    their height) at the cost of diverging from the reference's trajectory.

    ``p0``: warm-start pressure (typically the previous frame's solution,
    masked here to the current fluid cells).  The reference rebuilds its
    Eigen solver from scratch every frame; CG from a one-frame-old pressure
    reaches the same ``pcg_rtol`` in ~2-3x fewer iterations and changes the
    answer only within that tolerance.  Outer passes beyond the first warm-
    start from the previous pass's solution (the systems are near-identical:
    the pass-to-pass RHS change is what ``outer_tol`` bounds).

    Returns (velg', err, n_outer, cg_iters_total, div_rms, pressure).
    """
    g = jnp.asarray(params.gravity, velg.dtype)
    dx, rho = params.dx, params.rho
    pcg_rtol = params.pcg_rtol or auto_pcg_rtol(fluid.shape[0])
    adiag = pr.laplacian_diag(fluid, solid, dt, rho, dx, dtype=velg.dtype)

    apply_a = lambda p: pr.apply_laplacian(p, adiag, fluid, dt, rho, dx)
    if params.preconditioner == "multigrid":
        from fluidsim_tpu.ops.multigrid import mg_preconditioner
        precond = mg_preconditioner(fluid, solid, dt, rho, dx)
    elif params.preconditioner == "chebyshev":
        from fluidsim_tpu.ops.pcg import chebyshev_preconditioner
        precond = chebyshev_preconditioner(
            apply_a, jacobi_preconditioner(adiag, mask=fluid),
            degree=params.cheb_degree, ratio=params.cheb_ratio)
    else:
        precond = jacobi_preconditioner(adiag, mask=fluid)

    def solve(b, x0):
        res = pcg(apply_a, b, x0=x0, precond=precond,
                  rtol=pcg_rtol, maxiter=params.pcg_maxiter)
        return res.x, res.iters

    def norm(x):
        return jnp.sqrt(jnp.sum((x * x).astype(jnp.float32)))

    nfluid = jnp.maximum(jnp.sum(fluid), 1)
    p0 = (jnp.zeros(fluid.shape, velg.dtype) if p0 is None
          else jnp.where(fluid, p0, 0.0))

    if not params.compat_projection:
        # clean mode: v += g*dt once, then one full-strength solve
        fl = fluid.astype(velg.dtype)
        velg = velg + g[None, None, None, :] * dt * fl[..., None]
        rhs = pr.set_rhs(velg, fluid, solid, jnp.zeros_like(g), dt, dx)
        b = pr.divergence_rhs(velg, rhs, fluid, solid, dx)
        x, iters = solve(b, p0)
        velg = pr.vel_update(velg, x, fluid, solid, g, dt, rho, dx,
                             gradient_scale=1.0, add_gravity=False)
        rhs2 = pr.set_rhs(velg, fluid, solid, jnp.zeros_like(g), dt, dx)
        b2 = pr.divergence_rhs(velg, rhs2, fluid, solid, dx)
        bn = norm(b)
        err = jnp.where(bn > 0, norm(b2) / jnp.where(bn > 0, bn, 1.0), 0.0)
        div_rms = norm(b2) / jnp.sqrt(nfluid.astype(jnp.float32))
        return velg, err, jnp.ones((), jnp.int32), iters, div_rms, x

    def one_pass(velg, x0):
        rhs = pr.set_rhs(velg, fluid, solid, g, dt, dx)
        b = pr.divergence_rhs(velg, rhs, fluid, solid, dx)
        x, iters = solve(b, x0)
        velg2 = pr.vel_update(velg, x, fluid, solid, g, dt, rho, dx)
        rhs2 = pr.set_rhs(velg2, fluid, solid, g, dt, dx)
        b2 = pr.divergence_rhs(velg2, rhs2, fluid, solid, dx)
        bn = norm(b)
        err = jnp.where(bn > 0, norm(b - b2) / jnp.where(bn > 0, bn, 1.0), 0.0)
        return velg2, err, iters, b2, x

    def body(carry):
        velg, _, n, cg_tot, _, x0 = carry
        velg, err, iters, b2, p = one_pass(velg, x0)
        return velg, err, n + 1, cg_tot + iters, b2, p

    init = body((velg, jnp.inf, jnp.zeros((), jnp.int32),
                 jnp.zeros((), jnp.int32),
                 jnp.zeros(fluid.shape, velg.dtype), p0))

    def cond(carry):
        _, err, n, _, _, _ = carry
        return (err > params.outer_tol) & (n < params.max_outer)

    velg, err, n, cg_tot, b2, p = jax.lax.while_loop(cond, body, init)
    div_rms = norm(b2) / jnp.sqrt(nfluid.astype(jnp.float32))
    return velg, err, n, cg_tot, div_rms, p


def flip_step(params: FlipParams, solid, state: FlipState):
    """One frame (``fluid.cc:1368-1506``). Fully jittable."""
    B, wall = params.bound, params.wall
    pos, vel, dt = state.pos, state.vel, state.dt

    aff = state.aff
    if params.mode == "apic":
        from fluidsim_tpu.ops import transfer_fast as tf
        from fluidsim_tpu.ops import apic
        pos, vel, flat, aff_flat = tf.sort_by_cell(
            pos, vel, B, extra=state.aff.reshape(-1, 9))
        aff = aff_flat.reshape(-1, 3, 3)
        weights, mom, occ = apic.p2g_apic(pos, vel, aff, flat, solid, B,
                                          params.kernel)
        velg = transfer.normalize_velocity(weights, mom)
    elif params.fast_transfer and params.transfer_chunks > 0:
        from fluidsim_tpu.ops import transfer_fast as tf
        from fluidsim_tpu.ops import transfer_chunked as tch
        pos, vel, flat = tf.sort_by_cell(pos, vel, B)
        weights, mom, occ, p2g_overflow = tch.p2g_fused_chunked(
            pos, vel, flat, solid, B, params.kernel,
            n_chunks=params.transfer_chunks)
        velg = transfer.normalize_velocity(weights, mom)
    elif params.fast_transfer:
        from fluidsim_tpu.ops import transfer_fast as tf
        pos, vel, flat = tf.sort_by_cell(pos, vel, B)
        weights, mom, occ = tf.p2g_fused(pos, vel, flat, solid, B,
                                         params.kernel)
        velg = transfer.normalize_velocity(weights, mom)
    else:
        # -- P2G (fluid.cc:1384) --
        weights, mom = transfer.p2g_velocity(pos, vel, solid, B, params.kernel)
        velg = transfer.normalize_velocity(weights, mom)
        # -- occupancy (fluid.cc:1413) --
        occ = transfer.p2g_mass(pos, solid, B, params.kernel)

    fluid = (occ > 0) & (~solid)

    velb = velg  # velBeforeUpdate (fluid.cc:1455)

    # -- pressure projection do-while (fluid.cc:1457-1484) --
    velg, err, n_outer, cg_iters, div_rms, pressure = project(
        params, velg, fluid, solid, dt, p0=state.pressure)

    # -- FLIP / PIC / APIC grid-to-particle (fluid.cc:1490) --
    vc_new = cell_center_velocity(velg)

    def g2p(fields):
        """Normalised 27-point gather via whichever schedule is active."""
        if params.fast_transfer and params.transfer_chunks > 0:
            from fluidsim_tpu.ops import transfer_chunked as tch
            out, _ = tch.g2p_fused_chunked(pos, flat, fields, B, wall,
                                           params.kernel,
                                           n_chunks=params.transfer_chunks)
            return out
        if params.fast_transfer:
            return tf.g2p_fused(pos, flat, fields, B, wall, params.kernel)
        return None

    if params.mode == "apic":
        vel, aff = apic.g2p_apic(pos, flat, vc_new, B, wall, params.kernel)
        e = 0.5
    elif params.mode == "flip":
        vc_old = cell_center_velocity(velb)
        delta = g2p(vc_new - vc_old)
        if delta is None:
            delta = transfer.g2p_flip_delta(pos, vc_new, vc_old, B, wall,
                                            params.kernel)
        vel = vel + delta
        e = 0.0
    else:
        vel = g2p(vc_new)
        if vel is None:
            vel = transfer.g2p_gather(pos, vc_new, B, wall, params.kernel)
        e = 0.5

    # -- CFL (fluid.cc:992-999) --
    speed = jnp.sqrt(jnp.sum(vel * vel, axis=-1))
    max_speed = jnp.max(speed)
    dt_new = jnp.where(max_speed != 0,
                       jnp.minimum(params.max_dt, params.dx / max_speed),
                       params.max_dt)

    # -- advect + bounce (fluid.cc:1000-1036) --
    pos, vel = advect_bounce(
        pos, vel, dt_new, solid, B, e, rounding="round",
        analytic_wall=params.wall if params.walls_only_solid else None)

    new_state = FlipState(pos=pos, vel=vel, dt=dt_new,
                          t=state.t + dt_new, frame=state.frame + 1,
                          aff=aff, pressure=pressure)
    metrics = {
        "error": err,
        "dt_used": dt,
        "outer_iters": n_outer,
        "cg_iters": cg_iters,
        "dt": dt_new,
        "max_speed": max_speed,
        "kinetic_energy": 0.5 * jnp.sum((vel * vel).astype(jnp.float32)),
        "div_rms": div_rms,
        "num_fluid_cells": jnp.sum(fluid),
        "transfer_overflow": (p2g_overflow if (params.fast_transfer and
                                               params.transfer_chunks > 0)
                              else jnp.zeros((), jnp.int32)),
        "occupancy": occ,
    }
    return new_state, metrics


def fused_table_bytes(n: int) -> int:
    """Bytes of the two fused transfer tables (the P2G scatter and the G2P
    gather, ``ops.transfer_fast``): n^3 cells x 128 f32 channels each."""
    return 2 * n ** 3 * 128 * 4


def device_memory_limit(device) -> int | None:
    """Bytes the device lets this process allocate, or None where the
    backend reports no limit (the CPU)."""
    stats = device.memory_stats()
    return stats.get("bytes_limit") if stats else None


def fit_transfers(params: FlipParams, n: int,
                  limit: int | None) -> FlipParams:
    """Fit the fused transfer tables into ``limit`` bytes of device memory.

    The tables may take half of it; the rest holds the particles, the grid
    fields and the CG vectors.  Past that, FLIP moves to x-slab chunked
    tables (``ops.transfer_chunked``) of about a quarter of ``limit`` each,
    and APIC, which has no chunked schedule, is refused.  ``limit=None``
    keeps ``params`` as given: only an explicit ``transfer_chunks`` chunks.
    Multi-device sharding is the real answer at that scale (each shard
    holds only its slab's tables)."""
    if params.mode == "apic" and params.transfer_chunks > 0:
        raise NotImplementedError(
            "transfer_chunks is not supported with mode='apic' yet; "
            "use ShardedFlipSim for large APIC grids")
    table = fused_table_bytes(n)
    if limit is None or table <= limit // 2:
        return params
    if params.mode == "apic":
        raise NotImplementedError(
            f"grid {n}^3: APIC fused tables ~{table / 1e9:.1f} GB exceed half "
            f"of the device's {limit / 1e9:.1f} GB; use ShardedFlipSim")
    if not params.fast_transfer or params.transfer_chunks > 0:
        return params
    chunks = 2 ** math.ceil(math.log2(table / (limit / 4)))
    warnings.warn(
        f"grid {n}^3: fused tables ~{table / 1e9:.1f} GB exceed half of the "
        f"device's {limit / 1e9:.1f} GB; chunking transfers over {chunks} "
        "x-slabs (multi-device ShardedFlipSim is the preferred route)",
        stacklevel=3)
    return dataclasses.replace(params, transfer_chunks=chunks)


class FlipSim:
    """Host-side driver: owns the jitted step, the frame loop, and export."""

    def __init__(self, scene: Scene | str = "water_cube_drop",
                 params: FlipParams | None = None, seed: int = 0,
                 dtype=jnp.float32, seeder=seed_particles, **scene_kwargs):
        if isinstance(scene, str):
            scene = get_scene(scene, **scene_kwargs)
        if params is None:
            params = FlipParams(bound=scene.spec.bound, wall=scene.spec.wall,
                                dx=scene.spec.dx,
                                gravity=tuple(scene.gravity))
        # Walls-only scenes (no obstacles) take the analytic bounce probe
        # (see advect_bounce docstring).
        if (not params.walls_only_solid
                and params.wall == scene.spec.wall
                and params.bound == scene.spec.bound
                and np.array_equal(np.asarray(scene.solid),
                                   scene.spec.wall_mask())):
            params = dataclasses.replace(params, walls_only_solid=True)
        params = fit_transfers(params, scene.spec.n,
                               device_memory_limit(jax.devices()[0]))
        self.scene = scene
        self.params = params
        self.solid = jnp.asarray(scene.solid)
        pos, vel = seeder(scene, seed=seed, dtype=np.dtype(dtype).name)
        aff = (jnp.zeros((pos.shape[0], 3, 3), dtype)
               if params.mode == "apic" else None)
        self.state = FlipState(
            pos=jnp.asarray(pos, dtype), vel=jnp.asarray(vel, dtype),
            dt=jnp.asarray(params.max_dt, dtype),
            t=jnp.zeros((), dtype), frame=jnp.zeros((), jnp.int32),
            aff=aff, pressure=jnp.zeros(scene.spec.shape, dtype))
        self._step = jax.jit(partial(flip_step, params), donate_argnums=(1,))
        self._scan = {}

    @property
    def num_particles(self) -> int:
        return int(self.state.pos.shape[0])

    def step(self) -> Dict[str, Any]:
        self.state, metrics = self._step(self.solid, self.state)
        return metrics

    def steps(self, k: int) -> Dict[str, Any]:
        """Run ``k`` frames in ONE device dispatch (``lax.scan`` over the
        jitted step).  Production 500-frame runs only need host contact
        at export points, so the scan amortises the per-frame host
        dispatch, which matters most where a frame is short (MPM's
        31^3).  Returns stacked per-frame metrics
        (leaves get a leading (k,) axis); grid-sized metrics (occupancy)
        are dropped from the stack — use ``step()``/``state`` when a frame
        grid is needed (e.g. per-frame VDB export)."""
        if k not in self._scan:
            params = self.params

            def runk(solid, state):
                def body(state, _):
                    state, metrics = flip_step(params, solid, state)
                    metrics.pop("occupancy")
                    return state, metrics

                return jax.lax.scan(body, state, None, length=k)

            self._scan[k] = jax.jit(runk, donate_argnums=(1,))
        self.state, metrics = self._scan[k](self.solid, self.state)
        return metrics

    def run(self, frames: int, callback=None, check: bool = True,
            chunk: int = 1):
        """Frame loop (``fluid.cc:1368``); callback(frame, state, metrics)
        runs host-side (export, logging).  ``chunk`` > 1 scans that many
        frames per dispatch (callback then fires once per chunk with the
        stacked metrics and the chunk's FINAL state)."""
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
