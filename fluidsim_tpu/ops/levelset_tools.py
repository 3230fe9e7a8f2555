"""Level-set evolution tools: rebuild, filter, morph, track, measure.

Completes the dense-array answer to the reference's level-set tool family
(``openvdb/tools/LevelSetRebuild.h``, ``LevelSetFilter.h``,
``LevelSetMorph.h``, ``LevelSetTracker.h``, ``LevelSetMeasure.h`` — none
are called by the apps, SURVEY.md §2.2, but all are part of the library
surface).  The reference implementations are narrow-band sparse-tree
algorithms threaded over leaf nodes with TBB; here each is a dense
whole-grid pass — a few shifted adds XLA fuses into one HBM sweep, with
the "narrow band" expressed as a cell mask that freezes far-field values
rather than as tree topology.

All functions are jit-safe, use fixed iteration counts (static shapes and
trip counts for XLA), and treat out-of-box neighbors as background.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from fluidsim_tpu.core.gridspec import shift_to_plus, shift_to_minus
from fluidsim_tpu.ops.advect_volume import advect_volume

__all__ = [
    "redistance", "rebuild_levelset", "filter_mean", "filter_gaussian",
    "filter_median", "filter_offset", "morph_levelset", "track_levelset",
    "levelset_area", "levelset_avg_curvature",
]


# Edge-clamped shift (out-of-box reads repeat the boundary value —
# zero-background shifts would pin boundary cells of an SDF at 1/√3
# during redistancing); shared with the FD scheme family.
from fluidsim_tpu.ops.fd import shift_edge as _shift_edge  # noqa: E402


def _godunov_grad_norm(phi, speed_sign, dx: float):
    """Godunov upwind |∇φ| for motion with sign ``speed_sign`` (+1 grows
    the outside / moves the interface inward, per Hamilton-Jacobi
    convention φ_t + s|∇φ| = 0)."""
    g2 = jnp.zeros_like(phi)
    for d in range(3):
        dm = (phi - _shift_edge(phi, d, -1)) / dx  # backward difference
        dp = (_shift_edge(phi, d, +1) - phi) / dx  # forward difference
        pos = jnp.maximum(jnp.maximum(dm, 0.0) ** 2,
                          jnp.minimum(dp, 0.0) ** 2)
        neg = jnp.maximum(jnp.minimum(dm, 0.0) ** 2,
                          jnp.maximum(dp, 0.0) ** 2)
        g2 = g2 + jnp.where(speed_sign > 0, pos, neg)
    return jnp.sqrt(g2)


def redistance(phi, iterations: int = 20, dx: float = 1.0, band: float | None = None):
    """PDE reinitialization: evolve ``φ_t = S(φ₀)(1 − |∇φ|)`` to restore
    the signed-distance property while preserving the zero level set.

    Dense equivalent of ``tools::LevelSetRebuild`` /
    ``LevelSetTracker::normalize`` — those re-mesh or renormalize the
    narrow band; this runs the classic Sussman–Smereka–Osher relaxation
    with Godunov upwinding, fixed trip count, CFL ``dt = 0.3 dx``.

    ``band``: if given, cells with ``|φ| > band`` are frozen (narrow-band
    behavior) — they keep their (clamped) input values.
    """
    phi0 = phi
    s = phi0 / jnp.sqrt(phi0 * phi0 + dx * dx)
    dt = 0.3 * dx
    frozen = None if band is None else (jnp.abs(phi0) > band)

    def body(_, p):
        g = _godunov_grad_norm(p, s, dx)
        p_new = p - dt * s * (g - 1.0)
        if frozen is not None:
            p_new = jnp.where(frozen, p, p_new)
        return p_new

    return jax.lax.fori_loop(0, iterations, body, phi)


def rebuild_levelset(field, iso: float = 0.0, half_width: float = 3.0,
                     iterations: int = 30, dx: float = 1.0,
                     fog: bool = False):
    """Rebuild a signed distance field from any scalar field's
    ``iso``-contour (``tools::levelSetRebuild``): seed with
    ``field − iso``, renormalize to unit gradient, clamp to
    ``±half_width·dx`` like OpenVDB's truncated narrow-band SDFs.

    ``fog=True`` flips the seed to ``iso − field`` for density/fog
    volumes whose *interior* is the high side (the sdfToFogVolume
    inverse direction): interiors come out negative as an SDF requires.
    """
    seed = (iso - field) if fog else (field - iso)
    # Normalize the seed to ±dx/2: a voxelized iso-contour lies midway
    # between an inside and an outside sample, so the near-interface seed
    # magnitude must be half a voxel — larger seeds (steep steps) make the
    # Godunov relaxation walk the zero crossing off the true surface.
    g = jnp.maximum(jnp.max(jnp.abs(seed)), 1e-12)
    seed = seed * (0.5 * dx / g)
    sdf = redistance(seed, iterations=iterations, dx=dx)
    w = half_width * dx
    return jnp.clip(sdf, -w, w)


def _box_blur_axis(a, d, width: int):
    """1-D box blur of odd ``width`` along axis ``d`` (edge-clamped)."""
    r = width // 2
    acc = a
    up = a
    dn = a
    for _ in range(r):
        # edge-clamped shifts: re-use the boundary value instead of 0 so
        # filtering does not drag the far field toward zero at the box edge
        pad_up = [(0, 0)] * 3
        pad_up[d] = (0, 1)
        up = jnp.pad(up, pad_up, mode="edge")[tuple(
            slice(1, None) if i == d else slice(None) for i in range(3))]
        pad_dn = [(0, 0)] * 3
        pad_dn[d] = (1, 0)
        dn = jnp.pad(dn, pad_dn, mode="edge")[tuple(
            slice(0, -1) if i == d else slice(None) for i in range(3))]
        acc = acc + up + dn
    return acc / float(width)


def _banded(phi, filtered, band: float | None, dx: float):
    if band is None:
        return filtered
    return jnp.where(jnp.abs(phi) > band * dx, phi, filtered)


def filter_mean(phi, width: int = 3, band: float | None = None, dx: float = 1.0):
    """Separable box (mean) filter — ``LevelSetFilter::mean``.  ``width``
    is the full odd stencil width in voxels; ``band`` (in voxels) freezes
    the far field like the reference's narrow-band filtering."""
    if width % 2 != 1:
        raise ValueError("width must be odd")
    out = phi
    for d in range(3):
        out = _box_blur_axis(out, d, width)
    return _banded(phi, out, band, dx)


def filter_gaussian(phi, width: int = 3, iterations: int = 4,
                    band: float | None = None, dx: float = 1.0):
    """Gaussian filter as repeated box blurs (central-limit approximation)
    — ``LevelSetFilter::gaussian`` uses the same repeated-mean trick."""
    out = phi
    for _ in range(iterations):
        for d in range(3):
            out = _box_blur_axis(out, d, width)
    return _banded(phi, out, band, dx)


def filter_median(phi, band: float | None = None, dx: float = 1.0):
    """27-neighborhood median — ``LevelSetFilter::median`` with its
    default radius-1 box.  Out-of-box neighbors clamp to the edge value.
    Implemented as a sort over a stacked 27-channel axis (one fused pass;
    no data-dependent control flow)."""
    stack = []
    for sx in (-1, 0, 1):
        for sy in (-1, 0, 1):
            for sz in (-1, 0, 1):
                v = phi
                for d, s in enumerate((sx, sy, sz)):
                    if s == 0:
                        continue
                    pad = [(0, 0)] * 3
                    if s > 0:
                        pad[d] = (0, 1)
                        v = jnp.pad(v, pad, mode="edge")[tuple(
                            slice(1, None) if i == d else slice(None)
                            for i in range(3))]
                    else:
                        pad[d] = (1, 0)
                        v = jnp.pad(v, pad, mode="edge")[tuple(
                            slice(0, -1) if i == d else slice(None)
                            for i in range(3))]
                stack.append(v)
    arr = jnp.stack(stack, axis=-1)
    med = jnp.sort(arr, axis=-1)[..., 13]
    return _banded(phi, med, band, dx)


def filter_offset(grid, offset, mask=None):
    """Add a constant to every voxel — ``tools::Filter::offset``
    (``openvdb/tools/Filter.h:166-168,419-433``).  With ``mask`` (an
    alpha grid in [0,1]) the offset is alpha-blended per voxel exactly
    like the reference's masked variant (``Filter.h:427``).  Together
    with ``filter_mean``/``filter_gaussian``/``filter_median`` (which with
    ``band=None`` operate on the whole grid) this provides the generic
    volume-filter capability of ``openvdb/tools/Filter.h``, not just the
    level-set-banded specialization."""
    if mask is None:
        return grid + offset
    return grid + mask * offset


def morph_levelset(phi, target, iterations: int = 20, dx: float = 1.0,
                   renorm_every: int = 5, speed_clamp: float = 3.0):
    """Morph one level set toward another — ``tools::LevelSetMorph``.

    Solves ``φ_t = α(x)|∇φ|`` where the speed ``α`` is the target's
    signed distance sampled at ``x``: where the current interface lies
    outside the target (``α > 0``) φ grows — the interface retreats
    inward — and inside the target (``α < 0``) it expands, with Godunov
    upwinding and periodic renormalization, exactly the scheme family the
    reference's morph tool integrates (its default 1st-order TVD-RK).

    The speed is clamped to ``±speed_clamp·dx`` so the CFL step is set by
    the near-interface speeds that matter, not by the domain's far
    corners, and the evolving field is kept a (band-clamped) SDF the way
    ``LevelSetTracker`` does: periodic renormalization plus band clamp
    during the evolution — otherwise interior values sink without bound
    (the PDE's speed never vanishes away from the target surface) — and a
    final full redistance so returned values are true distances.
    """
    cap = speed_clamp * dx
    speed = jnp.clip(target, -cap, cap)
    dt = 0.3 * dx / cap
    band = 3.0 * cap

    def body(i, p):
        g = _godunov_grad_norm(p, -speed, dx)
        p = jnp.clip(p + dt * speed * g, -band, band)
        p = jax.lax.cond(
            (i + 1) % renorm_every == 0,
            lambda q: redistance(q, iterations=3, dx=dx),
            lambda q: q, p)
        return p

    out = jax.lax.fori_loop(0, iterations, body, phi)
    return redistance(out, iterations=int(band / (0.3 * dx)) + 2, dx=dx)


def track_levelset(phi, vc, dt, bound: int, order: int = 2,
                   redist_iterations: int = 5, half_width: float | None = None,
                   dx: float = 1.0, spatial: str = "semi"):
    """One tracked level-set advection step — ``tools::LevelSetAdvect`` +
    ``LevelSetTracker``: transport in velocity field ``vc`` (cell-centred
    ``(N,N,N,3)``), then renormalization, then optional truncation to
    ``±half_width·dx`` (the tracker's band prune).

    ``spatial`` selects the transport discretization, mirroring the
    reference's ``BiasedGradientScheme`` menu (``LevelSetAdvect.h`` with
    ``math/FiniteDifference.h:207-219``): ``"semi"`` (default) is the
    semi-Lagrangian path; ``"first"``/``"second"``/``"third"``/``"weno5"``/
    ``"hjweno5"`` run Eulerian upwind HJ advection (``ops/fd.py``) with
    TVD-RK``order`` time integration.
    """
    if spatial == "semi":
        phi = advect_volume(phi, vc, dt, bound, order=order)
    else:
        from fluidsim_tpu.ops.fd import advect_hj
        # vc is index-space velocity (voxels/time) in BOTH paths —
        # advect_volume back-traces in index space, so the HJ gradient
        # must also be per-voxel (dx=1); this function's own ``dx`` only
        # scales the renormalization below
        phi = advect_hj(phi, vc, dt, spatial=spatial,
                        temporal=min(order, 3), dx=1.0)
    phi = redistance(phi, iterations=redist_iterations, dx=dx)
    if half_width is not None:
        w = half_width * dx
        phi = jnp.clip(phi, -w, w)
    return phi


def _delta_weight(phi, dx: float, eps_voxels: float):
    """Surface-integral weight field ``δ_ε(φ)|∇φ|`` shared by the
    levelSetMeasure outputs: smeared delta
    ``δ_ε(φ) = (1 + cos(πφ/ε)) / (2ε)`` on ``|φ| < ε`` times the
    central-difference gradient magnitude."""
    eps = eps_voxels * dx
    d = jnp.where(jnp.abs(phi) < eps,
                  (1.0 + jnp.cos(jnp.pi * phi / eps)) / (2.0 * eps), 0.0)
    g2 = jnp.zeros_like(phi)
    for ax in range(3):
        g = (shift_to_plus(phi, ax) - shift_to_minus(phi, ax)) / (2.0 * dx)
        g2 = g2 + g * g
    return d * jnp.sqrt(g2)


def levelset_avg_curvature(phi, dx: float = 1.0, eps_voxels: float = 1.5):
    """Average mean curvature over the zero level set —
    ``tools::levelSetMeasure``'s third output
    (``openvdb/tools/LevelSetMeasure.h:95-108``): the surface-integral
    average ``(∫ δ_ε(φ)|∇φ| κ) / (∫ δ_ε(φ)|∇φ|)`` with the same smeared
    delta as ``levelset_area`` and κ = (κ₁+κ₂)/2 from the grid-operator
    mean-curvature stencil.  For a sphere of radius r this returns 1/r.
    """
    from fluidsim_tpu.ops.gridops import mean_curvature
    w = _delta_weight(phi, dx, eps_voxels)
    kappa = mean_curvature(phi, dx)
    tot = jnp.sum(w)
    return jnp.sum(w * kappa) / jnp.where(tot > 0, tot, 1.0)


def levelset_area(phi, dx: float = 1.0, eps_voxels: float = 1.5):
    """Surface area of the zero level set — ``tools::levelSetArea``
    (``LevelSetMeasure.h``): ``A = Σ δ_ε(φ) |∇φ| dx³``."""
    return jnp.sum(_delta_weight(phi, dx, eps_voxels)) * dx ** 3
