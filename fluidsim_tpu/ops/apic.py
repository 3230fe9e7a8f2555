"""APIC (Affine Particle-In-Cell) transfer variant.

The reference ships PIC and FLIP blending only; APIC (Jiang et al. 2015)
carries a per-particle affine velocity matrix C so angular/shear motion
survives the grid round-trip without FLIP's noise.  This is the transfer
upgrade named in the benchmark plan (BASELINE.json config 4), built on the
same sorted channel-fused schedule as ``ops.transfer_fast``:

* P2G momentum channels become ``w_o * (v + C (x_o - x_p))`` — still one
  sorted 108-channel scatter, since the offset vector is per-channel.
* G2P gathers velocity and the outer-product moments in one fused pass:
  ``B = sum w vc d^T``, ``D = sum w d d^T``, ``C = B D^{-1}``.

The general-D form is used (the reference's compressed kernel is not the
standard quadratic B-spline, so the usual ``D = dx^2/4 I`` shortcut does not
hold).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from fluidsim_tpu.core.splines import cround
from fluidsim_tpu.ops.transfer import _OFFSETS
from fluidsim_tpu.ops.transfer_fast import _stencil_w, _shift3, _neighborhood_table
from fluidsim_tpu.ops.smallmat import apply_mat27 as _apply_mat27
from fluidsim_tpu.ops.smallmat import outer_sum27 as _outer_sum27


def p2g_apic(pos_s, vel_s, aff_s, flat_s, solid, bound: int,
             kernel: str = "flip"):
    """APIC P2G: weights + affine-augmented momentum + occupancy."""
    n = 2 * bound + 1
    w27 = _stencil_w(pos_s, kernel)
    valid = jnp.all(jnp.abs(cround(pos_s)) <= bound, axis=-1)
    w27 = jnp.where(valid[:, None], w27, 0.0)

    base = cround(pos_s)
    offs = jnp.asarray(_OFFSETS, pos_s.dtype)
    d = (base[:, None, :] + offs[None]) - pos_s[:, None, :]     # (P,27,3)
    v_aug = vel_s[:, None, :] + _apply_mat27(aff_s, d)
    u = jnp.concatenate([w27[..., None], w27[..., None] * v_aug], axis=-1)
    dsum = jnp.zeros((n * n * n, 27 * 4), pos_s.dtype).at[flat_s].add(
        u.reshape(-1, 27 * 4), indices_are_sorted=True)
    dsum = dsum.reshape(n, n, n, 27, 4)
    acc = jnp.zeros((n, n, n, 4), pos_s.dtype)
    for o in range(27):
        acc = acc + _shift3(dsum[..., o, :], _OFFSETS[o])

    coords = np.abs(np.arange(-bound, bound + 1))
    wi = coords <= bound - 2
    p2g_mask = jnp.asarray(wi[:, None, None] & wi[None, :, None]
                           & wi[None, None, :]) & (~solid)
    weights = jnp.where(p2g_mask, acc[..., 0], 0.0)
    mom = jnp.where(p2g_mask[..., None], acc[..., 1:4], 0.0)
    occ = jnp.where(~solid, acc[..., 0], 0.0)
    return weights, mom, occ


def g2p_apic(pos_s, flat_s, vc, bound: int, wall: int, kernel: str = "flip"):
    """APIC G2P: (velocity, C matrix) per particle from cell-centred vc."""
    n = 2 * bound + 1
    coords = np.abs(np.arange(-bound, bound + 1))
    ok = coords <= wall
    within = jnp.asarray(ok[:, None, None] & ok[None, :, None]
                         & ok[None, None, :])
    table = _neighborhood_table(vc, within, n)          # (N^3, 27*4)
    rows = table[flat_s].reshape(-1, 27, 4)
    w27 = _stencil_w(pos_s, kernel)
    valid = jnp.all(jnp.abs(cround(pos_s)) <= bound, axis=-1)
    wm = jnp.where(valid[:, None], w27, 0.0) * rows[..., 3]

    base = cround(pos_s)
    offs = jnp.asarray(_OFFSETS, pos_s.dtype)
    d = (base[:, None, :] + offs[None]) - pos_s[:, None, :]

    den = jnp.sum(wm, axis=1)
    safe = jnp.where(den != 0, den, 1.0)
    vel = jnp.sum(wm[..., None] * rows[..., :3], axis=1) / safe[:, None]
    vel = jnp.where(den[:, None] != 0, vel, 0.0)

    # Centered weighted affine fit.  Canonical APIC (B D^{-1} uncentered)
    # assumes a partition-of-unity kernel where sum(w d) == 0; the
    # reference's compressed kernel is not one, so the uncentered moments
    # leak a spurious C even for constant fields, and a particle sitting on
    # a cell centre has a rank-deficient D.  Centering fixes both; a small
    # ridge keeps near-degenerate stencils at C ~ 0.
    dbar = jnp.sum(wm[..., None] * d, axis=1) / safe[:, None]
    vw = rows[..., :3] * wm[..., None]                   # (P,27,3)
    b = (_outer_sum27(vw, d) / safe[:, None, None]
         - vel[:, :, None] * dbar[:, None, :])
    dw = d * wm[..., None]
    dmat = (_outer_sum27(dw, d) / safe[:, None, None]
            - dbar[:, :, None] * dbar[:, None, :])
    eye = jnp.eye(3, dtype=pos_s.dtype)
    dreg = dmat + 1e-3 * eye
    # closed-form inverse via adjugate/det (dreg is SPD 3x3): a batched
    # jnp.linalg.solve is an iterative library call per particle.
    from fluidsim_tpu.ops.svd3 import cofactor3, det3, mm3
    det = det3(dreg)
    inv = jnp.swapaxes(cofactor3(dreg), -1, -2) / det[..., None, None]
    c = mm3(b, inv)
    c = jnp.where(den[:, None, None] != 0, c, 0.0)
    return vel, c
