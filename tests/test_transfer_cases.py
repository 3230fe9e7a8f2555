"""Shape and placement cases of the XLA transfer schedules against their
naive oracles: odd particle counts, particles on the walls and on rounding
ties, particles beside an interior solid, mostly-empty grids and parked
(dead) slots.  FLIP (``ops.transfer_fast``), APIC (``ops.apic``) and MPM
(``ops.mpm_fast``) each against the plain formulation they replace."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fluidsim_tpu.core.gridspec import GridSpec, cell_center_velocity
from fluidsim_tpu.core.splines import cround
from fluidsim_tpu.ops import apic, transfer, transfer_fast as tf
from fluidsim_tpu.scenes import _box_mask

B, WALL = 9, 7
CASES = ["one", "seven", "odd_1001", "on_walls", "rounding_ties",
         "beside_solid", "mostly_empty", "parked_slots"]


def _case(name, seed=0):
    """(solid, pos, vel) for one placement case on a (2B+1)^3 grid."""
    spec = GridSpec(bound=B, wall=WALL)
    solid = spec.wall_mask()
    rng = np.random.default_rng(seed)
    lo, hi = -WALL + 0.2, WALL - 0.2
    if name == "one":
        pos = np.asarray([[0.3, -1.7, 2.2]])
    elif name == "seven":
        pos = rng.uniform(lo, hi, size=(7, 3))
    elif name == "odd_1001":
        pos = rng.uniform(lo, hi, size=(1001, 3))
    elif name == "on_walls":
        # every coordinate on a wall plane or one cell inside it
        pos = rng.choice([-WALL, -WALL + 1, WALL - 1, WALL],
                         size=(301, 3)).astype(float)
        pos += rng.uniform(-0.05, 0.05, size=pos.shape) * (np.abs(pos) < WALL)
    elif name == "rounding_ties":
        pos = rng.integers(-WALL + 1, WALL - 1, size=(257, 3)) + 0.5
    elif name == "beside_solid":
        solid = solid | _box_mask(spec, (-2, -2, -2), (2, 2, 2))
        face = rng.uniform(-2.4, 2.4, size=(400, 3))
        axis = rng.integers(0, 3, size=400)
        face[np.arange(400), axis] = rng.choice([-3.0, 3.0], size=400)
        pos = face
    elif name == "mostly_empty":
        pos = rng.normal(loc=(2.0, -3.0, 1.0), scale=0.4, size=(500, 3))
    elif name == "parked_slots":
        pos = rng.uniform(lo, hi, size=(600, 3))
        pos[::3] = 1.0e6
    else:
        raise ValueError(name)
    vel = rng.normal(size=pos.shape)
    return (jnp.asarray(solid), jnp.asarray(pos, jnp.float32),
            jnp.asarray(vel, jnp.float32))


@pytest.mark.parametrize("case", CASES)
def test_flip_p2g_fused_matches_naive(case):
    solid, pos, vel = _case(case)
    w_ref, mom_ref = transfer.p2g_velocity(pos, vel, solid, B)
    occ_ref = transfer.p2g_mass(pos, solid, B)
    pos_s, vel_s, flat = tf.sort_by_cell(pos, vel, B)
    w, mom, occ = tf.p2g_fused(pos_s, vel_s, flat, solid, B)
    for got, ref in ((w, w_ref), (mom, mom_ref), (occ, occ_ref)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_flip_g2p_fused_matches_naive(case):
    solid, pos, vel = _case(case, seed=1)
    rng = np.random.default_rng(2)
    vc_old = jnp.asarray(rng.normal(size=(2 * B + 1,) * 3 + (3,)),
                         jnp.float32)
    vc_new = vc_old * 1.3 + 0.2
    pos_s, _, flat = tf.sort_by_cell(pos, vel, B)
    np.testing.assert_allclose(
        np.asarray(tf.g2p_fused(pos_s, flat, vc_new - vc_old, B, WALL)),
        np.asarray(transfer.g2p_flip_delta(pos_s, vc_new, vc_old, B, WALL)),
        rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(tf.g2p_fused(pos_s, flat, vc_new, B, WALL)),
        np.asarray(transfer.g2p_gather(pos_s, vc_new, B, WALL)),
        rtol=1e-3, atol=1e-5)


def _offsets_and_weights(pos):
    """Naive stencil: (P,27,3) cells, in-box mask, weights, offsets d."""
    cells, inb = transfer.particle_stencil(pos, B)
    w = np.asarray(transfer.stencil_weights(pos, cells, "flip"), np.float64)
    cells = np.asarray(cells)
    valid = np.all(np.abs(np.asarray(cround(pos))) <= B, axis=-1)
    w = np.where(np.asarray(inb) & valid[:, None], w, 0.0)
    d = cells - np.asarray(pos, np.float64)[:, None, :]
    return cells, w, d


def _apic_p2g_oracle(pos, vel, aff, solid):
    n = 2 * B + 1
    cells, w, d = _offsets_and_weights(pos)
    v_aug = (np.asarray(vel, np.float64)[:, None, :]
             + np.einsum("pij,pkj->pki", np.asarray(aff, np.float64), d))
    acc = np.zeros((n, n, n, 4))
    idx = np.clip(cells + B, 0, n - 1).reshape(-1, 3)
    vals = np.concatenate([w[..., None], w[..., None] * v_aug], -1)
    np.add.at(acc, (idx[:, 0], idx[:, 1], idx[:, 2]), vals.reshape(-1, 4))
    coords = np.abs(np.arange(-B, B + 1)) <= B - 2
    inner = coords[:, None, None] & coords[None, :, None] & coords[None, None]
    mask = inner & ~np.asarray(solid)
    return (np.where(mask, acc[..., 0], 0.0),
            np.where(mask[..., None], acc[..., 1:], 0.0),
            np.where(~np.asarray(solid), acc[..., 0], 0.0))


def _apic_g2p_oracle(pos, vc):
    n = 2 * B + 1
    cells, w, d = _offsets_and_weights(pos)
    coords = np.abs(np.arange(-B, B + 1)) <= WALL
    within = coords[:, None, None] & coords[None, :, None] & coords[None, None]
    inb = np.all(np.abs(cells) <= B, axis=-1)
    idx = np.clip(cells + B, 0, n - 1)
    ok = within[idx[..., 0], idx[..., 1], idx[..., 2]] & inb
    wm = np.where(ok, w, 0.0)
    v_at = np.asarray(vc, np.float64)[idx[..., 0], idx[..., 1], idx[..., 2]]
    den = wm.sum(1)
    safe = np.where(den != 0, den, 1.0)
    vel = np.where(den[:, None] != 0,
                   (wm[..., None] * v_at).sum(1) / safe[:, None], 0.0)
    dbar = (wm[..., None] * d).sum(1) / safe[:, None]
    bmat = (np.einsum("pk,pki,pkj->pij", wm, v_at, d) / safe[:, None, None]
            - vel[:, :, None] * dbar[:, None, :])
    dmat = (np.einsum("pk,pki,pkj->pij", wm, d, d) / safe[:, None, None]
            - dbar[:, :, None] * dbar[:, None, :]) + 1e-3 * np.eye(3)
    c = bmat @ np.linalg.inv(dmat)
    return vel, np.where(den[:, None, None] != 0, c, 0.0)


@pytest.mark.parametrize("case", ["odd_1001", "on_walls", "beside_solid",
                                  "parked_slots"])
def test_apic_p2g_matches_oracle(case):
    solid, pos, vel = _case(case, seed=3)
    rng = np.random.default_rng(4)
    aff = jnp.asarray(0.3 * rng.normal(size=(pos.shape[0], 3, 3)),
                      jnp.float32)
    pos_s, vel_s, flat, aff_s = tf.sort_by_cell(pos, vel, B,
                                                extra=aff.reshape(-1, 9))
    aff_s = aff_s.reshape(-1, 3, 3)
    got = apic.p2g_apic(pos_s, vel_s, aff_s, flat, solid, B)
    ref = _apic_p2g_oracle(pos_s, vel_s, aff_s, solid)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g), r, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["odd_1001", "on_walls", "rounding_ties",
                                  "parked_slots"])
def test_apic_g2p_moments_match_oracle(case):
    """Velocity and the centred affine moment matrix C = B D^-1."""
    solid, pos, vel = _case(case, seed=5)
    rng = np.random.default_rng(6)
    vc = jnp.asarray(rng.normal(size=(2 * B + 1,) * 3 + (3,)), jnp.float32)
    pos_s, _, flat = tf.sort_by_cell(pos, vel, B)
    v, c = apic.g2p_apic(pos_s, flat, vc, B, WALL)
    v_ref, c_ref = _apic_g2p_oracle(pos_s, vc)
    np.testing.assert_allclose(np.asarray(v), v_ref, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(c), c_ref, rtol=2e-3, atol=2e-3)


def _mpm_state(bound=12, frames=2):
    """A deformed, sorted MPM cone state and its stencil data."""
    from fluidsim_tpu.models.mpm import MpmParams, MpmSim
    from fluidsim_tpu.ops import mpm_fast as mf

    sim = MpmSim("mpm_cone", bound=bound, density=40.0,
                 params=MpmParams(bound=bound, wall=bound - 2,
                                  fast_transfer=False))
    for _ in range(frames):
        sim.step()
    st = sim.state
    rng = np.random.default_rng(7)
    fe = st.FE + jnp.asarray(0.04 * rng.normal(size=st.FE.shape), jnp.float32)
    pos, vel, fe, fp, vol, flat = mf.sort_mpm(st.pos, st.vel, fe, st.FP,
                                              st.volume, bound)
    return sim, pos, fe, fp, vol, flat


@pytest.mark.parametrize("hessian", ["full", "spd", "hybrid"])
def test_mpm_force_and_hvp_fused_match_naive(hessian):
    """The explicit force and the jvp Hessian-vector product of the fused
    force function equal the naive scatter's (``models.mpm``)."""
    from fluidsim_tpu.models.mpm import _particle_nodes, make_force_fn
    from fluidsim_tpu.ops import mpm_fast as mf
    from fluidsim_tpu.ops.svd3 import det3, hardening

    sim, pos, fe, fp, vol, flat = _mpm_state()
    p, solid = sim.params, sim.solid
    bound, n = p.bound, 2 * p.bound + 1
    n3 = n ** 3
    mass = transfer.p2g_mass(pos, solid, bound, "mpm")
    active = (mass > p.mass_threshold) & ~solid
    mu, lam = hardening(p.mu0, p.lam0, p.hardening_eps, det3(fp))

    ids, inb, not_solid, _, gradw = _particle_nodes(pos, solid, bound)
    naive = make_force_fn(ids, active.reshape(-1)[ids] & inb, not_solid,
                          gradw, fe, vol, mu, lam, n3, hessian=hessian)
    _, gradw_f = mf.stencil_mpm(pos)
    valid = jnp.all(jnp.abs(jnp.round(pos)) <= bound, axis=-1)
    fused = mf.make_force_fn_fused(pos, flat, gradw_f,
                                   valid[:, None].astype(pos.dtype), fe, vol,
                                   mu, lam, active, solid, bound,
                                   hessian=hessian)
    pairs = zip(naive, fused) if hessian == "hybrid" else [(naive, fused)]
    rng = np.random.default_rng(8)
    w = jnp.where(active[..., None],
                  jnp.asarray(rng.normal(size=(n, n, n, 3)), jnp.float32), 0)
    for f_naive, f_fused in pairs:
        z_flat, z = jnp.zeros((n3, 3)), jnp.zeros((n, n, n, 3))
        f0_n = f_naive(z_flat).reshape(n, n, n, 3)
        f0_f = f_fused(z)
        scale = float(jnp.abs(f0_n).max())
        np.testing.assert_allclose(np.asarray(f0_f), np.asarray(f0_n),
                                   atol=1e-4 * scale, rtol=1e-3)
        _, d_n = jax.jvp(f_naive, (z_flat,), (w.reshape(n3, 3),))
        _, d_f = jax.jvp(f_fused, (z,), (w,))
        scale = float(jnp.abs(d_n).max())
        np.testing.assert_allclose(np.asarray(d_f),
                                   np.asarray(d_n).reshape(n, n, n, 3),
                                   atol=1e-4 * scale, rtol=1e-3)


def test_mpm_gradv_and_flip_delta_fused_match_naive():
    from fluidsim_tpu.models.mpm import _particle_nodes
    from fluidsim_tpu.ops import mpm_fast as mf
    from fluidsim_tpu.ops.smallmat import outer_sum27

    sim, pos, _, _, _, flat = _mpm_state(frames=1)
    p, solid = sim.params, sim.solid
    n = 2 * p.bound + 1
    rng = np.random.default_rng(9)
    velg = jnp.asarray(rng.normal(size=(n, n, n, 3)), jnp.float32)
    ids, _, not_solid, _, gradw = _particle_nodes(pos, solid, p.bound)
    v_nodes = velg.reshape(-1, 3)[ids] * not_solid[..., None]
    _, gradw_f = mf.stencil_mpm(pos)
    np.testing.assert_allclose(
        np.asarray(mf.g2p_gradv(velg, flat, gradw_f, solid, p.bound)),
        np.asarray(outer_sum27(v_nodes, gradw)), rtol=1e-3, atol=1e-4)
    vc_old = cell_center_velocity(velg)
    vc_new = vc_old * 0.7 - 0.1
    np.testing.assert_allclose(
        np.asarray(mf.g2p_flip_mpm(pos, flat, vc_new - vc_old, p.bound,
                                   p.wall)),
        np.asarray(transfer.g2p_flip_delta(pos, vc_new, vc_old, p.bound,
                                           p.wall, "mpm")),
        rtol=1e-3, atol=1e-5)
