"""Field-level SPD-vs-full-Hessian trajectory deviation.

``hessian="spd"`` (the Gauss-Newton operator that fixed the 127^3 impact
stall) changes the implicit integrator for every scaled MPM scene, and a
single scalar (KE) bounds the deviation only loosely.  This script
runs the SAME scene with ``hessian="full"`` (the reference's exact
operator, ``deformHeader.h:241-272``) and ``hessian="spd"`` and compares
field-level observables at checkpoints:

* particle position RMS / max deviation (same seeding => same indexing),
* occupancy-grid IoU + voxel-set Hausdorff distance (cells),
* det(F_P) distribution quantiles (plasticity state),
* kinetic energy.

Writes docs/mpm_deviation.json for the validation doc.

Usage: python scripts/mpm_deviation.py [--bound 63] [--frames 500]
           [--checkpoints 60,114,200,350,500]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from fluidsim_tpu.utils.cache import enable_compilation_cache

enable_compilation_cache()


def run_variant(hessian, bound, frames, checkpoints, chunk=10):
    import dataclasses
    from fluidsim_tpu.models.mpm import MpmSim, MpmParams
    from fluidsim_tpu.scenes import get_scene

    scene = get_scene("mpm_cone", bound=bound)
    params = MpmParams(bound=bound, wall=scene.spec.wall,
                       dx=scene.spec.dx, gravity=tuple(scene.gravity),
                       hessian=hessian)
    sim = MpmSim(scene, params=params)
    snaps = {}
    done = 0
    for cp in checkpoints:
        while done < cp:
            k = min(chunk, cp - done)
            m = sim.steps(k)
            done += k
        ke = float(np.asarray(m["kinetic_energy"][-1]))
        pos = np.asarray(sim.state.pos)
        detfp = np.linalg.det(np.asarray(sim.state.FP))
        snaps[cp] = {"pos": pos, "detfp": detfp, "ke": ke}
        print(f"# {hessian} frame {cp}: ke={ke:.4g}", file=sys.stderr,
              flush=True)
    return sim, snaps


def occupancy(pos, bound):
    base = np.clip(np.floor(np.abs(pos) + 0.5).astype(int)
                   * np.sign(pos).astype(int) + bound, 0, 2 * bound)
    occ = np.zeros((2 * bound + 1,) * 3, bool)
    occ[base[:, 0], base[:, 1], base[:, 2]] = True
    return occ


def voxel_hausdorff(a_occ, b_occ):
    """Symmetric Hausdorff distance between occupied-voxel sets (cells)."""
    from scipy.spatial import cKDTree
    pa = np.argwhere(a_occ)
    pb = np.argwhere(b_occ)
    if not len(pa) or not len(pb):
        return float("inf")
    da = cKDTree(pb).query(pa)[0].max()
    db = cKDTree(pa).query(pb)[0].max()
    return float(max(da, db))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bound", type=int, default=63)
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--checkpoints", default="60,114,200,350,500")
    ap.add_argument("--json", default=os.path.join(
        os.path.dirname(__file__), "..", "docs", "mpm_deviation.json"))
    args = ap.parse_args()
    cps = [int(x) for x in args.checkpoints.split(",")
           if int(x) <= args.frames]

    sim_f, full = run_variant("full", args.bound, args.frames, cps)
    sim_s, spd = run_variant("spd", args.bound, args.frames, cps)

    n = 2 * args.bound + 1
    rows = []
    qs = [0.01, 0.25, 0.5, 0.75, 0.99]
    for cp in cps:
        f, s = full[cp], spd[cp]
        d = np.linalg.norm(f["pos"] - s["pos"], axis=1)
        of = occupancy(f["pos"], args.bound)
        os_ = occupancy(s["pos"], args.bound)
        inter = (of & os_).sum()
        union = (of | os_).sum()
        rows.append({
            "frame": cp,
            "pos_rms_cells": float(np.sqrt((d ** 2).mean())),
            "pos_max_cells": float(d.max()),
            "pos_median_cells": float(np.median(d)),
            "occupancy_iou": float(inter / union),
            "voxel_hausdorff_cells": voxel_hausdorff(of, os_),
            "detfp_quantiles_full": [float(x) for x in
                                     np.quantile(f["detfp"], qs)],
            "detfp_quantiles_spd": [float(x) for x in
                                    np.quantile(s["detfp"], qs)],
            "ke_full": f["ke"], "ke_spd": s["ke"],
            "ke_rel": float(s["ke"] / f["ke"]) if f["ke"] else None,
        })
        print(json.dumps(rows[-1]), flush=True)

    out = {"grid": n, "particles": sim_f.num_particles,
           "scene": "mpm_cone", "quantiles": qs, "rows": rows}
    with open(args.json, "w") as fjs:
        json.dump(out, fjs, indent=1)
    print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
