"""500-frame full-reference-scale soak on the current backend: runs the
bit-compat-seeded water-cube drop (121^3, 689,210 particles) end to end
and compares the per-frame kinetic-energy trace against the recorded run
(``docs/ke_trace_500frames.json``).

Trajectory-level oracle: early (pre-chaos) frames must track tightly;
later frames are chaotic, so the check is that KE stays finite, bounded by
the recorded envelope, and settles in the same regime.

Usage: python scripts/soak_500.py [--frames 500] [--update]
"""

import argparse
import json
import os
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE = os.path.join(HERE, "docs", "ke_trace_500frames.json")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--update", action="store_true",
                    help="rewrite the recorded trace from this run")
    args = ap.parse_args()

    from fluidsim_tpu.models.flip import FlipSim
    from fluidsim_tpu.compat.scatter import seed_particles_compat

    sim = FlipSim("water_cube_drop", seeder=seed_particles_compat)
    print(f"# {sim.num_particles} particles")

    t0 = time.time()
    kes, dts, errs, outers = [], [], [], []
    for f in range(args.frames):
        m = sim.step()
        kes.append(m["kinetic_energy"])      # device arrays; fetch later
        dts.append(m["dt"])
        errs.append(m["error"])
        outers.append(m["outer_iters"])
        if f == 0:
            print(f"# first frame (incl. compile): {time.time()-t0:.1f}s")
    ke = np.asarray([float(k) for k in kes])
    dt = np.asarray([float(d) for d in dts])
    err = np.asarray([float(e) for e in errs])
    wall = time.time() - t0
    print(f"# {args.frames} frames in {wall:.1f}s "
          f"({args.frames/wall:.2f} steps/s incl. compile)")

    assert np.isfinite(ke).all(), "non-finite kinetic energy"
    pos = np.asarray(sim.state.pos)
    assert np.isfinite(pos).all() and np.abs(pos).max() <= sim.params.bound, \
        "particles escaped the box"
    assert (err[1:] <= 0.101).all(), "projection error above tolerance"

    if os.path.exists(TRACE) and not args.update:
        ref = json.load(open(TRACE))
        ref_ke = np.asarray([r["ke"] for r in ref])[:args.frames]
        n = min(len(ref_ke), len(ke))
        early = slice(1, min(15, n))
        rel = np.abs(ke[early] - ref_ke[early]) / np.abs(ref_ke[early])
        print(f"# early-frame KE rel err max: {rel.max():.3e}")
        assert rel.max() < 1e-2, "early trajectory diverged from record"
        # chaotic tail: same energy regime (order of magnitude)
        tail = slice(max(0, n - 100), n)
        print(f"# tail KE: run {ke[tail].mean():.3e}  ref {ref_ke[tail].mean():.3e}")
        assert 0.1 < ke[tail].mean() / ref_ke[tail].mean() < 10.0
        print("SOAK OK (trace matches recorded run)")
    if args.update or not os.path.exists(TRACE):
        rows = [{"frame": i, "ke": float(ke[i]), "dt": float(dt[i]),
                 "err": float(err[i]), "outer": int(outers[i])}
                for i in range(len(ke))]
        json.dump(rows, open(TRACE, "w"))
        print(f"wrote {TRACE}")


if __name__ == "__main__":
    main()
