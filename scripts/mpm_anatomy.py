"""127^3 MPM frame anatomy: per-frame CG iterations,
dt, KE and wall time across fall / impact / settle, so the impact-phase
engineering (preconditioning, warm starts, tolerance schedule) is driven
by a measured profile instead of the bench-vs-soak discrepancy.

Writes mpm_anatomy_127.json: per-frame rows + phase summary.

Usage: python scripts/mpm_anatomy.py [--bound 63] [--frames 500]
       [--out mpm_anatomy_127.json] [--precond jacobi|none]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bound", type=int, default=63)
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--chunk", type=int, default=10,
                    help="frames per device dispatch (wall per chunk)")
    ap.add_argument("--out", default="mpm_anatomy_127.json")
    ap.add_argument("--precond", default=None, choices=[None, "none",
                                                        "jacobi"],
                    help="override MpmParams.precond")
    args = ap.parse_args()

    from fluidsim_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    from fluidsim_tpu.models.mpm import MpmSim, MpmParams

    kw = {}
    sim = MpmSim("mpm_cone", bound=args.bound, **kw)
    if args.precond:
        import dataclasses
        sim = MpmSim("mpm_cone", bound=args.bound,
                     params=dataclasses.replace(sim.params,
                                                precond=args.precond))
    print(f"# {sim.num_particles} particles, bound {args.bound}, "
          f"precond={getattr(sim.params, 'precond', 'n/a')}", file=sys.stderr)

    rows = []
    t0 = time.time()
    first = None
    done = 0
    while done < args.frames:
        k = min(args.chunk, args.frames - done)
        tc = time.time()
        m = sim.steps(k)
        ke = np.asarray(m["kinetic_energy"], np.float64)
        _ = float(ke[-1])                       # force host fetch (sync)
        wall = time.time() - tc
        if first is None:
            first = wall
            print(f"# first chunk incl. compile: {wall:.1f}s", file=sys.stderr)
        iters = np.asarray(m["cg_iters"])
        dts = np.asarray(m["dt"])
        for i in range(k):
            rows.append({"frame": done + i, "cg_iters": int(iters[i]),
                         "dt": float(dts[i]), "ke": float(ke[i]),
                         "chunk_wall": wall / k})
        done += k
    total = time.time() - t0
    print(f"# {args.frames} frames in {total:.1f}s "
          f"({args.frames/total:.2f} steps/s incl. compile)", file=sys.stderr)

    it = np.array([r["cg_iters"] for r in rows])
    w = np.array([r["chunk_wall"] for r in rows])
    # phases by frame index: fall (cone drops at v=-50), impact (iteration
    # spike), settle (tail)
    spike = int(np.argmax(it))
    phases = {"spike_frame": spike, "spike_iters": int(it[spike]),
              "total_secs": total, "iters_total": int(it.sum())}
    for name, sl in (("fall_0_99", slice(0, 100)),
                     ("impact_100_299", slice(100, 300)),
                     ("settle_300_end", slice(300, None))):
        if len(it[sl]):
            phases[name] = {"iters_mean": float(it[sl].mean()),
                            "iters_max": int(it[sl].max()),
                            "wall_mean_ms": 1000 * float(w[sl].mean())}
    out = {"rows": rows, "phases": phases,
           "particles": sim.num_particles, "bound": args.bound,
           "precond": getattr(sim.params, "precond", None)}
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(json.dumps(phases, indent=1))


if __name__ == "__main__":
    main()
