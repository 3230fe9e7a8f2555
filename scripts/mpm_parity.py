"""Cross-implementation MPM parity: JAX solver vs native/ref_mpm.cc.

Seeds the headline mpm_cone scene once, dumps the exact particle set to a
f32 file for the C++ oracle, runs both for N frames, and compares the
per-frame kinetic-energy traces (the same protocol as the FLIP parity run,
docs/parity_full_121cube.json).

Usage:  python scripts/mpm_parity.py [frames] [out.json]
        (run ref_mpm separately or let this script invoke it)
"""

import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FRAMES = int(sys.argv[1]) if len(sys.argv) > 1 else 60
OUT = sys.argv[2] if len(sys.argv) > 2 else "docs/mpm_parity_cone.json"
POS_FILE = "/tmp/mpm_cone_pos.f32"


def main():
    if os.environ.get("FLUIDSIM_CPU"):
        import jax
        jax.config.update("jax_platforms", "cpu")
    from fluidsim_tpu.models.mpm import MpmSim

    sim = MpmSim("mpm_cone")
    pos0 = np.asarray(sim.state.pos, np.float32)
    pos0.tofile(POS_FILE)
    print(f"seeded {pos0.shape[0]} particles -> {POS_FILE}", flush=True)

    # C++ oracle (f64 accumulation, independent numerics); rebuild on demand
    # so a stale/absent binary can't silently drift from ref_mpm.cc.
    native = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native")
    subprocess.check_call(["make", "-C", native, "ref_mpm"])
    ref_bin = os.path.join(native, "ref_mpm")
    proc = subprocess.Popen([ref_bin, "15", "400", str(FRAMES), POS_FILE],
                            stdout=subprocess.PIPE, text=True)

    jax_ke, jax_dt = [], []
    for f in range(FRAMES):
        m = sim.step()
        jax_ke.append(float(m["kinetic_energy"]))
        jax_dt.append(float(m["dt"]))
        if f % 10 == 0:
            print(f"jax frame {f}: ke={jax_ke[-1]:.6e} dt={jax_dt[-1]:.6f}",
                  flush=True)

    ref_lines = [json.loads(l) for l in proc.stdout if l.strip().startswith("{")]
    proc.wait()
    assert proc.returncode == 0, "ref_mpm failed"
    ref_ke = [r["ke"] for r in ref_lines][:FRAMES]
    ref_dt = [r["dt"] for r in ref_lines][:FRAMES]

    n = min(len(jax_ke), len(ref_ke))
    jk, rk = np.array(jax_ke[:n]), np.array(ref_ke[:n])
    rel = np.abs(jk - rk) / np.maximum(np.abs(rk), 1e-30)
    corr = float(np.corrcoef(jk, rk)[0, 1])
    report = {
        "scene": "mpm_cone", "particles": int(pos0.shape[0]), "frames": n,
        "median_rel_ke_err": float(np.median(rel)),
        "max_rel_ke_err": float(np.max(rel)),
        "p90_rel_ke_err": float(np.percentile(rel, 90)),
        "ke_correlation": corr,
        "jax_ke": jax_ke[:n], "ref_ke": ref_ke[:n],
        "jax_dt": jax_dt[:n], "ref_dt": ref_dt[:n],
    }
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(report, f, indent=1)
    print(f"median rel KE err: {report['median_rel_ke_err']:.3e}  "
          f"max: {report['max_rel_ke_err']:.3e}  corr: {corr:.7f}")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
