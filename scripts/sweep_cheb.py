"""Sweep the Chebyshev preconditioner degree/ratio on the headline config.

Usage: python -m scripts.sweep_cheb [--bound 64] [--density 25] [--frames 20]
"""

import argparse
import dataclasses
import time

import jax


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bound", type=int, default=64)
    ap.add_argument("--density", type=float, default=25.0)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=6)
    args = ap.parse_args()

    from fluidsim_tpu.models.flip import FlipSim
    from fluidsim_tpu.scenes import get_scene

    scene = get_scene("water_cube_drop", bound=args.bound,
                      density=args.density)
    base = FlipSim(scene).params
    for degree, ratio in ((3, 30.0), (5, 30.0), (7, 30.0), (5, 60.0),
                          (2, 30.0)):
        sim = FlipSim(scene, params=dataclasses.replace(
            base, cheb_degree=degree, cheb_ratio=ratio))
        # scan path (steps(k) = ONE dispatch for k frames): amortizes the
        # per-frame host dispatch like production runs do
        jax.block_until_ready(sim.steps(args.warmup))
        t0 = time.perf_counter()
        m = jax.block_until_ready(sim.steps(args.frames))
        dt = (time.perf_counter() - t0) / args.frames
        m = {k: v[-1] for k, v in m.items()}
        print(f"degree {degree} ratio {ratio:5.1f}  {dt*1e3:7.1f} ms/frame "
              f"({1.0/dt:5.2f} steps/s)  cg_iters {float(m['cg_iters']):.0f}",
              flush=True)


if __name__ == "__main__":
    main()
