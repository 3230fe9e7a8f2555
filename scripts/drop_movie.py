"""Render the 500-frame water-cube-drop as an animated GIF —
the framework's equivalent of the reference's showcased
``water_cube_drop*.mp4`` videos (same scene: 121^3 box, 10 ppv seed cube,
``fluid.cc:1176,1348-1357``), with the parity-sheet camera.

Usage:  python -m scripts.drop_movie [--frames 500] [--every 4]
Needs a GPU (reference scale, ~690k particles).
"""

import argparse
import os
import sys

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="docs/images/water_cube_drop.gif")
    ap.add_argument("--bound", type=int, default=60)
    ap.add_argument("--density", type=float, default=10.0)
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--every", type=int, default=4)
    args = ap.parse_args()

    from fluidsim_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    from fluidsim_tpu.models.flip import FlipSim
    from fluidsim_tpu.scenes import get_scene
    from scripts.parity_renders import render_frame

    sim = FlipSim(get_scene("water_cube_drop", bound=args.bound,
                            density=args.density))
    print(f"# {sim.num_particles} particles", file=sys.stderr)

    imgs = [render_frame(np.asarray(sim.state.pos), args.bound)]
    for f in range(1, args.frames + 1):
        sim.step()
        if f % args.every == 0:
            imgs.append(render_frame(np.asarray(sim.state.pos), args.bound))
            if f % 100 == 0:
                print(f"frame {f}: {len(imgs)} rendered", file=sys.stderr)

    from PIL import Image
    frames = [Image.fromarray(im).convert("P", palette=Image.ADAPTIVE)
              for im in imgs]
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    frames[0].save(args.out, save_all=True, append_images=frames[1:],
                   duration=40, loop=0)
    print(f"wrote {args.out} ({len(frames)} frames)", file=sys.stderr)


if __name__ == "__main__":
    main()
