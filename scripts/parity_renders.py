"""Qualitative parity artifact: render the water-cube-drop at the
reference's showcased frames (0/1/30/55 — ``screenshots/grid*_*.png``) with
a matching 3/4 elevated camera, and compose a side-by-side sheet
(reference row on top, framework row below) at ``docs/images/parity_sheet.png``.

The reference's screenshots are offline renders of its ``.vdb`` outputs
(external renderer, front-right elevated camera looking at the box).  We
reproduce the VIEW, not the shading: same scene (121^3 box, 10 ppv seed
cube, mt19937(0) bit-compatible seeding — ``compat/scatter.py``), same
frame indices, sphere-traced particle level set.

Usage:  python -m scripts.parity_renders [--out docs/images]
Needs a GPU (reference scale, ~690k particles).
"""

import argparse
import os
import sys

import numpy as np

FRAMES = (0, 1, 30, 55)
REF_IMAGES = {0: "grid2_0.png", 1: "grid1_1.png", 30: "grid2_30.png",
              55: "grid2_55.png"}
REF_DIR = "/root/reference/screenshots"


def render_frame(pos, bound, res=(480, 270)):
    import jax
    import jax.numpy as jnp
    from fluidsim_tpu.ops.levelset import particles_to_levelset
    from fluidsim_tpu.ops.raytrace import raytrace_levelset

    sdf = particles_to_levelset(jnp.asarray(pos), bound, radius=1.3)
    # front-right elevated 3/4 view toward the box centre, like the
    # reference's screenshots (fluid sits around y ~ -20 after settling)
    eye = (1.5 * bound, 1.1 * bound, -2.0 * bound)
    look = (0.0, -0.45 * bound, 0.0)
    img, _, _ = raytrace_levelset(sdf, bound, eye, look,
                                  width=res[0], height=res[1], fov_deg=36.0)
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255).astype(np.uint8)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="docs/images")
    ap.add_argument("--bound", type=int, default=60)
    ap.add_argument("--density", type=float, default=10.0)
    args = ap.parse_args()

    from fluidsim_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    from fluidsim_tpu.io.render import write_png
    from fluidsim_tpu.models.flip import FlipSim
    from fluidsim_tpu.scenes import get_scene

    os.makedirs(args.out, exist_ok=True)
    sim = FlipSim(get_scene("water_cube_drop", bound=args.bound,
                            density=args.density))
    print(f"# {sim.num_particles} particles", file=sys.stderr)

    ours = {}
    frame = 0
    for target in FRAMES:
        while frame < target:
            sim.step()
            frame += 1
        img = render_frame(np.asarray(sim.state.pos), args.bound)
        path = os.path.join(args.out, f"parity_f{target}.png")
        write_png(path, img)
        ours[target] = img
        print(f"frame {target}: {path}", file=sys.stderr)

    # side-by-side sheet: top = reference screenshot, bottom = ours
    try:
        from PIL import Image
    except ImportError:
        print("PIL unavailable; per-frame PNGs written, no sheet",
              file=sys.stderr)
        return
    cols = []
    for target in FRAMES:
        ref = Image.open(os.path.join(REF_DIR, REF_IMAGES[target]))
        ref = ref.convert("RGB").resize((480, 270))
        mine = Image.fromarray(ours[target].astype(np.uint8)).convert("RGB")
        col = Image.new("RGB", (480, 540 + 24), "white")
        col.paste(ref, (0, 0))
        col.paste(mine, (0, 270 + 24))
        cols.append(col)
    sheet = Image.new("RGB", (480 * len(cols) + 8 * (len(cols) - 1),
                              540 + 24), "white")
    for i, col in enumerate(cols):
        sheet.paste(col, (i * 488, 0))
    out = os.path.join(args.out, "parity_sheet.png")
    sheet.save(out)
    print(f"sheet: {out} (top row = reference screenshots frames "
          f"{FRAMES}, bottom row = framework renders)", file=sys.stderr)


if __name__ == "__main__":
    main()
