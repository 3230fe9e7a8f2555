"""Device profile of the main paths on one GPU: where XLA's plain path spends
the frame, and which MPM transfer schedule is fastest.

    python scripts/device_profile.py [--out chiprun_out/profile]

1. FLIP 129^3 / 2M (``mode="flip"``): a ``jax.profiler`` trace of a few
   steady frames, reduced to the costliest device operations.
2. MPM at the reference's 31^3 and at 127^3 / 474k: steady ms/frame of the
   two transfer schedules — the naive 27-point path and the sorted
   channel-fused ``ops.mpm_fast`` — then a trace of the faster one at
   127^3.

Every timing ends in ``jax.block_until_ready``; compilation is warmed up
before the window and reported apart.  Needs a GPU and fails without one.
Writes ``profile.json`` (and the raw traces) under ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import glob
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_op_table(xplane_path: str, frames: int, top: int = 10) -> dict:
    """Reduce a trace to per-frame device time by operation.

    Reads the device planes (``/device:GPU:*``) of an ``.xplane.pb``.  The
    ``XLA Ops`` line holds one event per executed HLO operation; where a
    trace has none, the stream lines (one event per kernel) are used.
    Returns the line totals, the ``top`` costliest operations with their
    per-frame milliseconds and share, and the busy share of the window
    (union of op intervals over the first-start to last-end span)."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    out = {"lines": {}, "top": [], "busy_share": None}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = {line.name: list(line.events) for line in plane.lines}
        for name, evs in lines.items():
            out["lines"][f"{plane.name} {name}"] = {
                "events": len(evs),
                "ms": sum(e.duration_ns for e in evs) / 1e6}
        ops = lines.get("XLA Ops") or [
            e for name, evs in lines.items() if name.startswith("Stream")
            for e in evs]
        if not ops:
            continue
        by_name = collections.defaultdict(lambda: [0.0, 0])
        for e in ops:
            by_name[e.name][0] += e.duration_ns
            by_name[e.name][1] += 1
        total = sum(v[0] for v in by_name.values())
        rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
        out["top"] = [{"op": k, "ms_per_frame": v[0] / 1e6 / frames,
                       "calls_per_frame": v[1] / frames,
                       "share": v[0] / total} for k, v in rows]
        out["op_ms_per_frame"] = total / 1e6 / frames
        spans = sorted((e.start_ns, e.start_ns + e.duration_ns) for e in ops)
        busy, cur_s, cur_e = 0.0, *spans[0]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        out["busy_share"] = busy / (spans[-1][1] - spans[0][0])
        break
    return out


def timed_frames(sim, warmup: int, frames: int) -> dict:
    import jax

    t0 = time.perf_counter()
    for _ in range(warmup):
        sim.step()
    jax.block_until_ready(sim.state)
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(frames):
        sim.step()
    jax.block_until_ready(sim.state)
    return {"warmup_s_incl_compile": setup,
            "ms_per_frame": (time.perf_counter() - t0) / frames * 1e3}


def traced(sim, frames: int, trace_dir: str) -> dict:
    import jax

    with jax.profiler.trace(trace_dir):
        for _ in range(frames):
            sim.step()
        jax.block_until_ready(sim.state)
    path = max(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                         recursive=True), key=os.path.getmtime)
    return device_op_table(path, frames)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/profile")
    ap.add_argument("--frames", type=int, default=5)
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found '{dev.platform}'")
    from fluidsim_tpu.models.flip import FlipSim
    from fluidsim_tpu.models.mpm import MpmParams, MpmSim
    from fluidsim_tpu.scenes import get_scene
    from fluidsim_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    os.makedirs(args.out, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    rec = {"card": card.strip(), "device_kind": dev.device_kind,
           "jax": jax.__version__, "frames": args.frames}
    print(f"card: {rec['card']}", flush=True)

    sim = FlipSim(get_scene("water_cube_drop", bound=64, density=25.0))
    rec["flip_129"] = {"particles": sim.num_particles,
                       **timed_frames(sim, 3, args.frames)}
    rec["flip_129"]["trace"] = traced(sim, 3, os.path.join(args.out,
                                                           "flip_129"))
    print(json.dumps({"flip_129": rec["flip_129"]}, indent=1), flush=True)
    del sim
    gc.collect()

    for tag, bound in (("mpm_31", 15), ("mpm_127", 63)):
        scene = get_scene("mpm_cone", bound=bound)
        base = MpmParams(bound=scene.spec.bound, wall=scene.spec.wall)
        variants = {
            "naive": dataclasses.replace(base, fast_transfer=False),
            "mpm_fast": dataclasses.replace(base, fast_transfer=True),
        }
        rec[tag] = {}
        for name, params in variants.items():
            sim = MpmSim(scene, params=params)
            rec[tag][name] = {"particles": sim.num_particles,
                              **timed_frames(sim, 2, args.frames)}
            print(tag, name, rec[tag][name], flush=True)
            del sim
            gc.collect()
    best = min(rec["mpm_127"], key=lambda k: rec["mpm_127"][k]["ms_per_frame"])
    sim = MpmSim(scene, params=variants[best])
    timed_frames(sim, 2, 1)
    rec["mpm_127_trace"] = {"variant": best,
                            **traced(sim, 3, os.path.join(args.out,
                                                          "mpm_127"))}
    print(json.dumps({"mpm_31": rec["mpm_31"], "mpm_127": rec["mpm_127"],
                      "mpm_127_trace": rec["mpm_127_trace"]}, indent=1),
          flush=True)
    with open(os.path.join(args.out, "profile.json"), "w") as f:
        json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
