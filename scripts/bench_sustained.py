"""Sustained-throughput measurement at bench scale.

The driver headline (``bench.py``) times frames 2-22 of the 129^3/2M
water-cube drop — early free fall, the cheapest regime (1 outer projection
pass, few CG iterations).  Production throughput is the *whole* 500-frame
run (the reference's actual workload, ``fluid.cc:1368``), whose post-impact
frames pay multiple outer passes.  This script publishes both sides in
identical windows:

  * device: one 500-frame run at 129^3/2M on the GPU, wall-clocked per
    segment (``jax.block_until_ready`` at the boundaries only):
    early = frames 2-22, post-impact = frames 50-70, full = frames 2-500.
  * CPU: the same windows extracted from the per-frame JSONL that
    ``native/ref_cpu <bound> <density> 500 --perframe=FILE`` writes
    (docs/ref_cpu_perframe_129.jsonl, a ~100-min single run, cached in
    git).  Each window also carries its own Amdahl bound (particle loops
    free, serial grid/CG unchanged — see BASELINE.md).

Writes the rows, with a like-for-like ``vs_baseline`` per window, to
``--out`` (default ``sustained_129.json``).

Usage:
  python scripts/bench_sustained.py            # device run + CPU windows
  python scripts/bench_sustained.py --cpu-only # re-derive CPU windows only
"""

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

PERFRAME = os.path.join(HERE, "docs", "ref_cpu_perframe_129.jsonl")

# (name, start_frame, end_frame) — half-open, frame indices in the run
WINDOWS = (("early", 2, 22), ("post_impact", 50, 70), ("full", 2, 500))


def cpu_windows():
    """Per-window steps/s + Amdahl bound from the ref_cpu per-frame trace."""
    if not os.path.exists(PERFRAME):
        return None
    rows = [json.loads(l) for l in open(PERFRAME) if l.strip()]
    if not rows:
        return None
    secs = np.array([r["secs"] for r in rows])
    psec = np.array([r["particle_secs"] for r in rows])
    out = {"frames_available": len(rows)}
    for name, a, b in WINDOWS:
        if len(rows) < b:
            continue
        w, p = secs[a:b], psec[a:b]
        total, part = w.sum(), p.sum()
        serial = (total - part) / len(w)
        out[name] = {
            "steps_per_sec": len(w) / total,
            "ms_per_frame": 1000.0 * total / len(w),
            "particle_fraction": part / total,
            "amdahl_bound_steps_per_sec": 1.0 / serial if serial > 0 else 0.0,
        }
    return out


def device_run(bound: int, density: float, frames: int, vdb_dir: str = None,
               accum: bool = False, kind: str = "flip",
               max_pending_bytes: int = 1 << 30):
    import jax

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("the device run needs a GPU (use --cpu-only)")
    from fluidsim_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    from fluidsim_tpu.scenes import get_scene

    if kind == "mpm":
        from fluidsim_tpu.models.mpm import MpmSim
        kw = {} if density is None else {"density": density}
        sim = MpmSim(get_scene("mpm_cone", bound=bound, **kw))
    else:
        from fluidsim_tpu.models.flip import FlipSim
        sim = FlipSim(get_scene("water_cube_drop", bound=bound,
                                density=density))
    print(f"# {kind} grid {2*bound+1}^3, {sim.num_particles} particles"
          + (f", vdb -> {vdb_dir}" if vdb_dir else ""), file=sys.stderr)

    # --vdb: pay the reference's per-frame I/O (fluid.cc:1503-1509 and
    # mpm.cc:1433-1434 write simulation/mygrids<i>.vdb every frame)
    # through the async writer the CLI uses (cli.py:90-125, io::Queue
    # analogue).  This inherently syncs the host once per frame (the
    # occupancy fetch), so the measured number is sustained throughput
    # WITH production I/O on.
    writer = None
    if vdb_dir:
        from fluidsim_tpu.io.export import AsyncFrameExporter
        os.makedirs(vdb_dir, exist_ok=True)
        writer = AsyncFrameExporter(sim.scene.spec, sim.scene.solid,
                                    mode=kind, accum=accum,
                                    max_pending_bytes=max_pending_bytes)

        def write_frame(frame, metrics):
            writer.submit(os.path.join(vdb_dir, f"mygrids{frame}.vdb"),
                          metrics["occupancy"])

    def writer_snap():
        if writer is None:
            return None
        return {"submit_block_secs": writer.submit_block_secs,
                "fetch_secs": writer.fetch_secs,
                "proc_secs": writer.proc_secs,
                "backpressure_secs": writer.backpressure_secs,
                "pending": writer.pending()}

    # segment boundaries: warmup ends at 2; then every window edge + end
    edges = sorted({2, frames} | {a for _, a, _ in WINDOWS}
                   | {b for _, _, b in WINDOWS})
    t0 = time.perf_counter()
    for _ in range(edges[0]):
        sim.step()
    jax.block_until_ready(sim.state)
    print(f"# warmup ({edges[0]} frames incl. compile): "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)

    # cumulative wall at each boundary, taken once the device has finished
    # the segment.
    # Per-frame solve-cost scalars (outer passes, CG iterations) are kept
    # as device handles and fetched after the run — the physics half of
    # the per-window physics-vs-I/O ledger.
    cum = {edges[0]: 0.0}
    snaps = {edges[0]: writer_snap()}
    solve_hist = []                     # (outer_iters, cg_iters) device pairs
    t0 = time.perf_counter()
    done = edges[0]
    for e in edges[1:]:
        for f in range(done, e):
            m = sim.step()
            solve_hist.append((m.get("outer_iters"), m.get("cg_iters")))
            if writer is not None:
                write_frame(f, m)
        jax.block_until_ready(sim.state)
        cum[e] = time.perf_counter() - t0
        snaps[e] = writer_snap()
        done = e
        print(f"# frame {e}: cumulative {cum[e]:.1f}s"
              + (f" (pending {snaps[e]['pending']})" if writer else ""),
              file=sys.stderr)
    if writer is not None:
        tq0 = time.time()
        writer.flush()
        drain_secs = time.time() - tq0
        if accum:
            from fluidsim_tpu.io.vdb import write_vdb
            write_vdb(os.path.join(vdb_dir, "mygrids.vdb"),
                      writer.accum_grids)
        writer.close()

    outer = np.array([float(np.asarray(o)) if o is not None else 0.0
                      for o, _ in solve_hist])
    cgs = np.array([float(np.asarray(c)) if c is not None else 0.0
                    for _, c in solve_hist])

    out = {"particles": sim.num_particles, "grid": 2 * bound + 1,
           "kind": kind}
    if writer is not None:
        out["vdb"] = {"dir": vdb_dir, "max_pending": writer.max_pending,
                      "writer_cap_frames": writer.writer_cap_frames,
                      "max_pending_bytes_budget": max_pending_bytes,
                      "final_drain_secs": round(drain_secs, 2),
                      "fallback_frames": writer.fallback_frames,
                      "tail_fetches": writer.tail_fetches,
                      "fetch_secs": round(writer.fetch_secs, 2),
                      "proc_secs": round(writer.proc_secs, 2),
                      "submit_block_secs": round(writer.submit_block_secs, 2),
                      "backpressure_secs": round(writer.backpressure_secs, 2),
                      "accum": accum}
    for name, a, b in WINDOWS:
        if a not in cum or b not in cum:
            continue
        secs = cum[b] - cum[a]
        row = {"steps_per_sec": (b - a) / secs,
               "ms_per_frame": 1000.0 * secs / (b - a)}
        # frame f's solve scalars live at solve_hist[f - edges[0]]
        oa, ob = a - edges[0], b - edges[0]
        if ob <= len(outer):
            row["outer_iters_mean"] = round(float(outer[oa:ob].mean()), 2)
            row["cg_iters_mean"] = round(float(cgs[oa:ob].mean()), 1)
        if writer is not None and snaps[a] and snaps[b]:
            io_row = {k: round(snaps[b][k] - snaps[a][k], 2)
                      for k in ("submit_block_secs", "fetch_secs",
                                "proc_secs", "backpressure_secs")}
            io_row["pending_at_end"] = snaps[b]["pending"]
            # main-loop wall not attributable to queue blocking ==
            # physics + dispatch; the claim "early frames are
            # physics-bound" is checkable per window from these two
            io_row["physics_side_secs"] = round(
                secs - io_row["submit_block_secs"], 2)
            row["io"] = io_row
        out[name] = row
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", choices=("flip", "mpm"), default="flip")
    ap.add_argument("--bound", type=int, default=None,
                    help="default: 64 for flip (129^3), 63 for mpm (127^3)")
    ap.add_argument("--density", type=float, default=None,
                    help="default: 25 for flip, scene default for mpm")
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--cpu-only", action="store_true")
    ap.add_argument("--vdb", default=None, metavar="DIR",
                    help="write mygrids<i>.vdb per frame to DIR through "
                         "AsyncVdbWriter (the reference's production I/O, "
                         "fluid.cc:1503-1509 / mpm.cc:1433-1434) and "
                         "publish *_vdb rows")
    ap.add_argument("--accum", action="store_true",
                    help="with --vdb: also write the accumulated "
                         "mygrids.vdb at the end (fluid.cc:1508-1509)")
    ap.add_argument("--max-pending-bytes", type=int, default=1 << 30,
                    help="host-memory budget for the encode/write queue")
    ap.add_argument("--out", default="sustained_129.json")
    args = ap.parse_args()
    if args.bound is None:
        args.bound = 63 if args.kind == "mpm" else 64
    if args.density is None and args.kind == "flip":
        args.density = 25.0

    rec = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            rec = json.load(f)
    # non-headline scales (e.g. the 121^3 reference-literal workload) get
    # grid-suffixed keys
    if args.kind == "mpm":
        key = f"mpm_{2 * args.bound + 1}" + ("_vdb" if args.vdb else "")
    else:
        key = "device_vdb" if args.vdb else "device"
        if args.bound != 64:
            key += f"_{2 * args.bound + 1}"
    if not args.cpu_only:
        rec[key] = device_run(args.bound, args.density, args.frames,
                              vdb_dir=args.vdb, accum=args.accum,
                              kind=args.kind,
                              max_pending_bytes=args.max_pending_bytes)
    cpu = cpu_windows()
    if cpu:
        rec["cpu"] = cpu
        for name, _, _ in WINDOWS:
            row, cwin = (rec.get(key) or {}).get(name), cpu.get(name)
            if row and cwin:
                row["vs_baseline"] = (row["steps_per_sec"]
                                      / cwin["amdahl_bound_steps_per_sec"])

    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"wrote {args.out}")
    for side in dict.fromkeys((key, "cpu")):
        for name, _, _ in WINDOWS:
            if name in rec.get(side, {}):
                print(f"{side} {name}: "
                      f"{rec[side][name]['steps_per_sec']:.3f} steps/s")


if __name__ == "__main__":
    main()
