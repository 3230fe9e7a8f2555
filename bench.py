"""Benchmark harness — prints ONE JSON line.

Headline config (BASELINE.json config 3): FLIP water-cube drop at 129^3
(bound 64) with ~2M particles, full reference pipeline per frame (P2G,
occupancy, pressure do-while with Chebyshev-PCG, FLIP gather, CFL, advect).

The timed window ends in ``jax.block_until_ready`` on the last frame's
state, so it measures what the device did, not what the host enqueued.
The run needs a GPU and fails without one: a CPU timing says nothing about
the device the numbers are quoted for.

``vs_baseline`` compares steps/sec against the single-core C++ CPU port of
the reference algorithm at the same scale (``native/ref_cpu.cc``), whose
measured number is stored in ``BASELINE_CPU.json``.  Run
``python bench.py --measure-cpu-baseline`` to (re)generate it.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BASELINE_PATH = os.path.join(HERE, "BASELINE_CPU.json")

sys.path.insert(0, HERE)


def require_gpu():
    """The first JAX device, which must be a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found '{dev.platform}'")
    return dev


def measure_flip(bound: int, density: float, warmup: int, frames: int):
    import jax
    from fluidsim_tpu.models.flip import FlipSim
    from fluidsim_tpu.scenes import get_scene

    sim = FlipSim(get_scene("water_cube_drop", bound=bound, density=density))
    n_particles = sim.num_particles
    print(f"# grid {2*bound+1}^3, {n_particles} particles", file=sys.stderr)

    t0 = time.perf_counter()
    for _ in range(warmup):
        sim.step()
    jax.block_until_ready(sim.state)
    print(f"# warmup ({warmup} frames incl. compile): "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)

    t0 = time.perf_counter()
    for _ in range(frames):
        sim.step()
    jax.block_until_ready(sim.state)
    dt = (time.perf_counter() - t0) / frames
    return {
        "steps_per_sec": 1.0 / dt,
        "particle_steps_per_sec": n_particles / dt,
        "ms_per_frame": dt * 1000.0,
        "particles": n_particles,
        "grid": 2 * bound + 1,
    }


def measure_cpu_baseline(bound: int, density: float, frames: int = 3):
    """Build and time the C++ CPU port of the reference at the same scale."""
    native = os.path.join(HERE, "native")
    subprocess.check_call(["make", "-C", native, "ref_cpu"])
    out = subprocess.check_output(
        [os.path.join(native, "ref_cpu"), str(bound), str(density),
         str(frames)], text=True)
    rec = json.loads(out.strip().splitlines()[-1])
    with open(BASELINE_PATH, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bound", type=int, default=64)      # 129^3 ~ "128^3"
    ap.add_argument("--density", type=float, default=25.0)  # ~2.0M particles
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--measure-cpu-baseline", action="store_true")
    args = ap.parse_args()

    if args.measure_cpu_baseline:
        rec = measure_cpu_baseline(args.bound, args.density)
        print(json.dumps(rec))
        return

    dev = require_gpu()
    from fluidsim_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    res = measure_flip(args.bound, args.density, args.warmup, args.frames)

    # vs_baseline uses the MOST CONSERVATIVE denominator available: the
    # Amdahl bound — the steps/s an infinitely-threaded reference could
    # reach on this CPU (particle loops free, serial grid/CG unchanged) —
    # computed over the SAME frame window the device numerator measures
    # (frames [warmup, warmup+frames) of the 500-frame per-frame CPU
    # trace, docs/ref_cpu_perframe_129.jsonl).  Early frames are the
    # cheapest for the CPU reference (free-fall: few CG iterations), so
    # the window-matched ratio is the honest one.
    vs_baseline = 0.0
    denom = None
    trace = os.path.join(HERE, "docs", "ref_cpu_perframe_129.jsonl")
    if os.path.exists(trace):
        with open(trace) as f:
            rows = [json.loads(line) for line in f]
        window = rows[args.warmup:args.warmup + args.frames]
        if window:
            serial = sum(r["secs"] - r["particle_secs"] for r in window)
            denom = len(window) / serial
    if denom is None and os.path.exists(BASELINE_PATH):
        with open(BASELINE_PATH) as f:
            base = json.load(f)
        denom = base.get("amdahl_bound_steps_per_sec") or base.get("steps_per_sec")
    if denom:
        vs_baseline = res["steps_per_sec"] / denom

    print(json.dumps({
        "metric": "flip_steps_per_sec_128cube_2Mparticles",
        "value": round(res["steps_per_sec"], 4),
        "unit": "steps/s",
        "vs_baseline": round(vs_baseline, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind},
    }))


if __name__ == "__main__":
    main()
