"""Smoke test of the main paths on the GPU, at the repo's real scales.

    python chip_smoke.py            # one GPU: phases 0-5
    python chip_smoke.py --multi    # four GPUs: the sharded phases only

Phases (one process; the C++ oracles are CPU subprocesses):

  0. device and set-up: a GPU or nothing; card name and power limit; the
     native tools rebuilt from ``native/*.cc``.
  1. FLIP at the reference scale (121^3, 689k particles) through
     ``cli fluid`` with per-frame ``.vdb`` export, read back, and checked
     against ``native/ref_cpu`` on the same particles.
  2. FLIP 129^3 / 2M, the headline scale.
  3. APIC 129^3.
  4. The MPM cone at the reference's 31^3 against ``native/ref_mpm``.
  5. MPM 127^3 / 474k under the hybrid operator.

``--multi``: ``ShardedFlipSim`` at 257^3 / 9.8M and ``ShardedMpmSim`` at
127^3 on a 1-D mesh of four GPUs, each against the single-device sim.

Any failed check ends the script with a non-zero exit code.  Only a run in
which every phase passed prints the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Times printed along the way are information, not measurements.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Parity limits.  FLIP: per-frame relative KE against ref_cpu over frames
# 0-9; f32 atomics sum in a different order on every run and the CG
# iteration counts differ, so this is looser than a bitwise match.  MPM:
# the limits of tests/test_ke_parity.py.  Sharded: the single-device
# parity tolerance of the sharded tests.
FLIP_KE_REL = 1e-3
MPM_KE_MEDIAN, MPM_KE_MAX, MPM_DT_RTOL = 5e-4, 5e-3, 1e-4
SHARDED_KE_REL = 2e-3

SINGLE_PHASES = ("flip_ref_cli", "flip_129", "apic_129", "mpm_ref",
                 "mpm_127")
MULTI_PHASES = ("sharded_flip", "sharded_mpm")


class SmokeFailure(Exception):
    pass


def check(cond, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def phases_for(multi: bool) -> tuple:
    """Phase names a run executes after set-up."""
    return MULTI_PHASES if multi else SINGLE_PHASES


def require_gpu(count: int = 1):
    """The JAX devices, which must be at least ``count`` GPUs."""
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"needs a GPU; JAX found '{devs[0].platform}'")
    check(len(devs) >= count, f"needs {count} GPUs; JAX found {len(devs)}")
    return devs


def result_line(devs) -> str:
    """The last line of a passing run."""
    return json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}})


def ke_rel_err(ours, ref) -> np.ndarray:
    """Per-frame relative KE error against a reference trace (the
    denominator is floored at 1 so a frame at rest does not divide by 0)."""
    ours = np.asarray(ours, np.float64)
    ref = np.asarray(ref, np.float64)
    check(ours.shape == ref.shape, f"trace lengths {ours.shape} vs {ref.shape}")
    return np.abs(ours - ref) / np.maximum(np.abs(ref), 1.0)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0 and out.stdout.strip(),
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def log(msg: str):
    print(msg, flush=True)


def check_frames(name: str, metrics: list, bound: int, pos,
                 max_outer: int | None = None):
    """Finite KE and dt every frame, and every particle inside the box."""
    ke = np.asarray([float(m["kinetic_energy"]) for m in metrics])
    dt = np.asarray([float(m["dt"]) for m in metrics])
    check(np.isfinite(ke).all() and (ke > 0).all(), f"{name}: KE {ke}")
    check(np.isfinite(dt).all() and (dt > 0).all(), f"{name}: dt {dt}")
    pos = np.asarray(pos)
    check(np.isfinite(pos).all(), f"{name}: non-finite positions")
    check(np.abs(pos).max() <= bound, f"{name}: particle outside the box "
          f"(|p| max {np.abs(pos).max():.3f} > {bound})")
    if max_outer is not None:
        outer = [int(m["outer_iters"]) for m in metrics]
        div = [float(m["div_rms"]) for m in metrics]
        check(all(1 <= o < max_outer for o in outer),
              f"{name}: outer iterations {outer} (cap {max_outer})")
        check(np.isfinite(div).all(), f"{name}: div_rms {div}")
        log(f"  outer_iters {outer}  div_rms "
            f"{[round(d, 4) for d in div]}")
    log(f"  KE {ke.tolist()}")


def run_compiled(name: str, sim, frames: int):
    """Compile ``sim``'s step ahead of time, print its memory analysis, and
    run ``frames`` frames; returns the per-frame metrics."""
    import jax

    t0 = time.perf_counter()
    compiled = sim._step.lower(sim.solid, sim.state).compile()
    log(f"  compile {time.perf_counter() - t0:.1f} s")
    log(f"  memory_analysis: {compiled.memory_analysis()}")
    metrics = []
    t0 = time.perf_counter()
    for i in range(frames):
        sim.state, m = compiled(sim.solid, sim.state)
        metrics.append(m)
        if i == 0:
            jax.block_until_ready(sim.state)
            t0 = time.perf_counter()
    jax.block_until_ready(sim.state)
    if frames > 1:
        ms = (time.perf_counter() - t0) / (frames - 1) * 1e3
        log(f"  steady {ms:.1f} ms/frame over {frames - 1} frames "
            "(information only)")
    return metrics


def build_native():
    from fluidsim_tpu.io.native import NATIVE_DIR

    subprocess.run(["make", "-C", NATIVE_DIR, "-B"], check=True,
                   stdout=subprocess.DEVNULL)
    return NATIVE_DIR


def phase_flip_ref_cli(tmp: str, native: str):
    """FLIP 121^3 / 689k through the CLI, with per-frame .vdb export."""
    from fluidsim_tpu import cli
    from fluidsim_tpu.io.vdb import read_vdb
    from fluidsim_tpu.scenes import get_scene
    from fluidsim_tpu.seeding import seed_particles

    frames = 10
    scene = get_scene("water_cube_drop")
    pos, _ = seed_particles(scene, seed=0)
    pfile = os.path.join(tmp, "particles.f32")
    np.ascontiguousarray(pos, np.float32).tofile(pfile)
    ref = subprocess.Popen(
        [os.path.join(native, "ref_cpu"), str(scene.spec.bound),
         str(scene.density), str(frames), pfile],
        stdout=subprocess.PIPE, text=True)
    try:
        out = os.path.join(tmp, "sim")
        rc = cli.main(["fluid", "--frames", str(frames), "--out", out,
                       "--metrics", os.path.join(out, "m.jsonl"),
                       "--echo-every", str(frames)])
        check(rc == 0, f"cli fluid returned {rc}")
        ref_out, _ = ref.communicate(timeout=900)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    check(ref.returncode == 0, f"ref_cpu exited {ref.returncode}")
    cpp = [json.loads(line) for line in ref_out.splitlines()
           if line.startswith("{")]
    with open(os.path.join(out, "m.jsonl")) as f:
        ours = [json.loads(line) for line in f]
    check(len(ours) == frames and len(cpp) == frames,
          f"frames: {len(ours)} logged, {len(cpp)} from ref_cpu")
    log(f"  {len(pos)} particles, grid {scene.spec.n}^3")

    paths = [os.path.join(out, f"mygrids{i}.vdb") for i in range(frames)]
    paths.append(os.path.join(out, "mygrids.vdb"))
    for p in paths:
        grids = read_vdb(p)
        check(len(grids) >= 1 and all(np.isfinite(g.values).all()
                                      for g in grids), f"bad archive {p}")
    check(len(read_vdb(paths[-1])) == frames,
          f"mygrids.vdb holds {len(read_vdb(paths[-1]))} grids, "
          f"expected {frames}")
    chk = subprocess.run([os.path.join(native, "vdbcheck"), paths[-2]],
                         capture_output=True, text=True, timeout=300)
    check(chk.returncode == 0, f"vdbcheck: {chk.stderr.strip()}")
    check(json.loads(chk.stdout.strip().splitlines()[-1])["ok"],
          "vdbcheck rejected the last frame")
    log(f"  read back {len(paths)} archives; vdbcheck ok on {paths[-2]}")

    rel = ke_rel_err([r["kinetic_energy"] for r in ours],
                     [r["ke"] for r in cpp])
    log(f"  KE rel err vs ref_cpu per frame: "
        f"{[float(f'{r:.2e}') for r in rel]}")
    check(rel.max() <= FLIP_KE_REL,
          f"FLIP KE parity {rel.max():.3e} > {FLIP_KE_REL}")


def phase_flip_129(mode: str = "flip", frames: int = 5):
    from fluidsim_tpu.models.flip import FlipParams, FlipSim
    from fluidsim_tpu.scenes import get_scene

    scene = get_scene("water_cube_drop", bound=64, density=25.0)
    params = FlipParams(bound=scene.spec.bound, wall=scene.spec.wall,
                        mode=mode)
    sim = FlipSim(scene, params=params)
    log(f"  {mode}: {sim.num_particles} particles, grid {scene.spec.n}^3, "
        f"transfer_chunks={sim.params.transfer_chunks}")
    metrics = run_compiled(mode, sim, frames)
    check_frames(mode, metrics, scene.spec.bound, sim.state.pos,
                 max_outer=sim.params.max_outer)


def phase_mpm_ref(tmp: str, native: str):
    """The reference cone at 31^3 against ref_mpm on the same particles."""
    from fluidsim_tpu.models.mpm import MpmSim

    frames = 12
    sim = MpmSim("mpm_cone")
    pos = np.asarray(sim.state.pos, np.float32)
    pfile = os.path.join(tmp, "mpm_particles.f32")
    np.ascontiguousarray(pos).tofile(pfile)
    ref = subprocess.run(
        [os.path.join(native, "ref_mpm"), str(sim.scene.spec.bound),
         str(sim.scene.density), str(frames), pfile],
        capture_output=True, text=True, timeout=900)
    check(ref.returncode == 0, f"ref_mpm exited {ref.returncode}")
    cpp = [json.loads(line) for line in ref.stdout.splitlines()
           if line.startswith("{")]
    metrics = [sim.step() for _ in range(frames)]
    ke = [float(m["kinetic_energy"]) for m in metrics]
    dt = [float(m["dt"]) for m in metrics]
    rel = ke_rel_err(ke, [r["ke"] for r in cpp])
    log(f"  {len(pos)} particles; KE rel err median {np.median(rel):.2e} "
        f"max {rel.max():.2e}")
    check(np.median(rel) < MPM_KE_MEDIAN and rel.max() < MPM_KE_MAX,
          f"MPM KE parity: {rel}")
    dt_rel = np.abs(np.asarray(dt) - [r["dt"] for r in cpp]) / np.asarray(
        [r["dt"] for r in cpp])
    check(dt_rel.max() <= MPM_DT_RTOL, f"MPM dt parity: {dt_rel}")
    check_frames("mpm_ref", metrics, sim.scene.spec.bound, sim.state.pos)


def phase_mpm_127(frames: int = 5):
    from fluidsim_tpu.models.mpm import MpmSim

    sim = MpmSim("mpm_cone", bound=63)
    p = sim.params
    log(f"  {sim.num_particles} particles, grid {sim.scene.spec.n}^3, "
        f"hessian={p.hessian} fast_transfer={p.fast_transfer}")
    metrics = run_compiled("mpm_127", sim, frames)
    cg = [int(m["cg_iters"]) for m in metrics]
    spd = [int(m["spd_fallback"]) for m in metrics]
    log(f"  cg_iters {cg}  spd_fallback {spd}")
    check(all(0 < c < p.cg_hybrid_cap for c in cg),
          f"CG did not converge within the full-operator budget: {cg}")
    check(sum(spd) == 0, f"SPD fallback in free fall: {spd}")
    check_frames("mpm_127", metrics, sim.scene.spec.bound, sim.state.pos)


def _mesh(devs):
    from jax.sharding import Mesh

    from fluidsim_tpu.parallel.flip_sharded import AX
    return Mesh(np.asarray(devs[:4]), (AX,))


def _sharded_vs_single(name, single_fn, sharded_fn, frames: int):
    """Run the single-device sim, free it, then the sharded one; compare
    KE per frame and require lost == 0.  Returns the sharded sim."""
    single = single_fn()
    log(f"  {single.num_particles} particles, grid {single.scene.spec.n}^3")
    ke_single = [float(single.step()["kinetic_energy"])
                 for _ in range(frames)]
    del single
    gc.collect()
    sim = sharded_fn()
    ke, lost = [], []
    for _ in range(frames):
        m = sim.step()
        ke.append(float(m["kinetic_energy"]))
        lost.append(int(m["lost"]))
    rel = ke_rel_err(ke, ke_single)
    log(f"  {name}: KE single {ke_single}\n  {name}: KE sharded {ke}\n"
        f"  rel {rel.tolist()}  lost {lost}")
    check(rel.max() <= SHARDED_KE_REL,
          f"{name}: sharded KE parity {rel.max():.3e} > {SHARDED_KE_REL}")
    check(sum(lost) == 0, f"{name}: lost particles {lost}")
    return sim


def _memory_per_card(devs, sim, name: str):
    """Print each card's bytes in use, and check that the sharded state is
    spread over all four cards rather than piled on the first."""
    import jax

    state = [0] * 4
    for leaf in jax.tree_util.tree_leaves(sim.state):
        for shard in leaf.addressable_shards:
            state[devs.index(shard.device)] += shard.data.nbytes
    stats = [d.memory_stats() for d in devs[:4]]
    in_use = [s["bytes_in_use"] if s else None for s in stats]
    log(f"  {name}: bytes_in_use per card {in_use}; "
        f"sharded state bytes per card {state}")
    check(min(state) >= 0.25 * max(state),
          f"{name}: state is not spread over the cards: {state}")


def phase_sharded_flip(devs):
    from fluidsim_tpu.models.flip import FlipSim
    from fluidsim_tpu.parallel.flip_sharded import ShardedFlipSim
    from fluidsim_tpu.scenes import get_scene

    scene = get_scene("water_cube_drop", bound=128, density=16.0)
    sim = _sharded_vs_single(
        "flip", lambda: FlipSim(scene),
        lambda: ShardedFlipSim(scene, mesh=_mesh(devs)), 3)
    _memory_per_card(devs, sim, "flip")
    del sim


def phase_sharded_mpm(devs):
    from fluidsim_tpu.models.mpm import MpmSim
    from fluidsim_tpu.parallel.mpm_sharded import ShardedMpmSim
    from fluidsim_tpu.scenes import get_scene

    scene = get_scene("mpm_cone", bound=63)
    sim = _sharded_vs_single(
        "mpm", lambda: MpmSim(scene),
        lambda: ShardedMpmSim(scene, mesh=_mesh(devs)), 2)
    _memory_per_card(devs, sim, "mpm")
    del sim


def run(multi: bool) -> str:
    """All phases of a run; returns the result line."""
    import jax

    devs = require_gpu(4 if multi else 1)
    from fluidsim_tpu.utils.cache import enable_compilation_cache

    log(f"card: {card_info()}")
    log(f"jax {jax.__version__}; {len(devs)} x {devs[0].device_kind}; "
        f"compile cache {enable_compilation_cache()}")
    t0 = time.perf_counter()
    native = build_native()
    log(f"[setup] native tools rebuilt in {time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        steps = {
            "flip_ref_cli": lambda: phase_flip_ref_cli(tmp, native),
            "flip_129": lambda: phase_flip_129("flip", 5),
            "apic_129": lambda: phase_flip_129("apic", 3),
            "mpm_ref": lambda: phase_mpm_ref(tmp, native),
            "mpm_127": lambda: phase_mpm_127(5),
            "sharded_flip": lambda: phase_sharded_flip(devs),
            "sharded_mpm": lambda: phase_sharded_mpm(devs),
        }
        for name in phases_for(multi):
            log(f"[{name}]")
            t0 = time.perf_counter()
            steps[name]()
            gc.collect()
            log(f"[{name}] passed in {time.perf_counter() - t0:.1f} s")
    return result_line(devs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded phases, on four GPUs")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    try:
        line = run(args.multi)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
