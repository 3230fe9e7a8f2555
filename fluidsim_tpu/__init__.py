"""fluidsim_tpu — a PIC/FLIP + MPM fluid simulation framework in JAX.

Built from scratch in JAX/XLA with the capabilities of the reference
C++ simulator Aakash1312/Fluid-Simulation (see SURVEY.md):

* ``models.flip`` — PIC+FLIP incompressible liquid on a MAC grid with a
  matrix-free pressure Poisson projection (reference: ``fluid.cc``).
* ``models.mpm`` — semi-implicit snow-style Material Point Method with
  SVD-clamped plasticity and a JVP-based implicit velocity solve
  (reference: ``mpm.cc`` + ``deformHeader.h``).
* ``ops`` — device-side building blocks: B-spline transfer kernels,
  P2G/G2P, stencil Laplacian, PCG, batched 3x3 SVD/polar.
* ``parallel`` — multi-device domain decomposition (``shard_map`` + halo
  exchange by ``ppermute``) for grids and particles.
* ``io`` — OpenVDB-4.0.2-compatible ``.vdb`` export, checkpoints, metrics.
* ``compat`` — bit-compatible reproduction of the reference's particle
  seeding (std::mt19937 + UniformPointScatter semantics).
"""

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy convenience exports (keep bare import light; JAX loads on demand).
    if name == "FlipSim":
        from fluidsim_tpu.models.flip import FlipSim
        return FlipSim
    if name == "MpmSim":
        from fluidsim_tpu.models.mpm import MpmSim
        return MpmSim
    if name == "ShardedFlipSim":
        from fluidsim_tpu.parallel.flip_sharded import ShardedFlipSim
        return ShardedFlipSim
    if name == "get_scene":
        from fluidsim_tpu.scenes import get_scene
        return get_scene
    if name == "mesh_to_sdf":
        from fluidsim_tpu.ops.mesh import mesh_to_sdf
        return mesh_to_sdf
    if name == "raytrace_levelset":
        from fluidsim_tpu.ops.raytrace import raytrace_levelset
        return raytrace_levelset
    if name == "volume_to_mesh":
        from fluidsim_tpu.ops.volume_to_mesh import volume_to_mesh
        return volume_to_mesh
    raise AttributeError(name)
