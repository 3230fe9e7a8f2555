"""Async sparse frame exporter (io/export.py): packer round-trip,
persistence rules, truncation fallback, and end-to-end VDB equivalence
with the synchronous dense path.

Reference semantics being preserved: per-frame ``mygrids<i>.vdb`` writes
(fluid.cc:1503-1509) with FLIP's overwrite-all-non-solid outputGrid rule
(fluid.cc:1434-1448) and MPM's mass>0.1 rule (mpm.cc:1368-1382), through
a background queue (the unused openvdb/io/Queue.h:248 made real).
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from fluidsim_tpu.io.export import (AsyncFrameExporter, pack_active,
                                    unpack_active)


class _Spec:
    def __init__(self, n, bound):
        self.shape = (n, n, n)
        self.bound = bound
        self.dx = 1.0


def _crop(g, bound, n):
    """Crop a leaf-aligned decoded grid back to the sim's (n, n, n) block."""
    off = [-bound - int(o) for o in g.origin]
    v = np.asarray(g.values)
    return v[off[0]:off[0] + n, off[1]:off[1] + n, off[2]:off[2] + n]


def _rand_field(n, frac, seed):
    rng = np.random.default_rng(seed)
    vals = rng.random((n, n, n)).astype(np.float32) + 0.1
    vals[rng.random((n, n, n)) > frac] = 0.0
    return vals


def test_pack_unpack_roundtrip():
    n = 21
    dense = _rand_field(n, 0.2, 0)
    cap = int((dense != 0).sum()) + 5
    buf = np.asarray(pack_active(jnp.asarray(dense), None, cap))
    out, count = unpack_active(buf, (n, n, n), cap)
    assert count == int((dense != 0).sum())
    np.testing.assert_array_equal(out, dense)


def test_pack_truncation_detected():
    n = 17
    dense = _rand_field(n, 0.5, 1)
    cap = 10  # far below the active count
    buf = np.asarray(pack_active(jnp.asarray(dense), None, cap))
    out, count = unpack_active(buf, (n, n, n), cap)
    assert out is None and count > cap


@pytest.mark.parametrize("mode", ["flip", "mpm"])
def test_exporter_matches_sync_dense_path(tmp_path, mode):
    from fluidsim_tpu.io.vdb import read_vdb

    n, bound = 21, 10
    spec = _Spec(n, bound)
    solid = np.zeros((n, n, n), bool)
    solid[0] = solid[-1] = True
    frames = [_rand_field(n, 0.15, 10 + i) for i in range(4)]

    out_dir = tmp_path / "async"
    os.makedirs(out_dir)
    with AsyncFrameExporter(spec, solid, mode=mode, accum=True) as ex:
        for i, f in enumerate(frames):
            ex.submit(str(out_dir / f"mygrids{i}.vdb"), jnp.asarray(f))
        ex.flush()
        assert ex.fallback_frames == 0
        assert len(ex.accum_grids) == len(frames)

    # reference persistence rules, computed directly
    persistent = np.zeros((n, n, n), np.float32)
    for i, f in enumerate(frames):
        ns = ~solid
        if mode == "mpm":
            upd = ns & (f > 0.1)
            persistent[upd] = f[upd]
        else:
            persistent[ns] = f[ns]
        (g,) = read_vdb(str(out_dir / f"mygrids{i}.vdb"))
        np.testing.assert_array_equal(_crop(g, bound, n), persistent)


def test_exporter_dense_fallback_on_tiny_cap(tmp_path):
    from fluidsim_tpu.io.vdb import read_vdb

    n, bound = 17, 8
    spec = _Spec(n, bound)
    solid = np.zeros((n, n, n), bool)
    dense = _rand_field(n, 0.6, 3)
    with AsyncFrameExporter(spec, solid, mode="flip", cap=8) as ex:
        ex.submit(str(tmp_path / "f.vdb"), jnp.asarray(dense))
        ex.flush()
        assert ex.fallback_frames == 1
    (g,) = read_vdb(str(tmp_path / "f.vdb"))
    np.testing.assert_array_equal(_crop(g, bound, n), dense)


def test_exporter_ref_topology_dense_active(tmp_path):
    """ref_topology=True marks EVERY non-solid voxel active (the
    reference's per-frame setValue sweep, fluid.cc:1443-1445), zeros
    included, while values stay identical to the compact default."""
    from fluidsim_tpu.io.vdb import read_vdb

    n, bound = 21, 10
    spec = _Spec(n, bound)
    solid = np.zeros((n, n, n), bool)
    solid[0] = solid[-1] = True
    dense = _rand_field(n, 0.15, 42)

    with AsyncFrameExporter(spec, solid, mode="flip",
                            ref_topology=True) as ex:
        ex.submit(str(tmp_path / "ref.vdb"), jnp.asarray(dense))
        ex.flush()
    with AsyncFrameExporter(spec, solid, mode="flip") as ex:
        ex.submit(str(tmp_path / "compact.vdb"), jnp.asarray(dense))
        ex.flush()

    (gr,) = read_vdb(str(tmp_path / "ref.vdb"))
    (gc,) = read_vdb(str(tmp_path / "compact.vdb"))
    np.testing.assert_array_equal(_crop(gr, bound, n), _crop(gc, bound, n))

    # crop the decoded active mask back to the sim block
    off = [-bound - int(o) for o in gr.origin]
    act = np.asarray(gr.active)[off[0]:off[0] + n, off[1]:off[1] + n,
                                off[2]:off[2] + n]
    np.testing.assert_array_equal(act, ~solid)
    # default topology: only nonzero voxels active
    actc = np.asarray(gc.active)[off[0]:off[0] + n, off[1]:off[1] + n,
                                 off[2]:off[2] + n]
    expect = np.where(solid, False, dense != 0)
    np.testing.assert_array_equal(actc, expect)


def test_lost_particle_monitor_warns_and_strict_raises(monkeypatch):
    """Silent migration drops must surface: warn on lost>0
    (checked one step later, off the dispatch path), raise under
    FLUIDSIM_STRICT_MIGRATION=1."""
    from fluidsim_tpu.parallel.flip_sharded import LostParticleMonitor

    class Sim(LostParticleMonitor):
        def __init__(self):
            self._init_lost_monitor()

    sim = Sim()
    sim._note_lost({"lost": np.int32(0)})       # step 1: no pending yet
    sim._note_lost({"lost": np.int32(3)})       # step 2: checks step 1 (0)
    with pytest.warns(RuntimeWarning, match="dropped 3 particle"):
        sim._note_lost({"lost": np.int32(0)})   # step 3: checks step 2
    assert sim.lost_total == 3
    sim._flush_lost()                           # pending 0 — no warning
    assert sim.lost_total == 3

    monkeypatch.setenv("FLUIDSIM_STRICT_MIGRATION", "1")
    sim2 = Sim()
    sim2._note_lost({"lost": np.int32(7)})
    with pytest.raises(RuntimeError, match="dropped 7 particle"):
        sim2._flush_lost()
