"""VDB archive round-trip tests (the reference validates I/O via
``TestFile.cc``/``TestGridIO.cc``; here the oracle is write->read identity
plus structural checks of the 4.0.2 layout)."""

import io
import os
import struct

import numpy as np
import pytest

from fluidsim_tpu.io.vdb import (
    VdbGrid, write_vdb, read_vdb, COMPRESS_NONE, COMPRESS_ZIP,
    COMPRESS_ACTIVE_MASK, COMPRESS_BLOSC, OPENVDB_MAGIC, FILE_VERSION)

ALL_COMPRESSION = [COMPRESS_NONE, COMPRESS_ZIP, COMPRESS_ACTIVE_MASK,
                   COMPRESS_ZIP | COMPRESS_ACTIVE_MASK,
                   COMPRESS_BLOSC, COMPRESS_BLOSC | COMPRESS_ACTIVE_MASK]


def _grid(shape=(21, 21, 21), origin=(-10, -10, -10), seed=0, frac_active=1.0):
    rng = np.random.default_rng(seed)
    vals = rng.random(shape).astype(np.float32)
    act = rng.random(shape) < frac_active
    vals[~act] = 0.0
    return VdbGrid(values=vals, origin=origin, active=act, name="g")


@pytest.mark.parametrize("compression", ALL_COMPRESSION)
def test_roundtrip_dense(tmp_path, compression):
    g = _grid()
    path = str(tmp_path / "t.vdb")
    write_vdb(path, [g], compression=compression)
    (r,) = read_vdb(path)
    # read-back covers the leaf-aligned bounding box; compare on the original
    o = np.asarray(g.origin) - np.asarray(r.origin)
    s = tuple(slice(int(o[d]), int(o[d]) + g.values.shape[d]) for d in range(3))
    np.testing.assert_array_equal(r.values[s], g.values)
    np.testing.assert_array_equal(r.active[s], g.active)
    # padding is inactive background
    pad_mask = np.ones(r.values.shape, bool)
    pad_mask[s] = False
    assert not r.active[pad_mask].any()


@pytest.mark.parametrize("compression", ALL_COMPRESSION)
def test_roundtrip_sparse_activity(tmp_path, compression):
    g = _grid(frac_active=0.3, seed=1)
    path = str(tmp_path / "t.vdb")
    write_vdb(path, [g], compression=compression)
    (r,) = read_vdb(path)
    o = np.asarray(g.origin) - np.asarray(r.origin)
    s = tuple(slice(int(o[d]), int(o[d]) + g.values.shape[d]) for d in range(3))
    np.testing.assert_array_equal(r.active[s], g.active)
    np.testing.assert_array_equal(r.values[s][g.active], g.values[g.active])


def test_multiple_grids_and_names(tmp_path):
    g1 = _grid(seed=2)
    g2 = _grid(seed=3)
    g1.name = g2.name = ""  # the reference writes unnamed grids
    path = str(tmp_path / "t.vdb")
    write_vdb(path, [g1, g2])
    r = read_vdb(path)
    assert len(r) == 2
    assert r[0].name == "[0]" and r[1].name == "[1]"  # addSuffix convention


def test_header_layout(tmp_path):
    g = _grid()
    path = str(tmp_path / "t.vdb")
    write_vdb(path, [g])
    raw = open(path, "rb").read()
    magic, = struct.unpack_from("<q", raw, 0)
    version, maj, mnr = struct.unpack_from("<III", raw, 8)
    assert magic == OPENVDB_MAGIC == 0x56444220
    assert version == FILE_VERSION == 224
    assert (maj, mnr) == (4, 0)
    assert raw[20] == 1  # hasGridOffsets
    uuid_txt = raw[21:57].decode()
    assert uuid_txt.count("-") == 4 and len(uuid_txt) == 36


def test_reference_scale_grid(tmp_path):
    # 121^3 box at origin -60 like fluid.cc's outputGrid
    rng = np.random.default_rng(4)
    vals = (rng.random((121, 121, 121)) < 0.1).astype(np.float32) * 27.0
    g = VdbGrid(values=vals, origin=(-60, -60, -60), name="")
    path = str(tmp_path / "big.vdb")
    write_vdb(path, [g])
    (r,) = read_vdb(path)
    o = np.asarray(g.origin) - np.asarray(r.origin)
    s = tuple(slice(int(o[d]), int(o[d]) + 121) for d in range(3))
    np.testing.assert_array_equal(r.values[s], vals)
    assert os.path.getsize(path) < 121 ** 3 * 4  # zip actually compresses


def test_background_value_roundtrip(tmp_path):
    g = _grid(frac_active=0.5, seed=5)
    g.background = -1.0
    g.values[~g.active] = -1.0
    path = str(tmp_path / "t.vdb")
    write_vdb(path, [g], compression=COMPRESS_ACTIVE_MASK)
    (r,) = read_vdb(path)
    assert r.background == -1.0
    o = np.asarray(g.origin) - np.asarray(r.origin)
    s = tuple(slice(int(o[d]), int(o[d]) + g.values.shape[d]) for d in range(3))
    np.testing.assert_array_equal(r.values[s], g.values)


def test_vec3_roundtrip(tmp_path):
    """Vec3f grids (Tree_vec3s_5_4_3, openvdb/openvdb.h:62,79) round-trip
    across all codecs."""
    from fluidsim_tpu.io import vdb

    rng = np.random.default_rng(3)
    vals = rng.normal(size=(12, 9, 17, 3)).astype(np.float32)
    act = rng.random((12, 9, 17)) > 0.35
    vals[~act] = 0.0
    for comp in (vdb.COMPRESS_NONE, vdb.COMPRESS_ZIP,
                 vdb.COMPRESS_ZIP | vdb.COMPRESS_ACTIVE_MASK):
        path = str(tmp_path / f"v3_{comp}.vdb")
        g = vdb.VdbGrid(values=vals, origin=(-5, 3, 2), active=act,
                        name="vel", background=(0.0, 0.0, 0.0))
        vdb.write_vdb(path, [g], compression=comp)
        (r,) = vdb.read_vdb(path)
        assert r.values.ndim == 4 and r.values.shape[-1] == 3
        o = np.asarray(r.origin) * -1  # r covers the leaf-aligned bbox
        s = tuple(slice(int(-5 - r.origin[0]) if d == 0
                        else int((3, 2)[d - 1] - r.origin[d]), None)
                  for d in range(3))
        # compare on active voxels via index math: locate our box in r
        ro = np.asarray(r.origin)
        sl = tuple(slice(int(o0 - ro[d]), int(o0 - ro[d]) + vals.shape[d])
                   for d, o0 in enumerate((-5, 3, 2)))
        np.testing.assert_array_equal(r.active[sl], act)
        np.testing.assert_allclose(r.values[sl][act], vals[act], rtol=0,
                                   atol=0)


def test_half_float_roundtrip(tmp_path):
    """save_half grids (_HalfFloat suffix, GridDescriptor.cc:50,86) store
    leaf buffers as IEEE half; reader restores f32 within half precision."""
    from fluidsim_tpu.io import vdb

    rng = np.random.default_rng(4)
    vals = rng.normal(size=(10, 10, 10)).astype(np.float32)
    act = rng.random((10, 10, 10)) > 0.4
    vals[~act] = 0.0
    for comp in (vdb.COMPRESS_NONE,
                 vdb.COMPRESS_ZIP | vdb.COMPRESS_ACTIVE_MASK):
        path = str(tmp_path / f"h_{comp}.vdb")
        g = vdb.VdbGrid(values=vals, origin=(0, 0, 0), active=act,
                        name="d", save_half=True)
        vdb.write_vdb(path, [g], compression=comp)
        (r,) = vdb.read_vdb(path)
        assert r.save_half
        sl = tuple(slice(0, 10) for _ in range(3))
        np.testing.assert_array_equal(r.active[sl], act)
        np.testing.assert_allclose(
            r.values[sl][act], vals[act].astype(np.float16).astype(np.float32))

    # vec3 + half combined
    v3 = rng.normal(size=(8, 8, 8, 3)).astype(np.float32)
    a3 = rng.random((8, 8, 8)) > 0.3
    v3[~a3] = 0.0
    path = str(tmp_path / "h3.vdb")
    vdb.write_vdb(path, [vdb.VdbGrid(values=v3, active=a3, name="v",
                                     background=(0.0, 0.0, 0.0),
                                     save_half=True)])
    (r,) = vdb.read_vdb(path)
    np.testing.assert_allclose(
        r.values[:8, :8, :8][a3], v3[a3].astype(np.float16).astype(np.float32))


@pytest.mark.parametrize("compression", ALL_COMPRESSION)
def test_delayed_load(tmp_path, compression):
    """``open_vdb`` defers leaf value buffers (io::File delayed loading):
    metadata/topology are available before any buffer read, and the
    on-demand load matches the eager reader exactly."""
    from fluidsim_tpu.io.vdb import open_vdb

    g1 = _grid(seed=4, frac_active=0.4)
    g2 = _grid(seed=5)
    g2.name = "other"
    path = str(tmp_path / "d.vdb")
    write_vdb(path, [g1, g2], compression=compression)

    handles = open_vdb(path)
    assert [h.name for h in handles] == ["g", "other"]
    assert all(not h.loaded for h in handles)
    assert handles[0].leaf_count > 0
    assert handles[0].voxel_size == 1.0

    eager = read_vdb(path)
    # load ONLY the second grid; the first stays unloaded
    r = handles[1].grid
    assert handles[1].loaded and not handles[0].loaded
    np.testing.assert_array_equal(r.values, eager[1].values)
    np.testing.assert_array_equal(r.active, eager[1].active)
    assert r.name == "other"
    # now the first
    r0 = handles[0].grid
    np.testing.assert_array_equal(r0.values, eager[0].values)
    np.testing.assert_array_equal(r0.active, eager[0].active)


def _typed_grids(seed=11, shape=(16, 16, 16)):
    """One grid per registered value type (openvdb/openvdb.h:49-82), all
    sharing an activity mask; returns (grids, active)."""
    rng = np.random.default_rng(seed)
    act = rng.random(shape) < 0.5
    return [
        VdbGrid(rng.standard_normal(shape).astype(np.float32), name="f",
                active=act),
        VdbGrid(rng.standard_normal(shape), name="d", active=act),
        VdbGrid(rng.integers(-5, 99, shape).astype(np.int32), name="i32",
                active=act, background=7),
        VdbGrid(rng.integers(-5, 99, shape).astype(np.int64), name="i64",
                active=act),
        VdbGrid(act.copy(), name="b", active=act, background=False),
        VdbGrid(rng.standard_normal(shape + (3,)).astype(np.float32),
                name="v3s", active=act),
        VdbGrid(rng.standard_normal(shape + (3,)), name="v3d", active=act),
        VdbGrid(rng.integers(-5, 99, shape + (3,)).astype(np.int32),
                name="v3i", active=act),
    ], act


@pytest.mark.parametrize("compression", ALL_COMPRESSION)
def test_value_type_roundtrip(tmp_path, compression):
    """Every registered value type round-trips with its native dtype
    (Int32/Bool/Double/Vec3d generality)."""
    grids, act = _typed_grids()
    path = str(tmp_path / "t.vdb")
    write_vdb(path, grids, compression=compression)
    back = read_vdb(path)
    for g, r in zip(grids, back):
        assert r.name == g.name
        assert r.value_type == g.value_type
        assert r.values.dtype == g.store_dtype
        ga = np.asarray(g.values, g.store_dtype)
        np.testing.assert_array_equal(ga[act], r.values[act])
        if not (compression & COMPRESS_ACTIVE_MASK):
            np.testing.assert_array_equal(ga, r.values)
        np.testing.assert_array_equal(act, r.active)


def test_double_half_roundtrip(tmp_path):
    """Double/Vec3d grids honor save_half (RealToHalf<double> -> half,
    io/Compression.h:120-146): stored half, read back as f64."""
    rng = np.random.default_rng(3)
    gs = [VdbGrid(rng.standard_normal((8, 8, 8)), name="dh", save_half=True),
          VdbGrid(rng.standard_normal((8, 8, 8, 3)), name="v3dh",
                  save_half=True)]
    path = str(tmp_path / "h.vdb")
    write_vdb(path, gs)
    for g, r in zip(gs, read_vdb(path)):
        assert r.save_half and r.values.dtype == np.float64
        np.testing.assert_allclose(
            r.values, np.asarray(g.values, np.float16).astype(np.float64))


def test_instance_parent_roundtrip(tmp_path):
    """Grids sharing a values array are written once; the second becomes an
    instance descriptor naming the first (Archive::writeGridInstance,
    Archive.cc:1329-1367) and the reader re-connects it
    (Archive::connectInstance)."""
    from fluidsim_tpu.io.vdb import open_vdb

    rng = np.random.default_rng(4)
    shared = rng.standard_normal((8, 8, 8)).astype(np.float32)
    gs = [VdbGrid(shared, name="a"),
          VdbGrid(shared, name="a_inst", voxel_size=2.0),
          VdbGrid(rng.standard_normal((8, 8, 8)).astype(np.float32),
                  name="own")]
    path = str(tmp_path / "i.vdb")
    write_vdb(path, gs)
    # the instance's tree section must not be duplicated on disk: the file
    # is much smaller than one with three independent trees
    gs_indep = [VdbGrid(np.array(g.values), name=g.name,
                        voxel_size=g.voxel_size) for g in gs]
    path2 = str(tmp_path / "i2.vdb")
    write_vdb(path2, gs_indep)
    assert os.path.getsize(path) < os.path.getsize(path2)

    back = read_vdb(path)
    assert [g.name for g in back] == ["a", "a_inst", "own"]
    assert back[1].voxel_size == 2.0
    np.testing.assert_array_equal(back[0].values, back[1].values)

    handles = open_vdb(path)
    assert handles[1].instance_parent == "a"
    np.testing.assert_array_equal(handles[1].grid.values,
                                  handles[0].grid.values)
