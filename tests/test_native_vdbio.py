"""Native VDB encoder tests: byte-identity with the Python writer (same
uuid), readability, and the async queue."""

import os

import numpy as np
import pytest

from fluidsim_tpu.io import native
from fluidsim_tpu.io.vdb import (VdbGrid, write_vdb, read_vdb, COMPRESS_NONE,
                                 COMPRESS_ZIP, COMPRESS_ACTIVE_MASK)

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="libvdbio.so not buildable")

UUID = "01234567-89ab-cdef-0123-456789abcdef"


def _grid(shape=(21, 21, 21), seed=0, frac=1.0, name="g"):
    rng = np.random.default_rng(seed)
    vals = rng.random(shape).astype(np.float32)
    act = rng.random(shape) < frac
    vals[~act] = 0.0
    return VdbGrid(values=vals, origin=(-10, -10, -10), active=act, name=name)


def _py_bytes(grid, compression):
    import io as _io
    import tempfile
    import fluidsim_tpu.io.vdb as vdb
    import uuid as uuid_mod

    class _Fixed:
        def __str__(self):
            return UUID

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.vdb")
        orig = uuid_mod.uuid4
        uuid_mod.uuid4 = lambda: _Fixed()
        try:
            write_vdb(path, [grid], compression=compression)
        finally:
            uuid_mod.uuid4 = orig
        return open(path, "rb").read()


@pytest.mark.parametrize("compression", [COMPRESS_NONE, COMPRESS_ZIP,
                                         COMPRESS_ACTIVE_MASK,
                                         COMPRESS_ZIP | COMPRESS_ACTIVE_MASK])
def test_native_matches_python_bytes(compression):
    g = _grid(frac=0.6, seed=1)
    py = _py_bytes(g, compression)
    nat = native.encode_native(g, compression, UUID)
    assert nat == py


def test_native_unnamed_grid():
    g = _grid(name="")
    py = _py_bytes(g, COMPRESS_ZIP | COMPRESS_ACTIVE_MASK)
    nat = native.encode_native(g, COMPRESS_ZIP | COMPRESS_ACTIVE_MASK, UUID)
    assert nat == py


def test_native_output_readable(tmp_path):
    g = _grid(frac=0.4, seed=2)
    data = native.encode_native(g, COMPRESS_ZIP | COMPRESS_ACTIVE_MASK)
    path = str(tmp_path / "n.vdb")
    open(path, "wb").write(data)
    (r,) = read_vdb(path)
    o = np.asarray(g.origin) - np.asarray(r.origin)
    s = tuple(slice(int(o[d]), int(o[d]) + g.values.shape[d]) for d in range(3))
    np.testing.assert_array_equal(r.active[s], g.active)
    np.testing.assert_array_equal(r.values[s][g.active], g.values[g.active])


def test_async_queue(tmp_path):
    grids = [_grid(seed=i) for i in range(4)]
    paths = [str(tmp_path / f"f{i}.vdb") for i in range(4)]
    with native.AsyncVdbWriter() as w:
        for p, g in zip(paths, grids):
            w.submit(p, g)
        w.flush()
        assert w.pending() == 0
    for p, g in zip(paths, grids):
        (r,) = read_vdb(p)
        o = np.asarray(g.origin) - np.asarray(r.origin)
        s = tuple(slice(int(o[d]), int(o[d]) + 21) for d in range(3))
        np.testing.assert_array_equal(r.values[s], g.values)


def test_build_native_goes_through_make(tmp_path, monkeypatch):
    """Native tools are built from the sources by make, which rebuilds a
    binary older than its source (a stale or foreign binary is not used
    as is) and, with ``force``, rebuilds regardless."""
    import shutil
    import time

    for f in ("Makefile", "vdbcheck.cc"):
        shutil.copy(os.path.join(native.NATIVE_DIR, f), tmp_path)
    monkeypatch.setattr(native, "NATIVE_DIR", str(tmp_path))
    exe = tmp_path / "vdbcheck"
    exe.write_text("stale")
    os.utime(exe, (1, 1))                      # older than the source
    assert native.build_native("vdbcheck")
    assert exe.read_bytes()[:4] == b"\x7fELF"
    t0 = exe.stat().st_mtime_ns
    time.sleep(0.01)
    assert native.build_native("vdbcheck")     # up to date: untouched
    assert exe.stat().st_mtime_ns == t0
    assert native.build_native("vdbcheck", force=True)
    assert exe.stat().st_mtime_ns > t0
    assert not native.build_native("no_such_target")
