"""ctypes bindings for the native VDB encoder + async writer queue
(``native/vdbio.cc``) with transparent fallback to the pure-Python writer.

The queue is the analogue of ``openvdb::io::Queue``
(``openvdb/io/Queue.h:248``): frame exports are handed to a background
thread so the device frame loop never stalls on encoding or disk.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import uuid as _uuid

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
NATIVE_DIR = os.path.normpath(os.path.join(_HERE, "..", "..", "native"))
_LIB_PATH = os.path.join(NATIVE_DIR, "libvdbio.so")

_lib = None


def build_native(*targets: str, force: bool = False) -> bool:
    """Build ``native/`` targets from the committed sources through ``make``,
    which rebuilds whatever is older than its source (``force``: all of
    them, as ``make -B``).  One build at a time per checkout: concurrent
    processes (test workers) wait on a lock instead of racing the linker.
    Returns False when the toolchain is missing or the build fails."""
    cmd = ["make", "-C", NATIVE_DIR] + (["-B"] if force else []) + list(targets)
    try:
        with open(os.path.join(NATIVE_DIR, ".build.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            subprocess.run(cmd, check=True, stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL)
    except (OSError, subprocess.CalledProcessError):
        return False
    return all(os.path.exists(os.path.join(NATIVE_DIR, t)) for t in targets)


def _ensure_lib():
    global _lib
    if _lib is not None:
        return _lib
    if not build_native("libvdbio.so"):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.vdbio_encode.restype = ctypes.c_long
    lib.vdbio_encode.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_double, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
    lib.vdbio_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.vdbio_queue_create.restype = ctypes.c_void_p
    lib.vdbio_queue_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_double, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.c_char_p]
    lib.vdbio_queue_pending.restype = ctypes.c_long
    lib.vdbio_queue_pending.argtypes = [ctypes.c_void_p]
    lib.vdbio_queue_flush.argtypes = [ctypes.c_void_p]
    lib.vdbio_queue_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _ensure_lib() is not None


def _grid_args(grid, compression, uuid36):
    vals = np.ascontiguousarray(grid.values, np.float32)
    act = grid.active
    act = (np.ascontiguousarray(act, np.uint8) if act is not None
           else np.ones(vals.shape, np.uint8))
    return (vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            act.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            vals.shape[0], vals.shape[1], vals.shape[2],
            int(grid.origin[0]), int(grid.origin[1]), int(grid.origin[2]),
            float(grid.background), float(grid.voxel_size),
            grid.name.encode(), compression, uuid36.encode(), vals, act)


def encode_native(grid, compression: int, uuid36: str | None = None) -> bytes:
    """Encode one grid into a single-grid archive, natively."""
    lib = _ensure_lib()
    if lib is None:
        raise RuntimeError("libvdbio.so unavailable")
    uuid36 = uuid36 or str(_uuid.uuid4())
    *args, vals, act = _grid_args(grid, compression, uuid36)
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = lib.vdbio_encode(*args, ctypes.byref(out))
    data = ctypes.string_at(out, n)
    lib.vdbio_free(out)
    return data


class AsyncVdbWriter:
    """Background frame writer (native thread; io::Queue analogue).

    Falls back to synchronous Python writes when the native library is
    unavailable.
    """

    def __init__(self, compression: int | None = None):
        from fluidsim_tpu.io.vdb import COMPRESS_ZIP, COMPRESS_ACTIVE_MASK
        self.compression = (COMPRESS_ZIP | COMPRESS_ACTIVE_MASK
                            if compression is None else compression)
        self._lib = _ensure_lib()
        self._q = self._lib.vdbio_queue_create() if self._lib else None

    def submit(self, path: str, grid):
        if self._q is None:
            from fluidsim_tpu.io.vdb import write_vdb
            write_vdb(path, [grid], compression=self.compression)
            return
        *args, vals, act = _grid_args(grid, self.compression,
                                      str(_uuid.uuid4()))
        # keep buffers alive until the native side copies (submit copies
        # synchronously into the job before returning)
        self._lib.vdbio_queue_submit(self._q, path.encode(), *args)

    def pending(self) -> int:
        return int(self._lib.vdbio_queue_pending(self._q)) if self._q else 0

    def flush(self):
        if self._q is not None:
            self._lib.vdbio_queue_flush(self._q)

    def close(self):
        if self._q is not None:
            self.flush()
            self._lib.vdbio_queue_destroy(self._q)
            self._q = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
