"""Asynchronous per-frame VDB export pipeline.

The reference writes ``simulation/mygrids<i>.vdb`` every frame from the
main loop (``fluid.cc:1503-1509``, ``mpm.cc:1433-1434``) and ships an
*unused* background writer (``openvdb/io/Queue.h:248``).  Here the whole
export path is asynchronous AND cheap on the device->host link:

* a jitted **sparse packer** (:func:`pack_active`) turns the dense
  occupancy grid into one uint8 buffer ``[count | bit-mask | compacted
  active values]`` — ~4-7x fewer bytes than the dense f32 grid when the
  fluid occupies ~10-25% of cells, and exactly ONE host fetch per frame
  (each fetch pays a fixed round-trip on top of bandwidth).  The FLIP
  persistence rule (overwrite every non-solid cell, ``fluid.cc:1434-1448``
  — i.e. the written field is just ``occ * ~solid``, no cross-frame
  memory) is folded into the packer so the host does no masking at all;
  MPM's rule (only cells with mass > 0.1, ``mpm.cc:1368-1382``) keeps a
  host-side persistent field.
* a **two-stage worker pipeline**: a fetch thread blocks on the link
  (GIL-free) while a process thread reconstructs + hands frames to the
  native encode/write queue (``io/native.py``) — the device frame loop
  never blocks on the link, the codec, or the disk, and the fetch
  overlaps the host-side work.

What the export costs per frame on the GPU (device fetch, encode) is not
measured yet.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from functools import partial

import numpy as np

_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


def pack_active(grid, solid_flat, cap: int):
    """Jittable sparse packer: dense (nx, ny, nz) f32 -> one uint8 buffer.

    ``solid_flat``: flat bool mask of cells forced to 0 first (pass None
    to skip).  Layout: ``[count:int32 | bits:ncells/8 | vals:4*cap]``
    where ``bits`` is the little-endian bit-packed ``grid != 0`` mask and
    ``vals`` the first ``cap`` active values in flat-index order (stable
    sort by inactivity).  If ``count > cap`` the values section is
    truncated — callers must fall back to a dense fetch for that frame.
    """
    import jax
    import jax.numpy as jnp

    flat = grid.reshape(-1)
    if solid_flat is not None:
        flat = jnp.where(solid_flat, 0.0, flat)
    n = flat.shape[0]
    npad = -(-n // 8) * 8
    act = flat != 0
    actp = jnp.pad(act, (0, npad - n))
    bits = jnp.sum(
        actp.reshape(-1, 8).astype(jnp.uint32)
        * jnp.asarray(_BIT_WEIGHTS, jnp.uint32), axis=1).astype(jnp.uint8)
    # stable sort moves active values (key 0) to the front, preserving
    # flat-index order among them
    vals = jax.lax.sort([(~act).astype(jnp.int32), flat], num_keys=1,
                        is_stable=True)[1][:cap]
    count = jnp.sum(act.astype(jnp.int32))
    return jnp.concatenate([
        jax.lax.bitcast_convert_type(count[None], jnp.uint8).reshape(-1),
        bits,
        jax.lax.bitcast_convert_type(vals, jnp.uint8).reshape(-1)])


def unpack_active(buf: np.ndarray, shape, cap: int):
    """Host-side inverse of :func:`pack_active`.

    Returns ``(dense, count)``; ``dense`` is None when ``count > cap``
    (truncated packet — caller falls back to the dense fetch).
    """
    n = int(np.prod(shape))
    npad = -(-n // 8) * 8
    count = int(np.frombuffer(buf[:4].tobytes(), np.int32)[0])
    if count > cap:
        return None, count
    bits = buf[4:4 + npad // 8]
    mask = np.unpackbits(bits, bitorder="little")[:n].astype(bool)
    vals = np.frombuffer(buf[4 + npad // 8:].tobytes(), np.float32)
    dense = np.zeros(n, np.float32)
    dense[mask] = vals[:count]
    return dense.reshape(shape), count


class AsyncFrameExporter:
    """Background per-frame VDB exporter (sparse fetch + write queue).

    ``submit(path, occ)`` queues one frame: ``occ`` is the DEVICE
    occupancy array straight out of the step's metrics; everything else
    (fetch, reconstruction, persistence rule, encode, disk) happens on
    the worker threads.  ``mode`` selects the reference's persistence
    rule: ``"flip"`` overwrites all non-solid cells (stateless — fused
    into the device packer), ``"mpm"`` only cells with value > 0.1.
    With ``accum=True`` every frame's grid is kept for a final
    accumulated archive (``fluid.cc:1508-1509``).

    ``ref_topology=True`` reproduces the reference's FLIP *active
    topology* exactly: ``fluid.cc:1443-1445`` setValues EVERY non-solid
    voxel each frame (zeros included), so the reference file marks all
    non-solid voxels active.  The default (False) marks only nonzero
    voxels active — value-identical on read-back (inactive voxels return
    the 0 background) and 6-8x cheaper to encode via the ACTIVE_MASK
    codec, but ``activeVoxelCount`` metadata and active-voxel iteration
    differ from the reference's output.  MPM topology matches the
    reference either way (only cells with mass > 0.1 are ever written,
    ``mpm.cc:1368-1382``, and those values are necessarily nonzero).
    """

    def __init__(self, spec, solid_np, mode: str = "flip", cap: int | None = None,
                 compression: int | None = None, accum: bool = False,
                 depth: int = 4, dense_fetch: bool = False,
                 ref_topology: bool = False,
                 max_pending_bytes: int = 1 << 30):
        import jax
        import jax.numpy as jnp

        from fluidsim_tpu.io.native import AsyncVdbWriter

        self.spec = spec
        self.solid = np.asarray(solid_np, bool)
        self.mode = mode
        self.ref_topology = bool(ref_topology)
        ncells = int(np.prod(spec.shape))
        self.cap = int(cap) if cap else max(1, ncells // 4)
        self._hdr = 4 + (-(-ncells // 8) * 8) // 8
        self.dense_fetch = bool(dense_fetch)
        solid_dev = (jnp.asarray(self.solid.reshape(-1))
                     if mode == "flip" else None)
        self._pack = jax.jit(partial(pack_active, solid_flat=solid_dev,
                                     cap=self.cap))
        if not self.dense_fetch:    # compile outside any timed window
            np.asarray(self._pack(jnp.zeros(spec.shape, jnp.float32)))
        self._persistent = (np.zeros(spec.shape, np.float32)
                            if mode == "mpm" else None)
        self._writer = AsyncVdbWriter(compression)
        self.accum_grids = [] if accum else None
        self.fallback_frames = 0
        self.tail_fetches = 0
        self._pred = self.cap          # first frame fetches the full buffer
        self.max_pending = 0
        self.fetch_secs = 0.0          # cumulative wall in the fetch stage
        self.proc_secs = 0.0           # cumulative wall in the process stage
        self.submit_block_secs = 0.0   # main-loop time blocked on the queue
        # Host-memory budget for the encode/write queue: each queued
        # native job copies the dense values (4 B) + mask (1 B) per cell,
        # so unbounded backlog at e.g. 121^3 is ~9 MB/frame (a measured
        # 78-frame pile-up = ~0.7 GB).  The PROC thread blocks while the
        # writer backlog exceeds the budget (backpressure_secs counts the
        # wall); the bounded fetch/proc queues then propagate the stall
        # to submit_block_secs, so peak host bytes stay <= budget +
        # (depth + 2) sparse frames.
        self._frame_bytes = 5 * ncells
        self.writer_cap_frames = max(2, int(max_pending_bytes)
                                     // self._frame_bytes)
        self.backpressure_secs = 0.0   # proc-thread wall spent throttling
        # two-stage pipeline: fetch (blocks on the link, GIL-free) ->
        # process (reconstruct + encode submit).  TWO fetch threads
        # alternate frames: transfers serialize at the link anyway, but
        # each fetch's fixed round-trip + unpack overlaps the other's
        # transfer; the process stage reorders by sequence number.
        self._n_fetchers = 2
        self._seq = 0
        self._fetch_q: queue.Queue = queue.Queue(maxsize=depth)
        self._proc_q: queue.Queue = queue.Queue(maxsize=depth + 2)
        self._err = None
        self._threads = [threading.Thread(target=self._fetch_loop,
                                          daemon=True)
                         for _ in range(self._n_fetchers)]
        self._threads.append(threading.Thread(target=self._proc_loop,
                                              daemon=True))
        for t in self._threads:
            t.start()

    # ---- main-loop side ----

    def submit(self, path: str, occ):
        if self._err is not None:
            raise RuntimeError("exporter worker failed") from self._err
        seq = self._seq
        self._seq += 1
        if self.dense_fetch:
            item = (seq, path, None, 0, None, occ)
        else:
            packed = self._pack(occ)
            # Dispatch the predictive head slice HERE, from the main
            # thread: device ops execute in dispatch order, so slicing in
            # the fetch thread would queue the copy behind every frame
            # step dispatched since (measured 130 ms/frame of fetch wait
            # vs the ~45 ms transfer itself).  Start the host copy
            # immediately so it overlaps subsequent compute.
            k = min(self.cap, -(-self._pred // self._BUCKET) * self._BUCKET)
            head = packed[:self._hdr + 4 * k]
            try:
                head.copy_to_host_async()
            except (AttributeError, NotImplementedError):
                pass
            item = (seq, path, head, k, packed, occ)
        t0 = time.monotonic()
        self._fetch_q.put(item)
        self.submit_block_secs += time.monotonic() - t0
        self.max_pending = max(
            self.max_pending,
            self._fetch_q.qsize() + self._proc_q.qsize()
            + self._writer.pending())

    def pending(self) -> int:
        return (self._fetch_q.qsize() + self._proc_q.qsize()
                + self._writer.pending())

    def flush(self):
        self._fetch_q.join()
        self._proc_q.join()
        self._writer.flush()
        if self._err is not None:
            raise RuntimeError("exporter worker failed") from self._err

    def close(self):
        if self._threads:
            self.flush()
            for _ in range(self._n_fetchers):
                self._fetch_q.put(None)
            self._proc_q.join()
            for t in self._threads:
                t.join()
            self._threads = []
        self._writer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- worker side ----

    _BUCKET = 65536   # value-count granularity of the predictive fetch

    def _fetch_sparse(self, head_dev, k, packed):
        """Complete the predictive fetch dispatched by ``submit``.

        The packed buffer holds ``cap`` value slots but only ``count``
        are real; transferring the full capacity wastes ~half the
        45 MB/s link, so ``submit`` sliced ``[header | bits | vals[:k]]``
        with ``k`` predicted from the previous frame's count (bucketed so
        slice executables are reused, not recompiled per frame).  On
        under-prediction, fetch the missing tail in a second round trip.
        """
        n = int(np.prod(self.spec.shape))
        hdr = self._hdr
        head = np.asarray(head_dev)
        count = int(np.frombuffer(head[:4].tobytes(), np.int32)[0])
        if count > self.cap:
            self._pred = self.cap
            return None, None, count           # truncated packet
        if count > k:                          # under-predicted: tail fetch
            self.tail_fetches += 1
            kc = min(self.cap, -(-count // self._BUCKET) * self._BUCKET)
            tail = np.asarray(packed[hdr + 4 * k:hdr + 4 * kc])
            buf = np.concatenate([head, tail])
        else:
            buf = head
        self._pred = count + max(4096, count // 16)
        mask = np.unpackbits(buf[4:hdr], bitorder="little")[:n].astype(bool)
        vals = np.frombuffer(buf[hdr:hdr + 4 * count].tobytes(), np.float32)
        dense = np.zeros(n, np.float32)
        dense[mask] = vals
        return (dense.reshape(self.spec.shape),
                mask.reshape(self.spec.shape), count)

    def _fetch_loop(self):
        while True:
            item = self._fetch_q.get()
            if item is None:
                self._proc_q.put(None)
                self._fetch_q.task_done()
                return
            seq, path, head, k, packed, occ = item
            try:
                t0 = time.monotonic()
                raw = head is None             # dense fetch: solid not yet 0
                mask = None
                if head is None:
                    dense = np.asarray(occ)
                else:
                    dense, mask, _cnt = self._fetch_sparse(head, k, packed)
                    if dense is None:          # truncated: dense fallback
                        self.fallback_frames += 1
                        dense = np.asarray(occ)
                        raw = True
                self.fetch_secs += time.monotonic() - t0
                self._proc_q.put((seq, path, dense, mask, raw))
            except BaseException as e:
                self._err = e
            finally:
                self._fetch_q.task_done()

    def _proc_loop(self):
        # frames may arrive out of order from the fetch pool; the MPM
        # persistence rule and the accumulated archive need sequence
        # order, so buffer gaps and process in-order
        pending = {}
        expect = 0
        ended = 0
        while True:
            item = self._proc_q.get()
            if item is None:
                ended += 1
                self._proc_q.task_done()
                if ended == self._n_fetchers:
                    return
                continue
            try:
                pending[item[0]] = item[1:]
                while expect in pending:
                    t0 = time.monotonic()
                    self._write_one(*pending.pop(expect))
                    self.proc_secs += time.monotonic() - t0
                    expect += 1
            except BaseException as e:         # surface on next submit/flush
                self._err = e
            finally:
                self._proc_q.task_done()

    def _write_one(self, path, dense, mask, raw):
        from fluidsim_tpu.io.vdb import VdbGrid

        if self._writer.pending() >= self.writer_cap_frames:
            t0 = time.monotonic()
            while self._writer.pending() >= self.writer_cap_frames:
                time.sleep(0.002)
            self.backpressure_secs += time.monotonic() - t0

        # Active topology = nonzero cells: lets the ACTIVE_MASK codec
        # compact each leaf to its active values before zlib (6-8x less
        # deflate input at ~15% fill).  Inactive voxels read back as the
        # 0 background — value-identical to the dense all-active form.
        if self.mode == "mpm":
            upd = (~self.solid) & (dense > 0.1)
            self._persistent[upd] = dense[upd]
            vals = self._persistent.copy()
            mask = vals != 0
        elif raw:
            vals = np.where(self.solid, np.float32(0.0), dense)
            mask = vals != 0
        else:
            vals = dense                        # solid rule fused on device
        if self.mode != "mpm" and self.ref_topology:
            # reference-faithful dense-active topology (see class doc)
            mask = ~self.solid
        g = VdbGrid(values=vals, origin=(-self.spec.bound,) * 3,
                    background=0.0, voxel_size=self.spec.dx, active=mask)
        self._writer.submit(path, g)
        if self.accum_grids is not None:
            self.accum_grids.append(g)
