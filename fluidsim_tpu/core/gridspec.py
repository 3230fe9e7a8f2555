"""Dense device-grid geometry.

The reference stores everything in OpenVDB sparse trees over the coordinate
box ``[-B, B]^3`` (``B = 60`` for FLIP, ``fluid.cc:1159``; ``B = 15`` for MPM,
``mpm.cc:1028``), fully voxelized — i.e. effectively dense.  This design
keeps one dense device-resident array per field with index
``i = c + B`` per axis, shape ``(N, N, N)`` with ``N = 2B + 1``.

Velocity uses the reference's MAC convention: a single ``(N, N, N, 3)`` array
where component ``d`` of cell ``c`` lives on the *lower* ``d``-face of the
cell; the cell-centred value is ``0.5 * (v[c, d] + v[c + e_d, d])``
(``fluid.cc:59-70``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static geometry of the simulation box (hashable: safe as a jit static).

    Attributes:
      bound: B — grid coordinates span ``[-B, B]`` per axis (``fluid.cc:1159``).
      wall: cells with ``|c| > wall`` are solid boundary walls
        (``fluid.cc:1264``: 58; ``mpm.cc:1193``: 13 — i.e. ``B - 2``).
      dx: voxel size (1.0 in both reference apps).
    """

    bound: int
    wall: int
    dx: float = 1.0

    @property
    def n(self) -> int:
        return 2 * self.bound + 1

    @property
    def shape(self):
        return (self.n, self.n, self.n)

    def coords(self) -> np.ndarray:
        """(N,) integer coordinates ``-B..B``."""
        return np.arange(-self.bound, self.bound + 1)

    def wall_mask(self) -> np.ndarray:
        """Boolean (N,N,N): True where ``|c| > wall`` on any axis."""
        c = np.abs(self.coords())
        over = c > self.wall
        return over[:, None, None] | over[None, :, None] | over[None, None, :]

    def within_mask(self, m: int) -> np.ndarray:
        """Boolean (N,N,N): True where ``|c| <= m`` on all axes."""
        c = np.abs(self.coords())
        ok = c <= m
        return ok[:, None, None] & ok[None, :, None] & ok[None, None, :]

    def wall_normals(self) -> np.ndarray:
        """(N,N,N,3) inward unit-ish normals on wall cells.

        Reference ``fluid.cc:1256-1331`` / ``mpm.cc:1185-1230``: each wall cell
        gets +-1 per axis whose coordinate exceeds the wall threshold,
        pointing into the domain.  Kept for API parity (the reference computes
        but never uses them in the dynamics).
        """
        c = self.coords()
        n = self.n
        normals = np.zeros((n, n, n, 3), dtype=np.float32)
        over = np.abs(c) > self.wall
        sgn = np.where(c < 0, 1.0, -1.0)
        for d in range(3):
            shape = [1, 1, 1]
            shape[d] = n
            normals[..., d] = np.where(over.reshape(shape), sgn.reshape(shape), 0.0)
        return normals


def flat_index(cells, n: int):
    """Flatten (…, 3) array-index cells (already offset by +B) to scalar ids."""
    return (cells[..., 0] * n + cells[..., 1]) * n + cells[..., 2]


def cell_center_velocity(vel):
    """MAC face velocities -> cell-centred velocities (``fluid.cc:59-70``).

    ``vc[c, d] = 0.5 * (v[c, d] + v[c + e_d, d])`` with zero beyond the array
    edge (matches the OpenVDB background value of 0).
    """
    out = []
    for d in range(3):
        vd = vel[..., d]
        pad = [(0, 0)] * 3
        pad[d] = (0, 1)
        shifted = jnp.pad(vd, pad)[tuple(
            slice(1, None) if i == d else slice(None) for i in range(3))]
        out.append(0.5 * (vd + shifted))
    return jnp.stack(out, axis=-1)


def shift_to_plus(a, d):
    """result[c] = a[c + e_d] (zero-padded): read the plus-side neighbour."""
    pad = [(0, 0)] * 3
    pad[d] = (0, 1)
    return jnp.pad(a, pad)[tuple(
        slice(1, None) if i == d else slice(None) for i in range(3))]


def shift_to_minus(a, d):
    """result[c] = a[c - e_d] (zero-padded): read the minus-side neighbour."""
    pad = [(0, 0)] * 3
    pad[d] = (1, 0)
    return jnp.pad(a, pad)[tuple(
        slice(0, -1) if i == d else slice(None) for i in range(3))]
