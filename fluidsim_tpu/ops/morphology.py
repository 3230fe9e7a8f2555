"""Binary mask morphology (``openvdb/tools/Morphology.h`` analog).

The reference library offers topology dilation/erosion of active masks
(``tools::dilateVoxels`` / ``tools::erodeVoxels``) with three neighborhood
patterns (``NN_FACE`` = 6, ``NN_FACE_EDGE`` = 18, ``NN_FACE_EDGE_VERTEX`` =
26).  On dense device-resident masks these are max/min-pools expressed as
shifted ORs — one fused XLA pass per iteration, no tree topology to
maintain.  Out-of-box neighbors read the background (inactive), matching
OpenVDB semantics on an unbounded tree clipped to our dense box.
"""

from __future__ import annotations

import jax.numpy as jnp

from fluidsim_tpu.core.gridspec import shift_to_plus, shift_to_minus

__all__ = ["dilate", "erode", "opening", "closing", "NN_FACE",
           "NN_FACE_EDGE", "NN_FACE_EDGE_VERTEX"]

NN_FACE = 6
NN_FACE_EDGE = 18
NN_FACE_EDGE_VERTEX = 26


def _neighbor_or(m, pattern: int):
    """OR of the neighborhood of each cell (excluding the cell itself)."""
    if pattern not in (NN_FACE, NN_FACE_EDGE, NN_FACE_EDGE_VERTEX):
        raise ValueError(f"unknown neighborhood pattern {pattern}")
    # Separable trick: face+edge+vertex (26) is a 3^3 box OR; face (6) is
    # the axis shifts only; face+edge (18) is the box minus the 8 corners,
    # built as OR over the three axis-plane 3x3 boxes.
    def axis_or3(a, d):
        return a | shift_to_plus(a, d) | shift_to_minus(a, d)

    if pattern == NN_FACE:
        out = jnp.zeros_like(m)
        for d in range(3):
            out = out | shift_to_plus(m, d) | shift_to_minus(m, d)
        return out
    if pattern == NN_FACE_EDGE_VERTEX:
        return axis_or3(axis_or3(axis_or3(m, 0), 1), 2)
    # NN_FACE_EDGE: union of the three 2-D 3x3 plane boxes through the cell
    xy = axis_or3(axis_or3(m, 0), 1)
    xz = axis_or3(axis_or3(m, 0), 2)
    yz = axis_or3(axis_or3(m, 1), 2)
    return xy | xz | yz


def dilate(mask, iterations: int = 1, pattern: int = NN_FACE):
    """Grow an active mask by ``iterations`` topology steps
    (``tools::dilateVoxels``)."""
    m = mask.astype(bool)
    for _ in range(iterations):
        m = m | _neighbor_or(m, pattern)
    return m


def _neighbor_and(m, pattern: int):
    """AND of the neighborhood of each cell (excluding the cell itself).
    Zero-padded shifts make out-of-box neighbors read inactive, matching
    OpenVDB's background on the clipped dense box."""
    if pattern not in (NN_FACE, NN_FACE_EDGE, NN_FACE_EDGE_VERTEX):
        raise ValueError(f"unknown neighborhood pattern {pattern}")

    def axis_and3(a, d):
        return a & shift_to_plus(a, d) & shift_to_minus(a, d)

    if pattern == NN_FACE:
        out = jnp.ones_like(m)
        for d in range(3):
            out = out & shift_to_plus(m, d) & shift_to_minus(m, d)
        return out
    if pattern == NN_FACE_EDGE_VERTEX:
        return axis_and3(axis_and3(axis_and3(m, 0), 1), 2)
    xy = axis_and3(axis_and3(m, 0), 1)
    xz = axis_and3(axis_and3(m, 0), 2)
    yz = axis_and3(axis_and3(m, 1), 2)
    return xy & xz & yz


def erode(mask, iterations: int = 1, pattern: int = NN_FACE):
    """Shrink an active mask (``tools::erodeVoxels``): a cell survives only
    if its whole neighborhood is active.  Dual of :func:`dilate`."""
    m = mask.astype(bool)
    for _ in range(iterations):
        m = m & _neighbor_and(m, pattern)
    return m


def opening(mask, iterations: int = 1, pattern: int = NN_FACE):
    """Erode then dilate — removes speckles smaller than the structuring
    element (the classic use of erode+dilate pairs in Morphology.h)."""
    return dilate(erode(mask, iterations, pattern), iterations, pattern)


def closing(mask, iterations: int = 1, pattern: int = NN_FACE):
    """Dilate then erode — fills holes smaller than the structuring
    element."""
    return erode(dilate(mask, iterations, pattern), iterations, pattern)
