"""Unrolled per-particle small-matrix contractions.

Batched tiny matmuls / dot_generals — (P,3,3) x (P,27,3)-style — have a
contraction of 3, far too small for a matrix unit, and at default
precision an f32 product may run in reduced precision (TF32 on the H100).
These helpers unroll the 3-sized dimensions into (P,27)-sliced elementwise
multiplies and reductions in full f32, which XLA fuses.
"""

from __future__ import annotations

import jax.numpy as jnp


def apply_mat27(c, d):
    """(P,3,3) x (P,27,3) -> (P,27,3): per-(particle, offset) ``C @ d``."""
    return jnp.stack(
        [sum(c[:, None, i, j] * d[..., j] for j in range(3)) for i in range(3)],
        axis=-1)


def outer_sum27(a, b):
    """(P,27,3) x (P,27,3) -> (P,3,3): ``sum_k a[:,k,i] b[:,k,j]``."""
    return jnp.stack(
        [jnp.stack([jnp.sum(a[..., i] * b[..., j], axis=1)
                    for j in range(3)], axis=-1) for i in range(3)], axis=-2)


def mat_apply27_T(m, g):
    """(P,3,3) x (P,27,3) -> (P,27,3): per-(particle, offset) ``M @ g`` where
    rows index the output (same as apply_mat27; alias for readability at
    force-scatter call sites: ``f_k = -V sigma gradW_k``)."""
    return apply_mat27(m, g)
