"""Grid validation (``openvdb/tools/Diagnostics.h`` analog).

The reference tool walks the tree checking values against predicates
(``checkLevelSet``: finite, symmetric background, |∇φ|≈1 in the band,
no active tiles; ``checkFogVolume``: finite, values in [0,1];
``CheckNan``/``CheckInf``/``CheckRange``...) and returns a report string
plus an optional mask of offending voxels.  Dense version: each check
is one fused reduction pass; masks are bool arrays.  These back the frame
loop's failure detection (SURVEY.md §5 — the reference has none).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from fluidsim_tpu.ops.gridops import gradient, magnitude

__all__ = ["CheckReport", "check_finite_grid", "check_range",
           "check_levelset", "check_fog_volume", "diagnose"]


class CheckReport(NamedTuple):
    """One predicate's outcome: failure count and (optional) voxel mask."""
    name: str
    failed: int
    mask: object  # (N,N,N) bool | None

    @property
    def ok(self) -> bool:
        return self.failed == 0

    def __str__(self) -> str:  # report-string surface like the reference
        return (f"{self.name}: ok" if self.ok
                else f"{self.name}: {self.failed} voxels failed")


def _report(name, bad, want_mask):
    return CheckReport(name, int(jnp.sum(bad)), bad if want_mask else None)


def check_finite_grid(grid, mask: bool = False) -> CheckReport:
    """``CheckNan`` + ``CheckInf``: every value finite."""
    bad = ~jnp.isfinite(grid)
    if bad.ndim == 4:
        bad = jnp.any(bad, axis=-1)
    return _report("finite", bad, mask)


def check_range(grid, lo: float, hi: float, mask: bool = False) -> CheckReport:
    """``CheckRange``: values within [lo, hi]."""
    bad = ~jnp.isfinite(grid) | (grid < lo) | (grid > hi)
    return _report(f"range[{lo},{hi}]", bad, mask)


def check_levelset(phi, half_width: float = 3.0, grad_tol: float = 0.5,
                   dx: float = 1.0, mask: bool = False):
    """``tools::checkLevelSet``: finite values, |φ| ≤ band everywhere
    (truncated narrow-band convention), and |∇φ| within ``grad_tol`` of 1
    inside the band.  Returns a list of CheckReports."""
    w = half_width * dx
    reports = [check_finite_grid(phi, mask)]
    over = jnp.abs(phi) > w * (1.0 + 1e-4)
    reports.append(_report("band", over, mask))
    g = magnitude(gradient(phi, dx))
    band = jnp.abs(phi) < 0.9 * w
    # skip a 1-voxel rind: central differences there read out-of-box zeros
    interior = jnp.zeros(phi.shape, bool).at[1:-1, 1:-1, 1:-1].set(True)
    badg = band & interior & (jnp.abs(g - 1.0) > grad_tol)
    reports.append(_report("unit-gradient", badg, mask))
    return reports


def check_fog_volume(fog, mask: bool = False):
    """``tools::checkFogVolume``: finite and within [0, 1]."""
    return [check_finite_grid(fog, mask), check_range(fog, 0.0, 1.0, mask)]


def diagnose(reports) -> str:
    """Join CheckReports into the reference-style report string (empty
    string = all good, same contract as ``tools::Diagnose``)."""
    bad = [str(r) for r in reports if not r.ok]
    return "\n".join(bad)
