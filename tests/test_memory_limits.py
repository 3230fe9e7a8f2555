"""Device-memory limits of the single-device FLIP transfers: the fused
tables may take half of what the device lets the process allocate; past
that FLIP chunks its transfers and APIC is refused.  The limit comes from
``memory_stats()``; a backend that reports none (the CPU) chunks only on
request."""

import math

import numpy as np
import pytest

from fluidsim_tpu.models import flip as flip_mod
from fluidsim_tpu.models.flip import (FlipParams, FlipSim, device_memory_limit,
                                      fit_transfers, fused_table_bytes)
from fluidsim_tpu.scenes import get_scene

GB = 10 ** 9
N257 = 257


class FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats,limit", [
    (None, None),
    ({}, None),
    ({"bytes_in_use": 5}, None),
    ({"bytes_limit": 60 * GB, "bytes_in_use": 5}, 60 * GB),
])
def test_device_memory_limit_from_stats(stats, limit):
    assert device_memory_limit(FakeDevice(stats)) == limit


def test_fused_table_bytes_at_257():
    assert fused_table_bytes(N257) == 2 * N257 ** 3 * 128 * 4
    assert 17.3 * GB < fused_table_bytes(N257) < 17.5 * GB


@pytest.mark.parametrize("mode", ["flip", "apic"])
def test_no_limit_keeps_params(mode):
    params = FlipParams(bound=128, wall=126, mode=mode)
    assert fit_transfers(params, N257, None) is params


@pytest.mark.parametrize("mode", ["flip", "apic"])
def test_257_fits_an_80gb_card(mode):
    """At 3/4 of 80 GB the 17.4 GB tables fit: no chunking, no refusal."""
    params = FlipParams(bound=128, wall=126, mode=mode)
    out = fit_transfers(params, N257, 60 * GB)
    assert out.transfer_chunks == 0 and out.mode == mode


def test_chunks_past_half_the_limit():
    limit = 16 * 2 ** 30
    with pytest.warns(UserWarning, match="chunking transfers over 8"):
        out = fit_transfers(FlipParams(bound=128, wall=126), N257, limit)
    table = fused_table_bytes(N257)
    assert out.transfer_chunks == 2 ** math.ceil(math.log2(table / (limit / 4)))
    assert out.transfer_chunks == 8


def test_apic_refused_past_half_the_limit():
    with pytest.raises(NotImplementedError, match="ShardedFlipSim"):
        fit_transfers(FlipParams(bound=128, wall=126, mode="apic"), N257,
                      16 * 2 ** 30)


@pytest.mark.parametrize("params", [
    FlipParams(bound=128, wall=126, transfer_chunks=2),
    FlipParams(bound=128, wall=126, fast_transfer=False),
], ids=["explicit_chunks", "naive_transfers"])
def test_limit_leaves_other_schedules(params):
    assert fit_transfers(params, N257, 16 * 2 ** 30) is params


def test_apic_with_explicit_chunks_rejected_without_limit():
    with pytest.raises(NotImplementedError, match="transfer_chunks"):
        fit_transfers(FlipParams(mode="apic", transfer_chunks=2), 17, None)


def test_flipsim_chunks_on_a_small_device(monkeypatch):
    """FlipSim reads the device limit: a device whose limit equals the
    table size gets 4 x-slab chunks, and the chunked frame matches the
    fused one."""
    scene = get_scene("water_cube_drop", bound=8, density=3.0)
    table = fused_table_bytes(scene.spec.n)
    fused = FlipSim(scene)
    monkeypatch.setattr(flip_mod, "device_memory_limit", lambda dev: table)
    with pytest.warns(UserWarning, match="chunking"):
        chunked = FlipSim(scene)
    assert fused.params.transfer_chunks == 0
    assert chunked.params.transfer_chunks == 4
    for _ in range(2):
        ka = float(fused.step()["kinetic_energy"])
        kb = float(chunked.step()["kinetic_energy"])
        np.testing.assert_allclose(kb, ka, rtol=2e-3)


@pytest.mark.gpu
def test_gpu_reports_a_limit_that_fits_257(gpu_device):
    limit = device_memory_limit(gpu_device)
    assert limit is not None and limit > 0
    if limit >= 40 * GB:
        out = fit_transfers(FlipParams(bound=128, wall=126), N257, limit)
        assert out.transfer_chunks == 0
