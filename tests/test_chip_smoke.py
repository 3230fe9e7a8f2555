"""The CPU-testable pieces of chip_smoke.py (the GPU smoke test): it
refuses a CPU device and prints no result, its result line, its KE-parity
helper, its per-frame checks, and ``--multi`` selecting only the sharded
phases."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


class FakeDevice:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


def test_refuses_a_cpu_device():
    with pytest.raises(chip_smoke.SmokeFailure, match="needs a GPU"):
        chip_smoke.require_gpu()


@pytest.mark.parametrize("argv", [[], ["--multi"]])
def test_main_on_cpu_fails_without_a_result(argv, capsys):
    assert chip_smoke.main(argv) == 1
    out, err = capsys.readouterr()
    assert '"ok"' not in out
    assert "needs a GPU" in err


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_format(count):
    line = chip_smoke.result_line([FakeDevice()] * count)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}
    assert "\n" not in line


@pytest.mark.parametrize("ours,ref,expected", [
    ([1.0e6, 2.0e6], [1.0e6, 2.0e6], [0.0, 0.0]),
    ([1.001e6, 2.0e6], [1.0e6, 2.002e6], [1e-3, 0.002 / 2.002]),
    ([0.5, 10.0], [0.0, 10.0], [0.5, 0.0]),      # floor of 1 at rest
])
def test_ke_rel_err(ours, ref, expected):
    np.testing.assert_allclose(chip_smoke.ke_rel_err(ours, ref), expected,
                               rtol=1e-9, atol=1e-12)


def test_ke_rel_err_rejects_traces_of_other_lengths():
    with pytest.raises(chip_smoke.SmokeFailure, match="trace lengths"):
        chip_smoke.ke_rel_err([1.0, 2.0], [1.0])


def test_parity_limits_as_specified():
    assert chip_smoke.FLIP_KE_REL == 1e-3
    assert (chip_smoke.MPM_KE_MEDIAN, chip_smoke.MPM_KE_MAX,
            chip_smoke.MPM_DT_RTOL) == (5e-4, 5e-3, 1e-4)
    assert chip_smoke.SHARDED_KE_REL == 2e-3


@pytest.mark.parametrize("multi,phases", [
    (False, ("flip_ref_cli", "flip_129", "apic_129", "mpm_ref", "mpm_127")),
    (True, ("sharded_flip", "sharded_mpm")),
])
def test_multi_selects_only_the_sharded_phases(multi, phases):
    assert chip_smoke.phases_for(multi) == phases


@pytest.mark.parametrize("pos,msg", [
    ([[0.0, 0.0, 5.5]], "outside the box"),
    ([[0.0, np.nan, 0.0]], "non-finite positions"),
])
def test_check_frames_flags_bad_particles(pos, msg):
    metrics = [{"kinetic_energy": 1.0, "dt": 0.1}]
    with pytest.raises(chip_smoke.SmokeFailure, match=msg):
        chip_smoke.check_frames("t", metrics, 5, np.asarray(pos))


def test_check_frames_flags_unconverged_projection():
    metrics = [{"kinetic_energy": 1.0, "dt": 0.1, "outer_iters": 100,
                "div_rms": 0.1}]
    with pytest.raises(chip_smoke.SmokeFailure, match="outer iterations"):
        chip_smoke.check_frames("t", metrics, 5, np.zeros((1, 3)),
                                max_outer=100)


def test_script_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo,
    the script exits non-zero and prints no result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_bench_refuses_the_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "bench.py", "--frames", "1"],
                         cwd=ROOT, capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode != 0
    assert "needs a GPU" in out.stderr
    assert '"value"' not in out.stdout
