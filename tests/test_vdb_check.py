"""Third-party cross-validation of the .vdb writer: ``native/vdbcheck`` is
an INDEPENDENT from-spec archive parser (no shared code with
``io/vdb.py`` or ``native/vdbio.cc`` — see its header comment), so a
successful parse + matching voxel counts/checksums is non-self-referential
evidence of format correctness."""

import json
import os
import subprocess

import numpy as np
import pytest

from fluidsim_tpu.io import vdb
from fluidsim_tpu.io.native import NATIVE_DIR, build_native


@pytest.fixture(scope="module")
def vdbcheck():
    assert build_native("vdbcheck"), "make -C native vdbcheck failed"
    return os.path.join(NATIVE_DIR, "vdbcheck")


def _run(exe, path):
    out = subprocess.check_output([exe, path], text=True)
    recs = [json.loads(line) for line in out.strip().splitlines()]
    assert recs[-1]["ok"]
    return recs[:-1]


@pytest.mark.parametrize("comp", [vdb.COMPRESS_NONE, vdb.COMPRESS_ZIP,
                                  vdb.COMPRESS_ZIP | vdb.COMPRESS_ACTIVE_MASK,
                                  vdb.COMPRESS_BLOSC,
                                  vdb.COMPRESS_BLOSC | vdb.COMPRESS_ACTIVE_MASK])
def test_writer_parses_with_independent_parser(tmp_path, vdbcheck, comp):
    rng = np.random.default_rng(7)
    vals = rng.normal(size=(21, 13, 18)).astype(np.float32)
    act = rng.random((21, 13, 18)) > 0.45
    vals[~act] = 0.0
    v3 = rng.normal(size=(10, 10, 10, 3)).astype(np.float32)
    a3 = rng.random((10, 10, 10)) > 0.3
    v3[~a3] = 0.0
    grids = [
        vdb.VdbGrid(values=vals, origin=(-9, 4, 1), active=act, name="d"),
        vdb.VdbGrid(values=v3, active=a3, name="v",
                    background=(0.0, 0.0, 0.0)),
        vdb.VdbGrid(values=vals, active=act, name="dh", save_half=True),
    ]
    path = str(tmp_path / "x.vdb")
    vdb.write_vdb(path, grids, compression=comp)
    recs = _run(vdbcheck, path)
    assert [r["name"] for r in recs] == ["d", "v", "dh"]
    assert recs[0]["type"] == "Tree_float_5_4_3"
    assert recs[1]["type"] == "Tree_vec3s_5_4_3"
    assert recs[2]["type"] == "Tree_float_5_4_3_HalfFloat" and recs[2]["half"]

    assert recs[0]["active_voxels"] == int(act.sum())
    assert recs[1]["active_voxels"] == int(a3.sum())
    np.testing.assert_allclose(recs[0]["active_sum"],
                               vals[act].astype(np.float64).sum(), rtol=1e-6)
    np.testing.assert_allclose(recs[1]["active_sum"],
                               v3[a3].astype(np.float64).sum(), rtol=1e-6)
    np.testing.assert_allclose(
        recs[2]["active_sum"],
        vals[act].astype(np.float16).astype(np.float64).sum(), rtol=1e-6)
    assert recs[0]["bbox"] == [-9, 4, 1, 11, 16, 18]


def test_cli_output_parses(tmp_path, vdbcheck):
    """End-to-end: a CLI frame export parses with the independent parser."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from fluidsim_tpu import cli

    out = str(tmp_path / "sim")
    rc = cli.main(["fluid", "--frames", "1", "--bound", "8",
                   "--density", "2", "--out", out, "--no-accum",
                   "--echo-every", "0"])
    assert rc == 0
    recs = _run(vdbcheck, os.path.join(out, "mygrids0.vdb"))
    assert recs and recs[0]["active_voxels"] > 0


def test_value_types_parse_with_independent_parser(tmp_path, vdbcheck):
    """Int32/Bool/Double/Vec3d/... grids + an instance descriptor all parse
    with the from-spec parser, with matching checksums."""
    rng = np.random.default_rng(13)
    act = rng.random((16, 16, 16)) < 0.5
    shared = rng.standard_normal((16, 16, 16)).astype(np.float32)
    grids = [
        vdb.VdbGrid(shared, name="f", active=act),
        vdb.VdbGrid(rng.standard_normal((16, 16, 16)), name="d", active=act),
        vdb.VdbGrid(rng.integers(-5, 99, (16, 16, 16)).astype(np.int32),
                    name="i32", active=act, background=7),
        vdb.VdbGrid(rng.integers(-5, 99, (16, 16, 16)).astype(np.int64),
                    name="i64", active=act),
        vdb.VdbGrid(act.copy(), name="b", active=act, background=False),
        vdb.VdbGrid(rng.standard_normal((16, 16, 16, 3)).astype(np.float32),
                    name="v3s", active=act),
        vdb.VdbGrid(rng.standard_normal((16, 16, 16, 3)), name="v3d",
                    active=act),
        vdb.VdbGrid(rng.integers(-5, 99, (16, 16, 16, 3)).astype(np.int32),
                    name="v3i", active=act),
        vdb.VdbGrid(shared, name="f_inst", active=act),
        vdb.VdbGrid(rng.standard_normal((16, 16, 16)), name="dh", active=act,
                    save_half=True),
    ]
    for comp in (vdb.COMPRESS_NONE, vdb.COMPRESS_ZIP,
                 vdb.COMPRESS_ZIP | vdb.COMPRESS_ACTIVE_MASK):
        path = str(tmp_path / f"t{comp}.vdb")
        vdb.write_vdb(path, grids, compression=comp)
        recs = _run(vdbcheck, path)
        assert len(recs) == len(grids)
        for g, r in zip(grids, recs):
            if r.get("instance_parent"):
                assert r["instance_parent"] == "f"
                continue
            exp = float(np.asarray(g.values, np.float64)[act].sum())
            tol = (2e-2 if g.save_half else 1e-6) * max(1.0, abs(exp))
            assert abs(r["active_sum"] - exp) < tol, (g.name, r, exp)
