"""PyTorch port: mesh tables, escape/velocity updates, seeding RNG and the
import boundary, held against the JAX package on identical inputs."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import cudaparticlesfoam_tpu.mesh as jmesh
import cudaparticlesfoam_tpu.state as jstate
import cudaparticlesfoam_tpu_torch as cpt
from cudaparticlesfoam_tpu_torch import convert
from cudaparticlesfoam_tpu_torch import mesh as tmesh
from cudaparticlesfoam_tpu_torch import state as tstate

from torch_port_common import CPU   # also caps torch at one thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _points_tets(kind):
    pts, tets, vv = tmesh.box_points_tets(4, 4, 4)
    if kind == "jitter":
        rng = np.random.default_rng(3)
        inner = np.all((pts > 1e-9) & (pts < 4 - 1e-9), axis=1)
        pts = pts + np.where(inner[:, None], rng.uniform(-0.2, 0.2, pts.shape), 0.0)
    tet_vel = vv[tets].mean(axis=1)
    return pts, tets, tet_vel, vv


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["box", "jitter"])
def test_host_payload_matches_jax(kind, dtype):
    pts, tets, tv, vv = _points_tets(kind)
    want = jmesh.from_arrays_host(pts, tets, tet_vel=tv, vert_vel=vv, dtype=dtype)
    got = tmesh.from_arrays_host(pts, tets, tet_vel=tv, vert_vel=vv, dtype=dtype)
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


def test_box_points_tets_matches_jax():
    for a, b in zip(tmesh.box_points_tets(3, 4, 5), jmesh.box_points_tets(3, 4, 5)):
        np.testing.assert_array_equal(a, b)


def test_upload_round_trip_and_jax_mesh_payload():
    jm = jmesh.box_mesh(3, 3, 3, dtype=np.float64)
    payload = convert.mesh_payload(jm)
    m = convert.to_mesh(payload, device=CPU)
    assert m.n_tets == jm.n_tets and m.dtype == torch.float64
    for k in tmesh.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(m, k).numpy(), np.asarray(getattr(jm, k)),
                                      err_msg=k)
        np.testing.assert_array_equal(m.host[k], np.asarray(getattr(jm, k)), err_msg=k)


def _tagged_payload(dtype):
    pts, tets, tv, vv = _points_tets("box")
    payload = tmesh.from_arrays_host(pts, tets, tet_vel=tv, vert_vel=vv, dtype=dtype)
    ctr = payload["points"][payload["bd_tris"]].mean(axis=1)
    payload["bd_patch"] = (ctr[:, 0] > 4 - 1e-6).astype(np.int32) + 2 * (
        ctr[:, 2] < 1e-6).astype(np.int32)
    return payload


@pytest.mark.parametrize("ids", [[1], [1, 2], []])
def test_set_boundary_escape_matches_jax(ids):
    payload = _tagged_payload(np.float64)
    jm = jmesh.set_boundary_escape(jmesh.host_to_device(dict(payload)), ids)
    tm = tmesh.set_boundary_escape(convert.to_mesh(payload, device=CPU), ids)
    np.testing.assert_array_equal(tm.tet_row.numpy(), np.asarray(jm.tet_row))
    np.testing.assert_array_equal(tm.bd_escape.numpy(), np.asarray(jm.bd_escape))
    np.testing.assert_array_equal(tm.host["tet_row"], np.asarray(jm.tet_row))
    if ids:
        assert tm.tet_row[:, 19].max() > 0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_replace_velocity_matches_jax(dtype):
    payload = _tagged_payload(dtype)
    rng = np.random.default_rng(1)
    tv = rng.normal(size=(payload["n_tets"], 3))
    jm = jmesh.replace_velocity(jmesh.host_to_device(dict(payload)), tet_vel=tv)
    tm = tmesh.replace_velocity(convert.to_mesh(payload, device=CPU), tet_vel=tv)
    np.testing.assert_array_equal(tm.tet_row.numpy(), np.asarray(jm.tet_row))
    np.testing.assert_array_equal(tm.tet_vel.numpy(), np.asarray(jm.tet_vel))
    np.testing.assert_array_equal(tm.host["tet_row"], tm.tet_row.numpy())


@pytest.mark.parametrize("n", [1, 300, 5000])
def test_owl_lcg_bit_exact(n):
    a = tstate._owl_lcg_uniform3(n)
    b = jstate._owl_lcg_uniform3(n)
    assert a.tobytes() == b.tobytes()


def test_seed_in_box_reference_matches_jax():
    a = cpt.seed_in_box(1000, (2.75,) * 3, (52.25,) * 3, dtype=np.float32, device=CPU)
    b = jstate.seed_in_box(1000, (2.75,) * 3, (52.25,) * 3, dtype=np.float32)
    assert a.pos.numpy().tobytes() == np.asarray(b.pos).tobytes()
    with pytest.raises(NotImplementedError, match="jax"):
        cpt.seed_in_box(10, (0,) * 3, (1,) * 3, method="threefry", device=CPU)


def test_locate_seeds_matches_jax():
    from cudaparticlesfoam_tpu.ops import locate as jlocate

    payload = _tagged_payload(np.float64)
    jm = jmesh.host_to_device(dict(payload))
    tm = convert.to_mesh(payload, device=CPU)
    pos = np.random.default_rng(2).uniform(-0.5, 4.5, (500, 3))
    want = np.asarray(jlocate.locate_seeds(jm, jlocate.build_grid_locator(jm), pos))
    got = cpt.locate_seeds(tm, cpt.build_grid_locator(tm),
                           torch.as_tensor(pos)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got < 0).any() and (got >= 0).any()


def test_import_pulls_in_neither_jax_nor_triton():
    code = ("import sys, cudaparticlesfoam_tpu_torch, cudaparticlesfoam_tpu_torch.ops.fused_cuda, "
            "cudaparticlesfoam_tpu_torch.convert, cudaparticlesfoam_tpu_torch.cli, "
            "cudaparticlesfoam_tpu_torch.models.uncoupled, cudaparticlesfoam_tpu_torch.io.native, "
            "cudaparticlesfoam_tpu_torch.models.coupled, "
            "cudaparticlesfoam_tpu_torch.models.pimple, "
            "cudaparticlesfoam_tpu_torch.models.dynamicmesh, "
            "cudaparticlesfoam_tpu_torch.io.checkpoint, "
            "cudaparticlesfoam_tpu_torch.parallel.sharding, "
            "cudaparticlesfoam_tpu_torch.parallel.auto, "
            "cudaparticlesfoam_tpu_torch.parallel.partition; "
            "print(sorted(m for m in ('jax', 'triton', 'cudaparticlesfoam_tpu') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


@pytest.mark.parametrize("cols", [3, 4])
def test_seed_from_file_matches_jax(tmp_path, cols):
    rng = np.random.default_rng(cols)
    rows = np.column_stack([rng.uniform(0, 4, (20, 3)), rng.integers(0, 50, 20)])[:, :cols]
    path = tmp_path / "seeds.dat"
    with open(path, "w") as fh:
        fh.write("NumParticles 20\nx y z tetID\n")
        for r in rows:
            fh.write(" ".join(f"{v:.17g}" for v in r) + "\n")
    got = cpt.seed_from_file(str(path), n=15, dtype=np.float64, device=CPU)
    want = jstate.seed_from_file(str(path), n=15, dtype=np.float64)
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    np.testing.assert_array_equal(got.tet_id.numpy(), np.asarray(want.tet_id))
    assert got.active.all() and got.step == 0
