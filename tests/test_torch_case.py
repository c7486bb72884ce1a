"""PyTorch port: case set-up (``config.py``, the ``state.py`` additions,
``models/case.py``) held against the JAX package on the same inputs: the
configs field for field, the particle file, injection on the same
uniforms, ``load_case``'s payload, time dir, ``tet_cell`` and located
seeds, the tet-mesh cache, and the seeding-window gate."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import cudaparticlesfoam_tpu.config as jconfig
import cudaparticlesfoam_tpu.mesh as jmesh
import cudaparticlesfoam_tpu.models.case as jcase
import cudaparticlesfoam_tpu.state as jstate
from cudaparticlesfoam_tpu.ops import locate as jlocate
import cudaparticlesfoam_tpu_torch as cpt
from cudaparticlesfoam_tpu_torch import config, convert
from cudaparticlesfoam_tpu_torch import mesh as tmesh
from cudaparticlesfoam_tpu_torch import state as tstate
from cudaparticlesfoam_tpu_torch.io import foamfile
from cudaparticlesfoam_tpu_torch.models import case as tcase
from cudaparticlesfoam_tpu_torch.models import uncoupled

from torch_port_common import CPU, PITZ, TJUNC, make_pitz_case   # also caps torch threads

FULL_DICT = {
    "seedingBox": [[-1.0, -2.0, -3.0], [1.0, 2.0, 3.0]], "numParticles": 1e5,
    "startTime": 5, "endTime": 9.5, "dt": 2e-4, "diffusionCoeff": 1e-3,
    "saveInterval": 25.0, "useAdvection": 0, "useBrownianMotion": 0, "reflectWall": 0,
    "saveStreamlines": 1, "velocityInterpMethod": "VertexVelocity", "locateMode": "convex",
    "rngSeed": 7.0, "seedingMethod": "threefry", "seedingFile": "seeds.dat",
    "escapePatches": ["outlet", "inlet"], "writeMeshVtk": 1, "injectionInterval": 3.0,
    "injectionCount": 11,
}
PARTICLE_DICTS = {
    "pitzDaily": os.path.join(PITZ, "system", "cudaParticlesDict"),
    "TJunction": os.path.join(TJUNC, "system", "cudaParticlesDict"),
    "full": FULL_DICT,
    "one_escape_patch": {"escapePatches": "outlet"},
    "empty": {},
}


def _dict(src):
    return foamfile.read(src) if isinstance(src, str) else dict(src)


@pytest.mark.parametrize("name", list(PARTICLE_DICTS))
def test_particles_config_and_step_config_match_jax(name):
    d = _dict(PARTICLE_DICTS[name])
    got, want = config.ParticlesConfig.from_dict(d), jconfig.ParticlesConfig.from_dict(d)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    sc, jsc = got.step_config(), want.step_config()
    assert isinstance(sc, cpt.StepConfig)
    assert dataclasses.asdict(sc) == dataclasses.asdict(jsc)


@pytest.mark.parametrize("case_dir", [PITZ, TJUNC])
def test_control_config_and_transport_match_jax(case_dir):
    got, want = config.ControlConfig.from_case(case_dir), jconfig.ControlConfig.from_case(case_dir)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert config.read_transport_properties(case_dir) == \
        jconfig.read_transport_properties(case_dir)
    assert dataclasses.asdict(config.ControlConfig.from_dict({})) == \
        dataclasses.asdict(jconfig.ControlConfig.from_dict({}))


# ---------------------------------------------------------------- state


def test_particle_file_round_trip_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    pos = rng.uniform(-1, 1, (40, 3))
    tet = rng.integers(-2, 900, 40).astype(np.int32)
    st = convert.to_state(pos, tet, dtype=np.float64, device=CPU)
    tstate.save_particle_file(str(tmp_path / "port.dat"), st)
    jstate.save_particle_file(str(tmp_path / "jax.dat"),
                              jstate.make_state(pos, tet_id=tet, dtype=np.float64))
    with open(tmp_path / "port.dat") as a, open(tmp_path / "jax.dat") as b:
        assert a.read() == b.read()
    back = cpt.seed_from_file(str(tmp_path / "port.dat"), dtype=np.float64, device=CPU)
    np.testing.assert_array_equal(back.pos.numpy(), pos)
    np.testing.assert_array_equal(back.tet_id.numpy(), tet)


@pytest.fixture(scope="module")
def box():
    """One f64 payload of box 4^3 uploaded to both packages, with their
    grid locators."""
    pts, tets, vv = tmesh.box_points_tets(4, 4, 4)
    payload = tmesh.from_arrays_host(pts, tets, tet_vel=vv[tets].mean(axis=1), vert_vel=vv,
                                     dtype=np.float64)
    m, jm = convert.to_mesh(payload, device=CPU), jmesh.host_to_device(dict(payload))
    return m, cpt.build_grid_locator(m), jm, jlocate.build_grid_locator(jm)


def _states(dead, n=48, step=13):
    rng = np.random.default_rng(4)
    pos = rng.uniform(0.3, 3.7, (n, 3))
    vel = rng.normal(size=(n, 3))
    act = np.ones(n, bool)
    act[list(dead)] = False
    tet = np.full(n, 5, np.int32)
    st = convert.to_state(pos, tet, vel=vel, active=act, step=step, seed=3, dtype=np.float64,
                          device=CPU)
    st = dataclasses.replace(st, disp=torch.full((n, 3), 0.25, dtype=torch.float64))
    jst = jstate.make_state(pos, tet_id=tet, rng_seed=3, dtype=np.float64)
    jst = dataclasses.replace(jst, vel=jax.numpy.asarray(vel), active=jax.numpy.asarray(act),
                              disp=jax.numpy.full((n, 3), 0.25), step=step)
    return st, jst


def _feed(monkeypatch, u):
    """Both packages draw ``u`` (rows as many as they ask for)."""
    monkeypatch.setattr(tstate, "_inject_uniforms",
                        lambda st, count, rng_seed: torch.as_tensor(u[:count]))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, dtype=None: jax.numpy.asarray(u[:shape[0]]))


def _assert_states_equal(st, jst):
    for f in ("pos", "vel", "disp", "tet_id", "active"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(jst, f)),
                                      err_msg=f)


# dead lanes: none, fewer than the count, more than the count
DEAD = {"none": (), "few": (3, 17, 40), "many": tuple(range(0, 48, 2))}


@pytest.mark.parametrize("dead", list(DEAD))
@pytest.mark.parametrize("device_side", [False, True])
def test_inject_matches_jax_on_the_same_uniforms(box, monkeypatch, dead, device_side):
    m, loc, jm, jloc = box
    st, jst = _states(DEAD[dead])
    u = np.random.default_rng(9).uniform(size=(8, 3))
    u[5] = [0.999, 0.999, 0.999]        # outside the box's mesh: stays dead
    _feed(monkeypatch, u)
    lo, hi = (0.2, 0.2, 0.2), (3.5, 3.9, 4.6)
    if device_side:
        got = tstate.inject_device(st, m, loc, lo, hi, 8, rng_seed=2)
        want = jstate.inject_device(jst, jm, jloc, lo, hi, 8, rng_seed=2)
    else:
        got, n_got = tstate.inject(st, m, loc, lo, hi, 8, rng_seed=2)
        want, n_want = jstate.inject(jst, jm, jloc, lo, hi, 8, rng_seed=2)
        assert n_got == n_want
    _assert_states_equal(got, want)
    if dead == "many":    # 8 slots refilled, the seeds outside the mesh stay dead
        assert 0 < int(got.active.sum()) - int(st.active.sum()) < 8


def test_injection_uniforms_are_seeded_by_seed_and_step():
    st, _ = _states(())
    u = tstate._inject_uniforms(st, 5, rng_seed=1)
    assert u.shape == (5, 3) and u.dtype == torch.float64
    assert bool(((u >= 0) & (u < 1)).all())
    assert torch.equal(u, tstate._inject_uniforms(st, 5, rng_seed=1))
    for other in (dataclasses.replace(st, step=st.step + 1), dataclasses.replace(st, seed=4)):
        assert not torch.equal(u, tstate._inject_uniforms(other, 5, rng_seed=1))
    assert not torch.equal(u, tstate._inject_uniforms(st, 5, rng_seed=2))


# ---------------------------------------------------------------- case


@pytest.fixture(scope="module")
def shear_case(tmp_path_factory):
    """The shrunk pitzDaily case of the driver anchor, loaded by both
    packages in float64 (one mesh build each for the file)."""
    case_dir = make_pitz_case(tmp_path_factory.mktemp("case"), shear=True)
    quiet = lambda *a: None  # noqa: E731
    c = tcase.load_case(case_dir, dtype=np.float64, log=quiet, device=CPU)
    jc = jcase.load_case(case_dir, dtype=np.float64, log=quiet)
    return case_dir, c, jc


def test_load_case_matches_jax(shear_case):
    case_dir, c, jc = shear_case
    assert (c.time_value, c.time_dir, c.patch_names) == (jc.time_value, jc.time_dir,
                                                         jc.patch_names)
    assert (c.time_value, c.time_dir) == (282.0, "282")
    assert dataclasses.asdict(c.control) == dataclasses.asdict(jc.control)
    assert dataclasses.asdict(c.particles) == dataclasses.asdict(jc.particles)
    np.testing.assert_array_equal(c.tet_cell, jc.tet_cell)
    want = convert.mesh_payload(jc.tet_mesh)
    for k in tmesh.ARRAY_FIELDS:
        np.testing.assert_array_equal(c.tet_mesh.host[k], want[k], err_msg=k)
        np.testing.assert_array_equal(getattr(c.tet_mesh, k).numpy(), want[k], err_msg=k)
    for k in tmesh.META_FIELDS:
        assert getattr(c.tet_mesh, k) == want[k], k
    assert c.tet_mesh.n_tets == 146_700 and c.tet_mesh.device == CPU
    assert c.locator.shape == jc.locator.shape
    np.testing.assert_array_equal(c.locator.cell_tet.numpy(), np.asarray(jc.locator.cell_tet))
    assert tcase.time_dirs(case_dir) == jcase.time_dirs(case_dir)
    np.testing.assert_array_equal(
        tcase.read_u_snapshot(case_dir, "282", c.poly.n_cells),
        jcase.read_u_snapshot(case_dir, "282", jc.poly.n_cells))
    assert tcase.read_u_snapshot(case_dir, "0.5", 3) is None


def test_init_particles_matches_jax(shear_case):
    _, c, jc = shear_case
    logs, jlogs = [], []
    st = tcase.init_particles(c, log=logs.append)
    jst = jcase.init_particles(jc, log=jlogs.append)
    np.testing.assert_array_equal(st.pos.numpy(), np.asarray(jst.pos))
    np.testing.assert_array_equal(st.tet_id.numpy(), np.asarray(jst.tet_id))
    assert (st.tet_id >= 0).all() and st.n_particles == 200
    assert logs == jlogs


def test_builder_flavor_matches_jax():
    assert tcase._builder_flavor() == jcase._builder_flavor()


def test_tet_mesh_cache_round_trip_and_separation(shear_case, tmp_path):
    """Twin of tests/test_cases.py::test_tet_mesh_cache_roundtrip, plus:
    the port's cache has its own file, and neither package restores the
    other's."""
    from cudaparticlesfoam_tpu_torch.io import blockmesh, polymesh

    case_dir = make_pitz_case(tmp_path, num_particles=10)
    pm = blockmesh.generate(os.path.join(case_dir, "system", "blockMeshDict"))
    polymesh.write_polymesh(pm, os.path.join(case_dir, "constant", "polyMesh"))
    mesh_dir = os.path.join(case_dir, "constant", "polyMesh")
    jlogs = []
    jcase._cached_tet_mesh(case_dir, pm, None, jlogs.append, min_build_s=0.0)
    assert os.path.exists(os.path.join(mesh_dir, ".tetmesh_cache.pkl"))

    def logged(fn, *a, **kw):
        out = []
        res = fn(*a, lambda *m: out.append(" ".join(map(str, m))), **kw)
        return res, any("restored from cache" in ln for ln in out)

    (m1, tc1), restored = logged(tcase._cached_tet_mesh, case_dir, pm, None, min_build_s=0.0,
                                 device=CPU)
    assert not restored                      # the JAX package's pickle is not read
    assert os.path.exists(os.path.join(mesh_dir, tcase.CACHE_NAME))
    (m2, tc2), restored = logged(tcase._cached_tet_mesh, case_dir, pm, None, device=CPU)
    assert restored
    np.testing.assert_array_equal(m2.tet_row.numpy(), m1.tet_row.numpy())
    np.testing.assert_array_equal(tc2, tc1)
    os.remove(os.path.join(mesh_dir, ".tetmesh_cache.pkl"))
    _, restored = logged(jcase._cached_tet_mesh, case_dir, pm, None)
    assert not restored                      # nor does JAX read the port's
    # a geometry change invalidates the fingerprint
    pm.points = pm.points * 1.001
    _, restored = logged(tcase._cached_tet_mesh, case_dir, pm, None, min_build_s=0.0,
                         device=CPU)
    assert not restored


def test_seeding_window_gate(tmp_path):
    """Twin of tests/test_cases.py::test_seeding_window_gate: the latest
    time outside [startTime, endTime] runs no cycle and writes frame 0."""
    case_dir = make_pitz_case(tmp_path, num_particles=50, u_time="50")
    out = tmp_path / "out"
    out.mkdir()
    _, st, stats = uncoupled.run(case_dir, out_dir=str(out), log=lambda *a: None, device=CPU)
    assert stats["cycles"] == 0 and st.step == 0
    assert os.listdir(out) == ["particle_0000.vtu"]
