"""PyTorch port: the I/O layer (``io/foamfile.py``, ``io/native.py``,
``io/blockmesh.py``, ``io/polymesh.py``, ``io/vtu.py``) and
``mesh.read_dataset``, each held against its JAX original on the same
inputs: equal parsed dicts and written bytes, equal ``PolyMesh`` arrays,
equal tet payloads, byte-identical VTU/VTK output on both writer paths."""

import glob
import os
import types

import numpy as np
import pytest
import torch

import cudaparticlesfoam_tpu.io.blockmesh as jblockmesh
import cudaparticlesfoam_tpu.io.foamfile as jfoamfile
import cudaparticlesfoam_tpu.io.native as jnative
import cudaparticlesfoam_tpu.io.polymesh as jpolymesh
import cudaparticlesfoam_tpu.io.vtu as jvtu
import cudaparticlesfoam_tpu.mesh as jmesh
import cudaparticlesfoam_tpu_torch as cpt
from cudaparticlesfoam_tpu_torch import convert
from cudaparticlesfoam_tpu_torch import mesh as tmesh
from cudaparticlesfoam_tpu_torch.io import blockmesh, foamfile, native, polymesh, vtu

from torch_port_common import CPU, PITZ, REPO, TJUNC   # also caps torch at one thread

DICTS = sorted(
    os.path.relpath(p, REPO)
    for case in (PITZ, TJUNC)
    for p in glob.glob(os.path.join(case, "*", "*"))
    if os.path.isfile(p) and os.path.basename(os.path.dirname(p)) in ("0", "constant", "system")
)
POLY_FIELDS = ("points", "face_verts", "face_offsets", "owner", "neighbour")


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _outcome(fn, *a):
    """fn(*a), or the message of the ValueError it raises."""
    try:
        return fn(*a)
    except ValueError as exc:
        return f"ValueError: {exc}"


# ---------------------------------------------------------------- foamfile


def test_every_tutorial_dict_is_listed():
    assert len(DICTS) >= 25
    assert "tutorials/incompressible/cudaParticlesUncoupledFoam/pitzDaily/system/" \
        "cudaParticlesDict" in DICTS


@pytest.mark.parametrize("rel", DICTS)
def test_foamfile_parse_and_write_match_jax(tmp_path, rel):
    path = os.path.join(REPO, rel)
    got = _outcome(foamfile.read, path)
    assert got == _outcome(jfoamfile.read, path)
    if isinstance(got, str):
        assert "#includeEtc" in got     # the one directive neither parser reads
        return
    body = {k: v for k, v in got.items() if k != "FoamFile"}
    foamfile.write(str(tmp_path / "port"), body, obj_name=os.path.basename(rel))
    jfoamfile.write(str(tmp_path / "jax"), body, obj_name=os.path.basename(rel))
    assert _read(tmp_path / "port") == _read(tmp_path / "jax")
    # and it reads back as the JAX package reads it (the writer covers the
    # ascii subset: a dict nested in a list does not round-trip in either)
    back = str(tmp_path / "port")
    assert _outcome(foamfile.read, back) == _outcome(jfoamfile.read, back)


def test_foamfile_helpers_match_jax():
    scope = {"a": 1.5, "b": [1, 2]}
    for v in ("$a", ["$a", "x", ["$b"]], 3):
        assert foamfile.expand_macros(v, scope) == jfoamfile.expand_macros(v, scope)
    d = {"n": 1e5, "s": "word", "f": 2}
    for key, default in (("n", 1000), ("n", 1.0), ("s", "x"), ("missing", 7), ("f", 0.5)):
        got, want = foamfile.get_or_default(d, key, default), \
            jfoamfile.get_or_default(d, key, default)
        assert got == want and type(got) is type(want)
    text = 'a 1; /* c */ b (1 2 (3 4)); // x\nc [0 1 -1 0 0 0 0]; d { e "q"; }'
    assert foamfile.tokenize(text) == jfoamfile.tokenize(text)
    assert foamfile.parse(text) == jfoamfile.parse(text)


# ---------------------------------------------------------------- native


def test_native_parsers_match_jax():
    if native._load("fastio") is None or jnative._build_and_load() is None:
        pytest.skip("no g++: both packages take their pure-Python paths")
    rng = np.random.default_rng(0)
    vals = rng.normal(size=300) * 10.0 ** rng.integers(-8, 8, 300)
    text = "(" + "\n".join(f"({v:.17g} {w:.17g};)" for v, w in zip(vals, vals[::-1])) + ")"
    got = native.parse_doubles(text)
    np.testing.assert_array_equal(got, jnative.parse_doubles(text))
    assert len(got) == 600
    ints = rng.integers(-2**40, 2**40, 500)
    text = "(" + " ".join(map(str, ints)) + ")\n"
    np.testing.assert_array_equal(native.parse_longs(text), jnative.parse_longs(text))
    np.testing.assert_array_equal(native.parse_longs(text), ints)


def test_native_libraries_live_in_the_ports_build_dir():
    if native._load("meshbuild") is None:
        pytest.skip("no g++")
    built = os.listdir(native.BUILD_DIR)
    assert any(f.startswith("libmeshbuild_") and f.endswith(".so") for f in built)
    assert os.path.commonpath([native.BUILD_DIR, os.path.join(REPO, "build")]) == \
        os.path.join(REPO, "build")


# ---------------------------------------------------------------- blockMesh

ANNULUS = """
FoamFile { version 2.0; format ascii; class dictionary; object blockMeshDict; }
scale 1;
vertices ( (1 0 0) (2 0 0) (0 2 0) (0 1 0) (1 0 0.1) (2 0 0.1) (0 2 0.1) (0 1 0.1) );
blocks ( hex (0 1 2 3 4 5 6 7) (4 8 1) simpleGrading (1 1 1) );
edges (
 arc 0 3 (0.70710678 0.70710678 0)
 arc 1 2 (1.41421356 1.41421356 0)
 arc 4 7 (0.70710678 0.70710678 0.1)
 arc 5 6 (1.41421356 1.41421356 0.1)
);
boundary (
 inner { type wall; faces ((0 4 7 3)); }
 outer { type wall; faces ((1 2 6 5)); }
 start { type patch; faces ((0 1 5 4)); }
 end   { type patch; faces ((3 7 6 2)); }
 frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); }
);
"""
KNOTS = "((0.92387953 0.38268343 0) (0.70710678 0.70710678 0) (0.38268343 0.92387953 0))"
BLOCK_DICTS = {
    "pitzDaily": os.path.join(PITZ, "system", "blockMeshDict"),
    "TJunction": os.path.join(TJUNC, "system", "blockMeshDict"),
    "arc": ANNULUS,
    "polyLine": ANNULUS.replace("arc 0 3 (0.70710678 0.70710678 0)", f"polyLine 0 3 {KNOTS}"),
    "spline": ANNULUS.replace("arc 0 3 (0.70710678 0.70710678 0)", f"spline 0 3 {KNOTS}"),
}


def _assert_polymesh_equal(got, want):
    for f in POLY_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.patches == want.patches
    assert (got.n_cells, got.n_internal_faces) == (want.n_cells, want.n_internal_faces)


@pytest.mark.parametrize("name", list(BLOCK_DICTS))
def test_blockmesh_generate_matches_jax(name):
    _assert_polymesh_equal(blockmesh.generate(BLOCK_DICTS[name]),
                           jblockmesh.generate(BLOCK_DICTS[name]))


# ---------------------------------------------------------------- polyMesh


@pytest.fixture(scope="module")
def pitz():
    """(port PolyMesh, JAX PolyMesh) of the pitzDaily blockMeshDict, built
    once for the file."""
    return blockmesh.generate(BLOCK_DICTS["pitzDaily"]), jblockmesh.generate(
        BLOCK_DICTS["pitzDaily"])


@pytest.mark.parametrize("binary", [False, True])
def test_polymesh_write_read_matches_jax(tmp_path, pitz, binary):
    pm, jpm = pitz
    polymesh.write_polymesh(pm, str(tmp_path / "port"), binary=binary)
    jpolymesh.write_polymesh(jpm, str(tmp_path / "jax"), binary=binary)
    for f in sorted(os.listdir(tmp_path / "jax")):
        assert _read(tmp_path / "port" / f) == _read(tmp_path / "jax" / f), f
    back, jback = (polymesh.read_polymesh(str(tmp_path / "port")),
                   jpolymesh.read_polymesh(str(tmp_path / "jax")))
    _assert_polymesh_equal(back, jback)
    _assert_polymesh_equal(back, pm) if binary else np.testing.assert_allclose(
        back.points, pm.points, rtol=1e-10)


@pytest.mark.parametrize("binary,compress", [(False, False), (True, False), (False, True)])
def test_field_write_read_matches_jax(tmp_path, binary, compress):
    vals = np.linspace(-2.0, 7.0, 30).reshape(10, 3)
    bf = {"inlet": {"type": "fixedValue", "value": "uniform (1 0 0)"},
          "walls": {"type": "zeroGradient"}}
    paths = {}
    for tag, mod in (("port", polymesh), ("jax", jpolymesh)):
        paths[tag] = str(tmp_path / tag)
        mod.write_field(paths[tag], "U", vals, boundary_field=bf, binary=binary,
                        compress=compress)
    suffix = ".gz" if compress else ""
    if not compress:    # gzip stamps the time into its header
        assert _read(paths["port"] + suffix) == _read(paths["jax"] + suffix)
    got, want = polymesh.read_field(paths["port"]), jpolymesh.read_field(paths["jax"])
    np.testing.assert_array_equal(got, want)
    # binary: raw doubles; ascii: the writers' 10 significant digits
    np.testing.assert_allclose(got, vals, rtol=0 if binary else 1e-9)
    if not compress:
        assert polymesh.read_field_bcs(paths["port"]).keys() == \
            jpolymesh.read_field_bcs(paths["jax"]).keys()


def test_uniform_field_and_latest_time_dir_match_jax(tmp_path):
    p = str(tmp_path / "U")
    with open(p, "w") as fh:
        fh.write("FoamFile\n{\nobject U;\n}\ninternalField uniform (1 2 3);\n")
    np.testing.assert_array_equal(polymesh.read_field(p, n_cells=5),
                                  jpolymesh.read_field(p, n_cells=5))
    for name in ("0", "0.5", "282", "constant", "system", "12.25"):
        (tmp_path / name).mkdir(exist_ok=True)
    assert polymesh.latest_time_dir(str(tmp_path)) == jpolymesh.latest_time_dir(str(tmp_path))


@pytest.mark.parametrize("binary", [False, True])
def test_surface_field_matches_jax(tmp_path, binary):
    rng = np.random.default_rng(3)
    patches = [("inlet", "patch", 0, 4), ("walls", "wall", 4, 6)]
    internal = rng.normal(size=50)
    bd = {"inlet": rng.normal(size=4), "walls": rng.normal(size=6)}
    polymesh.write_surface_field(str(tmp_path / "port"), "phi", internal, bd, binary=binary)
    jpolymesh.write_surface_field(str(tmp_path / "jax"), "phi", internal, bd, binary=binary)
    assert _read(tmp_path / "port") == _read(tmp_path / "jax")
    np.testing.assert_array_equal(polymesh.read_surface_field(str(tmp_path / "port"), patches),
                                  jpolymesh.read_surface_field(str(tmp_path / "jax"), patches))


def test_cell_zones_match_jax(tmp_path):
    zones = {"porous": np.arange(0, 40, 3), "rotor": np.array([1, 5, 7])}
    for tag in ("port", "jax"):
        os.makedirs(tmp_path / tag)
    polymesh.write_cell_zones(zones, str(tmp_path / "port"))
    jpolymesh.write_cell_zones(zones, str(tmp_path / "jax"))
    assert _read(tmp_path / "port" / "cellZones") == _read(tmp_path / "jax" / "cellZones")
    got, want = (polymesh.read_cell_zones(str(tmp_path / "port")),
                 jpolymesh.read_cell_zones(str(tmp_path / "jax")))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_geometry_and_tet_decomposition_match_jax(pitz):
    pm, jpm = pitz
    for got, want in zip(polymesh.face_centres_areas(pm), jpolymesh.face_centres_areas(jpm)):
        np.testing.assert_array_equal(got, want)
    ctrs, vols = polymesh.cell_centres_volumes(pm)
    jctrs, jvols = jpolymesh.cell_centres_volumes(jpm)
    np.testing.assert_array_equal(ctrs, jctrs)
    np.testing.assert_array_equal(vols, jvols)
    np.testing.assert_array_equal(polymesh.face_base_points(pm, ctrs),
                                  jpolymesh.face_base_points(jpm, jctrs))
    for got, want in zip(polymesh.tet_decompose(pm, ctrs), jpolymesh.tet_decompose(jpm, jctrs)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_mesh_host_from_polymesh_matches_jax(pitz, dtype):
    pm, jpm = pitz
    u = np.random.default_rng(1).normal(size=(pm.n_cells, 3))
    got, tc = polymesh.mesh_host_from_polymesh(pm, u_cells=u, dtype=dtype)
    want, jtc = jpolymesh.mesh_host_from_polymesh(jpm, u_cells=u, dtype=dtype)
    np.testing.assert_array_equal(tc, jtc)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    assert got["n_tets"] == 146_700 and len(np.unique(got["bd_patch"])) > 1


# ---------------------------------------------------------------- VTU / VTK


def _frame(n=57, seed=0, dead=()):
    """(port state on the CPU, numpy namespace for the JAX writers)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (n, 3))
    vel = rng.normal(size=(n, 3))
    vel[3] = 0.0                      # a zero-KE lane (the quirk's other branch)
    tet = rng.integers(-3, 500, n).astype(np.int32)
    act = np.ones(n, bool)
    act[list(dead)] = False
    st = convert.to_state(pos, tet, vel=vel, active=act, dtype=np.float64, device=CPU)
    return st, types.SimpleNamespace(pos=pos, vel=vel, tet_id=tet, active=act)


@pytest.mark.parametrize("path_kind", ["native", "python", "convex", "no_quirk"])
def test_vtu_frames_match_jax(tmp_path, monkeypatch, path_kind):
    st, ref = _frame(dead=(5, 9))
    kw = {}
    if path_kind == "python":
        monkeypatch.setattr(native, "write_particles_vtu", lambda *a, **k: False)
        monkeypatch.setattr(jnative, "write_particles_vtu", lambda *a, **k: False)
    elif path_kind == "convex":
        kw["convex_tet_id"] = st.tet_id
    elif path_kind == "no_quirk":
        kw["reference_quirks"] = False
    p = vtu.write_particles_vtu(3, st, out_dir=str(tmp_path / "port"), **kw)
    jkw = dict(kw)
    if "convex_tet_id" in jkw:
        jkw["convex_tet_id"] = ref.tet_id
    q = jvtu.write_particles_vtu(3, ref, out_dir=str(tmp_path / "jax"), **jkw)
    assert os.path.basename(p) == os.path.basename(q) == "particle_0003.vtu"
    assert _read(p) == _read(q)
    assert vtu.system_kinetic_energy(st) == jvtu.system_kinetic_energy(ref)


def test_native_and_python_vtu_paths_agree(tmp_path, monkeypatch):
    if native._load("fastio") is None:
        pytest.skip("no g++: only the pure-Python writer exists")
    st, _ = _frame(n=200, seed=4, dead=(0, 199))
    a = vtu.write_particles_vtu(str(tmp_path / "a.vtu"), st)
    monkeypatch.setattr(native, "write_particles_vtu", lambda *a, **k: False)
    b = vtu.write_particles_vtu(str(tmp_path / "b.vtu"), st)
    assert _read(a) == _read(b)


def test_async_writer_copies_the_frame_before_returning(tmp_path):
    st, ref = _frame(n=300, seed=2)
    w = vtu.AsyncVTUWriter()
    path = w.write(7, st, out_dir=str(tmp_path / "async"))
    # the caller's next chunk reuses the state's memory at once
    st.pos.fill_(123.0)
    st.vel.zero_()
    st.tet_id.fill_(-9)
    w.close()
    want = jvtu.write_particles_vtu(7, ref, out_dir=str(tmp_path / "jax"))
    assert _read(path) == _read(want)


def test_obj_and_trajectories_match_jax(tmp_path):
    st, ref = _frame(n=6, seed=5, dead=(2,))
    assert _read(vtu.write_particles_obj(4, st, out_dir=str(tmp_path))) == _read(
        jvtu.write_particles_obj(str(tmp_path / "j.obj"), ref))
    tr, jtr = vtu.Trajectories(6), jvtu.Trajectories(6)
    for i in range(3):
        pos = ref.pos + i
        tr.append(types.SimpleNamespace(pos=torch.as_tensor(pos), active=st.active))
        jtr.append(types.SimpleNamespace(pos=pos, active=ref.active))
    for ext, save, jsave in (("obj", tr.save_obj, jtr.save_obj),
                             ("vtk", tr.save_vtk, jtr.save_vtk)):
        save(str(tmp_path / f"p.{ext}"))
        jsave(str(tmp_path / f"j.{ext}"))
        assert _read(tmp_path / f"p.{ext}") == _read(tmp_path / f"j.{ext}"), ext


@pytest.mark.parametrize("boundary_only", [True, False])
def test_mesh_vtk_writers_match_jax(tmp_path, boundary_only):
    pts, tets, vv = tmesh.box_points_tets(2, 3, 2)
    payload = tmesh.from_arrays_host(pts, tets, vert_vel=vv, dtype=np.float64)
    m, jm = convert.to_mesh(payload, device=CPU), jmesh.host_to_device(dict(payload))
    vtu.write_tet_mesh_vtk(str(tmp_path / "p.vtk"), m)
    jvtu.write_tet_mesh_vtk(str(tmp_path / "j.vtk"), jm)
    assert _read(tmp_path / "p.vtk") == _read(tmp_path / "j.vtk")
    vtu.write_face_mesh_vtk(str(tmp_path / "pf.vtk"), m, boundary_only=boundary_only)
    jvtu.write_face_mesh_vtk(str(tmp_path / "jf.vtk"), jm, boundary_only=boundary_only)
    assert _read(tmp_path / "pf.vtk") == _read(tmp_path / "jf.vtk")


# ---------------------------------------------------------------- read_dataset


def test_read_dataset_ascii_matches_jax(tmp_path):
    """Twin of tests/test_mesh.py::test_read_dataset_ascii."""
    vert, cell, solc = tmp_path / "vert.dat", tmp_path / "cell.dat", tmp_path / "solc.dat"
    vert.write_text("NumTetVerts = 4\nx y z\n0 0 0\n1 0 0\n0 1 0\n0 0 1\n")
    # negative-volume winding on purpose: the reader must fix it
    cell.write_text("NumTetCells = 1\nid1 id2 id3 id4\n1 0 2 3\n")
    solc.write_text("p u v w\n-0.5 1.0 2.0 3.0\n")
    m = tmesh.read_dataset(str(vert), str(cell), solc_fname=str(solc), dtype=np.float64,
                           device=CPU)
    jm = jmesh.read_dataset(str(vert), str(cell), solc_fname=str(solc), dtype=np.float64)
    assert m.n_tets == 1 and m.n_points == 4
    np.testing.assert_allclose(m.tet_vel.numpy()[0], [1.0, 2.0, 3.0])
    want = convert.mesh_payload(jm)
    for k in tmesh.ARRAY_FIELDS:
        np.testing.assert_array_equal(m.host[k], want[k], err_msg=k)
    pts, t = m.points.numpy(), m.tets.numpy()[0]
    a, b, c, d = pts[t[0]], pts[t[1]], pts[t[2]], pts[t[3]]
    assert np.dot(d - a, np.cross(b - a, c - a)) > 0


def test_dataset_pk_pipeline_matches_jax(tmp_path):
    """Twin of tests/test_mesh.py::test_dataset_pk_pipeline: a per-vertex
    solution through read_dataset, with_pk_rows and one VertexVelocity
    cycle of the cached engine; u = (x, 0, 0) is exact under P1, so a
    particle moves by x dt."""
    pts, tets, _ = tmesh.box_points_tets(2, 1, 1)
    vert, cell, solv = tmp_path / "vert.dat", tmp_path / "cell.dat", tmp_path / "solv.dat"
    vert.write_text(f"NumTetVerts = {len(pts)}\nx y z\n"
                    + "\n".join(" ".join(f"{v:.17g}" for v in p) for p in pts) + "\n")
    cell.write_text(f"NumTetCells = {len(tets)}\nid1 id2 id3 id4\n"
                    + "\n".join(" ".join(map(str, t)) for t in tets) + "\n")
    solv.write_text("p u v w\n" + "\n".join(f"0 {p[0]:.17g} 0 0" for p in pts) + "\n")
    m = tmesh.with_pk_rows(tmesh.read_dataset(str(vert), str(cell), solv_fname=str(solv),
                                              dtype=np.float64, device=CPU))
    jm = jmesh.with_pk_rows(jmesh.read_dataset(str(vert), str(cell), solv_fname=str(solv),
                                               dtype=np.float64))
    np.testing.assert_array_equal(m.host["tet_row_pk"], np.asarray(jm.tet_row_pk))
    pos0 = np.array([[0.25, 0.5, 0.5], [1.5, 0.3, 0.7], [0.9, 0.9, 0.1]])
    p0 = torch.as_tensor(pos0)
    st = cpt.make_state(pos0, tet_id=cpt.locate_seeds(m, cpt.build_grid_locator(m), p0),
                        dtype=np.float64, device=CPU)
    dt = 0.05
    cfg = cpt.StepConfig(dt=dt, use_brownian=False, velocity_interp="VertexVelocity")
    assert cfg.resolved_engine() == "cached"
    out = cpt.run_cycles(m, st, cfg, 1)
    np.testing.assert_allclose(out.pos.numpy()[:, 0], pos0[:, 0] * (1 + dt), rtol=1e-12)
    np.testing.assert_allclose(out.pos.numpy()[:, 1:], pos0[:, 1:], atol=1e-15)
