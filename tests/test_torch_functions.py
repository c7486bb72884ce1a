"""PyTorch port: the function objects (``models/functions.py``): probes,
passive scalar transport and flow streamlines, against the JAX package's
on the CPU in float64, and the twins of tests/test_functions.py with its
own assertions and tolerances."""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudaparticlesfoam_tpu.io import blockmesh as jblockmesh
from cudaparticlesfoam_tpu.io import polymesh as jpolymesh
from cudaparticlesfoam_tpu.models import functions as jfo
from cudaparticlesfoam_tpu.models import fv as jfv
from cudaparticlesfoam_tpu.ops import locate as jlocate
from cudaparticlesfoam_tpu_torch.io import blockmesh, polymesh
from cudaparticlesfoam_tpu_torch.models import functions as fo
from cudaparticlesfoam_tpu_torch.models import fv, simple
from cudaparticlesfoam_tpu_torch.ops import locate

from torch_port_common import CPU, PITZ, make_channel_case

QUIET = lambda *a: None  # noqa: E731


@pytest.fixture(scope="module")
def channel(tmp_path_factory):
    case = make_channel_case(tmp_path_factory.mktemp("chan"))
    path = f"{case}/system/blockMeshDict"
    return case, blockmesh.generate(path), jblockmesh.generate(path)


def _scalar_case(m, lib):
    st = lib.ScalarTransport.__new__(lib.ScalarTransport)
    st.m, st.field = m, "s"
    return st


# ---------------------------------------------------------------------------
# against JAX
# ---------------------------------------------------------------------------


def test_probes_match_jax(channel, tmp_path):
    _, pm, jpm = channel
    locs = [[0.5, 0.05, 0.005], [1.5, 0.02, 0.005], [1.99, 0.099, 0.001]]
    pr = fo.Probes(fv.fv_mesh(pm, device=CPU), locs)
    jpr = jfo.Probes(jfv.fv_mesh(jpm), locs)
    np.testing.assert_array_equal(pr.cells, jpr.cells)
    rng = np.random.default_rng(0)
    p, u = rng.normal(size=pm.n_cells), rng.normal(size=(pm.n_cells, 3))
    for t in (0.1, 0.2):
        pr.sample(t, {"p": torch.from_numpy(p), "U": u})
        jpr.sample(t, {"p": p, "U": u})
    out, jout = pr.write(str(tmp_path / "port")), jpr.write(str(tmp_path / "jax"))
    for field in ("p", "U"):
        with open(os.path.join(out, field)) as a, open(os.path.join(jout, field)) as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("source", [(0.0, 0.0), (1.0, -0.5)])
def test_scalar_transport_step_matches_jax(channel, source):
    _, pm, jpm = channel
    m, jm = fv.fv_mesh(pm, dtype="float64", device=CPU), jfv.fv_mesh(jpm, dtype=jnp.float64)
    rng = np.random.default_rng(1)
    s, flux = rng.uniform(size=m.n_cells), rng.normal(size=m.n_faces) * 1e-4
    spec = {"inlet": ("fixedValue", 1.0)}
    su, sp = source
    got = fo.scalar_transport_step(m, torch.from_numpy(s), torch.from_numpy(flux),
                                   fv.make_bcs(m, spec, 1), 1e-5, 0.02, source_su=su,
                                   source_sp=sp)
    want = jfo.scalar_transport_step(jm, jnp.asarray(s), jnp.asarray(flux),
                                     jfv.make_bcs(jm, spec, 1), 1e-5, 0.02, source_su=su,
                                     source_sp=sp)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()


def test_scalar_transport_reads_and_writes_like_jax(channel, tmp_path):
    case, pm, jpm = channel
    case2 = str(tmp_path / "s")
    shutil.copytree(case, case2)
    with open(f"{case2}/0/s", "w") as fh:
        fh.write("FoamFile { version 2.0; format ascii; class volScalarField; object s; }\n"
                 "dimensions [0 0 0 0 0 0 0];\ninternalField uniform 0.25;\nboundaryField {\n"
                 " inlet { type fixedValue; value uniform 1; }\n outlet { type zeroGradient; }\n"
                 " walls { type zeroGradient; }\n frontAndBack { type empty; }\n}\n")
    st = fo.ScalarTransport(case2, fv.fv_mesh(pm, dtype="float64", device=CPU), source_su=1.0)
    jst = jfo.ScalarTransport(case2, jfv.fv_mesh(jpm, dtype=jnp.float64), source_su=1.0)
    for k in ("a", "b"):
        np.testing.assert_array_equal(getattr(st.bcs, k).numpy(), np.asarray(getattr(jst.bcs, k)))
    flux = simple.load_flow_case(case2, pm=pm, dtype=torch.float64, device=CPU)[1].flux
    for _ in range(3):
        st.advance(flux, 0.05)
        jst.advance(jnp.asarray(flux.numpy()), 0.05)
    np.testing.assert_allclose(st.s.numpy(), np.asarray(jst.s), rtol=0, atol=1e-12)
    st.write(str(tmp_path / "port"), "3")
    jst.write(str(tmp_path / "jax"), "3")
    with open(tmp_path / "port" / "3" / "s") as a, open(tmp_path / "jax" / "3" / "s") as b:
        assert a.read() == b.read()


def test_streamlines_match_jax(channel):
    """Field lines of a sheared field through the simple engine, float64."""
    _, pm, jpm = channel
    ctrs, _ = polymesh.cell_centres_volumes(pm)
    u = np.zeros((pm.n_cells, 3))
    u[:, 0], u[:, 1] = 1.0, 0.02 * (ctrs[:, 0] - 1.0)
    tm, _ = polymesh.mesh_from_polymesh(pm, u_cells=u, dtype=np.float64, device=CPU)
    jtm, _ = jpolymesh.mesh_from_polymesh(jpm, u_cells=u, dtype=np.float64)
    seeds = [[0.1, 0.05, 0.005], [0.1, 0.03, 0.005], [0.3, 0.08, 0.002]]
    lines = fo.trace_streamlines(tm, locate.build_grid_locator(tm), seeds, 0.01, n_steps=60)
    jlines = jfo.trace_streamlines(jtm, jlocate.build_grid_locator(jtm), seeds, 0.01,
                                   n_steps=60)
    assert len(lines) == len(jlines) == 3
    for a, b in zip(lines, jlines):
        assert a.shape == np.asarray(b).shape == (61, 3)
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# twins of tests/test_functions.py
# ---------------------------------------------------------------------------


def test_probes(channel, tmp_path):
    _, pm, _ = channel
    m = fv.fv_mesh(pm, device=CPU)
    pr = fo.Probes(m, [[0.5, 0.05, 0.005], [1.5, 0.02, 0.005]])
    p = np.arange(m.n_cells, dtype=np.float64)
    u = np.tile([1.0, 2.0, 3.0], (m.n_cells, 1))
    pr.sample(0.1, {"p": p, "U": u})
    pr.sample(0.2, {"p": p + 1, "U": u})
    out = pr.write(str(tmp_path))
    txt = open(f"{out}/p").read()
    assert "Probe 0" in txt and "0.1" in txt and "0.2" in txt
    assert "(1 2 3)" in open(f"{out}/U").read()


def test_scalar_transport_unity_source(channel):
    _, pm, _ = channel
    m = fv.fv_mesh(pm, device=CPU)
    st = _scalar_case(m, fo)
    st.diffusivity, st.source_su = 0.0, 1.0
    st.bcs = fv.make_bcs(m, {}, 1)
    st.s = torch.zeros(m.n_cells, dtype=m.dtype)
    flux = torch.zeros(m.n_faces, dtype=m.dtype)
    for _ in range(10):
        st.advance(flux, 0.1)
    np.testing.assert_allclose(st.s.numpy(), 1.0, rtol=1e-4)


def test_scalar_transport_advection(channel):
    case, pm, _ = channel
    m, fst, u_bcs, *_ = simple.load_flow_case(case, pm=pm, device=CPU)
    st = _scalar_case(m, fo)
    st.diffusivity, st.source_su = 1e-6, 0.0
    st.bcs = fv.make_bcs(m, {"inlet": ("fixedValue", 1.0)}, 1)
    st.s = torch.zeros(m.n_cells, dtype=m.dtype)
    for _ in range(100):
        st.advance(fst.flux, 0.02)
    s, cc = st.s.numpy(), m.cc.numpy()
    assert s[cc[:, 0] < 0.5].mean() > 0.6
    assert (s > -1e-3).all() and (s < 1.0 + 1e-3).all()


def test_streamlines(channel):
    _, pm, _ = channel
    u = np.tile([1.0, 0.0, 0.0], (pm.n_cells, 1))
    tet_mesh, _ = polymesh.mesh_from_polymesh(pm, u_cells=u, device=CPU)
    loc = locate.build_grid_locator(tet_mesh)
    lines = fo.trace_streamlines(tet_mesh, loc, [[0.1, 0.05, 0.005], [0.1, 0.03, 0.005]],
                                 step_length=0.01, n_steps=100)
    assert len(lines) == 2
    line = np.asarray(lines[0])
    assert line[-1][0] > line[0][0] + 0.5
    np.testing.assert_allclose(line[:, 1], 0.05, atol=1e-5)


def test_streamline_function_object_from_controldict(tmp_path):
    """simple's streamLine function object (pitzDaily/system/controlDict:
    46-74): tracks.vtk under postProcessing/<name>/<time>/."""
    case = str(tmp_path / "pitz")
    shutil.copytree(PITZ, case)
    pm = blockmesh.generate(os.path.join(case, "system", "blockMeshDict"))
    polymesh.write_polymesh(pm, os.path.join(case, "constant", "polyMesh"))
    m, st, _ = simple.solve_steady(case, pm=pm, n_iters=40, log=QUIET, device=CPU)
    simple.run_streamline_functions(case, "282", st.u.numpy(), pm=pm, log=QUIET)
    out = os.path.join(case, "postProcessing", "streamlines", "282", "tracks.vtk")
    assert os.path.exists(out)
    txt = open(out).read()
    assert "POLYDATA" in txt or "LINES" in txt.upper()
