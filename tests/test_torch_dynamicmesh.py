"""PyTorch port: the moving-mesh branch (``models/dynamicmesh.py``,
``models/motionsolver.py``, ``mesh.refresh_geometry``) — the twins of
tests/test_dynamicmesh.py on the CPU (cases built with the port's io only,
torch_port_common), and parity with the JAX package: the device-side
refresh of the walk tables against JAX's and against a rebuild from the
moved points (float64, within 1e-12), and the mesh motion, swept flux and
moving-wall velocity of both packages from one case."""

from torch_port_common import (CPU, FakeCase, OSC_BOX_BMD, TWO_ZONE_BMD,
                               make_motion_solver_case, make_oscillating_case, write_files)

import math  # noqa: E402
import os  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import cudaparticlesfoam_tpu_torch as cpt  # noqa: E402
from cudaparticlesfoam_tpu_torch import mesh as tmesh  # noqa: E402
from cudaparticlesfoam_tpu_torch.io import blockmesh, polymesh  # noqa: E402
from cudaparticlesfoam_tpu_torch.models import dynamicmesh as dyn  # noqa: E402
from cudaparticlesfoam_tpu_torch.models import fv  # noqa: E402

F64 = torch.float64
REFRESH_TOL = 1e-12


def _moved_box(n=3, dtype=None):
    mesh = cpt.box_mesh(n, n, n, dtype=dtype, device=CPU)
    rot = dyn._rodrigues(np.array([0.0, 0.0, 1.0]), 0.3)
    pts = mesh.host["points"].astype(np.float64) @ rot.T + np.array([0.5, -0.2, 0.1])
    return mesh, pts


def test_refresh_geometry_matches_rebuild():
    """Twin of tests/test_dynamicmesh.py::test_refresh_geometry_matches_rebuild
    (float32, its tolerances), and float64 within 1e-12 for every row table
    the mesh holds (tet_row, tet_row_pk32, tet_row_cx, tet_row_cxe)."""
    mesh, pts_new = _moved_box()
    moved = tmesh.refresh_geometry(mesh, pts_new)
    rebuilt = tmesh.from_arrays(pts_new, mesh.host["tets"], tet_vel=mesh.host["tet_vel"],
                                device=CPU)
    np.testing.assert_allclose(moved.tet_a.numpy(), rebuilt.tet_a.numpy(), atol=1e-6)
    np.testing.assert_allclose(moved.tet_tinv.numpy(), rebuilt.tet_tinv.numpy(), atol=1e-5)
    np.testing.assert_allclose(moved.tet_row.numpy(), rebuilt.tet_row.numpy(), atol=1e-5)
    np.testing.assert_allclose(moved.tet_face_d.numpy(), rebuilt.tet_face_d.numpy(), atol=1e-6)
    np.testing.assert_array_equal(moved.tet_nbr.numpy(), mesh.tet_nbr.numpy())

    mesh, pts_new = _moved_box(4, np.float64)
    full = cpt.with_pk_rows(cpt.with_convex_rows(mesh))
    moved = tmesh.refresh_geometry(full, pts_new)
    rebuilt = cpt.with_pk_rows(cpt.with_convex_rows(tmesh.from_arrays(
        pts_new, mesh.host["tets"], tet_vel=mesh.host["tet_vel"],
        vert_vel=mesh.host["vert_vel"], dtype=np.float64, device=CPU)))
    for k in ("points", "tet_a", "tet_tinv", "tet_face_n", "tet_face_d", "tet_row",
              "tet_row_pk32", "tet_row_cx", "tet_row_cxe", "bounds_lo", "bounds_hi"):
        np.testing.assert_allclose(getattr(moved, k).numpy(), getattr(rebuilt, k).numpy(),
                                   atol=REFRESH_TOL, rtol=0, err_msg=k)
        if k in moved.host:
            np.testing.assert_array_equal(moved.host[k], getattr(moved, k).numpy(), k)
    # the host payload follows: a later velocity refresh keeps the new geometry
    again = cpt.replace_velocity(moved, tet_vel=np.ones((mesh.n_tets, 3)))
    np.testing.assert_array_equal(again.tet_row[:, :12].numpy(), moved.tet_row[:, :12].numpy())


def test_refresh_geometry_matches_jax():
    import cudaparticlesfoam_tpu.mesh as jmesh

    mesh, pts_new = _moved_box(4, np.float64)
    full = cpt.with_pk_rows(cpt.with_convex_rows(mesh))
    from cudaparticlesfoam_tpu_torch import convert

    jm = jmesh.with_pk_rows(jmesh.with_convex_rows(jmesh.host_to_device(
        convert.mesh_payload(mesh))))
    want = jmesh.refresh_geometry(jm, pts_new)
    got = tmesh.refresh_geometry(full, pts_new)
    for k in ("points", "tet_a", "tet_tinv", "tet_face_n", "tet_face_d", "tet_row",
              "tet_row_pk", "tet_row_cx", "tet_row_cxe", "bounds_lo", "bounds_hi"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   atol=REFRESH_TOL, rtol=0, err_msg=k)


def test_motion_functions():
    p = np.array([[1.0, 0.0, 0.0]])
    lin = dyn.SolidBodyMotion(kind="linearMotion", velocity=(2.0, 0.0, 0.0))
    np.testing.assert_allclose(lin.transform(p, 1.5), [[4.0, 0.0, 0.0]])
    rot = dyn.SolidBodyMotion(kind="rotatingMotion", omega=math.pi / 2)
    np.testing.assert_allclose(rot.transform(p, 1.0), [[0.0, 1.0, 0.0]], atol=1e-12)
    osc = dyn.SolidBodyMotion(kind="oscillatingLinearMotion", amplitude=(0.0, 0.5, 0.0),
                              omega=math.pi)
    np.testing.assert_allclose(osc.transform(p, 0.5), [[1.0, 0.5, 0.0]], atol=1e-12)
    np.testing.assert_allclose(osc.transform(p, 1.0), p, atol=1e-12)


def test_read_dynamic_mesh(tmp_path):
    write_files(tmp_path, {"constant/dynamicMeshDict":
                           "FoamFile { version 2.0; format ascii; class dictionary; "
                           "object dynamicMeshDict; }\n"
                           "dynamicFvMesh solidBodyMotionFvMesh;\n"
                           "solidBodyMotionFunction oscillatingLinearMotion;\n"
                           "oscillatingLinearMotionCoeffs { amplitude (0 0.1 0); omega 3.14; }\n"})
    m = dyn.read_dynamic_mesh(str(tmp_path))
    assert m.kind == "oscillatingLinearMotion"
    assert m.amplitude == (0.0, 0.1, 0.0)
    assert m.omega == pytest.approx(3.14)


def test_read_static_returns_none(tmp_path):
    assert dyn.read_dynamic_mesh(str(tmp_path)) is None
    write_files(tmp_path, {"constant/dynamicMeshDict":
                           "FoamFile { object dynamicMeshDict; }\ndynamicFvMesh staticFvMesh;\n"})
    assert dyn.read_dynamic_mesh(str(tmp_path)) is None


def test_mesh_phi_rigid_translation(tmp_path):
    (tmp_path / "blockMeshDict").write_text(OSC_BOX_BMD)
    pm = blockmesh.generate(str(tmp_path / "blockMeshDict"))
    motion = dyn.SolidBodyMotion(kind="linearMotion", velocity=(0.7, 0.0, 0.0))
    dm = dyn.DynamicMesh(motion, pm, dtype=F64, device=CPU)
    m_new, mesh_phi, bd_vel = dm.update(t_new=0.1, dt=0.1)
    # translation: meshPhi = v . Sf exactly, wall velocity = v
    np.testing.assert_allclose(mesh_phi.numpy(), m_new.sf.numpy()[:, 0] * 0.7, atol=1e-9)
    np.testing.assert_allclose(bd_vel.numpy(), np.tile([0.7, 0.0, 0.0], (len(bd_vel), 1)),
                               atol=1e-9)
    # swept flux sums to zero per cell (space conservation, rigid motion)
    assert float(fv.surface_sum(m_new, mesh_phi).abs().max()) < 1e-9


def test_coupled_oscillating_box(tmp_path):
    """Full coupled run on a rigidly oscillating closed box: the moving walls
    entrain the fluid, the particle walk tables track the moving geometry,
    and everything stays bounded and in the domain."""
    from cudaparticlesfoam_tpu_torch.models import coupled

    case_dir = make_oscillating_case(tmp_path)
    out = str(tmp_path / "out")
    os.makedirs(out)
    logs = []
    case, state, stats = coupled.run_coupled(
        case_dir, out_dir=out, n_steps=5, device=CPU,
        log=lambda *a: logs.append(" ".join(map(str, a))))
    assert any("dynamic mesh: oscillatingLinearMotion" in ln for ln in logs)
    assert torch.isfinite(state.pos).all()
    assert state.active.all() and (state.tet_id >= 0).all()
    # the particle mesh really moved with the motion function
    expect_shift = 0.2 * math.sin(6.283 * stats["time"])
    assert float(case.tet_mesh.bounds_lo[0]) == pytest.approx(expect_shift, abs=5e-3)
    assert float(state.vel.abs().max()) > 1e-4
    assert all(s["geometry_ms"] >= 0.0 for s in stats["steps"]) and stats["active_in_domain"]


def test_blockmesh_cell_zones():
    pm = blockmesh.generate(TWO_ZONE_BMD)
    assert pm.cell_zones is not None and "rotor" in pm.cell_zones
    assert len(pm.cell_zones["rotor"]) == 6 * 6 * 2
    ctrs, _ = polymesh.cell_centres_volumes(pm)
    assert (ctrs[pm.cell_zones["rotor"], 0] < 1.0).all()


def test_cell_zones_roundtrip(tmp_path):
    pm = blockmesh.generate(TWO_ZONE_BMD)
    d = str(tmp_path / "polyMesh")
    polymesh.write_polymesh(pm, d)
    back = polymesh.read_polymesh(d)
    assert set(back.cell_zones) == {"rotor"}
    np.testing.assert_array_equal(back.cell_zones["rotor"], pm.cell_zones["rotor"])


def test_read_multi_solid_body(tmp_path):
    write_files(tmp_path, {"constant/dynamicMeshDict":
                           "FoamFile { version 2.0; format ascii; class dictionary; "
                           "object dynamicMeshDict; }\n"
                           "dynamicFvMesh multiSolidBodyMotionFvMesh;\n"
                           "multiSolidBodyMotionFvMeshCoeffs\n{\n"
                           " rotor { solidBodyMotionFunction oscillatingLinearMotion;\n"
                           "   oscillatingLinearMotionCoeffs { amplitude (0.08 0 0); "
                           "omega 6.28; } }\n}\n"})
    m = dyn.read_dynamic_mesh(str(tmp_path))
    assert isinstance(m, dyn.MultiSolidBodyMotion)
    assert m.zones[0][0] == "rotor"
    assert m.zones[0][1].kind == "oscillatingLinearMotion"


def _divergence(pm, mesh_phi):
    phi = mesh_phi.numpy()
    div = np.zeros(pm.n_cells)
    np.add.at(div, pm.owner, phi)
    np.add.at(div, pm.neighbour, -phi[: pm.n_internal_faces])
    return div


def test_multi_zone_motion_deforms_interface():
    """Left (rotor) zone oscillates in x, right zone static: zone cells
    translate rigidly, interface cells deform, every volume stays positive,
    and meshPhi satisfies the GCL (div(meshPhi) = dV/dt)."""
    pm = blockmesh.generate(TWO_ZONE_BMD)
    motion = dyn.MultiSolidBodyMotion(zones=(
        ("rotor", dyn.SolidBodyMotion(kind="oscillatingLinearMotion",
                                      amplitude=(0.08, 0.0, 0.0), omega=2.0 * np.pi)),))
    dm = dyn.DynamicMesh(motion, pm, dtype=F64, device=CPU)
    _, vols0 = polymesh.cell_centres_volumes(polymesh.PolyMesh(
        dm.points0, pm.face_verts, pm.face_offsets, pm.owner, pm.neighbour, pm.patches))
    dt = 0.01
    m_new, mesh_phi, _ = dm.update(t_new=0.15, dt=dt)
    ctrs, vols1 = polymesh.cell_centres_volumes(pm)
    assert (vols1 > 0).all()
    rotor_cells = pm.cell_zones["rotor"]
    assert (np.abs(ctrs[rotor_cells][:, 0]) < 2.0).all()
    changed = np.abs(vols1 - vols0) / vols0
    assert changed.max() > 0.05           # interface cells deform
    assert np.median(changed[rotor_cells]) < 1e-9   # bulk rigid
    pm_prev = polymesh.PolyMesh(dm._points_at(0.15 - dt), pm.face_verts, pm.face_offsets,
                                pm.owner, pm.neighbour, pm.patches)
    _, vols_prev = polymesh.cell_centres_volumes(pm_prev)
    np.testing.assert_allclose(_divergence(pm, mesh_phi), (vols1 - vols_prev) / dt,
                               atol=2e-4 * vols0.max() / dt * dt)


def test_coupled_flow_on_multi_zone_mesh(tmp_path):
    """The PIMPLE solver advances on the deforming two-zone mesh without
    NaNs, without spurious ALE currents (u=0 is exact for interior-zone
    deformation in a rigid closed box), and with bounded continuity."""
    from cudaparticlesfoam_tpu_torch.models.pimple import FlowSolver

    case = write_files(tmp_path, {
        "system/blockMeshDict": TWO_ZONE_BMD,
        "system/controlDict": "FoamFile { version 2.0; format ascii; class dictionary; "
        "object controlDict; }\napplication pimpleFoam; startFrom startTime; startTime 0; "
        "endTime 1;\ndeltaT 0.005; writeControl timeStep; writeInterval 1000;\n",
        "system/fvSolution": "FoamFile { version 2.0; format ascii; class dictionary; "
        "object fvSolution; }\n"
        "PIMPLE { nOuterCorrectors 1; nCorrectors 2; nNonOrthogonalCorrectors 0; }\n",
        "system/fvSchemes": "FoamFile { version 2.0; format ascii; class dictionary; "
        "object fvSchemes; }\ndivSchemes { default none; \"div\\(phi,U\\)\" Gauss upwind; }\n",
        "constant/transportProperties": "FoamFile { version 2.0; format ascii; class "
        "dictionary; object transportProperties; }\nnu [0 2 -1 0 0 0 0] 0.01;\n",
        "constant/dynamicMeshDict": "FoamFile { version 2.0; format ascii; class dictionary; "
        "object dynamicMeshDict; }\ndynamicFvMesh multiSolidBodyMotionFvMesh;\n"
        "multiSolidBodyMotionFvMeshCoeffs\n{\n"
        " rotor { solidBodyMotionFunction oscillatingLinearMotion;\n"
        "   oscillatingLinearMotionCoeffs { amplitude (0.05 0 0); omega 6.2832; } }\n}\n",
        "0/U": "FoamFile { version 2.0; format ascii; class volVectorField; object U; }\n"
        "dimensions [0 1 -1 0 0 0 0];\ninternalField uniform (0 0 0);\n"
        "boundaryField { walls { type noSlip; } }\n",
        "0/p": "FoamFile { version 2.0; format ascii; class volScalarField; object p; }\n"
        "dimensions [0 2 -2 0 0 0 0];\ninternalField uniform 0;\n"
        "boundaryField { walls { type zeroGradient; } }\n",
    })
    pm = blockmesh.generate(os.path.join(case, "system", "blockMeshDict"))
    polymesh.write_polymesh(pm, os.path.join(case, "constant", "polyMesh"))
    flow = FlowSolver.from_case(FakeCase(case, pm), log=lambda *a: None, device=CPU)
    assert flow.dyn is not None and flow.dyn._zone_pts is not None
    for _ in range(3):
        flow.advance(0.005)
    assert torch.isfinite(flow.state.u).all()
    assert float(flow.state.u.abs().max()) < 1e-4
    assert flow.last["continuity"] < 1e-3


def test_parse_motion_solver(tmp_path):
    from cudaparticlesfoam_tpu_torch.models import motionsolver as ms

    case_dir = make_motion_solver_case(tmp_path, diffusivity="inverseDistance (movingWall);")
    m = dyn.read_dynamic_mesh(case_dir)
    assert isinstance(m, ms.MotionSolverMotion)
    assert m.kind == "velocityLaplacian"
    assert m.diffusivity == ("inverseDistance", ("movingWall",))
    bcs = dict(m.bcs)
    assert bcs["movingWall"].btype == "fixedValue"
    assert bcs["movingWall"].value == (0.5, 0.0, 0.0)
    assert bcs["farWall"].btype == "fixedValue"
    assert bcs["sides"].btype == "zeroGradient"


def _lap_pm(case_dir):
    return polymesh.read_polymesh(os.path.join(case_dir, "constant", "polyMesh"))


def test_velocity_laplacian_motion(tmp_path):
    """velocityLaplacian: moving wall advances at the prescribed velocity,
    far wall stays, interior deforms smoothly and monotonically, volumes
    stay positive, and meshPhi satisfies the GCL."""
    case_dir = make_motion_solver_case(tmp_path)
    pm = _lap_pm(case_dir)
    dm = dyn.DynamicMesh(dyn.read_dynamic_mesh(case_dir), pm, dtype=F64, device=CPU)
    _, vols_prev = polymesh.cell_centres_volumes(polymesh.PolyMesh(
        dm.points0, pm.face_verts, pm.face_offsets, pm.owner, pm.neighbour, pm.patches))
    dt = 0.05
    for t in (dt, 2 * dt, 3 * dt):
        _, mesh_phi, _ = dm.update(t_new=t, dt=dt)
        _, vols = polymesh.cell_centres_volumes(pm)
        assert (vols > 0).all()
        np.testing.assert_allclose(_divergence(pm, mesh_phi), (vols - vols_prev) / dt,
                                   atol=1e-10)
        vols_prev = vols
    pts = pm.points
    mv = pts[np.isclose(dm.points0[:, 0], 0.0)]
    np.testing.assert_allclose(mv[:, 0], 0.075, atol=1e-6)
    fw = pts[np.isclose(dm.points0[:, 0], 2.0)]
    np.testing.assert_allclose(fw[:, 0], 2.0, atol=1e-12)
    xs0 = np.unique(np.round(dm.points0[:, 0], 9))
    xs_now = [float(np.mean(pts[np.isclose(dm.points0[:, 0], x0), 0])) for x0 in xs0]
    assert all(a < b for a, b in zip(xs_now, xs_now[1:]))
    np.testing.assert_allclose(pts[:, 1:], dm.points0[:, 1:], atol=1e-8)


def test_displacement_laplacian_motion(tmp_path):
    """displacementLaplacian with an oscillatingDisplacement wall: points
    track amplitude*sin(omega*t) ABSOLUTELY."""
    case_dir = make_motion_solver_case(tmp_path, solver="displacementLaplacian")
    pm = _lap_pm(case_dir)
    motion = dyn.read_dynamic_mesh(case_dir)
    assert motion.kind == "displacementLaplacian"
    dm = dyn.DynamicMesh(motion, pm, dtype=F64, device=CPU)
    dt = 0.025
    for t in (dt, 2 * dt, 3 * dt, 4 * dt):
        dm.update(t_new=t, dt=dt)
        mv = pm.points[np.isclose(dm.points0[:, 0], 0.0)]
        np.testing.assert_allclose(mv[:, 0], 0.2 * math.sin(6.2832 * t), atol=1e-6)
    _, vols = polymesh.cell_centres_volumes(pm)
    assert (vols > 0).all()


def test_coupled_flow_on_laplacian_mesh(tmp_path):
    """PIMPLE advances on the velocityLaplacian-deforming channel: the moving
    wall drives the fluid (movingWallVelocity) and the solve stays finite
    with bounded continuity."""
    from cudaparticlesfoam_tpu_torch.models.pimple import FlowSolver

    case_dir = make_motion_solver_case(tmp_path, flow=True)
    logs = []
    flow = FlowSolver.from_case(FakeCase(case_dir, _lap_pm(case_dir)),
                                log=lambda *a: logs.append(" ".join(map(str, a))), device=CPU)
    assert flow.dyn is not None and flow.dyn._lap is not None
    assert any("velocityLaplacian" in ln for ln in logs)
    for _ in range(3):
        flow.advance(0.01)
    assert torch.isfinite(flow.state.u).all()
    assert float(flow.state.u[:, 0].abs().max()) > 1e-3
    assert flow.last["continuity"] < 1e-2


def test_amg_active_under_motion(tmp_path):
    """The AMG preconditioner stays on moving meshes: the hierarchy is
    topological and the Galerkin coarse ops rebuild per solve."""
    from cudaparticlesfoam_tpu_torch.models.pimple import FlowSolver

    case_dir = make_motion_solver_case(tmp_path, flow=True)
    flow = FlowSolver.from_case(FakeCase(case_dir, _lap_pm(case_dir)), log=lambda *a: None,
                                device=CPU)
    assert flow.dyn is not None
    assert flow.amg is not None and flow.cfg.p_solver == "amg"
    for _ in range(3):
        flow.advance(0.01)
    assert torch.isfinite(flow.state.u).all()
    assert flow.last["continuity"] < 1e-2


@pytest.mark.parametrize("kind", ["oscillating", "velocityLaplacian", "displacementLaplacian"])
def test_mesh_motion_matches_jax(tmp_path, kind):
    """Both packages move one case's mesh three steps (and the port once more
    from the JAX mesh's state after step 1): points, meshPhi, the
    boundary velocity and the tet vertices within 1e-12 (float64) for the
    solid-body motion; the Laplacian solvers solve the motion with
    Jacobi-CG to 1e-8, in two orders of summation, so there the points
    within 1e-9 and the velocities (differences of points over dt) within
    1e-9 / dt."""
    from cudaparticlesfoam_tpu.io import polymesh as jpolymesh
    from cudaparticlesfoam_tpu.models import dynamicmesh as jdyn

    if kind == "oscillating":
        case_dir = make_oscillating_case(tmp_path)
    else:
        case_dir = make_motion_solver_case(tmp_path, solver=kind,
                                           diffusivity="quadratic inverseDistance (movingWall);")
    mesh_dir = os.path.join(case_dir, "constant", "polyMesh")
    jpm, pm = jpolymesh.read_polymesh(mesh_dir), polymesh.read_polymesh(mesh_dir)
    jdm = jdyn.DynamicMesh(jdyn.read_dynamic_mesh(case_dir), jpm, dtype=np.float64)
    dm = dyn.DynamicMesh(dyn.read_dynamic_mesh(case_dir), pm, dtype=F64, device=CPU)
    tol = 1e-12 if kind == "oscillating" else 1e-9
    dt = 0.02
    carried = None
    for t in (dt, 2 * dt, 3 * dt):
        want = jdm.update(t_new=t, dt=dt)
        runs = [(dm, pm, dm.update(t_new=t, dt=dt))]
        if carried is not None:
            runs.append((carried, carried.pm, carried.update(t_new=t, dt=dt)))
        for d, p, got in runs:
            np.testing.assert_allclose(p.points, jpm.points, atol=tol, rtol=0)
            for g, w in zip(got[1:], want[1:]):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol / dt, rtol=0)
            np.testing.assert_allclose(d.tet_vertices(got[0]), jdm.tet_vertices(want[0]),
                                       atol=tol, rtol=0)
        if carried is None:
            # the JAX mesh's state after step 1 carried into the port
            # (convert.to_dynamic_mesh), stepped on beside both
            from cudaparticlesfoam_tpu_torch import convert

            cpm = polymesh.read_polymesh(mesh_dir)
            cpm.points = np.array(jpm.points)
            carried = convert.to_dynamic_mesh(jdm, cpm, dtype=F64, device=CPU)
