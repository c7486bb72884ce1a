"""PyTorch port: MRF zones (``models/mrf.py``) and CorrectPhi
(``pimple.correct_flux``) — the twins of tests/test_mrf.py, on the CPU,
written with the port's io only, plus the zones read by both packages from
one case compared field for field."""

from torch_port_common import (CPU, MRF_BOX_BMD, cell_zones_text, make_mrf_case, mrf_props,
                               write_files, write_polymesh_of)

import os  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from cudaparticlesfoam_tpu_torch.io import polymesh  # noqa: E402
from cudaparticlesfoam_tpu_torch.models import fv, mrf, pimple  # noqa: E402


@pytest.fixture(scope="module")
def boxcase(tmp_path_factory):
    case = write_files(tmp_path_factory.mktemp("mrfbox"),
                       {"system/blockMeshDict": MRF_BOX_BMD, "constant/.keep": "",
                        "0/.keep": ""})
    from cudaparticlesfoam_tpu_torch.io import blockmesh

    pm = blockmesh.generate(os.path.join(case, "system", "blockMeshDict"))
    m = fv.fv_mesh(pm, device=CPU)
    return case, pm, m


def write_mrf_props(case, zone="rotor", omega=10.0, nonrot=()):
    write_files(case, {"constant/MRFProperties": mrf_props(omega, zone, nonrot)})


def write_cell_zones(case, pm, name, cells):
    write_files(case, {"constant/polyMesh/cellZones": cell_zones_text(name, cells)})


def test_cell_zones_reader(boxcase):
    case, pm, m = boxcase
    cells = [0, 3, 7, 42]
    write_cell_zones(case, pm, "rotor", cells)
    zones = polymesh.read_cell_zones(os.path.join(case, "constant", "polyMesh"))
    np.testing.assert_array_equal(zones["rotor"], cells)


def test_mrf_from_case_masks(boxcase):
    case, pm, m = boxcase
    cells = list(range(pm.n_cells // 2))            # half the domain
    write_cell_zones(case, pm, "rotor", cells)
    write_mrf_props(case, omega=10.0)
    z = mrf.from_case(case, m, pm)
    assert z is not None
    om = z.cell_omega.numpy()
    in_zone = np.zeros(pm.n_cells, bool)
    in_zone[cells] = True
    np.testing.assert_allclose(om[in_zone, 2], 10.0)
    np.testing.assert_allclose(om[~in_zone], 0.0)
    # rotational internal faces: both cells in zone
    own, nei = m.owner.numpy(), m.neighbour.numpy()
    n_int = m.n_internal
    fom = z.face_omega.numpy()
    both = in_zone[own[:n_int]] & in_zone[nei]
    np.testing.assert_allclose(fom[:n_int][both, 2], 10.0)
    np.testing.assert_allclose(fom[:n_int][~both], 0.0)
    # boundary faces of zone cells rotate unless excluded
    bd_in = in_zone[own[n_int:]]
    np.testing.assert_allclose(fom[n_int:][bd_in, 2], 10.0)
    np.testing.assert_allclose(fom[n_int:][~bd_in], 0.0)


def test_mrf_nonrotating_patches(boxcase):
    case, pm, m = boxcase
    write_cell_zones(case, pm, "rotor", list(range(pm.n_cells)))
    write_mrf_props(case, omega=5.0, nonrot=("frontAndBack",))
    z = mrf.from_case(case, m, pm)
    fom = z.face_omega.numpy()[m.n_internal:]
    for name, _, start, cnt in m.patch_slices:
        sl = slice(start, start + cnt)
        if name == "frontAndBack":
            np.testing.assert_allclose(fom[sl], 0.0)
        else:
            np.testing.assert_allclose(fom[sl, 2], 5.0)


def test_coriolis_source_analytic(boxcase):
    case, pm, m = boxcase
    write_cell_zones(case, pm, "rotor", list(range(pm.n_cells)))
    write_mrf_props(case, omega=2.0)
    z = mrf.from_case(case, m, pm)
    u = torch.tensor([1.0, 0.0, 0.0], dtype=m.dtype).repeat(m.n_cells, 1)
    src = mrf.coriolis_source(z, m, u).numpy()
    # Omega x u = (0,0,2) x (1,0,0) = (0,2,0); source = -that * V
    np.testing.assert_allclose(src[:, 1], -2.0 * m.vol.numpy(), rtol=1e-6)
    np.testing.assert_allclose(src[:, [0, 2]], 0.0, atol=1e-12)


def test_make_relative_cancels_solid_rotation(boxcase):
    """flux of the rigid-rotation velocity (a linear field, exactly
    represented by linear face interpolation) equals the frame flux, so
    makeRelative zeroes it on rotational faces."""
    case, pm, m = boxcase
    write_cell_zones(case, pm, "rotor", list(range(pm.n_cells)))
    write_mrf_props(case, omega=3.0)
    z = mrf.from_case(case, m, pm)
    omega = np.array([0.0, 0.0, 3.0])
    u_rot = np.cross(np.tile(omega, (m.n_cells, 1)), m.cc.numpy())
    u_bcs = fv.make_bcs(m, {}, 3)   # zeroGradient everywhere
    flux = fv.flux_of(m, torch.as_tensor(u_rot, dtype=m.dtype), u_bcs)
    rel = mrf.make_relative(z, m, flux).numpy()
    n_int = m.n_internal
    scale = float(flux[:n_int].abs().max())
    assert np.abs(rel[:n_int]).max() < 1e-5 * max(scale, 1e-12)


def test_correct_boundary_velocity(boxcase):
    case, pm, m = boxcase
    write_cell_zones(case, pm, "rotor", list(range(pm.n_cells)))
    write_mrf_props(case, omega=4.0)
    z = mrf.from_case(case, m, pm)
    spec = {name: ("noSlip", None) for name, *_ in m.patch_slices}
    u_bcs = fv.make_bcs(m, spec, 3)
    fixed = mrf.correct_boundary_velocity(z, m, u_bcs)
    cf = m.cf.numpy()[m.n_internal:]
    expect = np.cross(np.tile([0, 0, 4.0], (len(cf), 1)), cf)
    np.testing.assert_allclose(fixed.b.numpy(), expect, atol=1e-6)


def test_correct_flux_makes_divergence_free(boxcase):
    case, pm, m = boxcase
    # a deliberately non-solenoidal field: u = (x, y, 0) has div = 2
    cc = m.cc.numpy()
    u = np.zeros((m.n_cells, 3))
    u[:, 0] = cc[:, 0]
    u[:, 1] = cc[:, 1]
    u_bcs = fv.make_bcs(m, {}, 3)
    flux = fv.flux_of(m, torch.as_tensor(u, dtype=m.dtype), u_bcs)
    div0 = float(fv.surface_sum(m, flux).abs().max())
    # like a real case, p is fixed on an outlet patch: pcorr=0 faces there
    # absorb the net imbalance (all-zeroGradient pcorr would be singular)
    p_bcs = fv.make_bcs(m, {"frontAndBack": ("fixedValue", 0.0)}, 1)
    fixed, res = pimple.correct_flux(m, flux, p_bcs, pin=False)
    div1 = float(fv.surface_sum(m, fixed).abs().max())
    assert div0 > 1e-4                 # it really was non-conservative
    assert div1 < 1e-7 * max(div0, 1.0) or div1 < 1e-9


def test_pimple_step_with_mrf_bounded(boxcase):
    """Closed box spun by an MRF zone: a few steps stay finite and the
    rotating-wall BC drives a swirl with the right sign."""
    case, pm, m = boxcase
    write_cell_zones(case, pm, "rotor", list(range(pm.n_cells)))
    write_mrf_props(case, omega=2.0, nonrot=("frontAndBack",))
    z = mrf.from_case(case, m, pm)
    spec = {"walls": ("noSlip", None), "frontAndBack": ("zeroGradient", None)}
    u_bcs = fv.make_bcs(m, spec, 3)
    p_bcs = fv.make_bcs(m, {}, 1)
    st = pimple.FlowState(u=torch.zeros((m.n_cells, 3), dtype=m.dtype),
                          p=torch.zeros(m.n_cells, dtype=m.dtype),
                          flux=torch.zeros(m.n_faces, dtype=m.dtype))
    cfg = pimple.PimpleConfig(nu=0.05, pin_pressure=True, n_correctors=2)
    for _ in range(3):
        st, res = pimple.pimple_step(m, st, u_bcs, p_bcs, cfg, 0.01, mrf=z)
    u = st.u.numpy()
    assert np.isfinite(u).all()
    # the spun walls entrain the fluid: angular momentum about z > 0
    cc = m.cc.numpy()
    assert (cc[:, 0] * u[:, 1] - cc[:, 1] * u[:, 0]).sum() > 0.0


def test_coupled_driver_with_mrf(tmp_path):
    """run_coupled on a case with constant/MRFProperties: the solver loads
    the zones (cudaParticlesPimpleFoam.C:151 path), the spun walls entrain
    the fluid, particles stay located."""
    from cudaparticlesfoam_tpu_torch.models import coupled

    case_dir = make_mrf_case(tmp_path)
    out = str(tmp_path / "out")
    os.makedirs(out)
    logs = []
    case, state, stats = coupled.run_coupled(
        case_dir, out_dir=out, n_steps=4, device=CPU,
        log=lambda *a: logs.append(" ".join(map(str, a))))
    assert any("MRF zones active" in ln for ln in logs)
    assert torch.isfinite(state.pos).all() and torch.isfinite(state.vel).all()
    assert state.active.all()
    assert (state.tet_id >= 0).all()


def test_mrf_zones_match_jax(tmp_path):
    """The zones both packages read from one case, field for field."""
    from cudaparticlesfoam_tpu.io import polymesh as jpolymesh
    from cudaparticlesfoam_tpu.models import fv as jfv
    from cudaparticlesfoam_tpu.models import mrf as jmrf

    case = write_files(tmp_path / "box", {"system/blockMeshDict": MRF_BOX_BMD})
    pm = write_polymesh_of(case)
    write_files(case, {"constant/polyMesh/cellZones": cell_zones_text("rotor",
                                                                      range(0, pm.n_cells, 3)),
                       "constant/MRFProperties": mrf_props(7.0, nonrot=("frontAndBack",))})
    jpm = jpolymesh.read_polymesh(os.path.join(case, "constant", "polyMesh"))
    want = jmrf.from_case(case, jfv.fv_mesh(jpm, dtype=np.float64), jpm)
    got = mrf.from_case(case, fv.fv_mesh(pm, dtype=torch.float64, device=CPU), pm)
    for k in ("cell_omega", "cell_origin", "face_omega", "face_origin"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)), k)
