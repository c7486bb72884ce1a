"""PyTorch port: the domain-decomposed PIMPLE step (``parallel/flowshard.py``)
on the CPU, S shards on ``cpu``, against the port's single-device step: the
twins of tests/test_flowshard.py's sharded-step tests and of
tests/test_fvoptions.py::test_fvoptions_sharded_matches_single, with JAX's
tolerances, and the halo exchange on a strided map.  The pins and the
parity with the JAX package are in tests/test_torch_flowshard_jax.py."""

from torch_port_common import CPU, FVO_CHANNEL_BMD, duct_mrf, flowshard_meshes, write_files

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from cudaparticlesfoam_tpu_torch.io import blockmesh  # noqa: E402
from cudaparticlesfoam_tpu_torch.models import fv, fvoptions, mrf, pimple  # noqa: E402
from cudaparticlesfoam_tpu_torch.models.simple import FlowState  # noqa: E402
from cudaparticlesfoam_tpu_torch.parallel import flowshard  # noqa: E402

F64 = torch.float64


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    return flowshard_meshes(tmp_path_factory.mktemp("flowshard"))


def duct_setup(pm, slip=False, speed=1.0, dtype=F64):
    """The duct's (m, u_bcs, p_bcs, state) in the port: inlet ``speed`` m/s
    in x, walls noSlip (or slip), outlet p = 0, U uniform.  pitzDaily takes
    the same patches' roles (its walls named upperWall/lowerWall)."""
    m = fv.fv_mesh(pm, dtype=dtype, device=CPU)
    wall = ("slip" if slip else "noSlip", 0.0)
    u_bcs = fv.make_bcs(m, {"inlet": ("fixedValue", [speed, 0.0, 0.0]), "walls": wall,
                            "upperWall": wall, "lowerWall": wall,
                            "frontAndBack": ("empty", 0.0)}, 3)
    p_bcs = fv.make_bcs(m, {"outlet": ("fixedValue", 0.0)}, 1)
    u0 = torch.tensor([speed, 0.0, 0.0], dtype=dtype).repeat(m.n_cells, 1)
    st = FlowState(u=u0, p=torch.zeros(m.n_cells, dtype=dtype), flux=fv.flux_of(m, u0, u_bcs))
    return m, u_bcs, p_bcs, st


def run_single(m, st, u_bcs, p_bcs, cfg, dt, n, mrf_z=None):
    for _ in range(n):
        st, _ = pimple.pimple_step(m, st, u_bcs, p_bcs, cfg, dt, mrf=mrf_z)
    return st


def run_sharded(smesh, bglob, m, st, u_bcs, p_bcs, cfg, dt, n, mrf_z=None):
    """``n`` sharded steps from the single-device inputs (the MRF frame as
    ShardedFlowSolver folds it in); returns (u, p) gathered and the last
    diagnostics."""
    extra = ()
    if mrf_z is not None:
        u_bcs = mrf.correct_boundary_velocity(mrf_z, m, u_bcs)
        extra = flowshard.shard_mrf(smesh, mrf_z, m)
    ub = flowshard.shard_bcs(u_bcs, bglob, smesh)
    pb = flowshard.shard_bcs(p_bcs, bglob, smesh)
    u = flowshard.scatter_cells(smesh, st.u)
    p = flowshard.scatter_cells(smesh, st.p)
    flux = flowshard.flux_init(smesh, u, ub)
    if mrf_z is not None:
        flux = [f - ff for f, ff in zip(flux, extra[1])]
    step = flowshard.make_sharded_pimple(smesh, cfg, with_mrf=mrf_z is not None)
    for _ in range(n):
        u, p, flux, diag = step(smesh, u, p, flux, ub, pb, dt, *extra)
    return (flowshard.gather_cells(smesh, u).numpy(), flowshard.gather_cells(smesh, p).numpy(),
            diag)


def duct_cfg(**kw):
    return pimple.PimpleConfig(**{**dict(nu=1e-3, n_outer=1, n_correctors=2, n_jacobi=8,
                                         p_tol=1e-12, p_max_iter=600), **kw})


# ---------------------------------------------------------------- twins


@pytest.mark.parametrize("div_scheme", ["upwind", "linearUpwind"])
def test_sharded_pimple_matches_single(meshes, div_scheme):
    """Twin of tests/test_flowshard.py::test_sharded_pimple_matches_single
    (8 slabs, 3 steps)."""
    pm = meshes["duct"][0]
    m, u_bcs, p_bcs, st = duct_setup(pm)
    cfg = duct_cfg(div_scheme=div_scheme)
    ref = run_single(m, st, u_bcs, p_bcs, cfg, 0.02, 3)
    smesh, bglob = flowshard.decompose(pm, 8, dtype=F64, device=CPU)
    u_g, p_g, diag = run_sharded(smesh, bglob, m, st, u_bcs, p_bcs, cfg, 0.02, 3)
    u_ref, p_ref = ref.u.numpy(), ref.p.numpy()
    assert np.abs(u_g - u_ref).max() < 1e-8 * max(np.abs(u_ref).max(), 1.0)
    assert np.abs(p_g - p_ref).max() < 1e-6 * max(np.abs(p_ref).max(), 1.0)
    assert np.isfinite(u_g).all() and np.isfinite(p_g).all()
    assert float(diag["continuity"]) < 1e-8


@pytest.mark.parametrize("grid", [(2, 2, 2), (4, 2, 1), (2, 1, 2)])
def test_sharded_pimple_multiaxis_grid(meshes, grid):
    """Twin of tests/test_flowshard.py::test_sharded_pimple_multiaxis_grid."""
    pm = meshes["duct6"][0]
    m, u_bcs, p_bcs, st = duct_setup(pm)
    cfg = duct_cfg()
    ref = run_single(m, st, u_bcs, p_bcs, cfg, 0.02, 3)
    smesh, bglob = flowshard.decompose(pm, int(np.prod(grid)), dtype=F64, grid=grid,
                                       device=CPU)
    u_g, p_g, diag = run_sharded(smesh, bglob, m, st, u_bcs, p_bcs, cfg, 0.02, 3)
    assert np.abs(u_g - ref.u.numpy()).max() < 1e-8
    assert np.abs(p_g - ref.p.numpy()).max() < 1e-6 * max(np.abs(ref.p.numpy()).max(), 1.0)
    assert float(diag["continuity"]) < 1e-8


def test_sharded_pimple_mrf_matches_single(meshes):
    """Twin of tests/test_flowshard.py::test_sharded_pimple_mrf_matches_single:
    Coriolis source, relative flux and rotating-wall BCs in the sharded step."""
    pm = meshes["duct"][0]
    m, u_bcs, p_bcs, st = duct_setup(pm)
    z = duct_mrf(m, mrf, torch.as_tensor)
    # the initial flux from the rotating-wall-corrected BCs on both legs
    flux0 = mrf.make_relative(z, m, fv.flux_of(m, st.u, mrf.correct_boundary_velocity(z, m,
                                                                                     u_bcs)))
    st = dataclasses.replace(st, flux=flux0)
    cfg = duct_cfg()
    ref = run_single(m, st, u_bcs, p_bcs, cfg, 0.02, 3, mrf_z=z)
    smesh, bglob = flowshard.decompose(pm, 8, dtype=F64, device=CPU)
    u_g, p_g, _ = run_sharded(smesh, bglob, m, st, u_bcs, p_bcs, cfg, 0.02, 3, mrf_z=z)
    u_ref, p_ref = ref.u.numpy(), ref.p.numpy()
    assert np.abs(u_g - u_ref).max() < 1e-8 * max(np.abs(u_ref).max(), 1.0)
    assert np.abs(p_g - p_ref).max() < 1e-6 * max(np.abs(p_ref).max(), 1.0)
    assert np.abs(u_ref[:, 1]).max() > 1e-3      # the zone swirls the flow


def test_decompose_structure(meshes):
    """Twin of tests/test_flowshard.py::test_decompose_structure."""
    pm = meshes["duct"][0]
    smesh, bglob = flowshard.decompose(pm, 4, dtype=F64, device=CPU)
    owned = smesh.glob_cell[smesh.cell_mask]
    assert sorted(owned.tolist()) == list(range(pm.n_cells))
    bvals = bglob[bglob >= 0]
    assert len(np.unique(bvals)) == len(bvals) == pm.n_faces - pm.n_internal_faces


def test_sharded_pimple_slip_bcs_match_single(meshes):
    """Twin of tests/test_flowshard.py::test_sharded_pimple_slip_bcs_match_single."""
    pm = meshes["duct"][0]
    m, u_bcs, p_bcs, st = duct_setup(pm, slip=True)
    assert u_bcs.slip_mask is not None
    cfg = duct_cfg()
    ref = run_single(m, st, u_bcs, p_bcs, cfg, 0.02, 3)
    smesh, bglob = flowshard.decompose(pm, 8, dtype=F64, device=CPU)
    assert any(bool(bc.slip_mask.any()) for bc in flowshard.shard_bcs(u_bcs, bglob, smesh))
    u_g, p_g, _ = run_sharded(smesh, bglob, m, st, u_bcs, p_bcs, cfg, 0.02, 3)
    assert np.abs(u_g - ref.u.numpy()).max() < 1e-8
    assert np.abs(p_g - ref.p.numpy()).max() < 1e-6
    assert np.abs(u_g[:, 0]).min() > 0.5          # slip walls keep the tangential flow


@pytest.mark.parametrize("decomp", ["rcb", "strided"])
def test_sharded_pimple_general_decomposition(meshes, decomp):
    """Twin of tests/test_flowshard.py::test_sharded_pimple_general_decomposition:
    RCB and a strided cell map (every internal face a cross face)."""
    pm = meshes["duct"][0]
    m, u_bcs, p_bcs, st = duct_setup(pm)
    cfg = duct_cfg()
    ref = run_single(m, st, u_bcs, p_bcs, cfg, 0.02, 3)
    kw = dict(grid="rcb") if decomp == "rcb" else dict(cell_map=np.arange(m.n_cells) % 8)
    smesh, bglob = flowshard.decompose(pm, 8, dtype=F64, device=CPU, **kw)
    u_g, p_g, diag = run_sharded(smesh, bglob, m, st, u_bcs, p_bcs, cfg, 0.02, 3)
    assert np.abs(u_g - ref.u.numpy()).max() < 1e-8
    assert np.abs(p_g - ref.p.numpy()).max() < 1e-6
    assert float(diag["continuity"]) < 1e-8


@pytest.mark.parametrize("grid", ["rcb", "graph"])
def test_sharded_pimple_pitzdaily_parity(meshes, grid):
    """Twins of tests/test_flowshard.py::test_sharded_pimple_rcb_pitzdaily_parity
    and ::test_sharded_pimple_graph_pitzdaily_parity (8 shards, 2 steps)."""
    pm = meshes["pitz"][0]
    m, u_bcs, p_bcs, st = duct_setup(pm, speed=10.0)
    cfg = duct_cfg(nu=1e-5, p_tol=1e-11, p_max_iter=2000)
    ref = run_single(m, st, u_bcs, p_bcs, cfg, 5e-5, 2)
    smesh, bglob = flowshard.decompose(pm, 8, dtype=F64, grid=grid, device=CPU)
    # RCB and the graph map on pitzDaily are not slabs: more than 2 rounds
    assert len(smesh.halo_perms) > 2
    u_g, p_g, _ = run_sharded(smesh, bglob, m, st, u_bcs, p_bcs, cfg, 5e-5, 2)
    p_ref = ref.p.numpy()
    assert np.abs(u_g - ref.u.numpy()).max() / 10.0 < 1e-6
    assert np.abs(p_g - p_ref).max() / (np.abs(p_ref).max() + 1e-12) < 1e-5


def force_driven(pm, dtype=F64):
    """tests/test_fvoptions.py's ``_force_driven_setup`` and its fvOptions
    (Su 3 in x, Sp -1, meanVelocityForce Ubar 1 over every cell)."""
    m = fv.fv_mesh(pm, dtype=dtype, device=CPU)
    u_bcs = fv.make_bcs(m, {"walls": ("noSlip", 0.0)}, 3, default="zeroGradient")
    p_bcs = fv.make_bcs(m, {"inlet": ("fixedValue", 0.0), "outlet": ("fixedValue", 0.0)}, 1)
    u0 = torch.zeros((m.n_cells, 3), dtype=dtype)
    st = FlowState(u=u0, p=torch.zeros(m.n_cells, dtype=dtype), flux=fv.flux_of(m, u0, u_bcs))
    t = lambda x: torch.as_tensor(x, dtype=dtype)  # noqa: E731
    fvo = fvoptions.FvOptions(
        su=t(np.tile([[3.0, 0.0, 0.0]], (m.n_cells, 1))), sp=t(np.full(m.n_cells, -1.0)),
        mvf_dir=t([1.0, 0.0, 0.0]), mvf_mask=t(np.ones(m.n_cells)), mvf_mag=t(1.0),
        mvf_relax=t(1.0), grad_p=t(0.0), dgrad=t(0.0), has_mvf=True)
    return m, st, u_bcs, p_bcs, fvo


def test_fvoptions_sharded_matches_single(tmp_path):
    """Twin of tests/test_fvoptions.py::test_fvoptions_sharded_matches_single:
    meanVelocityForce + semiImplicitSource with psum-global zone averages."""
    path = write_files(tmp_path, {"blockMeshDict": FVO_CHANNEL_BMD}) + "/blockMeshDict"
    pm = blockmesh.generate(path)
    m, st, u_bcs, p_bcs, fvo = force_driven(pm)
    cfg = pimple.PimpleConfig(nu=0.01, n_correctors=2, n_jacobi=8, p_tol=1e-12, p_max_iter=600)
    st1, fvo1 = st, fvo
    for _ in range(3):
        st1, res = pimple.pimple_step(m, st1, u_bcs, p_bcs, cfg, 0.02, fvo=fvo1)
        fvo1 = dataclasses.replace(fvo1, grad_p=res["fvo_grad_p"], dgrad=res["fvo_dgrad"])
    smesh, bglob = flowshard.decompose(pm, 8, dtype=F64, device=CPU)
    ub = flowshard.shard_bcs(u_bcs, bglob, smesh)
    pb = flowshard.shard_bcs(p_bcs, bglob, smesh)
    u = flowshard.scatter_cells(smesh, np.zeros((m.n_cells, 3)))
    p = flowshard.scatter_cells(smesh, np.zeros(m.n_cells))
    flux = flowshard.flux_init(smesh, u, ub)
    su, sp, mask = (flowshard.scatter_cells(smesh, x) for x in (fvo.su, fvo.sp, fvo.mvf_mask))
    step = flowshard.make_sharded_pimple(smesh, cfg, with_fvo=True, fvo_mvf=True)
    grad_p, dgrad = 0.0, 0.0
    for _ in range(3):
        par = torch.tensor([1.0, 0.0, 0.0, 1.0, 1.0, grad_p, dgrad], dtype=F64)
        u, p, flux, diag = step(smesh, u, p, flux, ub, pb, 0.02, su, sp, mask, par)
        grad_p, dgrad = float(diag["fvo_grad_p"]), float(diag["fvo_dgrad"])
    u_g = flowshard.gather_cells(smesh, u).numpy()
    assert np.abs(u_g - st1.u.numpy()).max() < 1e-8
    assert abs(grad_p - float(fvo1.grad_p)) + abs(dgrad - float(fvo1.dgrad)) < 1e-8
    assert u_g[:, 0].max() > 0.5


def test_halo_refresh_fills_ghosts_from_neighbours(meshes):
    """The exchange on the strided map (every internal face a cross face):
    after one refresh every ghost slot a face reads holds its global cell's
    value, and the owned slots are untouched."""
    pm = meshes["duct"][0]
    smesh, _ = flowshard.decompose(pm, 8, dtype=F64, device=CPU,
                                   cell_map=np.arange(pm.n_cells) % 8)
    xs = flowshard.scatter_cells(smesh, np.arange(pm.n_cells, dtype=np.float64), fill=-1.0)
    out = flowshard.halo_refresh(smesh, xs)
    for s, sh in enumerate(smesh.shards):
        m = sh.m
        n_int = m.n_internal
        nei = fv.host(m.neighbour)
        real = smesh.fglob[s, :n_int] != 0
        fg = np.abs(smesh.fglob[s, :n_int][real]) - 1
        # the face's far cell: the global neighbour, or the owner where flipped
        far = np.where(smesh.fglob[s, :n_int][real] > 0, pm.neighbour[fg], pm.owner[fg])
        np.testing.assert_array_equal(out[s].numpy()[nei[real]], far)
        assert torch.equal(out[s][: smesh.n_loc], xs[s][: smesh.n_loc])
