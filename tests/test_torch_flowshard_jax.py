"""PyTorch port: the domain-decomposed flow solve's host code and step
(``parallel/flowshard.py``) against the JAX package's, on the CPU in
float64.

* Pins: ``decompose`` returns JAX's stacked arrays array for array (1-D
  slabs, the (2,2,2) grid, RCB, the graph map and an explicit cell map, in
  float64 and float32), and ``build_local_amg`` JAX's hierarchy.
* Parity: the port's sharded step and JAX's ``make_sharded_pimple`` on one
  decomposition (JAX's, carried across by ``convert.to_sharded_flow_mesh``
  / ``to_local_amg``) from the same inputs: fields within 1e-9 after one
  step, equal CG counts.  The psum orders differ (shard order here, XLA's
  all-reduce over 8 virtual CPU devices there), so the pressure solves run
  to a tight p_tol: the sharded AMG-CG takes ~3x the single-device
  iterations, and at the default 1e-6 the two orders part at ~6e-9 after a
  step."""

from torch_port_common import CPU, FVO_CHANNEL_BMD, duct_mrf, flowshard_meshes, write_files

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from cudaparticlesfoam_tpu.io import blockmesh as jblockmesh  # noqa: E402
from cudaparticlesfoam_tpu.models import fv as jfv  # noqa: E402
from cudaparticlesfoam_tpu.models import mrf as jmrf  # noqa: E402
from cudaparticlesfoam_tpu.parallel import flowshard as jfs  # noqa: E402
from cudaparticlesfoam_tpu.parallel import sharding as jsharding  # noqa: E402
from cudaparticlesfoam_tpu_torch import convert  # noqa: E402
from cudaparticlesfoam_tpu_torch.models import mrf, pimple  # noqa: E402
from cudaparticlesfoam_tpu_torch.parallel import flowshard  # noqa: E402

F64 = torch.float64
PARITY_TOL = 1e-9       # port against JAX, one step, relative to each field's largest value


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    return flowshard_meshes(tmp_path_factory.mktemp("flowshard_jax"))


# ---------------------------------------------------------------- pins

DECOMPS = {
    "slabs": dict(), "slabs-y": dict(direction=1), "grid222": dict(grid=(2, 2, 2)),
    "rcb": dict(grid="rcb"), "graph": dict(grid="graph"),
    "strided": dict(cell_map="strided"),
}


DECOMP_CASES = ([("duct", n, "float64") for n in sorted(DECOMPS)]
                + [("duct", n, "float32") for n in ("slabs", "grid222", "strided")]
                + [("pitz", n, "float64") for n in ("slabs", "grid222", "rcb", "graph")])


@pytest.mark.parametrize("mesh,name,dtype", DECOMP_CASES)
def test_decompose_matches_jax(meshes, mesh, name, dtype):
    """Every stacked array, bglob, the halo pairs, n_loc and fv_meta equal
    JAX's ``decompose`` (8 shards)."""
    pm, jpm = meshes[mesh]
    kw = dict(DECOMPS[name])
    if kw.get("cell_map") == "strided":
        kw["cell_map"] = np.arange(pm.n_cells) % 8
    js, jb = jfs.decompose(jpm, 8, dtype=getattr(jnp, dtype), **kw)
    ps, pb = flowshard.decompose(pm, 8, dtype=dtype, device=CPU, **kw)
    for k in flowshard.HOST_FIELDS:
        want = np.asarray(getattr(js, k))
        got = getattr(ps, k)
        assert got.dtype == (want.dtype if want.dtype.kind in "fb" else np.int64), k
        np.testing.assert_array_equal(got, want, err_msg=k)
    np.testing.assert_array_equal(pb, np.asarray(jb))
    assert ps.halo_perms == js.halo_perms and ps.n_loc == js.n_loc
    assert ps.fv_meta == js.fv_meta and ps.n_dev == js.n_dev
    assert [sh.device for sh in ps.shards] == [CPU] * 8


@pytest.mark.parametrize("mesh,S,kw", [("duct", 2, {}), ("duct6", 2, dict(grid=(1, 2, 1))),
                                       ("pitz", 4, dict(grid="graph")),
                                       ("pitz", 8, dict(grid="rcb"))])
def test_build_local_amg_matches_jax(meshes, mesh, S, kw):
    """The hierarchy of every shard with more than 100 owned cells (the
    shallower ones extended to the common depth)."""
    pm, jpm = meshes[mesh]
    js, _ = jfs.decompose(jpm, S, dtype=jnp.float64, **kw)
    ps = convert.to_sharded_flow_mesh(js, device=CPU)
    want = jfs.build_local_amg(js)
    got = flowshard.build_local_amg(ps)
    assert got.n_levels == want.n_levels > 0 and got.sizes == tuple(want.sizes)
    for field in ("aggs", "owners", "neighs", "f2cf"):
        for a, b in zip(getattr(got, field), getattr(want, field)):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=field)
    np.testing.assert_array_equal(got.off_mask, np.asarray(want.off_mask))


# ---------------------------------------------------------------- parity with JAX


def _jax_inputs(jpm, kind, dtype=jnp.float64):
    """JAX's (m, u_bcs, p_bcs, u0) of ``kind`` ("duct", "pitz", "fvo")."""
    jm = jfv.fv_mesh(jpm, dtype=dtype)
    if kind == "fvo":
        u_bcs = jfv.make_bcs(jm, {"walls": ("noSlip", 0.0)}, 3, default="zeroGradient")
        p_bcs = jfv.make_bcs(jm, {"inlet": ("fixedValue", 0.0), "outlet": ("fixedValue", 0.0)},
                             1)
        return jm, u_bcs, p_bcs, np.zeros((jm.n_cells, 3))
    speed = 10.0 if kind == "pitz" else 1.0
    wall = ("noSlip", 0.0)
    u_bcs = jfv.make_bcs(jm, {"inlet": ("fixedValue", [speed, 0.0, 0.0]), "walls": wall,
                              "upperWall": wall, "lowerWall": wall,
                              "frontAndBack": ("empty", 0.0)}, 3)
    p_bcs = jfv.make_bcs(jm, {"outlet": ("fixedValue", 0.0)}, 1)
    return jm, u_bcs, p_bcs, np.tile([speed, 0.0, 0.0], (jm.n_cells, 1))


PARITY = {
    # name: (mesh, decompose kw, shards, cfg kw, dt, options)
    "duct-upwind": ("duct", {}, 8, dict(nu=1e-3), 0.02, ()),
    "duct-linearUpwind": ("duct", {}, 8, dict(nu=1e-3, div_scheme="linearUpwind"), 0.02, ()),
    "grid222": ("duct6", dict(grid=(2, 2, 2)), 8, dict(nu=1e-3), 0.02, ()),
    "pitz-graph": ("pitz", dict(grid="graph"), 8, dict(nu=1e-5, p_tol=1e-11, p_max_iter=2000),
                   5e-5, ()),
    "local-amg": ("duct", {}, 2, dict(nu=1e-3, p_tol=1e-10), 0.02, ("amg",)),
    "mrf": ("duct", {}, 8, dict(nu=1e-3), 0.02, ("mrf",)),
    "fvo-mvf": ("fvo", {}, 8, dict(nu=0.01), 0.02, ("fvo",)),
}


@pytest.mark.parametrize("name", sorted(PARITY))
def test_sharded_step_matches_jax(meshes, tmp_path, name):
    """One sharded step of each package from the same float64 inputs on
    JAX's decomposition: u, p, flux (gathered) within 1e-9, the step's CG
    iterations equal; with fvOptions grad_p / dgrad within 1e-9."""
    mesh, kw, S, ckw, dt, opts = PARITY[name]
    if mesh == "fvo":
        path = write_files(tmp_path, {"blockMeshDict": FVO_CHANNEL_BMD}) + "/blockMeshDict"
        jpm = jblockmesh.generate(path)
    else:
        jpm = meshes[mesh][1]
    jm, jub, jpb, u0 = _jax_inputs(jpm, mesh)
    js, jb = jfs.decompose(jpm, S, dtype=jnp.float64, **kw)
    dmesh = jsharding.make_device_mesh(S, axis="f")
    cfg_kw = {**dict(n_outer=1, n_correctors=2, n_jacobi=8, p_tol=1e-12, p_max_iter=600),
              **ckw}
    if "amg" in opts:
        cfg_kw["p_solver"] = "amg"
    from cudaparticlesfoam_tpu.models.pimple import PimpleConfig as JCfg

    jcfg, cfg = JCfg(**cfg_kw), pimple.PimpleConfig(**cfg_kw)
    m = convert.to_fv_mesh(jm, device=CPU)
    ps = convert.to_sharded_flow_mesh(js, device=CPU)
    ub, pb = convert.to_bcs(jub, device=CPU), convert.to_bcs(jpb, device=CPU)
    jextra, extra, jkw, pkw = [], [], {}, {}
    if "amg" in opts:
        jl = jfs.build_local_amg(js)
        jextra.append(jl)
        extra.append(convert.to_local_amg(jl, ps))
        jkw["lamg"], pkw["lamg"] = jl, extra[-1]
    if "mrf" in opts:
        jz = duct_mrf(jm, jmrf, jnp.asarray)
        z = convert.to_mrf(jz, device=CPU)
        jub = jmrf.correct_boundary_velocity(jz, jm, jub)
        ub = mrf.correct_boundary_velocity(z, m, ub)
        jextra += list(jfs.shard_mrf(js, jz, jm))
        extra += list(flowshard.shard_mrf(ps, z, m))
        jkw["with_mrf"] = pkw["with_mrf"] = True
    if "fvo" in opts:
        fields = (np.tile([[3.0, 0.0, 0.0]], (jm.n_cells, 1)), np.full(jm.n_cells, -1.0),
                  np.ones(jm.n_cells))
        jextra += [jfs.scatter_cells(js, x) for x in fields]
        extra += [flowshard.scatter_cells(ps, x) for x in fields]
        par = [1.0, 0.0, 0.0, 1.0, 1.0, 0.25, 0.125]
        jextra.append(jnp.asarray(par, jnp.float64))
        extra.append(torch.tensor(par, dtype=F64))
        jkw.update(with_fvo=True, fvo_mvf=True)
        pkw.update(with_fvo=True, fvo_mvf=True)
    jub_s, jpb_s = jfs.shard_bcs(jub, jb), jfs.shard_bcs(jpb, jb)
    ub_s, pb_s = flowshard.shard_bcs(ub, jb, ps), flowshard.shard_bcs(pb, jb, ps)
    ju = jfs.scatter_cells(js, u0)
    jp = jfs.scatter_cells(js, np.zeros(jm.n_cells))
    jflux = jfs.make_flux_init(js, dmesh)(js, ju, jub_s)
    u = flowshard.scatter_cells(ps, u0)
    p = flowshard.scatter_cells(ps, np.zeros(jm.n_cells))
    flux = flowshard.flux_init(ps, u, ub_s)
    if "mrf" in opts:
        jflux = jflux - jextra[-1]
        flux = [f - ff for f, ff in zip(flux, extra[-1])]
    jstep = jfs.make_sharded_pimple(js, jcfg, dmesh, **jkw)
    step = flowshard.make_sharded_pimple(ps, cfg, **pkw)
    ju, jp, jflux, jdiag = jstep(js, ju, jp, jflux, jub_s, jpb_s, dt, *jextra)
    u, p, flux, diag = step(ps, u, p, flux, ub_s, pb_s, dt, *extra)

    def rel(got, want):
        want = np.asarray(want)
        return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-300)

    assert rel(flowshard.gather_cells(ps, u).numpy(), jfs.gather_cells(js, ju)) <= PARITY_TOL
    assert rel(flowshard.gather_cells(ps, p).numpy(), jfs.gather_cells(js, jp)) <= PARITY_TOL
    for s in range(S):
        assert rel(flux[s].numpy(), np.asarray(jflux)[s]) <= PARITY_TOL
    assert sum(diag["p_iters"]) == int(np.asarray(jdiag["p_iters"])[0])
    assert float(diag["continuity"]) == pytest.approx(
        float(np.asarray(jdiag["continuity"])[0]), rel=1e-6, abs=1e-13)
    if "fvo" in opts:
        for k in ("fvo_grad_p", "fvo_dgrad"):
            assert float(diag[k]) == pytest.approx(float(np.asarray(jdiag[k])[0]), rel=1e-9)
