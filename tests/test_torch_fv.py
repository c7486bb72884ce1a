"""PyTorch port: the finite-volume layer (``models/fv.py``) against the JAX
package's on the CPU.  The host-built tables (``fv_mesh``, ``make_bcs``,
``build_amg``) equal JAX's bit for bit; every operator, in float64 on the
same inputs, lies within 1e-12 of the largest magnitude of JAX's result
(the two sum in different orders, so bit for bit is not expected); the
two CG solvers take the same number of iterations and agree within 1e-10.
Twins of tests/test_fv_schemes.py's physical checks at the end."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudaparticlesfoam_tpu.io import blockmesh as jblockmesh
from cudaparticlesfoam_tpu.models import fv as jfv
from cudaparticlesfoam_tpu.models import simple as jsimple
from cudaparticlesfoam_tpu_torch import convert
from cudaparticlesfoam_tpu_torch.io import blockmesh
from cudaparticlesfoam_tpu_torch.models import fv, simple

from torch_port_common import CPU, PITZ, SKEW_VERTICES, TJUNC, channel_bmd, make_channel_case

OP_TOL = 1e-12       # operators, float64, relative to the largest magnitude
SOLVE_TOL = 1e-10    # CG / AMG-CG solutions, float64
# a channel whose cells are parallelograms: the non-orthogonal correction is live


def np_(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_close(got, want, tol, what=""):
    got, want = np_(got), np_(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-300)
    err = float(np.abs(got - want).max()) / scale if want.size else 0.0
    assert err <= tol, (what, err)


def assert_same(got, want, what=""):
    got, want = np_(got), np_(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _meshes(tmp_path_factory, name, bmd):
    case = make_channel_case(tmp_path_factory.mktemp(name), bmd=bmd)
    path = f"{case}/system/blockMeshDict"
    return blockmesh.generate(path), jblockmesh.generate(path)


@pytest.fixture(scope="module")
def polys(tmp_path_factory):
    """(port PolyMesh, JAX PolyMesh) of the channel, the skewed channel and
    the pitzDaily tutorial."""
    out = {name: _meshes(tmp_path_factory, name, bmd) for name, bmd in (
        ("channel", channel_bmd()), ("skew", channel_bmd(SKEW_VERTICES)))}
    path = f"{PITZ}/system/blockMeshDict"
    out["pitz"] = (blockmesh.generate(path), jblockmesh.generate(path))
    return out


MESH_ARRAYS = ("owner", "neighbour", "sf", "mag_sf", "cf", "cc", "vol", "w", "delta",
               "bd_delta", "nonortho")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["channel", "skew", "pitz"])
def test_fv_mesh_tables_equal_jax(polys, name, dtype):
    pm, jpm = polys[name]
    m = fv.fv_mesh(pm, dtype=dtype, device=CPU)
    jm = jfv.fv_mesh(jpm, dtype=jnp.dtype(dtype))
    for k in MESH_ARRAYS:
        assert_same(getattr(m, k), getattr(jm, k), k)
        assert np_(getattr(m, k)).dtype.kind == np.asarray(getattr(jm, k)).dtype.kind
    assert m.dtype == getattr(torch, dtype)
    assert (m.n_cells, m.n_faces, m.n_internal) == (jm.n_cells, jm.n_faces, jm.n_internal)
    assert m.patch_slices == jm.patch_slices


@pytest.fixture(scope="module")
def chan(polys):
    pm, jpm = polys["channel"]
    return fv.fv_mesh(pm, dtype="float64", device=CPU), jfv.fv_mesh(jpm, dtype=jnp.float64)


@pytest.fixture(scope="module")
def skew(polys):
    pm, jpm = polys["skew"]
    return fv.fv_mesh(pm, dtype="float64", device=CPU), jfv.fv_mesh(jpm, dtype=jnp.float64)


# every family make_bcs maps, on the channel's four patches
BC_SPECS = {
    "velocity": ({"inlet": ("fixedValue", [1.0, 0.5, 0.0]), "outlet": ("zeroGradient", None),
                  "walls": ("noSlip", None), "frontAndBack": ("empty", None)}, 3),
    "slip": ({"inlet": ("uniformFixedValue", [2.0, 0.0, 0.0]), "walls": ("slip", None),
              "outlet": ("calculated", None), "frontAndBack": ("symmetry", None)}, 3),
    "slip-scalar": ({"walls": ("symmetryPlane", None), "inlet": ("movingWallVelocity", 0.5)}, 1),
    "inletOutlet": ({"outlet": ("inletOutlet", [0.5, 0.0, 0.0]),
                     "inlet": ("pressureInletOutletVelocity", [0.0, 0.0, 0.0]),
                     "walls": ("pressureInletOutletParSlipVelocity", None)}, 3),
    "pressure": ({"inlet": ("totalPressure", 40.0), "outlet": ("uniformTotalPressure", 10.0),
                  "walls": ("outletInlet", None), "frontAndBack": ("waveTransmissive", None)}, 1),
    "fixed-scalar": ({"outlet": ("fixedValue", None), "inlet": ("fixedValue", 3.0)}, 1),
    "default": ({}, 2),
}


@pytest.mark.parametrize("name", sorted(BC_SPECS))
def test_make_bcs_equal_jax(chan, name):
    m, jm = chan
    spec, n_comp = BC_SPECS[name]
    bc, jbc = fv.make_bcs(m, spec, n_comp), jfv.make_bcs(jm, spec, n_comp)
    for k in ("a", "b", "io_mask", "io_value"):
        assert_same(getattr(bc, k), getattr(jbc, k), k)
    assert (bc.slip_mask is None) == (jbc.slip_mask is None)
    if bc.slip_mask is not None:
        assert_same(bc.slip_mask, jbc.slip_mask, "slip_mask")
    assert bc.a.dtype == torch.float64


def test_make_bcs_unknown_type_raises(chan):
    m, jm = chan
    for make, mesh in ((fv.make_bcs, m), (jfv.make_bcs, jm)):
        with pytest.raises(ValueError, match="fixedGradient"):
            make(mesh, {"inlet": ("fixedGradient", 1.0)}, 1)


@pytest.mark.parametrize("name", ["channel", "pitz"])
def test_build_amg_equals_jax(polys, name):
    pm, jpm = polys[name]
    h = fv.build_amg(fv.fv_mesh(pm, dtype="float32", device=CPU))
    jh = jfv.build_amg(jfv.fv_mesh(jpm, dtype=jnp.float32))
    assert h.sizes == jh.sizes and len(h.sizes) >= (2 if name == "channel" else 6)
    for k in ("aggs", "owners", "neighs", "f2cf"):
        assert len(getattr(h, k)) == len(getattr(jh, k))
        for lvl, (a, b) in enumerate(zip(getattr(h, k), getattr(jh, k))):
            assert_same(a, b, f"{k}[{lvl}]")


def test_carried_tables_equal_the_ported_ones(chan):
    """convert.to_fv_mesh / to_amg / to_bcs of the JAX objects give the
    port's own tables."""
    m, jm = chan
    cm = convert.to_fv_mesh(jm, device=CPU)
    for k in MESH_ARRAYS:
        assert_same(getattr(cm, k), getattr(m, k), k)
        assert getattr(cm, k).dtype == getattr(m, k).dtype
    assert cm.patch_slices == m.patch_slices and cm.n_internal == m.n_internal
    h, ch = fv.build_amg(m), convert.to_amg(jfv.build_amg(jm), device=CPU)
    assert ch.sizes == h.sizes
    for k in ("aggs", "owners", "neighs", "f2cf"):
        for a, b in zip(getattr(ch, k), getattr(h, k)):
            assert_same(a, b, k)
            assert a.dtype == b.dtype == torch.int64
    spec, n_comp = BC_SPECS["slip"]
    cb, b = convert.to_bcs(jfv.make_bcs(jm, spec, n_comp), device=CPU), fv.make_bcs(m, spec, n_comp)
    for k in ("a", "b", "io_mask", "io_value", "slip_mask"):
        assert_same(getattr(cb, k), getattr(b, k), k)


# ---------------------------------------------------------------------------
# operators in float64 on the same inputs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def inputs(skew):
    """Random fields on the skewed channel (seed 0): a cell scalar and
    vector, a face flux of both signs, a face diffusivity, and BCs with
    every branch (fixed, gradient, slip, inletOutlet)."""
    m, jm = skew
    rng = np.random.default_rng(0)
    spec_u = {"inlet": ("fixedValue", [1.0, 0.2, 0.1]), "outlet": ("inletOutlet", [0.3, 0, 0]),
              "walls": ("slip", None), "frontAndBack": ("noSlip", None)}
    spec_p = {"outlet": ("fixedValue", 0.5), "walls": ("zeroGradient", None)}
    d = dict(p=rng.normal(size=m.n_cells), u=rng.normal(size=(m.n_cells, 3)),
             flux=rng.normal(size=m.n_faces) * 1e-3, gamma=rng.uniform(1e-3, 2e-3, m.n_faces),
             ddt=rng.uniform(1.0, 2.0, m.n_cells))
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    j = {k: jnp.asarray(v) for k, v in d.items()}
    t.update(bu=fv.make_bcs(m, spec_u, 3), bp=fv.make_bcs(m, spec_p, 1))
    j.update(bu=jfv.make_bcs(jm, spec_u, 3), bp=jfv.make_bcs(jm, spec_p, 1))
    return t, j


def _transport(lib, mesh, a, ddt):
    kw = dict(ddt_coeff=a["ddt"], phi_old=a["u"]) if ddt else {}
    return lib.assemble_transport(mesh, a["flux"], a["gamma"], a["bu"], 3, **kw)


def _lap(lib, mesh, a):
    """A symmetric positive definite pressure operator (the SIMPLE one) of
    the random diffusivity."""
    A, _ = (simple if lib is fv else jsimple)._pressure_matrix(mesh, a["gamma"], a["bp"], False)
    return A


OPS = {
    "face_interp_scalar": lambda L, m, a: L.face_interp(m, a["p"]),
    "face_interp_vector": lambda L, m, a: L.face_interp(m, a["u"]),
    "boundary_value_scalar": lambda L, m, a: L.boundary_value(m, a["bp"], a["p"]),
    "boundary_value_slip": lambda L, m, a: L.boundary_value(m, a["bu"], a["u"]),
    "effective_bcs": lambda L, m, a: L.effective_bcs(a["bu"], a["flux"][m.n_internal:]).b,
    "surface_sum": lambda L, m, a: L.surface_sum(m, a["flux"]),
    "surface_sum_internal": lambda L, m, a: L.surface_sum_internal(m, a["flux"][:m.n_internal]),
    "divergence": lambda L, m, a: L.divergence(m, a["flux"]),
    "gradient": lambda L, m, a: L.gradient(m, a["p"], a["bp"]),
    "flux_of": lambda L, m, a: L.flux_of(m, a["u"], a["bu"]),
    "conv_upwind": lambda L, m, a: L.convection_correction(m, a["flux"], a["u"], a["bu"],
                                                           "upwind"),
    "conv_linear": lambda L, m, a: L.convection_correction(m, a["flux"], a["u"], a["bu"],
                                                           "linear"),
    "conv_linearUpwind": lambda L, m, a: L.convection_correction(m, a["flux"], a["u"],
                                                                 a["bu"], "linearUpwind"),
    "conv_limitedLinear": lambda L, m, a: L.convection_correction(m, a["flux"], a["u"],
                                                                  a["bu"], "limitedLinear"),
    "conv_limitedLinear_scalar": lambda L, m, a: L.convection_correction(
        m, a["flux"], a["p"], a["bp"], "limitedLinear"),
    "nonortho_flux": lambda L, m, a: L.nonortho_flux(m, a["gamma"], a["p"], a["bp"]),
    "transport_diag": lambda L, m, a: _transport(L, m, a, False).diag,
    "transport_lower": lambda L, m, a: _transport(L, m, a, False).lower,
    "transport_upper": lambda L, m, a: _transport(L, m, a, False).upper,
    "transport_source": lambda L, m, a: _transport(L, m, a, False).source,
    "transport_ddt_diag": lambda L, m, a: _transport(L, m, a, True).diag,
    "transport_ddt_source": lambda L, m, a: _transport(L, m, a, True).source,
    "matvec_vector": lambda L, m, a: L.matvec(m, _transport(L, m, a, False), a["u"]),
    "matvec_scalar": lambda L, m, a: L.matvec(m, _lap(L, m, a), a["p"]),
    "h_operator": lambda L, m, a: L.h_operator(m, _transport(L, m, a, True), a["u"]),
    "jacobi_solve": lambda L, m, a: L.jacobi_solve(m, _transport(L, m, a, True),
                                                   _transport(L, m, a, True).source, a["u"],
                                                   sweeps=4, relax=0.8),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_operator_matches_jax(skew, inputs, name):
    (m, jm), (t, j) = skew, inputs
    assert_close(OPS[name](fv, m, t), OPS[name](jfv, jm, j), OP_TOL, name)


def test_nonortho_is_live_on_the_skewed_channel(skew, inputs):
    """The skewed mesh's correction vector and the corrector flux are far
    from zero (unlike tests/test_fv_schemes.py's orthogonal box)."""
    (m, _), (t, _) = skew, inputs
    assert float(m.nonortho.abs().max()) > 1e-5
    assert float(fv.nonortho_flux(m, t["gamma"], t["p"], t["bp"]).abs().max()) > 1e-6


def test_amg_coarse_ops_and_vcycle_match_jax(skew, inputs):
    """The Galerkin levels (JAX's mode="drop" scatters against the spare
    slot) and one V-cycle."""
    (m, jm), (t, j) = skew, inputs
    A, jA = _lap(fv, m, t), _lap(jfv, jm, j)
    h, jh = fv.build_amg(m), jfv.build_amg(jm)
    levels, jlevels = fv.amg_coarse_ops(m, h, A), jfv.amg_coarse_ops(jm, jh, jA)
    assert len(levels) == len(jlevels) == len(h.sizes) >= 2
    for lvl, ((d, o), (jd, jo)) in enumerate(zip(levels, jlevels)):
        assert_close(d, jd, OP_TOL, f"diag[{lvl}]")
        assert_close(o, jo, OP_TOL, f"off[{lvl}]")
        assert d.shape[0] == h.sizes[lvl]
    assert_close(fv.amg_vcycle(m, h, A, levels, t["p"]),
                 jfv.amg_vcycle(jm, jh, jA, jlevels, j["p"]), OP_TOL, "vcycle")


@pytest.mark.parametrize("solver", ["cg", "amg"])
def test_cg_solvers_match_jax(skew, inputs, solver):
    (m, jm), (t, j) = skew, inputs
    A, jA = _lap(fv, m, t), _lap(jfv, jm, j)
    b, jb = t["p"] * 1e-3, j["p"] * 1e-3
    x0, jx0 = torch.zeros_like(b), jnp.zeros_like(jb)
    if solver == "amg":
        x, res, it = fv.amg_cg_solve(m, fv.build_amg(m), A, b, x0, tol=1e-8, max_iter=300)
        jx, jres, jit = jfv.amg_cg_solve(jm, jfv.build_amg(jm), jA, jb, jx0, tol=1e-8,
                                          max_iter=300)
    else:
        x, res, it = fv.cg_solve(m, A, b, x0, tol=1e-8, max_iter=2000)
        jx, jres, jit = jfv.cg_solve(jm, jA, jb, jx0, tol=1e-8, max_iter=2000)
    assert it == int(jit) and 3 < it < (300 if solver == "amg" else 2000)
    assert isinstance(it, int)
    assert_close(x, jx, SOLVE_TOL, "x")
    assert float(res) <= 1e-8 and abs(float(res) - float(jres)) <= 1e-3 * float(jres)


@pytest.mark.parametrize("case", ["exact_start", "capped"])
def test_cg_loop_semantics_match_jax(skew, inputs, case):
    """JAX's while_loop: the test runs before the body (an exact start
    takes no iteration), and max_iter caps the count."""
    (m, jm), (t, j) = skew, inputs
    A, jA = _lap(fv, m, t), _lap(jfv, jm, j)
    x_true = t["p"]
    b, jb = fv.matvec(m, A, x_true), jfv.matvec(jm, jA, j["p"])
    kw = dict(tol=1e-7, max_iter=3)
    x0, jx0 = (x_true, j["p"]) if case == "exact_start" else (torch.zeros_like(b),
                                                              jnp.zeros_like(jb))
    for solve, jsolve in ((fv.cg_solve, jfv.cg_solve),
                          (lambda *a, **k: fv.amg_cg_solve(m, fv.build_amg(m), *a[1:], **k),
                           lambda *a, **k: jfv.amg_cg_solve(jm, jfv.build_amg(jm), *a[1:],
                                                            **k))):
        x, res, it = solve(m, A, b, x0, **kw)
        jx, jres, jit = jsolve(jm, jA, jb, jx0, **kw)
        assert it == int(jit) == (0 if case == "exact_start" else 3)
        assert_close(x, jx, SOLVE_TOL, case)
        assert_close(res, jres, 1e-6, case)


# ---------------------------------------------------------------------------
# twins of tests/test_fv_schemes.py, on the port (a 20 x 4 x 4 walled box)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    import textwrap

    d = tmp_path_factory.mktemp("box")
    path = d / "blockMeshDict"
    path.write_text(textwrap.dedent("""
        FoamFile { version 2.0; format ascii; class dictionary; object blockMeshDict; }
        convertToMeters 1;
        vertices ( (0 0 0) (10 0 0) (10 1 0) (0 1 0)
                   (0 0 1) (10 0 1) (10 1 1) (0 1 1) );
        blocks ( hex (0 1 2 3 4 5 6 7) (20 4 4) simpleGrading (1 1 1) );
        boundary (
          inlet  { type patch; faces ((0 4 7 3)); }
          outlet { type patch; faces ((1 2 6 5)); }
          walls  { type wall;  faces ((0 1 5 4) (3 7 6 2) (0 3 2 1) (4 5 6 7)); }
        );
    """))
    return fv.fv_mesh(blockmesh.generate(str(path)), dtype="float64", device=CPU)


def _uniform_flux(m, u=(1.0, 0.0, 0.0)):
    bc = fv.make_bcs(m, {}, 3)
    return fv.flux_of(m, torch.tensor(np.tile(u, (m.n_cells, 1))), bc)


def test_correction_zero_on_uniform_field(box):
    m = box
    flux = _uniform_flux(m)
    bc = fv.make_bcs(m, {}, 1)
    phi = torch.ones(m.n_cells, dtype=torch.float64) * 3.7
    for scheme in ("upwind", "linear", "linearUpwind", "limitedLinear"):
        c = fv.convection_correction(m, flux, phi, bc, scheme)
        assert float(c.abs().max()) < 1e-12, scheme


def test_second_order_on_linear_field(box):
    """phi = x with uniform flux: the deferred linear / linearUpwind /
    limitedLinear corrections cancel upwind's O(h) error in the interior."""
    m = box
    flux = _uniform_flux(m)
    phi = m.cc[:, 0].numpy()
    bc = fv.make_bcs(m, {"inlet": ("fixedValue", 0.0)}, 1)
    n_int = m.n_internal
    f_i = flux.numpy()[:n_int]
    own, nei = m.own_i.numpy(), m.neighbour.numpy()
    up = np.where(f_i >= 0, own, nei)
    conv = np.zeros(m.n_cells)
    np.add.at(conv, own, f_i * phi[up])
    np.add.at(conv, nei, -f_i * phi[up])
    cc = m.cc.numpy()
    interior = (cc[:, 0] > 1.0) & (cc[:, 0] < 9.0)
    for scheme in ("linear", "linearUpwind", "limitedLinear"):
        corr = fv.convection_correction(m, flux, m.cc[:, 0], bc, scheme).numpy()
        d = (conv - corr[:, 0]) / m.vol.numpy()
        assert np.abs(d[interior] - 1.0).max() < 1e-10, scheme
        assert np.abs(corr).max() > 1e-6, scheme


def test_limited_linear_bounded(box):
    m = box
    flux = _uniform_flux(m)
    phi = (m.cc[:, 0] > 5.0).to(torch.float64)
    bc = fv.make_bcs(m, {}, 1)
    c_lim = fv.convection_correction(m, flux, phi, bc, "limitedLinear").numpy()
    c_lin = fv.convection_correction(m, flux, phi, bc, "linear").numpy()
    assert np.abs(c_lim).max() <= np.abs(c_lin).max() + 1e-12
    assert np.isfinite(c_lim).all()


def test_effective_bcs_backflow_switch(box):
    m = box
    n_bd = m.n_faces - m.n_internal
    bc = fv.make_bcs(m, {"outlet": ("inletOutlet", [0.5, 0.0, 0.0])}, 3)
    assert bool(bc.io_mask.any())
    io = bc.io_mask.numpy()
    eff = fv.effective_bcs(bc, torch.ones(n_bd, dtype=torch.float64))
    assert np.allclose(eff.a.numpy()[io], 1.0)
    eff = fv.effective_bcs(bc, -torch.ones(n_bd, dtype=torch.float64))
    assert np.allclose(eff.a.numpy()[io], 0.0)
    assert np.allclose(eff.b.numpy()[io, 0], 0.5)


def test_nonortho_vanishes_on_hex(box):
    m = box
    assert float(m.nonortho.abs().max()) < 1e-10
    bc = fv.make_bcs(m, {}, 1)
    p = torch.from_numpy(np.random.default_rng(0).normal(size=m.n_cells))
    corr = fv.nonortho_flux(m, torch.ones(m.n_faces, dtype=torch.float64), p, bc)
    assert float(corr.abs().max()) < 1e-8


def test_read_numerics_tutorials():
    pitz = simple.read_numerics(PITZ)
    assert pitz["div_scheme"] == "linearUpwind"
    assert pitz == jsimple.read_numerics(PITZ)
    tj = simple.read_numerics(TJUNC)
    assert tj["div_scheme"] == "limitedLinear"
    assert tj["n_correctors"] == 2 and tj["n_outer"] == 1
    assert tj == jsimple.read_numerics(TJUNC)


def test_state_carried_across_keeps_dtype_and_values(chan):
    """convert.to_flow_state of a JAX FlowState: same values, same dtype."""
    m, jm = chan
    rng = np.random.default_rng(3)
    jst = jsimple.FlowState(u=jnp.asarray(rng.normal(size=(m.n_cells, 3))),
                            p=jnp.asarray(rng.normal(size=m.n_cells)),
                            flux=jnp.asarray(rng.normal(size=m.n_faces)))
    st = convert.to_flow_state(jst, device=CPU)
    for k in ("u", "p", "flux"):
        assert_same(getattr(st, k), getattr(jst, k), k)
        assert getattr(st, k).dtype == torch.float64
    assert dataclasses.is_dataclass(st)
