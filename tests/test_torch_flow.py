"""PyTorch port: the steady-flow solver (``models/simple.py``,
``models/turbulence.py``) against the JAX package's on the CPU, the twins
of tests/test_flow.py (all but its PISO/pimple and RK4 tests), and the CLI
chain of the pitzDaily Allrun (blockMesh -> simple -> uncoupled).

SIMPLE parity: both packages start from one state (JAX runs ``N0``
iterations, ``convert`` carries the state across), then each takes 10
iterations in float64.  The fields agree within 1e-9 of each field's
largest magnitude; the AMG-CG counts (~60 a solve) are identical.  The two
packages sum in different orders.  A Jacobi-CG solve of ~340 iterations
turns that into a drift: stopped at the default p_tol 1e-7, ~5e-9 in the
first iteration from the cold start, and from the channel's state after 20
iterations the two part at the 9th (318 against 309 CG iterations,
7.7e-9).  So the Jacobi-CG cases solve to p_tol 1e-10 (fields within
~1e-11), where the counts still cross the tolerance a step or two apart
(measured: at most 2 in 40 solves): they must agree within 1% there.
limitedLinear runs on a 3-D duct:
on a 2-D case JAX's V-limiter takes the min over components, one of which
is the empty direction's rounding noise (~1e-15), so the limiter, and with
it the run, follows ulps (ROADMAP.md queue 3, known differences)."""

import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudaparticlesfoam_tpu.io import blockmesh as jblockmesh
from cudaparticlesfoam_tpu.models import fv as jfv
from cudaparticlesfoam_tpu.models import simple as jsimple
from cudaparticlesfoam_tpu.models import turbulence as jturb
from cudaparticlesfoam_tpu_torch import convert
from cudaparticlesfoam_tpu_torch.io import blockmesh, foamfile, polymesh
from cudaparticlesfoam_tpu_torch.models import fv, simple
from cudaparticlesfoam_tpu_torch.models import turbulence as turb

from torch_port_common import (CPU, FLOW_PARITY, PITZ, REPO, make_channel_case, make_flow_case,
                               simple_steps)

FIELD_TOL = 1e-9     # float64, 10 SIMPLE iterations, relative to each field's max
STEP_TOL = 1e-12     # one closure step from the same inputs
N0 = 20              # JAX iterations before the state is carried across
QUIET = lambda *a: None  # noqa: E731


def np_(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def rel_err(got, want):
    got, want = np_(got), np_(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-300)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """{name: (case dir, port PolyMesh, JAX PolyMesh)} of every flow case."""
    root = tmp_path_factory.mktemp("flow")
    out = {}
    for name in ("channel", "skew", "duct", "backflow", "kEpsilon", "kOmegaSST"):
        case = make_flow_case(root, name)
        path = f"{case}/system/blockMeshDict"
        out[name] = (case, blockmesh.generate(path), jblockmesh.generate(path))
    return out


def _setup(lib, turb_lib, case, pm, solver, scheme, n_nonortho, p_tol=1e-7, **kw):
    m, st, ub, pb, nu, pin, _ = lib.load_flow_case(case, pm=pm, **kw)
    cfg = lib.SimpleConfig(nu=nu, pin_pressure=pin, div_scheme=scheme, p_solver=solver,
                           n_nonortho=n_nonortho, p_tol=p_tol)
    amg = lib.fv.build_amg(m) if solver == "amg" else None
    model = lib.turbulence_model(case)
    closure = None
    if model != "laminar":
        closure = (model,) + tuple(turb_lib.init_model(model, case, m))
    return m, st, ub, pb, cfg, amg, closure


def _parity(case, pm, jpm, solver, scheme, n_nonortho, p_tol, n0, n=10):
    """JAX ``n0`` iterations, then ``n`` in each package from the carried
    state; returns ((state, closure, its) port, (...) JAX, JAX mesh, the
    carried flux)."""
    jm, jst, jub, jpb, jcfg, jamg, jcl = _setup(jsimple, jturb, case, jpm, solver, scheme,
                                                n_nonortho, p_tol, dtype=jnp.float64)
    m, _, ub, pb, cfg, amg, cl = _setup(simple, turb, case, pm, solver, scheme, n_nonortho,
                                        p_tol, dtype=torch.float64, device=CPU)
    jst, jcl, _ = simple_steps(jsimple, jturb, jm, jst, jub, jpb, jcfg, jamg, jcl, n0)
    st = convert.to_flow_state(jst, device=CPU)
    if cl is not None:
        cl = (cl[0], convert.to_turbulence_state(jcl[1], device=CPU)) + cl[2:]
    start_flux = np_(jst.flux)
    got = simple_steps(simple, turb, m, st, ub, pb, cfg, amg, cl, n)
    want = simple_steps(jsimple, jturb, jm, jst, jub, jpb, jcfg, jamg, jcl, n)
    return got, want, jm, start_flux


def _assert_flow_parity(got, want, tol, exact_counts=True):
    (st, cl, its), (jst, jcl, jits) = got, want
    if exact_counts:
        assert its == jits, (its, jits)
    else:
        assert all(abs(a - b) <= max(1, 0.01 * b) for a, b in zip(its, jits)), (its, jits)
    errs = {k: rel_err(getattr(st, k), getattr(jst, k)) for k in ("u", "p", "flux")}
    if cl is not None:
        for k in ("k", "eps", "omega", "nut"):
            if hasattr(jcl[1], k):
                errs[k] = rel_err(getattr(cl[1], k), getattr(jcl[1], k))
    assert max(errs.values()) <= tol, errs
    for k in ("u", "p", "flux"):
        assert torch.isfinite(getattr(st, k)).all()
    return errs


@pytest.mark.parametrize("name", sorted(FLOW_PARITY))
def test_simple_iterations_match_jax(cases, name):
    flow, solver, scheme, n_nonortho, p_tol = FLOW_PARITY[name]
    case, pm, jpm = cases[flow]
    n0 = 0 if flow == "backflow" else N0
    got, want, jm, start_flux = _parity(case, pm, jpm, solver, scheme, n_nonortho, p_tol, n0)
    _assert_flow_parity(got, want, FIELD_TOL, exact_counts=solver == "amg")
    if flow == "backflow":
        # the inletOutlet switch is live in the compared iterations
        _, _, start, cnt = {p[0]: p for p in jm.patch_slices}["outlet"]
        assert (start_flux[jm.n_internal + start:jm.n_internal + start + cnt] < 0).any()
    if flow == "skew":
        assert float(np.abs(np.asarray(jm.nonortho)).max()) > 1e-5


def test_pitzdaily_simple_matches_jax():
    """pitzDaily as it ships (12,225 cells, kEpsilon, linearUpwind, AMG-CG):
    10 iterations from the cold start, float64."""
    pm, jpm = (blockmesh.generate(f"{PITZ}/system/blockMeshDict"),
               jblockmesh.generate(f"{PITZ}/system/blockMeshDict"))
    got, want, jm, _ = _parity(PITZ, pm, jpm, "amg", "linearUpwind", 0, 1e-7, n0=0)
    assert jm.n_cells == 12225 and got[1][0] == "kEpsilon"
    _assert_flow_parity(got, want, FIELD_TOL)


# ---------------------------------------------------------------------------
# the case set-up and the closure pieces against JAX
# ---------------------------------------------------------------------------


def test_load_flow_case_matches_jax(cases, tmp_path):
    """Fields, BCs, nu, pin and the p0 table; a restart directory's fields
    with the BCs from 0/."""
    case = make_channel_case(tmp_path, "ramp", p=(
        "FoamFile { version 2.0; format ascii; class volScalarField; object p; }\n"
        "dimensions [0 2 -2 0 0 0 0];\ninternalField uniform 0;\nboundaryField {\n"
        " inlet { type uniformTotalPressure;\n   p0 table ( (0 40) (1 10) );\n"
        " value uniform 40; }\n outlet { type fixedValue; value uniform 0; }\n"
        " walls { type zeroGradient; }\n frontAndBack { type empty; }\n}\n"))
    pm = blockmesh.generate(f"{case}/system/blockMeshDict")
    rng = np.random.default_rng(1)
    os.makedirs(f"{case}/7")
    polymesh.write_field(f"{case}/7/U", "U", rng.normal(size=(pm.n_cells, 3)))
    for time_dir in ("0", "7"):
        m, st, ub, pb, nu, pin, tab = simple.load_flow_case(case, pm=pm, dtype=torch.float64,
                                                            time_dir=time_dir, device=CPU)
        jm, jst, jub, jpb, jnu, jpin, jtab = jsimple.load_flow_case(
            case, pm=jblockmesh.generate(f"{case}/system/blockMeshDict"), dtype=jnp.float64,
            time_dir=time_dir)
        assert (nu, pin, tab) == (jnu, jpin, jtab) and not pin
        assert tab == {"inlet": [(0.0, 40.0), (1.0, 10.0)]}
        for k in ("u", "p"):
            np.testing.assert_array_equal(np_(getattr(st, k)), np_(getattr(jst, k)))
        assert rel_err(st.flux, jst.flux) <= STEP_TOL
        for a, b in ((ub, jub), (pb, jpb)):
            for k in ("a", "b", "io_mask", "io_value"):
                np.testing.assert_array_equal(np_(getattr(a, k)), np_(getattr(b, k)))


@pytest.fixture(scope="module")
def closure_inputs(cases):
    """Both closures after 3 JAX SIMPLE iterations on the turbulent
    channel, with the port's own set-up of the same case."""
    out = {}
    for model in ("kEpsilon", "kOmegaSST"):
        case, pm, jpm = cases[model]
        jm, jst, jub, jpb, jcfg, jamg, jcl = _setup(jsimple, jturb, case, jpm, "amg",
                                                    "linearUpwind", 0, dtype=jnp.float64)
        jst, jcl, _ = simple_steps(jsimple, jturb, jm, jst, jub, jpb, jcfg, jamg, jcl, 3)
        port = _setup(simple, turb, case, pm, "amg", "linearUpwind", 0, dtype=torch.float64,
                      device=CPU)
        out[model] = (port, (jm, jst, jub, jcfg, jcl))
    return out


@pytest.mark.parametrize("model", ["kEpsilon", "kOmegaSST"])
def test_init_model_matches_jax(closure_inputs, model, cases):
    (m, _, _, _, _, _, cl), _ = closure_inputs[model]
    case, _, jpm = cases[model]
    jm = jfv.fv_mesh(jpm, dtype=jnp.float64)
    jstate, jba, jbb, jwi = jturb.init_model(model, case, jm)
    _, state, ba, bb, wi = cl
    for k in ("k", "nut") + (("eps",) if model == "kEpsilon" else ("omega", "y")):
        assert rel_err(getattr(state, k), getattr(jstate, k)) <= STEP_TOL, k
    for a, b in ((ba, jba), (bb, jbb)):
        for k in ("a", "b", "io_mask"):
            np.testing.assert_array_equal(np_(getattr(a, k)), np_(getattr(b, k)))
    for k in ("wall_cell", "y_wall", "wall_bd_face"):
        np.testing.assert_array_equal(np_(getattr(wi, k)), np_(getattr(jwi, k)))
    assert len(np_(wi.wall_cell)) == 80     # 40 cells on each wall


@pytest.mark.parametrize("dt", [None, 0.01])
@pytest.mark.parametrize("model", ["kEpsilon", "kOmegaSST"])
def test_closure_step_matches_jax(closure_inputs, model, dt):
    (m, _, ub, _, cfg, _, cl), (jm, jst, jub, jcfg, jcl) = closure_inputs[model]
    kes = convert.to_turbulence_state(jcl[1], device=CPU)
    st = convert.to_flow_state(jst, device=CPU)
    got = turb.model_step(model, m, kes, st.u, ub, st.flux, cl[2], cl[3], cl[4], cfg.nu, dt=dt)
    want = jturb.model_step(model, jm, jcl[1], jst.u, jub, jst.flux, jcl[2], jcl[3], jcl[4],
                            jcfg.nu, dt=dt)
    for k in ("k", "nut") + (("eps",) if model == "kEpsilon" else ("omega",)):
        assert rel_err(getattr(got, k), getattr(want, k)) <= STEP_TOL, k
    nut_bd = turb.wall_nut_bd(m, cl[4], kes.nut, kes.k, cfg.nu)
    jnut_bd = jturb.wall_nut_bd(jm, jcl[4], jcl[1].nut, jcl[1].k, jcfg.nu)
    assert rel_err(nut_bd, jnut_bd) <= STEP_TOL
    pk = turb.production(m, st.u, ub, kes.nut)
    assert rel_err(pk, jturb.production(jm, jst.u, jub, jcl[1].nut)) <= STEP_TOL


def test_wall_penalty_accumulates_repeated_wall_cells(closure_inputs):
    """A wall cell listed twice takes the 1e30 penalty twice, as JAX's
    .at[].add does: with every wall row doubled, both packages agree."""
    (m, _, ub, _, cfg, _, cl), (jm, jst, jub, jcfg, jcl) = closure_inputs["kEpsilon"]
    wi, jwi = cl[4], jcl[4]
    twice = turb.WallInfo(*(torch.cat([x, x]) for x in (wi.wall_cell, wi.y_wall,
                                                        wi.wall_bd_face)))
    jtwice = jturb.WallInfo(*(jnp.concatenate([x, x]) for x in (jwi.wall_cell, jwi.y_wall,
                                                               jwi.wall_bd_face)))
    kes, st = convert.to_turbulence_state(jcl[1], device=CPU), convert.to_flow_state(jst,
                                                                                      device=CPU)
    got = turb.k_epsilon_step(m, kes, st.u, ub, st.flux, cl[2], cl[3], twice, cfg.nu)
    want = jturb.k_epsilon_step(jm, jcl[1], jst.u, jub, jst.flux, jcl[2], jcl[3], jtwice,
                                jcfg.nu)
    assert rel_err(got.eps, want.eps) <= STEP_TOL and rel_err(got.k, want.k) <= STEP_TOL


def test_wall_distance_paths(cases):
    """The k-d tree and the brute-force fallback give JAX's distances."""
    _, pm, jpm = cases["channel"]
    m, jm = fv.fv_mesh(pm, dtype="float64", device=CPU), jfv.fv_mesh(jpm, dtype=jnp.float64)
    y = turb.wall_distance(m)
    np.testing.assert_array_equal(y, jturb.wall_distance(jm))
    wf = fv.host(m.cf)[m.n_internal:][np.concatenate(
        [np.arange(s, s + c) for _, t, s, c in m.patch_slices if t == "wall"])]
    np.testing.assert_allclose(turb._wall_distance_brute(fv.host(m.cc), wf), y, rtol=0,
                               atol=1e-15)


def test_solve_steady_logs_match_jax(cases):
    """solve_steady's log lines letter for letter (every iteration logged),
    the stop rule (initial residual < tol after at least 10 iterations) and
    n_done; kEpsilon's closure line too."""
    for name, tol in (("channel", 1.0), ("kEpsilon", 1.0)):
        case, pm, jpm = cases[name]
        logs, jlogs = [], []
        _, st, bcs = simple.solve_steady(case, pm=pm, n_iters=14, tol=tol, dtype=torch.float64,
                                         log=logs.append, log_every=1, device=CPU)
        _, jst, jbcs = jsimple.solve_steady(case, pm=jpm, n_iters=14, tol=tol,
                                            dtype=jnp.float64, log=jlogs.append, log_every=1)
        assert logs == jlogs
        assert bcs[3] == jbcs[3] == 11 and "converged in 10 iterations" in logs[-1]
        assert vars(bcs[2]) == vars(jbcs[2])
        assert rel_err(st.u, jst.u) <= FIELD_TOL
    assert logs[0].startswith("#flow: kEpsilon closure active (80 wall cells)")


# ---------------------------------------------------------------------------
# twins of tests/test_flow.py on the port (JAX's assertions and tolerances)
# ---------------------------------------------------------------------------


def test_fv_operators_consistency(cases):
    _, pm, _ = cases["channel"]
    m = fv.fv_mesh(pm, dtype="float64", device=CPU)
    phi = m.cc @ torch.tensor([2.0, -3.0, 0.0], dtype=torch.float64)
    bcs = fv.make_bcs(m, {}, 1, default="zeroGradient")
    g = fv.gradient(m, phi, bcs).numpy()
    interior = np.ones(m.n_cells, bool)
    interior[m.own_b.numpy()] = False
    np.testing.assert_allclose(g[interior, 0], 2.0, atol=1e-9)
    np.testing.assert_allclose(g[interior, 1], -3.0, atol=1e-9)
    u = torch.tensor([[1.0, 2.0, 0.0]], dtype=torch.float64).repeat(m.n_cells, 1)
    ubc = fv.make_bcs(m, {}, 3, default="zeroGradient")
    div = fv.divergence(m, fv.flux_of(m, u, ubc)).numpy()
    np.testing.assert_allclose(div, 0.0, atol=1e-9)


def test_simple_poiseuille(cases):
    case, pm, _ = cases["channel"]
    m, st, _ = simple.solve_steady(case, pm=pm, n_iters=400, log=QUIET, dtype=torch.float32,
                                   device=CPU)
    u, cc = st.u.numpy(), m.cc.numpy()
    sel = np.abs(cc[:, 0] - 1.9) < 0.05
    y, ux = cc[sel, 1], u[sel, 0]
    ana = 6.0 * (y / 0.1) * (1.0 - y / 0.1)
    assert np.abs(ux - ana).max() / 1.5 < 0.02
    flux = st.flux.numpy()
    names = {p[0]: p for p in m.patch_slices}
    for nm in ("inlet", "outlet"):
        _, _, start, cnt = names[nm]
        net = flux[m.n_internal + start: m.n_internal + start + cnt].sum()
        assert abs(abs(net) - 1e-3) < 1e-8, nm


def test_write_solution_roundtrip(cases, tmp_path):
    case, pm, _ = cases["channel"]
    m, st, *_ = simple.load_flow_case(case, pm=pm, device=CPU)
    out = simple.write_solution(str(tmp_path), "42", m, st)
    u_back = polymesh.read_field(os.path.join(out, "U"), n_cells=m.n_cells)
    np.testing.assert_allclose(u_back, st.u.numpy(), rtol=1e-6, atol=1e-8)
    # phi reads back on every face, and the files equal the JAX writer's
    jm, jst, *_ = jsimple.load_flow_case(case, pm=jblockmesh.generate(
        f"{case}/system/blockMeshDict"))
    jout = jsimple.write_solution(str(tmp_path / "jax"), "42", jm, jst)
    for name in ("U", "p"):
        with open(os.path.join(out, name)) as a, open(os.path.join(jout, name)) as b:
            assert a.read() == b.read(), name
    phi = polymesh.read_surface_field(os.path.join(out, "phi"), [p[0] for p in m.patch_slices])
    if phi is not None:
        np.testing.assert_allclose(phi, st.flux.numpy(), rtol=1e-6, atol=1e-12)


def _turbulent_profile(case, pm):
    m, st, _ = simple.solve_steady(case, pm=pm, n_iters=250, log=QUIET, device=CPU)
    u = st.u.numpy()
    assert not np.isnan(u).any()
    cc = m.cc.numpy()
    ux = u[np.abs(cc[:, 0] - 1.9) < 0.05, 0]
    return ux.max() / max(ux.mean(), 1e-9)


def test_kepsilon_channel(cases):
    case, pm, _ = cases["kEpsilon"]
    assert simple.turbulence_model(case) == "kEpsilon"
    assert 1.05 < _turbulent_profile(case, pm) < 1.45  # flatter than laminar


def test_komega_sst_channel(cases):
    case, pm, _ = cases["kOmegaSST"]
    assert simple.turbulence_model(case) == "kOmegaSST"
    assert 1.05 < _turbulent_profile(case, pm) < 1.45  # flatter than laminar


def test_slip_bc_zeroes_normal_component(cases):
    _, pm, _ = cases["channel"]
    m = fv.fv_mesh(pm, device=CPU)
    u_bcs = fv.make_bcs(
        m, {"inlet": ("fixedValue", (1.0, 0.5, 0.0)), "outlet": ("zeroGradient", None),
            "walls": ("slip", None), "frontAndBack": ("empty", None)}, 3)
    u = torch.tensor([1.0, 0.7, 0.0], dtype=m.dtype).repeat(m.n_cells, 1)
    ub = fv.boundary_value(m, u_bcs, u).numpy()
    _, _, start, cnt = {p[0]: p for p in m.patch_slices}["walls"]
    sl = slice(start, start + cnt)
    nhat = m.sf.numpy()[m.n_internal:][sl]
    nhat = nhat / np.linalg.norm(nhat, axis=1, keepdims=True)
    np.testing.assert_allclose(np.einsum("ij,ij->i", ub[sl], nhat), 0.0, atol=1e-12)
    np.testing.assert_allclose(np.abs(ub[sl, 0]), 1.0, atol=1e-12)
    flux = fv.flux_of(m, u, u_bcs).numpy()[m.n_internal:][sl]
    np.testing.assert_allclose(flux, 0.0, atol=1e-12)
    p_bcs = fv.make_bcs(m, {"walls": ("symmetry", None)}, 1)
    pb = fv.boundary_value(m, p_bcs, torch.arange(m.n_cells, dtype=m.dtype)).numpy()
    own = m.own_b.numpy()[sl]
    np.testing.assert_allclose(pb[sl], own.astype(float), atol=1e-12)


def test_sst_blending_functions(cases):
    _, pm, _ = cases["channel"]
    m = fv.fv_mesh(pm, device=CPU)
    y = turb.wall_distance(m)
    assert (y > 0).all()
    assert y.max() <= 0.051
    cc = m.cc.numpy()
    np.testing.assert_allclose(y, np.minimum(np.abs(cc[:, 1]), np.abs(0.1 - cc[:, 1])),
                               atol=5e-3)


def test_turbulence_model_unknown_is_error(cases, tmp_path):
    case = str(tmp_path / "badmodel")
    shutil.copytree(cases["channel"][0], case)
    path = f"{case}/constant/turbulenceProperties"
    head = ("FoamFile { version 2.0; format ascii; class dictionary; "
            "object turbulenceProperties; }\n")
    for body, expect in (
            ("simulationType RAS;\nRAS { RASModel SpalartAllmaras; turbulence on; }\n",
             "SpalartAllmaras"),
            ("simulationType LES;\nLES { LESModel Smagorinsky; }\n", "LES"),
            ("simulationType RAS;\nRAS { RASModel kEpsilon; turbulence off; }\n", None)):
        with open(path, "w") as fh:
            fh.write(head + body)
        if expect is None:
            assert simple.turbulence_model(case) == "laminar" == jsimple.turbulence_model(case)
        else:
            for lib in (simple, jsimple):
                with pytest.raises(ValueError, match=expect):
                    lib.turbulence_model(case)


def test_read_residual_control_and_purge(tmp_path):
    assert simple.read_residual_control(PITZ) == jsimple.read_residual_control(PITZ)
    assert simple.read_residual_control(PITZ)["U"] == 1e-3
    for lib, name in ((simple, "port"), (jsimple, "jax")):
        case = tmp_path / name
        for t in ("0", "1", "2.5", "10", "100", "constant"):
            (case / t).mkdir(parents=True)
        lib.purge_old_times(str(case), 2)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) \
        == ["0", "10", "100", "constant"]


# ---------------------------------------------------------------------------
# the entry points: the CLI chain, the device policy, the import boundary
# ---------------------------------------------------------------------------


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", "cudaparticlesfoam_tpu_torch", *args], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=600)


def test_cli_allrun_chain_on_the_cpu(tmp_path):
    """The tutorial's Allrun through the port's CLI on the CPU: blockmesh,
    dict deltaT 1.0, simple --iters 5 (written at the clamped time 282,
    with the streamline file), dict deltaT 0.01, uncoupled with 200
    particles: every lane active and inside the domain."""
    case = str(tmp_path / "pitzDaily")
    shutil.copytree(PITZ, case)
    d = foamfile.read(f"{case}/system/cudaParticlesDict")
    d.pop("FoamFile", None)
    d["numParticles"] = 200
    foamfile.write(f"{case}/system/cudaParticlesDict", d, obj_name="cudaParticlesDict")
    steps = (("blockmesh", case), ("dict", f"{case}/system/controlDict", "-entry", "deltaT",
                                   "-set", "1.0"),
             ("simple", case, "--iters", "5", "--device", "cpu"),
             ("dict", f"{case}/system/controlDict", "-entry", "deltaT", "-set", "0.01"),
             ("uncoupled", case, "--out", str(tmp_path / "out"), "--device", "cpu"))
    outs = []
    for args in steps:
        res = _cli(*args)
        assert res.returncode == 0, (args, res.stderr[-3000:])
        outs.append(res.stdout)
    assert "iteration-time 5 outside the particle window [282, 382]" in outs[2]
    assert "kEpsilon closure active" in outs[2]
    u = polymesh.read_field(f"{case}/282/U")
    assert np.isfinite(u).all() and np.linalg.norm(u, axis=1).max() < 50.0
    for name in ("p", "phi"):
        assert os.path.exists(f"{case}/282/{name}")
    tracks = f"{case}/postProcessing/streamlines/282/tracks.vtk"
    with open(tracks) as fh:
        txt = fh.read()
    assert "POLYDATA" in txt and "LINES 10 " in txt
    assert "nCycles: 100" in outs[4]
    frames = sorted(os.listdir(tmp_path / "out"))
    assert len(frames) == 11
    import xml.etree.ElementTree as ET

    root = ET.parse(str(tmp_path / "out" / frames[-1])).getroot()
    arrays = {da.get("Name"): np.array(da.text.split(), dtype=float)
              for da in root.iter("DataArray")}
    assert (arrays["ParticleType"] > 0).all() and (arrays["ParticleTetID"] >= 0).all()
    assert len(arrays["ParticleType"]) == 200


def test_entry_points_default_to_the_card(cases):
    """Without ``device`` the solver allocates on the card; a CPU-only torch
    raises there and nothing falls back to the CPU."""
    case, pm, _ = cases["channel"]
    if torch.cuda.is_available():
        m, *_ = simple.load_flow_case(case, pm=pm)
        assert m.device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        simple.load_flow_case(case, pm=pm)
    with pytest.raises(RuntimeError, match="CUDA"):
        simple.run(case, n_iters=1, log=QUIET)


def test_models_import_neither_jax_nor_the_jax_package():
    mods = ", ".join(f"cudaparticlesfoam_tpu_torch.models.{m}"
                     for m in ("fv", "simple", "turbulence", "functions"))
    code = (f"import sys, {mods}, cudaparticlesfoam_tpu_torch.convert; "
            "print(sorted(m for m in ('jax', 'triton', 'cudaparticlesfoam_tpu') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
