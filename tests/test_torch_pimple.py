"""PyTorch port: the transient PIMPLE/PISO solver (``models/pimple.py``)
against the JAX package's on the CPU, and the twins of tests/test_flow.py's
PISO and Courant tests.

Parity: both packages take the same float64 inputs (``convert`` carries the
JAX mesh, BCs, state, AMG hierarchy, MRF zones and fvOptions across) and
run 5 steps each; the fields agree within 1e-9 of each field's largest
magnitude.  The JAX step is one jitted program that keeps its CG counts
inside; here it is re-jitted with its solvers wrapped to report each
solve's count through ``jax.debug.callback``, so the AMG-CG counts can be
compared one for one (equal).  Jacobi-CG cases solve to p_tol 1e-10 (a
solve of a few hundred iterations carries two summation orders apart at
the default 1e-6, tests/test_torch_flow.py) and allow 1% in the counts."""

from torch_port_common import (CPU, FakeCase, FVO_CHANNEL_BMD, MRF_BOX_BMD, assert_logs_match,
                               cell_zones_text, make_channel_case, mrf_props, shrink_tjunction,
                               write_files, write_polymesh_of)

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from cudaparticlesfoam_tpu.io import blockmesh as jblockmesh
from cudaparticlesfoam_tpu.models import fv as jfv
from cudaparticlesfoam_tpu.models import fvoptions as jfvo
from cudaparticlesfoam_tpu.models import mrf as jmrf
from cudaparticlesfoam_tpu.models import pimple as jpimple
from cudaparticlesfoam_tpu.models import simple as jsimple
from cudaparticlesfoam_tpu_torch import convert
from cudaparticlesfoam_tpu_torch.io import blockmesh
from cudaparticlesfoam_tpu_torch.models import pimple, simple

FIELD_TOL = 1e-9     # float64, 5 steps, relative to each field's largest magnitude
N_STEPS = 5


def np_(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def rel_err(got, want):
    got, want = np_(got), np_(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-300)


def counted_jax_step(monkeypatch):
    """(a fresh jit of the JAX pimple_step whose pressure solves report their
    CG counts, the list they are appended to)."""
    counts = []

    def wrap(orig):
        def solve(*a, **k):
            x, res, it = orig(*a, **k)
            jax.debug.callback(lambda i: counts.append(int(i)), it, ordered=True)
            return x, res, it
        return solve

    monkeypatch.setattr(jfv, "amg_cg_solve", wrap(jfv.amg_cg_solve))
    monkeypatch.setattr(jfv, "cg_solve", wrap(jfv.cg_solve))
    return jax.jit(jpimple.pimple_step.__wrapped__, static_argnames=("cfg",)), counts


@pytest.fixture(scope="module")
def channel(tmp_path_factory):
    """tests/test_flow.py's channel (40 x 16 x 1, inlet 1 m/s, nu 0.01)."""
    case = make_channel_case(tmp_path_factory.mktemp("pimple"))
    path = f"{case}/system/blockMeshDict"
    return case, blockmesh.generate(path), jblockmesh.generate(path)


def _step_both(monkeypatch, jm, jst, jub, jpb, jcfg, cfg, dt, n=N_STEPS, jamg=None,
               jmrf_z=None, jfvo_=None):
    """``n`` steps of each package from the same inputs; returns (port
    state, JAX state, port counts, JAX counts, port fvo, JAX fvo)."""
    m = convert.to_fv_mesh(jm, device=CPU)
    st = convert.to_flow_state(jst, device=CPU)
    ub, pb = convert.to_bcs(jub, device=CPU), convert.to_bcs(jpb, device=CPU)
    amg = convert.to_amg(jamg, device=CPU) if jamg is not None else None
    z = convert.to_mrf(jmrf_z, device=CPU) if jmrf_z is not None else None
    fvo = convert.to_fvoptions(jfvo_, device=CPU) if jfvo_ is not None else None
    step, jits = counted_jax_step(monkeypatch)
    its = []
    for _ in range(n):
        st, res = pimple.pimple_step(m, st, ub, pb, cfg, dt, amg=amg, mrf=z, fvo=fvo)
        its += res["p_iters"]
        if fvo is not None:
            fvo = dataclasses.replace(fvo, grad_p=res["fvo_grad_p"], dgrad=res["fvo_dgrad"])
        jst, jres = step(jm, jst, jub, jpb, jcfg, dt, amg=jamg, mrf=jmrf_z, fvo=jfvo_)
        if jfvo_ is not None:
            jfvo_ = dataclasses.replace(jfvo_, grad_p=jres["fvo_grad_p"],
                                        dgrad=jres["fvo_dgrad"])
    jax.effects_barrier()
    return st, jst, its, list(jits), fvo, jfvo_


def _assert_states(st, jst, its, jits, exact_counts=True):
    errs = {k: rel_err(getattr(st, k), getattr(jst, k)) for k in ("u", "p", "flux")}
    assert max(errs.values()) <= FIELD_TOL, errs
    assert len(its) == len(jits)
    if exact_counts:
        assert its == jits, (its, jits)
    else:
        assert all(abs(a - b) <= max(1, 0.01 * b) for a, b in zip(its, jits)), (its, jits)
    return errs


@pytest.mark.parametrize("solver,p_tol", [("amg", 1e-6), ("cg", 1e-10)])
def test_pimple_step_matches_jax(channel, monkeypatch, solver, p_tol):
    case, _, jpm = channel
    jm, jst, jub, jpb, nu, pin, _ = jsimple.load_flow_case(case, pm=jpm, dtype=jnp.float64)
    kw = dict(nu=nu, pin_pressure=pin, p_solver=solver, p_tol=p_tol, div_scheme="linearUpwind")
    jamg = jfv.build_amg(jm) if solver == "amg" else None
    st, jst, its, jits, _, _ = _step_both(monkeypatch, jm, jst, jub, jpb,
                                          jpimple.PimpleConfig(**kw), pimple.PimpleConfig(**kw),
                                          0.01, jamg=jamg)
    _assert_states(st, jst, its, jits, exact_counts=solver == "amg")
    assert len(its) == 2 * N_STEPS


def test_pimple_step_nonortho_outer_matches_jax(monkeypatch, tmp_path):
    """Two outer PIMPLE loops and one non-orthogonal corrector on the skewed
    channel."""
    from torch_port_common import SKEW_VERTICES, channel_bmd

    case = make_channel_case(tmp_path, bmd=channel_bmd(SKEW_VERTICES))
    jpm = jblockmesh.generate(f"{case}/system/blockMeshDict")
    jm, jst, jub, jpb, nu, pin, _ = jsimple.load_flow_case(case, pm=jpm, dtype=jnp.float64)
    kw = dict(nu=nu, pin_pressure=pin, p_solver="amg", n_outer=2, n_nonortho=1)
    st, jst, its, jits, _, _ = _step_both(monkeypatch, jm, jst, jub, jpb,
                                          jpimple.PimpleConfig(**kw), pimple.PimpleConfig(**kw),
                                          0.01, n=3, jamg=jfv.build_amg(jm))
    _assert_states(st, jst, its, jits)
    assert len(its) == 3 * 2 * 2 * 2


def test_pimple_step_with_mrf_matches_jax(monkeypatch, tmp_path):
    case = write_files(tmp_path / "box", {"system/blockMeshDict": MRF_BOX_BMD})
    pm = write_polymesh_of(case)
    write_files(case, {"constant/polyMesh/cellZones": cell_zones_text("rotor",
                                                                      range(pm.n_cells)),
                       "constant/MRFProperties": mrf_props(2.0, nonrot=("frontAndBack",))})
    jpm = jblockmesh.generate(f"{case}/system/blockMeshDict")
    jm = jfv.fv_mesh(jpm, dtype=jnp.float64)
    z = jmrf.from_case(case, jm, jpm)
    jub = jfv.make_bcs(jm, {"walls": ("noSlip", None), "frontAndBack": ("zeroGradient", None)}, 3)
    jpb = jfv.make_bcs(jm, {}, 1)
    zero = jnp.zeros((jm.n_cells, 3), jnp.float64)
    jst = jpimple.FlowState(u=zero, p=jnp.zeros(jm.n_cells, jnp.float64),
                            flux=jnp.zeros(jm.n_faces, jnp.float64))
    kw = dict(nu=0.05, pin_pressure=True, n_correctors=2, p_solver="amg")
    st, jst, its, jits, _, _ = _step_both(monkeypatch, jm, jst, jub, jpb,
                                          jpimple.PimpleConfig(**kw), pimple.PimpleConfig(**kw),
                                          0.01, jamg=jfv.build_amg(jm), jmrf_z=z)
    _assert_states(st, jst, its, jits)
    assert float(np.abs(np_(st.u)).max()) > 1e-3


def test_pimple_step_with_fvoptions_matches_jax(monkeypatch, tmp_path):
    """meanVelocityForce (the controller state too) and semiImplicitSource
    on tests/test_fvoptions.py's channel."""
    d = write_files(tmp_path / "chan", {
        "system/blockMeshDict": FVO_CHANNEL_BMD,
        "system/fvOptions": "FoamFile { version 2.0; format ascii; object fvOptions; }\n"
        "momentumSource {\n type meanVelocityForce;\n meanVelocityForceCoeffs {\n"
        "  selectionMode all;\n  fields (U);\n  Ubar (1 0 0);\n  relaxation 0.8;\n }\n}\n"
        "damping {\n type vectorSemiImplicitSource;\n volumeMode specific;\n"
        " selectionMode all;\n injectionRateSuSp {\n  U ((0.5 0 0) -2.0);\n }\n}\n"})
    jpm = jblockmesh.generate(f"{d}/system/blockMeshDict")
    jm = jfv.fv_mesh(jpm, dtype=jnp.float64)
    jub = jfv.make_bcs(jm, {"walls": ("noSlip", 0.0)}, 3, default="zeroGradient")
    jpb = jfv.make_bcs(jm, {"inlet": ("fixedValue", 0.0), "outlet": ("fixedValue", 0.0)}, 1)
    u0 = jnp.zeros((jm.n_cells, 3), jnp.float64)
    jst = jpimple.FlowState(u=u0, p=jnp.zeros(jm.n_cells, jnp.float64),
                            flux=jfv.flux_of(jm, u0, jub))
    fvo = jfvo.from_case(d, jm, jpm)
    kw = dict(nu=0.01, n_correctors=2, n_jacobi=10, p_tol=1e-6, p_solver="amg")
    st, jst, its, jits, got, want = _step_both(
        monkeypatch, jm, jst, jub, jpb, jpimple.PimpleConfig(**kw), pimple.PimpleConfig(**kw),
        0.02, jamg=jfv.build_amg(jm), jfvo_=fvo)
    _assert_states(st, jst, its, jits)
    for k in ("grad_p", "dgrad"):
        assert rel_err(getattr(got, k), getattr(want, k)) <= FIELD_TOL, k
    assert float(got.grad_p) != 0.0


def test_flow_solver_on_the_tjunction_matches_jax(tmp_path, monkeypatch):
    """FlowSolver.from_case + 5 advance() steps on the shrunk TJunction
    (kEpsilon, AMG-CG, the p0 ramps), both packages in float64: U, p, flux,
    k and epsilon within 1e-9, the AMG-CG counts equal, and the log lines
    equal number for number (torch_port_common.assert_logs_match: within
    1e-6, or both at rounding level)."""
    from cudaparticlesfoam_tpu.io import polymesh as jpolymesh
    from cudaparticlesfoam_tpu_torch.io import polymesh

    case = shrink_tjunction(tmp_path)
    write_polymesh_of(case)
    mesh_dir = f"{case}/constant/polyMesh"
    jload = jpimple.load_flow_case
    monkeypatch.setattr(jpimple, "load_flow_case",
                        lambda *a, **k: jload(*a, **dict(k, dtype=jnp.float64)))
    jlogs, logs = [], []
    jflow = jpimple.FlowSolver.from_case(FakeCase(case, jpolymesh.read_polymesh(mesh_dir)),
                                         log=lambda *a: jlogs.append(" ".join(map(str, a))))
    flow = pimple.FlowSolver.from_case(FakeCase(case, polymesh.read_polymesh(mesh_dir)),
                                       log=lambda *a: logs.append(" ".join(map(str, a))),
                                       dtype=torch.float64, device=CPU)
    step, jits = counted_jax_step(monkeypatch)
    monkeypatch.setattr(jpimple, "pimple_step", step)
    its = []
    for dt in (1e-3, 1.2e-3, 1.2e-3, 1.44e-3, 1.44e-3):
        its += flow.advance(dt)["p_iters"]
        jflow.advance(dt)
    jax.effects_barrier()
    assert_logs_match(logs, jlogs)
    assert its == jits and len(its) == 10
    for k in ("u", "p", "flux"):
        assert rel_err(getattr(flow.state, k), getattr(jflow.state, k)) <= FIELD_TOL, k
    for k in ("k", "eps", "nut"):
        assert rel_err(getattr(flow.kes, k), getattr(jflow.kes, k)) <= FIELD_TOL, k
    assert flow.stable_dt(type("C", (), {"delta_t": 1e-3, "max_co": 5.0})) == pytest.approx(
        jflow.stable_dt(type("C", (), {"delta_t": 1e-3, "max_co": 5.0})), rel=1e-12)


def test_correct_flux_and_courant_number_match_jax(channel):
    case, _, jpm = channel
    jm, jst, jub, jpb, nu, pin, _ = jsimple.load_flow_case(case, pm=jpm, dtype=jnp.float64)
    cc = np.asarray(jm.cc)
    u = np.stack([cc[:, 0], cc[:, 1] * 3.0, np.zeros(len(cc))], axis=1)
    jflux = jfv.flux_of(jm, jnp.asarray(u), jub)
    want, wres = jpimple.correct_flux(jm, jflux, jpb, pin=pin)
    m = convert.to_fv_mesh(jm, device=CPU)
    got, res = pimple.correct_flux(m, torch.as_tensor(np.array(jflux)),
                                   convert.to_bcs(jpb, device=CPU), pin=pin)
    # a Jacobi-CG solve to 1e-8 in two orders of summation
    assert rel_err(got, want) <= FIELD_TOL
    assert float(res) == pytest.approx(float(wres), rel=1e-6, abs=1e-14)
    co = float(pimple.courant_number(m, torch.as_tensor(np.array(jflux)), 0.01))
    assert co == pytest.approx(float(jpimple.courant_number(jm, jflux, 0.01)), rel=1e-14)


# ---------------------------------------------------------------- twins of tests/test_flow.py


def test_piso_transient_to_steady(channel):
    """Twin of tests/test_flow.py::test_piso_transient_to_steady (float32)."""
    case, pm, _ = channel
    m, st, u_bcs, p_bcs, nu, pin, _ = simple.load_flow_case(case, pm=pm, device=CPU)
    cfg = pimple.PimpleConfig(nu=nu, pin_pressure=pin)
    for _ in range(200):
        st, res = pimple.pimple_step(m, st, u_bcs, p_bcs, cfg, 0.01)
    u = st.u.numpy()
    cc = m.cc.numpy()
    sel = np.abs(cc[:, 0] - 1.9) < 0.05
    ux = u[sel, 0]
    y = cc[sel, 1]
    ana = 6.0 * (y / 0.1) * (1.0 - y / 0.1)
    assert np.abs(ux - ana).max() / 1.5 < 0.03
    assert float(res["continuity"]) < 1e-4


def test_courant_number(channel):
    """Twin of tests/test_flow.py::test_courant_number."""
    case, pm, _ = channel
    m, st, *_ = simple.load_flow_case(case, pm=pm, device=CPU)
    co = float(pimple.courant_number(m, st.flux, 0.01))
    # u=1, dx = 2/40 = 0.05 -> Co ~ 0.2 (plus cross-terms)
    assert 0.1 < co < 0.6
