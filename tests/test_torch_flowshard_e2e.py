"""PyTorch port: the domain-decomposed flow solve end to end on the CPU
(``parallel/flowshard.ShardedFlowSolver``, ``run_coupled(flow_devices=N)``,
``dryrun.dryrun_multichip``) on the shrunk TJunction of
tests/test_coupled_e2e.py (1/5 resolution per axis, 1,984 cells; its
decomposeParDict asks for ``simple`` with n (4 1 1)).

* Twins of tests/test_coupled_e2e.py:155 (DP and partitioned particles in
  ``run_coupled``), :198 (kEpsilon), :256 (kOmegaSST), :300 (the dynamic
  mesh) and of tests/test_flowshard.py's two solver tests.
* Parity with JAX in float64: ``ShardedFlowSolver`` against JAX's on the
  same case (kEpsilon, AMG-CG, 4 shards), one step, within 1e-9 and with
  equal CG counts; ``run_coupled(flow_devices=4)`` against JAX's (the same
  noise replayed): tet/active exact, pos within 1e-9.  JAX's sharded solver
  always solves in float32 and keeps the wall distances of its wall
  functions in float32; its float64 runs here take the float64 loader,
  decomposition and wall distances (ROADMAP.md, queue 3's known
  differences)."""

from torch_port_common import (CPU, FakeCase, recorded_noise, shrink_tjunction,
                               write_polymesh_of)

import os  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from cudaparticlesfoam_tpu_torch.io import foamfile, polymesh  # noqa: E402
from cudaparticlesfoam_tpu_torch.models import case as caselib  # noqa: E402
from cudaparticlesfoam_tpu_torch.models import coupled, fv  # noqa: E402
from cudaparticlesfoam_tpu_torch.models.pimple import FlowSolver  # noqa: E402
from cudaparticlesfoam_tpu_torch.parallel import flowshard  # noqa: E402
from cudaparticlesfoam_tpu_torch.parallel.flowshard import ShardedFlowSolver  # noqa: E402

QUIET = lambda *a: None  # noqa: E731
FIELD_TOL = 1e-9


@pytest.fixture(scope="module")
def tj(tmp_path_factory):
    """The shrunk TJunction with its polyMesh (10 particles)."""
    case = shrink_tjunction(tmp_path_factory.mktemp("tjshard"), num_particles=10)
    write_polymesh_of(case)
    return case


def load(case_dir):
    return caselib.load_case(case_dir, log=QUIET, device=CPU)


def rel_rms(a, b):
    a, b = fv.host(a), fv.host(b)
    return np.sqrt(((a - b) ** 2).mean()) / (np.sqrt((a ** 2).mean()) + 1e-12)


def variant(tmp_path, tj, turbulence=None, dynamic=None):
    """A copy of the shrunk TJunction with other turbulenceProperties or a
    dynamicMeshDict."""
    import shutil

    case = str(tmp_path / "TJunction")
    shutil.copytree(tj, case)
    tp = os.path.join(case, "constant", "turbulenceProperties")
    if turbulence == "laminar":
        with open(tp, "w") as fh:
            fh.write("FoamFile { version 2.0; format ascii; class dictionary; "
                     "object turbulenceProperties; }\nsimulationType laminar;\n")
    elif turbulence is not None:
        with open(tp) as fh:
            s = fh.read()
        assert "kEpsilon" in s
        with open(tp, "w") as fh:
            fh.write(s.replace("kEpsilon", turbulence))
    if dynamic is not None:
        with open(os.path.join(case, "constant", "dynamicMeshDict"), "w") as fh:
            fh.write(dynamic)
    return case


# ---------------------------------------------------------------- twins


def test_tjunction_sharded_flow_kepsilon_parity(tj):
    """Twin of tests/test_coupled_e2e.py::test_tjunction_sharded_flow_kepsilon_parity:
    kEpsilon on 4 shards against the single-device solver (U within 5e-4
    after a step; per-field rel-RMS within 5e-3 after 3; the gathered flux
    conservative)."""
    case = load(tj)
    single = FlowSolver.from_case(case, log=QUIET, device=CPU)
    sharded = ShardedFlowSolver(case, 4, log=QUIET, device=CPU)
    assert sharded._turb_on and sharded.turb_model == "kEpsilon"
    assert sharded.smesh.halo_perms == (((1, 0), (2, 1), (3, 2)), ((0, 1), (1, 2), (2, 3)))
    for i in range(3):
        single.advance(0.005)
        res = sharded.advance(0.005)
        if i == 0:
            ua, ub = fv.host(single.state.u), fv.host(sharded.state.u)
            assert np.abs(ua - ub).max() / (np.abs(ua).max() + 1e-12) < 5e-4
    assert np.isfinite(res["u_res"]) and len(res["p_iters"]) == 2
    a, b = single.state, sharded.state
    for name, xa, xb in (("U", a.u, b.u), ("p", a.p, b.p), ("k", single.kes.k, sharded.kes.k),
                         ("epsilon", single.kes.eps, sharded.kes.eps),
                         ("nut", single.kes.nut, sharded.kes.nut)):
        assert rel_rms(xa, xb) < 5e-3, name
    assert float(fv.surface_sum(single.m, b.flux).abs().max()) < 1e-4


def test_tjunction_sharded_flow_komegasst_parity(tj, tmp_path):
    """Twin of tests/test_coupled_e2e.py::test_tjunction_sharded_flow_komegasst_parity."""
    case = load(variant(tmp_path, tj, turbulence="kOmegaSST"))
    single = FlowSolver.from_case(case, log=QUIET, device=CPU)
    sharded = ShardedFlowSolver(case, 4, log=QUIET, device=CPU)
    assert sharded._turb_on and sharded.turb_model == "kOmegaSST"
    for _ in range(3):
        single.advance(0.005)
        sharded.advance(0.005)
    a, b = single.state, sharded.state
    for name, xa, xb in (("U", a.u, b.u), ("p", a.p, b.p), ("k", single.kes.k, sharded.kes.k),
                         ("omega", single.kes.omega, sharded.kes.omega),
                         ("nut", single.kes.nut, sharded.kes.nut)):
        assert rel_rms(xa, xb) < 5e-3, name


OSCILLATING = ("FoamFile { version 2.0; format ascii; class dictionary; "
               "object dynamicMeshDict; }\n"
               "dynamicFvMesh solidBodyMotionFvMesh;\n"
               "solidBodyMotionFunction oscillatingLinearMotion;\n"
               "oscillatingLinearMotionCoeffs { amplitude (0 0.002 0); omega 20; }\n")


def test_tjunction_sharded_flow_dynamic_mesh_parity(tj, tmp_path):
    """Twin of tests/test_coupled_e2e.py::test_tjunction_sharded_flow_dynamic_mesh_parity:
    an oscillating laminar TJunction, the per-shard geometry refreshed in
    place, the psum-global correctPhi, the flux relative to meshPhi."""
    case = load(variant(tmp_path, tj, turbulence="laminar", dynamic=OSCILLATING))
    single = FlowSolver.from_case(case, log=QUIET, device=CPU)
    assert single.dyn is not None
    case2 = load(case.case_dir)          # its own poly mesh: the motion moves the points
    sharded = ShardedFlowSolver(case2, 4, log=QUIET, device=CPU)
    assert sharded.dyn is not None
    for _ in range(3):
        single.advance(0.005)
        sharded.advance(0.005)
    vol = flowshard.gather_cells(sharded.smesh, [sh.m.vol for sh in sharded.smesh.shards])
    np.testing.assert_allclose(fv.host(vol), fv.host(single.m.vol), rtol=1e-6)
    a, b = single.state, sharded.state
    for name, xa, xb in (("U", a.u, b.u), ("p", a.p, b.p)):
        assert rel_rms(xa, xb) < 5e-3, name
    div = fv.host(fv.surface_sum(single.m, b.flux))
    vdot = float(single.m.vol.abs().max()) * 20 * 0.002
    assert np.abs(div).max() < max(1e-4, vdot)


def test_coupled_with_sharded_flow(tmp_path):
    """Twin of tests/test_flowshard.py::test_coupled_with_sharded_flow:
    run_coupled with the flow on 4 shards, 2 steps, 500 particles."""
    case = shrink_tjunction(tmp_path, num_particles=500)
    write_polymesh_of(case)
    out = str(tmp_path / "out")
    os.makedirs(out)
    logs = []
    _, state, stats = coupled.run_coupled(case, out_dir=out, n_steps=2, flow_devices=4,
                                          device=CPU,
                                          log=lambda *a: logs.append(" ".join(map(str, a))))
    assert stats["cycles"] >= 20
    assert state.active.all() and torch.isfinite(state.pos).all()
    steps = [ln for ln in logs if ln.startswith("#coupled: step")]
    assert len(steps) == 2 and all("flow_shards=4 halo_rounds=2" in ln for ln in steps)
    assert all(s["halo_refreshes"] > 0 and s["flow_shards"] == 4 for s in stats["steps"])
    assert any("(sharded)" in ln for ln in logs)


def test_sharded_flow_restarts_from_latest_time(tmp_path):
    """run_coupled with the flow on 4 shards writes the gathered fields
    (U, p, phi, k, epsilon); ShardedFlowSolver resumes a latestTime restart
    at the case's time from them, its flux from the written phi."""
    import re

    case = shrink_tjunction(tmp_path, num_particles=50)
    cd_path = os.path.join(case, "system", "controlDict")
    cd = foamfile.read(cd_path)
    cd.pop("FoamFile", None)
    cd.update(writeControl="timeStep", writeInterval=2, startFrom="latestTime")
    foamfile.write(cd_path, cd, obj_name="controlDict")
    pm = write_polymesh_of(case)
    coupled.run_coupled(case, n_steps=2, flow_devices=4, device=CPU, log=QUIET)
    latest = max((d for d in os.listdir(case) if re.match(r"\d", d) and d != "0"), key=float)
    case2 = load(case)
    assert case2.time_dir == latest
    logs = []
    flow = ShardedFlowSolver(case2, 4, log=lambda *a: logs.append(" ".join(map(str, a))),
                             device=CPU)
    assert flow.time == pytest.approx(float(latest))
    assert any("restart flux from written phi" in ln for ln in logs)
    phi = polymesh.read_surface_field(os.path.join(case, latest, "phi"), pm.patches)
    np.testing.assert_allclose(fv.host(flow.state.flux), phi, atol=1e-7)
    for name, got in (("U", flow.state.u), ("k", flow.kes.k)):
        want = polymesh.read_field(os.path.join(case, latest, name), pm.n_cells)
        np.testing.assert_allclose(fv.host(got), want, atol=1e-5)
    flow.advance(0.001)
    assert torch.isfinite(flow.state.u).all()


def test_local_amg_preconditioner_cuts_iterations(tj):
    """Twin of tests/test_flowshard.py::test_local_amg_preconditioner_cuts_iterations:
    the per-shard AMG V-cycle preconditioner more than halves the
    pressure-CG iterations of Jacobi-CG, to the same pressure field."""
    case = load(tj)
    runs = {}
    for kind in ("amg", "cg"):
        fs = ShardedFlowSolver(case, 4, log=QUIET, device=CPU, p_solver=kind)
        iters = 0
        for _ in range(2):
            iters += sum(fs.advance(0.005)["p_iters"])
        runs[kind] = (iters, fv.host(fs.state.p))
    (it_amg, p_amg), (it_cg, p_cg) = runs["amg"], runs["cg"]
    assert it_amg < 0.5 * it_cg, (it_amg, it_cg)
    assert np.abs(p_amg - p_cg).max() / (np.abs(p_cg).max() + 1e-12) < 5e-3


def test_tjunction_coupled_multichip_particles(tmp_path):
    """Twin of tests/test_coupled_e2e.py::test_tjunction_coupled_multichip_particles:
    DP and partitioned particles over 8 shards in run_coupled track the
    single-device coupled run exactly (Brownian motion off)."""
    states = {}
    for name, kw in (("single", {}), ("dp8", {"devices": 8, "strategy": "dp"}),
                     ("part8", {"devices": 8, "strategy": "partitioned"})):
        case = shrink_tjunction(tmp_path / name, num_particles=400)
        path = os.path.join(case, "system", "cudaParticlesDict")
        d = foamfile.read(path)
        d.pop("FoamFile", None)
        d["useBrownianMotion"] = 0
        foamfile.write(path, d, obj_name="cudaParticlesDict")
        write_polymesh_of(case)
        _, state, stats = coupled.run_coupled(case, write_output=False, n_steps=2,
                                              log=QUIET, device=CPU, **kw)
        assert stats["cycles"] >= 20
        states[name] = state
    ref = states["single"]
    for name in ("dp8", "part8"):
        np.testing.assert_allclose(states[name].pos.numpy(), ref.pos.numpy(), atol=1e-9)
        np.testing.assert_array_equal(states[name].tet_id.numpy(), ref.tet_id.numpy())


def test_sharded_solver_rejects_other_closures(tj, tmp_path):
    """A closure other than laminar, kEpsilon and kOmegaSST raises, as in JAX."""
    case = load(variant(tmp_path, tj, turbulence="realizableKE"))
    with pytest.raises((NotImplementedError, ValueError), match="realizableKE"):
        ShardedFlowSolver(case, 4, log=QUIET, device=CPU)


# ---------------------------------------------------------------- parity with JAX


def jax_float64(monkeypatch):
    """JAX's sharded solver in float64: its loader and decomposition, and its
    wall distances (which ``_wall_arrays`` keeps in float32, so that the
    epsilon wall pin would take ``KAPPA * y`` in float32)."""
    from cudaparticlesfoam_tpu.models import simple as jsimple
    from cudaparticlesfoam_tpu.parallel import flowshard as jfs

    jload, jdec = jsimple.load_flow_case, jfs.decompose
    monkeypatch.setattr(jsimple, "load_flow_case",
                        lambda *a, **k: jload(*a, **dict(k, dtype=jnp.float64)))
    monkeypatch.setattr(jfs, "decompose", lambda *a, **k: jdec(*a, **dict(k, dtype=jnp.float64)))
    orig = jfs.ShardedFlowSolver._wall_arrays

    def wall_arrays(self, m, wi, bglob):
        n = orig(self, m, wi, bglob)
        y_of = np.full(m.n_faces - m.n_internal, -1.0)
        y_of[np.asarray(wi.wall_bd_face)] = np.asarray(wi.y_wall)
        bg = np.asarray(bglob)
        self.y_wall_s = jnp.asarray(np.where(np.asarray(self.wall_bd_s) >= 0,
                                             y_of[np.clip(bg, 0, None)], -1.0))
        return n

    monkeypatch.setattr(jfs.ShardedFlowSolver, "_wall_arrays", wall_arrays)
    return jfs


def test_sharded_flow_solver_matches_jax(tj, monkeypatch):
    """ShardedFlowSolver (kEpsilon, local AMG-CG, 4 shards, the p0 ramps)
    against JAX's in float64, one step at p_tol 1e-11: U, p, flux, k,
    epsilon and nut within 1e-9, the step's CG iterations equal, the
    Courant number's dt within 1e-12."""
    from cudaparticlesfoam_tpu.io import polymesh as jpolymesh

    jfs = jax_float64(monkeypatch)
    mesh_dir = f"{tj}/constant/polyMesh"
    jflow = jfs.ShardedFlowSolver(FakeCase(tj, jpolymesh.read_polymesh(mesh_dir)), 4,
                                  log=QUIET, p_tol=1e-11)
    flow = ShardedFlowSolver(FakeCase(tj, polymesh.read_polymesh(mesh_dir)), 4, log=QUIET,
                             device=CPU, dtype=torch.float64, p_tol=1e-11)
    np.testing.assert_array_equal(
        np.concatenate([fv.host(y) for y in flow.y_wall_s]), np.asarray(jflow.y_wall_s).ravel())
    jres = jflow.advance(1e-3)
    res = flow.advance(1e-3)
    assert sum(res["p_iters"]) == jres["p_iters"]

    def rel(got, want):
        want = np.asarray(want)
        return float(np.abs(fv.host(got) - want).max()) / float(np.abs(want).max())

    for k in ("u", "p", "flux"):
        assert rel(getattr(flow.state, k), getattr(jflow.state, k)) <= FIELD_TOL, k
    for k in ("k", "eps", "nut"):
        assert rel(getattr(flow.kes, k), getattr(jflow.kes, k)) <= FIELD_TOL, k
    ctrl = type("C", (), {"delta_t": 1e-3, "max_co": 5.0})
    assert flow.stable_dt(ctrl) == pytest.approx(jflow.stable_dt(ctrl), rel=1e-12)


def test_run_coupled_sharded_flow_matches_jax(tmp_path, monkeypatch):
    """run_coupled with the flow on 4 shards, both packages in float64, the
    JAX run's threefry normals replayed in the port: 2 Eulerian steps,
    tet/active exact, pos within 1e-9, the same cycles and time."""
    from cudaparticlesfoam_tpu.models import coupled as jcoupled

    jax_float64(monkeypatch)
    case = shrink_tjunction(tmp_path, num_particles=300)
    write_polymesh_of(case)
    _, jstate, jstats = jcoupled.run_coupled(case, n_steps=2, flow_devices=4,
                                             dtype=jnp.float64, write_output=False, log=QUIET)
    n = int(jstate.pos.shape[0])
    key = jax.random.PRNGKey(0)
    noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, s), (n, 3),
                                                   dtype=np.float64))
                      for s in range(jstats["cycles"] + 1)])
    recorded_noise(monkeypatch, noise)
    _, state, stats = coupled.run_coupled(case, n_steps=2, flow_devices=4, dtype=np.float64,
                                          write_output=False, device=CPU,
                                          flow_dtype=torch.float64, log=QUIET)
    assert stats["cycles"] == jstats["cycles"] >= 20
    assert stats["time"] == pytest.approx(jstats["time"], rel=1e-12)
    np.testing.assert_array_equal(state.tet_id.numpy(), np.asarray(jstate.tet_id))
    np.testing.assert_array_equal(state.active.numpy(), np.asarray(jstate.active))
    np.testing.assert_allclose(state.pos.numpy(), np.asarray(jstate.pos), atol=1e-9, rtol=0)


# ---------------------------------------------------------------- dryrun


def test_dryrun_multichip_four_cpu_shards():
    """The port's dryrun_multichip (the twin of __graft_entry__.py's) on 4
    CPU shards: DP = single device, partitioned = single device after a
    settle, the sharded PIMPLE step finite and conservative."""
    from cudaparticlesfoam_tpu_torch import dryrun

    out = dryrun.dryrun_multichip(4, device=CPU)
    assert out["devices"] == ["cpu"] * 4
    assert out["dp_max_abs_err"] <= 1e-6 and out["partitioned_max_abs_err"] <= 1e-6
    assert out["continuity"] < 1e-3 and out["active"] == out["particles"] > 0
