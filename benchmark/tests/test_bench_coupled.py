"""The coupled cell on the CPU at a test's size (the TJunction shrunk to 1,984
cells, a few thousand tracers): its name lookup, its reference against the
port piece by piece (the tet decomposition, the refresh, the function
objects, whole steps), a sound run, and the control and planted faults,
which must come out not correct."""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from harness import spec
from harness.run import run_cell
from reference import coupled as refc
from reference import particles as ref
from reference import tetmesh
from reference.flow import blockmesh

SEED = 2**31 + 13
QUIET = lambda *a: None  # noqa: E731


@pytest.fixture
def small_coupled(small_tjunction, tmp_path, monkeypatch):
    monkeypatch.setattr(refc, "CACHE", str(tmp_path / "reference"))

    def make(n_particles=3000):
        cell = small_tjunction("tjunction.coupled")
        cell.config = {**cell.config, "n_particles": n_particles}
        return cell
    return make


def run(cell, trace=False, variant="program", seconds=0.1):
    res = run_cell(cell, SEED, seconds, trace, "cpu", time.perf_counter(), variant=variant)
    json.dumps(res)
    return res


def test_the_cell_by_name():
    cell = spec.load_cell("tjunction.coupled")
    assert cell.chips == 1 and cell.config_name == "tjunction-coupled"
    assert cell.traffic["driver"] == "coupled"
    assert [m["name"] for m in cell.end_to_end] == ["flow_step_ms", "setup_s"]
    assert {m["name"] for m in cell.per_layer} == {
        "refresh_ms_per_step.coupled", "advect_ms_per_step.coupled",
        "functions_ms_per_step.coupled", "advect_calls_per_step.coupled",
        "device_idle_share.coupled"}
    for kind, name in [("drivers", "coupled"), ("builders", "foam_coupled")] + [
            ("metrics", m["name"]) for m in cell.per_layer]:
        assert callable(getattr(spec.load_module(kind, name), "run" if kind == "drivers" else
                                "prepare" if kind == "builders" else "read"))
    assert cell.config["n_particles"] == 4_000_000 and cell.config["n_tets"] == 12 * 248_000


def _program_run(case_dir, pos, seed):
    from cudaparticlesfoam_tpu_torch.models import coupled

    return coupled.CoupledRun(case_dir, write_output=False, log=QUIET, device="cpu",
                              rng_seed=seed, positions=pos)


def test_tet_decomposition_and_refresh_equal_the_port(small_coupled):
    """The reference's tets, tet_cell and table are the native builder's,
    and its refresh gives the port's table after ``Case.update_velocity``."""
    from cudaparticlesfoam_tpu_torch.models import case as caselib

    cfg = small_coupled().config
    builder = spec.load_module("builders", "foam_coupled")
    case_dir = builder.prepare(cfg)
    assert caselib._builder_flavor() == "native"
    pm = blockmesh.generate(os.path.join(case_dir, "system", "blockMeshDict"))
    points, tets, tet_cell = tetmesh.decompose(pm)
    case = caselib.load_case(case_dir, log=QUIET, device="cpu")
    host = case.tet_mesh.host
    assert len(tets) == 12 * pm.n_cells
    np.testing.assert_array_equal(tet_cell, case.tet_cell)
    np.testing.assert_array_equal(points.astype(host["points"].dtype), host["points"])
    tab, _ = ref.build_table(points, tets, np.zeros((len(tets), 3)))
    # the port swaps a negative tet's first two vertices, as build_table does
    assert torch.equal(tab[:, :12], case.tet_mesh.tet_row[:, :12])
    assert torch.equal(tab[:, 15:], case.tet_mesh.tet_row[:, 15:])
    u = torch.randn(pm.n_cells, 3, dtype=torch.float32, generator=torch.Generator().manual_seed(5))
    case.update_velocity(u.numpy())
    r = refc.CoupledReference.__new__(refc.CoupledReference)
    r.tab, r.tet_cell, r.low = tab, torch.as_tensor(tet_cell), False
    r.refresh(u)
    assert torch.equal(r.tab, case.tet_mesh.tet_row)


def test_reference_geometry_is_kept_and_its_grid_is_the_particles_one(small_coupled):
    """The reference's geometry, built once and read back, is what it
    builds; its device-filled seeding grid gives particles.grid_start's
    start tets."""
    cfg = small_coupled().config
    builder = spec.load_module("builders", "foam_coupled")
    case_dir = builder.prepare(cfg)
    first = refc.geometry(case_dir, torch.float32)
    assert len(os.listdir(refc.CACHE)) == 1
    again = refc.geometry(case_dir, torch.float32)
    pm = blockmesh.generate(os.path.join(case_dir, "system", "blockMeshDict"))
    points, tets, tet_cell = tetmesh.decompose(pm)
    tab, bd = ref.build_table(points, tets, np.zeros((len(tets), 3)))
    for got in (first, again):
        assert got[0].n_cells == pm.n_cells
        np.testing.assert_array_equal(got[1], points)
        np.testing.assert_array_equal(got[2], tets)
        np.testing.assert_array_equal(got[3], tet_cell)
        assert torch.equal(got[4], tab) and torch.equal(got[5], bd)
    pos = builder.positions(cfg, SEED, "cpu")
    pos = torch.cat([pos, torch.tensor([[0.2, 0.2, 0.01], [0.3, 0.0, -0.1]])])
    assert torch.equal(refc.grid_start(points, tets, pos), ref.grid_start(points, tets, pos))


def test_seeding_equals_the_port_outside_the_domain(small_coupled):
    """Start positions on the walls, outside the domain and inside it: the
    reference's locate gives the port's tet or -1 for every lane."""
    from cudaparticlesfoam_tpu_torch.models import case as caselib
    from cudaparticlesfoam_tpu_torch.ops import locate as locate_ops

    cfg = small_coupled().config
    case_dir = spec.load_module("builders", "foam_coupled").prepare(cfg)
    case = caselib.load_case(case_dir, log=QUIET, device="cpu")
    pm = blockmesh.generate(os.path.join(case_dir, "system", "blockMeshDict"))
    points, tets, _ = tetmesh.decompose(pm)
    tab, _ = ref.build_table(points, tets, np.zeros((len(tets), 3)))
    g = torch.Generator().manual_seed(11)
    pos = torch.rand((400, 3), generator=g, dtype=torch.float64)
    pos = torch.tensor([0.0, -0.011, -0.001]) + pos * torch.tensor([0.06, 0.022, 0.022],
                                                                  dtype=torch.float64)
    pos[:40, 1] = -0.01                        # on a wall
    pos[40:80, 2] = 0.02
    pos[80:120, 0] = 0.0                       # on the inlet
    pos = pos.to(torch.float32)
    mine = locate_ops.locate_seeds(case.tet_mesh, case.locator, pos)
    theirs = refc.locate(tab, points, tets, pos)
    assert torch.equal(mine, theirs)
    assert int((theirs == -1).sum()) > 20 and int((theirs >= 0).sum()) > 200


def test_reference_steps_equal_the_port(small_coupled):
    """Three coupled steps of the reference and of the port from the same
    start: every field, s, every probe sample, every CG count and every
    lane bit for bit."""
    cfg = small_coupled(2000).config
    builder = spec.load_module("builders", "foam_coupled")
    case_dir = builder.prepare(cfg)
    pos = builder.positions(cfg, SEED, "cpu")
    prog = _program_run(case_dir, pos, SEED)
    refs = refc.CoupledReference(case_dir, pos, SEED, cfg["inline_hops"], "cpu")
    assert torch.equal(refs.tet, prog.state.tet_id) and bool((refs.tet >= 0).all())
    hops = 0
    for _ in range(3):
        before = prog.state.tet_id.clone()
        assert list(prog.step()["cg_iterations"]) == refs.step()
        hops += int((prog.state.tet_id != before).sum())
    assert prog.cfg.inline_hops == cfg["inline_hops"]
    assert hops > 0 and prog.step0 == refs.sub_step >= 30
    got = refs.outputs()
    mine = {"U": prog.flow.state.u, "p": prog.flow.state.p, "phi": prog.flow.state.flux,
            "k": prog.flow.kes.k, "epsilon": prog.flow.kes.eps, "s": prog.scalar.s,
            "pos": prog.state.pos, "tet": prog.state.tet_id, "active": prog.state.active}
    assert got.keys() == mine.keys()
    for k in got:
        assert torch.equal(got[k], mine[k]), k
    assert float(got["s"].abs().max()) > 0.0
    samples = prog.probes.samples
    assert len(refs.probes.samples) == len(samples["p"]) == 3
    for (t, p, u), (tp, pp), (tu, pu) in zip(refs.probes.samples, samples["p"], samples["U"]):
        assert t == tp == tu
        assert torch.equal(p, torch.as_tensor(pp)) and torch.equal(u, torch.as_tensor(pu))


def test_coupled_sound_run_and_its_line(small_coupled):
    cell = small_coupled()
    res = run(cell)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1, res["checks"]
    assert set(res["metrics"]) == {"flow_step_ms", "setup_s"}
    assert set(res["checks"]) == set(cell.config["limits"])
    assert res["checks"]["lanes_off_reference"]["value"] == 0


def test_coupled_control_fails(small_coupled):
    res = run(small_coupled(), variant="control")
    assert not res["correct"]


def _fault_one_tet(monkeypatch):
    from cudaparticlesfoam_tpu_torch import stepper
    real = stepper.PackedRun.result

    def altered(self):
        st = real(self)
        tet = st.tet_id.clone()
        tet[len(tet) // 3] = (tet[len(tet) // 3] + 1) % self.mesh.n_tets
        return dataclasses.replace(st, tet_id=tet)
    monkeypatch.setattr(stepper.PackedRun, "result", altered)


def _fault_stale_refresh(monkeypatch):
    from cudaparticlesfoam_tpu_torch.models import case as caselib
    monkeypatch.setattr(caselib.Case, "update_velocity", lambda self, u: None)


def _fault_no_scalar(monkeypatch):
    from cudaparticlesfoam_tpu_torch.models import functions
    monkeypatch.setattr(functions.ScalarTransport, "advance", lambda self, flux, dt: self.s)


@pytest.mark.parametrize("fault", [_fault_one_tet, _fault_stale_refresh, _fault_no_scalar],
                         ids=["one-tet-altered", "refresh-skipped", "scalar-unchanged"])
def test_coupled_fault_fails(small_coupled, monkeypatch, fault):
    fault(monkeypatch)
    res = run(small_coupled(1000))
    assert not res["correct"] and res["failed"] >= 1
