"""Whole runs of the cells on the CPU at a test's size, without the look for
a card: the result line has the contract's keys and nothing else, a sound
run is correct, and the control (the reference at the next lower precision
in the program's place) and each fault the cell can have, planted under
the timed path, come out not correct."""

import dataclasses
import json
import time

import pytest
import torch

from harness.run import run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
SEED = 2**31 + 11


def run(cell, trace=False, variant="program", seconds=0.3):
    res = run_cell(cell, SEED, seconds, trace, "cpu", time.perf_counter(), variant=variant)
    json.dumps(res)
    return res


@pytest.mark.parametrize("workload", ["box55.track", "box55.saves"])
def test_sound_run_and_its_line(small_box, workload):
    cell = small_box(workload)
    res = run(cell)
    assert list(res) == KEYS
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert {k: v["unit"] for k, v in res["metrics"].items()} == {
        m["name"]: m["unit"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(res["checks"]) == set(cell.config["limits"])
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())


def test_traced_line_reports_per_layer_metrics_only(small_box):
    cell = small_box("box55.saves")
    res = run(cell, trace=True)
    assert list(res)[-1] == "checks" and set(res) <= set(KEYS) | {"breakdown"}
    names = {m["name"] for m in cell.per_layer}
    assert res["metrics"] and set(res["metrics"]) <= names


def test_particles_control_fails(small_box):
    assert not run(small_box("box55.track", 6, 400), variant="control", seconds=0.1)["correct"]


def _fault_unchanged(monkeypatch):
    from cudaparticlesfoam_tpu_torch import stepper
    monkeypatch.setattr(stepper.PackedRun, "advance", lambda self, *a, **k: None)


def _fault_half_batch(monkeypatch):
    from cudaparticlesfoam_tpu_torch.ops import fused
    real = fused.mega_cycle

    def half(mesh, m, *a, **k):
        k.update(pending=None, scratch=None)
        real(mesh, m[: m.shape[0] // 2], *a, **k)
        return m
    monkeypatch.setattr(fused, "mega_cycle", half)


def _fault_one_answer(monkeypatch):
    from cudaparticlesfoam_tpu_torch import stepper
    real = stepper.PackedRun.result

    def altered(self):
        st = real(self)
        pos = st.pos.clone()
        pos[len(pos) // 3, 0] += 0.25
        return dataclasses.replace(st, pos=pos)
    monkeypatch.setattr(stepper.PackedRun, "result", altered)


@pytest.mark.parametrize("fault", [_fault_unchanged, _fault_half_batch, _fault_one_answer],
                         ids=["state-unchanged", "half-batch", "one-answer-altered"])
def test_particles_fault_fails(small_box, monkeypatch, fault):
    fault(monkeypatch)
    res = run(small_box("box55.track", 5, 300))
    assert not res["correct"] and res["failed"] >= 1


def test_tjunction_sound_run_and_control(small_tjunction):
    res = run(small_tjunction(), seconds=0.1)
    assert list(res) == KEYS and res["correct"]
    assert set(res["metrics"]) == {"flow_step_ms", "setup_s"}
    assert not run(small_tjunction(), variant="control", seconds=0.1)["correct"]


def _flow_unchanged(monkeypatch):
    from cudaparticlesfoam_tpu_torch.models import pimple
    monkeypatch.setattr(pimple.FlowSolver, "advance",
                        lambda self, dt: {"p_iters": [1, 1]})


def _flow_half_batch(monkeypatch):
    from cudaparticlesfoam_tpu_torch.models import pimple
    real = pimple.pimple_step

    def half(m, st, *a, **k):
        new, res = real(m, st, *a, **k)
        h = m.n_cells // 2
        u = torch.cat([new.u[:h], st.u[h:]])
        return dataclasses.replace(new, u=u), res
    monkeypatch.setattr(pimple, "pimple_step", half)


def _flow_one_answer(monkeypatch):
    from cudaparticlesfoam_tpu_torch.models import pimple
    real = pimple.FlowSolver.advance

    def altered(self, dt):
        res = real(self, dt)
        p = self.state.p.clone()
        p[len(p) // 3] += 0.05 * float(p.abs().max())
        self.state = dataclasses.replace(self.state, p=p)
        return res
    monkeypatch.setattr(pimple.FlowSolver, "advance", altered)


@pytest.mark.parametrize("fault", [_flow_unchanged, _flow_half_batch, _flow_one_answer],
                         ids=["state-unchanged", "half-batch", "one-answer-altered"])
def test_flow_fault_fails(small_tjunction, monkeypatch, fault):
    fault(monkeypatch)
    res = run(small_tjunction(), seconds=0.1)
    assert not res["correct"]


def test_a_run_that_loaded_jax_gives_no_result(small_box, monkeypatch):
    import sys
    import types

    from harness import guard

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(guard.ForbiddenModules, match="jax"):
        run(small_box("box55.saves"))


def test_a_reader_that_loads_jax_gives_no_result(small_box, monkeypatch):
    """The guard looks once the per-layer readers have run."""
    import sys
    import types

    from harness import guard, spec

    real = spec.load_module

    def loading(kind, name):
        mod = real(kind, name)
        if kind != "metrics":
            return mod

        def read(data):
            monkeypatch.setitem(sys.modules, "jaxlib.xla_client", types.ModuleType("x"))
            return mod.read(data)
        return types.SimpleNamespace(read=read)
    monkeypatch.setattr(spec, "load_module", loading)
    with pytest.raises(guard.ForbiddenModules, match="jaxlib"):
        run(small_box("box55.saves"), trace=True)
