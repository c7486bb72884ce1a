"""PyTorch port: the coupled driver's per-step entry (``coupled.CoupledRun``)
on the CPU, on tests/test_coupled_e2e.py's shrunk TJunction: stepped by hand
it is ``run_coupled``, ``snapshot`` / ``restore`` replay a stretch of steps
bit for bit, and under a profiler its spans nest under ``CoupledRun.step``
with the driver's counters rising once a step, a sub-step and a call."""

from torch_port_common import CPU, shrink_tjunction, write_polymesh_of

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from cudaparticlesfoam_tpu_torch.models import coupled  # noqa: E402
from cudaparticlesfoam_tpu_torch.utils import profiling  # noqa: E402

QUIET = lambda *a: None  # noqa: E731


@pytest.fixture
def tj_case(tmp_path):
    case = shrink_tjunction(tmp_path, num_particles=300, save_interval=2)
    write_polymesh_of(case)
    return case


def outputs(run) -> dict:
    """Everything a step changes that the benchmark compares, copied."""
    f = run.flow
    out = {"U": f.state.u, "p": f.state.p, "phi": f.state.flux, "k": f.kes.k,
           "epsilon": f.kes.eps, "s": run.scalar.s, "pos": run.state.pos,
           "vel": run.state.vel, "tet": run.state.tet_id, "active": run.state.active}
    out = {k: v.clone() for k, v in out.items()}
    out["probes"] = {k: [(t, np.array(v)) for t, v in rows]
                     for k, rows in run.probes.samples.items()}
    out["cg"] = [list(r["cg_iterations"]) for r in run.steps]
    out["cycles"] = [r["cycles"] for r in run.steps]
    out["t"], out["k"], out["step0"] = run.t, run.k, run.step0
    return out


def assert_same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for key in a:
        if torch.is_tensor(a[key]):
            assert torch.equal(a[key], b[key]), key
        elif key == "probes":
            assert a[key].keys() == b[key].keys() == {"p", "U"}
            for name in a[key]:
                assert len(a[key][name]) == len(b[key][name])
                for (ta, va), (tb, vb) in zip(a[key][name], b[key][name]):
                    assert ta == tb
                    np.testing.assert_array_equal(va, vb)
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("n_steps", [1, 3])
def test_coupled_run_stepped_is_run_coupled(tj_case, n_steps, monkeypatch):
    """``n_steps`` calls of ``step()`` give what ``run_coupled(n_steps=...)``
    gives: the fields, the CG counts, the scalar, the probe samples and
    every lane, bit for bit, and the same per-step records."""
    run = coupled.CoupledRun(tj_case, write_output=False, device=CPU, log=QUIET)
    for _ in range(n_steps):
        rec = run.step()
        assert rec is run.steps[-1] and rec["cycles"] >= 10
    mine = outputs(run)
    # what run_coupled's run holds when it finishes
    finish, theirs = coupled.CoupledRun.finish, []
    monkeypatch.setattr(coupled.CoupledRun, "finish",
                        lambda self: (theirs.append(outputs(self)), finish(self))[1])
    _, state, stats = coupled.run_coupled(tj_case, write_output=False, device=CPU, log=QUIET,
                                          n_steps=n_steps)
    assert_same(mine, theirs[0])
    assert stats["cycles"] == run.step0 and stats["time"] == run.t
    assert [r["cg_iterations"] for r in stats["steps"]] == mine["cg"]
    assert [r["dt_e"] for r in stats["steps"]] == [r["dt_e"] for r in run.steps]
    for a, b in ((mine["pos"], state.pos), (mine["tet"], state.tet_id),
                 (mine["active"], state.active), (mine["vel"], state.vel)):
        assert torch.equal(a, b)
    assert float(mine["s"].abs().max()) > 0.0
    assert len(mine["probes"]["p"]) == n_steps


def test_coupled_run_seed_and_positions(tj_case):
    """The caller's noise seed and start positions replace the dict's."""
    lo, hi = np.array([0.0, -0.01, 0.0]), np.array([0.05, 0.01, 0.02])
    pos = lo + (hi - lo) * np.random.default_rng(3).uniform(0.05, 0.95, (200, 3))
    run = coupled.CoupledRun(tj_case, write_output=False, device=CPU, log=QUIET,
                             rng_seed=2**33 + 5, positions=pos)
    assert run.state.seed == 2**33 + 5 and run.state.n_particles == 200
    np.testing.assert_array_equal(run.state.pos.numpy(), pos.astype(np.float32))
    assert bool((run.state.tet_id >= 0).all())
    run.step()
    other = coupled.CoupledRun(tj_case, write_output=False, device=CPU, log=QUIET,
                               rng_seed=7, positions=pos)
    other.step()
    assert not torch.equal(run.state.pos, other.state.pos)
    assert torch.equal(run.flow.state.u, other.flow.state.u)


def test_snapshot_restore_replays_the_steps(tj_case):
    """snapshot() -> K steps -> restore() -> the same K steps: identical
    outputs, twice over, and the snapshot outlives the steps after it."""
    run = coupled.CoupledRun(tj_case, write_output=False, device=CPU, log=QUIET)
    run.step()
    snap = run.snapshot()
    before = outputs(run)
    for _ in range(2):
        run.step()
    first = outputs(run)
    assert first["k"] == 3 and first["step0"] > before["step0"]
    for _ in range(2):
        run.restore(snap)
        assert_same(outputs(run), before)
        for _ in range(2):
            run.step()
        assert_same(outputs(run), first)


def test_snapshot_refuses_an_engine(tj_case):
    run = coupled.CoupledRun(tj_case, write_output=False, device=CPU, log=QUIET, devices=1,
                             strategy="dp")
    assert run.engine is not None
    with pytest.raises(NotImplementedError):
        run.snapshot()


def test_coupled_spans_and_counters(tj_case):
    """Under a profiler each step is an outermost ``CoupledRun.step`` span
    holding the phases (``Flow``, ``Functions`` with ``functions.probes``
    and ``functions.scalar_transport``, ``Refresh`` with its read, host
    table and upload, ``Advect``), and the counters rise by one a step, one
    a sub-step and one a particle call."""
    from torch.profiler import ProfilerActivity, profile

    run = coupled.CoupledRun(tj_case, write_output=False, device=CPU, log=QUIET)
    run.step()
    rec = profiling.RECORDER
    rec.new_window()
    with profile(activities=[ProfilerActivity.CPU]):
        recs = [run.step() for _ in range(2)]
    spans = [sp for sp in rec.spans if sp.name != "python.gc"]
    tops = [sp for sp in spans if sp.parent < 0]
    assert [sp.name for sp in tops] == ["CoupledRun.step"] * 2
    by_index = {sp.index: sp for sp in rec.spans}

    def parent(sp):
        return by_index[sp.parent].name

    names = {sp.name for sp in spans}
    for phase in ("Flow", "Functions", "Refresh", "Advect"):
        assert phase in names
        assert all(parent(sp) == "CoupledRun.step" for sp in spans if sp.name == phase)
    for child, phase in (("functions.probes", "Functions"),
                         ("functions.scalar_transport", "Functions"),
                         ("sync.refresh_u", "Refresh"), ("refresh.host_table", "Refresh"),
                         ("FlowSolver.advance", "Flow"), ("run_cycles", "Advect")):
        found = [sp for sp in spans if sp.name == child]
        assert len(found) >= 2 and all(parent(sp) == phase for sp in found), child
    counts = rec.counts()
    cycles = sum(r["cycles"] for r in recs)
    assert counts["coupled.steps"] == 2
    assert counts["coupled.cycles"] == cycles
    assert counts["coupled.advect_calls"] == cycles     # saveInterval 2: one-cycle calls
    assert len([sp for sp in spans if sp.name == "run_cycles"]) == cycles
    assert all(sp.counts["coupled.steps"] == 1 for sp in tops)
