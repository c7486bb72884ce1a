"""PyTorch port: the coupled and replay drivers (``models/coupled.py``) and
the CLI's ``coupled`` / ``replay`` on the CPU — the port's run of the shrunk
TJunction against the JAX package's, and the twins of
tests/test_coupled_e2e.py's single-device tests and of
tests/test_cases.py::test_replay_driver.

Parity: both packages run the shrunk TJunction (tests/test_coupled_e2e.py's
1/5 resolution, kEpsilon, probes, scalarTransport, the p0 ramps, adjustable
dt) for 3 Eulerian steps in float64 — both packages solve the flow in
float32 by default, so JAX's loader and the port's ``flow_dtype`` ask for
float64 here — with the JAX run's threefry
normals replayed in the port (``torch_port_common.recorded_noise``): tet_id
and active exact, pos within 1e-9, and the lines both print equal number for
number (``assert_logs_match``; the port's own ``#coupled:`` lines and the
lines that carry a wall time are not JAX's)."""

from torch_port_common import (CPU, assert_logs_match, make_oscillating_case, make_pitz_case,
                               recorded_noise, shrink_tjunction, write_polymesh_of)

import os  # noqa: E402
import re  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from cudaparticlesfoam_tpu_torch.io import foamfile, polymesh  # noqa: E402
from cudaparticlesfoam_tpu_torch.models import case as caselib  # noqa: E402
from cudaparticlesfoam_tpu_torch.models import coupled, pimple  # noqa: E402

POS_TOL = 1e-9
SHARED = ("#flow:", "Time =", "dtE:", "nCycles:", "#fo:", "#adv: Out-of-domain")


def shared_lines(logs):
    return [ln for ln in logs if ln.startswith(SHARED)]


def _jax_noise(n, cycles, seed=0):
    key = jax.random.PRNGKey(seed)
    return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, s), (n, 3),
                                                  dtype=np.float64)) for s in range(cycles)])


@pytest.mark.parametrize("which", ["tjunction", "oscillating-box"])
def test_run_coupled_matches_jax(tmp_path, monkeypatch, which):
    """The shrunk TJunction, and tests/test_dynamicmesh.py's oscillating box
    (the dynamic-mesh branch: refresh_geometry every step), 3 Eulerian
    steps, float64, the same noise: tet/active exact, pos within 1e-9."""
    from cudaparticlesfoam_tpu.models import coupled as jcoupled
    from cudaparticlesfoam_tpu.models import pimple as jpimple

    if which == "tjunction":
        case = shrink_tjunction(tmp_path, num_particles=500)
        write_polymesh_of(case)
    else:
        case = make_oscillating_case(tmp_path, n_particles=300)
    jload = jpimple.load_flow_case
    monkeypatch.setattr(jpimple, "load_flow_case",
                        lambda *a, **k: jload(*a, **dict(k, dtype=jnp.float64)))
    jlogs, logs = [], []
    _, jstate, jstats = jcoupled.run_coupled(
        case, out_dir=str(tmp_path / "jout"), n_steps=3, dtype=jnp.float64,
        write_output=False, log=lambda *a: jlogs.append(" ".join(map(str, a))))
    n = int(jstate.pos.shape[0])
    recorded_noise(monkeypatch, _jax_noise(n, jstats["cycles"] + 1))
    _, state, stats = coupled.run_coupled(
        case, out_dir=str(tmp_path / "out"), n_steps=3, dtype=np.float64, write_output=False,
        device=CPU, flow_dtype=torch.float64, log=lambda *a: logs.append(" ".join(map(str, a))))
    assert stats["cycles"] == jstats["cycles"] >= (30 if which == "tjunction" else 6)
    assert stats["time"] == pytest.approx(jstats["time"], rel=1e-12)
    np.testing.assert_array_equal(state.tet_id.numpy(), np.asarray(jstate.tet_id))
    np.testing.assert_array_equal(state.active.numpy(), np.asarray(jstate.active))
    np.testing.assert_allclose(state.pos.numpy(), np.asarray(jstate.pos), atol=POS_TOL, rtol=0)
    assert_logs_match(shared_lines(logs), shared_lines(jlogs))
    assert len([ln for ln in logs if ln.startswith("#coupled: step")]) == 3


# ---------------------------------------------------------------- twins


def test_tjunction_coupled_end_to_end(tmp_path):
    """Twin of tests/test_coupled_e2e.py::test_tjunction_coupled_end_to_end."""
    case = shrink_tjunction(tmp_path)
    pm = write_polymesh_of(case)
    assert pm.n_cells == 40 * 4 * 4 + 4 * 4 * 4 + 2 * (4 * 40 * 4)
    out = str(tmp_path / "out")
    os.makedirs(out)
    logs = []
    _, state, stats = coupled.run_coupled(case, out_dir=out, n_steps=3, device=CPU,
                                          log=lambda *a: logs.append(" ".join(map(str, a))))
    assert stats["cycles"] >= 30 and stats["time"] > 0.0
    frames = sorted(f for f in os.listdir(out) if re.match(r"particle_\d+\.vtu", f))
    assert frames[0] == "particle_0000.vtu" and len(frames) >= 2
    pos = state.pos.numpy()
    assert state.active.all() and (state.tet_id >= 0).all()
    assert np.isfinite(pos).all()
    assert pos[:, 0].min() >= -1e-6 and pos[:, 0].max() <= 0.21 + 1e-6
    pdir = os.path.join(out, "postProcessing", "probes", "0")
    for field in ("p", "U"):
        f = os.path.join(pdir, field)
        assert os.path.exists(f), f"missing probe file {f}"
        lines = [ln for ln in open(f) if not ln.startswith("#")]
        assert len(lines) == 3          # one sample per Eulerian step
        assert np.isfinite(np.array(re.findall(r"-?\d+\.?\d*(?:[eE][+-]?\d+)?", lines[-1]),
                                    dtype=float)).all()
    sdirs = [d for d in os.listdir(out)
             if re.match(r"\d", d) and os.path.exists(os.path.join(out, d, "s"))]
    assert sdirs, "scalarTransport field never written"
    assert np.isfinite(polymesh.read_field(os.path.join(out, sdirs[0], "s"), pm.n_cells)).all()
    assert any("Time =" in ln for ln in logs)
    steps = stats["steps"]
    assert len(steps) == 3 and all(s["cycles"] >= 10 and s["cg_iterations"] for s in steps)
    assert stats["active_in_domain"] and stats["active"] == 2000


def test_coupled_restart_from_latest_time(tmp_path):
    """Twin of tests/test_coupled_e2e.py::test_coupled_restart_from_latest_time:
    runTime.write() + startFrom latestTime resume the flow and kEpsilon from
    the written time directory, the flux from the written phi."""
    case = shrink_tjunction(tmp_path, num_particles=500)
    cd_path = os.path.join(case, "system", "controlDict")
    cd = foamfile.read(cd_path)
    cd.pop("FoamFile", None)
    cd.update(writeControl="timeStep", writeInterval=2, startFrom="latestTime")
    foamfile.write(cd_path, cd, obj_name="controlDict")
    pm = write_polymesh_of(case)
    coupled.run_coupled(case, n_steps=2, device=CPU, log=lambda *a: None)
    tdirs = [d for d in os.listdir(case) if re.match(r"\d", d) and d != "0"
             and os.path.isdir(os.path.join(case, d))]
    assert tdirs, "no time directory written"
    latest = max(tdirs, key=float)
    for f in ("U", "p", "phi", "k", "epsilon"):
        assert os.path.exists(os.path.join(case, latest, f)), f"missing {f}"
    case2 = caselib.load_case(case, log=lambda *a: None, device=CPU)
    assert case2.time_value == pytest.approx(float(latest))
    assert case2.time_dir == latest
    logs = []
    flow2 = pimple.FlowSolver.from_case(case2, log=lambda *a: logs.append(" ".join(map(str, a))))
    assert any("restart flux from written phi" in ln for ln in logs)
    phi_written = polymesh.read_surface_field(os.path.join(case, latest, "phi"), pm.patches)
    np.testing.assert_allclose(flow2.state.flux.numpy(), phi_written, atol=1e-7)
    u_written = polymesh.read_field(os.path.join(case, latest, "U"), pm.n_cells)
    np.testing.assert_allclose(flow2.state.u.numpy(), u_written, atol=1e-5)
    k_written = polymesh.read_field(os.path.join(case, latest, "k"), pm.n_cells)
    np.testing.assert_allclose(flow2.kes.k.numpy(), k_written, atol=1e-6)
    flow2.advance(0.001)
    assert torch.isfinite(flow2.state.u).all()


def _replay_case(tmp_path):
    case_dir = make_pitz_case(tmp_path, num_particles=100,
                              extra_dict={"dt": 1e-3, "saveInterval": 100000})
    from cudaparticlesfoam_tpu_torch.io import blockmesh

    pm = blockmesh.generate(os.path.join(case_dir, "system", "blockMeshDict"))
    for t, ux in [("282.01", 0.5), ("282.02", 0.25)]:
        os.makedirs(os.path.join(case_dir, t), exist_ok=True)
        polymesh.write_field(os.path.join(case_dir, t, "U"), "U",
                             np.tile([ux, 0.0, 0.0], (pm.n_cells, 1)))
    return case_dir


def test_replay_driver(tmp_path):
    """Twin of tests/test_cases.py::test_replay_driver."""
    case_dir = _replay_case(tmp_path)
    out = tmp_path / "out"
    out.mkdir()
    case, state, stats = coupled.run_replay(case_dir, out_dir=str(out), log=lambda *a: None,
                                            device=CPU)
    # two intervals of 0.01 at dt=1e-3 -> 20 cycles total
    assert stats["cycles"] == 20
    assert int(state.active.sum()) > 0


def test_cli_coupled_and_replay_on_the_cpu(tmp_path, capsys):
    from cudaparticlesfoam_tpu_torch.cli import main

    case = shrink_tjunction(tmp_path / "tj", num_particles=300)
    assert main(["blockmesh", case]) == 0
    assert main(["coupled", case, "--device", "cpu", "--steps", "2", "--f64", "--out",
                 str(tmp_path / "cout")]) == 0
    out = capsys.readouterr().out
    assert out.count("#coupled: step") == 2 and "Time = " in out
    assert "every active lane in the domain: 1" in out
    assert os.path.exists(tmp_path / "cout" / "particle_0000.vtu")
    case_dir = _replay_case(tmp_path / "rp")
    assert main(["replay", case_dir, "--device", "cpu", "--no-write"]) == 0
    out = capsys.readouterr().out
    assert out.count("nCycles: 10 ") == 2 and "Simulation RunTime=" in out


@pytest.mark.parametrize("cmd,args,item", [
    ("coupled", ["--devices", "2"], "13a"), ("coupled", ["--strategy", "dp"], "13a"),
    ("coupled", ["--flow-devices", "2"], "13c"), ("replay", ["--devices", "2"], "13a"),
    ("replay", ["--strategy", "partitioned", "--devices", "1"], "13a")])
def test_multi_device_requests_raise(tmp_path, monkeypatch, cmd, args, item):
    """Every multi-device request is ported: the particle strategies (item
    13a) pass the check and fail only on the empty case directory, and
    ``--flow-devices 2`` (item 13c) reaches ``ShardedFlowSolver`` with 2
    shards, from the CLI and from ``run_coupled`` alike."""
    from cudaparticlesfoam_tpu_torch.cli import main

    kw = {"--devices": ("devices", int), "--strategy": ("strategy", str),
          "--flow-devices": ("flow_devices", int)}
    call = {kw[a][0]: kw[a][1](v) for a, v in zip(args[::2], args[1::2])}
    fn = coupled.run_coupled if cmd == "coupled" else coupled.run_replay
    if item == "13c":
        case = shrink_tjunction(tmp_path, num_particles=10)
        write_polymesh_of(case)
        built = []

        class Reached(Exception):
            pass

        def sharded(case_, n_dev, **k):
            built.append((n_dev, k["device"]))
            raise Reached

        monkeypatch.setattr(coupled, "ShardedFlowSolver", sharded)
        with pytest.raises(Reached):
            main([cmd, case, "--device", "cpu", *args])
        with pytest.raises(Reached):
            fn(case, device=CPU, log=lambda *a: None, **call)
        assert built == [(2, CPU), (2, CPU)]
        return
    coupled.check_single_device(call.get("devices"), call.get("strategy", "auto"))
    for run in (lambda: main([cmd, str(tmp_path), "--device", "cpu", *args]),
                lambda: fn(str(tmp_path), device=CPU, **call)):
        with pytest.raises(Exception) as exc:
            run()
        assert not isinstance(exc.value, NotImplementedError)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks a torch without CUDA")
def test_coupled_defaults_to_the_card_and_raises_without_one(tmp_path):
    with pytest.raises(RuntimeError, match="--device cpu"):
        coupled.run_coupled(str(tmp_path), log=lambda *a: None)
    with pytest.raises(RuntimeError, match="--device cpu"):
        coupled.run_replay(str(tmp_path), log=lambda *a: None)
