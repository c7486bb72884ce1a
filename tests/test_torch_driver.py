"""PyTorch port: the uncoupled driver (``models/uncoupled.py``), its CLI
(``python -m cudaparticlesfoam_tpu_torch``) and ``utils/profiling.py`` on
the CPU: the frame schedule and the VTU contract (twins of
tests/test_cases.py), injection on an unaligned interval, the pitzDaily
driver anchor of tests/golden/particles_f64.npz in float64 to 1e-12 (the
noise replayed from tests/golden/torch_port_pitz_noise.npz, which a test
pins against a fresh JAX draw), and the CLI against the JAX CLI (the
import boundary of the CLI and the driver is checked with the package's,
tests/test_torch_mesh.py)."""

import os
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

import cudaparticlesfoam_tpu.models.uncoupled as juncoupled
from cudaparticlesfoam_tpu_torch import state as tstate
from cudaparticlesfoam_tpu_torch.models import case as tcase
from cudaparticlesfoam_tpu_torch.models import uncoupled
from cudaparticlesfoam_tpu_torch.utils import profiling

from torch_port_common import CPU, GOLDEN_DIR, make_pitz_case, recorded_noise

GOLDEN = os.path.join(GOLDEN_DIR, "particles_f64.npz")
PITZ_NOISE = os.path.join(GOLDEN_DIR, "torch_port_pitz_noise.npz")
QUIET = lambda *a: None  # noqa: E731


def _arrays(path):
    """{Name: values} of a VTU frame's DataArrays, and its point count."""
    root = ET.fromstring(open(path).read())
    piece = next(root.iter("Piece"))
    return ({da.get("Name"): np.array(da.text.split(), dtype=float)
             for da in root.iter("DataArray")}, int(piece.get("NumberOfPoints")))


@pytest.mark.parametrize("n,every", [(100, 10), (1000, 10), (7, 3), (5, 1), (3, 10)])
def test_write_schedule_matches_jax(n, every):
    assert uncoupled.write_schedule(n, every) == juncoupled.write_schedule(n, every)


@pytest.fixture(scope="module")
def pitz_run(tmp_path_factory):
    """The shrunk tutorial (200 particles, deltaT 0.01, uniform +x field)
    through the driver on the CPU in float32, with its frames."""
    case_dir = make_pitz_case(tmp_path_factory.mktemp("case"))
    out = tmp_path_factory.mktemp("out")
    case, state, stats = uncoupled.run(case_dir, out_dir=str(out), log=QUIET, device=CPU)
    return case, state, stats, out


def test_uncoupled_runs_and_writes(pitz_run):
    """Twin of tests/test_cases.py::test_uncoupled_runs_and_writes."""
    case, state, stats, out = pitz_run
    # deltaT=0.01, dt=1e-4 -> 100 cycles; saveInterval=10 -> frames 0,1,11,...,91
    assert stats["cycles"] == 100 and state.step == 100
    expected = ["particle_0000.vtu"] + [f"particle_{i + 1:04d}.vtu" for i in range(0, 100, 10)]
    assert sorted(os.listdir(out)) == sorted(expected)
    assert [os.path.basename(p) for p in stats["frames"]] == expected
    assert set(stats["phases"]) == {"Init", "Seed", "Advect", "IO"}
    assert stats["phases"] == stats["host_phases"]      # the CPU's clock for both


def test_uncoupled_particles_advected(pitz_run):
    """Twin of tests/test_cases.py::test_uncoupled_particles_advected."""
    case, state, stats, out = pitz_run
    pos, tet, act = state.pos.numpy(), state.tet_id.numpy(), state.active.numpy()
    assert act.sum() > 0 and state.dtype == torch.float32
    lo, hi = case.tet_mesh.bounds_lo.numpy(), case.tet_mesh.bounds_hi.numpy()
    assert (pos[act] >= lo - 1e-6).all() and (pos[act] <= hi + 1e-6).all()
    assert (tet[act] >= 0).all()
    # uniform +x at 1 m/s for 0.01 s: the frames show the drift
    first, _ = _arrays(os.path.join(out, "particle_0001.vtu"))
    last, _ = _arrays(os.path.join(out, "particle_0091.vtu"))
    dx = last["Position"].reshape(-1, 3)[:, 0] - first["Position"].reshape(-1, 3)[:, 0]
    assert 0.008 < np.median(dx) < 0.0095


def test_uncoupled_vtu_contract(pitz_run):
    """Twin of tests/test_cases.py::test_uncoupled_vtu_contract, with the
    reference quirks: warm-up velocities in frame 0, KEs all zeros."""
    case, state, stats, out = pitz_run
    arrays, n = _arrays(os.path.join(out, "particle_0000.vtu"))
    assert n == 200
    assert list(arrays) == ["Position", "ParticleType", "ParticleID", "ParticleTetID", "vels",
                            "KEs", "connectivity", "offsets", "types"]
    np.testing.assert_allclose(arrays["vels"].reshape(-1, 3), np.tile([1.0, 0, 0], (200, 1)))
    assert (arrays["KEs"] == 0).all() and (arrays["ParticleTetID"] >= 0).all()


def test_injection_fires_on_unaligned_interval(tmp_path, monkeypatch):
    """Twin of tests/test_cases.py::test_injection_fires_on_unaligned_interval:
    every multiple of injectionInterval is a chunk start, so an interval
    that does not divide saveInterval still fires every interval."""
    calls = []

    def counting_inject(st, *a, **kw):
        calls.append(st.step)
        return st, 0

    monkeypatch.setattr(tstate, "inject", counting_inject)
    case_dir = make_pitz_case(tmp_path, num_particles=50,
                              extra_dict={"injectionInterval": 3, "injectionCount": 5})
    out = tmp_path / "out"
    out.mkdir()
    uncoupled.run(case_dir, out_dir=str(out), write_output=False, log=QUIET, device=CPU)
    # 100 cycles, saveInterval=10, interval=3: injections at the chunks
    # starting at steps 0, 3, ..., 99 -> 34 events (the bug gave 4); each
    # comes after its chunk has run
    assert len(calls) == 34
    assert calls[0] == 1 and calls[-1] == 100


@pytest.mark.parametrize("option", ["streamlines", "convex"])
def test_driver_options(tmp_path, option):
    """saveStreamlines writes Streamline.vtk; locateMode convex runs the
    convex engine and adds the ConvexTetID column (utils.cpp:216-228)."""
    extra = {"saveStreamlines": 1} if option == "streamlines" else {"locateMode": "convex"}
    case_dir = make_pitz_case(tmp_path, num_particles=30, delta_t=0.002, extra_dict=extra)
    out = tmp_path / "out"
    case, st, stats = uncoupled.run(case_dir, out_dir=str(out), log=QUIET, device=CPU)
    assert stats["cycles"] == 20 and (st.tet_id >= 0).all()
    arrays, n = _arrays(os.path.join(out, "particle_0011.vtu"))
    assert n == 30
    if option == "streamlines":
        txt = open(out / "Streamline.vtk").read()
        assert "LINES 30 " in txt and "ConvexTetID" not in arrays
    else:
        assert case.tet_mesh.tet_row_cx is not None
        np.testing.assert_array_equal(arrays["ConvexTetID"], arrays["ParticleTetID"])


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def test_pitz_noise_file_matches_a_fresh_jax_draw():
    """tests/golden/torch_port_pitz_noise.npz holds the JAX cached engine's
    threefry normals of the anchor run (tools/make_torch_port_inputs.py)."""
    import jax

    noise = np.load(PITZ_NOISE)["noise"]
    assert noise.shape == (100, 200, 3) and noise.dtype == np.float64
    key = jax.random.PRNGKey(0)
    for step in (0, 1, 57, 99):
        want = np.asarray(jax.random.normal(jax.random.fold_in(key, step), (200, 3),
                                            dtype=np.float64))
        np.testing.assert_array_equal(noise[step], want)


def test_pitz_driver_matches_golden(golden, tmp_path, monkeypatch):
    """Port twin of tests/test_golden.py::test_pitz_driver_matches_golden:
    the whole case pipeline (blockMesh, tet decomposition, owl-LCG seeding,
    locate, the tuned cached engine, sub-cycling) on the CPU in float64,
    with the JAX run's Brownian normals replayed.  Flavor-gated as the JAX
    test is: the anchor records which base-point builder made its mesh."""
    want = str(golden.get("builder_flavor", "numpy"))
    if tcase._builder_flavor() != want:
        pytest.skip(f"golden anchor was built with the {want} base-point "
                    f"builder; this host runs {tcase._builder_flavor()}")
    recorded_noise(monkeypatch, np.load(PITZ_NOISE)["noise"])
    case_dir = make_pitz_case(tmp_path, shear=True)
    _, state, stats = uncoupled.run(case_dir, out_dir=str(tmp_path / "out"), write_output=False,
                                    dtype=np.float64, log=QUIET, device=CPU)
    assert stats["cycles"] == 100 and state.step == 100
    np.testing.assert_allclose(state.pos.numpy(), golden["pitz_pos"], atol=1e-12, rtol=0,
                               err_msg="pitzDaily driver drifted from the golden anchor")
    np.testing.assert_array_equal(state.tet_id.numpy(), golden["pitz_tet"])
    np.testing.assert_array_equal(state.active.numpy(), golden["pitz_active"])


# ---------------------------------------------------------------- CLI


def test_cli_blockmesh_matches_jax_cli(tmp_path):
    from cudaparticlesfoam_tpu.cli import main as jmain
    from cudaparticlesfoam_tpu_torch.cli import main

    a = make_pitz_case(tmp_path / "port", num_particles=10)
    b = make_pitz_case(tmp_path / "jax", num_particles=10)
    assert main(["blockmesh", a]) == 0 and jmain(["blockmesh", b]) == 0
    da, db = (os.path.join(c, "constant", "polyMesh") for c in (a, b))
    names = sorted(os.listdir(db))
    assert sorted(os.listdir(da)) == names and "points" in names
    for f in names:
        with open(os.path.join(da, f), "rb") as fa, open(os.path.join(db, f), "rb") as fb:
            assert fa.read() == fb.read(), f


def test_cli_dict_matches_jax_cli(tmp_path, capsys):
    from cudaparticlesfoam_tpu.cli import main as jmain
    from cudaparticlesfoam_tpu_torch.cli import main

    a = make_pitz_case(tmp_path / "port", num_particles=10)
    b = make_pitz_case(tmp_path / "jax", num_particles=10)
    fa, fb = (os.path.join(c, "system", "cudaParticlesDict") for c in (a, b))
    for args in (["-entry", "numParticles"], ["-entry", "dt", "-set", "2e-4"],
                 ["-entry", "saveInterval", "-set", "5"], ["-entry", "dt"]):
        capsys.readouterr()
        assert main(["dict", fa, *args]) == 0
        got = capsys.readouterr().out
        assert jmain(["dict", fb, *args]) == 0
        assert got == capsys.readouterr().out
    assert open(fa).read() == open(fb).read()


def test_cli_uncoupled_runs_on_the_cpu_in_float64(tmp_path, capsys):
    from cudaparticlesfoam_tpu_torch.cli import main

    case_dir = make_pitz_case(tmp_path, num_particles=40, delta_t=0.002)
    assert main(["uncoupled", case_dir, "--device", "cpu", "--f64", "--no-write"]) == 0
    out = capsys.readouterr().out
    assert "nCycles: 20 " in out and "Out-of-domain particles(-tetID) = 0" in out
    assert "Simulation RunTime=" in out and not os.path.exists(tmp_path / "particle_0000.vtu")


@pytest.mark.parametrize("args", [["--devices", "2"], ["--strategy", "dp"],
                                  ["--strategy", "partitioned", "--devices", "1"]])
def test_cli_multi_device_raises(tmp_path, args, capsys):
    """The multi-device legs are ported (``parallel/``): such a request no
    longer raises, it runs on a ParticleEngine and says so; only an unknown
    strategy is refused."""
    from cudaparticlesfoam_tpu_torch.cli import main

    case_dir = make_pitz_case(tmp_path, num_particles=40, delta_t=0.002)
    assert main(["uncoupled", case_dir, "--device", "cpu", "--f64", "--no-write", *args]) == 0
    out = capsys.readouterr().out
    assert "#adv: engine strategy=" in out and "Out-of-domain particles(-tetID) = 0" in out
    with pytest.raises(ValueError, match="unknown strategy"):
        uncoupled.run(case_dir, strategy="scatter", device=CPU, log=QUIET)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks a torch without CUDA")
def test_uncoupled_defaults_to_the_card_and_raises_without_one(tmp_path):
    with pytest.raises(RuntimeError, match="--device cpu"):
        uncoupled.run(str(tmp_path), log=QUIET)


# ---------------------------------------------------------------- profiling


def test_phase_timer_and_trace_on_the_cpu(tmp_path):
    timer = profiling.PhaseTimer(CPU)
    for _ in range(2):
        with timer.phase("Advect"):
            torch.ones(1000).sum()
    timer.add("IO", 0.5)
    lines = []
    total = timer.report(log=lines.append)
    assert timer.counts == {"Advect": 2, "IO": 1}
    assert timer.totals == timer.host and total == timer.totals["Advect"]
    assert lines[0].split() == ["Item", "time(s)", "fraction(%)"] and "IO" in lines[-2]
    with profiling.device_trace(str(tmp_path / "trace"), CPU):
        torch.ones(10).cumsum(0)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    with profiling.device_trace(None):
        pass
