"""PyTorch port, end to end on the CPU: ``run_cycles`` against the committed
f64 golden anchors (tests/golden/particles_f64.npz: bary and convex) and
against the JAX package's cached engine; plus the replay fixture the card uses to replay
the anchors without jax (tests/golden/torch_port_box_inputs.npz)."""

import importlib.util
import os
import re

import jax
import numpy as np
import pytest
import torch

import cudaparticlesfoam_tpu as jcpf
import cudaparticlesfoam_tpu.mesh as jmesh
import cudaparticlesfoam_tpu_torch as cpt
from cudaparticlesfoam_tpu_torch import convert
from cudaparticlesfoam_tpu_torch import mesh as tmesh

from torch_port_common import CPU   # also caps torch at one thread

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden", "particles_f64.npz")
INPUTS = os.path.join(HERE, "golden", "torch_port_box_inputs.npz")
GENERATOR = os.path.join(HERE, "..", "tools", "make_torch_port_inputs.py")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def inputs():
    return dict(np.load(INPUTS))


@pytest.fixture(scope="module")
def box(inputs):
    """test_golden.box_setup on the port: box 6^3 in f64, the outward
    field, and the recorded threefry seeds with their tets."""
    mesh = cpt.replace_velocity(cpt.box_mesh(6, 6, 6, dtype=np.float64, device=CPU),
                                tet_vel=inputs["tet_vel"])
    st = convert.to_state(inputs["seed_pos"], inputs["seed_tet"], dtype=np.float64, device=CPU)
    return mesh, st


def _assert_anchor(fin, golden, name):
    np.testing.assert_allclose(fin.pos.numpy(), golden[f"box_{name}_pos"], atol=1e-12,
                               rtol=0)
    np.testing.assert_array_equal(fin.tet_id.numpy(), golden[f"box_{name}_tet"])
    np.testing.assert_array_equal(fin.active.numpy(), golden[f"box_{name}_active"])


def test_golden_box_bary_adv(golden, box):
    mesh, st = box
    fin = cpt.run_cycles(mesh, st, cpt.StepConfig(dt=0.08, use_brownian=False), 60)
    _assert_anchor(fin, golden, "bary_adv")
    assert fin.step == 60


def test_golden_box_bary_brownian(golden, box):
    """Noise drawn here exactly as the JAX cached engine draws it
    (threefry, fold_in(PRNGKey(0), step)) and injected per cycle."""
    mesh, st = box
    key = jax.random.PRNGKey(0)
    noise = torch.stack([
        torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(key, step), (256, 3), dtype=np.float64)))
        for step in range(60)
    ])
    cfg = cpt.StepConfig(dt=0.08, diffusion_coeff=1e-3)
    fin = cpt.run_cycles(mesh, st, cfg, 60, noise=noise)
    _assert_anchor(fin, golden, "bary_brownian")


def test_golden_box_convex_adv(golden, box):
    """The ConvexPoly cached engine (convex stream + convex rare stage with
    the barycentric safety net) on the same box and seeds."""
    mesh, st = box
    fin = cpt.run_cycles(cpt.with_convex_rows(mesh), st,
                         cpt.StepConfig(dt=0.08, use_brownian=False, locate_mode="convex"), 60)
    _assert_anchor(fin, golden, "convex_adv")
    assert fin.step == 60


def test_multihop_run_matches_jax_cached_engine():
    """6^3 box, inline_hops=4, no noise, 20 cycles at about a cell per
    sub-step, f64: tet/active exact, pos within 1e-12."""
    pts, tets, vv = tmesh.box_points_tets(6, 6, 6)
    rng = np.random.default_rng(4)
    tet_vel = rng.normal(size=(len(tets), 3))
    payload = tmesh.from_arrays_host(pts, tets, tet_vel=tet_vel, vert_vel=vv,
                                     dtype=np.float64)
    pos = rng.uniform(0.1, 5.9, (1000, 3))
    jm = jmesh.host_to_device(dict(payload))
    tet = np.asarray(jcpf.locate_seeds(jm, jcpf.build_grid_locator(jm), pos))
    kw = dict(dt=0.7, use_brownian=False, inline_hops=4)
    jst = jcpf.make_state(pos, tet_id=tet, dtype=np.float64)
    want = jcpf.run_cycles(jm, jst, jcpf.StepConfig(engine="cached", **kw), 20)
    got = cpt.run_cycles(convert.to_mesh(payload, device=CPU),
                         convert.to_state(pos, tet, dtype=np.float64, device=CPU),
                         cpt.StepConfig(**kw), 20)
    np.testing.assert_array_equal(got.tet_id.numpy(), np.asarray(want.tet_id))
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos), atol=1e-12, rtol=0)
    np.testing.assert_allclose(got.vel.numpy(), np.asarray(want.vel), atol=1e-12, rtol=0)
    assert (got.tet_id.numpy() != tet).mean() > 0.5


def test_port_locates_the_recorded_seeds(box, inputs):
    mesh, _ = box
    tet = cpt.locate_seeds(mesh, cpt.build_grid_locator(mesh),
                           torch.from_numpy(inputs["seed_pos"]))
    np.testing.assert_array_equal(tet.numpy(), inputs["seed_tet"])


def test_replay_fixture_matches_its_generator(inputs):
    spec = importlib.util.spec_from_file_location("make_torch_port_inputs", GENERATOR)
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    fresh = gen.make_inputs()
    assert set(fresh) == set(inputs)
    for k, v in fresh.items():
        assert v.dtype == inputs[k].dtype, k
        np.testing.assert_array_equal(v, inputs[k], err_msg=k)


def test_diagnostics_and_sub_cycling(box):
    mesh, st = box
    fin = cpt.run_cycles(mesh, st, cpt.StepConfig(dt=0.08, use_brownian=False), 5)
    d = cpt.diagnostics(fin)
    assert int(d["active"]) == 256 and int(d["out_of_domain"]) == 0
    np.testing.assert_allclose(float(d["kinetic_energy"]),
                               0.5 * float((fin.vel ** 2).sum()))
    assert cpt.n_cycles_for(0.1, 0.03) == jcpf.n_cycles_for(0.1, 0.03)


def test_chip_smoke_rehearsal_runs_every_phase():
    """``chip_smoke.py --rehearse`` drives every phase at small sizes on the
    CPU through the plain versions: it must exit 2 (no device result), print
    the table of the twenty-two kernel entries (the eight of the north-star
    slice's paths, the two of the uncoupled driver's, phase 8, the four of
    the rk4-tracers cell, phase 9, the two of the coupled driver on the
    TJunction, phase 11, the four of the multi-device paths, phase 12, and
    the two of the TJunction with its flow on 4 shards, phase 13) with every
    key the table carries, and no ``ok`` line; phase 10 (the steady-flow
    solver, no kernel of its own) prints its parity, Allrun and split lines;
    phase 11 (the coupled solver) its PIMPLE parity, dynamic-mesh,
    TJunction and split lines; phase 12 its remote-kernel parity,
    data-parallel, partitioned and driver lines; phase 13 its sharded-step
    parity, Allrun-parallel, cycle and dry-run lines."""
    import json
    import subprocess
    import sys

    root = os.path.join(HERE, "..")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, os.path.join(root, "chip_smoke.py"), "--rehearse"],
                         cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 2, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert lines[-1].startswith("rehearsal done") and '"ok"' not in res.stdout
    table = json.loads(lines[-2])
    names = [k["name"] for k in table["kernels"]]
    assert names == ["stream_kernel", "rare_kernel", "convex_stream_kernel",
                     "convex_rare_kernel", "hop_admit_kernel", "macro_stream_kernel",
                     "stream_kernel<pk>", "rare_kernel<pk>", "stream_kernel", "rare_kernel",
                     "stream_kernel<rk4>", "rare_kernel", "stream_kernel<pk, rk4>",
                     "rare_kernel<pk>", "stream_kernel", "rare_kernel", "stream_kernel",
                     "rare_kernel", "rare_kernel<remote>", "rare_kernel<pk, remote>",
                     "stream_kernel", "rare_kernel"]
    assert [k["path"].startswith("uncoupled driver") for k in table["kernels"]] == \
        [False] * 8 + [True] * 2 + [False] * 12
    assert all(k["path"].startswith("rk4-tracers") for k in table["kernels"][10:14])
    assert all(k["path"].startswith("coupled driver (TJunction") for k in table["kernels"][14:16])
    assert [k["path"] for k in table["kernels"][16:20]] == [
        "north-star, DP 4 shards"] * 2 + ["north-star, partitioned",
                                          "north-star, partitioned, VertexVelocity"]
    assert all(k["path"].startswith("coupled driver (TJunction Allrun-parallel, flow on 4 "
                                    "shards") and k["phases"] == "13c"
               for k in table["kernels"][20:])
    for entry in table["kernels"]:
        assert {"path", "phases", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms", "bytes", "share", "copy_ms",
                "launches_per_cycle"} <= set(entry), entry["name"]
        assert entry["library_ms"] is None
        # both sides are the plain version here: any difference is a fault of the rehearsal
        assert entry["max_abs_err"] == 0.0, (
            f"{entry['name']} on the path {entry['path']!r} (phases {entry['phases']}): "
            f"max_abs_err {entry['max_abs_err']!r}")
        assert os.path.exists(os.path.join(root, entry["source"]))
    floors = {k["name"] for k in table["kernels"] if "launch_floor_ms" in k}
    assert floors == {"rare_kernel", "convex_rare_kernel", "hop_admit_kernel", "rare_kernel<pk>",
                      "rare_kernel<remote>", "rare_kernel<pk, remote>"}
    # the rare rows' latency bound (phase 6): chains, both latencies, bound and share
    rare = {"rare_kernel", "convex_rare_kernel", "rare_kernel<pk>", "rare_kernel<remote>",
            "rare_kernel<pk, remote>"}
    for entry in table["kernels"]:
        keys = {"pending", "chain_mean", "chain_p99", "chain_max", "t_dep_nbr_ms", "t_dep_hbm_ms",
                "latency_bound_ms", "share_of_latency", "one_call_at_a_time_ms",
                "pending_first_ms", "ms_per_chain_step", "ms_at_chain_0"}
        assert (keys <= set(entry)) == (entry["name"] in rare), entry["name"]
        if entry["name"] in rare:
            assert entry["chain_max"] >= entry["chain_p99"] >= 0 and entry["pending"] > 0
            assert entry["latency_bound_ms"] == pytest.approx(
                entry["launch_floor_ms"] + (2 + entry["chain_max"]) * entry["t_dep_nbr_ms"])
            assert entry["share_of_latency"] == pytest.approx(
                entry["latency_bound_ms"] / entry["ms"])
    latency = [line for line in lines if line.startswith("[latency]")]
    assert len(latency) == 23 and "host loop (cpu rehearsal)" in latency[0]
    for name in ("rare", "convex_rare", "rare_pk", "rare_tutorial", "rare_rk4", "rare_pk_rk4",
                 "rare_tjunction", "rare_dp", "rare_remote", "rare_pk_remote",
                 "rare_tjunction_par"):
        assert any(f"| {name} lanes=" in line and "share_of_latency=" in line
                   and "pending_first_ms=" in line for line in latency), name
        assert any(f"| {name} by longest chain" in line and "ms_per_chain_step=" in line
                   for line in latency), name
    assert any("rare_patterns_identical=1" in line for line in lines if line.startswith("[parity]"))
    for tag in ("[parity]", "[convex-parity]", "[noise]", "[admit]", "[compact]", "[macro]",
                "[golden]", "[slice]", "[convex-slice]", "[macro-slice]", "[compact-slice]",
                "[convex-compact-slice]", "[pk-parity]", "[pk-slice]", "[simple]", "[bound]",
                "[driver-anchor]", "[driver-tutorial]", "[driver-cycle]", "[rk4-parity]",
                "[rk4-simple]", "[duct]", "[rk4-slice]", "[flow-parity]", "[flow-allrun]",
                "[flow-split]", "[pimple-parity]", "[dyn-refresh]", "[dyn-kernels]",
                "[dyn-coupled]", "[tj-step]", "[tj-run]", "[tj-cycle]", "[pimple-split]",
                "[tj-advect]", "[remote]", "[dp]", "[part]", "[part-pk]", "[drivers]",
                "[flowshard-parity]", "[tj-par]", "[tj-par-cycle]", "[dryrun]", "[flowshard]"):
        assert any(line.startswith(tag) for line in lines), tag
    # phase 9: RK4 kernel = plain in every case, the oracles, the cell
    rk4 = [line for line in lines if line.startswith("[rk4-parity]")]
    assert len(rk4) == 64 and all("stream_identical=1" in line and "rare_identical=1" in line
                                  for line in rk4)
    assert sum("cached_equals_simple=1" in line for line in lines) == 3   # 5d, and 9b x 2
    assert sum(line.startswith("[duct]") for line in lines) == 4
    assert sum("stream_identical=1 cycle_identical=1" in line for line in lines
               if line.startswith("[rk4-slice]")) == 2
    # phase 8: the anchor through the driver, the CLI tutorial run, one cycle at its shape
    anchor = next(line for line in lines if line.startswith("[driver-anchor]"))
    assert ("tet_exact=1 active_exact=1" in anchor and "cycles=100" in anchor) or \
        "skipped" in anchor
    tutorial = next(line for line in lines if line.startswith("[driver-tutorial]"))
    assert "frames=11 " in tutorial and "out_of_domain=0 " in tutorial
    assert any("stream_identical=1" in line and "cycle_identical=1" in line
               for line in lines if line.startswith("[driver-cycle]"))
    assert any("| stream_tutorial lanes=" in line for line in lines if line.startswith("[bound]"))
    # phase 10: SIMPLE card = CPU (here both the CPU), the Allrun chain on the
    # solved field, one SIMPLE iteration split into its stages
    parity = [line for line in lines if line.startswith("[flow-parity]")]
    assert len(parity) == 6 and sum("finite=1 checked s=" in line for line in parity) == 5
    assert all("max_rel_err=0.000e+00" in line and "second_card_run_identical=1" in line
               for line in parity)
    allrun = [line for line in lines if line.startswith("[flow-allrun]")]
    assert len(allrun) == 2 and "iterations=5 " in allrun[0] and "iters_cap=5 " in allrun[0]
    assert "written_time=282 " in allrun[0] and "streamlines=10 " in allrun[0]
    assert "frames=11 " in allrun[1] and "out_of_domain=0 " in allrun[1]
    assert "mean_x_first_last=" in allrun[1]
    split = [line for line in lines if line.startswith("[flow-split]")]
    assert len(split) == 10 and "whole_ms=" in split[-1] and "cg_iterations=" in split[-1]
    # phase 11: PIMPLE card = CPU (here both the CPU), the dynamic mesh, the
    # TJunction through the CLI and its kernels' cycle, one PIMPLE step split
    pimple = [line for line in lines if line.startswith("[pimple-parity]")]
    assert len(pimple) == 3 and all("max_rel_err=0.000e+00" in line and "cg_equal=1" in line
                                    and "second_card_run_identical=1" in line for line in pimple)
    assert "kEpsilon mrf=0 fvOptions=0" in pimple[0] and "mrf=1" in pimple[1]
    assert "fvOptions=1" in pimple[2] and "'grad_p'" in pimple[2]
    refresh = [line for line in lines if line.startswith("[dyn-refresh]")]
    assert len(refresh) == 2 and all("card_vs_cpu_max_abs=0.000e+00" in line
                                     and "topology_unchanged=1" in line for line in refresh)
    dyn = [line for line in lines if line.startswith("[dyn-kernels]")]
    assert len(dyn) == 2 and all("stream_identical=1" in line and "rare_identical=1" in line
                                 for line in dyn)
    coupled = next(line for line in lines if line.startswith("[dyn-coupled]"))
    assert "tet_exact=1 active_exact=1 active_in_domain=1" in coupled
    assert "max_abs_err=0.000e+00" in coupled
    steps = [line for line in lines if line.startswith("[tj-step]")]
    assert len(steps) == 3 and all("cg_iterations_per_corrector=[" in line for line in steps)
    run = next(line for line in lines if line.startswith("[tj-run]"))
    assert "all_active_in_domain=1" in run and "active=2000 of 2000" in run
    assert any("stream_identical=1" in line and "cycle_identical=1" in line
               for line in lines if line.startswith("[tj-cycle]"))
    assert any("| stream_tjunction lanes=" in line for line in lines if line.startswith("[bound]"))
    psplit = [line for line in lines if line.startswith("[pimple-split]")]
    assert len(psplit) == 12 and "whole_ms=" in psplit[-1] and "cg_iterations=[" in psplit[-1]
    assert "(median of 10)" in psplit[-1] and "whole_ms_min_max=(" in psplit[-1]
    # steps 2 and 3 in process, their Advect chunk by chunk (a frame at sub-step 20 in step 2)
    advect = [line for line in lines if line.startswith("[tj-advect]")]
    assert len(advect) == 4 and "step 2 " in advect[0] and "step 3 " in advect[2]
    assert "frames_at_sub_steps=[20]" in advect[0] and "frames_at_sub_steps=[]" in advect[2]
    assert all("chunks(cycles, device_ms, issue_ms)=[(" in advect[i] for i in (0, 2))
    # phase 12: rare_kernel<remote> = plain (here both the plain version), lanes
    # paused by the walk and after a bounce; DP and partitioned gates; the drivers
    remote = [line for line in lines if line.startswith("[remote] layout=")]
    assert len(remote) == 16 and all("identical=1" in line for line in remote)
    assert sum(int(re.search(r"paused_after_bounce=(\d+)", line).group(1)) for line in remote) > 0
    dp = [line for line in lines if line.startswith("[dp] brownian_rng=")]
    assert len(dp) == 2 and all("bit for bit: 1" in line for line in dp)
    gate = [line for line in lines if line.startswith("[part] shards=")]
    assert len(gate) == 2 and all("tet_identical=1 active_identical=1" in line for line in gate)
    drivers = [line for line in lines if line.startswith("[drivers]")]
    assert sum("tet_identical=1 active_identical=1" in line for line in drivers) == 2
    assert any("engine=partitioned placement=[cpu x4]" in line for line in drivers)
    # phase 13: the sharded step against the single-device one and against
    # itself on the CPU (here the CPU twice), the Allrun-parallel through the
    # CLI and in process beside the single-device flow, its cycle, the dry run
    shard = [line for line in lines if line.startswith("[flowshard-parity]")]
    assert len(shard) == 6 and all("max_rel_err=0.000e+00" in line for line in shard)
    assert all("single_ok=1" in line for line in shard[:5]) and "cg_equal=1" in shard[-1]
    assert "run_to_run_identical=1" in shard[-1]
    tjp = [line for line in lines if line.startswith("[tj-par]")]
    assert sum("CLI step " in line and "flow_shards=4 halo_rounds=2" in line
               for line in tjp) == 3
    assert any("shards=4 [cpu x4]" in line and "all_active_in_domain=1" in line
               and "active=2000 of 2000" in line for line in tjp)
    assert sum("cg_iterations_per_corrector single=[" in line for line in tjp) == 3
    assert any("rel_rms U=" in line and "gathered_flux_divergence_max=" in line for line in tjp)
    assert any("stream_identical=1" in line and "cycle_identical=1" in line
               for line in lines if line.startswith("[tj-par-cycle]"))
    assert any("| stream_tjunction_par lanes=" in line for line in lines
               if line.startswith("[bound]"))
    dry = next(line for line in lines if line.startswith("[dryrun]"))
    assert "dp_max_abs_err=0.000e+00" in dry and "partitioned_max_abs_err=0.000e+00" in dry
