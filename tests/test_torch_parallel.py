"""PyTorch port: particle data parallelism (``parallel/sharding.py``), the
strategy choice and ``ParticleEngine`` (``parallel/auto.py``), and the
strategies through the drivers, on CPU shards.

* DP under threefry (and "rbg") equals a single-device run of the padded
  state bit for bit; under "rbg_kernel" each shard equals a single-device
  run of its slice with lane offset ``s * 8192``, bit for bit.
* ``choose_strategy`` / ``mesh_table_bytes`` equal JAX's on the same meshes
  and budgets (twin of ``tests/test_cases.py:223``).
* Twins of ``tests/test_cases.py:191`` and ``:294``: the uncoupled and
  replay drivers with ``dp`` and ``partitioned`` on 8 shards equal the
  single-device run (tet and active exact, pos within 1e-9, float64); the
  uncoupled one also equals JAX's single-device driver run within 1e-12
  (the replay's is ``tests/test_torch_coupled.py``'s).
"""

import os

from torch_port_common import CPU, make_pitz_case   # also caps torch at one thread

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import cudaparticlesfoam_tpu.mesh as jmesh  # noqa: E402
from cudaparticlesfoam_tpu.parallel import auto as jauto  # noqa: E402
from cudaparticlesfoam_tpu_torch import StepConfig, convert, run_cycles  # noqa: E402
from cudaparticlesfoam_tpu_torch import mesh as tmesh  # noqa: E402
from cudaparticlesfoam_tpu_torch.models import coupled, uncoupled  # noqa: E402
from cudaparticlesfoam_tpu_torch.parallel import auto, sharding  # noqa: E402

QUIET = lambda *a, **k: None  # noqa: E731
DRIVER_TOL = 1e-9
JAX_TOL = 1e-12


def _box(nside=6, dtype=np.float64):
    pts, tets, vv = tmesh.box_points_tets(nside, nside, nside)
    cen = pts[tets].mean(axis=1)
    c = cen - nside / 2.0
    u = c / nside * 2.0 + np.stack([-c[:, 1], c[:, 0], 0 * c[:, 2]], 1) / nside
    return tmesh.from_arrays_host(pts, tets, tet_vel=u, vert_vel=vv, dtype=dtype)


@pytest.fixture(scope="module")
def box():
    """The swirl box 6^3 (walls, hops, corner hits) and 1,001 seeds on it."""
    payload = _box()
    tm = convert.to_mesh(payload, device=CPU)
    rng = np.random.default_rng(4)
    pos = torch.as_tensor(rng.uniform(0.1, 5.9, (1001, 3)))
    from cudaparticlesfoam_tpu_torch import build_grid_locator, locate_seeds

    st = convert.to_state(pos, locate_seeds(tm, build_grid_locator(tm), pos),
                          dtype=torch.float64, device=CPU)
    return payload, tm, st


def _same(a, b):
    """Two states hold the same bits (pos, vel, tet, active)."""
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("pos", "vel", "tet_id", "active"))


def _cat(shards, n=None):
    cat = {f: torch.cat([getattr(s, f) for s in shards]) for f in
           ("pos", "vel", "tet_id", "active")}
    return type("St", (), {k: v[:n] for k, v in cat.items()})


# ---------------------------------------------------------------------------
# sharding
# ---------------------------------------------------------------------------


def test_device_mesh_and_padding(box):
    _, _, st = box
    devs = sharding.make_device_mesh(3, "cpu")
    assert devs == [torch.device("cpu")] * 3
    assert sharding.placement(devs) == "cpu x3"
    assert sharding.placement([torch.device("cuda", 0)] * 2 + [torch.device("cuda", 1)]) == \
        "cuda:0 x2, cuda:1 x1"
    shards = sharding.shard_state(st, devs)
    assert [s.n_particles for s in shards] == [334] * 3
    last = shards[-1]
    # the padded lanes are dead: inactive, tet -1, at rest
    assert not last.active[-1] and int(last.tet_id[-1]) == -1
    assert float(last.pos[-1].abs().sum()) == 0.0
    assert all(s.seed == st.seed and s.step == st.step for s in shards)
    diag = sharding.global_diagnostics(shards)
    assert diag["active"] == int(st.active.sum())
    assert diag["out_of_domain"] == int((st.tet_id < 0).sum()) + 1


@pytest.mark.parametrize("kw", [
    dict(),                                              # threefry, the bary engine
    dict(brownian_rng="rbg"),
    dict(macro_cycles=4),                                # macro cycles, threefry
    dict(locate_mode="convex"),                          # the convex engine
    dict(engine="simple"),                               # the simple engine
], ids=["threefry", "rbg", "macro4", "convex", "simple"])
def test_dp_equals_single_device_run_of_the_padded_state(box, kw):
    """JAX's GSPMD route: each sub-step's noise drawn over the padded
    global lanes and sliced, so 3 shards = one device, bit for bit."""
    _, tm, st = box
    if kw.get("locate_mode") == "convex":
        tm = tmesh.with_convex_rows(tm)
    cfg = StepConfig(dt=0.3, diffusion_coeff=5e-3, **kw)
    devs, meshes, shards = sharding.distribute(tm, st, 3)
    got = sharding.run_cycles_sharded(meshes, shards, cfg, 9)
    ref = run_cycles(tm, sharding.pad_particles(st, 3), cfg, 9)
    assert _same(_cat(got), ref)
    assert all(s.step == 9 for s in got)


@pytest.mark.parametrize("kw", [dict(), dict(locate_mode="convex")], ids=["bary", "convex"])
def test_dp_rbg_kernel_shards_equal_their_slices_with_lane_offsets(box, kw):
    """JAX's shard_map route: shard s = a single-device run of its slice
    with lane_offset0 = s * 8192, bit for bit, and the streams differ."""
    _, tm, st = box
    if kw:
        tm = tmesh.with_convex_rows(tm)
    cfg = StepConfig(dt=0.3, diffusion_coeff=5e-3, brownian_rng="rbg_kernel", **kw)
    devs, meshes, shards = sharding.distribute(tm, st, 3)
    got = sharding.run_cycles_dp_shardmap(devs, meshes, shards, cfg, 6)
    for s, (g, sh) in enumerate(zip(got, shards)):
        assert _same(g, run_cycles(tm, sh, cfg, 6, lane_offset0=s * 8192))
    # without the offsets every shard would draw the same stream
    assert not _same(got[1], run_cycles(tm, shards[1], cfg, 6))


def test_engine_dp_refresh_and_chunks(box):
    """ParticleEngine("dp") keeps its shards packed across calls: chunks of
    cycles and a velocity refresh (update_from_case) equal a single device
    running the same chunks on the same meshes, bit for bit."""
    payload, tm, st = box
    cfg = StepConfig(dt=0.3, diffusion_coeff=5e-3)
    eng = auto.ParticleEngine(tm, st, cfg, devices=4, strategy="dp", log=QUIET)
    assert eng.strategy == "dp" and not eng._dp.lane_offsets
    ref = sharding.pad_particles(st, 4)
    tm2 = tmesh.replace_velocity(tm, tet_vel=-2.0 * tm.tet_vel)
    for mesh, n in ((tm, 1), (tm, 4), (tm2, 3)):
        eng.update_from_case(type("Case", (), {"tet_mesh": mesh}))
        eng.advance(n, 0.3)
        ref = run_cycles(mesh, ref, cfg, n)
    out = eng.snapshot()
    assert out.n_particles == st.n_particles and out.step == 8
    assert _same(out, _cat([ref], st.n_particles))


def test_choose_strategy_memory_model():
    """Twin of tests/test_cases.py:223: the same table bytes and the same
    choices as JAX's on the same meshes and budgets."""
    for nside in (4, 6):
        payload = _box(nside)
        jm, tm = jmesh.host_to_device(dict(payload)), convert.to_mesh(payload, device=CPU)
        b = auto.mesh_table_bytes(tm)
        assert b == jauto.mesh_table_bytes(jm) > 0
        for n, ndev, hbm in ((1000, 1, None), (1000, 8, 100 * b), (1000, 8, b),
                             (10**6, 4, b + 2e7), (10**6, 4, 1.7 * b + 2e8), (10, 2, None)):
            got = auto.choose_strategy(tm, n, ndev, hbm_bytes=hbm)
            assert got == jauto.choose_strategy(jm, n, ndev, hbm_bytes=hbm), (n, ndev, hbm)
    assert auto.choose_strategy(tm, 1000, 1) == "single"
    assert auto.choose_strategy(tm, 1000, 8, hbm_bytes=100 * b) == "dp"
    assert auto.choose_strategy(tm, 1000, 8, hbm_bytes=b) == "partitioned"
    # the CPU reports no memory: the JAX package's default budget
    assert auto.device_hbm_bytes(device="cpu") == jauto.device_hbm_bytes() == 16e9


def test_engine_logs_its_placement(box):
    _, tm, st = box
    lines = []
    eng = auto.ParticleEngine(tm, st, StepConfig(), devices=4, strategy="partitioned",
                              log=lines.append)
    assert eng.devices == [CPU] * 4
    assert "strategy=partitioned devices=[cpu x4]" in lines[0]
    with pytest.raises(ValueError, match="unknown strategy"):
        auto.ParticleEngine(tm, st, StepConfig(), devices=2, strategy="mesh", log=QUIET)
    single = auto.ParticleEngine(tm, st, StepConfig(), devices=1, strategy="dp", log=QUIET)
    assert single.strategy == "single" and single.migration_stats == {}


# ---------------------------------------------------------------------------
# the drivers (twins of tests/test_cases.py:191 and :294)
# ---------------------------------------------------------------------------


def _jax_uncoupled(case_dir):
    from cudaparticlesfoam_tpu.models import uncoupled as juncoupled

    return juncoupled.run(case_dir, write_output=False, log=QUIET, dtype=np.float64)[1]


def _assert_driver_parity(runs, jref, n):
    """dp and partitioned = single; single = JAX's run ``jref`` (if given)."""
    ref = runs["single"]
    if jref is not None:
        np.testing.assert_array_equal(ref.tet_id.numpy(), np.asarray(jref.tet_id))
        np.testing.assert_array_equal(ref.active.numpy(), np.asarray(jref.active))
        np.testing.assert_allclose(ref.pos.numpy(), np.asarray(jref.pos), atol=JAX_TOL, rtol=0)
    for strat in ("dp", "partitioned"):
        st = runs[strat]
        assert st.n_particles == n
        np.testing.assert_array_equal(st.tet_id.numpy(), ref.tet_id.numpy(), err_msg=strat)
        np.testing.assert_array_equal(st.active.numpy(), ref.active.numpy(), err_msg=strat)
        np.testing.assert_allclose(st.pos.numpy(), ref.pos.numpy(), atol=DRIVER_TOL, rtol=0)


def test_uncoupled_strategy_parity(tmp_path):
    """The uncoupled driver on 8 CPU shards with dp and partitioned
    reproduces the single-device trajectory (float64, no Brownian term:
    the partitioned noise is keyed by particle id)."""
    case_dir = make_pitz_case(tmp_path, num_particles=300, delta_t=0.004, shear=True,
                              extra_dict={"useBrownianMotion": 0})
    runs, logs = {}, []
    for strat, dev in (("single", 1), ("dp", 8), ("partitioned", 8)):
        _, state, stats = uncoupled.run(case_dir, write_output=False, log=logs.append,
                                        devices=dev, strategy=strat, dtype="float64",
                                        device=CPU)
        runs[strat] = state
        assert stats["cycles"] == 40
    assert set(stats["migration"]) == {"migrated", "deferred", "settle_rounds"}
    assert any("strategy=dp devices=[cpu x8]" in str(x) for x in logs)
    _assert_driver_parity(runs, _jax_uncoupled(case_dir), 300)


def test_replay_strategy_parity(tmp_path):
    """The replay driver's engines take each snapshot's field
    (update_from_case) and track the single-device trajectory."""
    from cudaparticlesfoam_tpu_torch.io import blockmesh, polymesh

    case_dir = make_pitz_case(tmp_path, num_particles=200,
                              extra_dict={"dt": 1e-3, "saveInterval": 100000,
                                          "useBrownianMotion": 0})
    pm = blockmesh.generate(os.path.join(case_dir, "system", "blockMeshDict"))
    ctrs, _ = polymesh.cell_centres_volumes(pm)
    for t, ux in [("282.01", 0.5), ("282.02", -0.25)]:
        os.makedirs(os.path.join(case_dir, t), exist_ok=True)
        u = np.zeros((pm.n_cells, 3))
        u[:, 0] = ux * (1.0 + 20.0 * ctrs[:, 1])
        polymesh.write_field(os.path.join(case_dir, t, "U"), "U", u)
    runs = {}
    for strat, dev in (("single", 1), ("dp", 8), ("partitioned", 8)):
        _, state, stats = coupled.run_replay(case_dir, write_output=False, log=QUIET,
                                             devices=dev, strategy=strat, dtype="float64",
                                             device=CPU)
        assert stats["cycles"] == 20
        runs[strat] = state
    assert np.abs(runs["single"].pos.numpy()).sum() > 0
    _assert_driver_parity(runs, None, 200)
