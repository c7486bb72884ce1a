"""PyTorch port: the simple engine (``ops/advect.py``, ``stepper.cycle``)
against the JAX package's on the same inputs in float64, the cached
engine against the simple one on one injected noise stream, and the
fall-backs from the cached engine to the simple one."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudaparticlesfoam_tpu as jcpf
import cudaparticlesfoam_tpu.mesh as jmesh
from cudaparticlesfoam_tpu import state as jstate
from cudaparticlesfoam_tpu.ops import advect as jadvect
from cudaparticlesfoam_tpu.ops import geometry as jgeometry
import cudaparticlesfoam_tpu_torch as cpt
from cudaparticlesfoam_tpu_torch import convert
from cudaparticlesfoam_tpu_torch import mesh as tmesh
from cudaparticlesfoam_tpu_torch.ops import advect, fused_cuda, geometry

from torch_port_common import CPU   # also caps torch at one thread

NSIDE, N = 4, 600
MODES = ("TetVelocity", "VertexVelocity", "ConstantVelocity")
TOL = dict(atol=1e-12, rtol=0)


@pytest.fixture(scope="module")
def setup():
    """One float64 payload for both packages: box 4^3 with an outward swirl
    per tet and per vertex, +x faces as patch 1; 600 seeds, a few outside
    the domain or inactive, with a velocity of their own."""
    pts, tets, _ = tmesh.box_points_tets(NSIDE, NSIDE, NSIDE)

    def field(x):
        c = x - NSIDE / 2.0
        return c * 0.6 + np.stack([-c[:, 1], c[:, 0], 0.3 * c[:, 2]], 1) * 0.5

    payload = tmesh.from_arrays_host(pts, tets, tet_vel=field(pts[tets].mean(axis=1)),
                                     vert_vel=field(pts), dtype=np.float64)
    ctr = payload["points"][payload["bd_tris"]].mean(axis=1)
    payload["bd_patch"] = (ctr[:, 0] > NSIDE - 1e-6).astype(np.int32)
    jm = jmesh.host_to_device(dict(payload))
    tm = convert.to_mesh(payload, device=CPU)
    rng = np.random.default_rng(5)
    pos = rng.uniform(0.2, NSIDE - 0.2, (N, 3))
    tet = cpt.locate_seeds(tm, cpt.build_grid_locator(tm), torch.as_tensor(pos)).numpy()
    tet[:7] = -1 - np.arange(7)                       # lanes that left the domain
    vel = rng.normal(size=(N, 3))
    act = rng.uniform(size=N) > 0.03
    ts = convert.to_state(pos, tet, vel=vel, active=act, dtype=np.float64, device=CPU)
    js = dataclasses.replace(jstate.make_state(jnp.asarray(pos)), tet_id=jnp.asarray(tet),
                             vel=jnp.asarray(vel), active=jnp.asarray(act))
    return jm, tm, js, ts


def _same_state(got, want, moved_from=None):
    np.testing.assert_array_equal(got.tet_id.numpy(), np.asarray(want.tet_id))
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos), **TOL)
    np.testing.assert_allclose(got.vel.numpy(), np.asarray(want.vel), **TOL)
    np.testing.assert_allclose(got.disp.numpy(), np.asarray(want.disp), **TOL)
    assert got.step == int(want.step)
    if moved_from is not None:
        assert (got.tet_id != moved_from.tet_id).any()


def test_bary_from_tinv_matches_jax(setup):
    jm, tm, js, ts = setup
    safe = ts.tet_id.long().clamp(min=0)
    got = geometry.bary_from_tinv(ts.pos, tm.tet_a[safe], tm.tet_tinv[safe])
    jsafe = jnp.maximum(js.tet_id, 0)
    want = jgeometry.bary_from_tinv(js.pos, jm.tet_a[jsafe], jm.tet_tinv[jsafe])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-13, rtol=0)
    np.testing.assert_allclose(got.sum(dim=1).numpy(), 1.0, atol=1e-12)


@pytest.mark.parametrize("mode", MODES)
def test_interp_velocity_matches_jax(setup, mode):
    jm, tm, js, ts = setup
    got = advect.interp_velocity(tm, ts.pos, ts.tet_id, ts.vel, mode)
    want = jadvect.interp_velocity(jm, js.pos, js.tet_id, js.vel, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="unknown velocity interpolation mode"):
        advect.interp_velocity(tm, ts.pos, ts.tet_id, ts.vel, "FaceVelocity")


@pytest.mark.parametrize("integrator", ["euler", "rk4"])
@pytest.mark.parametrize("mode", MODES)
def test_advect_matches_jax(setup, mode, integrator):
    jm, tm, js, ts = setup
    dt = 0.35
    d, v, a = advect.advect(tm, ts.pos, ts.vel, ts.tet_id, ts.active, dt, mode, integrator)
    jd, jv, ja = jadvect.advect(jm, js.pos, js.vel, js.tet_id, js.active, jnp.float64(dt), mode,
                                integrator=integrator)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
    # lanes with a negative tet are killed and keep their velocity, without a displacement
    dead = ts.tet_id.numpy() < 0
    assert not a.numpy()[dead].any() and not d.numpy()[dead].any()
    np.testing.assert_array_equal(v.numpy()[dead], ts.vel.numpy()[dead])
    with pytest.raises(ValueError, match="unknown integrator"):
        advect.advect(tm, ts.pos, ts.vel, ts.tet_id, ts.active, dt, mode, "rk2")


def test_rk4_differs_from_euler_and_walks_stages(setup):
    _, tm, _, ts = setup
    e, _, _ = advect.advect(tm, ts.pos, ts.vel, ts.tet_id, ts.active, 0.35, "VertexVelocity")
    r, _, _ = advect.advect(tm, ts.pos, ts.vel, ts.tet_id, ts.active, 0.35, "VertexVelocity",
                            "rk4")
    assert float((e - r).abs().max()) > 1e-3


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_brownian_and_move_match_jax(setup, dtype):
    jm, tm, js, ts = setup
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    key = jax.random.PRNGKey(11)
    disp = np.random.default_rng(2).normal(size=(N, 3)).astype(dtype)
    xi = np.asarray(jax.random.normal(key, (N, 3), dtype=dtype))
    want = jadvect.brownian(jnp.asarray(disp), js.active, key, jnp.asarray(0.07, dtype), 3e-3)
    got = advect.brownian(torch.as_tensor(disp), ts.active, torch.as_tensor(xi.copy()), 0.07,
                          3e-3)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12 if dtype == np.float64 else 1e-6)
    idle = ~ts.active.numpy()
    np.testing.assert_array_equal(got.numpy()[idle], disp[idle])
    pos = ts.pos.to(tdt)
    p, d = advect.move(pos, got, ts.active)
    jp, jd = jadvect.move(jnp.asarray(pos.numpy()), want, js.active)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(p.numpy()[idle], pos.numpy()[idle])
    assert not d.numpy()[~idle].any() and (d.numpy()[idle] == got.numpy()[idle]).all()
    np.testing.assert_array_equal(np.asarray(jd) == 0, d.numpy() == 0)


@pytest.mark.parametrize("diffusion", [5.7e-6, 1e-2])
def test_eval_timestep_matches_jax(setup, diffusion):
    jm, tm, _, _ = setup
    lo, hi = advect.eval_timestep(tm, diffusion)
    jlo, jhi = jadvect.eval_timestep(jm, diffusion)
    np.testing.assert_allclose([float(lo), float(hi)], [float(jlo), float(jhi)], rtol=1e-12)
    assert 0 < float(lo) <= float(hi)


CYCLE_CASES = [
    dict(velocity_interp="TetVelocity"),
    dict(velocity_interp="VertexVelocity"),
    dict(velocity_interp="ConstantVelocity"),
    dict(velocity_interp="TetVelocity", integrator="rk4"),
    dict(velocity_interp="VertexVelocity", integrator="rk4"),
    dict(velocity_interp="VertexVelocity", reflect_wall=False),
    dict(velocity_interp="VertexVelocity", escape=True),
    dict(velocity_interp="TetVelocity", max_hops=1, max_bounces=2),
    dict(velocity_interp="TetVelocity", locate_mode="convex"),
    dict(velocity_interp="VertexVelocity", locate_mode="convex"),
    dict(velocity_interp="ConstantVelocity", locate_mode="convex", integrator="rk4"),
    dict(velocity_interp="TetVelocity", locate_mode="convex", convex_bary_fix=False),
    dict(velocity_interp="VertexVelocity", locate_mode="convex", escape=True),
    dict(velocity_interp="TetVelocity", locate_mode="convex", reflect_wall=False),
]


@pytest.mark.parametrize("case", CYCLE_CASES,
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_simple_engine_matches_jax(setup, case):
    """``run_cycles(engine="simple")`` and ``step_once`` against JAX's,
    Brownian off (the two packages draw different threefry bits), float64,
    8 cycles: tet/active exact, pos/vel/disp within 1e-12."""
    jm, tm, js, ts = setup
    kw = dict(case)
    if kw.pop("escape", False):
        jm, tm = jmesh.set_boundary_escape(jm, [1]), tmesh.set_boundary_escape(tm, [1])
    kw = dict(dt=0.3, use_brownian=False, engine="simple", **kw)
    one = cpt.step_once(tm, ts, cpt.StepConfig(**kw), 0.3)
    _same_state(one, jcpf.step_once(jm, js, jcpf.StepConfig(**kw), 0.3))
    fin = cpt.run_cycles(tm, ts, cpt.StepConfig(**kw), 8)
    _same_state(fin, jcpf.run_cycles(jm, js, jcpf.StepConfig(**kw), 8), moved_from=ts)
    if case.get("escape"):
        assert (fin.tet_id.numpy()[ts.tet_id.numpy() >= 0] < 0).any()


def _live(tm, ts):
    """The fixture's state with every lane in the domain and active (the
    engines agree on lanes that are alive; a lane that starts dead is
    carried differently by design)."""
    tet = cpt.locate_seeds(tm, cpt.build_grid_locator(tm), ts.pos)
    return dataclasses.replace(ts, tet_id=tet, active=torch.ones_like(ts.active))


def test_fuzz_cached_vs_simple(setup):
    """Seeded fuzz over the StepConfig surface (a twin of the JAX package's
    ``test_fuzz_cached_vs_simple``): the cached engine (the kernels' plain
    versions here) keeps to the simple engine's trajectories on one
    injected noise stream, under both layouts."""
    _, tm, _, ts = setup
    tm = tmesh.with_pk_rows(tm)
    st = _live(tm, ts)
    rng = np.random.default_rng(2024)
    for trial in range(8):
        kw = dict(
            dt=float(rng.uniform(0.02, 0.5)),
            diffusion_coeff=float(10 ** rng.uniform(-5, -2.5)),
            use_advection=bool(rng.random() < 0.85),
            use_brownian=bool(rng.random() < 0.7),
            reflect_wall=bool(rng.random() < 0.85),
            inline_hops=int(rng.integers(0, 5)),
            inline_bounce=bool(rng.random() < 0.7),
            velocity_interp=str(rng.choice(["TetVelocity", "VertexVelocity"])),
            hop_compact=int(rng.choice([0, 4])),
            macro_cycles=int(rng.choice([1, 1, 3])),
        )
        n = int(rng.integers(10, 30))
        noise = torch.as_tensor(rng.standard_normal((n, N, 3)))
        a = cpt.run_cycles(tm, st, cpt.StepConfig(engine="simple", **kw), n, noise=noise)
        b = cpt.run_cycles(tm, st, cpt.StepConfig(engine="cached", **kw), n, noise=noise)
        try:
            assert torch.equal(a.tet_id, b.tet_id) and torch.equal(a.active, b.active)
            np.testing.assert_allclose(a.pos.numpy(), b.pos.numpy(), atol=1e-9, rtol=0)
            np.testing.assert_allclose(a.vel.numpy(), b.vel.numpy(), atol=1e-9, rtol=0)
        except AssertionError as e:
            raise AssertionError(f"fuzz trial {trial} failed for {kw}") from e


@pytest.mark.parametrize("mode", ["TetVelocity", "VertexVelocity"])
def test_cached_convex_and_bary_match_simple_without_noise(setup, mode):
    _, tm, _, ts = setup
    tm = tmesh.with_pk_rows(cpt.with_convex_rows(tm))
    st = _live(tm, ts)
    cfg = cpt.StepConfig(dt=0.2, use_brownian=False, velocity_interp=mode)
    a = cpt.run_cycles(tm, st, dataclasses.replace(cfg, engine="simple"), 25)
    b = cpt.run_cycles(tm, st, dataclasses.replace(cfg, engine="cached"), 25)
    assert torch.equal(a.tet_id, b.tet_id) and torch.equal(a.active, b.active)
    np.testing.assert_allclose(a.pos.numpy(), b.pos.numpy(), atol=1e-9, rtol=0)
    assert bool(b.active.all()) and bool((b.tet_id >= 0).all())
    assert float((b.pos - st.pos).abs().max()) > 0.1


def _refuse_cached(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the cached engine ran")

    for name in ("stream_cycle", "rare_resolve", "convex_stream_cycle", "convex_rare_resolve"):
        monkeypatch.setattr(fused_cuda, name, refuse)


def test_pk_missing_rows_falls_back(setup, monkeypatch):
    """VertexVelocity on a mesh without ``with_pk_rows`` runs the simple
    engine, as in the JAX package: the same physics, bit for bit."""
    jm, tm, js, ts = setup
    assert tm.tet_row_pk is None
    kw = dict(velocity_interp="VertexVelocity", dt=0.05, use_brownian=False)
    want = cpt.run_cycles(tm, ts, cpt.StepConfig(engine="simple", **kw), 20)
    _refuse_cached(monkeypatch)
    got = cpt.run_cycles(tm, ts, cpt.StepConfig(**kw), 20)
    for f in ("pos", "vel", "tet_id", "active"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    _same_state(got, jcpf.run_cycles(jm, js, jcpf.StepConfig(**kw), 20))


def test_convex_missing_rows_falls_back(setup, monkeypatch):
    """``locate_mode="convex"`` on a mesh without ``with_convex_rows`` runs
    the simple engine, as in the JAX package."""
    jm, tm, js, ts = setup
    assert tm.tet_row_cx is None
    kw = dict(locate_mode="convex", dt=0.1, use_brownian=False)
    want = cpt.run_cycles(tm, ts, cpt.StepConfig(engine="simple", **kw), 12)
    _refuse_cached(monkeypatch)
    got = cpt.run_cycles(tm, ts, cpt.StepConfig(**kw), 12)
    for f in ("pos", "vel", "tet_id", "active"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    _same_state(got, jcpf.run_cycles(jm, js, jcpf.StepConfig(**kw), 12))


@pytest.mark.parametrize("kw, table", [
    (dict(velocity_interp="VertexVelocity"), "with_pk_rows"),
    (dict(locate_mode="convex"), "with_convex_rows"),
    (dict(locate_mode="convex", engine="cached"), "with_convex_rows"),
], ids=["pk", "convex", "convex-cached"])
def test_missing_rows_raise_on_the_card(setup, kw, table):
    """On the card a missing table is an error that names the table and
    ``engine="simple"``: the kernels never give way to torch ops without a
    word.  With the table, with ``engine="simple"``, or outside the cached
    engine's envelope the choice is ``resolved_engine``'s on any device."""
    from cudaparticlesfoam_tpu_torch import stepper

    _, tm, _, _ = setup
    cfg = cpt.StepConfig(**kw)
    cuda = torch.device("cuda", 0)
    assert stepper.engine_for(tm, cfg, CPU) == "simple"
    with pytest.raises(ValueError, match=rf"{table}.*engine='simple'"):
        stepper.engine_for(tm, cfg, cuda)
    full = tmesh.with_pk_rows(cpt.with_convex_rows(tm))
    assert stepper.engine_for(full, cfg, cuda) == "cached"
    assert stepper.engine_for(tm, dataclasses.replace(cfg, engine="simple"), cuda) == "simple"
    outside = cpt.StepConfig(locate_mode="convex", velocity_interp="VertexVelocity")
    assert stepper.engine_for(tm, outside, cuda) == "simple"


def test_simple_engine_noise_is_injected_or_drawn_per_step(setup):
    _, tm, _, ts = setup
    cfg = cpt.StepConfig(dt=0.05, diffusion_coeff=1e-2, use_advection=False, engine="simple")
    xi = torch.as_tensor(np.random.default_rng(1).standard_normal((N, 3)))
    out = cpt.cycle(tm, ts, cfg, 0.05, noise=xi)
    act = ts.active.numpy()
    sigma = np.sqrt(2 * 1e-2 * 0.05)
    # the tiny kick keeps nearly every lane off the walls: pos moved by sigma * xi
    moved = (out.pos - ts.pos).numpy()
    plain = np.abs(moved - sigma * xi.numpy()).max(axis=1) < 1e-12
    assert plain[act].mean() > 0.8 and not moved[~act].any()
    # without noise= the draw is that of (seed, step), as the cached engine's
    a = cpt.run_cycles(tm, ts, cfg, 2)
    b = cpt.run_cycles(tm, ts, cfg, 2)
    c = cpt.run_cycles(tm, dataclasses.replace(ts, seed=ts.seed + 1), cfg, 2)
    assert torch.equal(a.pos, b.pos) and not torch.equal(a.pos, c.pos) and a.step == 2
    with pytest.raises(ValueError, match="noise must be"):
        cpt.run_cycles(tm, ts, cfg, 2, noise=xi)
