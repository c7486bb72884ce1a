"""PyTorch port: RK4 on the cached engine (``stream_kernel``'s RK4
instantiation, whose plain version is ``fused.stream_plain(rk4=True)`` with
``fused.stage_velocity``) against the JAX package's cached RK4
(``fused._stage_velocity`` and the jnp cycle, float64) on one host payload,
against the port's simple engine (twins of the JAX package's
``tests/test_fused.py`` RK4 tests and of ``tests/test_flow.py``'s RK4
trajectory test), and its dispatch (no macro cycle, no compacted hop
gather, as on JAX's jnp path)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudaparticlesfoam_tpu.mesh as jmesh
from cudaparticlesfoam_tpu import StepConfig as JStepConfig
from cudaparticlesfoam_tpu.ops import fused as jfused
import cudaparticlesfoam_tpu_torch as cpt
from cudaparticlesfoam_tpu_torch import convert
from cudaparticlesfoam_tpu_torch import mesh as tmesh
from cudaparticlesfoam_tpu_torch.ops import fused, fused_cuda

from torch_port_common import CPU   # also caps torch at one thread

VV = "VertexVelocity"
LAYOUTS = {"tet": fused.LAYOUT_TET, "pk": fused.LAYOUT_PK}


def _swirl_payload(nside):
    """float64 box payload: an outward swirl per tet and per vertex (stage
    points that stay, walk and leave the domain), +x faces as patch 1.  Not
    linear, so that a stage tet's Pk blend differs from the own row's
    extrapolation."""
    pts, tets, _ = tmesh.box_points_tets(nside, nside, nside)

    def field(x):
        c = x - nside / 2.0
        return (c * 0.5 + np.stack([-c[:, 1], c[:, 0], 0.2 * c[:, 2]], 1) * 0.4
                + 0.3 * np.sin(0.7 * x[:, [1, 2, 0]] * x[:, [2, 0, 1]]))

    payload = tmesh.from_arrays_host(pts, tets, tet_vel=field(pts[tets].mean(axis=1)),
                                     vert_vel=field(pts), dtype=np.float64)
    ctr = payload["points"][payload["bd_tris"]].mean(axis=1)
    payload["bd_patch"] = (ctr[:, 0] > nside - 1e-6).astype(np.int32)
    return payload


def _seeds(tm, n, nside, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.3, nside - 0.3, (n, 3))
    st = convert.to_state(pos, np.zeros(n, np.int32), dtype=tm.dtype, device=CPU)
    return dataclasses.replace(st, tet_id=cpt.locate_seeds(tm, cpt.build_grid_locator(tm),
                                                           st.pos))


@pytest.fixture(scope="module")
def box6():
    """One payload for both packages (box 6^3), with the Pk rows and the
    escape mask of patch 1 on both sides, and 2,048 located seeds."""
    payload = _swirl_payload(6)
    jm = jmesh.with_pk_rows(jmesh.host_to_device(dict(payload)))
    tm = tmesh.with_pk_rows(convert.to_mesh(payload, device=CPU))
    return jm, tm, _seeds(tm, 2048, 6, seed=3)


@pytest.mark.parametrize("layout", ["tet", "pk"])
def test_stage_velocity_matches_jax(box6, layout):
    """The port's plain stage velocity against ``fused._stage_velocity`` on
    the same mega, float64: stage points that stay in the cell, walk 1-3
    hops, and leave the domain.  Values within 1e-12, and the lanes that
    keep the own-row default (no walk, or a walk out of the domain) the
    same (JAX's compiled CPU loop contracts the Pk blend into FMAs, so
    "kept" is within 1e-13 of the port's default)."""
    jm, tm, st = box6
    ly, jly = LAYOUTS[layout], jfused.LAYOUT_PK if layout == "pk" else jfused.LAYOUT_TET
    n = st.n_particles
    m = fused.pack_state(fused.row_table(tm, ly), st.pos, st.vel, st.tet_id, st.active, ly.width)
    jmega = jfused.pack_state(jm, jnp.asarray(st.pos.numpy()), jnp.zeros((n, 3)),
                              jnp.asarray(st.tet_id.numpy()), jnp.asarray(st.active.numpy()),
                              jly)
    rng = np.random.default_rng(4)
    # a step of 0 to 2.5 cells in a random direction: 0-3 hops, some out of the box
    d = rng.normal(size=(n, 3))
    d *= (rng.uniform(0.0, 2.5, n) / np.linalg.norm(d, axis=1))[:, None]
    q = st.pos.numpy() + d
    rows = m[:, fused.ROW : fused.ROW + ly.tab_w]
    tet = m[:, fused.TET].to(torch.int64)
    live = st.active & (tet >= 0)
    walks = torch.zeros(3, dtype=torch.int64)
    qt = tuple(torch.as_tensor(q[:, c]) for c in range(3))
    got = fused.stage_velocity(fused.row_table(tm, ly), rows, tet, live, qt, ly, walks)
    want = jfused._stage_velocity(jfused.row_table(jm, jly), jmega, jly,
                                  *(jnp.asarray(q[:, c]) for c in range(3)),
                                  jnp.asarray(live.numpy()), JStepConfig())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-12, rtol=0)
    default = [k.numpy() for k in fused._row_velocity(rows, qt, ly)]
    kept_port = np.all([g.numpy() == k for g, k in zip(got, default)], axis=0)
    kept_jax = np.all([np.abs(np.asarray(w) - k) <= 1e-13 for w, k in zip(want, default)],
                      axis=0)
    np.testing.assert_array_equal(kept_port, kept_jax)
    walked, rows_loaded, left = walks.tolist()
    # the stages stay, walk one hop and more, and leave the domain
    assert 0 < walked < n and rows_loaded > walked and left > 0
    assert kept_port.sum() > n - walked       # the walks that left kept the default too


CACHED_CASES = [
    dict(velocity_interp="TetVelocity", inline_hops=1),
    dict(velocity_interp="TetVelocity", inline_hops=3, escape_faces=True),
    dict(velocity_interp=VV, inline_hops=2, escape_faces=True, inline_bounce=False),
]


@pytest.mark.parametrize("case", range(len(CACHED_CASES)))
def test_cached_rk4_matches_jax_f64(case):
    """run_cycles with integrator="rk4" on the cached engine against the
    JAX package's cached RK4 (``engine_impl="jnp"``, float64) over 20
    cycles on box 6^3 with walls and Brownian noise (one injected stream),
    under TetVelocity and VertexVelocity: tet/active exact, pos/vel within
    1e-12."""
    nside, n, dt, n_cycles = 6, 1024, 0.25, 20
    kw = dict(dict(dt=dt, diffusion_coeff=5e-3, integrator="rk4"), **CACHED_CASES[case])
    payload = _swirl_payload(nside)
    jm, tm = jmesh.host_to_device(dict(payload)), convert.to_mesh(payload, device=CPU)
    if kw.get("escape_faces"):
        jm, tm = jmesh.set_boundary_escape(jm, [1]), tmesh.set_boundary_escape(tm, [1])
    jm, tm = jmesh.with_pk_rows(jm), tmesh.with_pk_rows(tm)
    st = _seeds(tm, n, nside, seed=40 + case)
    noise = np.random.default_rng(50 + case).standard_normal((n_cycles, n, 3))
    cfg = cpt.StepConfig(**kw)
    assert cfg.resolved_engine() == "cached"
    fin = cpt.run_cycles(tm, st, cfg, n_cycles, noise=torch.as_tensor(noise))

    jcfg = JStepConfig(engine_impl="jnp", **kw)
    assert jcfg.resolved_engine() == "cached"
    jly = jfused.layout_for(jcfg)
    m = jfused.pack_state(jm, jnp.asarray(st.pos.numpy()), jnp.zeros((n, 3)),
                          jnp.asarray(st.tet_id.numpy()), jnp.asarray(st.active.numpy()), jly)
    step = jax.jit(lambda mm, xi, i: jfused._mega_cycle_aligned(
        jm, mm, jax.random.PRNGKey(0), i, jcfg, jnp.float64(dt), noise=xi))
    for i in range(n_cycles):
        m = step(m, jnp.asarray(noise[i]), i)
    pos, vel, tet, act = (np.asarray(x) for x in jfused.unpack_state(m))
    np.testing.assert_array_equal(fin.tet_id.numpy(), tet)
    np.testing.assert_array_equal(fin.active.numpy(), act)
    np.testing.assert_allclose(fin.pos.numpy(), pos, atol=1e-12, rtol=0)
    np.testing.assert_allclose(fin.vel.numpy(), vel, atol=1e-12, rtol=0)
    assert (tet != st.tet_id.numpy()).mean() > 0.5
    if kw.get("escape_faces"):
        assert (~act).any()


# ---------------------------------------------------------------------------
# twins of the JAX package's cached-against-simple RK4 tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def outward6():
    """``tests/test_fused.py``'s set-up in the port: box 6^3, the outward
    field x1.5 per tet (and at the vertices), 256 located seeds."""
    pts, tets, _ = tmesh.box_points_tets(6, 6, 6)

    def outward(x):
        c = x - 3.0
        return c / (np.linalg.norm(c, axis=1, keepdims=True) + 1e-12) * 1.5

    payload = tmesh.from_arrays_host(pts, tets, tet_vel=outward(pts[tets].mean(axis=1)),
                                     vert_vel=outward(pts), dtype=np.float64)
    tm = tmesh.with_pk_rows(convert.to_mesh(payload, device=CPU))
    rng = np.random.default_rng(6)
    pos = rng.uniform(0.5, 5.5, (256, 3))
    st = convert.to_state(pos, np.zeros(256, np.int32), dtype=np.float64, device=CPU)
    return tm, dataclasses.replace(st, tet_id=cpt.locate_seeds(tm, cpt.build_grid_locator(tm),
                                                               st.pos))


def _compare(tm, st, n, atol=1e-9, **kw):
    a = cpt.run_cycles(tm, st, cpt.StepConfig(engine="simple", **kw), n)
    b = cpt.run_cycles(tm, st, cpt.StepConfig(engine="cached", **kw), n)
    np.testing.assert_allclose(a.pos.numpy(), b.pos.numpy(), atol=atol, rtol=0)
    np.testing.assert_array_equal(a.tet_id.numpy(), b.tet_id.numpy())
    np.testing.assert_array_equal(a.active.numpy(), b.active.numpy())
    np.testing.assert_allclose(a.vel.numpy(), b.vel.numpy(), atol=atol, rtol=0)
    return a, b


def test_rk4_cached_matches_simple(outward6):
    """Twin of ``test_rk4_cached_matches_simple``: crossings, wall
    reflections and out-of-domain stage points on the cached engine equal
    the simple engine's RK4."""
    tm, st = outward6
    a, b = _compare(tm, st, 120, dt=0.08, use_brownian=False, integrator="rk4")
    assert b.active.all()
    assert (a.tet_id != st.tet_id).any()


def test_rk4_cached_matches_simple_brownian(outward6):
    """Twin of ``test_rk4_cached_matches_simple_brownian`` (the port's
    threefry noise: both engines draw the same stream per step)."""
    tm, st = outward6
    _compare(tm, st, 60, dt=0.08, diffusion_coeff=1e-3, integrator="rk4")


def test_rk4_cached_tiny_capacity_overflow(outward6):
    """Twin of ``test_rk4_cached_tiny_capacity_overflow``: JAX's stage-walk
    arena at 1e-3 of the lanes must retire every walker; the port has no
    arena, so the fraction must change nothing."""
    tm, st = outward6
    a = cpt.run_cycles(tm, st, cpt.StepConfig(engine="simple", dt=0.08, use_brownian=False,
                                              integrator="rk4"), 60)
    c = cpt.run_cycles(tm, st, cpt.StepConfig(engine="cached", dt=0.08, use_brownian=False,
                                              integrator="rk4", walk_capacity_frac=1e-3), 60)
    d = cpt.run_cycles(tm, st, cpt.StepConfig(engine="cached", dt=0.08, use_brownian=False,
                                              integrator="rk4"), 60)
    np.testing.assert_allclose(a.pos.numpy(), c.pos.numpy(), atol=1e-9, rtol=0)
    np.testing.assert_array_equal(a.tet_id.numpy(), c.tet_id.numpy())
    for f in ("pos", "vel", "tet_id", "active"):
        assert torch.equal(getattr(c, f), getattr(d, f)), f


def test_pk_rk4_cached_matches_simple(outward6):
    """Twin of ``test_pk_rk4_cached_matches_simple``: each stage takes the
    blend of the stage tet's vertex velocities at the stage point."""
    tm, st = outward6
    a, _ = _compare(tm, st, 80, dt=0.05, use_brownian=False, integrator="rk4",
                    velocity_interp=VV)
    assert (a.tet_id != st.tet_id).any()


def test_rk4_high_order_trajectory():
    """Twin of ``tests/test_flow.py``'s ``test_rk4_high_order_trajectory``
    on the cached engine (the mesh carries its Pk rows): u = 0.1 x, so
    x(t) = x0 exp(0.1 t); RK4's error < 1e-8 and < Euler's x 1e-4."""
    pts, tets, _ = tmesh.box_points_tets(8, 8, 8)
    vv = np.zeros_like(pts)
    vv[:, 0] = pts[:, 0] * 0.1
    tm = tmesh.with_pk_rows(convert.to_mesh(
        tmesh.from_arrays_host(pts, tets, vert_vel=vv, dtype=np.float64), device=CPU))
    rng = np.random.default_rng(7)
    pos = rng.uniform((1.0, 0.5, 0.5), (2.0, 7.5, 7.5), (32, 3))
    st = convert.to_state(pos, np.zeros(32, np.int32), dtype=np.float64, device=CPU)
    st = dataclasses.replace(st, tet_id=cpt.locate_seeds(tm, cpt.build_grid_locator(tm), st.pos))
    T, n = 5.0, 100
    exact = pos[:, 0] * np.exp(0.1 * T)
    errs = {}
    for integ in ("euler", "rk4"):
        cfg = cpt.StepConfig(dt=T / n, use_brownian=False, velocity_interp=VV, integrator=integ)
        assert cfg.resolved_engine() == "cached"
        out = cpt.run_cycles(tm, st, cfg, n)
        errs[integ] = np.abs(out.pos.numpy()[:, 0] - exact).max()
    assert errs["rk4"] < 1e-8
    assert errs["rk4"] < errs["euler"] * 1e-4


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(macro_cycles=4), dict(hop_compact=4), dict(macro_cycles=3, hop_compact=4),
    dict(hop_compact=4, velocity_interp=VV, brownian_rng="rbg_kernel"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_rk4_runs_cycle_by_cycle_on_the_whole_pass(outward6, kw, monkeypatch):
    """Under RK4 (JAX runs it on its jnp path, which has neither),
    ``macro_cycles`` and ``hop_compact=4`` are ignored: the state equals
    the per-cycle whole-pass run's, and no macro or compacted stage runs."""
    def refuse(*a, **k):
        raise AssertionError("a macro or compacted stage ran under RK4")

    for name in ("stream_crossers", "hop_admit", "macro_stream", "macro_crossers"):
        monkeypatch.setattr(fused_cuda, name, refuse)
    tm, st = outward6
    cfg = cpt.StepConfig(dt=0.08, diffusion_coeff=1e-3, integrator="rk4", **kw)
    base = dataclasses.replace(cfg, hop_compact=0, macro_cycles=1)
    out, want = cpt.run_cycles(tm, st, cfg, 9), cpt.run_cycles(tm, st, base, 9)
    for f in ("pos", "vel", "tet_id", "active"):
        assert torch.equal(getattr(out, f), getattr(want, f)), f


def test_rk4_stream_calls_the_whole_rk4_pass(outward6, monkeypatch):
    """mega_cycle hands integrator="rk4" to the stream wrapper (the RK4
    instantiation on the card), and the wrapper refuses it with the
    compacted pass's admission flags."""
    tm, st = outward6
    seen = []
    real = fused_cuda.stream_cycle

    def spy(*a, **k):
        seen.append(k["rk4"])
        return real(*a, **k)

    monkeypatch.setattr(fused_cuda, "stream_cycle", spy)
    cpt.run_cycles(tm, st, cpt.StepConfig(dt=0.08, integrator="rk4"), 2)
    cpt.run_cycles(tm, st, cpt.StepConfig(dt=0.08), 1)
    assert seen == [True, True, False]
    m = fused.pack_state(fused.row_table(tm), st.pos, st.vel, st.tet_id, st.active)
    flags = torch.zeros(st.n_particles, dtype=torch.uint8)
    with pytest.raises(ValueError, match="whole pass only"):
        real(tm.tet_row, m, None, flags, dt=0.1, sigma=0.0, use_adv=True, use_brown=False,
             bounce_on=True, esc_on=False, n_hops=1, admit=flags, rk4=True)
