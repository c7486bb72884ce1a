"""PyTorch port, ConvexPoly locate mode: the cx row tables, the tracer and
reflectors (``ops/convex.py``, ``locate.reflect_walls``), the convex stream
(``convex_stream_plain``, the plain version of the CUDA
``convex_stream_kernel``) against the JAX package's Pallas kernels in
interpret mode, the convex rare stage (``convex_rare_plain``) against JAX
``fused_convex._rare_stage``, and 20 cycles against JAX ``run_cycles``.
Inputs are built once with numpy from a seed and uploaded to both packages.

Tolerances: float64 gives exact tet/active and pos/vel within 1e-12; the
float32 Pallas comparison gives exact tet/active/pending and 2e-6 (Mosaic
may contract mul+add into FMA, the plain version does not)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudaparticlesfoam_tpu as jcpf
import cudaparticlesfoam_tpu.mesh as jmesh
from cudaparticlesfoam_tpu import StepConfig as JStepConfig
from cudaparticlesfoam_tpu.ops import convex as jconvex
from cudaparticlesfoam_tpu.ops import fused as jfused
from cudaparticlesfoam_tpu.ops import fused_convex as jfused_convex
from cudaparticlesfoam_tpu.ops import fused_pallas
from cudaparticlesfoam_tpu.ops import locate as jlocate
import cudaparticlesfoam_tpu_torch as cpt
from cudaparticlesfoam_tpu_torch import convert
from cudaparticlesfoam_tpu_torch import mesh as tmesh
from cudaparticlesfoam_tpu_torch.ops import convex, fused, fused_convex, fused_cuda
from cudaparticlesfoam_tpu_torch.ops import locate

from torch_port_common import CPU   # also caps torch at one thread

TOL64 = dict(atol=1e-12, rtol=0)


def _payload(nside, dtype, field="radial", seed=0):
    """Box payload with +x faces tagged as patch 1 and the -y faces as
    patch 2; field 'radial' (outward) or 'swirl' (outward plus a swirl:
    hops, walls and corner hits)."""
    pts, tets, vv = tmesh.box_points_tets(nside, nside, nside)
    cen = pts[tets].mean(axis=1)
    if field == "radial":
        tv = vv[tets].mean(axis=1)
    else:
        c = cen - nside / 2.0
        tv = c / nside * 2.0 + np.stack([-c[:, 1], c[:, 0], 0 * c[:, 2]], 1) / nside
        tv = tv + np.random.default_rng(seed).normal(scale=0.2, size=tv.shape)
    payload = tmesh.from_arrays_host(pts, tets, tet_vel=tv, vert_vel=vv, dtype=dtype)
    ctr = payload["points"][payload["bd_tris"]].mean(axis=1)
    payload["bd_patch"] = np.where(ctr[:, 0] > nside - 1e-6, 1,
                                   np.where(ctr[:, 1] < 1e-6, 2, 0)).astype(np.int32)
    return payload


def _meshes(payload, escape=()):
    """(JAX mesh, port mesh), both with the convex rows and the same
    absorbing patches."""
    jm = jmesh.host_to_device(dict(payload))
    tm = convert.to_mesh(payload, device=CPU)
    if escape:
        jm = jmesh.set_boundary_escape(jm, list(escape))
        tm = tmesh.set_boundary_escape(tm, list(escape))
    return jmesh.with_convex_rows(jm), cpt.with_convex_rows(tm)


def _located(tm, pos):
    st = convert.to_state(pos, np.zeros(len(pos), np.int32), dtype=tm.dtype, device=CPU)
    return cpt.locate_seeds(tm, cpt.build_grid_locator(tm), st.pos)


# ---------------------------------------------------------------------------
# 1. the cx row tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_convex_rows_match_jax(dtype):
    payload = _payload(4, dtype, "swirl")
    jm, tm = _meshes(payload, escape=(1,))
    for k in ("tet_row_cx", "tet_row_cxe"):
        got, want = getattr(tm, k).numpy(), np.asarray(getattr(jm, k))
        assert got.dtype == want.dtype and got.shape == want.shape == (tm.n_tets, 24)
        np.testing.assert_array_equal(got, want, err_msg=k)
        np.testing.assert_array_equal(tm.host[k], want, err_msg=k)
    np.testing.assert_array_equal(fused_convex.cx_table(tm).numpy(),
                                  np.asarray(jfused_convex.cx_table(jm)))
    assert cpt.with_convex_rows(tm) is tm
    # a velocity refresh lands in the engine table too
    tv = np.random.default_rng(1).normal(size=(tm.n_tets, 3))
    jr = jmesh.replace_velocity(jm, tet_vel=tv)
    tr = cpt.replace_velocity(tm, tet_vel=tv)
    for k in ("tet_row_cxe", "tet_row_cx", "tet_row", "tet_vel"):
        np.testing.assert_array_equal(getattr(tr, k).numpy(), np.asarray(getattr(jr, k)),
                                      err_msg=k)
        np.testing.assert_array_equal(tr.host[k], np.asarray(getattr(jr, k)), err_msg=k)
    # the payload carries the rows to JAX and back
    back = convert.to_mesh(convert.mesh_payload(tr), device=CPU)
    rt = jmesh.host_to_device(convert.mesh_payload(tr))
    for k in ("tet_row_cx", "tet_row_cxe"):
        np.testing.assert_array_equal(getattr(back, k).numpy(), tr.host[k])
        np.testing.assert_array_equal(np.asarray(getattr(rt, k)), tr.host[k])


def test_convex_rows_need_exact_float32_codes():
    tm = convert.to_mesh(_payload(2, np.float32), device=CPU)
    big = dataclasses.replace(tm, n_tets=1 << 24)
    with pytest.raises(ValueError, match="2\\^24"):
        cpt.with_convex_rows(big)
    with pytest.raises(ValueError, match="with_convex_rows"):
        fused_convex.cx_table(tm)


# ---------------------------------------------------------------------------
# 2. the tracer and the reflectors, float64
# ---------------------------------------------------------------------------


def _segments(n, nside, seed, tm):
    """Starts inside the box with their tets, and displacements from short
    (a hop or two) to far past the walls and corners."""
    rng = np.random.default_rng(seed)
    start = rng.uniform(0.2, nside - 0.2, (n, 3))
    scale = np.where(rng.uniform(size=(n, 1)) < 0.5, 0.8, 4.0)
    disp = rng.normal(size=(n, 3)) * scale
    tet = _located(tm, start)
    vel = rng.normal(size=(n, 3))
    act = rng.uniform(size=n) > 0.1
    return start, disp, tet, vel, act


@pytest.mark.parametrize("escape", [False, True])
def test_trace_and_reflect_match_jax(escape):
    nside, n = 6, 2048
    jm, tm = _meshes(_payload(nside, np.float64), escape=(1, 2) if escape else ())
    start, disp, tet, vel, act = _segments(n, nside, 3 + escape, tm)
    t = lambda x: torch.as_tensor(x)  # noqa: E731
    got = convex.trace_segment(tm, t(start), t(disp), tet, active=t(act), max_tets=6)
    want = jconvex.trace_segment(jm, jnp.asarray(start), jnp.asarray(disp),
                                 jnp.asarray(tet.numpy()), active=jnp.asarray(act),
                                 max_tets=6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL64)
    code = got[0]
    assert (code < 0).any() and (code != tet).any()

    r_got = convex.convex_reflect(tm, t(start), t(disp), t(vel), *got)
    r_want = jconvex.convex_reflect(jm, jnp.asarray(start), jnp.asarray(disp),
                                    jnp.asarray(vel), *want)
    for g, w in zip(r_got, r_want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL64)
    hit = code.numpy() < 0
    assert (r_got[3].numpy()[hit] >= 0).any()
    if escape:
        assert (r_got[3].numpy()[hit] < 0).any()

    # the barycentric safety net on the landed points
    p_land = r_got[0] + r_got[1]
    tet_chk, slot = locate.walk(tm, p_land, r_got[3])
    j_chk, j_slot = jlocate.walk(jm, jnp.asarray(p_land.numpy()), jnp.asarray(r_want[3]))
    np.testing.assert_array_equal(tet_chk.numpy(), np.asarray(j_chk))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(j_slot))
    # walls far away so that several bounces run
    far = p_land + t(disp) * 3.0
    tet_far, _ = locate.walk(tm, far, tet_chk)
    for mb in (10, 1):
        w_got = locate.reflect_walls(tm, far, torch.zeros_like(far), t(vel), tet_far,
                                     max_bounces=mb)
        w_want = jlocate.reflect_walls(jm, jnp.asarray(far.numpy()), jnp.zeros((n, 3)),
                                       jnp.asarray(vel), jnp.asarray(tet_far.numpy()),
                                       max_bounces=mb)
        for g, w in zip(w_got, w_want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL64)
    assert (tet_far.numpy() < 0).sum() > 100


# ---------------------------------------------------------------------------
# 3. the convex stream against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def _lanes(tm, tab, n, nside, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.5, nside - 0.5, (n, 3)).astype(np.float32)
    tet = _located(tm, pos)
    return fused_convex.pack_state(tm, tab, torch.as_tensor(pos), torch.zeros((n, 3)),
                                   tet, torch.ones(n, dtype=torch.bool))


@pytest.mark.parametrize("escape", [False, True])
def test_convex_stream_plain_matches_pallas_interpret(escape):
    """Box 8^3, 8192 lanes, float32, inline_hops 1, brownian_rng "rbg"
    (the Philox stream on the CPU: the port draws its own, JAX draws
    lax.rng_bit_generator's): the stream section (pos/vel/tet/active,
    pending, disp), then the whole cycle (the packed rare stage against
    ``convex_rare_plain``)."""
    from jax.experimental.pallas import tpu as pltpu

    # the Pallas kernels are float32-only; the harness enables x64 globally
    if jax.config.read("jax_enable_x64"):
        jax.config.update("jax_enable_x64", False)
        try:
            return test_convex_stream_plain_matches_pallas_interpret(escape)
        finally:
            jax.config.update("jax_enable_x64", True)

    n, nside, dt, seed, step = fused_pallas.PACK_LANES, 8, 0.4, 1, 3
    jm, tm = _meshes(_payload(nside, np.float32), escape=(1,) if escape else ())
    tab = fused_convex.cx_table(tm)
    m0 = _lanes(tm, tab, n, nside, seed=5 + escape)
    kw = dict(dt=dt, diffusion_coeff=3e-3, locate_mode="convex", walk_capacity_frac=0.25,
              brownian_rng="rbg", escape_faces=escape)
    cfg = cpt.StepConfig(**kw)
    jcfg = JStepConfig(**kw)
    key = jax.random.PRNGKey(seed)
    m_in = jnp.asarray(m0.numpy()).reshape(-1, 4 * fused_convex.WIDTH)
    with pltpu.force_tpu_interpret_mode():
        m_rm, disp_pk, jpend = fused_pallas.convex_pre_rare_cycle_packed(
            jm, jm.tet_row_cxe, m_in, key, step, jcfg, jnp.float32(dt))
        m_full = jfused_convex.mega_cycle_packed(jm, jm.tet_row_cxe, m_in, key, step,
                                                 jcfg, jnp.float32(dt))

    m, pend = m0.clone(), torch.empty(n, dtype=torch.uint8)
    disp = torch.empty((n, 3))
    dt_t, sigma = fused.scalars(cfg, dt, torch.float32)
    fused_cuda.convex_stream_cycle(tab, m, None, pend, disp, dt=dt_t, sigma=sigma,
                                   use_adv=True, use_brown=True, n_hops=1,
                                   noise_key=fused.philox_key(seed, step))
    mj = np.asarray(m_rm).reshape(n, 32)
    got = m.numpy()
    np.testing.assert_array_equal(got[:, 6], mj[:, 6])
    np.testing.assert_array_equal(got[:, 7], mj[:, 7])
    np.testing.assert_array_equal(pend.numpy().astype(bool), np.asarray(jpend))
    np.testing.assert_allclose(got[:, :6], mj[:, :6], atol=2e-6, rtol=0)
    np.testing.assert_allclose(disp.numpy(), np.asarray(disp_pk).reshape(n, 4)[:, :3],
                               atol=2e-6, rtol=0)
    assert 0.01 < pend.numpy().mean() < 0.5 and (got[:, 6] != m0.numpy()[:, 6]).any()

    fused_cuda.convex_rare_resolve(tm, tab, m, disp, pend, max_hops=cfg.max_hops,
                                   reflect_wall=True, bary_fix=True,
                                   max_bounces=cfg.max_bounces)
    mf = np.asarray(m_full).reshape(n, 32)
    got = m.numpy()
    np.testing.assert_array_equal(got[:, 6], mf[:, 6])
    np.testing.assert_array_equal(got[:, 7], mf[:, 7])
    np.testing.assert_allclose(got[:, :6], mf[:, :6], atol=2e-6, rtol=0)


# ---------------------------------------------------------------------------
# 4. the convex rare stage, float64
# ---------------------------------------------------------------------------


RARE_CASES = [
    dict(),
    dict(escape_faces=True),
    dict(reflect_wall=False),
    dict(convex_bary_fix=False),
    dict(max_hops=2),
    dict(max_bounces=1, escape_faces=True),
    dict(escape_faces=True, convex_bary_fix=False),
]


@pytest.mark.parametrize("case", range(len(RARE_CASES)))
def test_convex_rare_plain_matches_jax_rare_stage(case):
    kw = RARE_CASES[case]
    nside, n = 6, 2048
    escape = (1, 2) if kw.get("escape_faces") else ()
    jm, tm = _meshes(_payload(nside, np.float64), escape=escape)
    tab = fused_convex.cx_table(tm)
    start, disp, tet, vel, act = _segments(n, nside, 20 + case, tm)
    m0 = fused_convex.pack_state(tm, tab, torch.as_tensor(start), torch.as_tensor(vel),
                                 tet, torch.as_tensor(act))
    rng = np.random.default_rng(case)
    pend = torch.as_tensor((rng.uniform(size=n) < 0.7) & act & (tet.numpy() >= 0))
    cfg = cpt.StepConfig(**kw)
    m = m0.clone()
    fused_cuda.convex_rare_resolve(tm, tab, m, torch.as_tensor(disp), pend.to(torch.uint8),
                                   max_hops=cfg.max_hops, reflect_wall=cfg.reflect_wall,
                                   bary_fix=cfg.convex_bary_fix,
                                   max_bounces=cfg.max_bounces)
    mj = np.asarray(jfused_convex._rare_stage(
        jm, jm.tet_row_cxe, jnp.asarray(m0.numpy()), jnp.asarray(disp),
        jnp.asarray(pend.numpy()), JStepConfig(locate_mode="convex", **kw), n, n // 8))
    got = m.numpy()
    flip = got[:, 6] != mj[:, 6]
    if escape and cfg.reflect_wall and cfg.convex_bary_fix:
        # A lane absorbed at an outlet face is parked exactly on the face,
        # and the safety-net walk decides from a weight of about one ulp
        # whether that point is inside (tet) or not (-(tet+1)).  JAX's
        # compiled trace contracts mul+add into FMA on the CPU, so its hit
        # point differs from the plain version's by ulps; those lanes may
        # differ in that sign only.  Every other lane is exact.
        g, w = got[flip, 6], mj[flip, 6]
        np.testing.assert_array_equal(np.where(g < 0, -g - 1, g), np.where(w < 0, -w - 1, w))
        on_outlet = (np.abs(got[:, 0] - nside) < 1e-9) | (np.abs(got[:, 1]) < 1e-9)
        assert on_outlet[flip].all() and flip.mean() < 0.1
        flip = np.zeros_like(flip)
    assert not flip.any()
    np.testing.assert_array_equal(got[:, 7], mj[:, 7])
    np.testing.assert_allclose(got[:, :6], mj[:, :6], **TOL64)
    live = got[:, 6] >= 0
    np.testing.assert_array_equal(got[live, 8:], tab.numpy()[got[live, 6].astype(int)])
    idle = ~pend.numpy()
    np.testing.assert_array_equal(got[idle], m0.numpy()[idle])
    assert (got[~idle, 6] != m0.numpy()[~idle, 6]).mean() > 0.5
    if escape and cfg.reflect_wall and not cfg.convex_bary_fix:
        # absorbed lanes keep their wall code (the safety net would walk
        # them back onto the outlet face)
        assert (got[~idle, 6] < 0).any()


def test_convex_rare_plain_with_nothing_pending_is_a_no_op():
    _, tm = _meshes(_payload(4, np.float64))
    tab = fused_convex.cx_table(tm)
    start, disp, tet, vel, act = _segments(256, 4, 0, tm)
    m0 = fused_convex.pack_state(tm, tab, torch.as_tensor(start), torch.as_tensor(vel),
                                 tet, torch.as_tensor(act))
    m = m0.clone()
    fused_convex.convex_rare_plain(tm, tab, m, torch.as_tensor(disp),
                                   torch.zeros(256, dtype=torch.uint8), max_hops=50,
                                   reflect_wall=True, bary_fix=True, max_bounces=10)
    assert torch.equal(m, m0)


# ---------------------------------------------------------------------------
# 5./6. whole cycles against the JAX cached convex engine, float64
# ---------------------------------------------------------------------------


STREAM_CASES = [
    dict(inline_hops=1),
    dict(inline_hops=0),
    dict(inline_hops=1, escape_faces=True),
    dict(inline_hops=4, reflect_wall=False),
    dict(inline_hops=1, use_advection=False, diffusion_coeff=0.05),
]


@pytest.mark.parametrize("case", range(len(STREAM_CASES)))
def test_convex_cycle_plain_matches_jnp_engine_f64(case):
    """convex_stream_plain + convex_rare_plain against
    ``fused_convex._cycle_aligned`` (jnp engine, float64, the JAX "rbg"
    noise drawn by each package)."""
    kw = dict(dict(dt=0.5, diffusion_coeff=5e-3, locate_mode="convex",
                   brownian_rng="rbg"), **STREAM_CASES[case])
    nside, n, seed, step = 6, 4096, 2, 7
    escape = (1,) if kw.get("escape_faces") else ()
    jm, tm = _meshes(_payload(nside, np.float64, "swirl", seed=case), escape=escape)
    tab = fused_convex.cx_table(tm)
    rng = np.random.default_rng(30 + case)
    pos = rng.uniform(0.05, nside - 0.05, (n, 3))
    m0 = fused_convex.pack_state(tm, tab, torch.as_tensor(pos),
                                 torch.as_tensor(rng.normal(size=(n, 3))), _located(tm, pos),
                                 torch.as_tensor(rng.uniform(size=n) > 0.05))
    cfg = cpt.StepConfig(**kw)
    m = fused_convex.mega_cycle(tm, tab, m0.clone(), seed, step, cfg, cfg.dt)
    mj = np.asarray(jfused_convex._cycle_aligned(
        jm, jm.tet_row_cxe, jnp.asarray(m0.numpy()), jax.random.PRNGKey(seed), step,
        JStepConfig(**kw), jnp.float64(cfg.dt)))
    got = m.numpy()
    np.testing.assert_array_equal(got[:, 6], mj[:, 6])
    np.testing.assert_array_equal(got[:, 7], mj[:, 7])
    np.testing.assert_allclose(got[:, :6], mj[:, :6], **TOL64)
    assert (got[:, 6] != m0.numpy()[:, 6]).mean() > 0.2


def test_convex_run_matches_jax_run_cycles():
    """20 cycles of the convex cached engine with Brownian motion, box 6^3,
    1000 lanes, float64: the JAX "rbg" noise injected into the port, and
    the port drawing the same stream itself (brownian_rng "rbg" and
    "rbg_kernel" alike)."""
    nside, n, n_cycles = 6, 1000, 20
    payload = _payload(nside, np.float64, "swirl", seed=9)
    jm, tm = _meshes(payload)
    rng = np.random.default_rng(4)
    pos = rng.uniform(0.1, nside - 0.1, (n, 3))
    tet = _located(tm, pos).numpy()
    kw = dict(dt=0.3, diffusion_coeff=2e-3, locate_mode="convex", brownian_rng="rbg")
    want = jcpf.run_cycles(jm, jcpf.make_state(pos, tet_id=tet, dtype=np.float64, rng_seed=5),
                           jcpf.StepConfig(engine="cached", **kw), n_cycles)
    jcfg = JStepConfig(**kw)
    noise = torch.stack([torch.from_numpy(np.array(jfused._brownian_noise(
        jax.random.PRNGKey(5), step, n, jnp.float64, jcfg))) for step in range(n_cycles)])
    st = convert.to_state(pos, tet, seed=5, dtype=np.float64, device=CPU)
    runs = [cpt.run_cycles(tm, st, cpt.StepConfig(**kw), n_cycles, noise=noise)]
    for mode in ("rbg", "rbg_kernel"):
        runs.append(cpt.run_cycles(tm, st, cpt.StepConfig(**dict(kw, brownian_rng=mode)),
                                   n_cycles))
    for got in runs:
        np.testing.assert_array_equal(got.tet_id.numpy(), np.asarray(want.tet_id))
        np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
        np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos), **TOL64)
        np.testing.assert_allclose(got.vel.numpy(), np.asarray(want.vel), **TOL64)
    assert torch.equal(runs[1].pos, runs[2].pos) and runs[1].step == n_cycles
    assert (runs[0].tet_id.numpy() != tet).mean() > 0.5


def test_convex_needs_the_row_tables():
    tm = convert.to_mesh(_payload(2, np.float64), device=CPU)
    pos = np.random.default_rng(0).uniform(0.2, 1.8, (64, 3))
    st = convert.to_state(pos, np.zeros(64, np.int32), dtype=np.float64, device=CPU)
    st = dataclasses.replace(st, tet_id=cpt.locate_seeds(tm, cpt.build_grid_locator(tm), st.pos))
    # the cached convex engine needs them ...
    with pytest.raises(ValueError, match="with_convex_rows"):
        fused_convex.cx_table(tm)
    # ... so without them run_cycles hands the run to the simple engine, as
    # the JAX package does, and with them to the cached one: the same state
    cfg = cpt.StepConfig(locate_mode="convex", dt=0.05, use_brownian=False)
    got = cpt.run_cycles(tm, st, cfg, 3)
    want = cpt.run_cycles(cpt.with_convex_rows(tm), st, cfg, 3)
    assert got.step == 3 and torch.equal(got.tet_id, want.tet_id)
    np.testing.assert_allclose(got.pos.numpy(), want.pos.numpy(), atol=1e-12, rtol=0)


def test_convex_wrappers_check_inputs():
    tm = cpt.with_convex_rows(convert.to_mesh(_payload(2, np.float32), device=CPU))
    tab = fused_convex.cx_table(tm)
    m = torch.zeros((8, 32))
    pend = torch.zeros(8, dtype=torch.uint8)
    disp = torch.zeros((8, 3))
    kw = dict(dt=0.1, sigma=0.1, use_adv=True, use_brown=False, n_hops=1)
    with pytest.raises(ValueError):
        fused_cuda.convex_stream_cycle(tm.tet_row, m, None, pend, disp, **kw)
    with pytest.raises(ValueError):
        fused_cuda.convex_stream_cycle(tab, m, None, pend, torch.zeros((8, 4)), **kw)
    with pytest.raises(TypeError):
        fused_cuda.convex_stream_cycle(tab, m, None, pend, disp, **dict(kw, use_brown=True))
    with pytest.raises(ValueError):
        fused_cuda.convex_stream_cycle(tab, m, torch.zeros((8, 3)), pend, disp,
                                       noise_key=(1, 2, 3, 4), **dict(kw, use_brown=True))
    with pytest.raises(ValueError):
        fused_cuda.convex_stream_cycle(tab, m, None, pend, disp, noise_key=(1, 2, 3),
                                       **dict(kw, use_brown=True))
    rk = dict(max_hops=50, reflect_wall=True, bary_fix=True, max_bounces=10)
    with pytest.raises(ValueError):
        fused_cuda.convex_rare_resolve(convert.to_mesh(_payload(2, np.float32), device=CPU), tab,
                                       m,
                                       disp, pend, **rk)
    with pytest.raises(TypeError):
        fused_cuda.convex_rare_resolve(tm, tab, m, disp, pend.bool(), **rk)
    before = (fused_cuda.convex_stream_cycle.launches, fused_cuda.convex_rare_resolve.launches)
    fused_cuda.convex_stream_cycle(tab, m, None, pend, disp, **kw)
    fused_cuda.convex_rare_resolve(tm, tab, m, disp, pend, **rk)
    after = (fused_cuda.convex_stream_cycle.launches, fused_cuda.convex_rare_resolve.launches)
    assert after == before   # CPU: plain, no launch
