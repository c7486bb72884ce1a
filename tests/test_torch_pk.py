"""PyTorch port: the VertexVelocity (Pk) path against the JAX package on
one host payload: the ``tet_row_pk`` table and its updates (exact), the
plain versions of the Pk instantiations of ``stream_kernel`` and
``rare_kernel`` against the Pallas packed cycle in interpret mode
(float32) and ``run_cycles`` against JAX's in float64 on injected noise,
and the settings VertexVelocity leaves out as the JAX package does."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudaparticlesfoam_tpu.mesh as jmesh
from cudaparticlesfoam_tpu import StepConfig as JStepConfig
from cudaparticlesfoam_tpu.ops import fused as jfused
from cudaparticlesfoam_tpu.ops import fused_pallas
from cudaparticlesfoam_tpu_torch import StepConfig, build_grid_locator, convert, locate_seeds
from cudaparticlesfoam_tpu_torch import mesh as tmesh
from cudaparticlesfoam_tpu_torch import run_cycles
from cudaparticlesfoam_tpu_torch.ops import fused, fused_cuda

from torch_port_common import CPU   # also caps torch at one thread

PK = fused.LAYOUT_PK
VV = "VertexVelocity"


def _payload(nside, dtype):
    """Box payload with its native radial vertex velocity and the +x faces
    tagged as patch 1."""
    pts, tets, vv = tmesh.box_points_tets(nside, nside, nside)
    payload = tmesh.from_arrays_host(pts, tets, tet_vel=vv[tets].mean(axis=1),
                                     vert_vel=vv, dtype=dtype)
    ctr = payload["points"][payload["bd_tris"]].mean(axis=1)
    payload["bd_patch"] = (ctr[:, 0] > nside - 1e-6).astype(np.int32)
    return payload


def _both(payload):
    return jmesh.host_to_device(dict(payload)), convert.to_mesh(payload, device=CPU)


def _same_table(jm, tm):
    want = np.asarray(jm.tet_row_pk)
    got = tm.tet_row_pk.numpy()
    assert got.shape == want.shape == (tm.n_tets, 29) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tm.host["tet_row_pk"], want)


def test_layout_matches_jax():
    for f in ("row_w", "width", "vel", "nbr"):
        assert getattr(PK, f) == getattr(jfused.LAYOUT_PK, f), f
        assert getattr(fused.LAYOUT_TET, f) == getattr(jfused.LAYOUT_TET, f), f
    assert PK.esc == 28 and fused.LAYOUT_TET.esc == 19
    # the table the cycle reads is padded to whole 16 B chunks, and fills the mega row
    assert PK.tab_w == 32 and fused.ROW + PK.tab_w == PK.width
    assert fused.LAYOUT_TET.tab_w == 20
    assert fused.layout_for(StepConfig(velocity_interp=VV)) is PK
    assert fused.layout_for(StepConfig()) is fused.LAYOUT_TET


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_with_pk_rows_matches_jax(dtype):
    jm, tm = _both(_payload(4, dtype))
    assert tm.tet_row_pk is None
    jm, tm = jmesh.with_pk_rows(jm), tmesh.with_pk_rows(tm)
    _same_table(jm, tm)
    assert tmesh.with_pk_rows(tm) is tm
    # the mesh stores it once, padded to 32 columns with zeros: row_table hands
    # that tensor out, tet_row_pk is a view of it, and tet_row stays as it is
    tab = fused.row_table(tm, PK)
    assert tab is tm.tet_row_pk32 and fused.row_table(tm, PK) is tab
    assert tuple(tab.shape) == (tm.n_tets, 32) and tab.is_contiguous()
    assert tm.tet_row_pk.data_ptr() == tab.data_ptr() and tm.tet_row_pk.stride() == (32, 1)
    assert torch.equal(tab[:, :29], tm.tet_row_pk) and not bool(tab[:, 29:].any())
    assert tmesh.PK_TAB_W == PK.tab_w and tm.host["tet_row_pk"].shape == (tm.n_tets, 29)
    assert fused.row_table(tm, fused.LAYOUT_TET) is tm.tet_row


@pytest.mark.parametrize("order", ["rows_first", "escape_first"])
def test_pk_escape_mask_baked_both_orders(order):
    """set_boundary_escape writes the same 4-bit mask into tet_row col 19 and
    tet_row_pk col 28 whichever ran first, equal to the JAX tables."""
    jm, tm = _both(_payload(3, np.float32))
    if order == "rows_first":
        jm = jmesh.set_boundary_escape(jmesh.with_pk_rows(jm), [1])
        tm = tmesh.set_boundary_escape(tmesh.with_pk_rows(tm), [1])
    else:
        jm = jmesh.with_pk_rows(jmesh.set_boundary_escape(jm, [1]))
        tm = tmesh.with_pk_rows(tmesh.set_boundary_escape(tm, [1]))
    _same_table(jm, tm)
    mask = tm.tet_row_pk[:, 28]
    assert torch.equal(mask, tm.tet_row[:, 19]) and float(mask.max()) > 0
    # clearing the patches clears both columns
    tm0 = tmesh.set_boundary_escape(tm, [])
    assert not bool(tm0.tet_row_pk[:, 28].any()) and not bool(tm0.tet_row[:, 19].any())


def test_pk_update_velocity_refreshes_rows():
    jm, tm = _both(_payload(3, np.float64))
    jm, tm = jmesh.with_pk_rows(jm), tmesh.with_pk_rows(tm)
    vv = tm.host["vert_vel"] * 2.0 + 0.25
    jm2, tm2 = jmesh.replace_velocity(jm, vert_vel=vv), tmesh.replace_velocity(tm, vert_vel=vv)
    _same_table(jm2, tm2)
    tets = tm.host["tets"]
    np.testing.assert_array_equal(tm2.tet_row_pk.numpy()[:, 12:24],
                                  vv[tets].reshape(len(tets), 12))
    np.testing.assert_array_equal(tm2.vert_vel.numpy(), vv)
    # the other columns, and a mesh without the table, are left alone
    np.testing.assert_array_equal(tm2.tet_row_pk.numpy()[:, :12], tm.tet_row_pk.numpy()[:, :12])
    np.testing.assert_array_equal(tm2.tet_row_pk.numpy()[:, 24:], tm.tet_row_pk.numpy()[:, 24:])
    assert tmesh.replace_velocity(convert.to_mesh(_payload(3, np.float64), device=CPU),
                                  vert_vel=vv).tet_row_pk is None
    # a tet velocity update does not touch it
    assert torch.equal(tmesh.replace_velocity(tm, tet_vel=tm.host["tet_vel"] * 3).tet_row_pk,
                       tm.tet_row_pk)


def test_pk_rows_ride_the_payload_both_ways():
    jm, tm = _both(_payload(3, np.float32))
    jm, tm = jmesh.with_pk_rows(jm), tmesh.with_pk_rows(tm)
    from_jax = convert.to_mesh(convert.mesh_payload(jm), device=CPU)
    _same_table(jm, from_jax)
    to_jax = jmesh.host_to_device(convert.mesh_payload(tm))
    np.testing.assert_array_equal(np.asarray(to_jax.tet_row_pk), tm.tet_row_pk.numpy())
    bad = dict(convert.mesh_payload(tm), tet_row_pk=np.zeros((tm.n_tets, 32), np.float32))
    with pytest.raises(ValueError, match=r"tet_row_pk must be \[nt, 29\]"):
        convert.to_mesh(bad, device=CPU)


def test_pk_rows_guard_float32_codes():
    tm = convert.to_mesh(_payload(2, np.float32), device=CPU)
    with pytest.raises(ValueError, match=r"2\^24"):
        tmesh.with_pk_rows(dataclasses.replace(tm, n_tets=1 << 24))


def _seeds(tm, n, nside, seed, lo=0.5):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(lo, nside - lo, (n, 3))
    st = convert.to_state(pos, np.zeros(n, np.int32), dtype=tm.dtype, device=CPU)
    return dataclasses.replace(st, tet_id=locate_seeds(tm, build_grid_locator(tm), st.pos))


def _x64_off(fn, *args):
    """The Pallas kernels are float32-only; the harness enables x64 globally."""
    if not jax.config.read("jax_enable_x64"):
        return fn(*args)
    jax.config.update("jax_enable_x64", False)
    try:
        return fn(*args)
    finally:
        jax.config.update("jax_enable_x64", True)


def _pallas_cycles(jm, m0, seed, step0, n_cycles, dt, kw):
    from jax.experimental.pallas import tpu as pltpu

    cfg = JStepConfig(engine_impl="pallas_packed", walk_capacity_frac=0.25, **kw)
    m_rm = jnp.asarray(m0.numpy()).reshape(-1, 4 * PK.width)
    with pltpu.force_tpu_interpret_mode():
        for j in range(n_cycles):
            m_rm = jfused.mega_cycle_packed(jm, m_rm, jax.random.PRNGKey(seed), step0 + j, cfg,
                                            jnp.float32(dt))
    return np.asarray(m_rm).reshape(-1, PK.width)


def _port_cycles(tm, m0, seed, step0, n_cycles, dt, kw):
    cfg = StepConfig(**kw)
    m = m0.clone()
    for j in range(n_cycles):
        fused.mega_cycle(tm, m, seed, step0 + j, cfg, dt)
    return m.numpy()


def _close_f32(a, b):
    """pos/vel of the port and of the Pallas cycle after several float32
    cycles: 2e-6 as the JAX package's own interpret-mode tests state, plus 4
    float32 ulps of the value: the two packages draw the "rbg" normals
    from the same bits but through their own float32 log and cos (within 4
    ulps, ``test_torch_noise``), Mosaic may contract mul+add into FMA, and
    a coordinate near 8 has an ulp of 4.8e-7 that each cycle can add."""
    np.testing.assert_allclose(a, b, atol=2e-6, rtol=4 * 2.0 ** -23)


def _packed_logic(hops):
    n, nside, dt = fused_pallas.PACK_LANES, 8, 0.4
    jm, tm = _both(_payload(nside, np.float32))
    jm, tm = jmesh.with_pk_rows(jm), tmesh.with_pk_rows(tm)
    st = _seeds(tm, n, nside, seed=17)
    m0 = fused.pack_state(tm, st.pos, st.vel, st.tet_id, st.active, PK)
    np.testing.assert_array_equal(
        m0.numpy(), np.asarray(jfused.pack_state(
            jm, jnp.asarray(st.pos.numpy()), jnp.zeros((n, 3), jnp.float32),
            jnp.asarray(st.tet_id.numpy()), jnp.asarray(st.active.numpy()), jfused.LAYOUT_PK)))
    kw = dict(dt=dt, diffusion_coeff=2e-3, inline_hops=hops, brownian_rng="rbg",
              velocity_interp=VV)
    a = _port_cycles(tm, m0, 7, 5, 4, dt, kw)
    b = _pallas_cycles(jm, m0, 7, 5, 4, dt, kw)
    assert (st.pos.numpy() != a[:, :3]).any() and (a[:, 6] != m0.numpy()[:, 6]).any()
    np.testing.assert_array_equal(a[:, 6], b[:, 6])   # tet ids
    np.testing.assert_array_equal(a[:, 7], b[:, 7])   # active
    _close_f32(a[:, :6], b[:, :6])
    # the row cache follows the tet, pad columns stay zero
    np.testing.assert_array_equal(a[:, 8:37], tm.tet_row_pk.numpy()[a[:, 6].astype(np.int64)])
    assert not a[:, 37:].any()


@pytest.mark.parametrize("hops", [1, 3])
def test_pk_packed_logic_matches_pallas_interpret(hops):
    """stream_plain + rare_plain under LAYOUT_PK against the Pallas packed
    cycle in VertexVelocity mode (interpret mode, float32, the shared "rbg"
    stream, 4 cycles of 8192 lanes on box 8^3): tet/active exact, pos/vel
    within :func:`_close_f32`."""
    _x64_off(_packed_logic, hops)


def _escape_logic():
    n, nside, dt = fused_pallas.PACK_LANES, 8, 0.35
    jm, tm = _both(_payload(nside, np.float32))
    jm = jmesh.with_pk_rows(jmesh.set_boundary_escape(jm, [1]))
    tm = tmesh.with_pk_rows(tmesh.set_boundary_escape(tm, [1]))
    st = _seeds(tm, n, nside, seed=47)
    m0 = fused.pack_state(tm, st.pos, st.vel, st.tet_id, st.active, PK)
    kw = dict(dt=dt, diffusion_coeff=2e-3, inline_hops=1, brownian_rng="rbg",
              velocity_interp=VV, escape_faces=True)
    a = _port_cycles(tm, m0, 9, 3, 6, dt, kw)
    b = _pallas_cycles(jm, m0, 9, 3, 6, dt, kw)
    assert (a[:, 7] < 0.5).sum() > 0        # some lanes escaped through +x
    np.testing.assert_array_equal(a[:, 6], b[:, 6])
    np.testing.assert_array_equal(a[:, 7], b[:, 7])
    live = a[:, 7] > 0.5
    _close_f32(a[live][:, :6], b[live][:, :6])
    # only +x faces absorb
    gone = a[:, 7] < 0.5
    assert (a[gone, 0] > nside - 1.0).all() and (a[gone, 6] < 0).all()


def test_pk_escape_logic_matches_pallas_interpret():
    """The same with escape faces (the mask in Pk row col 28), 6 cycles."""
    _x64_off(_escape_logic)


F64_CASES = [
    dict(inline_hops=1),
    dict(inline_hops=3),
    dict(inline_hops=1, escape_faces=True),
    dict(inline_hops=4, escape_faces=True, inline_bounce=False),
    dict(inline_hops=2, reflect_wall=False),
    dict(inline_hops=0),
    dict(inline_hops=2, use_advection=False, diffusion_coeff=0.05),
]


@pytest.mark.parametrize("case", range(len(F64_CASES)))
def test_run_cycles_matches_jax_f64(case):
    """run_cycles under VertexVelocity against the JAX cached engine
    (jnp, float64) over 20 cycles on one injected noise stream:
    tet/active exact, pos/vel within 1e-12."""
    nside, n, dt, n_cycles = 6, 2048, 0.3, 20
    kw = dict(dict(dt=dt, diffusion_coeff=5e-3, velocity_interp=VV), **F64_CASES[case])
    jm, tm = _both(_payload(nside, np.float64))
    if kw.get("escape_faces"):
        jm, tm = jmesh.set_boundary_escape(jm, [1]), tmesh.set_boundary_escape(tm, [1])
    jm, tm = jmesh.with_pk_rows(jm), tmesh.with_pk_rows(tm)
    st = _seeds(tm, n, nside, seed=20 + case)
    noise = np.random.default_rng(30 + case).standard_normal((n_cycles, n, 3))
    fin = run_cycles(tm, st, StepConfig(**kw), n_cycles, noise=torch.as_tensor(noise))
    assert fin.step == n_cycles

    jcfg = JStepConfig(engine_impl="jnp", **kw)
    m = jfused.pack_state(jm, jnp.asarray(st.pos.numpy()), jnp.zeros((n, 3)),
                          jnp.asarray(st.tet_id.numpy()), jnp.asarray(st.active.numpy()),
                          jfused.LAYOUT_PK)
    step = jax.jit(lambda mm, xi, i: jfused._mega_cycle_aligned(
        jm, mm, jax.random.PRNGKey(0), i, jcfg, jnp.float64(dt), noise=xi))
    for i in range(n_cycles):
        m = step(m, jnp.asarray(noise[i]), i)
    pos, vel, tet, act = (np.asarray(x) for x in jfused.unpack_state(m))
    np.testing.assert_array_equal(fin.tet_id.numpy(), tet)
    np.testing.assert_array_equal(fin.active.numpy(), act)
    np.testing.assert_allclose(fin.pos.numpy(), pos, atol=1e-12, rtol=0)
    np.testing.assert_allclose(fin.vel.numpy(), vel, atol=1e-12, rtol=0)
    assert (tet != st.tet_id.numpy()).any()
    if kw.get("escape_faces"):
        assert (~act).any()


@pytest.mark.parametrize("kw", [
    dict(hop_compact=4), dict(macro_cycles=4), dict(hop_compact=4, macro_cycles=3),
    dict(macro_cycles=4, brownian_rng="rbg_kernel", escape_faces=True),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_pk_ignores_compaction_and_macro_cycles(kw, monkeypatch):
    """As in the JAX package (``_b_compute_c`` takes no layout,
    ``macro_supported`` is TetVelocity only), VertexVelocity runs cycle by
    cycle whatever hop_compact and macro_cycles say: the state equals the
    plain run's and no compacted or macro stage is called."""
    def refuse(*a, **k):
        raise AssertionError("a TetVelocity-only stage ran under VertexVelocity")

    for name in ("stream_crossers", "hop_admit", "macro_stream", "macro_crossers"):
        monkeypatch.setattr(fused_cuda, name, refuse)
    tm = tmesh.with_pk_rows(convert.to_mesh(_payload(4, np.float32), device=CPU))
    st = _seeds(tm, 512, 4, seed=3)
    cfg = StepConfig(dt=0.2, diffusion_coeff=2e-3, velocity_interp=VV, **kw)
    base = dataclasses.replace(cfg, hop_compact=0, macro_cycles=1)
    out, want = run_cycles(tm, st, cfg, 9), run_cycles(tm, st, base, 9)
    for f in ("pos", "vel", "tet_id", "active"):
        assert torch.equal(getattr(out, f), getattr(want, f)), f
    # JAX's own envelope refuses macro fusion under VertexVelocity
    jm = jmesh.with_pk_rows(jmesh.box_mesh(2, 2, 2))
    assert not fused_pallas.macro_supported(jm, JStepConfig(velocity_interp=VV), 4)


def test_pk_wrappers_check_layout_and_shapes():
    tm = tmesh.with_pk_rows(convert.to_mesh(_payload(2, np.float32), device=CPU))
    tab = fused.row_table(tm, PK)
    m = torch.zeros((8, 40))
    pend = torch.zeros(8, dtype=torch.uint8)
    kw = dict(dt=0.1, sigma=0.1, use_adv=True, use_brown=False, bounce_on=True, esc_on=False,
              n_hops=1)
    with pytest.raises(ValueError):        # the Tet table under the Pk layout
        fused_cuda.stream_cycle(tm.tet_row, m, None, pend, ly=PK, **kw)
    with pytest.raises(ValueError):        # the unpadded table
        fused_cuda.stream_cycle(tm.tet_row_pk, m, None, pend, ly=PK, **kw)
    with pytest.raises(ValueError):        # a Tet mega
        fused_cuda.stream_cycle(tab, torch.zeros((8, 32)), None, pend, ly=PK, **kw)
    with pytest.raises(ValueError, match="TetVelocity only"):
        fused_cuda.stream_cycle(tab, m, None, pend, admit=pend, ly=PK, **kw)
    with pytest.raises(ValueError):
        fused_cuda.rare_resolve(tm.tet_row, m, pend, tm.bd_escape, max_hops=50, max_bounces=10,
                                reflect_wall=True, ly=PK)
    with pytest.raises(ValueError, match="with_pk_rows"):
        fused.row_table(convert.to_mesh(_payload(2, np.float32), device=CPU), PK)
    before = (fused_cuda.stream_cycle.launches, fused_cuda.rare_resolve.launches)
    fused_cuda.stream_cycle(tab, m, None, pend, ly=PK, **kw)
    fused_cuda.rare_resolve(tab, m, pend, tm.bd_escape, max_hops=50, max_bounces=10,
                            reflect_wall=True, ly=PK)
    assert before == (fused_cuda.stream_cycle.launches,
                      fused_cuda.rare_resolve.launches)     # CPU: plain, no launch
