"""PyTorch port: the StepConfig surface, the settings that were not ported
until the cached engine took them (each runs and equals its counterpart),
the settings that run on the simple engine, suggest_tuning against the JAX
package, and the kernel build's error when there is no CUDA toolkit."""

import dataclasses

import numpy as np
import pytest
import torch

import cudaparticlesfoam_tpu as jcpf
import cudaparticlesfoam_tpu.mesh as jmesh
import cudaparticlesfoam_tpu.stepper as jstepper
import cudaparticlesfoam_tpu_torch as cpt
from cudaparticlesfoam_tpu_torch import convert
from cudaparticlesfoam_tpu_torch import mesh as tmesh
from cudaparticlesfoam_tpu_torch.ops import _build, fused_cuda

from torch_port_common import CPU   # also caps torch at one thread


def test_step_config_fields_and_defaults_match_jax():
    got = {f.name: f.default for f in dataclasses.fields(cpt.StepConfig)}
    want = {f.name: f.default for f in dataclasses.fields(jcpf.StepConfig)}
    assert got == want


@pytest.mark.parametrize("kw", [
    dict(hop_compact=2), dict(hop_compact=8), dict(macro_cycles=0), dict(macro_cycles=9),
])
def test_validation_mirrors_jax(kw):
    with pytest.raises(ValueError) as want:
        jcpf.StepConfig(**kw)
    with pytest.raises(ValueError) as got:
        cpt.StepConfig(**kw)
    assert str(got.value) == str(want.value)


# (setting, its counterpart): the settings that raised NotImplementedError
# until the port had them; RK4 on the cached engine against the simple
# engine's RK4, the knobs against the default run
UNPORTED = [
    (dict(integrator="rk4"), dict(integrator="rk4", engine="simple")),
    (dict(integrator="rk4", engine="cached", velocity_interp="VertexVelocity"),
     dict(integrator="rk4", engine="simple", velocity_interp="VertexVelocity")),
    (dict(cycle_chunks=2), dict()),
    (dict(engine_impl="jnp"), dict()),
]

# settings that go to the simple engine (stepper.cycle), by request or
# because the cached engine does not cover them or the mesh lacks its tables
SIMPLE = [
    dict(engine="simple"),
    dict(engine="simple", integrator="rk4"),
    dict(engine="simple", locate_mode="convex"),
    dict(locate_mode="convex"),                          # no with_convex_rows
    dict(locate_mode="convex", integrator="rk4"),
    dict(locate_mode="convex", velocity_interp="VertexVelocity"),
    dict(velocity_interp="VertexVelocity"),              # no with_pk_rows
    dict(velocity_interp="ConstantVelocity"),
    dict(velocity_interp="ConstantVelocity", integrator="rk4"),
]


def _ids(cases):
    return ["-".join(f"{k}={v}" for k, v in kw.items()) for kw in cases]


@pytest.fixture(scope="module")
def tiny():
    mesh = cpt.box_mesh(2, 2, 2, device=CPU)
    st = convert.to_state(np.full((8, 3), 1.0), np.zeros(8, np.int32), device=CPU)
    st = dataclasses.replace(st, tet_id=cpt.locate_seeds(
        mesh, cpt.build_grid_locator(mesh), st.pos))
    return mesh, st


@pytest.mark.parametrize("kw,counterpart", UNPORTED, ids=_ids([kw for kw, _ in UNPORTED]))
def test_unported_settings_raise(tiny, kw, counterpart):
    """The settings that raised NotImplementedError until the port had them
    (the test keeps the name it had then) run now, check_ported refuses
    none of them, and each equals its counterpart: cached RK4 the simple
    engine's RK4 (to float32 rounding); cycle_chunks and engine_impl, which
    select nothing in the port, the default run bit for bit, under the
    barycentric and the convex locator."""
    mesh, st = tiny
    mesh = cpt.with_pk_rows(cpt.with_convex_rows(mesh))
    cfg = cpt.StepConfig(dt=0.05, diffusion_coeff=1e-3, **kw)
    cpt.stepper.check_ported(cfg)
    assert cfg.resolved_engine() == "cached"
    out = cpt.run_cycles(mesh, st, cfg, 3)
    want = cpt.run_cycles(mesh, st, cpt.StepConfig(dt=0.05, diffusion_coeff=1e-3,
                                                   **counterpart), 3)
    assert int(out.active.sum()) == 8 and out.step == 3
    assert torch.equal(out.tet_id, want.tet_id) and torch.equal(out.active, want.active)
    if "integrator" in kw:
        np.testing.assert_allclose(out.pos.numpy(), want.pos.numpy(), atol=1e-6, rtol=0)
        return
    for f in ("pos", "vel"):
        assert torch.equal(getattr(out, f), getattr(want, f)), f
    convex = cpt.StepConfig(dt=0.05, diffusion_coeff=1e-3, locate_mode="convex")
    out = cpt.run_cycles(mesh, st, dataclasses.replace(convex, **kw), 3)
    want = cpt.run_cycles(mesh, st, convex, 3)
    for f in ("pos", "vel", "tet_id", "active"):
        assert torch.equal(getattr(out, f), getattr(want, f)), f


@pytest.mark.parametrize("kw", SIMPLE, ids=_ids(SIMPLE))
def test_simple_engine_settings_run(tiny, kw, monkeypatch):
    """Each of these runs through ``stepper.cycle`` and never through the
    cached engine's wrappers."""
    mesh, st = tiny

    def refuse(*a, **k):
        raise AssertionError("the cached engine ran")

    for name in ("stream_cycle", "rare_resolve", "convex_stream_cycle", "convex_rare_resolve"):
        monkeypatch.setattr(fused_cuda, name, refuse)
    cfg = cpt.StepConfig(dt=0.01, **kw)
    assert cfg.resolved_engine() == jcpf.StepConfig(dt=0.01, **kw).resolved_engine()
    out = cpt.run_cycles(mesh, st, cfg, 2)
    assert int(out.active.sum()) == 8 and out.step == 2
    assert bool(torch.isfinite(out.pos).all()) and not torch.equal(out.pos, st.pos)


@pytest.mark.parametrize("kw", [
    dict(), dict(integrator="rk4"), dict(velocity_interp="VertexVelocity"),
    dict(velocity_interp="VertexVelocity", integrator="rk4"),
    dict(velocity_interp="ConstantVelocity"), dict(locate_mode="convex"),
    dict(locate_mode="convex", velocity_interp="VertexVelocity"),
    dict(locate_mode="convex", integrator="rk4"), dict(engine="simple"),
    dict(engine="cached", integrator="rk4"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "default")
def test_resolved_engine_matches_jax(kw):
    assert cpt.StepConfig(**kw).resolved_engine() == jcpf.StepConfig(**kw).resolved_engine()


def test_ported_settings_run(tiny):
    mesh, st = tiny
    mesh_cx = cpt.with_convex_rows(mesh)
    for kw in (dict(), dict(engine="cached"), dict(inline_hops=8, escape_faces=True),
               dict(walk_capacity_frac=0.5, arena_lane_frac=0.1, inline_bounce=False),
               dict(brownian_rng="rbg"), dict(brownian_rng="rbg_kernel"),
               dict(locate_mode="convex"), dict(locate_mode="convex", engine="cached",
                                                brownian_rng="rbg_kernel", inline_hops=0),
               dict(locate_mode="convex", escape_faces=True, convex_bary_fix=False)):
        out = cpt.run_cycles(mesh_cx, st, cpt.StepConfig(dt=0.01, **kw), 2)
        assert int(out.active.sum()) == 8 and out.step == 2
    for kw in (dict(velocity_interp="VertexVelocity"),
               dict(velocity_interp="VertexVelocity", inline_hops=3, escape_faces=True,
                    brownian_rng="rbg_kernel")):
        out = cpt.run_cycles(cpt.with_pk_rows(mesh), st, cpt.StepConfig(dt=0.01, **kw), 2)
        assert int(out.active.sum()) == 8 and out.step == 2
    for kw in (dict(inline_hops=9), dict(locate_mode="convex", inline_hops=9),
               dict(locate_mode="walk"), dict(brownian_rng="philox"), dict(engine="fast"),
               dict(integrator="rk2"), dict(velocity_interp="FaceVelocity")):
        with pytest.raises(ValueError):
            cpt.run_cycles(mesh_cx, st, cpt.StepConfig(**kw), 1)


@pytest.mark.parametrize("kw", [
    dict(hop_compact=4), dict(macro_cycles=2), dict(macro_cycles=8, hop_compact=4),
    dict(hop_compact=4, hop_compact_frac=0.02, escape_faces=True, brownian_rng="rbg_kernel"),
    dict(macro_cycles=3, inline_hops=4, brownian_rng="rbg"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_compaction_and_macro_settings_run(tiny, kw):
    """hop_compact=4 (K3) and macro_cycles 2..8 (K4) run, and their final
    state equals the plain per-cycle run's on this tiny case."""
    mesh, st = tiny
    cfg = cpt.StepConfig(dt=0.05, diffusion_coeff=1e-3, **kw)
    base = dataclasses.replace(cfg, hop_compact=0, macro_cycles=1)
    out, want = cpt.run_cycles(mesh, st, cfg, 9), cpt.run_cycles(mesh, st, base, 9)
    assert out.step == 9 and int(out.active.sum()) == 8
    for f in ("pos", "vel", "tet_id", "active"):
        assert torch.equal(getattr(out, f), getattr(want, f)), f


@pytest.mark.parametrize("k", [2, 8])
def test_convex_ignores_macro_cycles(tiny, k):
    """The convex engine never reads macro_cycles (nor does JAX's convex
    branch): the run equals macro_cycles=1 cycle for cycle."""
    mesh, st = tiny
    mesh = cpt.with_convex_rows(mesh)
    cfg = cpt.StepConfig(dt=0.05, diffusion_coeff=1e-3, locate_mode="convex")
    out = cpt.run_cycles(mesh, st, dataclasses.replace(cfg, macro_cycles=k), 5)
    want = cpt.run_cycles(mesh, st, cfg, 5)
    for f in ("pos", "vel", "tet_id", "active"):
        assert torch.equal(getattr(out, f), getattr(want, f)), f


def _box_payload(nside, speed):
    pts, tets, vv = tmesh.box_points_tets(nside, nside, nside)
    return tmesh.from_arrays_host(pts, tets, tet_vel=speed * vv[tets].mean(axis=1),
                                  vert_vel=vv, dtype=np.float64)


@pytest.mark.parametrize("nside,speed,dt,kw", [
    (4, 1.0, 0.05, dict(diffusion_coeff=1e-3)),
    (6, 1.0, 0.8, dict(use_brownian=False)),
    (8, 3.0, 1.0, dict(diffusion_coeff=1e-2, reflect_wall=False)),
])
def test_suggest_tuning_matches_jax(nside, speed, dt, kw):
    payload = _box_payload(nside, speed)
    cfg_j = jstepper.suggest_tuning(jmesh.host_to_device(dict(payload)),
                                    jcpf.StepConfig(dt=dt, **kw), dt)
    cfg_t = cpt.suggest_tuning(convert.to_mesh(payload, device=CPU), cpt.StepConfig(dt=dt, **kw),
                               dt)
    for k in ("inline_hops", "walk_capacity_frac", "inline_bounce"):
        assert getattr(cfg_t, k) == getattr(cfg_j, k), k
    # TPU-measured knobs are not carried over
    assert cfg_t.cycle_chunks == 1 and cfg_t.hop_compact == 0


def test_suggest_tuning_covers_the_hop_regimes():
    hops = {cpt.suggest_tuning(convert.to_mesh(_box_payload(4, 1.0), device=CPU),
                               cpt.StepConfig(dt=dt, use_brownian=False)).inline_hops
            for dt in (0.05, 0.3, 0.6, 3.0)}
    assert hops == {1, 2, 4, 8}


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_kernel_sources_are_found():
    names = sorted(p.rsplit("/", 1)[-1] for p in _build.sources())
    assert names == ["amg.cu", "convex_rare.cu", "convex_stream.cu", "hop_admit.cu", "macro.cu",
                     "probe.cu", "rare.cu", "stream.cu"]
    assert "--fmad=false" in _build.FLAGS and "code=sm_90a" in _build.ARCH


def test_wrappers_refuse_other_devices():
    m = torch.empty((8, 32), device="meta")
    tab = torch.empty((4, 20), device="meta")
    pend = torch.empty(8, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_cuda.stream_cycle(tab, m, None, pend, dt=0.1, sigma=0.0, use_adv=True,
                                use_brown=False, bounce_on=True, esc_on=False, n_hops=1)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_cuda.rare_resolve(tab, m, pend, torch.empty(0, dtype=torch.bool, device="meta"),
                                max_hops=50, max_bounces=10, reflect_wall=True)
    cx = torch.empty((4, 24), device="meta")
    disp = torch.empty((8, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_cuda.convex_stream_cycle(cx, m, None, pend, disp, dt=0.1, sigma=0.0,
                                       use_adv=True, use_brown=False, n_hops=1)
    kw = dict(dt=0.1, sigma=0.0, use_adv=True, use_brown=False)
    for call in (lambda: fused_cuda.stream_crossers(tab, m, None, pend, **kw),
                 lambda: fused_cuda.convex_stream_crossers(cx, m, None, pend, **kw),
                 lambda: fused_cuda.macro_crossers(tab, m, None, pend, pend, k=2, **kw),
                 lambda: fused_cuda.macro_stream(tab, m, None, pend, pend, k=2, bounce_on=True,
                                                 esc_on=False, **kw),
                 lambda: fused_cuda.hop_admit(pend, pend, capb=1024)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()

