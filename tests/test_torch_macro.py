"""PyTorch port, macro-cycle fusion (``macro_cycles`` = k, K4): ``mega_macro``
with the plain versions of ``macro_stream_kernel`` and the compacted trips
against the JAX package's ``macro_cycle_packed`` in Pallas interpret mode,
against k of the port's own per-cycle steps, and ``run_cycles`` against the
JAX cached engine.  Inputs are built once with numpy from a seed and
uploaded to both packages; the noise is injected where the two packages
would draw different streams.

Tolerances: float32 against the Pallas kernels gives exact tet/active and
pos/vel within 2e-6 (Mosaic may contract mul+add into FMA, the plain
version does not); the port's macro cycle against its per-cycle steps is
exact in float32 and float64 (the same expressions in the same order);
float64 against the JAX jnp engine gives exact tet/active and 1e-12."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudaparticlesfoam_tpu as jcpf
import cudaparticlesfoam_tpu.mesh as jmesh
from cudaparticlesfoam_tpu import StepConfig as JStepConfig
from cudaparticlesfoam_tpu.ops import fused as jfused
from cudaparticlesfoam_tpu.ops import fused_pallas
import cudaparticlesfoam_tpu_torch as cpt
from cudaparticlesfoam_tpu_torch import convert
from cudaparticlesfoam_tpu_torch import mesh as tmesh
from cudaparticlesfoam_tpu_torch.ops import fused, fused_cuda
from tests.test_torch_compact import N, NSIDE, _payload, _x32

from torch_port_common import CPU   # also caps torch at one thread


def _state(tm, n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.05, NSIDE - 0.05, (n, 3))
    tet = cpt.locate_seeds(tm, cpt.build_grid_locator(tm), torch.as_tensor(pos, dtype=tm.dtype))
    return convert.to_state(pos, tet.numpy(), vel=rng.normal(size=(n, 3)),
                            active=rng.uniform(size=n) > 0.05, seed=3, step=5, dtype=tm.dtype,
                            device=CPU)


@pytest.mark.parametrize("k", [2, 4])
def test_macro_matches_pallas_macro_cycle_interpret(k):
    """Box 8^3, 8192 lanes, float32, injected [k, n, 3] noise: ``mega_macro``
    against ``fused_pallas.macro_cycle_packed`` driven with the same noise
    as [3k, n] planes and a ``_rare_stage_packed`` closure, as
    ``fused.mega_macro_packed`` builds it.  Trip 0 hops every crosser; the
    later trips run the compacted gather at frac 0.5, 0.25, 0.125 of the
    2048 groups (capacity 1024 each)."""
    tm = convert.to_mesh(_payload(np.float32, seed=1), device=CPU)
    jm = jmesh.host_to_device(_payload(np.float32, seed=1))
    st = _state(tm, N, seed=2 + k)
    m0 = fused.pack_state(fused.row_table(tm), st.pos, st.vel, st.tet_id, st.active)
    xi = torch.as_tensor(np.random.default_rng(k).standard_normal((k, N, 3)),
                         dtype=torch.float32)
    kw = dict(dt=0.25, diffusion_coeff=5e-3, macro_cycles=k, walk_capacity_frac=0.25)
    m = fused.mega_macro(tm, m0.clone(), st.seed, st.step, cpt.StepConfig(**kw), kw["dt"],
                         noise=xi)

    def jax_macro():
        from jax.experimental.pallas import tpu as pltpu

        def rare(mc, pend, cfg_t):
            return jfused._rare_stage_packed(jm, jm.tet_row, mc, pend, cfg_t, jfused.LAYOUT_TET,
                                             N, N // jfused.BLOCK, 32)

        planes = jnp.asarray(xi.numpy().transpose(0, 2, 1).reshape(3 * k, N))
        with pltpu.force_tpu_interpret_mode():
            out = fused_pallas.macro_cycle_packed(
                jm, jm.tet_row, jnp.asarray(m0.numpy()).reshape(-1, 128),
                jax.random.PRNGKey(0), st.step, JStepConfig(**kw), jnp.float32(kw["dt"]), k,
                rare, noise=planes)
        return np.asarray(out).reshape(N, 32)

    mj = _x32(jax_macro)
    got = m.numpy()
    np.testing.assert_array_equal(got[:, 6], mj[:, 6])
    np.testing.assert_array_equal(got[:, 7], mj[:, 7])
    np.testing.assert_allclose(got[:, :6], mj[:, :6], atol=2e-6, rtol=0)
    assert (got[:, 6] != m0.numpy()[:, 6]).mean() > 0.5


SELF_CASES = [
    dict(k=2),
    dict(k=4, escape_faces=True),
    dict(k=4, escape_faces=True, brownian_rng="rbg_kernel"),
    dict(k=3, hop_compact_frac=0.02, inline_bounce=False, brownian_rng="rbg"),
    dict(k=8, use_advection=False, diffusion_coeff=0.05),
    dict(k=4, reflect_wall=False, use_brownian=False),
]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", range(len(SELF_CASES)))
def test_macro_equals_per_cycle_steps(dtype, case):
    """One macro cycle of k sub-steps against k ``mega_cycle`` calls on the
    same state and noise (threefry, or the Philox stream drawn from the
    seed): bit for bit, the row cache included for live lanes."""
    kw = dict(SELF_CASES[case])
    k = kw.pop("k")
    kw = dict(dict(dt=0.3, diffusion_coeff=5e-3), **kw)
    tm = convert.to_mesh(_payload(dtype, seed=case), device=CPU)
    tm = tmesh.set_boundary_escape(tm, [1] if kw.get("escape_faces") else [])
    st = _state(tm, 4096, seed=20 + case)
    cfg = cpt.StepConfig(macro_cycles=k, **kw)
    m0 = fused.pack_state(fused.row_table(tm), st.pos, st.vel, st.tet_id, st.active)
    ref = m0.clone()
    for j in range(k):
        fused.mega_cycle(tm, ref, st.seed, st.step + j, cfg, cfg.dt)
    got = fused.mega_macro(tm, m0.clone(), st.seed, st.step, cfg, cfg.dt)
    live = ref[:, 6] >= 0
    assert torch.equal(got[:, :8], ref[:, :8])
    assert torch.equal(got[live], ref[live])
    assert (ref[:, 6] != m0[:, 6]).float().mean() > 0.3
    if kw.get("escape_faces"):
        assert (ref[:, 6] < 0).any()


def test_macro_trip_phases_and_launch_counts():
    """The phase bookkeeping of one macro cycle: after trip 0 every lane
    has stopped at a crossing or finished (phase k), later trips move only
    the stopped ones, and after k trips every lane is at phase k with
    nothing pending.  The CPU runs the plain versions (no launches)."""
    tm = convert.to_mesh(_payload(np.float32), device=CPU)
    st = _state(tm, 2048, seed=9)
    m = fused.pack_state(fused.row_table(tm), st.pos, st.vel, st.tet_id, st.active)
    k = 4
    cfg = cpt.StepConfig(dt=0.3, diffusion_coeff=5e-3, macro_cycles=k)
    xi = torch.randn((k, 2048, 3), generator=torch.Generator().manual_seed(1))
    kw = dict(fused.stream_kwargs(cfg, cfg.dt, m.dtype), k=k, bounce_on=True, esc_on=False)
    phase = torch.zeros(2048, dtype=torch.uint8)
    pend = torch.empty_like(phase)
    before = fused_cuda.macro_stream.launches
    stopped = []
    for trip in range(k):
        fused_cuda.macro_stream(tm.tet_row, m, xi, phase, pend, **kw)
        fused_cuda.rare_resolve(tm.tet_row, m, pend, tm.bd_escape, max_hops=50, max_bounces=10,
                                reflect_wall=True)
        stopped.append(int((phase < k).sum()))
        assert int(phase.min()) >= trip + 1
    assert stopped[0] > stopped[1] > 0 and stopped[-1] == 0
    fused_cuda.macro_stream(tm.tet_row, m, xi, phase, pend, **kw)   # all at phase k
    assert int(pend.sum()) == 0
    assert fused_cuda.macro_stream.launches == before
    with pytest.raises(ValueError):
        fused_cuda.macro_stream(tm.tet_row, m, xi[:2], phase, pend, **kw)
    with pytest.raises(ValueError):
        fused_cuda.macro_stream(tm.tet_row, m, xi, phase, pend, **dict(kw, k=9))
    with pytest.raises(TypeError):
        fused_cuda.macro_stream(tm.tet_row, m, xi, phase.bool(), pend, **kw)


def test_run_cycles_macro_matches_jax_run_cycles():
    """20 cycles of ``run_cycles(macro_cycles=4, hop_compact=4)`` (five
    macro cycles with compacted trips; per-cycle compaction unused) and of
    ``macro_cycles=3`` (six macro cycles and two single cycles, compacted)
    on box 8^3, 1000 lanes, float64, against JAX ``run_cycles`` on the CPU
    (its per-cycle jnp engine, which ignores both knobs), with JAX's
    threefry noise injected: tet/active exact, pos/vel within 1e-12."""
    n, n_cycles = 1000, 20
    payload = _payload(np.float64, seed=7)
    jm, tm = jmesh.host_to_device(dict(payload)), convert.to_mesh(payload, device=CPU)
    rng = np.random.default_rng(4)
    pos = rng.uniform(0.1, NSIDE - 0.1, (n, 3))
    tet = cpt.locate_seeds(tm, cpt.build_grid_locator(tm), torch.as_tensor(pos)).numpy()
    kw = dict(dt=0.3, diffusion_coeff=2e-3)
    want = jcpf.run_cycles(jm, jcpf.make_state(pos, tet_id=tet, dtype=np.float64, rng_seed=5),
                           jcpf.StepConfig(engine="cached", **kw), n_cycles)
    key = jax.random.PRNGKey(5)
    noise = torch.stack([torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(key, step), (n, 3), dtype=np.float64))) for step in range(n_cycles)])
    st = convert.to_state(pos, tet, seed=5, dtype=np.float64, device=CPU)
    for extra in (dict(macro_cycles=4, hop_compact=4, hop_compact_frac=0.02),
                  dict(macro_cycles=3, hop_compact=4)):
        got = cpt.run_cycles(tm, st, cpt.StepConfig(**kw, **extra), n_cycles, noise=noise)
        np.testing.assert_array_equal(got.tet_id.numpy(), np.asarray(want.tet_id))
        np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
        np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos), atol=1e-12, rtol=0)
        np.testing.assert_allclose(got.vel.numpy(), np.asarray(want.vel), atol=1e-12, rtol=0)
        assert got.step == n_cycles
    assert (np.asarray(want.tet_id) != tet).mean() > 0.5


def test_run_cycles_macro_launches_and_convex_ignores_it():
    """The bary engine runs n_cycles // k macro cycles then the rest one at
    a time (the plain versions here; the counts are the CUDA launches, none
    on the CPU), and the convex engine ignores ``macro_cycles`` as JAX's
    convex branch never reads it: its result equals macro_cycles=1."""
    tm = cpt.with_convex_rows(convert.to_mesh(_payload(np.float64, seed=3), device=CPU))
    st = _state(tm, 512, seed=1)
    cfg = cpt.StepConfig(dt=0.2, diffusion_coeff=1e-3, brownian_rng="rbg")
    one = cpt.run_cycles(tm, st, cfg, 7)
    mac = cpt.run_cycles(tm, st, dataclasses.replace(cfg, macro_cycles=3), 7)
    assert torch.equal(one.pos, mac.pos) and torch.equal(one.tet_id, mac.tet_id)
    ccfg = dataclasses.replace(cfg, locate_mode="convex")
    c1 = cpt.run_cycles(tm, st, ccfg, 5)
    c4 = cpt.run_cycles(tm, st, dataclasses.replace(ccfg, macro_cycles=4, hop_compact=4), 5)
    for f in ("pos", "vel", "tet_id", "active"):
        assert torch.equal(getattr(c1, f), getattr(c4, f)), f
    assert mac.step == 12 and c4.step == 10


def _lanes_at_phase(tm, m0, xi, phase, k, admit=None):
    """macro_stream on a copy of ``m0`` with the given phase vector: (m,
    phase, pending)."""
    cfg = cpt.StepConfig(dt=0.3, diffusion_coeff=5e-3, macro_cycles=k, escape_faces=True)
    kw = dict(fused.stream_kwargs(cfg, cfg.dt, m0.dtype), k=k, bounce_on=True, esc_on=True)
    m, ph = m0.clone(), phase.clone()
    pend = torch.full_like(ph, 9)
    fused_cuda.macro_stream(tm.tet_row, m, xi, ph, pend, admit=admit, **kw)
    return m, ph, pend


@pytest.mark.parametrize("n", [4096, 4099])
@pytest.mark.parametrize("k", [2, 4])
def test_macro_trip_with_whole_runs_of_lanes_finished(k, n):
    """A trip on a phase vector with whole 256-lane runs finished, one run
    holding a single working lane, and the ragged tail finished: lanes do
    not depend on their neighbours, so each lane ends where it ends when
    every lane is at its phase; finished lanes keep their row, are not
    pending and keep phase k.  With and without admission flags."""
    tm = tmesh.set_boundary_escape(convert.to_mesh(_payload(np.float32, seed=k), device=CPU), [1])
    st = _state(tm, n, seed=30 + k)
    m0 = fused.pack_state(fused.row_table(tm), st.pos, st.vel, st.tet_id, st.active)
    rng = np.random.default_rng(n + k)
    xi = torch.as_tensor(rng.standard_normal((k, n, 3)), dtype=torch.float32)
    phase = torch.as_tensor(rng.integers(0, k + 1, n).astype(np.uint8))
    phase[256:1024] = k
    phase[1280:1536] = k
    phase[1280 + 7] = k - 1
    phase[-300:] = k
    admit = torch.as_tensor((rng.uniform(size=n) < 0.5).astype(np.uint8))
    for adm in (None, admit):
        m, ph, pend = _lanes_at_phase(tm, m0, xi, phase, k, adm)
        done = phase == k
        assert torch.equal(m[done], m0[done])
        assert int(pend[done].sum()) == 0 and bool((ph[done] == k).all())
        for p in range(k):
            sel = phase == p
            mu, phu, pendu = _lanes_at_phase(tm, m0, xi, torch.full_like(phase, p), k, adm)
            assert torch.equal(m[sel], mu[sel]), p
            assert torch.equal(ph[sel], phu[sel]) and torch.equal(pend[sel], pendu[sel]), p
        assert bool((ph > phase)[~done].all())
    assert int(pend.sum()) > 0


@pytest.mark.parametrize("k", [2, 4])
def test_macro_trip_with_no_lane_working(k):
    """Every lane at phase k: the whole pass and the flag pass leave the
    state alone and write zero flags over whatever the buffers held."""
    n = 4099
    tm = convert.to_mesh(_payload(np.float32), device=CPU)
    st = _state(tm, n, seed=3)
    m0 = fused.pack_state(fused.row_table(tm), st.pos, st.vel, st.tet_id, st.active)
    xi = torch.zeros((k, n, 3))
    phase = torch.full((n,), k, dtype=torch.uint8)
    m, ph, pend = _lanes_at_phase(tm, m0, xi, phase, k)
    assert torch.equal(m, m0) and torch.equal(ph, phase) and int(pend.sum()) == 0
    cross = torch.full_like(phase, 9)
    cfg = cpt.StepConfig(dt=0.3, diffusion_coeff=5e-3)
    fused_cuda.macro_crossers(tm.tet_row, m, xi, ph, cross, k=k,
                              **fused.stream_kwargs(cfg, cfg.dt, m.dtype))
    assert int(cross.sum()) == 0 and torch.equal(m, m0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [2, 4])
def test_macro_equals_per_cycle_steps_at_a_ragged_lane_count(k, dtype):
    """4,099 lanes (no multiple of a block, of 16 or of 4): one macro cycle
    against k per-cycle steps, bit for bit, under the Philox stream."""
    tm = tmesh.set_boundary_escape(convert.to_mesh(_payload(dtype, seed=5), device=CPU), [1])
    st = _state(tm, 4099, seed=40 + k)
    cfg = cpt.StepConfig(dt=0.3, diffusion_coeff=5e-3, macro_cycles=k, escape_faces=True,
                         brownian_rng="rbg")
    m0 = fused.pack_state(fused.row_table(tm), st.pos, st.vel, st.tet_id, st.active)
    ref = m0.clone()
    for j in range(k):
        fused.mega_cycle(tm, ref, st.seed, st.step + j, cfg, cfg.dt)
    got = fused.mega_macro(tm, m0.clone(), st.seed, st.step, cfg, cfg.dt)
    live = ref[:, 6] >= 0
    assert torch.equal(got[:, :8], ref[:, :8]) and torch.equal(got[live], ref[live])
    assert (ref[:, 6] != m0[:, 6]).float().mean() > 0.3


HOIST_CASES = [dict(macro_cycles=4), dict(macro_cycles=3, hop_compact=4),
               dict(hop_compact=4, hop_compact_frac=0.02),
               dict(hop_compact=4, locate_mode="convex")]


@pytest.mark.parametrize("case", range(len(HOIST_CASES)))
def test_run_cycles_hoisted_scratch_equals_per_call_buffers(case):
    """``run_cycles`` allocates the compacted stages' buffers once
    (``fused.compact_scratch``) and hands them down; the cycles called one
    by one without them allocate their own.  Same state, bit for bit, and a
    scratch that is reused dirty from an earlier run changes nothing."""
    kw = dict(dict(dt=0.3, diffusion_coeff=5e-3, brownian_rng="rbg"), **HOIST_CASES[case])
    cfg = cpt.StepConfig(**kw)
    tm = cpt.with_convex_rows(convert.to_mesh(_payload(np.float64, seed=6), device=CPU))
    n, n_cycles = 1500, 7
    st = _state(tm, n, seed=50 + case)
    got = cpt.run_cycles(tm, st, cfg, n_cycles)
    dirty = fused.compact_scratch(n, CPU)
    for name in ("phase", "crossers", "admit"):
        dirty[name].fill_(3)
    if cfg.locate_mode == "convex":
        from cudaparticlesfoam_tpu_torch.ops import fused_convex
        tab = fused_convex.cx_table(tm)
        for scratch in (None, dirty):
            m = fused.pack_state(tab, st.pos, st.vel, st.tet_id, st.active, fused_convex.WIDTH)
            for i in range(n_cycles):
                fused_convex.mega_cycle(tm, tab, m, st.seed, st.step + i, cfg, cfg.dt,
                                        scratch=scratch)
            pos, vel, tet, act = fused.unpack_state(m)
            assert torch.equal(pos, got.pos) and torch.equal(tet, got.tet_id)
            assert torch.equal(vel, got.vel) and torch.equal(act, got.active)
        return
    k = cfg.macro_cycles
    for scratch in (None, dirty):
        m = fused.pack_state(fused.row_table(tm), st.pos, st.vel, st.tet_id, st.active)
        n_mac = n_cycles // k if k > 1 else 0
        for i in range(0, n_mac * k, k):
            fused.mega_macro(tm, m, st.seed, st.step + i, cfg, cfg.dt, scratch=scratch)
        for i in range(n_mac * k, n_cycles):
            fused.mega_cycle(tm, m, st.seed, st.step + i, cfg, cfg.dt, scratch=scratch)
        pos, vel, tet, act = fused.unpack_state(m)
        assert torch.equal(pos, got.pos) and torch.equal(tet, got.tet_id)
        assert torch.equal(vel, got.vel) and torch.equal(act, got.active)
    assert (got.tet_id != st.tet_id).float().mean() > 0.3
