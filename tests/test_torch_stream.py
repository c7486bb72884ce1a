"""PyTorch port: the stream section (``stream_plain``, the plain version of
the CUDA ``stream_kernel``) against the JAX package's Pallas stream
kernels in interpret mode, and the whole cycle against the jnp engine in
f64.  The inputs are built once with numpy from a seed and uploaded to
both packages, and the Brownian noise is injected into both."""

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
from cudaparticlesfoam_tpu_torch.ops import fused, fused_cuda

from torch_port_common import CPU   # also caps torch at one thread


def _payload(nside, dtype):
    """Box payload with the radial (outward) field and +x faces tagged as
    patch 1."""
    pts, tets, vv = tmesh.box_points_tets(nside, nside, nside)
    payload = tmesh.from_arrays_host(pts, tets, tet_vel=vv[tets].mean(axis=1),
                                     vert_vel=vv, dtype=dtype)
    ctr = payload["points"][payload["bd_tris"]].mean(axis=1)
    payload["bd_patch"] = (ctr[:, 0] > nside - 1e-6).astype(np.int32)
    return payload


def _meshes(payload, escape):
    jm = jmesh.host_to_device(dict(payload))
    tm = convert.to_mesh(payload, device=CPU)
    if escape:
        jm = jmesh.set_boundary_escape(jm, [1])
        tm = tmesh.set_boundary_escape(tm, [1])
    return jm, tm


def _lanes(tm, n, nside, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.05, nside - 0.05, (n, 3))
    st = convert.to_state(pos, np.zeros(n, np.int32), dtype=tm.dtype, device=CPU)
    tet = locate_seeds(tm, build_grid_locator(tm), st.pos)
    vel = torch.as_tensor(rng.normal(size=(n, 3)), dtype=tm.dtype)
    act = torch.as_tensor(rng.uniform(size=n) > 0.05)
    m0 = fused.pack_state(fused.row_table(tm), st.pos, vel, tet, act)
    xi = torch.as_tensor(rng.standard_normal((n, 3)), dtype=tm.dtype)
    return m0, xi


def _run_port(tm, m0, xi, cfg, dt):
    m = m0.clone()
    pend = torch.empty(m.shape[0], dtype=torch.uint8)
    dt_t, sigma = fused.scalars(cfg, dt, m.dtype)
    fused_cuda.stream_cycle(
        tm.tet_row, m, xi, pend, dt=dt_t, sigma=sigma, use_adv=cfg.use_advection,
        use_brown=cfg.use_brownian, bounce_on=cfg.reflect_wall and cfg.inline_bounce,
        esc_on=cfg.escape_faces, n_hops=cfg.inline_hops)
    return m, pend


@pytest.mark.parametrize("escape", [False, True])
@pytest.mark.parametrize("hops,dt", [(1, 0.15), (4, 0.9)])
def test_stream_plain_matches_pallas_interpret(hops, dt, escape):
    """n = 8192 lanes on box 8^3, float32: tet/active/pending exact, floats
    within 2e-6 (Mosaic may contract mul+add into FMA, the plain version
    does not)."""
    from jax.experimental.pallas import tpu as pltpu

    # the Pallas kernels are float32-only; the harness enables x64 globally
    if jax.config.read("jax_enable_x64"):
        jax.config.update("jax_enable_x64", False)
        try:
            return test_stream_plain_matches_pallas_interpret(hops, dt, escape)
        finally:
            jax.config.update("jax_enable_x64", True)

    n, nside = fused_pallas.PACK_LANES, 8
    jm, tm = _meshes(_payload(nside, np.float32), escape)
    m0, xi = _lanes(tm, n, nside, seed=hops + 2 * escape)
    kw = dict(dt=dt, diffusion_coeff=5e-3, inline_hops=hops, escape_faces=escape)
    m, pend = _run_port(tm, m0, xi, StepConfig(**kw), dt)
    with pltpu.force_tpu_interpret_mode():
        m_rm, jpend = fused_pallas.pre_rare_cycle_packed(
            jm, jm.tet_row, jnp.asarray(m0.numpy()).reshape(-1, 128),
            jax.random.PRNGKey(0), 3, JStepConfig(**kw), jnp.float32(dt),
            noise=jnp.asarray(xi.numpy()), n_hops=hops)
    mj = np.asarray(m_rm).reshape(n, 32)
    got = m.numpy()
    np.testing.assert_array_equal(got[:, 6], mj[:, 6])      # tet ids
    np.testing.assert_array_equal(got[:, 7], mj[:, 7])      # active
    np.testing.assert_array_equal(pend.numpy().astype(bool), np.asarray(jpend))
    np.testing.assert_allclose(got[:, :6], mj[:, :6], atol=2e-6, rtol=0)
    # the cycle exercised hops, walls and (with escape) absorbs
    assert pend.numpy().any() and (got[:, 6] != m0.numpy()[:, 6]).any()
    if escape:
        assert ((got[:, 7] == 0) & (m0.numpy()[:, 7] == 1) & (got[:, 6] < 0)).any()


F64_CASES = [
    dict(inline_hops=1),
    dict(inline_hops=4),
    dict(inline_hops=1, escape_faces=True),
    dict(inline_hops=4, escape_faces=True),
    dict(inline_hops=2, reflect_wall=False),
    dict(inline_hops=0),
    dict(inline_hops=3, inline_bounce=False, use_advection=False, diffusion_coeff=0.5),
]


@pytest.mark.parametrize("case", range(len(F64_CASES)))
def test_cycle_plain_matches_jnp_engine_f64(case):
    """stream_plain + rare_plain against ``fused._mega_cycle_aligned``
    (jnp engine, float64, noise injected): tet/active exact, pos/vel
    within 1e-12."""
    nside, n, dt = 6, 4096, 0.6
    kw = dict(dict(dt=dt, diffusion_coeff=5e-3), **F64_CASES[case])
    escape = kw.get("escape_faces", False)
    jm, tm = _meshes(_payload(nside, np.float64), escape)
    m0, xi = _lanes(tm, n, nside, seed=10 + case)
    cfg = StepConfig(**kw)
    m = fused.mega_cycle(tm, m0.clone(), 0, 5, cfg, dt, noise=xi)
    mj = np.asarray(jfused._mega_cycle_aligned(
        jm, jnp.asarray(m0.numpy()), jax.random.PRNGKey(0), 5,
        JStepConfig(engine_impl="jnp", **kw), jnp.float64(dt),
        noise=jnp.asarray(xi.numpy())))
    got = m.numpy()
    np.testing.assert_array_equal(got[:, 6], mj[:, 6])
    np.testing.assert_array_equal(got[:, 7], mj[:, 7])
    np.testing.assert_allclose(got[:, :6], mj[:, :6], atol=1e-12, rtol=0)


def test_wrapper_checks_inputs():
    tm = convert.to_mesh(_payload(2, np.float32), device=CPU)
    m = torch.zeros((8, 32))
    pend = torch.zeros(8, dtype=torch.uint8)
    kw = dict(dt=0.1, sigma=0.1, use_adv=True, use_brown=False, bounce_on=True,
              esc_on=False, n_hops=1)
    with pytest.raises(TypeError):
        fused_cuda.stream_cycle(tm.tet_row, m.double(), None, pend, **kw)
    with pytest.raises(ValueError):
        fused_cuda.stream_cycle(tm.tet_row, torch.zeros((8, 30)), None, pend, **kw)
    with pytest.raises(ValueError):
        fused_cuda.stream_cycle(tm.tet_row, m.t().contiguous().t(), None, pend, **kw)
    with pytest.raises(TypeError):
        fused_cuda.stream_cycle(tm.tet_row, m, None, pend.bool(), **kw)
    with pytest.raises(TypeError):
        fused_cuda.stream_cycle(tm.tet_row, m, None, pend,
                                **dict(kw, use_brown=True))
    with pytest.raises(ValueError):
        fused_cuda.stream_cycle(tm.tet_row, m, None, pend, **dict(kw, n_hops=9))
    before = fused_cuda.stream_cycle.launches
    fused_cuda.stream_cycle(tm.tet_row, m, None, pend, **kw)
    assert fused_cuda.stream_cycle.launches == before   # CPU: plain, no launch


def test_brownian_noise_is_per_step_and_reproducible():
    a = fused._brownian_noise(7, 3, 1000, torch.float32, torch.device("cpu"))
    b = fused._brownian_noise(7, 3, 1000, torch.float32, torch.device("cpu"))
    c = fused._brownian_noise(7, 4, 1000, torch.float32, torch.device("cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert abs(float(a.mean())) < 0.1 and abs(float(a.std()) - 1.0) < 0.1


def test_stream_seed_separates_seed_and_step_on_both_devices():
    """Every (seed, step) pair gets a generator seed of its own in the bits
    the device's generator keeps: all 63 on the card (seed high, step low),
    the low 32 on the CPU (hashed, since mt19937 drops the rest)."""
    pairs = [(sd, st) for sd in (0, 1, 2, 7, 1 << 20, (1 << 31) - 1) for st in range(0, 4000, 7)]
    cuda = [fused._stream_seed(sd, st, torch.device("cuda", 0)) for sd, st in pairs]
    assert cuda == [(sd << 32) + st for sd, st in pairs] and len(set(cuda)) == len(pairs)
    cpu = [fused._stream_seed(sd, st, "cpu") for sd, st in pairs]
    assert all(0 <= x < (1 << 63) for x in cpu)
    assert len({x & 0xFFFFFFFF for x in cpu}) == len(pairs)
    # and the CPU draws differ by seed as well as by step
    a = fused._brownian_noise(7, 3, 100, torch.float64, torch.device("cpu"))
    b = fused._brownian_noise(8, 3, 100, torch.float64, torch.device("cpu"))
    assert not torch.equal(a, b)
