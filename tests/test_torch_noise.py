"""PyTorch port, Brownian noise: the plain Philox4x32-10 stream
(``fused.philox_bits`` / ``philox_normals``, the plain version of the CUDA
stream kernels' in-kernel noise) against the JAX package's off-TPU "rbg"
stream (``lax.rng_bit_generator``, ``fused._brownian_noise``).

The bits must be equal.  The normals go through log, sqrt, sin and cos,
whose CPU implementations differ between XLA and PyTorch by an ulp or two:
they must agree within 4 ulps of the Box-Muller radius r = sqrt(-2 log u)
(the measured worst case is 2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from cudaparticlesfoam_tpu import StepConfig as JStepConfig
from cudaparticlesfoam_tpu.ops import fused as jfused
import cudaparticlesfoam_tpu_torch as cpt
from cudaparticlesfoam_tpu_torch import convert
from cudaparticlesfoam_tpu_torch.ops import fused, fused_cuda

from torch_port_common import CPU   # also caps torch at one thread

KEYS = [
    (0, 0, 0),                       # (seed, step, lane_offset)
    (1, 3, 0),
    (42, 17, 4096),
    ((1 << 40) + 7, 123456, 0),
    ((1 << 64) - 1, (1 << 32) - 1, 0xFFFFFFFF),
    (5, 9, 0x9E3779B9 ^ 0xFFFFFFF0),  # the counter's low word carries into the next
]


@pytest.mark.parametrize("seed,step,off", KEYS)
@pytest.mark.parametrize("n", [1, 7, 1000, 4099])
def test_philox_bits_equal_rng_bit_generator(seed, step, off, n):
    key4 = fused.philox_key(seed, step, off)
    want = np.asarray(lax.rng_bit_generator(jnp.asarray(np.array(key4, np.uint32)), (n, 4),
                                            dtype=jnp.uint32)[1])
    got = fused.philox_bits(key4, n).numpy()
    assert got.dtype == np.int64 and got.min() >= 0 and got.max() < (1 << 32)
    np.testing.assert_array_equal(got.astype(np.uint32), want)


def test_philox_key_is_the_jax_key():
    """(key0, key1) = jax.random.PRNGKey(seed); words 2, 3 as in
    fused._brownian_noise."""
    for seed in (0, 1, 12345, (1 << 33) + 5, (1 << 63) - 1):
        kk = np.asarray(jax.random.PRNGKey(seed), dtype=np.uint32)
        assert fused.philox_key(seed, 8, 3)[:2] == tuple(int(x) for x in kk)
    assert fused.philox_key(1, 8, 3)[2:] == (0x9E3779B9 ^ 3, 8)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed,step", [(3, 5), (0, 0), ((1 << 40) + 7, 123456)])
def test_normals_match_jax_rbg(dtype, seed, step):
    n = 50001
    cfg = JStepConfig(brownian_rng="rbg")
    want = np.asarray(jfused._brownian_noise(jax.random.PRNGKey(seed), step, n, dtype, cfg))
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    got = fused._brownian_noise(seed, step, n, tdt, torch.device("cpu"), "rbg")
    assert got.dtype == tdt and tuple(got.shape) == (n, 3)
    got = got.numpy()
    bits = fused.philox_bits(fused.philox_key(seed, step), n).numpy()
    r = np.sqrt(-2.0 * np.log(bits[:, :2] * 2.0**-32 + 2.0**-33))
    ulp_r = np.spacing(np.stack([r[:, 0], r[:, 0], r[:, 1]], 1).astype(dtype))
    assert (np.abs(got - want) <= 4 * ulp_r).all()
    assert (got == want).mean() > 0.8
    same = fused._brownian_noise(seed, step, n, tdt, torch.device("cpu"), "rbg_kernel")
    np.testing.assert_array_equal(same.numpy(), got)


def test_noise_statistics():
    """Sane normals: mean, variance, independence of the three components
    and of consecutive steps (1M lanes per step, as the slice draws)."""
    n = 1_000_000
    a = fused._brownian_noise(7, 0, n, torch.float64, torch.device("cpu"), "rbg")
    b = fused._brownian_noise(7, 1, n, torch.float64, torch.device("cpu"), "rbg")
    for x in (a, b):
        assert float(x.mean(dim=0).abs().max()) < 0.005
        assert float((x.var(dim=0) - 1.0).abs().max()) < 0.006
        c = torch.corrcoef(x.T)
        assert float((c - torch.eye(3, dtype=c.dtype)).abs().max()) < 0.005
    assert abs(float((a * b).mean())) < 0.005
    # fourth moment of a normal is 3
    assert abs(float((a ** 4).mean()) - 3.0) < 0.05


def test_unknown_noise_mode_raises():
    with pytest.raises(ValueError, match="brownian_rng"):
        fused._brownian_noise(0, 0, 4, torch.float32, torch.device("cpu"), "rbg2")
    with pytest.raises(ValueError, match="brownian_rng"):
        cpt.run_cycles(cpt.box_mesh(1, 1, 1, device=CPU),
                       convert.to_state(np.full((1, 3), 0.5), [0], device=CPU),
                       cpt.StepConfig(brownian_rng="philox"), 1)


@pytest.mark.parametrize("locate_mode", ["bary", "convex"])
def test_rbg_modes_run_the_same_stream(locate_mode):
    """On the CPU "rbg" and "rbg_kernel" are one stream, drawn per (seed,
    step), so the results are identical, and equal to injecting
    philox_normals; a different seed changes them."""
    mesh = cpt.with_convex_rows(cpt.box_mesh(4, 4, 4, dtype=np.float64, device=CPU))
    rng = np.random.default_rng(0)
    pos = rng.uniform(0.2, 3.8, (512, 3))
    tet = cpt.locate_seeds(mesh, cpt.build_grid_locator(mesh), torch.as_tensor(pos))
    st = convert.to_state(pos, tet.numpy(), seed=11, step=4, dtype=np.float64, device=CPU)
    kw = dict(dt=0.2, diffusion_coeff=0.02, locate_mode=locate_mode)
    a = cpt.run_cycles(mesh, st, cpt.StepConfig(brownian_rng="rbg", **kw), 5)
    b = cpt.run_cycles(mesh, st, cpt.StepConfig(brownian_rng="rbg_kernel", **kw), 5)
    noise = torch.stack([fused.philox_normals(fused.philox_key(11, 4 + i), 512, torch.float64)
                         for i in range(5)])
    c = cpt.run_cycles(mesh, st, cpt.StepConfig(**kw), 5, noise=noise)
    for x in (b, c):
        assert torch.equal(a.pos, x.pos) and torch.equal(a.tet_id, x.tet_id)
        assert torch.equal(a.vel, x.vel) and torch.equal(a.active, x.active)
    d = cpt.run_cycles(mesh, convert.to_state(pos, tet.numpy(), seed=12, step=4,
                                              dtype=np.float64, device=CPU),
                       cpt.StepConfig(brownian_rng="rbg", **kw), 5)
    assert not torch.equal(a.pos, d.pos)


def test_stream_wrapper_draws_philox_on_the_cpu():
    """stream_cycle with a noise key equals stream_plain fed
    philox_normals, and launches nothing on the CPU."""
    mesh = cpt.box_mesh(3, 3, 3, device=CPU)
    rng = np.random.default_rng(1)
    pos = torch.as_tensor(rng.uniform(0.1, 2.9, (300, 3)), dtype=torch.float32)
    tet = cpt.locate_seeds(mesh, cpt.build_grid_locator(mesh), pos)
    m0 = fused.pack_state(mesh, pos, torch.zeros_like(pos), tet, torch.ones(300, dtype=torch.bool))
    kw = dict(dt=0.1, sigma=0.3, use_adv=True, use_brown=True, bounce_on=True, esc_on=False,
              n_hops=1)
    key = fused.philox_key(3, 9)
    ma, mb = m0.clone(), m0.clone()
    pa, pb = torch.empty(300, dtype=torch.uint8), torch.empty(300, dtype=torch.uint8)
    before = fused_cuda.stream_cycle.launches
    fused_cuda.stream_cycle(mesh.tet_row, ma, None, pa, noise_key=key, **kw)
    fused.stream_plain(mesh.tet_row, mb, fused.philox_normals(key, 300, torch.float32), pb, **kw)
    assert torch.equal(ma, mb) and torch.equal(pa, pb)
    assert fused_cuda.stream_cycle.launches == before
    assert not torch.equal(ma[:, :3], m0[:, :3])
