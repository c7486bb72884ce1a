"""PyTorch port: the analytic square-duct oracle (``ops/duct.py``,
``models/duct.py``; the reference's ``particles.cu:451-519``): twins of the
JAX package's ``tests/test_duct.py``, the port's profile and analytic
advect against JAX's, and the end-to-end trajectory check through the
port's cached engine with both integrators."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudaparticlesfoam_tpu.models import duct as jmduct
from cudaparticlesfoam_tpu.ops import duct as jduct
import cudaparticlesfoam_tpu_torch as cpt
from cudaparticlesfoam_tpu_torch.models import duct as mduct
from cudaparticlesfoam_tpu_torch.ops import duct

from torch_port_common import CPU   # also caps torch at one thread


def test_profile_properties():
    """No-slip at all four walls, maximum at the centre, positive flow for
    a negative pressure gradient, symmetry in x (numpy and torch inputs)."""
    h = duct.TUBE_H
    y = np.linspace(0.0, h, 41)
    x0 = np.zeros_like(y)
    assert np.abs(duct.square_duct_velocity(np.full_like(y, -h / 2), y)).max() < 1e-9
    assert np.abs(duct.square_duct_velocity(np.full_like(y, h / 2), y)).max() < 1e-9
    assert np.abs(duct.square_duct_velocity(x0, np.zeros_like(y))).max() < 1e-9
    centre = duct.square_duct_velocity(np.array([0.0]), np.array([h / 2]))[0]
    assert centre > 0.0
    prof = duct.square_duct_velocity(x0, y)
    assert prof.max() == centre
    xs = np.linspace(-h / 2, h / 2, 21)
    v = duct.square_duct_velocity(xs, np.full_like(xs, h / 2))
    np.testing.assert_allclose(v, v[::-1], atol=1e-12)
    vt = duct.square_duct_velocity(torch.as_tensor(xs), torch.full((21,), h / 2))
    assert torch.is_tensor(vt)
    np.testing.assert_allclose(vt.numpy(), v, atol=1e-12, rtol=0)


def test_flow_rate_matches_reference_config():
    """The profile integrated over the cross-section gives the flow rate
    the reference documents for its hardcoded config (Q = 0.000536 cm^3/s,
    particles.cu:505)."""
    h = duct.TUBE_H
    n = 400
    x = (np.arange(n) + 0.5) / n * h - h / 2
    y = (np.arange(n) + 0.5) / n * h
    X, Y = np.meshgrid(x, y)
    q = duct.square_duct_velocity(X, Y).mean() * h * h
    np.testing.assert_allclose(q, duct.TUBE_Q, rtol=2e-3)


def test_tube_advect_semantics():
    """particleTubeAdvect: straight-line z motion at the local analytic
    speed; dead lanes (tet < 0) freeze and deactivate."""
    pos = torch.tensor([[0.0, duct.TUBE_H / 2, 0.0], [0.02, 0.03, 1.0],
                        [0.0, duct.TUBE_H / 2, 2.0]], dtype=torch.float64)
    vel = torch.zeros((3, 3), dtype=torch.float64)
    tet = torch.tensor([0, 5, -1])
    act = torch.tensor([True, True, True])
    dt = 0.5
    p1, v1, a1 = duct.tube_advect(pos, vel, tet, act, dt)
    vz0 = float(duct.square_duct_velocity(np.array([0.0]), np.array([duct.TUBE_H / 2]))[0])
    np.testing.assert_allclose(p1[0].numpy(), [0.0, duct.TUBE_H / 2, dt * vz0], rtol=1e-6)
    assert not bool(a1[2])
    np.testing.assert_allclose(p1[2].numpy(), [0.0, duct.TUBE_H / 2, 2.0])
    np.testing.assert_allclose(p1[:2, :2].numpy(), pos[:2, :2].numpy())


def test_oracle_matches_jax():
    """The port's profile (ops and models), analytic advect step and
    n-step analytic advect against the JAX package's on the same float64
    inputs, to 1e-12."""
    h = duct.TUBE_H
    rng = np.random.default_rng(2)
    x = rng.uniform(-h / 2, h / 2, 257)
    y = rng.uniform(0.0, h, 257)
    want = np.asarray(jduct.square_duct_velocity(jnp.asarray(x), jnp.asarray(y)))
    got = duct.square_duct_velocity(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    np.testing.assert_allclose(mduct.duct_velocity(x, y).numpy(),
                               np.asarray(jmduct.duct_velocity(x, y)), atol=1e-12, rtol=0)
    pos = np.stack([x, y, rng.uniform(0.0, 1.0, 257)], axis=1)
    vel = rng.normal(size=(257, 3))
    tet = np.where(rng.uniform(size=257) < 0.1, -1, 3)
    act = rng.uniform(size=257) > 0.05
    want = jduct.tube_advect(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(tet),
                             jnp.asarray(act), 0.3)
    got = duct.tube_advect(torch.as_tensor(pos), torch.as_tensor(vel), torch.as_tensor(tet),
                           torch.as_tensor(act), 0.3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-12, rtol=0)
    for steps in (0, 1, 7):
        want = jmduct.tube_advect(jnp.asarray(pos), 0.05, n_steps=steps)
        got = mduct.tube_advect(torch.as_tensor(pos), 0.05, n_steps=steps)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-12, rtol=0)


@pytest.fixture(scope="module")
def duct_case():
    """The oracle's mesh and seeds of ``tests/test_duct.py``: 16 x 16 x 4
    cells and 4,000 lanes.  Larger than the port tests' usual 8^3 box: the
    test's tolerances (0.02 max, 0.006 median) are the P1 interpolation
    error of a 16-cell cross-section."""
    h = duct.TUBE_H
    mesh = mduct.duct_mesh(16, 4, dtype=torch.float64, device=CPU)
    rng = np.random.default_rng(11)
    n = 4000
    pos0 = np.stack([rng.uniform(-0.4 * h, 0.4 * h, n), rng.uniform(0.1 * h, 0.9 * h, n),
                     rng.uniform(0.05, 0.1, n)], axis=1)
    st = cpt.make_state(pos0, dtype=torch.float64, device=CPU)
    st = dataclasses.replace(st, tet_id=cpt.locate_seeds(mesh, cpt.build_grid_locator(mesh),
                                                         st.pos))
    return mesh, st, pos0


@pytest.mark.parametrize("integ", ["euler", "rk4"])
def test_engine_trajectory_error_vs_analytic(duct_case, integ):
    """End-to-end oracle (twin of the JAX test of the same name): the
    analytic profile sampled at the vertices, advected by the port's cached
    engine (VertexVelocity, the kernels' plain versions here), against the
    exact trajectory k dt vz(x0, y0).  The deviation is P1 interpolation
    error, O(1/N^2) on an N^2 section."""
    mesh, st, pos0 = duct_case
    h = duct.TUBE_H
    assert int((st.tet_id < 0).sum()) == 0
    vmax = float(duct.square_duct_velocity(np.array([0.0]), np.array([h / 2]))[0])
    dt = 0.01 / vmax        # ~0.01 cm per step at the centreline
    k = 25
    dz_exact = k * dt * duct.square_duct_velocity(pos0[:, 0], pos0[:, 1])
    cfg = cpt.StepConfig(dt=dt, use_brownian=False, velocity_interp="VertexVelocity",
                         integrator=integ)
    assert cfg.resolved_engine() == "cached"
    out = cpt.run_cycles(mesh, st, cfg, k)
    assert int((out.tet_id < 0).sum()) == 0
    dz = out.pos.numpy()[:, 2] - pos0[:, 2]
    rel = np.abs(dz - dz_exact) / (k * dt * vmax)
    assert rel.max() < 0.02          # JAX measured 0.0142 (wall-adjacent)
    assert np.median(rel) < 0.006    # JAX measured 0.0043
    np.testing.assert_allclose(out.pos.numpy()[:, :2], pos0[:, :2], atol=1e-7)
