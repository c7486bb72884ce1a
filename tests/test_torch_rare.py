"""PyTorch port: the rare stage (``rare_plain``, the plain version of the
CUDA ``rare_kernel``) against the JAX package's ``fused._rare_stage`` on
identical (mega, pending) inputs in float64: tet/active exact, pos/vel
within 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudaparticlesfoam_tpu.mesh as jmesh
from cudaparticlesfoam_tpu import StepConfig as JStepConfig
from cudaparticlesfoam_tpu.ops import fused as jfused
from cudaparticlesfoam_tpu_torch import StepConfig, build_grid_locator, convert, locate_seeds
from cudaparticlesfoam_tpu_torch import mesh as tmesh
from cudaparticlesfoam_tpu_torch.ops import fused, fused_cuda

from torch_port_common import CPU   # also caps torch at one thread

NSIDE, N = 6, 2048


def _meshes(escape):
    pts, tets, vv = tmesh.box_points_tets(NSIDE, NSIDE, NSIDE)
    payload = tmesh.from_arrays_host(pts, tets, tet_vel=vv[tets].mean(axis=1),
                                     vert_vel=vv, dtype=np.float64)
    ctr = payload["points"][payload["bd_tris"]].mean(axis=1)
    payload["bd_patch"] = ((ctr[:, 0] > NSIDE - 1e-6) | (ctr[:, 1] < 1e-6)).astype(np.int32)
    jm = jmesh.host_to_device(dict(payload))
    tm = convert.to_mesh(payload, device=CPU)
    if escape:
        jm = jmesh.set_boundary_escape(jm, [1])
        tm = tmesh.set_boundary_escape(tm, [1])
    return jm, tm


def _rare_inputs(tm, kind, seed):
    """Lanes with a cached start tet and a far target position in the pos
    columns: 'walk' = 0-4 cells away (multi-hop walkers, some past a wall),
    'corner' = targets beyond the box corners (multi-bounce hits)."""
    rng = np.random.default_rng(seed)
    start = rng.uniform(0.2, NSIDE - 0.2, (N, 3))
    st = convert.to_state(start, np.zeros(N, np.int32), dtype=torch.float64, device=CPU)
    tet = locate_seeds(tm, build_grid_locator(tm), st.pos)
    if kind == "walk":
        target = start + rng.normal(scale=1.6, size=(N, 3))
    else:
        corner = rng.integers(0, 2, (N, 3)) * NSIDE
        target = corner + np.where(corner > 0, 1.0, -1.0) * rng.uniform(0.01, 1.5, (N, 3))
    vel = torch.as_tensor(rng.normal(size=(N, 3)))
    act = torch.as_tensor(rng.uniform(size=N) > 0.02)
    m = fused.pack_state(tm, torch.as_tensor(target), vel, tet, act)
    pend = torch.as_tensor(rng.uniform(size=N) < 0.7).to(torch.uint8)
    return m, pend


CASES = [
    ("walk", dict()),
    ("corner", dict()),
    ("walk", dict(escape_faces=True)),
    ("corner", dict(escape_faces=True)),
    ("walk", dict(reflect_wall=False)),
    ("walk", dict(max_hops=1)),
    ("corner", dict(max_bounces=1)),
    ("corner", dict(max_hops=3, max_bounces=3, walk_capacity_frac=0.01)),
    ("corner", dict(max_bounces=0)),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_rare_plain_matches_jax_rare_stage(case):
    kind, kw = CASES[case]
    escape = kw.get("escape_faces", False)
    jm, tm = _meshes(escape)
    m0, pend = _rare_inputs(tm, kind, seed=case)
    cfg = StepConfig(**kw)
    m = m0.clone()
    fused_cuda.rare_resolve(tm.tet_row, m, pend, tm.bd_escape, max_hops=cfg.max_hops,
                            max_bounces=cfg.max_bounces, reflect_wall=cfg.reflect_wall)
    mj = np.asarray(jfused._rare_stage(
        jm, jm.tet_row, jnp.asarray(m0.numpy()), jnp.asarray(pend.numpy().astype(bool)),
        JStepConfig(**kw), jfused.LAYOUT_TET, N, N // 8, 32))
    got = m.numpy()
    np.testing.assert_array_equal(got[:, 6], mj[:, 6])
    np.testing.assert_array_equal(got[:, 7], mj[:, 7])
    np.testing.assert_allclose(got[:, :6], mj[:, :6], atol=1e-12, rtol=0)
    # lanes not pending are untouched; the case really walked and bounced
    idle = pend.numpy() == 0
    np.testing.assert_array_equal(got[idle], m0.numpy()[idle])
    moved = (got[:, 6] != m0.numpy()[:, 6]) & ~idle
    assert moved.any()
    if kind == "corner" and cfg.reflect_wall and cfg.max_bounces:
        assert (np.abs(got[~idle, 3:6] - m0.numpy()[~idle, 3:6]) > 0).any()
    if escape:
        assert (got[~idle, 6] < 0).any()
    if cfg.reflect_wall and not escape:
        # out of bounces, a wall lane keeps its non-negative exit tet
        assert (got[~idle & (m0.numpy()[:, 6] >= 0), 6] >= 0).all()


def test_rare_plain_with_nothing_pending_is_a_no_op():
    _, tm = _meshes(False)
    m0, pend = _rare_inputs(tm, "walk", seed=0)
    m = m0.clone()
    fused.rare_plain(tm.tet_row, m, torch.zeros_like(pend), tm.bd_escape,
                     max_hops=50, max_bounces=10, reflect_wall=True)
    assert torch.equal(m, m0)

