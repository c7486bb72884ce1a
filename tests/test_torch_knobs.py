"""PyTorch port: the last engine knobs.  ``cycle_chunks`` (twins of the
JAX package's ``test_cycle_chunks_bit_identical`` for the bary, convex and
VertexVelocity engines: the port runs the whole cycle whatever the knob
says, and the result is the one JAX's lane ranges give, bit for bit) and
``engine_impl`` (every JAX value runs the same code)."""

import dataclasses

import numpy as np
import pytest
import torch

import cudaparticlesfoam_tpu_torch as cpt
from cudaparticlesfoam_tpu_torch import convert
from cudaparticlesfoam_tpu_torch import mesh as tmesh
from cudaparticlesfoam_tpu_torch.stepper import ENGINE_IMPLS

from torch_port_common import CPU   # also caps torch at one thread


@pytest.fixture(scope="module")
def outward6():
    """``test_cycle_chunks_bit_identical``'s set-up: box 6^3, the outward
    field x1.2 (per tet and at the vertices), 4,096 located seeds; the
    convex and Pk tables attached."""
    pts, tets, _ = tmesh.box_points_tets(6, 6, 6)

    def outward(x):
        c = x - 3.0
        return c / (np.linalg.norm(c, axis=1, keepdims=True) + 1e-12) * 1.2

    payload = tmesh.from_arrays_host(pts, tets, tet_vel=outward(pts[tets].mean(axis=1)),
                                     vert_vel=outward(pts), dtype=np.float64)
    tm = cpt.with_convex_rows(tmesh.with_pk_rows(convert.to_mesh(payload, device=CPU)))
    rng = np.random.default_rng(8)
    pos = rng.uniform(0.5, 5.5, (4096, 3))
    st = convert.to_state(pos, np.zeros(4096, np.int32), dtype=np.float64, device=CPU)
    return tm, dataclasses.replace(st, tet_id=cpt.locate_seeds(tm, cpt.build_grid_locator(tm),
                                                               st.pos))


def _identical(a, b):
    for f in ("pos", "vel", "tet_id", "active"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


CHUNKED = [
    dict(),
    dict(locate_mode="convex"),
    dict(velocity_interp="VertexVelocity"),
]


@pytest.mark.parametrize("kw", CHUNKED, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()) or "bary")
def test_cycle_chunks_bit_identical(outward6, kw):
    """cycle_chunks=4 equals cycle_chunks=1 bit for bit over 25 cycles."""
    tm, st = outward6
    base = cpt.StepConfig(dt=0.07, diffusion_coeff=1e-3, engine="cached", **kw)
    a = cpt.run_cycles(tm, st, base, 25)
    b = cpt.run_cycles(tm, st, dataclasses.replace(base, cycle_chunks=4), 25)
    _identical(a, b)
    assert (a.tet_id != st.tet_id).any()


@pytest.mark.parametrize("impl", ENGINE_IMPLS)
def test_engine_impl_values_run_the_same_engine(outward6, impl):
    """Each of the JAX package's engine_impl values means "the kernels on
    CUDA tensors, their plain versions on CPU tensors": the result equals
    "auto"'s bit for bit, under both layouts."""
    tm, st = outward6
    for vi in ("TetVelocity", "VertexVelocity"):
        cfg = cpt.StepConfig(dt=0.07, diffusion_coeff=1e-3, velocity_interp=vi)
        _identical(cpt.run_cycles(tm, st, dataclasses.replace(cfg, engine_impl=impl), 6),
                   cpt.run_cycles(tm, st, cfg, 6))


def test_unknown_engine_impl_raises(outward6):
    tm, st = outward6
    with pytest.raises(ValueError, match="engine_impl"):
        cpt.run_cycles(tm, st, cpt.StepConfig(engine_impl="xla"), 1)


def test_walk_and_arena_fractions_have_no_effect(outward6):
    """``walk_capacity_frac`` and ``arena_lane_frac`` size JAX's compaction
    arenas only: the port's kernels need none."""
    tm, st = outward6
    cfg = cpt.StepConfig(dt=0.07, diffusion_coeff=1e-3, integrator="rk4")
    _identical(cpt.run_cycles(tm, st, dataclasses.replace(cfg, walk_capacity_frac=1e-3,
                                                          arena_lane_frac=1e-3), 6),
               cpt.run_cycles(tm, st, cfg, 6))
