"""Advection, Brownian diffusion and move ops of the simple engine, and the
diagnostics reductions (port of ``cudaparticlesfoam_tpu/ops/advect.py``).

Each op maps old state tensors to new ones with torch ops on the tensors'
device; the simple engine (``stepper.cycle``) chains them.  It has no
kernel in the JAX package and needs none here: it is the oracle the cached
engine's kernels are held against, and runs the settings they do not
cover.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dtypes import numpy_float
from .geometry import bary_from_tinv

# velocity interpolation modes (src/initCuda.H:72 hardcodes "TetVelocity")
TET_VELOCITY = "TetVelocity"        # RT0: cell-constant (particles.cu:317-373)
VERTEX_VELOCITY = "VertexVelocity"  # Pk: barycentric vertex interp (:245-313)
CONSTANT_VELOCITY = "ConstantVelocity"  # keep current vel (:377-399)


def interp_velocity(mesh, pos, tet_id, vel_prev, mode: str):
    """Velocity at particle positions (negative tet ids are clamped to 0)."""
    safe = tet_id.long().clamp(min=0)
    if mode == TET_VELOCITY:
        return mesh.tet_vel[safe]
    if mode == VERTEX_VELOCITY:
        bary = bary_from_tinv(pos, mesh.tet_a[safe], mesh.tet_tinv[safe])
        vverts = mesh.vert_vel[mesh.tets[safe].long()]          # [n, 4, 3]
        return ((bary[:, 0, None] * vverts[:, 0] + bary[:, 1, None] * vverts[:, 1])
                + bary[:, 2, None] * vverts[:, 2]) + bary[:, 3, None] * vverts[:, 3]
    if mode == CONSTANT_VELOCITY:
        return vel_prev
    raise ValueError(f"unknown velocity interpolation mode {mode!r}")


def advect(mesh, pos, vel, tet_id, active, dt, mode: str = TET_VELOCITY,
           integrator: str = "euler"):
    """Advection displacement (``cudaAdvect``, ``particles.cu:403-448``).

    ``integrator`` "euler" is the reference's first-order step
    (``particles.cu:297-302``); "rk4" is classical RK4 with each stage
    point relocated by a bounded tet walk from the lane's tet, so stage
    velocities come from the right cell (a stage that leaves the domain
    falls back to the lane's own tet).

    Kills particles whose tet_id went negative (left the domain with wall
    reflection off, ``particles.cu:333-338``).  Returns (disp, vel, active).
    """
    alive = active & (tet_id >= 0)
    v = interp_velocity(mesh, pos, tet_id, vel, mode)
    if integrator == "rk4":
        from . import locate as locate_ops

        def vel_at(p):
            t, _ = locate_ops.walk(mesh, p, tet_id, active=alive)
            t_ok = torch.where(t >= 0, t, tet_id.to(t.dtype))
            return interp_velocity(mesh, p, t_ok, vel, mode)

        k1 = v
        k2 = vel_at(pos + 0.5 * dt * k1)
        k3 = vel_at(pos + 0.5 * dt * k2)
        k4 = vel_at(pos + dt * k3)
        v_eff = (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0
    elif integrator == "euler":
        v_eff = v
    else:
        raise ValueError(f"unknown integrator {integrator!r}")
    disp = v_eff * dt
    disp = torch.where(alive[:, None], disp, torch.zeros_like(disp))
    new_vel = torch.where(alive[:, None], v_eff, vel)
    return disp, new_vel, alive


def brownian(disp, active, xi, dt, diffusion_coeff):
    """Brownian displacement increment (``particleBrownianMotion``,
    ``particles.cu:551-599``): disp += sqrt(2 D dt) * xi per axis for
    active lanes, with ``xi`` [n, 3] standard normals (the JAX package
    draws them here from its key; the port's caller draws or injects
    them, ``fused._brownian_noise``)."""
    nt = numpy_float(disp.dtype)
    # sigma in the state dtype from T(2 D) * T(dt), as the JAX package forms it
    sigma = float(np.sqrt(np.asarray(2.0 * diffusion_coeff, nt) * np.asarray(dt, nt)))
    return disp + torch.where(active[:, None], sigma * xi, torch.zeros_like(disp))


def move(pos, disp, active):
    """Apply displacement and reset it (``particleMoveKernel`` disp overload,
    ``particles.cu:659-716``): inactive particles keep pos *and* disp."""
    new_pos = torch.where(active[:, None], pos + disp, pos)
    new_disp = torch.where(active[:, None], torch.zeros_like(disp), disp)
    return new_pos, new_disp


def count_out_of_domain(tet_id: torch.Tensor) -> torch.Tensor:
    """``cudaReportParticles`` count (``particles.cu:763-775``)."""
    return (tet_id < 0).sum(dtype=torch.int32)


def kinetic_energy(vel: torch.Tensor, mass: float = 1.0) -> torch.Tensor:
    """Total system KE as printed at every VTU write (``utils.cpp:241-258``)."""
    return 0.5 * mass * (vel * vel).sum()


def eval_timestep(mesh, diffusion_coeff: float):
    """Stable-dt estimate per tet (``evalTimestep``, ``particles.cu:164-237``;
    declared in the reference's public API but not called by its solvers).

    Returns (dt_min, dt_max) over tets with the reference's formulas: the
    velocity constraint dt <= 0.5 h / |u| with h = cbrt of the signed
    determinant, and the Brownian-root constraint."""
    tets = mesh.tets.long()
    a, b, c, d = (mesh.points[tets[:, i]] for i in range(4))
    volume = ((d - a) * torch.linalg.cross(b - a, c - a)).sum(dim=-1)
    grid_h = torch.sign(volume) * volume.abs().pow(1.0 / 3.0)
    speed = torch.linalg.vector_norm(mesh.tet_vel, dim=-1)
    dt_vel = 0.5 * grid_h / speed
    dt_brown = (
        torch.sqrt(6.0 * diffusion_coeff + 2.0 * speed * grid_h)
        - (6.0 * diffusion_coeff) ** 0.5
    ) / (2.0 * speed)
    dt_est = torch.minimum(dt_brown, dt_vel).abs()
    # particles.cu:195
    dt_est = torch.where(dt_est < 1e-8, torch.full_like(dt_est, 1.12345678), dt_est)
    return dt_est.min(), dt_est.max()
