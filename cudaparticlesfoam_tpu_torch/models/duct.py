"""Analytic square-duct laminar flow, the validation oracle (port of
``cudaparticlesfoam_tpu/models/duct.py``).

The reference's closed-form Poiseuille profile for a square duct
(``SquareDuct_analyticalVel`` / ``cudaTubeAdvect``,
``cuda/particles.cu:451-519``; series solution per PhysRevE.71.057301):
axial velocity

    v_z(x, y) = -dp/(L mu) * 4 h^2 / pi^3 *
                sum_{n odd} 1/n^3 [1 - cosh(n pi x/h)/cosh(n pi/2)]
                            sin(n pi y/h)

with 20 series terms like the reference.  Used as an exact end-to-end
trajectory oracle: a particle advected in this field moves on a straight
line at constant speed, so integration error is directly measurable.
Plain torch ops on the inputs' device; no kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.duct import TUBE_DP as DEFAULT_DP
from ..ops.duct import TUBE_H as DEFAULT_H
from ..ops.duct import TUBE_L as DEFAULT_L
from ..ops.duct import TUBE_MU as DEFAULT_MU
from ..ops.duct import square_duct_velocity


def duct_velocity(x, y, h=DEFAULT_H, L=DEFAULT_L, dp=DEFAULT_DP, mu=DEFAULT_MU,
                  n_terms: int = 20):
    """Axial velocity v_z(x, y) as a tensor (``ops.duct.square_duct_velocity``'s
    series); broadcasts over array inputs."""
    x = torch.as_tensor(x)
    return square_duct_velocity(x, torch.as_tensor(y, device=x.device), h, L, dp, mu, n_terms)


def _duct_vel(p, h, L, dp, mu):
    vz = duct_velocity(p[:, 0], p[:, 1], h, L, dp, mu)
    return torch.stack([torch.zeros_like(vz), torch.zeros_like(vz), vz], dim=-1)


def tube_advect(pos, dt, n_steps: int = 1, h=DEFAULT_H, L=DEFAULT_L,
                dp=DEFAULT_DP, mu=DEFAULT_MU):
    """Euler-advect particles through the analytic duct field
    (``cudaTubeAdvect``): v = (0, 0, v_z(x, y)), pos += dt*v per step.
    Returns (pos, vel): the velocity of the last step taken (at the start
    position when ``n_steps`` is 0)."""
    p = torch.as_tensor(pos)
    v = _duct_vel(p, h, L, dp, mu)
    for _ in range(n_steps):
        v = _duct_vel(p, h, L, dp, mu)
        p = p + dt * v
    return p, v


def duct_mesh(n_xy: int = 16, n_z: int = 4, length: float = 0.5, h=DEFAULT_H, dtype=None,
              device=None):
    """The oracle's tet mesh (``tests/test_duct.py``'s
    ``test_engine_trajectory_error_vs_analytic``): the box of ``n_xy`` x
    ``n_xy`` x ``n_z`` cells mapped onto the cross-section ``[-h/2, h/2] x
    [0, h]`` and ``length`` along z, the analytic profile sampled at the
    vertices (VertexVelocity) and ``with_pk_rows`` attached, so that the
    cached engine runs it."""
    from ..mesh import box_points_tets, from_arrays, with_pk_rows

    pts, tets, _ = box_points_tets(n_xy, n_xy, n_z)
    pts = pts.astype(float)
    pts[:, 0] = pts[:, 0] / n_xy * h - h / 2
    pts[:, 1] = pts[:, 1] / n_xy * h
    pts[:, 2] = pts[:, 2] / n_z * length
    vz = square_duct_velocity(pts[:, 0], pts[:, 1], h=h)
    vert_vel = np.stack([np.zeros_like(vz), np.zeros_like(vz), vz], axis=1)
    return with_pk_rows(from_arrays(pts, tets, vert_vel=vert_vel, dtype=dtype, device=device))
