"""Square-duct analytic flow oracle (port of
``cudaparticlesfoam_tpu/ops/duct.py``).

The reference's closed-form laminar square-duct profile and its
analytic-advect step (``SquareDuct_analyticalVel`` / ``particleTubeAdvect``
/ ``cudaTubeAdvect``, ``particles.cu:451-519``; the series of
PhysRevE.71.057301): an exact Navier-Stokes solution used as an end-to-end
trajectory-error oracle for the particle engines.  Sample the profile onto
a tet mesh, advect with the production engine, and the difference from the
analytic trajectory is pure interpolation error.

Coordinates follow the reference: the duct cross-section is
``x in [-h/2, h/2]``, ``y in [0, h]``, flow along z.  Plain torch ops on
the caller's device (or numpy): there is no kernel here, and the JAX
package has none.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# cudaTubeAdvect's hardcoded configuration (particles.cu:498-506)
TUBE_L = 30.0            # cm
TUBE_H = 0.1             # cm
TUBE_MU = 0.001072       # Pa s
TUBE_DP = -4.904871302657455   # Pa
TUBE_Q = 0.000536        # cm^3/s (documented flow rate; not used in the math)


def square_duct_velocity(x, y, h=TUBE_H, L=TUBE_L, dp=TUBE_DP, mu=TUBE_MU,
                         n_terms: int = 20):
    """Axial velocity vz(x, y) of laminar flow in a square duct.

    Same 20-term series and association order as the reference
    (``particles.cu:451-463``); works on numpy arrays or torch tensors.
    """
    xp = torch if torch.is_tensor(x) or torch.is_tensor(y) else np
    vz = xp.zeros_like(x * y)
    for i in range(n_terms):
        n = 2.0 * i + 1.0
        vz = vz + (
            1.0 / (n * n * n)
            * (1.0 - xp.cosh(n * math.pi * x / h) / math.cosh(n * math.pi / 2.0))
            * xp.sin(n * math.pi * y / h)
        )
    return -dp / L / mu * 4.0 * h * h / math.pi ** 3 * vz


def tube_advect(pos, vel, tet_id, active, dt,
                h=TUBE_H, L=TUBE_L, dp=TUBE_DP, mu=TUBE_MU):
    """One analytic-advect step (``particleTubeAdvect`` semantics):
    velocity = (0, 0, vz(x, y)) at the CURRENT position, displacement =
    vel*dt; particles with negative tet id are deactivated.  Returns
    (pos', vel', active')."""
    vz = square_duct_velocity(pos[:, 0], pos[:, 1], h, L, dp, mu)
    act = active & (tet_id >= 0)
    vel_new = torch.stack([torch.zeros_like(vz), torch.zeros_like(vz), vz], dim=1)
    vel_new = torch.where(act[:, None], vel_new, vel)
    pos_new = pos + torch.where(act[:, None], vel_new * dt, torch.zeros_like(vel_new))
    return pos_new, vel_new, act
