"""Interpolation-mode names and the diagnostics reductions (port of the
parts of ``cudaparticlesfoam_tpu/ops/advect.py`` that ``diagnostics``
needs; the simple engine's advect/brownian/move are not ported)."""

from __future__ import annotations

import torch

# velocity interpolation modes (src/initCuda.H:72 hardcodes "TetVelocity")
TET_VELOCITY = "TetVelocity"        # RT0: cell-constant (particles.cu:317-373)
VERTEX_VELOCITY = "VertexVelocity"  # Pk: barycentric vertex interp (:245-313)
CONSTANT_VELOCITY = "ConstantVelocity"  # keep current vel (:377-399)


def count_out_of_domain(tet_id: torch.Tensor) -> torch.Tensor:
    """``cudaReportParticles`` count (``particles.cu:763-775``)."""
    return (tet_id < 0).sum(dtype=torch.int32)


def kinetic_energy(vel: torch.Tensor, mass: float = 1.0) -> torch.Tensor:
    """Total system KE as printed at every VTU write (``utils.cpp:241-258``)."""
    return 0.5 * mass * (vel * vel).sum()
