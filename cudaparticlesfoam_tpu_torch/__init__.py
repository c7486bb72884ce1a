"""cudaparticlesfoam_tpu_torch — the PyTorch/CUDA port of cudaparticlesfoam_tpu.

Lagrangian passive-particle tracking on a tetrahedral mesh (Euler
advection through a frozen TetVelocity field, Brownian kicks, barycentric
tet walk, specular wall reflection), with the per-cycle hot loop in two
hand-written CUDA kernels for the H100 (``ops/fused_cuda.py``,
``csrc/``).  On CPU tensors the same calls run the kernels' plain PyTorch
versions.  This package imports torch and never jax.
"""

from .mesh import TetMesh, box_mesh, from_arrays, replace_velocity, set_boundary_escape
from .state import ParticleState, make_state, seed_from_file, seed_in_box
from .stepper import StepConfig, diagnostics, n_cycles_for, run_cycles, suggest_tuning
from .ops.locate import (
    GridLocator,
    build_grid_locator,
    first_locate,
    locate_seeds,
    walk,
)

__version__ = "0.1.0"

__all__ = [
    "TetMesh",
    "box_mesh",
    "from_arrays",
    "replace_velocity",
    "set_boundary_escape",
    "ParticleState",
    "make_state",
    "seed_in_box",
    "seed_from_file",
    "StepConfig",
    "run_cycles",
    "n_cycles_for",
    "diagnostics",
    "suggest_tuning",
    "GridLocator",
    "build_grid_locator",
    "first_locate",
    "locate_seeds",
    "walk",
]
