"""cudaparticlesfoam_tpu_torch — the PyTorch/CUDA port of cudaparticlesfoam_tpu.

Lagrangian passive-particle tracking on a tetrahedral mesh (Euler or RK4
advection through a frozen TetVelocity or VertexVelocity field, Brownian
kicks, barycentric tet walk, specular wall reflection), with the per-cycle
hot loop in two hand-written CUDA kernels for the H100
(``ops/fused_cuda.py``, ``csrc/``), for the barycentric locator (under
TetVelocity, and under VertexVelocity on a mesh with ``with_pk_rows``;
Euler or RK4) and for the ConvexPoly one (``locate_mode="convex"`` on a
mesh with ``with_convex_rows``).  On CPU tensors the same calls run the
kernels' plain PyTorch versions.  The simple engine (``engine="simple"``,
``stepper.cycle``: torch ops, also ConstantVelocity) is their oracle;
where a mesh lacks the cached engine's tables, ``run_cycles`` takes it on
CPU tensors and raises on the card.  The analytic square-duct oracle
(``ops/duct.py``, ``models/duct.py``) checks trajectories end to end.

A case directory runs through the uncoupled driver
(``models/uncoupled.py``, ``python -m cudaparticlesfoam_tpu_torch
uncoupled <case>``): the OpenFOAM I/O of ``io/``, the case set-up of
``config.py`` and ``models/case.py``, then ``run_cycles`` chunk by chunk
between VTU frames, on the card unless told otherwise.
This package imports torch and never jax.
"""

from .mesh import (
    TetMesh,
    box_mesh,
    from_arrays,
    replace_velocity,
    set_boundary_escape,
    with_convex_rows,
    with_pk_rows,
)
from .state import ParticleState, make_state, seed_from_file, seed_in_box
from .stepper import (
    StepConfig,
    cycle,
    diagnostics,
    n_cycles_for,
    run_cycles,
    step_once,
    suggest_tuning,
)
from .ops.locate import (
    GridLocator,
    build_grid_locator,
    first_locate,
    locate_seeds,
    reflect_walls,
    walk,
)
from .ops.convex import convex_reflect, trace_segment

__version__ = "0.1.0"

__all__ = [
    "TetMesh",
    "box_mesh",
    "from_arrays",
    "replace_velocity",
    "set_boundary_escape",
    "with_convex_rows",
    "with_pk_rows",
    "ParticleState",
    "make_state",
    "seed_in_box",
    "seed_from_file",
    "StepConfig",
    "run_cycles",
    "cycle",
    "step_once",
    "n_cycles_for",
    "diagnostics",
    "suggest_tuning",
    "GridLocator",
    "build_grid_locator",
    "first_locate",
    "locate_seeds",
    "walk",
    "reflect_walls",
    "trace_segment",
    "convex_reflect",
]
