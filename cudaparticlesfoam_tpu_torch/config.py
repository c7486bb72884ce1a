"""Case configuration.

Mirrors the reference's three config levels (SURVEY.md §5):
1. the ``system/cudaParticlesDict`` keys with ``getOrDefault`` defaults
   (``src/initCuda.H:50-57``),
2. ``system/controlDict`` time control,
3. the reference's hardcoded toggles (``src/initCuda.H:64-72``) promoted to
   real options.

A copy of ``cudaparticlesfoam_tpu/config.py``: the same fields, defaults
and parsing; :meth:`ParticlesConfig.step_config` returns the port's
``StepConfig`` (pinned field for field by ``tests/test_torch_case.py``).
"""

from __future__ import annotations

import dataclasses
import os

from .io import foamfile
from .stepper import StepConfig


@dataclasses.dataclass(frozen=True)
class ParticlesConfig:
    """system/cudaParticlesDict (+ promoted hardcoded toggles)."""

    seeding_box_lo: tuple = (0.0, 0.0, 0.0)
    seeding_box_hi: tuple = (30.0, 30.0, 30.0)   # initCuda.H:50 default bb
    num_particles: int = 1000                     # initCuda.H:52
    start_time: float = 0.0                       # initCuda.H:53
    end_time: float = 1e5                         # initCuda.H:54
    dt: float = 1e-4                              # initCuda.H:55
    diffusion_coeff: float = 5.7e-6               # initCuda.H:56
    save_interval: int = 10                       # initCuda.H:57
    # promoted toggles (initCuda.H:64-72)
    use_advection: bool = True
    use_brownian: bool = True
    reflect_wall: bool = True
    save_streamlines: bool = False
    velocity_interp: str = "TetVelocity"
    # cell-location algorithm: the reference selects this at BUILD time
    # (RTX env -> -DConvexPoly, applications/*/Make/options:1-5); here it
    # is a case option: "bary" (RTX build) | "convex" (ConvexPoly build)
    locate_mode: str = "bary"
    # options of the rebuild (not in the reference)
    rng_seed: int = 0
    seeding_method: str = "reference"   # bit-exact owl LCG positions
    seeding_file: str | None = None
    # patches whose boundary faces absorb particles instead of reflecting
    # (data-driven fix for the reference's reflect-everywhere TODO,
    # RTQuery.cu:165-166); empty = reference-compatible reflect-all
    escape_patches: tuple = ()
    # dump mesh.vtk / mesh_faces.vtk at init like the reference's OptiX
    # layer does at BVH build (OptixTetQuery.cpp:331-417)
    write_mesh_vtk: bool = False
    # continuous injection (new capability; the reference only kills
    # particles): every injectionInterval sub-steps, re-seed up to
    # injectionCount dead slots in the seeding box
    injection_interval: int = 0
    injection_count: int = 0

    def step_config(self) -> StepConfig:
        return StepConfig(
            dt=self.dt,
            diffusion_coeff=self.diffusion_coeff,
            use_advection=self.use_advection,
            use_brownian=self.use_brownian,
            reflect_wall=self.reflect_wall,
            velocity_interp=self.velocity_interp,
            locate_mode=self.locate_mode,
            escape_faces=bool(self.escape_patches),
        )

    @staticmethod
    def from_dict(d: dict) -> "ParticlesConfig":
        g = foamfile.get_or_default
        box = d.get("seedingBox", [[0.0, 0.0, 0.0], [30.0, 30.0, 30.0]])
        return ParticlesConfig(
            seeding_box_lo=tuple(float(x) for x in box[0]),
            seeding_box_hi=tuple(float(x) for x in box[1]),
            num_particles=int(g(d, "numParticles", 1000.0)),
            start_time=g(d, "startTime", 0.0),
            end_time=g(d, "endTime", 1e5),
            dt=g(d, "dt", 1e-4),
            diffusion_coeff=g(d, "diffusionCoeff", 5.7e-6),
            save_interval=int(g(d, "saveInterval", 10.0)),
            use_advection=bool(g(d, "useAdvection", 1)),
            use_brownian=bool(g(d, "useBrownianMotion", 1)),
            reflect_wall=bool(g(d, "reflectWall", 1)),
            save_streamlines=bool(g(d, "saveStreamlines", 0)),
            velocity_interp=str(g(d, "velocityInterpMethod", "TetVelocity")),
            locate_mode=str(g(d, "locateMode", "bary")),
            rng_seed=int(g(d, "rngSeed", 0.0)),
            seeding_method=str(g(d, "seedingMethod", "reference")),
            seeding_file=d.get("seedingFile"),
            escape_patches=tuple(
                d["escapePatches"] if isinstance(d.get("escapePatches"), list)
                else ([d["escapePatches"]] if "escapePatches" in d else [])
            ),
            write_mesh_vtk=bool(g(d, "writeMeshVtk", 0)),
            injection_interval=int(g(d, "injectionInterval", 0.0)),
            injection_count=int(g(d, "injectionCount", 0.0)),
        )

    @staticmethod
    def from_case(case_dir: str) -> "ParticlesConfig":
        path = os.path.join(case_dir, "system", "cudaParticlesDict")
        return ParticlesConfig.from_dict(foamfile.read(path))


@dataclasses.dataclass(frozen=True)
class ControlConfig:
    """system/controlDict subset the solvers consume."""

    start_from: str = "latestTime"
    start_time: float = 0.0
    end_time: float = 1.0
    delta_t: float = 0.1
    write_interval: float = 100
    write_control: str = "timeStep"
    adjust_time_step: bool = False
    max_co: float = 1.0
    application: str = ""
    # output management (OpenFOAM Time I/O controls)
    purge_write: int = 0            # keep only the last N written time dirs
    write_format: str = "ascii"     # "ascii" | "binary"
    write_compression: bool = False  # gzip written field files

    @staticmethod
    def from_dict(d: dict) -> "ControlConfig":
        g = foamfile.get_or_default
        return ControlConfig(
            start_from=str(g(d, "startFrom", "latestTime")),
            start_time=g(d, "startTime", 0.0),
            end_time=g(d, "endTime", 1.0),
            delta_t=g(d, "deltaT", 0.1),
            write_interval=g(d, "writeInterval", 100.0),
            write_control=str(g(d, "writeControl", "timeStep")),
            adjust_time_step=str(g(d, "adjustTimeStep", "no")) in ("yes", "true", "on", "1"),
            max_co=g(d, "maxCo", 1.0),
            application=str(g(d, "application", "")),
            purge_write=int(g(d, "purgeWrite", 0.0)),
            write_format=str(g(d, "writeFormat", "ascii")),
            write_compression=str(g(d, "writeCompression", "off"))
            in ("yes", "true", "on", "1", "compressed"),
        )

    @staticmethod
    def from_case(case_dir: str) -> "ControlConfig":
        path = os.path.join(case_dir, "system", "controlDict")
        return ControlConfig.from_dict(foamfile.read(path))


def read_transport_properties(case_dir: str) -> dict:
    path = os.path.join(case_dir, "constant", "transportProperties")
    if os.path.exists(path):
        return foamfile.read(path)
    return {}
