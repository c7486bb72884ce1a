"""The particle stepper (port of ``cudaparticlesfoam_tpu/stepper.py``): the
cached engine, whose cycle runs in hand-written CUDA kernels, and the
simple engine (:func:`cycle`: ``ops.advect`` + ``ops.locate`` /
``ops.convex`` as torch ops), which is the cached engine's oracle and runs
what its kernels do not cover (``StepConfig.resolved_engine``).

``run_cycles`` packs the state into the mega array once ([n, 32] under
TetVelocity, [n, 40] under VertexVelocity), runs
``n_cycles`` sub-steps of :func:`ops.fused.mega_cycle` (or, with
``locate_mode="convex"``, :func:`ops.fused_convex.mega_cycle`; two
kernels each on CUDA: stream + rare, with ``hop_compact=4`` four: the
crossing flags, ``hop_admit``, stream, rare), and unpacks.  With
``macro_cycles`` = k > 1 the bary engine runs k sub-steps at a time as
one macro cycle (:func:`ops.fused.mega_macro`: k trips of the macro
stream and rare kernels) and the remaining ``n_cycles % k`` one at a
time.  ``integrator="rk4"`` runs the stream kernel's RK4 instantiation
(per cycle, uncompacted).  PyTorch runs eagerly, so the loop is a Python loop of
asynchronous launches with no host sync inside.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .dtypes import numpy_float
from .mesh import TetMesh
from .ops import advect as advect_ops
from .ops import convex as convex_ops
from .ops import fused, fused_convex
from .ops import locate as locate_ops
from .state import ParticleState


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Per-run knobs, every field of the JAX package's ``StepConfig`` with
    the same defaults and validation; :func:`check_ported` refuses values
    the engines cannot take."""

    dt: float = 1e-4
    diffusion_coeff: float = 5.7e-6
    use_advection: bool = True            # usingAdvection
    use_brownian: bool = True             # usingBrownianMotion
    reflect_wall: bool = True             # reflectWall
    velocity_interp: str = advect_ops.TET_VELOCITY
    max_hops: int = locate_ops.MAX_HOPS   # RTQuery.cu:42
    max_bounces: int = 10                 # RTQuery.cu:131
    engine: str = "auto"
    # rare-stage and RK4 stage-walk round buffer and arena fractions: the
    # kernels need no compaction, so these have no effect in the port
    # (accepted so that a JAX configuration carries over unchanged)
    walk_capacity_frac: float = 0.125
    arena_lane_frac: float = 0.25
    locate_mode: str = "bary"
    integrator: str = "euler"
    # "threefry": torch.randn outside the kernel, one stream per (seed,
    # step); "rbg" / "rbg_kernel": the JAX "rbg" Philox stream, drawn
    # inside the stream kernels on CUDA (ops/fused.py:_brownian_noise)
    brownian_rng: str = "threefry"
    inline_hops: int = 1
    inline_bounce: bool = True
    # no effect in the port: the JAX package splits a cycle into lane ranges
    # for its TPU (gather queue, table placement); the card runs the whole
    # cycle, and a range would give the same result bit for bit
    cycle_chunks: int = 1
    hop_compact: int = 0
    hop_compact_frac: float = 0.5
    macro_cycles: int = 1
    escape_faces: bool = False
    # any of ENGINE_IMPLS: the kernels on CUDA tensors, their plain versions
    # on CPU tensors (equal bit for bit, so the JAX choices cannot differ)
    engine_impl: str = "auto"
    convex_bary_fix: bool = True

    def __post_init__(self):
        if self.hop_compact not in (0, 4):
            raise ValueError(
                f"hop_compact must be 0 (off) or 4 (4-lane groups), got "
                f"{self.hop_compact!r} — other group widths are not "
                f"implemented (the packed carry holds 4 lanes per row)"
            )
        if not 1 <= self.macro_cycles <= 8:
            raise ValueError(
                f"macro_cycles must be in 1..8 (phases ride f32 head rows"
                f" and trips are unrolled), got {self.macro_cycles!r}"
            )

    def resolved_engine(self) -> str:
        """"cached" or "simple" (JAX ``StepConfig.resolved_engine``): under
        ``engine="auto"`` the cached engine takes TetVelocity + Euler with
        the ConvexPoly locator, and TetVelocity / VertexVelocity with the
        barycentric one; everything else goes to the simple engine.
        On CPU tensors ``run_cycles`` also falls back to the simple engine
        where the mesh lacks the cached engine's tables; on the card it
        raises there."""
        if self.engine != "auto":
            return self.engine
        if self.locate_mode == "convex":
            return ("cached" if self.velocity_interp == advect_ops.TET_VELOCITY
                    and self.integrator == "euler" else "simple")
        return ("cached" if self.velocity_interp in (advect_ops.TET_VELOCITY,
                                                     advect_ops.VERTEX_VELOCITY)
                and self.locate_mode == "bary" and self.integrator in ("euler", "rk4")
                else "simple")


# the JAX package's engine_impl values (its Pallas and jnp stream paths)
ENGINE_IMPLS = ("auto", "jnp", "pallas", "pallas_packed")


def check_ported(cfg: StepConfig) -> None:
    """Raise ``ValueError`` for values the engines cannot take."""
    if cfg.engine not in ("auto", "cached", "simple"):
        raise ValueError(f"unknown engine {cfg.engine!r}")
    if cfg.locate_mode not in ("bary", "convex"):
        raise ValueError(f"unknown locate_mode {cfg.locate_mode!r}")
    if cfg.integrator not in ("euler", "rk4"):
        raise ValueError(f"unknown integrator {cfg.integrator!r}")
    if cfg.velocity_interp not in (advect_ops.TET_VELOCITY, advect_ops.VERTEX_VELOCITY,
                                   advect_ops.CONSTANT_VELOCITY):
        raise ValueError(f"unknown velocity interpolation mode {cfg.velocity_interp!r}")
    if cfg.brownian_rng not in ("threefry",) + fused.RBG_MODES:
        raise ValueError(f"unknown brownian_rng {cfg.brownian_rng!r}")
    if cfg.engine_impl not in ENGINE_IMPLS:
        raise ValueError(f"unknown engine_impl {cfg.engine_impl!r}, expected one of "
                         f"{ENGINE_IMPLS}")
    if not 0 <= cfg.inline_hops <= 8:
        raise ValueError(f"inline_hops must be in 0..8, got {cfg.inline_hops}")


def cycle(mesh: TetMesh, state: ParticleState, cfg: StepConfig, dt,
          noise=None) -> ParticleState:
    """One Lagrangian sub-step of the simple engine (one iteration of
    ``advect.H:86-184``; JAX ``stepper.cycle``): advect, Brownian kick,
    locate (the barycentric walk, or with ``locate_mode="convex"`` the
    segment tracer, its reflector and the ``convex_bary_fix`` pass),
    reflect, move.  Torch ops on the tensors' device, no kernel.  ``noise``
    [n, 3] replaces the cycle's noise draw, as in :func:`run_cycles`, so
    that the cached and the simple engine can be run on one stream."""
    T = state.dtype
    dt = float(np.asarray(dt, numpy_float(T)))   # dt in the state dtype first, as JAX casts it
    pos, vel, disp = state.pos, state.vel, state.disp
    tet_id, active = state.tet_id, state.active

    # advect: disp = dt * u(x); kills lanes with negative tet ids
    if cfg.use_advection:
        disp, vel, active = advect_ops.advect(
            mesh, pos, vel, tet_id, active, dt, cfg.velocity_interp,
            integrator=cfg.integrator)

    # brownian: disp += sqrt(2 D dt) N(0,1)
    if cfg.use_brownian:
        xi = noise if noise is not None else fused._brownian_noise(
            state.seed, state.step, state.n_particles, T, state.device, cfg.brownian_rng)
        disp = advect_ops.brownian(disp, active, xi, dt, cfg.diffusion_coeff)

    if cfg.locate_mode == "convex":
        # ConvexPoly mode: exact segment tracing + its reflector
        tet_id, stop_tet, p_cross, hit_face = convex_ops.trace_segment(
            mesh, pos, disp, tet_id, active=active, max_tets=cfg.max_hops)
        if cfg.reflect_wall:
            pos, disp, vel, tet_id = convex_ops.convex_reflect(
                mesh, pos, disp, vel, tet_id, stop_tet, p_cross, hit_face)
            if cfg.convex_bary_fix:
                # barycentric consistency pass on the landed position
                p_land = pos + torch.where(active[:, None], disp, torch.zeros_like(disp))
                tet_chk, _ = locate_ops.walk(mesh, p_land, tet_id)
                d_fix, vel, tet_id = locate_ops.reflect_walls(
                    mesh, p_land, torch.zeros_like(disp), vel, tet_chk,
                    max_bounces=cfg.max_bounces)
                disp = torch.where(active[:, None], disp + d_fix, disp)
    else:
        # locate: walk from the previous tet to pos + disp
        tet_id, _ = locate_ops.walk(mesh, pos + disp, tet_id, max_hops=cfg.max_hops)
        # reflect wall hits (specular, all boundaries but the absorbing ones)
        if cfg.reflect_wall:
            disp, vel, tet_id = locate_ops.reflect_walls(
                mesh, pos, disp, vel, tet_id, max_bounces=cfg.max_bounces)

    # move: pos += disp; disp = 0
    pos, disp = advect_ops.move(pos, disp, active)
    return dataclasses.replace(
        state, pos=pos, vel=vel, disp=disp, tet_id=tet_id.to(torch.int32), active=active,
        step=state.step + 1)


def step_once(mesh: TetMesh, state: ParticleState, cfg: StepConfig, dt,
              noise=None) -> ParticleState:
    """Single sub-step of the simple engine, for tests and interactive use
    (JAX ``stepper.step_once``)."""
    check_ported(dataclasses.replace(cfg, engine="simple"))
    return cycle(mesh, state, cfg, dt, noise=noise)


def engine_for(mesh: TetMesh, cfg: StepConfig, device) -> str:
    """The engine :func:`run_cycles` runs on ``device``:
    ``cfg.resolved_engine()``, except where that is "cached" and the mesh
    lacks the table it reads.  Then "simple" on the CPU, and ``ValueError``
    on any other device (see :func:`run_cycles`)."""
    engine = cfg.resolved_engine()
    missing = None
    if engine == "cached" and cfg.locate_mode == "convex":
        missing = "with_convex_rows" if mesh.tet_row_cx is None else None
    elif engine == "cached" and cfg.velocity_interp == advect_ops.VERTEX_VELOCITY:
        missing = "with_pk_rows" if mesh.tet_row_pk is None else None
    if missing is None:
        return engine
    if torch.device(device).type != "cpu":
        raise ValueError(
            f"the cached engine needs mesh.{missing}(mesh) on {device}: attach the table, or "
            f"pass engine='simple' for the simple engine (torch ops, no kernel)")
    return "simple"


class PackedRun:
    """The cached engine's state of a run, packed once and carried from
    call to call of :meth:`advance` (what :func:`run_cycles` does inside
    one call): the mega array (``[n, 32]`` or ``[n, 40]``, or the convex
    mega with its ``disp``), ``pending`` and the compacted stages' scratch,
    the seed and the step.  Under the simple engine it carries the
    :class:`ParticleState` itself.  The data-parallel shards of
    ``parallel/sharding.py`` each keep one across the engine's calls.

    The row cache holds the velocities of the table it was packed from:
    after the mesh's velocities change, :meth:`set_mesh` re-packs it from
    the unpacked state, as a new :func:`run_cycles` call would."""

    def __init__(self, mesh: TetMesh, state: ParticleState, cfg: StepConfig):
        check_ported(cfg)
        self.cfg, self.template = cfg, state
        self.seed, self.step = state.seed, state.step
        self.engine = engine_for(mesh, cfg, state.device)
        self.ly = fused.layout_for(cfg)
        n = state.n_particles
        self.macro = (cfg.locate_mode == "bary" and cfg.macro_cycles > 1
                      and self.ly is fused.LAYOUT_TET and cfg.integrator == "euler")
        if self.engine == "simple":
            self.mesh, self.state = mesh, state
            return
        self.pending = torch.empty(n, dtype=torch.uint8, device=state.device)
        # the compacted stages' buffers, once for the run
        self.scratch = None
        if (cfg.hop_compact == fused.HOP_GROUP and self.ly is fused.LAYOUT_TET
                and cfg.integrator == "euler") or self.macro:
            self.scratch = fused.compact_scratch(n, state.device)
        self.disp = None
        if cfg.locate_mode == "convex":
            self.disp = torch.empty((n, 3), dtype=state.dtype, device=state.device)
        self._pack(mesh, state.pos, state.vel, state.tet_id, state.active)

    def _pack(self, mesh, pos, vel, tet, act):
        self.mesh = mesh
        if self.cfg.locate_mode == "convex":
            self.tab = fused_convex.cx_table(mesh)
            self.m = fused_convex.pack_state(mesh, self.tab, pos, vel, tet, act)
        else:
            self.m = fused.pack_state(mesh, pos, vel, tet, act, self.ly)

    def _unpack(self):
        if self.cfg.locate_mode == "convex":
            return fused_convex.unpack_state(self.m)
        return fused.unpack_state(self.m)

    def set_mesh(self, mesh: TetMesh) -> None:
        """Continue on ``mesh`` (new velocities or geometry, same tets):
        the row cache is gathered again from its tables."""
        if self.engine == "simple":
            self.mesh = mesh
            return
        pos, vel, tet, act = self._unpack()
        self._pack(mesh, pos.clone(), vel.clone(), tet, act)

    def advance(self, n_cycles: int, dt, noise=None, lane_offset0: int = 0) -> None:
        """``n_cycles`` sub-steps from the current step, in place.  ``noise``:
        anything indexable by the cycle (``noise[i]``, and for a macro cycle
        ``noise[i : i + k]``), e.g. a [n_cycles, n, 3] tensor; ``lane_offset0``:
        the global index of lane 0 under "rbg"/"rbg_kernel" (the Philox key,
        ``fused.philox_key``)."""
        cfg = self.cfg
        step = self.step
        if self.engine == "simple":
            for i in range(n_cycles):
                self.state = cycle(self.mesh, self.state, cfg, dt,
                                   noise=None if noise is None else noise[i])
        elif cfg.locate_mode == "convex":
            for i in range(n_cycles):
                fused_convex.mega_cycle(self.mesh, self.tab, self.m, self.seed, step + i, cfg,
                                        dt, noise=None if noise is None else noise[i],
                                        pending=self.pending, disp=self.disp,
                                        scratch=self.scratch, lane_offset=lane_offset0)
        else:
            k = cfg.macro_cycles
            n_mac = n_cycles // k if self.macro else 0
            for i in range(0, n_mac * k, k):
                fused.mega_macro(self.mesh, self.m, self.seed, step + i, cfg, dt,
                                 noise=None if noise is None else noise[i : i + k],
                                 pending=self.pending, scratch=self.scratch,
                                 lane_offset=lane_offset0)
            for i in range(n_mac * k, n_cycles):
                fused.mega_cycle(self.mesh, self.m, self.seed, step + i, cfg, dt,
                                 noise=None if noise is None else noise[i],
                                 pending=self.pending, scratch=self.scratch,
                                 lane_offset=lane_offset0)
        self.step = step + n_cycles

    def result(self) -> ParticleState:
        """The state after the cycles run so far (fresh tensors)."""
        if self.engine == "simple":
            return self.state
        pos, vel, tet, act = self._unpack()
        return dataclasses.replace(
            self.template, pos=pos.clone(), vel=vel.clone(),
            disp=torch.zeros_like(self.template.disp), tet_id=tet, active=act,
            step=self.step,
        )


def run_cycles(mesh: TetMesh, state: ParticleState, cfg: StepConfig,
               n_cycles: int, dt=None, noise=None, lane_offset0: int = 0) -> ParticleState:
    """``n_cycles`` sub-steps.  The engine is ``cfg.resolved_engine()``: the
    cached engine (bary under TetVelocity or VertexVelocity, or ConvexPoly
    with ``locate_mode="convex"`` under TetVelocity), or the simple engine
    (:func:`cycle`).  Where the mesh lacks the cached engine's tables
    (VertexVelocity without ``mesh.with_pk_rows``, convex without
    ``mesh.with_convex_rows``) the JAX package hands the run to the simple
    engine without a word.  The port does so on CPU tensors only; on the
    card, where that would trade the kernels for torch ops with a host
    sync per walk hop, it raises ``ValueError`` and names the two ways on:
    attach the table, or ask for ``engine="simple"``.

    ``dt`` defaults to cfg.dt (``advect.H:36-37``: pass the Eulerian
    ``cycleDt`` for sub-cycled runs).  ``noise`` [n_cycles, n, 3], when
    given, replaces the per-step noise draw (replays of a recorded
    Brownian stream).  ``lane_offset0`` (JAX's): the global index of lane
    0, which keys the "rbg"/"rbg_kernel" Philox stream of a data-parallel
    shard (``parallel/sharding.py``); at 0 it changes nothing.  On CUDA
    tensors every cycle of the cached engine runs the stream and rare
    kernels; on CPU tensors their plain versions.
    ``macro_cycles`` applies to the bary engine only (the convex engine
    never reads it, as in JAX); a macro cycle takes ``noise`` k steps at a
    time.

    VertexVelocity keeps to the JAX package's envelope: ``hop_compact=4``
    is ignored (its compacted hop gather takes no layout) and
    ``macro_cycles`` > 1 runs cycle by cycle (a macro sub-step needs a
    velocity that is constant within a tet), so both give the plain run's
    result.  So does ``integrator="rk4"`` on the cached engine (JAX runs
    it on its jnp path, which has neither): the stream kernel's RK4
    instantiation, whose stage walks run inside the kernel.
    ``cycle_chunks`` has no effect (see :class:`StepConfig`)."""
    dt = cfg.dt if dt is None else dt
    n = state.n_particles
    if noise is not None and tuple(noise.shape) != (n_cycles, n, 3):
        raise ValueError(f"noise must be [{n_cycles}, {n}, 3], got {tuple(noise.shape)}")
    run = PackedRun(mesh, state, cfg)
    run.advance(n_cycles, dt, noise=noise, lane_offset0=lane_offset0)
    return run.result()


def suggest_tuning(mesh: TetMesh, cfg: StepConfig, dt=None,
                   n_particles: int | None = None) -> StepConfig:
    """Static tuning of ``inline_hops``, ``walk_capacity_frac`` and
    ``inline_bounce`` from the expected tet-face crossings per particle per
    sub-step (per-tet speed, tet size and the Brownian RMS kick), as the
    JAX package estimates them.  Its chunk, hop-compaction and arena
    thresholds were measured on a TPU and are not carried over
    (``hop_compact`` and ``macro_cycles`` are left as ``cfg`` has them).
    ``n_particles`` is accepted for signature parity and unused."""
    dt = float(cfg.dt if dt is None else dt)
    host = mesh.host
    pts = host["points"].astype(np.float64)
    tets = host["tets"]
    u = host["tet_vel"].astype(np.float64)
    if cfg.velocity_interp == advect_ops.VERTEX_VELOCITY or not np.any(u):
        vv = host["vert_vel"].astype(np.float64)
        if np.any(vv):
            u = vv[tets].mean(axis=1)
    a = pts[tets[:, 0]]
    vol = np.abs(
        np.einsum(
            "ij,ij->i",
            pts[tets[:, 1]] - a,
            np.cross(pts[tets[:, 2]] - a, pts[tets[:, 3]] - a),
        )
        / 6.0
    )
    h = np.cbrt(np.maximum(vol * 6.0, 1e-300))   # tet characteristic length
    speed = np.sqrt((u * u).sum(axis=1))
    if cfg.use_brownian:
        speed = speed + np.sqrt(2.0 * cfg.diffusion_coeff / max(dt, 1e-300)) * 1.7
    # mean tets crossed per sub-step (1.5: the Kuhn split's internal
    # diagonal faces are crossed more often than cell faces)
    crossings = float(np.mean(np.minimum(speed * dt / np.maximum(h, 1e-300), 50.0)) * 1.5)
    if crossings < 0.4:
        hops, frac = 1, 1 / 16
    elif crossings < 0.8:
        hops, frac = 2, 1 / 8
    elif crossings < 1.5:
        hops, frac = 4, 1 / 4
    else:
        hops, frac = min(4 + int(crossings + 1.0), 8), 1 / 4
    # inline bounce when wall contact is frequent: boundary-adjacent tet
    # fraction x crossing rate
    bd_frac = float(np.mean(np.any(host["tet_nbr"] < 0, axis=1)))
    wall_rate = bd_frac * min(crossings, 1.0) * 0.5
    inline_bounce = cfg.reflect_wall and wall_rate > 0.01
    return dataclasses.replace(
        cfg, inline_hops=hops, walk_capacity_frac=frac,
        inline_bounce=inline_bounce,
    )


def n_cycles_for(delta_t_euler: float, dt_lagrange: float) -> tuple[int, float]:
    """Sub-cycling split (``advect.H:36-37``)."""
    n = max(int(math.ceil(delta_t_euler / dt_lagrange)), 1)
    return n, delta_t_euler / n


def diagnostics(state: ParticleState) -> dict:
    """Out-of-domain count, system KE and active count (the reference
    prints these at ``particles.cu:770`` and ``utils.cpp:258``)."""
    return {
        "out_of_domain": advect_ops.count_out_of_domain(state.tet_id),
        "kinetic_energy": advect_ops.kinetic_energy(state.vel),
        "active": state.active.sum(dtype=torch.int32),
    }
