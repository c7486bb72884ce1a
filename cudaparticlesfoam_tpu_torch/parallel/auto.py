"""Multi-device strategy selection for the particle engine (port of
``cudaparticlesfoam_tpu/parallel/auto.py``).

* ``single``: one device, the plain stepper (``stepper.run_cycles``).
* ``dp``: particle data parallelism (:mod:`.sharding`): the mesh
  replicated per device, the particles sharded.  Chosen when the mesh's
  tables fit comfortably in one device's memory.
* ``partitioned``: the slab-partitioned mesh with migration
  (:mod:`.partition`).  Chosen when replicating the mesh would not fit.

:class:`ParticleEngine` gives the drivers one interface over the three.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..mesh import TetMesh
from ..ops import advect as advect_ops
from ..state import ParticleState
from ..stepper import StepConfig, run_cycles
from . import partition, sharding


def device_hbm_bytes(default: float = 16e9, device=None) -> float:
    """One device's memory budget: a CUDA device's total memory
    (``torch.cuda.get_device_properties``); ``default`` (the JAX package's
    value, so that both choose alike) where the device reports none, as the
    CPU does."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(dev).total_memory)
    return default


def mesh_table_bytes(tet_mesh: TetMesh) -> int:
    """Bytes of the mesh's tensors, which a replicating (DP) device must
    hold (``tet_row_pk`` is a view of ``tet_row_pk32`` and not counted)."""
    total = 0
    for f in dataclasses.fields(tet_mesh):
        v = getattr(tet_mesh, f.name)
        if torch.is_tensor(v) and f.name != "tet_row_pk":
            total += int(np.prod(v.shape)) * v.element_size()
    return total


def particle_working_bytes(n: int, itemsize: int = 4) -> int:
    """Per-particle engine working set: mega rows (32-40 columns) double-
    buffered through the cycle + the unpacked state arrays."""
    return n * itemsize * (40 * 2 + 14)


def choose_strategy(tet_mesh: TetMesh, n_particles: int, n_devices: int,
                    hbm_bytes: float | None = None, headroom: float = 0.6) -> str:
    """Pick single / dp / partitioned from the memory model: DP replicates
    the mesh, viable iff ``mesh_bytes + particle_share <= headroom * HBM``;
    otherwise the mesh must be partitioned.  One device always runs
    ``single``."""
    if n_devices <= 1:
        return "single"
    hbm = hbm_bytes if hbm_bytes is not None else device_hbm_bytes(device=tet_mesh.device)
    share = particle_working_bytes(-(-n_particles // n_devices))
    if mesh_table_bytes(tet_mesh) + share <= headroom * hbm:
        return "dp"
    return "partitioned"


def partition_layout(cfg: StepConfig, tet_mesh: TetMesh) -> str:
    """The partition layout of a configuration: "cx" (ConvexPoly), "pk"
    (VertexVelocity) or "tet"."""
    if cfg.locate_mode == "convex":
        if tet_mesh.tet_row_cx is None:
            raise ValueError("partitioned convex mode needs with_convex_rows(mesh)")
        return "cx"
    if cfg.velocity_interp == advect_ops.VERTEX_VELOCITY:
        return "pk"
    return "tet"


class ParticleEngine:
    """One stepping interface over the three strategies.

    ``advance(n_cycles, dt)`` runs sub-steps; ``snapshot()`` returns the
    state in the original particle order and count (the partitioned
    strategy settles pending migration hand-offs first, so that snapshots
    match the single-device trajectory).  The data-parallel shards keep
    their packed state from one ``advance`` to the next, and so do the
    partitioned shards (the mega-resident runner), except under ConvexPoly,
    which steps its slot arrays.

    The partitioned strategy draws Brownian noise keyed by (seed, step,
    global particle id) whatever ``cfg.brownian_rng`` says (so does JAX's):
    row pid of the "rbg" Philox stream, so a particle's noise is that of a
    single-device run under ``brownian_rng="rbg"``, whatever its shard and
    migrations.  DP keeps ``rbg_kernel`` on the lane-offset route."""

    def __init__(self, tet_mesh: TetMesh, state: ParticleState, cfg: StepConfig,
                 devices: int | None = None, strategy: str = "auto",
                 hbm_bytes: float | None = None, log=print):
        self.cfg = cfg
        self._orig_n = state.n_particles
        self._device = state.device
        n_dev = devices if devices is not None else 1
        if strategy == "auto":
            strategy = choose_strategy(tet_mesh, state.n_particles, n_dev, hbm_bytes)
        if strategy == "dp" and n_dev <= 1:
            strategy = "single"
        if strategy not in ("single", "dp", "partitioned"):
            raise ValueError(f"unknown strategy {strategy!r}")
        self.strategy = strategy
        self.devices = ([state.device] if strategy == "single"
                        else sharding.make_device_mesh(n_dev, state.device))
        log(f"#adv: engine strategy={strategy} devices=[{sharding.placement(self.devices)}] "
            f"(mesh tables {mesh_table_bytes(tet_mesh) / 2**20:.0f}MB)")
        if strategy == "single":
            self.mesh, self.state = tet_mesh, state
        elif strategy == "dp":
            meshes = sharding.replicate_mesh(tet_mesh, self.devices)
            self._dp = sharding.DataParallelRun(
                meshes, sharding.shard_state(state, self.devices), cfg,
                lane_offsets=cfg.brownian_rng == "rbg_kernel")
        else:
            layout = partition_layout(cfg, tet_mesh)
            S = len(self.devices)
            pm = partition.partition_mesh(tet_mesh, S, layout=layout)
            sp = partition.distribute_particles(pm, state.pos, state.vel, state.tet_id,
                                                state.active, seed=state.seed, step=state.step)
            self._pm, self._sp = partition.shard_arrays(pm, sp, self.devices)
            self._step = partition.make_partitioned_step(self._pm, cfg, self.devices)
            self._settle = partition.make_settle_step(self._pm, cfg, self.devices)
            self._mega = None        # the resident shards (partition.MegaShards)
            self._migrated = self._deferred = 0
            self._settle_rounds = 0  # extra settle migrations (partition.MegaShards)

    @property
    def supports_injection(self) -> bool:
        return True

    def _slots(self) -> partition.ShardedParticles:
        """The partitioned slot arrays, decoded from the resident shards."""
        if self._mega is not None:
            self._sp = self._mega.decode()
        return self._sp

    def set_state(self, state: ParticleState) -> None:
        """Replace the particle state (injection): single assigns, DP
        re-shards, partitioned re-distributes into the existing per-shard
        slots (same capacity; streams are keyed by (step, pid), so surviving
        particles keep their noise)."""
        if self.strategy == "single":
            self.state = state
        elif self.strategy == "dp":
            self._dp = sharding.DataParallelRun(
                [run.mesh for run in self._dp.runs], sharding.shard_state(state, self.devices),
                self.cfg, lane_offsets=self._dp.lane_offsets)
        else:
            sp = partition.distribute_particles(
                self._pm, state.pos, state.vel, state.tet_id, state.active, seed=state.seed,
                capacity=self._sp.capacity, step=state.step)
            _, self._sp = partition.shard_arrays(self._pm, sp, self.devices)
            self._mega = None

    def update_from_case(self, case, geometry: bool = False) -> None:
        """Take the case mesh's new velocities (or, with ``geometry``, its
        moved geometry): the multi-device form of the per-Eulerian-step
        ``cudaUpdateVelocity`` upload (``advect.H:44-83``)."""
        tm = case.tet_mesh
        if self.strategy == "single":
            self.mesh = tm
        elif self.strategy == "dp":
            self._dp.set_meshes(sharding.replicate_mesh(tm, self.devices))
        else:
            sp = self._slots()
            if geometry:
                pm = partition.refresh_geometry(self._pm, tm)
            else:
                pm = partition.update_velocity(self._pm, tm.tet_vel, vert_vel=tm.vert_vel,
                                               tets=tm.tets)
            self._pm = pm
            self._sp, self._mega = sp, None      # re-encoded against the new rows

    @property
    def migration_stats(self) -> dict:
        if self.strategy != "partitioned":
            return {}
        return {"migrated": int(self._migrated), "deferred": int(self._deferred),
                "settle_rounds": self._settle_rounds}

    def advance(self, n_cycles: int, dt) -> None:
        if self.strategy == "partitioned":
            if self._pm.layout == "cx":
                for _ in range(n_cycles):
                    self._sp, stats = self._step(self._pm, self._sp, dt)
                    self._migrated = self._migrated + stats["migrated"]
                    self._deferred = self._deferred + stats["deferred"]
                return
            if self._mega is None:
                self._mega = partition.MegaShards(self._pm, self.cfg, self.devices, self._sp)
            stats = self._mega.cycles(n_cycles, dt)
            # kept on the device, so that advance issues without a host sync
            self._migrated = self._migrated + stats["migrated"]
            self._deferred = self._deferred + stats["deferred"]
            self._settle_rounds += stats["settle_rounds"]
            return
        if self.strategy == "dp":
            self._dp.advance(n_cycles, dt)
            return
        self.state = run_cycles(self.mesh, self.state, self.cfg, n_cycles, dt)

    def snapshot(self) -> ParticleState:
        """The state in the original particle order and count, on the
        device the engine was given."""
        dev = self._device
        if self.strategy == "partitioned":
            sp = self._slots()
            settled, _ = self._settle(self._pm, sp, 0.0)
            pos, vel, tet, act = partition.collect_particles(self._pm, settled, self._orig_n)
            T = sp.pos[0].dtype
            return ParticleState(
                pos=torch.as_tensor(pos, dtype=T, device=dev),
                vel=torch.as_tensor(vel, dtype=T, device=dev),
                disp=torch.zeros((self._orig_n, 3), dtype=T, device=dev),
                tet_id=torch.as_tensor(tet, device=dev),
                active=torch.as_tensor(act, device=dev),
                seed=sp.seed,
                # the settle pass is bookkeeping, not a sub-step: the
                # pre-settle cycle counter (injection keys its draw off it)
                step=sp.step)
        if self.strategy == "single":
            return self.state
        shards = self._dp.states()
        n = self._orig_n
        st = shards[0]
        return dataclasses.replace(
            st, pos=torch.cat([s.pos.to(dev) for s in shards])[:n],
            vel=torch.cat([s.vel.to(dev) for s in shards])[:n],
            disp=torch.cat([s.disp.to(dev) for s in shards])[:n],
            tet_id=torch.cat([s.tet_id.to(dev) for s in shards])[:n],
            active=torch.cat([s.active.to(dev) for s in shards])[:n])

    def block(self) -> None:
        """Wait for every device of the engine."""
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
