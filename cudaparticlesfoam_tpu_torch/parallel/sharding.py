"""Particle data parallelism (port of ``cudaparticlesfoam_tpu/parallel/sharding.py``).

Particles are independent: split them into S shards, replicate the tet
mesh on each shard's device, and step every shard with the single-device
cached engine.  No communication per step; diagnostics sum over shards.

Noise keeps the JAX package's two routes:

* :func:`run_cycles_sharded` (threefry, "rbg"; JAX's GSPMD program, which
  draws the noise over the padded global array): the noise of each cycle
  is drawn once over the padded ``n`` (``fused._brownian_noise``) and
  sliced per shard, so the run equals a single-device run of the padded
  state bit for bit.
* :func:`run_cycles_dp_shardmap` (JAX's ``shard_map`` route, taken under
  ``brownian_rng="rbg_kernel"``): shard ``s`` keys its Philox stream with
  ``lane_offset = s * n_pad`` (``n_pad`` the shard's lane count rounded up
  to 8,192, JAX's ``PACK_LANES``), so the streams are disjoint and each
  shard equals a single-device run of its slice with that offset; the
  stream kernels draw it in the kernel.

Each shard's cycles run through ``stepper.PackedRun``, so on the card
``stream_kernel`` and ``rare_kernel`` launch once per shard per sub-step.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..dtypes import canonical_device
from ..mesh import TetMesh, to_device
from ..ops import fused
from ..state import ParticleState
from ..stepper import PackedRun, StepConfig


def make_device_mesh(n_devices: int | None = None, device=None) -> list[torch.device]:
    """The devices of ``n_devices`` shards (default: one per visible card):
    on CUDA (``device`` None or a CUDA device) shard ``s`` takes card
    ``s % torch.cuda.device_count()``, so more shards than cards share
    them in turn; on the CPU every shard is ``cpu``.  Never falls back to
    the CPU."""
    base = canonical_device(device)
    if base.type == "cpu":
        return [torch.device("cpu")] * max(int(n_devices or 1), 1)
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError(f"no visible CUDA device for {base}: pass device='cpu' for CPU "
                           "shards")
    n = count if n_devices is None else max(int(n_devices), 1)
    return [torch.device("cuda", s % count) for s in range(n)]


def placement(devices) -> str:
    """``cuda:0 x4``, or ``cuda:0 x2, cuda:1 x2``: each device and its shards."""
    out = []
    for d in devices:
        if out and out[-1][0] == d:
            out[-1][1] += 1
        else:
            out.append([d, 1])
    return ", ".join(f"{d} x{k}" for d, k in out)


def on_device(dev):
    """The context a shard's launches run in: ``torch.cuda.device(dev)``
    on a card (the kernel wrappers check it), nothing on the CPU."""
    dev = torch.device(dev)
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def pad_particles(state: ParticleState, multiple: int) -> ParticleState:
    """Pad the particle arrays to a multiple of the shard count; padded
    lanes are inactive with tet_id = -1 (dead particles)."""
    n = state.n_particles
    pad = -(-n // multiple) * multiple - n
    if pad == 0:
        return state

    def pad_arr(x, fill):
        return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                                        device=x.device)])

    return dataclasses.replace(
        state, pos=pad_arr(state.pos, 0.0), vel=pad_arr(state.vel, 0.0),
        disp=pad_arr(state.disp, 0.0), tet_id=pad_arr(state.tet_id, -1),
        active=pad_arr(state.active, False))


def shard_state(state: ParticleState, devices) -> list[ParticleState]:
    """The padded state split into ``len(devices)`` equal shards, shard
    ``s`` on ``devices[s]``; each carries the run's seed and step."""
    S = len(devices)
    state = pad_particles(state, S)
    n_local = state.n_particles // S
    out = []
    for s, dev in enumerate(devices):
        sl = slice(s * n_local, (s + 1) * n_local)
        out.append(dataclasses.replace(
            state, pos=state.pos[sl].to(dev), vel=state.vel[sl].to(dev),
            disp=state.disp[sl].to(dev), tet_id=state.tet_id[sl].to(dev),
            active=state.active[sl].to(dev)))
    return out


def replicate_mesh(tet_mesh: TetMesh, devices) -> list[TetMesh]:
    """The mesh of every shard: one copy per distinct device."""
    copies = {dev: to_device(tet_mesh, dev) for dev in dict.fromkeys(devices)}
    return [copies[dev] for dev in devices]


class _GlobalNoise:
    """Shard ``[lo, hi)``'s rows of the noise drawn over the padded global
    lane count: ``noise[i : i + c]`` of cycles i.. of the current group
    (JAX's GSPMD noise is one logical sharded array)."""

    def __init__(self, draws, lo, hi, dev):
        self.draws, self.lo, self.hi, self.dev = draws, lo, hi, dev

    def __getitem__(self, i):
        return self.draws[i][..., self.lo:self.hi, :].to(self.dev).contiguous()


class DataParallelRun:
    """The shards of a data-parallel run, each a ``stepper.PackedRun`` on
    its device, kept packed from one :meth:`advance` to the next.
    ``lane_offsets``: the ``shard_map`` route (:func:`run_cycles_dp_shardmap`);
    else the global-noise route (:func:`run_cycles_sharded`)."""

    def __init__(self, meshes, shards, cfg: StepConfig, lane_offsets: bool = False):
        self.cfg, self.lane_offsets = cfg, bool(lane_offsets)
        self.devices = [st.device for st in shards]
        self.n_local = shards[0].n_particles
        self.n_total = self.n_local * len(shards)
        self.seed, self.step = shards[0].seed, shards[0].step
        self.runs = []
        for mesh, st in zip(meshes, shards):
            with on_device(st.device):
                self.runs.append(PackedRun(mesh, st, cfg))

    def set_meshes(self, meshes) -> None:
        """Continue on new replicated meshes (a velocity or geometry refresh)."""
        for run, mesh, dev in zip(self.runs, meshes, self.devices):
            with on_device(dev):
                run.set_mesh(mesh)

    def advance(self, n_cycles: int, dt) -> None:
        cfg = self.cfg
        if self.lane_offsets or not cfg.use_brownian:
            # JAX's shard_map route: per-shard lane offsets, no global draw
            n_pad = self.n_local + (-self.n_local) % fused._PACK_LANES
            for s, (run, dev) in enumerate(zip(self.runs, self.devices)):
                with on_device(dev):
                    run.advance(n_cycles, dt, lane_offset0=s * n_pad if self.lane_offsets else 0)
        else:
            # one draw over the padded global lanes per sub-step, sliced;
            # a macro cycle's sub-steps are drawn together
            k = cfg.macro_cycles if self.runs[0].macro else 1
            dev0, T = self.devices[0], self.runs[0].template.dtype
            for i0 in range(0, n_cycles, k):
                c = min(k, n_cycles - i0)
                draws = torch.stack([fused._brownian_noise(self.seed, self.step + i0 + j,
                                                           self.n_total, T, dev0,
                                                           cfg.brownian_rng)
                                     for j in range(c)])
                for s, (run, dev) in enumerate(zip(self.runs, self.devices)):
                    lo = s * self.n_local
                    with on_device(dev):
                        run.advance(c, dt, noise=_GlobalNoise(draws, lo, lo + self.n_local,
                                                              dev))
        self.step += n_cycles

    def states(self) -> list[ParticleState]:
        out = []
        for run, dev in zip(self.runs, self.devices):
            with on_device(dev):
                out.append(run.result())
        return out


def run_cycles_sharded(meshes, shards, cfg: StepConfig, n_cycles: int,
                       dt=None) -> list[ParticleState]:
    """``stepper.run_cycles`` on every shard (:func:`shard_state`), the
    noise of each sub-step drawn over the padded global lanes and sliced,
    so the shards together equal a single-device run of the padded state
    bit for bit (JAX: the same program, GSPMD-partitioned)."""
    run = DataParallelRun(meshes, shards, cfg)
    run.advance(n_cycles, cfg.dt if dt is None else dt)
    return run.states()


def run_cycles_dp_shardmap(devices, meshes, shards, cfg: StepConfig, n_cycles: int,
                           dt=None) -> list[ParticleState]:
    """:func:`run_cycles_sharded` on JAX's ``shard_map`` route, the one it
    takes under ``brownian_rng="rbg_kernel"``: shard ``s`` keys its Philox
    stream with ``lane_offset0 = s * n_pad`` (the shard's lanes rounded up
    to 8,192), so the in-kernel streams are disjoint and each shard equals
    a single-device run of its slice with that offset."""
    if [st.device for st in shards] != [torch.device(d) for d in devices]:
        raise ValueError("the shards must lie on the devices given, in order")
    run = DataParallelRun(meshes, shards, cfg, lane_offsets=True)
    run.advance(n_cycles, cfg.dt if dt is None else dt)
    return run.states()


def global_diagnostics(shards) -> dict:
    """Sums over the shards (the psum of JAX's diagnostics; the reference's
    count_if + KE print, ``particles.cu:763-775``, ``utils.cpp:258``), on
    the first shard's device."""
    dev = shards[0].device
    return {
        "out_of_domain": sum(int((st.tet_id < 0).sum()) for st in shards),
        "active": sum(int(st.active.sum()) for st in shards),
        "kinetic_energy": sum(
            (0.5 * (st.vel * st.vel).sum()).to(dev) for st in shards),
    }


def distribute(tet_mesh: TetMesh, state: ParticleState, n_devices: int | None = None):
    """One-call set-up: (devices, replicated meshes, shards)."""
    devices = make_device_mesh(n_devices, state.device)
    return devices, replicate_mesh(tet_mesh, devices), shard_state(state, devices)
