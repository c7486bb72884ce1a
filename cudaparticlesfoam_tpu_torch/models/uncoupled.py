"""Uncoupled (frozen-field) particle tracking driver.

The equivalent of ``cudaParticlesUncoupledFoam``
(``applications/cudaParticlesUncoupledFoam/cudaParticlesUncoupledFoam.C:60-89``):
read the latest converged ``U``, build the tet mesh + particle state, then
run ``nCycles = ceil(deltaT/dt)`` Lagrangian sub-steps of the frozen field
in one shot (``advect.H`` included once, no time loop).

The port's copy of ``cudaparticlesfoam_tpu/models/uncoupled.py`` (default
on the card).  Each chunk of cycles between two VTU writes is one
:func:`~cudaparticlesfoam_tpu_torch.stepper.run_cycles` call, which on the
card launches the stream and rare kernels of every cycle with no host
synchronisation; the host waits only for the frame copies (every
``saveInterval`` cycles) and the single scalar readbacks the JAX driver
also takes (seeding, injection, the final report).  With ``devices`` or a
``strategy`` other than auto, the chunks run on a
:class:`~cudaparticlesfoam_tpu_torch.parallel.auto.ParticleEngine`
(particle data parallelism or the partitioned mesh), as in the JAX driver.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..dtypes import run_device
from ..io import vtu
from ..ops import advect as advect_ops
from ..stepper import n_cycles_for, run_cycles, suggest_tuning
from ..utils.profiling import PhaseTimer, device_trace
from . import case as caselib

# the CUDA wrappers a run of the cached engine can launch (ops/fused_cuda.py)
_KERNEL_WRAPPERS = ("stream_cycle", "stream_crossers", "hop_admit", "macro_stream",
                    "macro_crossers", "rare_resolve", "convex_stream_cycle",
                    "convex_stream_crossers", "convex_rare_resolve")


STRATEGIES = ("auto", "single", "dp", "partitioned")


def check_single_device(devices=None, strategy="auto", flow_devices=None) -> None:
    """Check a request's multi-device knobs: ``strategy`` must be one of
    :data:`STRATEGIES`, and ``devices`` / ``flow_devices`` at least 1
    (``ValueError``).  Every particle strategy runs
    (``parallel.auto.ParticleEngine``), and ``flow_devices > 1`` runs the
    domain-decomposed flow solve (``parallel.flowshard.ShardedFlowSolver``,
    in the coupled driver)."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}, expected one of {STRATEGIES}")
    if devices is not None and devices < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    if flow_devices is not None and flow_devices < 1:
        raise ValueError(f"flow_devices must be >= 1, got {flow_devices}")


def write_schedule(n_cycles: int, save_interval: int):
    """Cycle indices after which a VTU frame is written, and the frame id.

    Matches ``advect.H:166-169``: after cycle i (0-based), write frame i+1
    iff i % saveInterval == 0.
    """
    return [(i, i + 1) for i in range(0, n_cycles, save_interval)]


def make_engine(tet_mesh, state, cfg, devices, strategy, log):
    """A :class:`~cudaparticlesfoam_tpu_torch.parallel.auto.ParticleEngine`
    when the request asks for one (``devices`` given, a strategy other than
    auto, or more than one visible card), else None: the plain
    single-device path with no wrapper (JAX ``_make_engine``)."""
    if devices is not None:
        n_dev = devices
    elif state.device.type == "cuda":
        n_dev = torch.cuda.device_count()
    else:
        n_dev = 1
    if strategy == "auto" and n_dev <= 1 and devices is None:
        return None
    from ..parallel.auto import ParticleEngine

    return ParticleEngine(tet_mesh, state, cfg, devices=n_dev, strategy=strategy, log=log)


def _launch_counts() -> dict:
    """Launches by wrapper, and of those of ``rare_resolve`` the remote
    (partitioned) instantiations' as ``rare_resolve_remote``."""
    from ..ops import fused_cuda

    counts = {name: getattr(fused_cuda, name).launches for name in _KERNEL_WRAPPERS}
    counts["rare_resolve_remote"] = fused_cuda.rare_resolve.remote_launches
    return counts


def run(
    case_dir: str,
    out_dir: str | None = None,
    write_output: bool = True,
    dtype=None,
    log=print,
    trajectories: bool | None = None,
    profile_dir: str | None = None,
    devices: int | None = None,
    strategy: str = "auto",
    device=None,
):
    """Run the uncoupled case end-to-end on ``device`` (default the card;
    ``"cpu"`` runs the kernels' plain versions).  Returns (case,
    final_state, stats).

    ``stats``: ``frames`` (paths), ``cycles``, ``wall_s`` (the advect loop
    with its frame writes; on the card between two CUDA events),
    ``phases`` (seconds per phase; on the card the device's spans),
    ``host_phases`` (the host's clock: on the card the time to issue), and
    on the card ``launches`` (kernel launches of the loop, by wrapper) and
    ``peak_bytes`` (peak device memory of the run).  ``devices`` /
    ``strategy`` are the JAX driver's: with either, the cycles run on a
    ``ParticleEngine`` (:func:`make_engine`; on the card S shards share
    the visible cards in turn), whose launches the counts include; with the
    partitioned strategy ``stats`` also has ``migration`` (migrated and
    deferred lanes).
    """
    check_single_device(devices, strategy)
    device = run_device(device)
    cuda = device.type == "cuda"
    timer = PhaseTimer(device)
    with timer.phase("Init"):
        case = caselib.load_case(case_dir, dtype=dtype, log=log, device=device)
    pcfg = case.particles
    ctrl = case.control
    out_dir = out_dir or case_dir

    t = case.time_value
    with timer.phase("Seed"):
        state = caselib.init_particles(case, log=log)
    cfg = suggest_tuning(case.tet_mesh, pcfg.step_config(), n_particles=state.n_particles)
    if cfg.locate_mode == "convex":
        from ..mesh import with_convex_rows

        case.tet_mesh = with_convex_rows(case.tet_mesh)
    elif cfg.velocity_interp == advect_ops.VERTEX_VELOCITY and cuda:
        # on the CPU the run takes the simple engine, as the JAX driver's
        # does (no Pk table); on the card run_cycles would raise without one
        from ..mesh import with_pk_rows

        case.tet_mesh = with_pk_rows(case.tet_mesh)

    # warm-up advect: initCuda.H:184-199 computes vel/disp once (no move)
    # so frame 0 carries velocities; reproduce via the advect op alone.
    disp0, vel0, act0 = advect_ops.advect(
        case.tet_mesh, state.pos, state.vel, state.tet_id, state.active,
        pcfg.dt, cfg.velocity_interp,
    )
    state = dataclasses.replace(state, vel=vel0, disp=disp0, active=act0)

    track = vtu.Trajectories(state.n_particles) if (
        trajectories if trajectories is not None else pcfg.save_streamlines
    ) else None

    # ConvexPoly builds write an extra ConvexTetID column (utils.cpp:216-228)
    convex_ids = (lambda st: st.tet_id) if cfg.locate_mode == "convex" else (lambda st: None)

    stats = {"frames": [], "cycles": 0, "wall_s": 0.0}
    writer = vtu.AsyncVTUWriter()   # formatting/IO overlaps device compute
    if write_output:
        with timer.phase("IO"):
            path = writer.write(
                0, state, convex_tet_id=convex_ids(state), out_dir=out_dir, verbose=True,
            )
        stats["frames"].append(path)

    if not (pcfg.start_time <= t <= pcfg.end_time):
        log(
            f"#adv: time {t} outside particle window "
            f"[{pcfg.start_time}, {pcfg.end_time}]; nothing to do (advect.H:33)"
        )
        writer.close()
        return case, state, stats

    n_cycles, cycle_dt = n_cycles_for(ctrl.delta_t, pcfg.dt)
    log(f"dtE:{ctrl.delta_t} dtL: {pcfg.dt}")
    log(f"nCycles: {n_cycles} cycleDt: {cycle_dt}")

    # clear the warm-up displacement before the real loop (the reference's
    # first cudaAdvect overwrite does this implicitly, particles.cu:362)
    state = dataclasses.replace(state, disp=torch.zeros_like(state.disp))
    engine = make_engine(case.tet_mesh, state, cfg, devices, strategy, log)

    launches0 = _launch_counts() if cuda else None
    wall0 = time.perf_counter()
    if cuda:
        ev0 = torch.cuda.Event(enable_timing=True)
        ev0.record(torch.cuda.current_stream(device))
    with device_trace(profile_dir, device):
        inj_active = pcfg.injection_interval > 0
        i = 0
        while i < n_cycles:
            # run up to the next write boundary in one run_cycles call
            if i % pcfg.save_interval == 0:
                chunk = 1
            else:
                next_write = ((i // pcfg.save_interval) + 1) * pcfg.save_interval
                chunk = min(next_write, n_cycles) - i
            if inj_active:
                # break chunks at injection boundaries too, so every
                # multiple of injectionInterval is a chunk start
                inj = pcfg.injection_interval
                chunk = min(chunk, ((i // inj) + 1) * inj - i)
            with timer.phase("Advect"):
                if engine is None:
                    # the stepper updates its mega array in place and returns
                    # fresh state tensors (the JAX driver donates the state)
                    state = run_cycles(case.tet_mesh, state, cfg, chunk, cycle_dt)
                else:
                    engine.advance(chunk, cycle_dt)
            prev = i
            i += chunk
            if inj_active and prev % pcfg.injection_interval == 0:
                from .. import state as statelib

                if engine is not None:
                    # the host-ordered unpadded view: padding slots must not
                    # pass for dead, injectable particles
                    state = engine.snapshot()
                state, n_inj = statelib.inject(
                    state, case.tet_mesh, case.locator,
                    pcfg.seeding_box_lo, pcfg.seeding_box_hi,
                    pcfg.injection_count, rng_seed=pcfg.rng_seed,
                )
                if engine is not None:
                    engine.set_state(state)
                if n_inj:
                    log(f"#adv: injected {n_inj} particles at step {prev}")
            if prev % pcfg.save_interval == 0:
                if engine is not None and (track is not None or write_output):
                    state = engine.snapshot()
                if track is not None:
                    track.append(state)
                if write_output:
                    with timer.phase("IO"):
                        path = writer.write(
                            prev + 1, state, convex_tet_id=convex_ids(state),
                            out_dir=out_dir, verbose=True,
                        )
                    stats["frames"].append(path)
        if engine is not None:
            engine.block()
            state = engine.snapshot()
            stats["migration"] = engine.migration_stats
        with timer.phase("IO"):
            writer.close()
    if cuda:
        ev1 = torch.cuda.Event(enable_timing=True)
        ev1.record(torch.cuda.current_stream(device))
        ev1.synchronize()
        stats["wall_s"] = ev0.elapsed_time(ev1) * 1e-3
        stats["launches"] = {k: v - launches0[k] for k, v in _launch_counts().items()}
        stats["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    else:
        stats["wall_s"] = time.perf_counter() - wall0
    stats["cycles"] = n_cycles
    rate = state.n_particles * n_cycles / max(stats["wall_s"], 1e-12)
    log(
        f"#adv: Simulation RunTime={stats['wall_s']*1e3:.1f} ms "
        f"({rate/1e6:.2f}M particle-steps/s)"
    )
    timer.report(log=log)
    stats["phases"] = dict(timer.totals)
    stats["host_phases"] = dict(timer.host)
    if cuda:
        ran = {k: v for k, v in stats["launches"].items() if v}
        log(f"#adv: on {torch.cuda.get_device_name(device)}: Advect "
            f"{stats['phases']['Advect'] / n_cycles * 1e3:.4f} ms/cycle on the device, "
            f"{stats['host_phases']['Advect'] / n_cycles * 1e3:.4f} ms/cycle to issue; "
            f"kernel launches {ran}; peak device memory {stats['peak_bytes'] / 2**30:.3f} GiB")
    if track is not None:
        track.save_vtk(f"{out_dir}/Streamline.vtk")
    return case, state, stats
