"""Coupled / transient particle tracking drivers.

The port of ``cudaparticlesfoam_tpu/models/coupled.py``, on one device
(default the card).  Two modes mirroring ``cudaParticlesPimpleFoam``
(``applications/cudaParticlesPimpleFoam/cudaParticlesPimpleFoam.C:131-192``):

* :func:`run_replay` — re-reads recorded ``U`` snapshots from the case's
  time directories and advances particles between them: each Eulerian
  interval gets ``nCycles = ceil(deltaT/dt)`` sub-steps with the fresh
  field (``src/advect.H:36-83``), and the global ``step`` counter persists
  across intervals like the reference's file numbering.
* :func:`run_coupled` — drives the PIMPLE flow solver (:mod:`.pimple`) and
  advects particles after every Eulerian step, the full equivalent of the
  reference solver; with a ``dynamicMeshDict`` the particle walk tables
  follow the moving mesh (:func:`~cudaparticlesfoam_tpu_torch.mesh.refresh_geometry`).

Each Eulerian step hands the new cell velocity to the particle tables as
JAX does: ``FlowSolver.cell_velocity`` copies U to the host and
``Case.update_velocity`` rebuilds the host row table and uploads it
(``mesh.replace_velocity``); the chunks of cycles between frames then run
the stream and rare kernels on the card (``stepper.run_cycles``).  With
``devices`` or a ``strategy`` other than auto the particles run on a
``parallel.auto.ParticleEngine`` (data parallelism or the partitioned
mesh), which takes each new field (``update_from_case``) as JAX's does.
With ``flow_devices > 1`` the flow runs domain-decomposed over that many
shards (``parallel.flowshard.ShardedFlowSolver``, the reference's
``Allrun-parallel``), as JAX's ``--flow-devices``.
"""

from __future__ import annotations

import os
import time

import torch

from ..dtypes import run_device
from ..io import vtu
from ..parallel.flowshard import ShardedFlowSolver, halo_refresh
from ..stepper import n_cycles_for, run_cycles, suggest_tuning
from ..utils.profiling import PhaseTimer
from . import case as caselib
from .uncoupled import _launch_counts, check_single_device, make_engine


def _advance_interval(case, state, cfg, pcfg, delta_t, step0, out_dir, writer, log,
                      timer=None, engine=None):
    """One Eulerian interval: sub-cycle with VTU writes on the reference's
    step schedule (``advect.H:86-184``) through ``writer`` (an
    :class:`~cudaparticlesfoam_tpu_torch.io.vtu.AsyncVTUWriter`; None
    writes no frame).  Returns (state, next step0).  ``timer`` (a
    :class:`PhaseTimer`), when given, times the chunks of cycles as
    "Advect" and the frame writes as "IO".  With ``engine`` (a
    ``ParticleEngine``) the sub-steps run on it, after it takes the case
    mesh's new field."""
    n_cycles, cycle_dt = n_cycles_for(delta_t, pcfg.dt)
    log(f"dtE:{delta_t} dtL: {pcfg.dt}")
    log(f"nCycles: {n_cycles} cycleDt: {cycle_dt}")
    timer = timer or PhaseTimer()
    if engine is not None:
        engine.update_from_case(case)    # the fresh U into the engine's tables
    i = 0
    while i < n_cycles:
        step = step0 + i
        if step % pcfg.save_interval == 0:
            chunk = 1
        else:
            next_write = ((step // pcfg.save_interval) + 1) * pcfg.save_interval
            chunk = min(next_write - step0, n_cycles) - i
        with timer.phase("Advect"):
            if engine is None:
                state = run_cycles(case.tet_mesh, state, cfg, chunk, cycle_dt)
            else:
                engine.advance(chunk, cycle_dt)
        prev = step
        i += chunk
        if writer is not None and prev % pcfg.save_interval == 0:
            if engine is not None:
                state = engine.snapshot()
            with timer.phase("IO"):
                writer.write(prev + 1, state, out_dir=out_dir, verbose=True)
    if engine is not None:
        state = engine.snapshot()
    return state, step0 + n_cycles


def _load(case_dir, dtype, log, device):
    """(case, step config) with the tables suggest_tuning's choice needs."""
    case = caselib.load_case(case_dir, dtype=dtype, log=log, device=device)
    pcfg = case.particles
    cfg = suggest_tuning(case.tet_mesh, pcfg.step_config(), n_particles=pcfg.num_particles)
    if cfg.locate_mode == "convex":
        from ..mesh import with_convex_rows

        case.tet_mesh = with_convex_rows(case.tet_mesh)
    return case, cfg


def run_replay(case_dir: str, out_dir: str | None = None, write_output: bool = True,
               dtype=None, log=print, devices: int | None = None, strategy: str = "auto",
               device=None):
    """Advance particles over the case's recorded U snapshots on ``device``
    (default the card); ``devices`` / ``strategy`` as in
    ``uncoupled.run``.  Returns (case, state, {"cycles", "wall_s"})."""
    check_single_device(devices, strategy)
    device = run_device(device)
    case, cfg = _load(case_dir, dtype, log, device)
    pcfg = case.particles
    out_dir = out_dir or case_dir
    tdirs = caselib.time_dirs(case_dir)
    # start at the first snapshot; advance between consecutive snapshots
    state = caselib.init_particles(case, log=log)
    engine = make_engine(case.tet_mesh, state, cfg, devices, strategy, log)
    writer = vtu.AsyncVTUWriter() if write_output else None
    if writer is not None:
        writer.write(0, state, out_dir=out_dir, verbose=True)
    step0 = 0
    wall0 = time.perf_counter()
    n_total = 0
    for (t_prev, _), (t_next, d_next) in zip(tdirs[:-1], tdirs[1:]):
        # an interval replays only if the particle window was already open at
        # its start: before that, advect.H:33 would have been a no-op every
        # Eulerian step, so the particles idle at their seeds
        if t_prev < pcfg.start_time - 1e-12 or t_next > pcfg.end_time + 1e-12:
            continue
        u = caselib.read_u_snapshot(case_dir, d_next, case.poly.n_cells)
        if u is None:
            continue
        case.update_velocity(u)  # advect.H:44-83
        state, step0 = _advance_interval(case, state, cfg, pcfg, t_next - t_prev, step0,
                                         out_dir, writer, log, engine=engine)
        n_total = step0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if writer is not None:
        writer.close()
    wall = time.perf_counter() - wall0
    if n_total:
        rate = state.n_particles * n_total / max(wall, 1e-12)
        log(f"#adv: Simulation RunTime={wall*1e3:.1f} ms ({rate/1e6:.2f}M particle-steps/s)")
    return case, state, {"cycles": n_total, "wall_s": wall}


def _function_objects(case_dir, flow, log):
    """(probes, scalarTransport) from controlDict's functions
    (``TJunction/system/controlDict:53-133``)."""
    from ..io import foamfile
    from . import functions as fo

    fns = foamfile.read(os.path.join(case_dir, "system", "controlDict")).get("functions", {})
    probes = scalar = None
    if isinstance(fns, dict):
        for name, spec in fns.items():
            if not isinstance(spec, dict):
                continue
            if spec.get("type") == "probes" and "probeLocations" in spec:
                probes = fo.Probes(flow.m, spec["probeLocations"], name=str(name))
                log(f"#fo: probes at {len(spec['probeLocations'])} locations")
            if spec.get("type") == "scalarTransport":
                field = str(spec.get("field", "s"))
                su = 0.0
                try:
                    src = spec["fvOptions"]["unitySource"][
                        "scalarSemiImplicitSourceCoeffs"]["injectionRateSuSp"][field]
                    su = float(src[0])
                except (KeyError, TypeError, IndexError):
                    pass
                scalar = fo.ScalarTransport(case_dir, flow.m, field=field,
                                            diffusivity=flow.cfg.nu, source_su=su)
                log(f"#fo: scalarTransport '{field}' (Su={su})")
    return probes, scalar


def _write_closure(flow, tdir, ctrl):
    """The closure fields (k + epsilon or omega) in the time dir, so that
    latestTime restarts resume the closure state too."""
    from ..io import polymesh as pmio
    from . import fv

    bf = {nm: {"type": "calculated"} for nm, *_ in flow.m.patch_slices}
    if hasattr(flow.kes, "eps"):
        fields = (("k", flow.kes.k, -2), ("epsilon", flow.kes.eps, -3))
    else:
        # kOmegaSST: omega has dimensions [0 0 -1]
        fields = (("k", flow.kes.k, -2), ("omega", flow.kes.omega, None))
    for fname, vals, tdim in fields:
        dims = (0, 0, -1, 0, 0, 0, 0) if tdim is None else (0, 2, tdim, 0, 0, 0, 0)
        pmio.write_field(os.path.join(tdir, fname), fname, fv.host(vals), dimensions=dims,
                         boundary_field=bf, binary=ctrl.write_format == "binary",
                         compress=ctrl.write_compression)


def run_coupled(case_dir: str, out_dir: str | None = None, write_output: bool = True,
                dtype=None, log=print, n_steps: int | None = None,
                flow_devices: int | None = None, devices: int | None = None,
                strategy: str = "auto", device=None, flow_dtype=None):
    """Full coupled run on ``device`` (default the card): a PIMPLE flow step
    and the particles' advection after every Eulerian step.

    ``dtype`` sets the particles' float type (default float32).  The flow
    is solved in float32 whatever the particles' type, as in the JAX
    package; ``flow_dtype`` overrides that for parity checks in float64.
    ``flow_devices`` / ``devices`` / ``strategy`` are the JAX driver's
    multi-device knobs: ``devices`` / ``strategy`` run the particles on a
    ``ParticleEngine`` (which on a moving mesh takes each refreshed
    geometry), ``flow_devices > 1`` solves the flow on that many shards
    (``parallel.flowshard.ShardedFlowSolver``, on ``device``'s cards in
    turn: ``cuda:0 x4`` on one card).

    Logs JAX's lines (``Time = ...``, the solver's ``#flow:`` lines,
    ``dtE``/``nCycles``), and per Eulerian step one ``#coupled:`` line:
    dt_e, cycles, the flow step's device and host ms, the CG iterations of
    each pressure solve, continuity, the velocity refresh's ms (copy off
    the device, host row rebuild, upload), Advect ms/cycle on the device and
    to issue, the frames' seconds, and the flow's shards, halo rounds, halo
    refreshes and MB; at the end the init times, kernel
    launches and peak device memory.  Returns (case, state, stats) with
    ``cycles``, ``time``, ``steps`` (the per-step records), ``init`` and, on
    the card, ``launches`` and ``peak_bytes``."""
    from .. import mesh as meshlib
    from . import pimple as pimplelib

    check_single_device(devices, strategy, flow_devices)
    device = run_device(device)
    cuda = device.type == "cuda"
    h0 = time.perf_counter()
    case, cfg = _load(case_dir, dtype, log, device)
    load_s = time.perf_counter() - h0
    pcfg = case.particles
    ctrl = case.control
    out_dir = out_dir or case_dir
    h0 = time.perf_counter()
    if flow_devices is not None and flow_devices > 1:
        flow = ShardedFlowSolver(case, flow_devices, log=log, dtype=flow_dtype, device=device)
        n_shards, halo_rounds = flow_devices, flow.smesh.halo_stats()["rounds"]
    else:
        flow = pimplelib.FlowSolver.from_case(case, log=log, dtype=flow_dtype, device=device)
        n_shards, halo_rounds = 1, 0
    flow_s = time.perf_counter() - h0
    h0 = time.perf_counter()
    state = caselib.init_particles(case, log=log)
    seed_s = time.perf_counter() - h0
    engine = make_engine(case.tet_mesh, state, cfg, devices, strategy, log)
    writer = vtu.AsyncVTUWriter() if write_output else None
    if writer is not None:
        writer.write(0, state, out_dir=out_dir, verbose=True)
    probes, scalar = _function_objects(case_dir, flow, log)
    init = {"load_case_s": load_s, "flow_solver_s": flow_s, "seed_s": seed_s,
            "builder": caselib._builder_flavor(), "n_cells": flow.m.n_cells,
            "n_tets": case.tet_mesh.n_tets, "n_particles": state.n_particles}
    log(f"#coupled: init: load_case {load_s:.2f} s (polyMesh, tet mesh {init['n_tets']} tets, "
        f"tables; host builder {init['builder']}), flow solver {flow_s:.2f} s "
        f"({init['n_cells']} cells), seeding {seed_s:.2f} s ({init['n_particles']} particles)")

    launches0 = _launch_counts() if cuda else None
    t = case.time_value
    step0 = 0
    k = 0
    steps = []
    # runTime.write() schedule (cudaParticlesPimpleFoam.C:189): timeStep
    # counts Eulerian steps; (adjustable)runTime writes every writeInterval
    # seconds, with adjustableRunTime trimming dt to land on write times
    run_time_write = ctrl.write_control in ("runTime", "adjustableRunTime", "adjustable",
                                            "clockTime")
    next_write_t = t + ctrl.write_interval if run_time_write else None
    while t < ctrl.end_time - 1e-12:
        dt_e = flow.stable_dt(ctrl) if ctrl.adjust_time_step else ctrl.delta_t
        dt_e = min(dt_e, ctrl.end_time - t)
        if ctrl.write_control in ("adjustableRunTime", "adjustable"):
            dt_e = min(dt_e, max(next_write_t - t, 1e-12))
        timer = PhaseTimer(device)      # this step's spans
        halo0 = (halo_refresh.calls, halo_refresh.bytes)
        with timer.phase("Flow"):
            res = flow.advance(dt_e)
        halo = (halo_refresh.calls - halo0[0], halo_refresh.bytes - halo0[1])
        cycles = 0
        if flow.dyn is not None:
            # moved mesh: refresh the particle walk tables on the device
            # (topology is motion-invariant; the geometry columns recompute)
            with timer.phase("Geometry"):
                case.tet_mesh = meshlib.refresh_geometry(case.tet_mesh,
                                                         flow.dyn.tet_vertices(flow.m))
                if engine is not None:
                    engine.update_from_case(case, geometry=True)
        t += dt_e
        k += 1
        log(f"Time = {t:g}  (deltaT {dt_e:g})")
        if write_output:
            if run_time_write:
                write_now = t >= next_write_t - 1e-9
                if write_now:
                    next_write_t += ctrl.write_interval
            else:
                write_now = ctrl.write_interval >= 1 and k % int(ctrl.write_interval) == 0
            if write_now:
                from . import simple as simplelib

                tdir = simplelib.write_solution(
                    out_dir, f"{t:g}", flow.m, flow.state,
                    binary=ctrl.write_format == "binary", compress=ctrl.write_compression)
                if flow.kes is not None:
                    _write_closure(flow, tdir, ctrl)
                simplelib.purge_old_times(out_dir, ctrl.purge_write)
        if probes is not None:
            probes.sample(t, {"p": flow.state.p, "U": flow.state.u})
        if scalar is not None:
            scalar.advance(flow.state.flux, dt_e)
        if pcfg.start_time <= t <= pcfg.end_time:
            # the velocity refresh: U off the device, the host row table
            # rebuilt, uploaded (mesh.replace_velocity), as JAX does
            with timer.phase("Refresh"):
                case.update_velocity(flow.cell_velocity())
            step_before = step0
            state, step0 = _advance_interval(case, state, cfg, pcfg, dt_e, step0, out_dir,
                                             writer, log, timer=timer, engine=engine)
            cycles = step0 - step_before
        dev_s, host_s = timer.resolve(), timer.host
        rec = {"dt_e": dt_e, "cycles": cycles, "cg_iterations": list(res["p_iters"]),
               "continuity": flow.last["continuity"], **{
                   f"{k_.lower()}_ms": dev_s.get(k_, 0.0) * 1e3
                   for k_ in ("Flow", "Geometry", "Refresh", "Advect")},
               "flow_host_ms": host_s.get("Flow", 0.0) * 1e3,
               "advect_host_ms": host_s.get("Advect", 0.0) * 1e3,
               "frames_s": host_s.get("IO", 0.0), "flow_shards": n_shards,
               "halo_rounds": halo_rounds, "halo_refreshes": halo[0],
               "halo_mb": halo[1] / 1e6}
        steps.append(rec)
        cyc = max(cycles, 1)
        log(f"#coupled: step {k} t={t:g} dt_e={dt_e:g} cycles={cycles} "
            f"flow_ms={rec['flow_ms']:.3f} flow_host_ms={rec['flow_host_ms']:.3f} "
            f"cg_iterations={rec['cg_iterations']} continuity={rec['continuity']:.3e} "
            f"geometry_ms={rec['geometry_ms']:.3f} refresh_ms={rec['refresh_ms']:.3f} "
            f"advect_ms_per_cycle={rec['advect_ms'] / cyc:.4f} "
            f"advect_issue_ms_per_cycle={rec['advect_host_ms'] / cyc:.4f} "
            f"frames_s={rec['frames_s']:.3f} flow_shards={n_shards} "
            f"halo_rounds={halo_rounds} halo_refreshes={halo[0]} "
            f"halo_MB={rec['halo_mb']:.3f}")
        if n_steps is not None and k >= n_steps:
            break
    if writer is not None:
        writer.close()
    if write_output and probes is not None:
        probes.write(out_dir)
    if write_output and scalar is not None:
        scalar.write(out_dir, f"{t:g}")
    stats = {"cycles": step0, "time": t, "steps": steps, "init": init}
    if cuda:
        stats["launches"] = {k_: v - launches0[k_] for k_, v in _launch_counts().items()}
        stats["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        ran = {k_: v for k_, v in stats["launches"].items() if v}
        log(f"#coupled: on {torch.cuda.get_device_name(device)}: kernel launches {ran}; "
            f"peak device memory {stats['peak_bytes'] / 2**30:.3f} GiB")
    if state.n_particles:
        # an active lane is in the domain when it sits in a tet
        stats["active"] = int(state.active.sum())
        stats["active_in_domain"] = bool((state.tet_id[state.active] >= 0).all())
        log(f"#coupled: {stats['active']} of {state.n_particles} lanes active, every active "
            f"lane in the domain: {int(stats['active_in_domain'])}")
    return case, state, stats
