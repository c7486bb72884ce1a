"""Plain reference of a coupled Eulerian step of ``cudaParticlesPimpleFoam``
(``cudaParticlesPimpleFoam.C:131-192``, ``src/advect.H``), for the coupled
cell: the PIMPLE flow step, the function objects, the velocity refresh of
the particles' tet table, and the interval's sub-steps.

Plain PyTorch and NumPy, float32 on the given device; no matrix product is
taken, so TF32 never enters.  It imports nothing of the program and takes
nothing it made: the mesh is its own blockMesh, the tets its own
decomposition (:mod:`.tetmesh`), the table its own (:mod:`.particles`), the
flow its own solver (:mod:`.flow.pimple`), the function objects its own
(:mod:`.functions`).  The mesh, tets and table depend on the case's
blockMeshDict alone, and a checkout builds them once (:func:`geometry`).
The particles' start positions and noise seed are the benchmark's inputs,
drawn from ``--seed``.

A step, in the solver's order:

1. dt: maxCo-scaled from deltaT (adjustTimeStep), trimmed to endTime and,
   under writeControl adjustable, to the next write time;
2. the flow step (:meth:`.flow.pimple.FlowSolver.advance`);
3. the probes sample p and U, and s takes its step in the new flux;
4. inside the particles' window [startTime, endTime]: each tet takes its
   cell's new U (the refresh), then ``ceil(dt / dt_p)`` sub-steps of
   ``dt / n`` in calls of one sub-step each, the tutorial's saveInterval 2
   schedule, each from the table rows of the lanes' tets (:func:`.particles.run`,
   whose noise of sub-step ``i`` is :func:`.particles.noise`).

Departures from OpenFOAM: the pressure solve is AMG-CG in place of GAMG;
the function objects' as :mod:`.functions` states; every boundary reflects
(the tutorial names no absorbing patch).
"""

from __future__ import annotations

import hashlib
import math
import os
import pickle
import time
import types

import numpy as np
import torch

from . import functions, particles, tetmesh
from .flow import blockmesh, foamfile
from .flow import pimple as rpimple

CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".cache",
                     "reference")
FLOW_FIELDS = ("u", "p", "flux")
CLOSURE_FIELDS = ("k", "eps", "nut")


def control(case_dir: str):
    """The controlDict entries a step reads."""
    d = foamfile.read(os.path.join(case_dir, "system", "controlDict"))
    g = foamfile.get_or_default
    return types.SimpleNamespace(
        delta_t=float(g(d, "deltaT", 0.1)), max_co=float(g(d, "maxCo", 1.0)),
        adjust_time_step=str(d.get("adjustTimeStep", "no")) in ("yes", "true", "on", "1"),
        end_time=float(g(d, "endTime", 1.0)), start_time=float(g(d, "startTime", 0.0)),
        write_control=str(d.get("writeControl", "timeStep")),
        write_interval=float(g(d, "writeInterval", 1.0)))


def particle_dict(case_dir: str):
    """cudaParticlesDict's window, sub-step and diffusion coefficient."""
    d = foamfile.read(os.path.join(case_dir, "system", "cudaParticlesDict"))
    g = foamfile.get_or_default
    return types.SimpleNamespace(start_time=float(g(d, "startTime", 0.0)),
                                 end_time=float(g(d, "endTime", 1e5)), dt=float(g(d, "dt", 1e-4)),
                                 diffusion_coeff=float(g(d, "diffusionCoeff", 5.7e-6)))


def geometry(case_dir: str, dtype):
    """(polyMesh, points, tets, tet_cell, table, escape mask) of the case's
    blockMeshDict, built by this package alone: :mod:`.flow.blockmesh`,
    :func:`.tetmesh.decompose` and :func:`.particles.build_table` (with zero
    velocities).  They are kept in :data:`CACHE` under a hash of the
    dictionary and of the files that build them, so that a checkout builds
    them once."""
    bmd = os.path.join(case_dir, "system", "blockMeshDict")
    here = os.path.dirname(os.path.abspath(__file__))
    key = hashlib.sha1(str(dtype).encode())
    for path in (bmd, __file__, tetmesh.__file__, particles.__file__,
                 os.path.join(here, "flow", "blockmesh.py"),
                 os.path.join(here, "flow", "polymesh.py")):
        with open(path, "rb") as fh:
            key.update(fh.read())
    path = os.path.join(CACHE, f"geometry-{key.hexdigest()}.pkl")
    if os.path.isfile(path):
        with open(path, "rb") as fh:
            return pickle.load(fh)
    pm = blockmesh.generate(bmd)
    points, tets, tet_cell = tetmesh.decompose(pm)
    tab, bd_escape = particles.build_table(points, tets, np.zeros((len(tets), 3)), dtype, "cpu")
    out = (pm, points, tets, tet_cell, tab, bd_escape)
    os.makedirs(CACHE, exist_ok=True)
    tmp = f"{path}.{os.getpid()}"
    with open(tmp, "wb") as fh:
        pickle.dump(out, fh, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    return out


def grid_start(points, tets, pos):
    """:func:`.particles.grid_start` with its grid filled on ``pos``'s
    device: the same grid, the same rolls in the same order, the same
    lookup."""
    np_dtype = np.float32 if pos.dtype == torch.float32 else np.float64
    pts = np.asarray(points).astype(np_dtype).astype(np.float64)
    tets = np.asarray(tets, dtype=np.int64)
    cen = pts[tets].mean(axis=1)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    extent = np.maximum(hi - lo, 1e-300)
    n_tets = tets.shape[0]
    g = np.maximum((extent / extent.prod() ** (1 / 3) * n_tets ** (1 / 3)).round().astype(int),
                   1)
    gx, gy, gz = int(g[0]), int(g[1]), int(g[2])
    inv_cell = np.array([gx, gy, gz], dtype=np.float64) / extent
    idx = np.clip(((cen - lo) * inv_cell).astype(np.int64), 0, [gx - 1, gy - 1, gz - 1])
    cell_tet = np.full(gx * gy * gz, -1, dtype=np.int64)
    cell_tet[(idx[:, 0] * gy + idx[:, 1]) * gz + idx[:, 2]] = np.arange(n_tets)
    grid = torch.as_tensor(cell_tet.reshape(gx, gy, gz), device=pos.device)
    for _ in range(max(gx, gy, gz)):
        if not bool((grid < 0).any()):
            break
        for axis in (0, 1, 2):
            for shift in (1, -1):
                src = torch.roll(grid, shift, dims=axis)
                grid = torch.where((grid < 0) & (src >= 0), src, grid)
    grid = torch.where(grid < 0, 0, grid).reshape(-1)
    rel = (pos - torch.as_tensor(lo, dtype=pos.dtype, device=pos.device)) * torch.as_tensor(
        inv_cell, dtype=pos.dtype, device=pos.device)
    top = torch.tensor([gx - 1, gy - 1, gz - 1], dtype=torch.int32, device=pos.device)
    ij = torch.minimum(torch.maximum(rel.to(torch.int32), torch.zeros_like(top)), top)
    return grid[((ij[:, 0] * gy + ij[:, 1]) * gz + ij[:, 2]).long()]


def locate(tab, points, tets, pos):
    """The tet holding each start position: :func:`.particles.locate`'s
    seeding walk from :func:`grid_start`, then, for the lanes it leaves
    outside the domain, the exhaustive test that seeding makes
    (``brute_force_resolve``): the first tet whose barycentric weights, in
    float64 from the table's A and Tinv, are all at least 0 and sum to at
    most 1, else -1 (a lane that never moves)."""
    guess = grid_start(points, tets, pos)
    act = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
    _, tet, _ = particles._walk(tab, tab[guess], guess, pos[:, 0], pos[:, 1], pos[:, 2], act,
                                particles.MAX_HOPS, bary=particles._bary_seeding)
    tet = tet.to(torch.int32)
    missed = (tet < 0).nonzero()[:, 0]
    if missed.numel():
        a = tab[:, 0:3].double()
        tinv = tab[:, 3:12].double().reshape(-1, 3, 3)
        for lanes in missed.split(8):
            rel = pos[lanes].double()[:, None, :] - a[None]              # [b, nt, 3]
            w = (tinv[None, :, :, 0] * rel[:, :, None, 0] + tinv[None, :, :, 1]
                 * rel[:, :, None, 1]) + tinv[None, :, :, 2] * rel[:, :, None, 2]
            inside = (w.amin(dim=-1) >= 0.0) & ((w[..., 0] + w[..., 1]) + w[..., 2] <= 1.0)
            first = inside.to(torch.int32).argmax(dim=1).to(tet.dtype)
            tet[lanes] = torch.where(inside.any(dim=1), first, torch.full_like(first, -1))
    return tet


def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


def _rounded(obj, names):
    import dataclasses

    return dataclasses.replace(obj, **{k: _bf16(getattr(obj, k)) for k in names})


class CoupledReference:
    """The coupled run of ``case_dir`` from its initial fields, a step at a
    time.  ``positions`` [n, 3] are the particles' start, ``seed`` their
    noise; ``n_hops`` the inline hops at which a sub-step's walk is split
    between its stages.  ``lower_precision``: the control, the same run with
    every field, table and mega row rounded to bfloat16 after each stage."""

    def __init__(self, case_dir: str, positions, seed: int, n_hops: int, device,
                 dtype=torch.float32, lower_precision: bool = False):
        self.ctrl, self.pdict = control(case_dir), particle_dict(case_dir)
        self.seed, self.n_hops, self.low = int(seed), int(n_hops), lower_precision
        clock = [time.perf_counter()]
        pm, self.points, self.tets, tet_cell, tab, bd_escape = geometry(case_dir, dtype)
        self.tet_cell = torch.as_tensor(tet_cell, device=device)
        self.tab, self.bd_escape = tab.to(device), bd_escape.to(device)
        clock.append(time.perf_counter())
        self.flow = rpimple.FlowSolver(case_dir, pm, dtype, device)
        clock.append(time.perf_counter())
        fos = functions.function_objects(case_dir)
        m = self.flow.m
        self.probes = functions.Probes(m, fos["probes"]) if "probes" in fos else None
        self.scalar = None
        if "scalarTransport" in fos:
            field, su = fos["scalarTransport"]
            self.scalar = functions.ScalarTransport(case_dir, m, field, self.flow.cfg.nu, su)
        pos = torch.as_tensor(positions, device=device).to(dtype)
        self.pos, self.vel = pos.clone(), torch.zeros_like(pos)
        self.tet = locate(self.tab, self.points, self.tets, pos)
        self.active = torch.ones(pos.shape[0], dtype=torch.bool, device=device)
        clock.append(time.perf_counter())
        # seconds of each part of the set-up (the host clock, not synchronised)
        self.setup_s = dict(zip(("mesh_tets_table", "flow", "functions_and_locate"),
                                np.diff(clock).tolist()))
        self.t, self.sub_step = self.ctrl.start_time, 0
        self.next_write_t = self.t + self.ctrl.write_interval

    def dt(self) -> float:
        c, t = self.ctrl, self.t
        dt = self.flow.stable_dt(c) if c.adjust_time_step else c.delta_t
        dt = min(dt, c.end_time - t)
        if c.write_control in ("adjustableRunTime", "adjustable"):
            dt = min(dt, max(self.next_write_t - t, 1e-12))
        return dt

    def step(self) -> list:
        """One coupled step; returns the CG iterations of its pressure solves."""
        f = self.flow
        dt_e = self.dt()
        res = f.advance(dt_e)
        if self.low:
            f.state = _rounded(f.state, FLOW_FIELDS)
            if f.kes is not None:
                f.kes = _rounded(f.kes, CLOSURE_FIELDS)
        self.t += dt_e
        if self.probes is not None:
            self.probes.sample(self.t, f.state.p, f.state.u)
        if self.scalar is not None:
            self.scalar.advance(f.state.flux, dt_e)
            if self.low:
                self.scalar.s = _bf16(self.scalar.s)
        pd = self.pdict
        if pd.start_time <= self.t <= pd.end_time:
            self.refresh(f.state.u)
            n = max(int(math.ceil(dt_e / pd.dt)), 1)
            for _ in range(n):
                self.sub_steps(1, dt_e / n)
        return list(res["p_iters"])

    def refresh(self, u_cells) -> None:
        """Each tet takes its cell's velocity: what :func:`.particles.build_table`
        gives for the new velocities, whose geometry columns do not change."""
        self.tab[:, particles.VEL:particles.VEL + 3] = u_cells[self.tet_cell].to(self.tab.dtype)
        if self.low:
            self.tab = particles.round_table_bf16(self.tab)

    def sub_steps(self, n: int, dt: float) -> None:
        self.pos, self.vel, self.tet, self.active = particles.run(
            self.tab, self.bd_escape, self.pos, self.vel, self.tet, self.active, seed=self.seed,
            step=self.sub_step, n_cycles=n, dt=dt, diffusion_coeff=self.pdict.diffusion_coeff,
            n_hops=self.n_hops, bounce_on=True,
            rounding=particles.round_mega_bf16 if self.low else None)
        self.sub_step += n

    def outputs(self) -> dict:
        """The compared state: the fields, s and the lanes (not copied)."""
        f = self.flow
        out = {"U": f.state.u, "p": f.state.p, "phi": f.state.flux}
        if f.kes is not None:
            out["k"], out["epsilon"] = f.kes.k, f.kes.eps
        if self.scalar is not None:
            out["s"] = self.scalar.s
        out.update(pos=self.pos, tet=self.tet, active=self.active)
        return out
