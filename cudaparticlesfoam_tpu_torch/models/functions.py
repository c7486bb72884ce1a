"""Function objects: probes, passive scalar transport, flow streamlines.

The port of ``cudaparticlesfoam_tpu/models/functions.py``: the OpenFOAM
function objects the reference tutorials configure
(``TJunction/system/controlDict:53-133``: ``probes`` + ``scalarTransport``
of an ``s`` field with a unity source; ``pitzDaily/system/controlDict:46-74``:
``streamLine`` sampling), on torch tensors.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..io import polymesh
from . import fv


# ---------------------------------------------------------------------------
# probes (OpenFOAM `probes` function object)
# ---------------------------------------------------------------------------


class Probes:
    """Sample cell values at fixed points each write; OpenFOAM-style
    ``postProcessing/<name>/0/<field>`` output files."""

    def __init__(self, m: fv.FvMesh, locations, name: str = "probes"):
        self.m = m
        self.name = name
        self.locations = np.asarray(locations, dtype=np.float64)
        cc = fv.host(m.cc).astype(np.float64)
        # nearest cell centre (OpenFOAM uses containing cell; nearest centre
        # is equivalent for probe points placed inside cells)
        d = np.linalg.norm(cc[None, :, :] - self.locations[:, None, :], axis=-1)
        self.cells = d.argmin(axis=1)
        self.samples: dict[str, list] = {}

    def sample(self, t: float, fields: dict) -> None:
        """fields: {"p": [nc], "U": [nc,3], ...} (tensors or arrays)."""
        for name, vals in fields.items():
            vals = fv.host(vals) if torch.is_tensor(vals) else np.asarray(vals)
            self.samples.setdefault(name, []).append((t, vals[self.cells]))

    def write(self, case_dir: str, start_name: str = "0") -> str:
        out = os.path.join(case_dir, "postProcessing", self.name, start_name)
        os.makedirs(out, exist_ok=True)
        for field, rows in self.samples.items():
            with open(os.path.join(out, field), "w") as fh:
                for i, loc in enumerate(self.locations):
                    fh.write(
                        f"# Probe {i} ({loc[0]:g} {loc[1]:g} {loc[2]:g})\n"
                    )
                fh.write("#       Time\n")
                for t, vals in rows:
                    cells = []
                    for v in vals:
                        if np.ndim(v) == 0:
                            cells.append(f"{float(v):.8g}")
                        else:
                            cells.append("(" + " ".join(f"{x:.8g}" for x in v) + ")")
                    fh.write(f"{t:>12g} " + " ".join(f"{c:>16s}" for c in cells) + "\n")
        return out


# ---------------------------------------------------------------------------
# passive scalar transport (`scalarTransport` function object)
# ---------------------------------------------------------------------------


def scalar_transport_step(
    m: fv.FvMesh, s, flux, bcs, diffusivity, dt, source_su=0.0, source_sp=0.0,
    n_sweeps: int = 6,
):
    """One implicit-Euler step of  ds/dt + div(phi s) - lap(D s) = Su + Sp*s.

    ``source_su``/``source_sp`` follow OpenFOAM's semi-implicit source pair
    (the TJunction case injects a unity specific source: Su=1, Sp=0,
    ``controlDict:104-110``).
    """
    ddt = m.vol / torch.as_tensor(dt, dtype=m.dtype, device=m.device)
    A = fv.assemble_transport(
        m, flux, diffusivity, bcs, 1, ddt_coeff=ddt, phi_old=s[:, None]
    )
    diag = A.diag - source_sp * m.vol
    b = A.source[:, 0] + source_su * m.vol
    A2 = dataclasses.replace(A, diag=diag)
    return fv.jacobi_solve(m, A2, b[:, None], s[:, None], sweeps=n_sweeps)[:, 0]


class ScalarTransport:
    """Stateful wrapper: reads 0/<field>, advances with the flow flux."""

    def __init__(self, case_dir: str, m: fv.FvMesh, field: str = "s",
                 diffusivity: float = 1e-5, source_su: float = 0.0):
        self.m = m
        self.field = field
        self.diffusivity = diffusivity
        self.source_su = source_su
        path = os.path.join(case_dir, "0", field)
        nc = m.n_cells
        if os.path.exists(path):
            s0 = polymesh.read_field(path, n_cells=nc)
            spec = polymesh.read_field_bcs(path)
        else:
            s0 = np.zeros(nc)
            spec = {}
        self.bcs = fv.make_bcs(
            m, {k: (e[0], e[1] if e[1] is not None else 0.0) for k, e in spec.items()}, 1
        )
        self.s = torch.as_tensor(np.asarray(s0).reshape(-1), dtype=m.dtype, device=m.device)

    def advance(self, flux, dt):
        self.s = scalar_transport_step(
            self.m, self.s, flux, self.bcs, self.diffusivity, dt,
            source_su=self.source_su,
        )
        return self.s

    def write(self, case_dir: str, time_name: str):
        out = os.path.join(case_dir, time_name)
        os.makedirs(out, exist_ok=True)
        polymesh.write_field(
            os.path.join(out, self.field), self.field, fv.host(self.s),
            dimensions=(0, 0, 0, 0, 0, 0, 0), location=time_name,
        )


# ---------------------------------------------------------------------------
# flow streamlines (`streamLine` function object)
# ---------------------------------------------------------------------------


def trace_streamlines(
    tet_mesh, locator, seeds, step_length: float, n_steps: int = 2000,
):
    """Integrate field lines of the (frozen) tet velocity field from seed
    points; returns a list of polylines (the streamLine function object,
    ``pitzDaily/system/controlDict:46-74``).

    Uses the particle machinery with pure advection and unit-speed
    normalized velocity so the step length is spatial: the simple engine
    (torch ops, as JAX's ``engine="simple"``) on the mesh's device.
    """
    from .. import StepConfig, replace_velocity, run_cycles
    from ..ops import locate as locate_ops
    from ..state import make_state

    seeds = np.asarray(seeds, dtype=np.float64)
    st = make_state(seeds, dtype=tet_mesh.dtype, device=tet_mesh.device)
    tet = locate_ops.locate_seeds(tet_mesh, locator, st.pos)
    st = dataclasses.replace(st, tet_id=tet)

    # normalize tet velocities -> arc-length stepping
    tv = tet_mesh.host["tet_vel"].astype(np.float64)
    speed = np.linalg.norm(tv, axis=1, keepdims=True)
    unit = np.where(speed > 1e-12, tv / np.maximum(speed, 1e-300), 0.0)
    m_unit = replace_velocity(tet_mesh, tet_vel=unit)

    cfg = StepConfig(dt=step_length, use_brownian=False, reflect_wall=False,
                     engine="simple")
    tracks = [seeds.copy()]
    s = st
    sample_every = max(n_steps // 200, 1)
    for _ in range(0, n_steps, sample_every):
        s = run_cycles(m_unit, s, cfg, sample_every)
        tracks.append(fv.host(s.pos).astype(np.float64))
    pts = np.stack(tracks, axis=1)          # [n_seeds, n_samples, 3]
    return [pts[i] for i in range(len(seeds))]


def write_streamlines_vtk(path: str, lines) -> None:
    from ..io.vtu import Trajectories

    tr = Trajectories(len(lines))
    tr.tracks = [[p.astype(np.float32) for p in line] for line in lines]
    tr.save_vtk(path)
