"""Plain reference of the TJunction tutorial's two function objects, for the
coupled cell: ``probes`` of p and U, and ``scalarTransport`` of a passive
scalar s with a unity source (``system/controlDict``'s ``functions``).

Plain PyTorch and NumPy on the reference flow's mesh
(:mod:`reference.flow.fv`); it imports nothing of the program.

Departures from OpenFOAM, as the port makes them:

* a probe samples the cell whose centre is nearest to its location, not
  the cell that contains it (the same cell wherever a probe sits well
  inside a cell), after every step rather than at write times;
* scalarTransport's solve is a fixed number of Jacobi sweeps from the last
  step's s, not a converged smoothSolver; its diffusivity is the flow's
  laminar nu; convection is upwind.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .flow import foamfile, fv, polymesh

SCALAR_SWEEPS = 6


def function_objects(case_dir: str) -> dict:
    """controlDict's ``functions`` entries by type: ``probes`` (their
    locations) and ``scalarTransport`` (its field and its unity source's Su)."""
    fns = foamfile.read(os.path.join(case_dir, "system", "controlDict")).get("functions", {})
    out = {}
    for spec in (fns.values() if isinstance(fns, dict) else ()):
        if not isinstance(spec, dict):
            continue
        if spec.get("type") == "probes" and "probeLocations" in spec:
            out["probes"] = np.asarray(spec["probeLocations"], dtype=np.float64)
        if spec.get("type") == "scalarTransport":
            field = str(spec.get("field", "s"))
            su = 0.0
            try:
                su = float(spec["fvOptions"]["unitySource"]["scalarSemiImplicitSourceCoeffs"][
                    "injectionRateSuSp"][field][0])
            except (KeyError, TypeError, IndexError):
                pass
            out["scalarTransport"] = (field, su)
    return out


class Probes:
    """p and U of the cells nearest to the locations, kept after each step."""

    def __init__(self, m: fv.FvMesh, locations):
        cc = fv.host(m.cc).astype(np.float64)
        loc = np.asarray(locations, dtype=np.float64)
        d = np.linalg.norm(cc[None, :, :] - loc[:, None, :], axis=-1)
        self.cells = torch.as_tensor(d.argmin(axis=1), device=m.device)
        self.samples = []        # [(t, p at the cells, U at the cells)]

    def sample(self, t: float, p, u) -> None:
        self.samples.append((t, p[self.cells].clone(), u[self.cells].clone()))


class ScalarTransport:
    """s advanced by one implicit-Euler step of

        ds/dt + div(phi s) - lap(D s) = Su

    a step: per cell, V (s - s_old) / dt + sum_f phi_f s_f - sum_f D |S_f| /
    |d_f| (s_N - s_P) = Su V, with s_f upwinded, assembled by
    :func:`reference.flow.fv.assemble_transport` (its ddt term carries V / dt
    and V s_old / dt) and solved by Jacobi sweeps from s_old."""

    def __init__(self, case_dir: str, m: fv.FvMesh, field: str, diffusivity: float, su: float):
        self.m, self.diffusivity, self.su = m, diffusivity, su
        path = os.path.join(case_dir, "0", field)
        spec = polymesh.read_field_bcs(path)
        self.bcs = fv.make_bcs(m, {k: (e[0], 0.0 if e[1] is None else e[1])
                                   for k, e in spec.items()}, 1)
        s0 = polymesh.read_field(path, n_cells=m.n_cells)
        self.s = torch.as_tensor(np.asarray(s0).reshape(-1), dtype=m.dtype, device=m.device)

    def advance(self, flux, dt: float):
        m = self.m
        v_dt = m.vol / torch.as_tensor(dt, dtype=m.dtype, device=m.device)
        A = fv.assemble_transport(m, flux, self.diffusivity, self.bcs, 1, ddt_coeff=v_dt,
                                  phi_old=self.s[:, None])
        # the unity source: Su V on the right, nothing implicit (Sp = 0)
        rhs = A.source[:, 0] + self.su * m.vol
        self.s = fv.jacobi_solve(m, A, rhs[:, None], self.s[:, None],
                                 sweeps=SCALAR_SWEEPS)[:, 0]
        return self.s
