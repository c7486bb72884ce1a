"""Transient incompressible PIMPLE/PISO step, for the flow reference: a
frozen copy of the port's ``models/pimple.py`` (the implicit-Euler momentum
predictor, the PISO correctors with Rhie-Chow fluxes, maxCo time steps),
without the MRF, fvOptions and moving-mesh hooks, which the benchmark's
cases do not use.  Torch ops on the tensors' device; the pressure solve
runs the plain AMG-CG of :mod:`.fv`.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from . import fv
from .simple import FlowState, _pressure_matrix, load_flow_case


@dataclasses.dataclass(frozen=True)
class PimpleConfig:
    nu: float = 1e-5
    n_outer: int = 1          # PIMPLE outer correctors (1 = PISO)
    n_correctors: int = 2     # pressure correctors per outer loop
    n_jacobi: int = 8
    p_tol: float = 1e-6
    p_max_iter: int = 400
    pin_pressure: bool = False
    div_scheme: str = "upwind"   # fvSchemes div(phi,U), deferred correction
    n_nonortho: int = 0          # fvSolution nNonOrthogonalCorrectors
    p_solver: str = "cg"         # "amg" (GAMG stand-in) or "cg"


@dataclasses.dataclass(frozen=True, eq=False)
class Momentum:
    """What the momentum predictor hands to the PISO correctors."""

    u_bcs: fv.BoundaryCoeffs   # after the inletOutlet switch
    A: fv.FvMatrix             # momentum operator (ddt, Sp included)
    b: torch.Tensor            # its source, with -grad(p) V and the explicit sources
    grad_p: torch.Tensor       # [nc, 3]
    u_star: torch.Tensor       # [nc, 3] predicted (and fvOptions-corrected) velocity
    u_res: torch.Tensor        # momentum residual
    rau: torch.Tensor          # [nc] V / aP
    rau_f: torch.Tensor        # [nf]
    Ap: fv.FvMatrix            # Laplacian(rAU) pressure operator


def face_viscosity(m: fv.FvMesh, cfg: PimpleConfig, nut=None, nut_bd=None):
    """Laminar nu, or nu + the face-interpolated eddy viscosity (``nut_bd``
    carries the nutkWallFunction values on wall faces)."""
    if nut is None:
        return cfg.nu
    nut_b = nut[m.own_b] if nut_bd is None else nut_bd
    return cfg.nu + torch.cat([fv.face_interp(m, nut), nut_b])


def momentum_predictor(m: fv.FvMesh, st: FlowState, u_bcs, p_bcs, cfg: PimpleConfig, ddt,
                       u_old, nu_f) -> Momentum:
    """Stage 1 (``UEqn.H``): assemble with the ddt term against the step's
    old velocity, add -grad(p) and the deferred convection correction,
    Jacobi-solve."""
    # inletOutlet backflow switching against the current flux
    u_bcs_e = fv.effective_bcs(u_bcs, st.flux[m.n_internal :])
    A = fv.assemble_transport(m, st.flux, nu_f, u_bcs_e, 3, ddt_coeff=ddt, phi_old=u_old)
    grad_p = fv.gradient(m, st.p, p_bcs)
    b = A.source - grad_p * m.vol[:, None]
    b = b + fv.convection_correction(m, st.flux, st.u, u_bcs_e, cfg.div_scheme)
    u_star = fv.jacobi_solve(m, A, b, st.u, sweeps=cfg.n_jacobi)
    u_res = torch.linalg.vector_norm(b - fv.matvec(m, A, u_star)) / (
        torch.linalg.vector_norm(b) + 1e-300)
    rau = m.vol / A.diag
    rau_f = torch.cat([fv.face_interp(m, rau), rau[m.own_b]])
    Ap, _ = _pressure_matrix(m, rau_f, p_bcs, cfg.pin_pressure)
    return Momentum(u_bcs=u_bcs_e, A=A, b=b, grad_p=grad_p, u_star=u_star, u_res=u_res,
                    rau=rau, rau_f=rau_f, Ap=Ap)


def pressure_system(m: fv.FvMesh, mo: Momentum, u_corr):
    """Stage 2a, per corrector: HbyA of the current velocity, its flux and
    the pressure equation's right-hand side.  Returns (hbya, phi_hbya, rhs)."""
    hbya = (mo.b + mo.grad_p * m.vol[:, None] - (
        fv.matvec(m, mo.A, u_corr) - mo.A.diag[:, None] * u_corr)) / mo.A.diag[:, None]
    phi_hbya = fv.flux_of(m, hbya, mo.u_bcs)
    rhs = mo.Ap.source[:, 0] - fv.surface_sum(m, phi_hbya)
    return hbya, phi_hbya, rhs


def pressure_solve(m: fv.FvMesh, mo: Momentum, rhs, p, p_bcs, cfg: PimpleConfig, amg=None):
    """Stage 2b: the pressure solve(s) from ``p`` with the explicit
    non-orthogonal correctors (``pEqn.H:42-57``).  Returns (p, corr, p_res,
    CG iterations of each solve)."""
    corr = torch.zeros(m.n_internal, dtype=m.dtype, device=m.device)
    p_res = torch.zeros((), dtype=m.dtype, device=m.device)
    its = []
    for no in range(cfg.n_nonortho + 1):
        b = rhs + fv.surface_sum_internal(m, corr)
        if cfg.p_solver == "amg":
            p, p_res, it = fv.amg_cg_solve(m, amg, mo.Ap, b, p, tol=cfg.p_tol,
                                           max_iter=cfg.p_max_iter)
        else:
            p, p_res, it = fv.cg_solve(m, mo.Ap, b, p, tol=cfg.p_tol, max_iter=cfg.p_max_iter)
        its.append(it)
        if no < cfg.n_nonortho:
            corr = fv.nonortho_flux(m, mo.rau_f, p, p_bcs)
    return p, corr, p_res, its


def correct(m: fv.FvMesh, rau, rau_f, hbya, phi_hbya, p, corr, p_bcs):
    """Stage 2c: the conservative flux ``phiHbyA - rAUf snGrad(p)`` and the
    velocity ``HbyA - rAU grad(p)``.  Returns (flux, u)."""
    n_int = m.n_internal
    dp = p[m.neighbour] - p[m.own_i]
    flux_i = phi_hbya[:n_int] - rau_f[:n_int] * m.delta * dp - corr
    dp_b = (p_bcs.a - 1.0) * p[m.own_b] + p_bcs.b[:, 0]
    flux_b = phi_hbya[n_int:] - rau_f[n_int:] * m.bd_delta * dp_b
    flux = torch.cat([flux_i, flux_b])
    u = hbya - rau[:, None] * fv.gradient(m, p, p_bcs)
    return flux, u


def pimple_step(m: fv.FvMesh, st: FlowState, u_bcs, p_bcs, cfg: PimpleConfig, dt, nut=None,
                amg=None, nut_bd=None):
    """One Eulerian time step: returns (state, residuals); ``p_iters`` lists
    the CG iterations of every pressure solve of the step."""
    ddt = m.vol / torch.as_tensor(dt, dtype=m.dtype, device=m.device)
    u_old = st.u
    nu_f = face_viscosity(m, cfg, nut, nut_bd)
    u_res = p_res = torch.zeros((), dtype=m.dtype, device=m.device)
    p_iters = []
    for _ in range(cfg.n_outer):
        mo = momentum_predictor(m, st, u_bcs, p_bcs, cfg, ddt, u_old, nu_f)
        u_res = mo.u_res
        p, flux, u_corr = st.p, st.flux, mo.u_star
        for _c in range(cfg.n_correctors):
            hbya, phi_hbya, rhs = pressure_system(m, mo, u_corr)
            p, corr, p_res, its = pressure_solve(m, mo, rhs, p, p_bcs, cfg, amg)
            p_iters += its
            flux, u_corr = correct(m, mo.rau, mo.rau_f, hbya, phi_hbya, p, corr, p_bcs)
        st = FlowState(u=u_corr, p=p, flux=flux)
    res = {"u_res": u_res, "p_res": p_res,
           "continuity": torch.sum(torch.abs(fv.surface_sum(m, st.flux))),
           "p_iters": p_iters}
    return st, res


def correct_flux(m: fv.FvMesh, flux, p_bcs, pin: bool):
    """``CorrectPhi(U, phi, p, rAUf=1, zero, pimple)`` (``correctPhi.H:1-11``):
    project the face flux onto a divergence-free field by solving
    ``laplacian(1, pcorr) == div(phi)`` with homogeneous pressure-like BCs
    and subtracting the corrective flux.  Used after a restart and after
    mesh motion (``cudaParticlesPimpleFoam.C:153-163``).  Returns (flux,
    residual)."""
    # pcorr BCs: fixed 0 where p is fixed, zeroGradient elsewhere
    bc0 = dataclasses.replace(p_bcs, b=torch.zeros_like(p_bcs.b), io_mask=None, io_value=None)
    Ap, _ = _pressure_matrix(m, torch.ones_like(flux), bc0, pin)
    rhs = -fv.surface_sum(m, flux)
    pc = torch.zeros(m.n_cells, dtype=flux.dtype, device=flux.device)
    pc, res, _ = fv.cg_solve(m, Ap, rhs, pc, tol=1e-8, max_iter=500)
    # the pressure corrector's flux update (pEqn.H:55: phi -= pEqn.flux)
    n_int = m.n_internal
    dp = pc[m.neighbour] - pc[m.own_i]
    flux_i = flux[:n_int] - m.delta * dp
    dp_b = (bc0.a - 1.0).reshape(-1) * pc[m.own_b]
    flux_b = flux[n_int:] - m.bd_delta * dp_b
    return torch.cat([flux_i, flux_b]), res


def courant_dt(ctrl, co: float) -> float:
    """The maxCo-scaled time step (setDeltaT semantics) for the Courant
    number ``co`` taken at ``ctrl.delta_t``: at most 1.2x growth and at
    most 100 ``deltaT``."""
    dt0 = ctrl.delta_t
    if co <= 0.0:
        return dt0
    return min(dt0 * min(ctrl.max_co / max(co, 1e-12), 1.2), dt0 * 100)


def p_table_bcs(p_bcs: fv.BoundaryCoeffs, p_tables: dict, patch_slices, t: float):
    """The pressure BCs with the time tables (uniformTotalPressure p0 ramps)
    interpolated to ``t`` into their patches' offsets, on the host (numpy
    interp), as JAX does."""
    b = p_bcs.b.clone()
    names = {ps[0]: ps for ps in patch_slices}
    for patch, tab in p_tables.items():
        if patch not in names:
            continue
        ts = np.array([x[0] for x in tab])
        vs = np.array([x[1] for x in tab])
        _, _, start, cnt = names[patch]
        b[start : start + cnt, 0] = float(np.interp(t, ts, vs))
    return dataclasses.replace(p_bcs, b=b)


def courant_number(m: fv.FvMesh, flux, dt):
    """Max Courant number (OpenFOAM CourantNo.H): 0.5 dt sum|phi| / V, a
    0-dim tensor."""
    sums = fv.index_sum(m.n_cells, [(m.owner, torch.abs(flux)),
                                    (m.neighbour, torch.abs(flux[: m.n_internal]))])
    return 0.5 * torch.as_tensor(dt, dtype=flux.dtype, device=flux.device) * torch.max(
        sums / m.vol)


class FlowSolver:
    """The flow of a case: mesh, state, boundary conditions, the AMG
    hierarchy and the kEpsilon closure, advanced one Eulerian step at a
    time."""

    def __init__(self, case_dir: str, pm, dtype, device):
        from .simple import read_numerics, turbulence_model
        from . import turbulence as turb

        m, st, u_bcs, p_bcs, nu, pin, p_tables = load_flow_case(
            case_dir, pm=pm, dtype=dtype, time_dir="0", device=device)
        num = read_numerics(case_dir)
        self.m, self.state, self.u_bcs, self.p_bcs = m, st, u_bcs, p_bcs
        self.cfg = PimpleConfig(nu=nu, pin_pressure=pin, div_scheme=num["div_scheme"],
                                n_nonortho=num["n_nonortho"], n_correctors=num["n_correctors"],
                                n_outer=num["n_outer"], p_solver="amg")
        self.amg = fv.build_amg(m)
        self.p_tables = p_tables
        self.time = 0.0
        self.turb_model = turbulence_model(case_dir)
        self.kes = self.k_bcs = self.e_bcs = self.wi = None
        if self.turb_model != "laminar":
            self.kes, self.k_bcs, self.e_bcs, self.wi = turb.init_model(
                self.turb_model, case_dir, m, time_dir="0")

    def advance(self, dt_e: float):
        """One Eulerian step of ``dt_e``; returns the residuals."""
        from . import turbulence as turb

        self.time = self.time + dt_e
        if self.p_tables:
            self.p_bcs = p_table_bcs(self.p_bcs, self.p_tables, self.m.patch_slices, self.time)
        nut = nut_bd = None
        if self.kes is not None:
            nut = self.kes.nut
            nut_bd = turb.wall_nut_bd(self.m, self.wi, self.kes.nut, self.kes.k, self.cfg.nu)
        self.state, res = pimple_step(self.m, self.state, self.u_bcs, self.p_bcs, self.cfg, dt_e,
                                      nut=nut, amg=self.amg, nut_bd=nut_bd)
        if self.kes is not None:
            self.kes = turb.model_step(self.turb_model, self.m, self.kes, self.state.u,
                                       self.u_bcs, self.state.flux, self.k_bcs, self.e_bcs,
                                       self.wi, self.cfg.nu, dt=dt_e)
        return res

    def stable_dt(self, ctrl):
        """maxCo-scaled time step (setDeltaT semantics)."""
        return courant_dt(ctrl, float(courant_number(self.m, self.state.flux, ctrl.delta_t)))
