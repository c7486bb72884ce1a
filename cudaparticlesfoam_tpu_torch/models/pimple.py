"""Transient incompressible PIMPLE/PISO solver.

The port of ``cudaparticlesfoam_tpu/models/pimple.py``: the flow half of
``cudaParticlesPimpleFoam``
(``applications/cudaParticlesPimpleFoam/cudaParticlesPimpleFoam.C:131-192``):
per time step, an implicit-Euler momentum predictor (``UEqn.H:5-24``)
followed by PISO pressure correctors (``pEqn.H:42-57``) with Rhie-Chow
fluxes, optional outer PIMPLE loops, and maxCo-driven adaptive time
stepping (``TJunction/system/controlDict:47-51``).  Laminar, or an
eddy-viscosity field per step from :mod:`.turbulence`.

JAX jits the whole step as one program (the outer loop a ``lax.scan``);
here :func:`pimple_step` is a Python loop over stage functions, as
:mod:`.simple` splits a SIMPLE iteration, so that each stage can be timed
on its own:

  1. :func:`momentum_predictor`: assembly with the ddt term, the MRF and
     fvOptions hooks, Jacobi sweeps, then rAU and the pressure operator;
  2. per PISO corrector :func:`pressure_system` (HbyA, its flux, the
     right-hand side), :func:`pressure_solve` (AMG-CG or Jacobi-CG with the
     non-orthogonal correctors) and :func:`correct` (flux and velocity).

Torch ops on the tensors' device; no kernel.  The CG loops read their exit
test on the host once per iteration (``fv._pcg``).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..dtypes import canonical_device
from . import fv
from . import fvoptions as fvo_mod
from . import mrf as mrf_mod
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
    fvo: object                # fvOptions state after constrain/correct (or None)


def face_viscosity(m: fv.FvMesh, cfg: PimpleConfig, nut=None, nut_bd=None):
    """Laminar nu, or nu + the face-interpolated eddy viscosity (``nut_bd``
    carries the nutkWallFunction values on wall faces)."""
    if nut is None:
        return cfg.nu
    nut_b = nut[m.own_b] if nut_bd is None else nut_bd
    return cfg.nu + torch.cat([fv.face_interp(m, nut), nut_b])


def momentum_predictor(m: fv.FvMesh, st: FlowState, u_bcs, p_bcs, cfg: PimpleConfig, ddt,
                       u_old, nu_f, mrf=None, fvo=None) -> Momentum:
    """Stage 1 (``UEqn.H``): assemble with the ddt term against the step's
    old velocity, fold fvOptions' Sp and pending increment in BEFORE rAU is
    taken (``UEqn.H:17``), add -grad(p), the deferred convection
    correction, the Coriolis and explicit sources, Jacobi-solve, and apply
    fvOptions.correct (``UEqn.H:23``)."""
    # inletOutlet backflow switching against the current flux
    u_bcs_e = fv.effective_bcs(u_bcs, st.flux[m.n_internal :])
    A = fv.assemble_transport(m, st.flux, nu_f, u_bcs_e, 3, ddt_coeff=ddt, phi_old=u_old)
    if fvo is not None:
        A, fvo = fvo_mod.constrain(fvo, m, A)
    grad_p = fv.gradient(m, st.p, p_bcs)
    b = A.source - grad_p * m.vol[:, None]
    b = b + fv.convection_correction(m, st.flux, st.u, u_bcs_e, cfg.div_scheme)
    if mrf is not None:
        # MRF.DDt(U) moved to the RHS: -(Omega x U) V over zone cells
        b = b + mrf_mod.coriolis_source(mrf, m, st.u)
    if fvo is not None:
        b = fvo_mod.add_sup(fvo, m, b)
    u_star = fv.jacobi_solve(m, A, b, st.u, sweeps=cfg.n_jacobi)
    u_res = torch.linalg.vector_norm(b - fv.matvec(m, A, u_star)) / (
        torch.linalg.vector_norm(b) + 1e-300)
    rau = m.vol / A.diag
    if fvo is not None:
        u_star, fvo = fvo_mod.correct(fvo, m, u_star, rau)
    rau_f = torch.cat([fv.face_interp(m, rau), rau[m.own_b]])
    Ap, _ = _pressure_matrix(m, rau_f, p_bcs, cfg.pin_pressure)
    return Momentum(u_bcs=u_bcs_e, A=A, b=b, grad_p=grad_p, u_star=u_star, u_res=u_res,
                    rau=rau, rau_f=rau_f, Ap=Ap, fvo=fvo)


def pressure_system(m: fv.FvMesh, mo: Momentum, u_corr, mrf=None):
    """Stage 2a, per corrector: HbyA of the current velocity, its flux
    (made relative to the MRF frame, ``pEqn.H:20``) and the pressure
    equation's right-hand side.  Returns (hbya, phi_hbya, rhs)."""
    hbya = (mo.b + mo.grad_p * m.vol[:, None] - (
        fv.matvec(m, mo.A, u_corr) - mo.A.diag[:, None] * u_corr)) / mo.A.diag[:, None]
    phi_hbya = fv.flux_of(m, hbya, mo.u_bcs)
    if mrf is not None:
        phi_hbya = mrf_mod.make_relative(mrf, m, phi_hbya)
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


def correct(m: fv.FvMesh, mo: Momentum, hbya, phi_hbya, p, corr, p_bcs, fvo=None):
    """Stage 2c: the conservative flux ``phiHbyA - rAUf snGrad(p)`` and the
    velocity ``HbyA - rAU grad(p)``, then fvOptions.correct (``pEqn.H:66``).
    Returns (flux, u, fvo)."""
    n_int = m.n_internal
    dp = p[m.neighbour] - p[m.own_i]
    flux_i = phi_hbya[:n_int] - mo.rau_f[:n_int] * m.delta * dp - corr
    dp_b = (p_bcs.a - 1.0) * p[m.own_b] + p_bcs.b[:, 0]
    flux_b = phi_hbya[n_int:] - mo.rau_f[n_int:] * m.bd_delta * dp_b
    flux = torch.cat([flux_i, flux_b])
    u = hbya - mo.rau[:, None] * fv.gradient(m, p, p_bcs)
    if fvo is not None:
        u, fvo = fvo_mod.correct(fvo, m, u, mo.rau)
    return flux, u, fvo


def pimple_step(m: fv.FvMesh, st: FlowState, u_bcs, p_bcs, cfg: PimpleConfig, dt, nut=None,
                amg=None, nut_bd=None, mrf=None, fvo=None):
    """One Eulerian time step: returns (state, residuals).

    ``mrf`` (:class:`.mrf.MRFZones`) adds the rotating-frame terms of
    ``UEqn.H:3-8`` / ``pEqn.H:20``: rotating-wall boundary velocity, the
    explicit Coriolis source and the relative convective flux; U stays
    absolute.  ``fvo`` (:class:`.fvoptions.FvOptions`) adds the momentum
    fvOptions (``UEqn.H:11,17,23``, ``pEqn.H:66``); its updated state is
    returned in the residuals as ``fvo_grad_p`` / ``fvo_dgrad``.

    The residuals ``u_res``, ``p_res`` and ``continuity`` are 0-dim tensors
    (the last outer loop's, as JAX's scan carries them); ``p_iters`` lists
    the CG iterations of every pressure solve of the step (Python ints).
    """
    ddt = m.vol / torch.as_tensor(dt, dtype=m.dtype, device=m.device)
    u_old = st.u
    if mrf is not None:
        # MRF.correctBoundaryVelocity(U): rotating walls move with the frame
        u_bcs = mrf_mod.correct_boundary_velocity(mrf, m, u_bcs)
    nu_f = face_viscosity(m, cfg, nut, nut_bd)
    u_res = p_res = torch.zeros((), dtype=m.dtype, device=m.device)
    p_iters = []
    for _ in range(cfg.n_outer):
        mo = momentum_predictor(m, st, u_bcs, p_bcs, cfg, ddt, u_old, nu_f, mrf, fvo)
        fvo, u_res = mo.fvo, mo.u_res
        p, flux, u_corr = st.p, st.flux, mo.u_star
        for _c in range(cfg.n_correctors):
            hbya, phi_hbya, rhs = pressure_system(m, mo, u_corr, mrf)
            p, corr, p_res, its = pressure_solve(m, mo, rhs, p, p_bcs, cfg, amg)
            p_iters += its
            flux, u_corr, fvo = correct(m, mo, hbya, phi_hbya, p, corr, p_bcs, fvo)
        st = FlowState(u=u_corr, p=p, flux=flux)
    res = {"u_res": u_res, "p_res": p_res,
           "continuity": torch.sum(torch.abs(fv.surface_sum(m, st.flux))),
           "p_iters": p_iters}
    if fvo is not None:
        res["fvo_grad_p"] = fvo.grad_p
        res["fvo_dgrad"] = fvo.dgrad
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


def courant_number(m: fv.FvMesh, flux, dt):
    """Max Courant number (OpenFOAM CourantNo.H): 0.5 dt sum|phi| / V, a
    0-dim tensor."""
    sums = torch.zeros(m.n_cells, dtype=flux.dtype, device=flux.device)
    sums.index_add_(0, m.owner, torch.abs(flux))
    sums.index_add_(0, m.neighbour, torch.abs(flux[: m.n_internal]))
    return 0.5 * torch.as_tensor(dt, dtype=flux.dtype, device=flux.device) * torch.max(
        sums / m.vol)


class FlowSolver:
    """Stateful wrapper used by the coupled driver."""

    def __init__(self, m, state, u_bcs, p_bcs, cfg: PimpleConfig, log=print):
        self.m = m
        self.state = state
        self.u_bcs = u_bcs
        self.p_bcs = p_bcs
        self.cfg = cfg
        self.log = log
        self.amg = self.mrf = self.fvo = self.dyn = None
        self.kes = self.k_bcs = self.e_bcs = self.wi = None
        self.p_tables = {}
        self.moving_patches = ()
        self.turb_model = "laminar"
        self.time = 0.0
        self.last = {}     # the last step's residuals as floats

    @classmethod
    def from_case(cls, case, log=print, dtype=None, device=None):
        """The solver of a loaded case on ``device`` (default the case mesh's
        device, else the card) in ``dtype`` (default float32, as JAX's, which
        always solves the flow in float32).  Reads transportProperties,
        fvSchemes/fvSolution numerics, MRFProperties, fvOptions, the restart
        flux, dynamicMeshDict and the turbulence closure in JAX's order."""
        from .simple import read_numerics, turbulence_model

        if device is None:
            tm = getattr(case, "tet_mesh", None)
            device = tm.device if tm is not None else None
        device = canonical_device(device)
        m, st, u_bcs, p_bcs, nu, pin, p_tables = load_flow_case(
            case.case_dir, pm=case.poly, dtype=dtype, time_dir=getattr(case, "time_dir", "0"),
            device=device)
        num = read_numerics(case.case_dir)
        cfg = PimpleConfig(nu=nu, pin_pressure=pin, div_scheme=num["div_scheme"],
                           n_nonortho=num["n_nonortho"], n_correctors=num["n_correctors"],
                           n_outer=num["n_outer"], p_solver="amg")
        solver = cls(m, st, u_bcs, p_bcs, cfg, log=log)
        solver.amg = fv.build_amg(m)
        solver.p_tables = p_tables
        solver.time = case.time_value
        # MRF zones (constant/MRFProperties; cudaParticlesPimpleFoam.C:151)
        solver.mrf = mrf_mod.from_case(case.case_dir, m, case.poly)
        # momentum fvOptions (constant/ or system/fvOptions; UEqn.H:11-23)
        solver.fvo = fvo_mod.from_case(case.case_dir, m, case.poly)
        if solver.fvo is not None:
            kinds = []
            if solver.fvo.has_mvf:
                kinds.append("meanVelocityForce")
            if bool((solver.fvo.su.abs().sum() > 0) or (solver.fvo.sp.abs().sum() > 0)):
                kinds.append("semiImplicitSource")
            log(f"#flow: momentum fvOptions active ({', '.join(kinds)})")
        if solver.mrf is not None:
            solver.state = dataclasses.replace(
                solver.state, flux=mrf_mod.make_relative(solver.mrf, m, solver.state.flux))
            log("#flow: MRF zones active")
        # restart flux: prefer the written phi (exact conservative flux);
        # else project the U-rebuilt flux (CorrectPhi, correctPhi.H)
        if case.time_value > 0.0:
            from ..io import polymesh as pmio

            phi = pmio.read_surface_field(
                os.path.join(case.case_dir, getattr(case, "time_dir", "0"), "phi"),
                case.poly.patches)
            if phi is not None and len(phi) == m.n_faces:
                solver.state = dataclasses.replace(
                    solver.state, flux=torch.as_tensor(np.asarray(phi), dtype=m.dtype,
                                                       device=m.device))
                log("#flow: restart flux from written phi")
            else:
                flux_c, res_c = correct_flux(m, solver.state.flux, p_bcs, pin=pin)
                solver.state = dataclasses.replace(solver.state, flux=flux_c)
                log(f"#flow: correctPhi residual={float(res_c):.3e}")
        # dynamic mesh (constant/dynamicMeshDict; mesh.controlledUpdate(),
        # cudaParticlesPimpleFoam.C:147)
        from . import dynamicmesh as dyn_mod

        motion = dyn_mod.read_dynamic_mesh(case.case_dir)
        if motion is not None:
            from ..io import polymesh as pmio

            solver.dyn = dyn_mod.DynamicMesh(motion, case.poly, dtype=m.dtype, device=m.device)
            u0 = os.path.join(case.case_dir, "0", "U")
            bcs0 = pmio.read_field_bcs(u0) if os.path.exists(u0) else {}
            solver.moving_patches = tuple(
                k for k, e in bcs0.items() if e[0] == "movingWallVelocity")
            # the AMG aggregation is TOPOLOGICAL (face-graph pairing seeded by
            # the initial-geometry weights); the Galerkin coarse operators are
            # rebuilt from the current pressure matrix at every solve
            # (fv.amg_coarse_ops), so the hierarchy stays valid under motion
            log(f"#flow: dynamic mesh: {motion.kind} "
                f"(moving walls: {solver.moving_patches})")
        solver.turb_model = turbulence_model(case.case_dir)
        if solver.turb_model != "laminar":
            from . import turbulence as turb

            solver.kes, solver.k_bcs, solver.e_bcs, solver.wi = turb.init_model(
                solver.turb_model, case.case_dir, m, time_dir=getattr(case, "time_dir", "0"))
            log(f"#flow: {solver.turb_model} closure active")
        log(f"#flow: PIMPLE solver on {m.n_cells} cells, nu={nu}")
        return solver

    def _apply_p_tables(self, t: float):
        """Interpolate the time tables (uniformTotalPressure p0 ramps) into
        the pressure BC offsets for the current time, on the host (numpy
        interp), as JAX does."""
        if not self.p_tables:
            return
        b = self.p_bcs.b.clone()
        names = {p[0]: p for p in self.m.patch_slices}
        for patch, tab in self.p_tables.items():
            if patch not in names:
                continue
            ts = np.array([x[0] for x in tab])
            vs = np.array([x[1] for x in tab])
            val = float(np.interp(t, ts, vs))
            _, _, start, cnt = names[patch]
            b[start : start + cnt, 0] = val
        self.p_bcs = dataclasses.replace(self.p_bcs, b=b)

    def move_mesh(self, dt_e: float):
        """The dynamic-mesh branch of a step (``mesh.controlledUpdate()`` +
        correctPhi + makeRelative, cudaParticlesPimpleFoam.C:144-166): move
        the mesh to ``self.time``, set the moving walls' velocity, rebuild
        the absolute flux of the mapped U on the new metrics, project it
        conservative and make it relative to the mesh motion."""
        from . import dynamicmesh as dyn_mod

        self.m, mesh_phi, bd_vel = self.dyn.update(self.time, dt_e)
        self.u_bcs = dyn_mod.update_moving_wall_bcs(self.m, self.u_bcs, bd_vel,
                                                    self.moving_patches)
        phi_abs = fv.flux_of(self.m, self.state.u,
                             fv.effective_bcs(self.u_bcs, self.state.flux[self.m.n_internal:]))
        phi_abs, _ = correct_flux(self.m, phi_abs, self.p_bcs, pin=self.cfg.pin_pressure)
        self.state = dataclasses.replace(self.state, flux=phi_abs - mesh_phi)

    def advance(self, dt_e: float):
        """One Eulerian step of ``dt_e``; logs JAX's residual line and
        returns the residuals (0-dim tensors, and ``p_iters``)."""
        self.time = self.time + dt_e
        self._apply_p_tables(self.time)
        if self.dyn is not None:
            self.move_mesh(dt_e)
        nut = nut_bd = None
        if self.kes is not None:
            from . import turbulence as turb

            nut = self.kes.nut
            nut_bd = turb.wall_nut_bd(self.m, self.wi, self.kes.nut, self.kes.k, self.cfg.nu)
        self.state, res = pimple_step(self.m, self.state, self.u_bcs, self.p_bcs, self.cfg, dt_e,
                                      nut=nut, amg=self.amg, nut_bd=nut_bd, mrf=self.mrf,
                                      fvo=self.fvo)
        if "fvo_grad_p" in res:
            self.fvo = dataclasses.replace(self.fvo, grad_p=res.pop("fvo_grad_p"),
                                           dgrad=res.pop("fvo_dgrad"))
        if self.kes is not None:
            from . import turbulence as turb

            self.kes = turb.model_step(self.turb_model, self.m, self.kes, self.state.u,
                                       self.u_bcs, self.state.flux, self.k_bcs, self.e_bcs,
                                       self.wi, self.cfg.nu, dt=dt_e)
        # the one host read of the step's residuals
        u_res, p_res, cont = torch.stack(
            [res["u_res"], res["p_res"], res["continuity"]]).tolist()
        self.last = {"u_res": u_res, "p_res": p_res, "continuity": cont}
        self.log(f"#flow: U residual={u_res:.3e} p residual={p_res:.3e} "
                 f"continuity={cont:.3e}")
        return res

    def stable_dt(self, ctrl):
        """maxCo-scaled time step (setDeltaT semantics); reads the Courant
        number on the host."""
        dt0 = ctrl.delta_t
        co = float(courant_number(self.m, self.state.flux, dt0))
        if co <= 0.0:
            return dt0
        scale = min(ctrl.max_co / max(co, 1e-12), 1.2)
        return min(dt0 * scale, ctrl.delta_t * 100)

    def cell_velocity(self) -> np.ndarray:
        return fv.host(self.state.u)

    def write(self, case_dir: str, time_name: str):
        from .simple import write_solution

        return write_solution(case_dir, time_name, self.m, self.state)
