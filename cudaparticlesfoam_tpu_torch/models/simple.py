"""Steady incompressible SIMPLE solver (the ``simpleFoam`` stand-in).

The port of ``cudaparticlesfoam_tpu/models/simple.py``.  The reference's
uncoupled tutorial depends on an external ``simpleFoam`` run for the
frozen field (``pitzDaily/Allrun:8-12``); this module solves the same
steady incompressible momentum/continuity system on the same polyMesh, so
the whole pipeline runs in the port:

    blockMesh (io.blockmesh) -> SIMPLE (here) -> particle advection

Algorithm (standard collocated SIMPLE with Rhie-Chow fluxes), one outer
iteration in four stages that :func:`simple_iteration` runs in order:
  1. :func:`momentum_predictor`: the upwind/diffusion momentum operator
     with the current flux, under-relaxed, Jacobi sweeps with -grad(p);
  2. :func:`pressure_system`: HbyA, its flux and the Laplacian(rAU)
     operator of the pressure equation;
  3. :func:`pressure_solve`: div(rAU grad p) = div(phi*), CG or AMG-CG,
     with the explicit non-orthogonal correctors;
  4. :func:`correct`: flux and velocity correction, pressure relaxation.
Laminar (constant nu), or an eddy viscosity per iteration from
:mod:`.turbulence`.  Torch ops on the tensors' device; no kernel.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
import time

import numpy as np
import torch

from ..dtypes import canonical_device, canonical_float, run_device
from ..io import foamfile, polymesh
from . import fv


@dataclasses.dataclass(frozen=True, eq=False)
class FlowState:
    u: torch.Tensor       # [nc, 3]
    p: torch.Tensor       # [nc]
    flux: torch.Tensor    # [nf]


@dataclasses.dataclass(frozen=True)
class SimpleConfig:
    nu: float = 1e-5
    alpha_u: float = 0.7
    alpha_p: float = 0.3
    n_jacobi: int = 8
    p_tol: float = 1e-7
    p_max_iter: int = 800
    pin_pressure: bool = False   # pin cell 0 when no fixedValue p patch
    # div(phi,U) scheme from system/fvSchemes (deferred correction on top
    # of the implicit upwind matrix): upwind | linear | linearUpwind |
    # limitedLinear
    div_scheme: str = "upwind"
    # explicit non-orthogonal pressure correctors (fvSolution
    # nNonOrthogonalCorrectors; pEqn.H:42-57 loop)
    n_nonortho: int = 0
    # pressure solver: "amg" = AMG-preconditioned CG (GAMG stand-in,
    # needs the hierarchy arg), "cg" = Jacobi-preconditioned CG
    p_solver: str = "cg"


def read_numerics(case_dir: str) -> dict:
    """div(phi,U) scheme + nNonOrthogonalCorrectors/nCorrectors/
    nOuterCorrectors from system/{fvSchemes,fvSolution}.  The div entry is
    parsed from raw text (its key contains parentheses)."""
    out = {"div_scheme": "upwind", "n_nonortho": 0, "n_correctors": 2,
           "n_outer": 1}
    fs = os.path.join(case_dir, "system", "fvSchemes")
    if os.path.exists(fs):
        with open(fs) as fh:
            txt = fh.read()
        mdiv = re.search(r"div\(phi,\s*U\)\s+([^;]+);", txt)
        ent = mdiv.group(1) if mdiv else ""
        if "limitedLinear" in ent:
            out["div_scheme"] = "limitedLinear"
        elif "linearUpwind" in ent:
            out["div_scheme"] = "linearUpwind"
        elif re.search(r"\blinear\b", ent):
            out["div_scheme"] = "linear"
    fsol = os.path.join(case_dir, "system", "fvSolution")
    if os.path.exists(fsol):
        d = foamfile.read(fsol)
        for block in ("SIMPLE", "PIMPLE", "PISO"):
            sub = d.get(block)
            if isinstance(sub, dict):
                out["n_nonortho"] = int(sub.get("nNonOrthogonalCorrectors", 0))
                out["n_correctors"] = int(sub.get("nCorrectors", 2))
                out["n_outer"] = int(sub.get("nOuterCorrectors", 1))
                break
    return out


def _exists(path):
    return os.path.exists(path) or os.path.exists(path + ".gz")


def load_flow_case(case_dir: str, pm=None, dtype=None, time_dir="0", device=None):
    """Read mesh + fields + transportProperties into solver inputs on
    ``device`` (default the card) in ``dtype`` (default float32).

    ``time_dir`` selects the field snapshot directory: "0" for a cold
    start, or the latest written time for a restart.  BC *specs* always
    come from ``0/``: the field writer tags boundaries "calculated"
    (which carries no inlet values).  Internal fields fall back to ``0/``
    when the restart dir misses a field.  Returns (m, state, u_bcs, p_bcs,
    nu, pin, p_tables).
    """
    if pm is None:
        pm = polymesh.read_polymesh(os.path.join(case_dir, "constant", "polyMesh"))
    m = fv.fv_mesh(pm, dtype=canonical_float(dtype), device=canonical_device(device))

    tp = {}
    tp_path = os.path.join(case_dir, "constant", "transportProperties")
    if os.path.exists(tp_path):
        tp = foamfile.read(tp_path)
    nu_e = tp.get("nu", 1e-5)
    # formats: `nu [dims] v;` or `nu v;`
    if isinstance(nu_e, list):
        nu = float([x for x in nu_e if isinstance(x, (int, float))][-1])
    else:
        nu = float(nu_e)

    def field_path(name):
        p = os.path.join(case_dir, str(time_dir), name)
        if _exists(p):
            return p
        return os.path.join(case_dir, "0", name)

    u0_path = field_path("U")
    p0_path = field_path("p")
    u_bc_path = os.path.join(case_dir, "0", "U")
    p_bc_path = os.path.join(case_dir, "0", "p")
    u_bc_spec = polymesh.read_field_bcs(u_bc_path) if os.path.exists(u_bc_path) else {}
    p_bc_spec = polymesh.read_field_bcs(p_bc_path) if os.path.exists(p_bc_path) else {}
    u_bcs = fv.make_bcs(
        m, {k: (e[0], e[1] if e[1] is not None else 0.0) for k, e in u_bc_spec.items()}, 3,
    )
    p_bcs = fv.make_bcs(
        m, {k: (e[0], e[1] if e[1] is not None else 0.0) for k, e in p_bc_spec.items()}, 1,
    )
    # time-varying pressure tables (uniformTotalPressure p0 ramps,
    # TJunction/0/p): {patch: [(t, p0), ...]}
    p_tables = {k: e[2] for k, e in p_bc_spec.items() if len(e) > 2}
    pin = not any(
        e[0] in ("fixedValue", "totalPressure", "uniformTotalPressure")
        for e in p_bc_spec.values()
    )
    u0 = (polymesh.read_field(u0_path, n_cells=pm.n_cells) if _exists(u0_path)
          else np.zeros((pm.n_cells, 3)))
    p0 = (polymesh.read_field(p0_path, n_cells=pm.n_cells) if _exists(p0_path)
          else np.zeros(pm.n_cells))
    u = torch.as_tensor(np.asarray(u0), dtype=m.dtype, device=m.device)
    state = FlowState(
        u=u,
        p=torch.as_tensor(np.asarray(p0).reshape(-1), dtype=m.dtype, device=m.device),
        flux=fv.flux_of(m, u, u_bcs),
    )
    return m, state, u_bcs, p_bcs, nu, pin, p_tables


def _pressure_matrix(m: fv.FvMesh, rau_f, p_bcs, pin: bool):
    """Laplacian(rAU) p  operator coefficients (symmetric), and the
    boundary source."""
    n_int = m.n_internal
    d_i = rau_f[:n_int] * m.delta
    d_b = rau_f[n_int:] * m.bd_delta
    diag = fv.index_sum(m.n_cells, [(m.own_i, d_i), (m.neighbour, d_i),
                                    (m.own_b, d_b * (1.0 - p_bcs.a))])
    if pin:
        diag[0] += 1.0
    src_b = fv.index_sum(m.n_cells, [(m.own_b, d_b * p_bcs.b[:, 0])])
    return fv.FvMatrix(diag=diag, lower=-d_i, upper=-d_i, source=src_b[:, None]), src_b


@dataclasses.dataclass(frozen=True, eq=False)
class Momentum:
    """What the momentum predictor hands to the pressure stages."""

    u_bcs: fv.BoundaryCoeffs   # after the inletOutlet switch
    A_rel: fv.FvMatrix         # under-relaxed momentum operator
    b_rel: torch.Tensor        # its source, with -grad(p) V
    grad_p: torch.Tensor       # [nc, 3]
    u_star: torch.Tensor       # [nc, 3] predicted velocity
    u_res: torch.Tensor        # inner (final) residual
    u_res0: torch.Tensor       # initial residual (residualControl's)


def momentum_predictor(m: fv.FvMesh, st: FlowState, u_bcs, p_bcs, cfg: SimpleConfig,
                       nut=None, nut_bd=None) -> Momentum:
    """Stage 1: assemble, under-relax and Jacobi-solve the momentum
    equation with the current pressure gradient."""
    # effective facewise viscosity: laminar + optional eddy viscosity
    # (nut_bd carries the nutkWallFunction values on wall faces)
    if nut is None:
        nu_f = cfg.nu
    else:
        nut_b = nut[m.own_b] if nut_bd is None else nut_bd
        nu_f = cfg.nu + torch.cat([fv.face_interp(m, nut), nut_b])

    # inletOutlet-family backflow switching against the current flux
    u_bcs = fv.effective_bcs(u_bcs, st.flux[m.n_internal :])

    # momentum operator (volume-integrated; rho = 1)
    A = fv.assemble_transport(m, st.flux, nu_f, u_bcs, 3)

    grad_p = fv.gradient(m, st.p, p_bcs)
    b = A.source - grad_p * m.vol[:, None]
    # deferred high-order convection (fvSchemes div(phi,U))
    b = b + fv.convection_correction(m, st.flux, st.u, u_bcs, cfg.div_scheme)

    # under-relaxation (OpenFOAM style): aP' = aP/alpha, b += (1-a)/a aP U.
    # The divisor is a 0-dim tensor: torch divides a CUDA tensor by a
    # Python scalar as a multiplication by its reciprocal, the CPU divides
    diag_rel = A.diag / torch.tensor(cfg.alpha_u, dtype=m.dtype, device=m.device)
    b_rel = b + ((1.0 - cfg.alpha_u) / cfg.alpha_u) * A.diag[:, None] * st.u
    A_rel = dataclasses.replace(A, diag=diag_rel)

    u_star = fv.jacobi_solve(m, A_rel, b_rel, st.u, sweeps=cfg.n_jacobi)
    norm_b = torch.linalg.vector_norm(b_rel) + 1e-300
    u_res = torch.linalg.vector_norm(b_rel - fv.matvec(m, A_rel, u_star)) / norm_b
    # OpenFOAM-style INITIAL residual (the quantity residualControl
    # watches): momentum imbalance of the incoming field against this
    # iteration's assembled system
    u_res0 = torch.linalg.vector_norm(b_rel - fv.matvec(m, A_rel, st.u)) / norm_b
    return Momentum(u_bcs=u_bcs, A_rel=A_rel, b_rel=b_rel, grad_p=grad_p, u_star=u_star,
                    u_res=u_res, u_res0=u_res0)


def pressure_system(m: fv.FvMesh, mo: Momentum, p_bcs, cfg: SimpleConfig):
    """Stage 2: Rhie-Chow HbyA = (b_without_gradp - offdiag U*) / aP', its
    flux, and the pressure equation Ap p = rhs (Ap the negative
    Laplacian(rAU), positive definite).  Returns (rau, hbya, phi_hbya,
    rau_f, Ap, rhs)."""
    diag_rel = mo.A_rel.diag
    rau = m.vol / diag_rel                      # [nc]  (V/aP)
    hbya = (mo.b_rel + mo.grad_p * m.vol[:, None] - (
        fv.matvec(m, mo.A_rel, mo.u_star) - diag_rel[:, None] * mo.u_star
    )) / diag_rel[:, None]
    phi_hbya = fv.flux_of(m, hbya, mo.u_bcs)
    rau_f = torch.cat([fv.face_interp(m, rau), rau[m.own_b]])
    Ap, _ = _pressure_matrix(m, rau_f, p_bcs, cfg.pin_pressure)
    rhs = Ap.source[:, 0] - fv.surface_sum(m, phi_hbya)
    return rau, hbya, phi_hbya, rau_f, Ap, rhs


def pressure_solve(m: fv.FvMesh, Ap, rhs, p0, rau_f, p_bcs, cfg: SimpleConfig, amg=None):
    """Stage 3: the pressure solve from ``p0``; explicit non-orthogonal
    correctors re-solve with the k . grad(p)_f flux of the latest p
    (pEqn.H:42-57).  Returns (p, corr, p_res, p_iters)."""
    p_new = p0
    corr = torch.zeros(m.n_internal, dtype=m.dtype, device=m.device)
    p_res = torch.zeros((), dtype=m.dtype, device=m.device)
    p_iters = 0
    for no in range(cfg.n_nonortho + 1):
        b = rhs + fv.surface_sum_internal(m, corr)
        if cfg.p_solver == "amg":
            p_new, p_res, p_iters = fv.amg_cg_solve(
                m, amg, Ap, b, p_new, tol=cfg.p_tol, max_iter=cfg.p_max_iter)
        else:
            p_new, p_res, p_iters = fv.cg_solve(
                m, Ap, b, p_new, tol=cfg.p_tol, max_iter=cfg.p_max_iter)
        if no < cfg.n_nonortho:
            corr = fv.nonortho_flux(m, rau_f, p_new, p_bcs)
    return p_new, corr, p_res, p_iters


def correct(m: fv.FvMesh, st: FlowState, rau, hbya, phi_hbya, rau_f, p_new, corr, p_bcs,
            cfg: SimpleConfig):
    """Stage 4: flux and velocity correction, pressure relaxation.
    Returns (state, continuity)."""
    # correct flux: phi = phi_hbya - rau_f * delta * (p_N - p_O) - corr on
    # internal; boundary: subtract rau_f * d_b * ((a-1) p_P + b)
    n_int = m.n_internal
    dp = p_new[m.neighbour] - p_new[m.own_i]
    flux_i = phi_hbya[:n_int] - rau_f[:n_int] * m.delta * dp - corr
    dp_b = (p_bcs.a - 1.0) * p_new[m.own_b] + p_bcs.b[:, 0]
    flux_b = phi_hbya[n_int:] - rau_f[n_int:] * m.bd_delta * dp_b
    flux = torch.cat([flux_i, flux_b])

    # correct velocity, relax pressure
    grad_pn = fv.gradient(m, p_new, p_bcs)
    u_new = hbya - rau[:, None] * grad_pn
    p_relaxed = st.p + cfg.alpha_p * (p_new - st.p)

    continuity = torch.sum(torch.abs(fv.surface_sum(m, flux)))
    return FlowState(u=u_new, p=p_relaxed, flux=flux), continuity


def simple_iteration(m: fv.FvMesh, st: FlowState, u_bcs, p_bcs, cfg: SimpleConfig,
                     nut=None, amg=None, nut_bd=None):
    """One SIMPLE outer iteration; returns (state, residuals dict).  The
    residuals are 0-dim tensors, ``p_iters`` a Python int (the pressure
    solve's last CG count)."""
    mo = momentum_predictor(m, st, u_bcs, p_bcs, cfg, nut=nut, nut_bd=nut_bd)
    rau, hbya, phi_hbya, rau_f, Ap, rhs = pressure_system(m, mo, p_bcs, cfg)
    p_new, corr, p_res, p_iters = pressure_solve(m, Ap, rhs, st.p, rau_f, p_bcs, cfg, amg)
    new, continuity = correct(m, st, rau, hbya, phi_hbya, rau_f, p_new, corr, p_bcs, cfg)
    return new, {"u_res": mo.u_res, "u_res0": mo.u_res0, "p_res": p_res,
                 "p_iters": p_iters, "continuity": continuity}


def turbulence_model(case_dir: str) -> str:
    """simulationType/RASModel from constant/turbulenceProperties."""
    path = os.path.join(case_dir, "constant", "turbulenceProperties")
    if not os.path.exists(path):
        return "laminar"
    d = foamfile.read(path)
    sim = str(d.get("simulationType", "laminar"))
    if sim == "laminar":
        return "laminar"
    if sim != "RAS":
        raise ValueError(
            f"unsupported simulationType {sim!r} in {path} "
            "(supported: laminar, RAS)"
        )
    ras = d.get("RAS", {})
    if not isinstance(ras, dict):
        raise ValueError(f"RAS sub-dictionary missing/malformed in {path}")
    if str(ras.get("turbulence", "on")) not in ("on", "true", "yes", "1"):
        return "laminar"
    model = str(ras.get("RASModel", ""))
    if model in ("kEpsilon", "kOmegaSST"):
        return model
    raise ValueError(
        f"unsupported RASModel {model!r} in {path} "
        "(supported: kEpsilon, kOmegaSST; the reference constructs any "
        "OpenFOAM model, applications/cudaParticlesPimpleFoam/"
        "createFields.H:53-61)"
    )


def read_residual_control(case_dir: str) -> dict:
    """fvSolution SIMPLE.residualControl entries ({field: tol})."""
    fsol = os.path.join(case_dir, "system", "fvSolution")
    if not os.path.exists(fsol):
        return {}
    d = foamfile.read(fsol)
    sub = d.get("SIMPLE")
    rc = sub.get("residualControl") if isinstance(sub, dict) else None
    return {k: float(v) for k, v in rc.items()
            if isinstance(v, (int, float))} if isinstance(rc, dict) else {}


def solve_steady(
    case_dir: str,
    pm=None,
    n_iters: int = 500,
    cfg: SimpleConfig | None = None,
    tol: float | None = None,
    dtype=None,
    log=print,
    log_every: int = 50,
    turbulence: str | None = None,
    device=None,
    on_iteration=None,
):
    """Run SIMPLE to (approximate) steadiness on ``device`` (default the
    card) in ``dtype`` (default float32); returns (m, state, bcs).

    ``tol`` defaults to fvSolution's ``SIMPLE.residualControl.U`` when
    present (the mechanism that stops the reference's simpleFoam early,
    ``pitzDaily/system/fvSolution``); the number of iterations actually
    run is recorded at ``bcs[3]`` so callers can reconstruct OpenFOAM's
    iteration-time (runTime = startTime + iters * deltaT).  The host reads
    the residuals once per iteration (one copy of four scalars);
    ``on_iteration(i, residuals)``, when given, gets them (floats, and
    ``p_iters``) after each iteration.
    """
    from . import turbulence as turb

    m, st, u_bcs, p_bcs, nu, pin, _ = load_flow_case(case_dir, pm=pm, dtype=dtype,
                                                      device=device)
    num = read_numerics(case_dir)
    rc = read_residual_control(case_dir)
    if tol is None:
        # default to fvSolution's SIMPLE.residualControl.U; an explicit
        # caller tolerance wins over the case value
        tol = float(rc["U"]) if "U" in rc else 1e-5
    if cfg is None:
        cfg = SimpleConfig(nu=nu, pin_pressure=pin,
                           div_scheme=num["div_scheme"],
                           n_nonortho=num["n_nonortho"], p_solver="amg")
    else:
        cfg = dataclasses.replace(cfg, nu=nu, pin_pressure=pin)
    amg = fv.build_amg(m) if cfg.p_solver == "amg" else None
    turbulence = turbulence if turbulence is not None else turbulence_model(case_dir)
    kes = k_bcs = e_bcs = wi = None
    if turbulence != "laminar":
        kes, k_bcs, e_bcs, wi = turb.init_model(turbulence, case_dir, m, dtype=m.dtype)
        log(f"#flow: {turbulence} closure active ({wi.wall_cell.numel()} wall cells)")
    for i in range(n_iters):
        nut_bd = None
        if kes is not None:
            nut_bd = turb.wall_nut_bd(m, wi, kes.nut, kes.k, cfg.nu)
        st, res = simple_iteration(
            m, st, u_bcs, p_bcs, cfg, nut=None if kes is None else kes.nut,
            amg=amg, nut_bd=nut_bd,
        )
        if kes is not None:
            kes = turb.model_step(
                turbulence, m, kes, st.u, u_bcs, st.flux, k_bcs, e_bcs, wi, cfg.nu,
            )
        # the one host read of this iteration's residuals
        u_res, u_res0, p_res, cont = torch.stack(
            [res["u_res"], res["u_res0"], res["p_res"], res["continuity"]]).tolist()
        if on_iteration is not None:
            on_iteration(i, {"u_res": u_res, "u_res0": u_res0, "p_res": p_res,
                             "p_iters": res["p_iters"], "continuity": cont})
        if i % log_every == 0:
            log(
                f"SIMPLE iter {i}: Ux residual={u_res:.3e} "
                f"p residual={p_res:.3e} "
                f"(CG {int(res['p_iters'])}) continuity={cont:.3e}"
            )
        if u_res0 < tol and i >= 10:
            # initial-residual control like OpenFOAM's residualControl
            # (>=10 iterations so the still-uniform startup field cannot
            # satisfy it spuriously)
            log(f"SIMPLE converged in {i} iterations "
                f"(initial residual {u_res0:.3e})")
            n_done = i + 1
            break
    else:
        n_done = n_iters
    return m, st, (u_bcs, p_bcs, cfg, n_done)


def write_solution(case_dir: str, time_name: str, m: fv.FvMesh, st: FlowState,
                   binary: bool = False, compress: bool = False):
    """Write U and p time-directory fields (OpenFOAM format), and the face
    flux ``phi``."""
    out = os.path.join(case_dir, time_name)
    os.makedirs(out, exist_ok=True)
    bf = {name: {"type": "calculated"} for name, *_ in m.patch_slices}
    polymesh.write_field(
        os.path.join(out, "U"), "U", fv.host(st.u),
        dimensions=(0, 1, -1, 0, 0, 0, 0), location=time_name,
        boundary_field=bf, binary=binary, compress=compress,
    )
    polymesh.write_field(
        os.path.join(out, "p"), "p", fv.host(st.p),
        dimensions=(0, 2, -2, 0, 0, 0, 0), location=time_name,
        boundary_field=bf, binary=binary, compress=compress,
    )
    # phi: the conservative face flux, so restarts resume exactly
    # (OpenFOAM's runTime.write() stores it too)
    flux = fv.host(st.flux).astype(np.float64)
    n_int = m.n_internal
    bd = {
        name: flux[n_int + start : n_int + start + cnt]
        for name, _, start, cnt in m.patch_slices
    }
    polymesh.write_surface_field(
        os.path.join(out, "phi"), "phi", flux[:n_int], bd,
        binary=binary, compress=compress,
    )
    return out


def purge_old_times(case_dir: str, keep: int) -> None:
    """OpenFOAM ``purgeWrite N``: keep only the newest ``keep`` written
    (non-zero) time directories."""
    if keep <= 0:
        return
    times = []
    for d in os.listdir(case_dir):
        full = os.path.join(case_dir, d)
        if not os.path.isdir(full):
            continue
        try:
            t = float(d)
        except ValueError:
            continue
        if t > 0.0:
            times.append((t, full))
    times.sort()
    for _, full in times[:-keep] if keep < len(times) else []:
        shutil.rmtree(full, ignore_errors=True)


def run(case_dir: str, n_iters: int | None = None, log=print, dtype=None, device=None):
    """CLI entry: solve steady flow on ``device`` (default the card) and
    write it at OpenFOAM's iteration-time.

    simpleFoam's runTime is the iteration counter scaled by deltaT; the
    reference tutorial relies on ``residualControl`` stopping the solve
    INSIDE the particle window [startTime, endTime] of
    ``cudaParticlesDict`` (``pitzDaily/Allrun:8-12`` + ``advect.H:33``).
    Convergence rates differ between solvers, so when the case carries a
    particle dict and the iteration-time misses its window, the write
    time is clamped into the window (logged); the tutorial dicts then
    run unmodified.  Without ``constant/polyMesh`` the mesh comes from
    ``system/blockMeshDict``.

    Logs the phase table (Mesh, SIMPLE, IO, Streamlines: device spans and
    the host's clock, as the uncoupled driver's) and a ``#flow:`` line
    with the iterations, ms per iteration after the first (on the card
    between CUDA events, beside the host's clock), the CG iterations per
    pressure solve and, on the card, the peak device memory.  Returns (m,
    state, stats).
    """
    from ..config import ControlConfig, ParticlesConfig
    from ..utils.profiling import PhaseTimer

    device = run_device(device)
    cuda = device.type == "cuda"
    timer = PhaseTimer(device)
    ctrl = ControlConfig.from_case(case_dir)
    pm = None
    mesh_dir = os.path.join(case_dir, "constant", "polyMesh")
    with timer.phase("Mesh"):
        if not os.path.exists(os.path.join(mesh_dir, "points")):
            from ..io import blockmesh

            pm = blockmesh.generate(os.path.join(case_dir, "system", "blockMeshDict"))
        else:
            pm = polymesh.read_polymesh(mesh_dir)
    cg_iters, marks = [], []

    def on_iteration(i, res):
        cg_iters.append(res["p_iters"])
        ev = None
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(device))
        marks.append((time.perf_counter(), ev))

    with timer.phase("SIMPLE"):
        m, st, bcs = solve_steady(case_dir, pm=pm, n_iters=n_iters or 500, log=log,
                                  dtype=dtype, device=device, on_iteration=on_iteration)
    n_done = bcs[3]
    t_write = min(ctrl.start_time + n_done * ctrl.delta_t, ctrl.end_time)
    pd_path = os.path.join(case_dir, "system", "cudaParticlesDict")
    if os.path.exists(pd_path):
        pcfg = ParticlesConfig.from_case(case_dir)
        if not (pcfg.start_time <= t_write <= pcfg.end_time):
            clamped = min(max(t_write, pcfg.start_time), pcfg.end_time)
            log(
                f"#flow: iteration-time {t_write:g} outside the particle "
                f"window [{pcfg.start_time:g}, {pcfg.end_time:g}]; "
                f"writing at {clamped:g} so the tracker's latestTime "
                "pickup fires (advect.H:33)"
            )
            t_write = clamped
    tname = f"{t_write:g}"
    with timer.phase("IO"):
        out = write_solution(case_dir, tname, m, st)
    log(f"wrote steady solution to {out}")
    with timer.phase("Streamlines"):
        run_streamline_functions(case_dir, tname, st.u, pm=pm, log=log)
    timer.report(log=log)
    stats = {"iterations": n_done, "time": tname, "cg_iters": cg_iters,
             "phases": dict(timer.totals), "host_phases": dict(timer.host)}
    n_timed = len(marks) - 1
    if n_timed > 0:
        host_ms = (marks[-1][0] - marks[0][0]) * 1e3 / n_timed
        dev_ms = marks[0][1].elapsed_time(marks[-1][1]) / n_timed if cuda else host_ms
        stats.update(ms_per_iteration=dev_ms, host_ms_per_iteration=host_ms)
        where = (f"{dev_ms:.3f} ms/iteration on the device, {host_ms:.3f} ms/iteration on "
                 f"the host" if cuda else f"{host_ms:.3f} ms/iteration on the CPU")
        line = (f"#flow: SIMPLE {n_done} iterations: {where} (iterations 1-{n_timed}); "
                f"CG iterations per pressure solve min/mean/max {min(cg_iters)}/"
                f"{sum(cg_iters) / len(cg_iters):.1f}/{max(cg_iters)}")
        if cuda:
            stats["peak_bytes"] = torch.cuda.max_memory_allocated(device)
            line += (f"; on {torch.cuda.get_device_name(device)}, peak device memory "
                     f"{stats['peak_bytes'] / 2**30:.3f} GiB")
        log(line)
    return m, st, stats


def run_streamline_functions(case_dir: str, time_name: str, u_cells,
                             pm=None, log=print):
    """controlDict ``streamLine`` function objects on the solved field
    (``pitzDaily/system/controlDict:46-74``): seed nLines points uniformly
    on [start, end], integrate field lines, write a VTK polyline file to
    postProcessing/<name>/<time>/tracks.vtk.  The lines are traced on
    ``u_cells``'s device (a numpy array: the CPU)."""
    cd = foamfile.read(os.path.join(case_dir, "system", "controlDict"))
    fns = cd.get("functions", {})
    if not isinstance(fns, dict):
        return
    specs = {
        name: spec for name, spec in fns.items()
        if isinstance(spec, dict) and spec.get("type") == "streamLine"
    }
    if not specs:
        return
    from ..ops import locate as locate_ops
    from . import functions as fo

    if torch.is_tensor(u_cells):
        device, u_cells = u_cells.device, fv.host(u_cells)
    else:
        device = torch.device("cpu")
    if pm is None:
        pm = polymesh.read_polymesh(os.path.join(case_dir, "constant", "polyMesh"))
    tet_mesh, _ = polymesh.mesh_from_polymesh(pm, u_cells=np.asarray(u_cells), device=device)
    locator = locate_ops.build_grid_locator(tet_mesh)
    for name, spec in specs.items():
        seed = spec.get("seedSampleSet", {})
        start = np.asarray(
            [float(x) for x in spec.get("start", seed.get("start", [0, 0, 0]))]
        )
        end = np.asarray(
            [float(x) for x in spec.get("end", seed.get("end", [0, 0, 0]))]
        )
        n_lines = int(spec.get("nLines", seed.get("nPoints", 10)))
        life = int(spec.get("lifeTime", 2000))
        frac = np.linspace(0.0, 1.0, n_lines)[:, None]
        seeds = start[None, :] * (1.0 - frac) + end[None, :] * frac
        # spatial step ~ a fraction of the mean cell size
        ext = (tet_mesh.host["bounds_hi"].astype(np.float64)
               - tet_mesh.host["bounds_lo"].astype(np.float64))
        h = float(np.max(ext)) / max(pm.n_cells ** (1 / 3), 1.0)
        lines = fo.trace_streamlines(
            tet_mesh, locator, seeds, step_length=h,
            n_steps=min(life, 4000),
        )
        odir = os.path.join(case_dir, "postProcessing", str(name), time_name)
        os.makedirs(odir, exist_ok=True)
        path = os.path.join(odir, "tracks.vtk")
        fo.write_streamlines_vtk(path, lines)
        log(f"#fo: streamLine '{name}': {n_lines} lines -> {path}")
