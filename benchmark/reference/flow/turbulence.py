"""A frozen copy of the port's ``models/turbulence.py``, for the flow reference.

RAS turbulence closures: standard k-epsilon and k-omega SST.

The port of ``cudaparticlesfoam_tpu/models/turbulence.py`` on torch
tensors: two upwind/diffusion transport equations with linearized sinks,
solved by Jacobi sweeps, the eddy viscosity, and the wall treatment of the
JAX package (log-law epsilon / blended omega pinned in wall-adjacent cells
by a large diagonal, zero-gradient k, nutkWallFunction on wall faces).
The host-side set-up (wall cells, wall distance) is numpy, as in JAX.

Coefficients: Cmu=0.09, C1=1.44, C2=1.92, sigma_k=1.0, sigma_eps=1.3
(standard Launder-Sharma constants, as OpenFOAM's kEpsilon); Menter 2003
for kOmegaSST (OpenFOAM's constants).

Where the JAX code divides by a Python scalar (the relaxation factor, the
Prandtl numbers), this module divides by a 0-dim tensor (:func:`_div`):
torch divides a CUDA tensor by a Python scalar as a multiplication by its
reciprocal, which can differ from the division in the last bit, while the
CPU divides; a 0-dim tensor divides on both.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from . import fv, polymesh

CMU = 0.09
C1 = 1.44
C2 = 1.92
SIGMA_K = 1.0
SIGMA_EPS = 1.3
KAPPA = 0.41
SMALL = 1e-10


def _div(x, s: float):
    """x / s, divided as on the CPU on every device (module docstring)."""
    return x / torch.tensor(s, dtype=x.dtype, device=x.device)


@dataclasses.dataclass(frozen=True, eq=False)
class KEpsilonState:
    k: torch.Tensor      # [nc]
    eps: torch.Tensor    # [nc]
    nut: torch.Tensor    # [nc]


@dataclasses.dataclass(frozen=True, eq=False)
class WallInfo:
    wall_cell: torch.Tensor     # [nw] wall-adjacent cell ids (a cell may repeat)
    y_wall: torch.Tensor        # [nw] wall distance of those cells
    wall_bd_face: torch.Tensor  # [nw] boundary-face index (bd numbering)


def wall_info(m: fv.FvMesh) -> WallInfo:
    """Wall-adjacent cells + their distance to the wall face."""
    cells = []
    ys = []
    bfaces = []
    n_int = m.n_internal
    cf = fv.host(m.cf)
    sf = fv.host(m.sf)
    mag = fv.host(m.mag_sf)
    cc = fv.host(m.cc)
    own = fv.host(m.owner)
    for name, ptype, start, cnt in m.patch_slices:
        if ptype != "wall":
            continue
        f = np.arange(start, start + cnt) + n_int
        c = own[f]
        nhat = sf[f] / np.maximum(mag[f], 1e-300)[:, None]
        y = np.abs(np.einsum("ij,ij->i", cf[f] - cc[c], nhat))
        cells.append(c)
        ys.append(y)
        bfaces.append(f - n_int)
    as_i = lambda x: torch.as_tensor(x, dtype=torch.int64, device=m.device)  # noqa: E731
    if not cells:
        return WallInfo(
            wall_cell=as_i(np.zeros(0, np.int64)),
            y_wall=torch.zeros(0, dtype=m.dtype, device=m.device),
            wall_bd_face=as_i(np.zeros(0, np.int64)),
        )
    return WallInfo(
        wall_cell=as_i(np.concatenate(cells)),
        y_wall=torch.as_tensor(np.concatenate(ys), dtype=m.dtype, device=m.device),
        wall_bd_face=as_i(np.concatenate(bfaces)),
    )


E_WALL = 9.8          # log-law constant (OpenFOAM nutkWallFunction)
YPLUS_LAM = 11.53     # laminar/log-law crossover for kappa=0.41, E=9.8


def wall_nut_bd(m: fv.FvMesh, wi: WallInfo, nut, k, nu):
    """Boundary-face eddy viscosity with the nutkWallFunction on walls:
    yPlus = Cmu^1/4 sqrt(k) y / nu; nut_w = nu (yPlus kappa / ln(E yPlus)
    - 1) in the log layer, 0 in the viscous sublayer.  Non-wall faces keep
    the owner-cell nut."""
    out = nut[m.own_b]
    kw = torch.clamp(k[wi.wall_cell], min=SMALL)
    yplus = _div(CMU ** 0.25 * torch.sqrt(kw) * wi.y_wall, nu)
    nut_w = torch.where(
        yplus > YPLUS_LAM,
        nu * (yplus * KAPPA / torch.log(torch.clamp(E_WALL * yplus, min=1.0 + SMALL)) - 1.0),
        0.0,
    )
    out[wi.wall_bd_face] = torch.clamp(nut_w, min=0.0)
    return out


def _field_paths(case_dir, time_dir):
    def field(name):
        p = os.path.join(case_dir, str(time_dir), name)
        if os.path.exists(p) or os.path.exists(p + ".gz"):
            return p
        return os.path.join(case_dir, "0", name)

    def exists(p):
        return os.path.exists(p) or os.path.exists(p + ".gz")

    return field, exists


def _turb_bcs(m: fv.FvMesh, spec: dict):
    """BCs of a transported turbulence field: wall functions behave as
    zeroGradient for the transported value; turbulent inlet generators
    reduce to fixedValue at their init value."""
    mapped = {}
    for name, entry in spec.items():
        t, v = entry[0], entry[1]
        if "WallFunction" in t:
            mapped[name] = ("zeroGradient", 0.0)
        elif t in (
            "turbulentIntensityKineticEnergyInlet",
            "turbulentMixingLengthDissipationRateInlet",
            "turbulentMixingLengthFrequencyInlet",
        ):
            mapped[name] = ("fixedValue", v if v is not None else 1e-3)
        else:
            mapped[name] = (t, v if v is not None else 0.0)
    return fv.make_bcs(m, mapped, 1)


def _read_spec(case_dir, name):
    path = os.path.join(case_dir, "0", name)
    return polymesh.read_field_bcs(path) if os.path.exists(path) else {}


def init_from_case(case_dir: str, m: fv.FvMesh, dtype=None, time_dir="0"):
    """Read k and epsilon internal fields from ``time_dir`` (restart) with
    a 0/ fallback; BC specs always from 0/ (written fields tag their
    boundaries "calculated")."""
    dtype = dtype or m.dtype
    nc = m.n_cells
    field, exists = _field_paths(case_dir, time_dir)
    k_path = field("k")
    e_path = field("epsilon")
    k0 = polymesh.read_field(k_path, n_cells=nc) if exists(k_path) else np.full(nc, 1e-3)
    e0 = polymesh.read_field(e_path, n_cells=nc) if exists(e_path) else np.full(nc, 1e-3)
    k = torch.as_tensor(np.asarray(k0).reshape(-1), dtype=dtype, device=m.device)
    eps = torch.as_tensor(np.asarray(e0).reshape(-1), dtype=dtype, device=m.device)
    nut = torch.clamp(CMU * k * k / torch.clamp(eps, min=SMALL), min=0.0)
    return (
        KEpsilonState(k=k, eps=eps, nut=nut),
        _turb_bcs(m, _read_spec(case_dir, "k")),
        _turb_bcs(m, _read_spec(case_dir, "epsilon")),
        wall_info(m),
    )


def strain_rate_sq(m: fv.FvMesh, u, u_bcs):
    """S2 = 2 Sij Sij from the Gauss velocity gradient."""
    grads = []
    for comp in range(3):
        bc_c = fv.BoundaryCoeffs(a=u_bcs.a, b=u_bcs.b[:, comp : comp + 1])
        grads.append(fv.gradient(m, u[:, comp], bc_c))
    g = torch.stack(grads, dim=1)                  # [nc, comp_i, d/dx_j]
    s = 0.5 * (g + g.transpose(1, 2))
    return 2.0 * torch.sum(s * s, dim=(1, 2))


def production(m: fv.FvMesh, u, u_bcs, nut):
    """P_k = nut * 2 Sij Sij from the Gauss velocity gradient."""
    return nut * strain_rate_sq(m, u, u_bcs)


def _face_gamma(m, nu, cell_diff):
    """nu + the cell diffusivity on faces (linear inside, owner on the
    boundary)."""
    return nu + torch.cat([fv.face_interp(m, cell_diff), cell_diff[m.own_b]])


def _relaxed_jacobi(m, A, diag, src, x, dt, relax, n_sweeps):
    """Steady (``dt`` None): under-relax as OpenFOAM does, then Jacobi."""
    if dt is None:
        src = src + ((1.0 - relax) / relax) * diag * x
        diag = _div(diag, relax)
    A2 = dataclasses.replace(A, diag=diag)
    return fv.jacobi_solve(m, A2, src[:, None], x[:, None], sweeps=n_sweeps)[:, 0]


def _ddt(m, dt):
    return None if dt is None else m.vol / torch.as_tensor(dt, dtype=m.dtype, device=m.device)


def k_epsilon_step(
    m: fv.FvMesh,
    st: KEpsilonState,
    u, u_bcs, flux,
    k_bcs, e_bcs,
    wi: WallInfo,
    nu: float,
    dt=None,
    n_sweeps: int = 6,
    relax: float = 0.7,
):
    """One k-epsilon update (steady: under-relaxed; transient: pass dt)."""
    k = torch.clamp(st.k, min=SMALL)
    eps = torch.clamp(st.eps, min=SMALL)
    nut = st.nut
    pk = production(m, u, u_bcs, nut)
    ddt = _ddt(m, dt)

    # epsilon equation
    gamma_e = nu + _div(torch.cat([fv.face_interp(m, nut), nut[m.own_b]]), SIGMA_EPS)
    Ae = fv.assemble_transport(
        m, flux, gamma_e, e_bcs, 1,
        ddt_coeff=ddt, phi_old=eps[:, None] if dt is not None else None,
    )
    # sinks/sources: + C1 pk eps/k  - C2 eps^2/k (implicit in eps)
    diag_e = Ae.diag + C2 * (eps / k) * m.vol
    src_e = Ae.source[:, 0] + C1 * pk * (eps / k) * m.vol
    # wall cells: fix eps by the log law; a cell on two wall faces takes
    # the penalty twice, as JAX's .at[].add does
    ew = CMU ** 0.75 * torch.clamp(k[wi.wall_cell], min=SMALL) ** 1.5 / (
        KAPPA * torch.clamp(wi.y_wall, min=SMALL)
    )
    big = torch.tensor(1e30, dtype=m.dtype, device=m.device)
    diag_e = fv.index_sum(m.n_cells, [(wi.wall_cell, big.expand(wi.wall_cell.shape[0]))],
                          out=diag_e)
    src_e = fv.index_sum(m.n_cells, [(wi.wall_cell, big * ew)], out=src_e)
    eps_new = _relaxed_jacobi(m, Ae, diag_e, src_e, eps, dt, relax, n_sweeps)
    eps_new = torch.clamp(eps_new, min=SMALL)

    # k equation
    gamma_k = nu + _div(torch.cat([fv.face_interp(m, nut), nut[m.own_b]]), SIGMA_K)
    Ak = fv.assemble_transport(
        m, flux, gamma_k, k_bcs, 1,
        ddt_coeff=ddt, phi_old=k[:, None] if dt is not None else None,
    )
    diag_k = Ak.diag + (eps_new / k) * m.vol          # implicit sink eps = (eps/k)k
    src_k = Ak.source[:, 0] + pk * m.vol
    k_new = _relaxed_jacobi(m, Ak, diag_k, src_k, k, dt, relax, n_sweeps)
    k_new = torch.clamp(k_new, min=SMALL)

    nut_new = torch.clamp(CMU * k_new * k_new / torch.clamp(eps_new, min=SMALL), 0.0, 1e5)
    return KEpsilonState(k=k_new, eps=eps_new, nut=nut_new)


# ---------------------------------------------------------------------------
# k-omega SST (Menter 2003, OpenFOAM kOmegaSST constants)
# ---------------------------------------------------------------------------

A1_SST = 0.31
B1_SST = 1.0
C1_SST = 10.0
BETA_STAR = 0.09
ALPHA_K1, ALPHA_K2 = 0.85, 1.0
ALPHA_W1, ALPHA_W2 = 0.5, 0.856
BETA1, BETA2 = 0.075, 0.0828
GAMMA1, GAMMA2 = 5.0 / 9.0, 0.44


@dataclasses.dataclass(frozen=True, eq=False)
class KOmegaSSTState:
    k: torch.Tensor       # [nc]
    omega: torch.Tensor   # [nc]
    nut: torch.Tensor     # [nc]
    y: torch.Tensor       # [nc] wall distance (static per mesh; carried in
    #                       the state so the step signature matches kEpsilon)


def wall_distance(m: fv.FvMesh) -> np.ndarray:
    """Per-cell distance to the nearest wall face centre (host-side; a k-d
    tree, or chunked brute force where scipy is missing): the SST blending
    functions need y everywhere, not just in wall-adjacent cells."""
    n_int = m.n_internal
    cf = fv.host(m.cf)
    cc = fv.host(m.cc)
    wall_f = []
    for name, ptype, start, cnt in m.patch_slices:
        if ptype == "wall":
            wall_f.append(np.arange(start, start + cnt) + n_int)
    if not wall_f:
        return np.full(m.n_cells, 1e10)
    wf = cf[np.concatenate(wall_f)]
    if len(wf) == 0:
        return np.full(m.n_cells, 1e10)
    try:
        from scipy.spatial import cKDTree

        return cKDTree(wf).query(cc, workers=-1)[0]
    except ImportError:
        pass
    return _wall_distance_brute(cc, wf)


def _wall_distance_brute(cc, wf):
    y = np.empty(len(cc))
    step = max(1, 2**22 // max(len(wf), 1))
    for c0 in range(0, len(cc), step):
        d = cc[c0 : c0 + step, None, :] - wf[None, :, :]
        y[c0 : c0 + step] = np.sqrt((d * d).sum(axis=2).min(axis=1))
    return y


def init_from_case_sst(case_dir: str, m: fv.FvMesh, dtype=None, time_dir="0"):
    """Read k and omega fields (restart-aware, 0/ fallback); omega falls
    back to eps/(Cmu k) when only epsilon exists, else 1."""
    dtype = dtype or m.dtype
    nc = m.n_cells
    field, exists = _field_paths(case_dir, time_dir)
    k_path = field("k")
    w_path = field("omega")
    k0 = polymesh.read_field(k_path, n_cells=nc) if exists(k_path) else np.full(nc, 1e-3)
    if exists(w_path):
        w0 = polymesh.read_field(w_path, n_cells=nc)
    else:
        e_path = field("epsilon")
        if exists(e_path):
            e0 = polymesh.read_field(e_path, n_cells=nc)
            w0 = np.asarray(e0).reshape(-1) / np.maximum(
                CMU * np.asarray(k0).reshape(-1), SMALL
            )
        else:
            w0 = np.full(nc, 1.0)
    k = torch.as_tensor(np.asarray(k0).reshape(-1), dtype=dtype, device=m.device)
    w = torch.clamp(torch.as_tensor(np.asarray(w0).reshape(-1), dtype=dtype, device=m.device),
                    min=SMALL)
    nut = torch.clamp(k / w, 0.0, 1e5)
    y = torch.as_tensor(wall_distance(m), dtype=dtype, device=m.device)
    return (
        KOmegaSSTState(k=k, omega=w, nut=nut, y=y),
        _turb_bcs(m, _read_spec(case_dir, "k")),
        _turb_bcs(m, _read_spec(case_dir, "omega")),
        wall_info(m),
    )


def k_omega_sst_step(
    m: fv.FvMesh,
    st: KOmegaSSTState,
    u, u_bcs, flux,
    k_bcs, w_bcs,
    wi: WallInfo,
    nu: float,
    dt=None,
    n_sweeps: int = 6,
    relax: float = 0.7,
):
    """One k-omega SST update (steady: under-relaxed; transient: pass dt).

    Menter 2003 blending: F1/F2 from wall distance, cross-diffusion in the
    omega equation, strain-rate-limited eddy viscosity
    nut = a1 k / max(a1 omega, b1 F2 |S|), production limiter
    min(Pk, c1 betaStar k omega).  Wall treatment: omega pinned in
    wall-adjacent cells to sqrt(omega_vis^2 + omega_log^2)
    (omegaWallFunction's blended value), k zeroGradient, nut via
    nutkWallFunction (wall_nut_bd)."""
    k = torch.clamp(st.k, min=SMALL)
    w = torch.clamp(st.omega, min=SMALL)
    y = torch.clamp(st.y, min=1e-10)
    y2 = y * y

    s2 = strain_rate_sq(m, u, u_bcs)
    gk = fv.gradient(m, k, k_bcs)
    gw = fv.gradient(m, w, w_bcs)
    cd_kw = 2.0 * ALPHA_W2 * torch.sum(gk * gw, dim=1) / w
    cd_kw_plus = torch.clamp(cd_kw, min=1e-10)
    sqk = torch.sqrt(k)
    arg1 = torch.clamp(
        torch.minimum(
            torch.maximum(sqk / (BETA_STAR * w * y), 500.0 * nu / (y2 * w)),
            4.0 * ALPHA_W2 * k / (cd_kw_plus * y2),
        ),
        max=10.0,
    )
    f1 = torch.tanh(arg1 ** 4)
    arg2 = torch.clamp(
        torch.maximum(2.0 * sqk / (BETA_STAR * w * y), 500.0 * nu / (y2 * w)), max=100.0
    )
    f2 = torch.tanh(arg2 * arg2)

    nut = A1_SST * k / torch.maximum(A1_SST * w, B1_SST * f2 * torch.sqrt(s2))
    pk_raw = nut * s2
    pk = torch.minimum(pk_raw, C1_SST * BETA_STAR * k * w)

    blend = lambda c1_, c2_: f1 * c1_ + (1.0 - f1) * c2_  # noqa: E731
    alpha_k = blend(ALPHA_K1, ALPHA_K2)
    alpha_w = blend(ALPHA_W1, ALPHA_W2)
    beta = blend(BETA1, BETA2)
    gamma = blend(GAMMA1, GAMMA2)
    ddt = _ddt(m, dt)

    # omega equation
    gamma_w = _face_gamma(m, nu, alpha_w * nut)
    Aw = fv.assemble_transport(
        m, flux, gamma_w, w_bcs, 1,
        ddt_coeff=ddt, phi_old=w[:, None] if dt is not None else None,
    )
    diag_w = Aw.diag + beta * w * m.vol             # implicit -beta w^2
    src_w = Aw.source[:, 0] + (gamma * s2 + (1.0 - f1) * cd_kw) * m.vol
    # wall cells: omegaWallFunction blended value, pinned by big diagonal
    yw = torch.clamp(wi.y_wall, min=1e-10)
    kw_ = torch.clamp(k[wi.wall_cell], min=SMALL)
    w_vis = 6.0 * nu / (BETA1 * yw * yw)
    w_log = torch.sqrt(kw_) / (CMU ** 0.25 * KAPPA * yw)
    w_wall = torch.sqrt(w_vis * w_vis + w_log * w_log)
    big = torch.tensor(1e30, dtype=m.dtype, device=m.device)
    diag_w = fv.index_sum(m.n_cells, [(wi.wall_cell, big.expand(wi.wall_cell.shape[0]))],
                          out=diag_w)
    src_w = fv.index_sum(m.n_cells, [(wi.wall_cell, big * w_wall)], out=src_w)
    w_new = _relaxed_jacobi(m, Aw, diag_w, src_w, w, dt, relax, n_sweeps)
    w_new = torch.clamp(w_new, min=SMALL)

    # k equation
    gamma_k = _face_gamma(m, nu, alpha_k * nut)
    Ak = fv.assemble_transport(
        m, flux, gamma_k, k_bcs, 1,
        ddt_coeff=ddt, phi_old=k[:, None] if dt is not None else None,
    )
    diag_k = Ak.diag + BETA_STAR * w_new * m.vol    # implicit sink
    src_k = Ak.source[:, 0] + pk * m.vol
    k_new = _relaxed_jacobi(m, Ak, diag_k, src_k, k, dt, relax, n_sweeps)
    k_new = torch.clamp(k_new, min=SMALL)

    nut_new = torch.clamp(
        A1_SST * k_new / torch.maximum(A1_SST * w_new, B1_SST * f2 * torch.sqrt(s2)),
        0.0, 1e5,
    )
    return KOmegaSSTState(k=k_new, omega=w_new, nut=nut_new, y=st.y)


# ---------------------------------------------------------------------------
# model-generic surface used by the solvers
# ---------------------------------------------------------------------------

MODELS = ("kEpsilon", "kOmegaSST")


def init_model(model: str, case_dir: str, m: fv.FvMesh, dtype=None, time_dir="0"):
    """(state, bcs_a, bcs_b, wall_info) for a supported RAS model."""
    if model == "kEpsilon":
        return init_from_case(case_dir, m, dtype=dtype, time_dir=time_dir)
    if model == "kOmegaSST":
        return init_from_case_sst(case_dir, m, dtype=dtype, time_dir=time_dir)
    raise ValueError(f"unsupported turbulence model {model!r}")


def model_step(model: str, m, st, u, u_bcs, flux, bcs_a, bcs_b, wi, nu, dt=None):
    """One closure update; bcs_a/bcs_b are (k, epsilon) or (k, omega)."""
    if model == "kEpsilon":
        return k_epsilon_step(m, st, u, u_bcs, flux, bcs_a, bcs_b, wi, nu, dt=dt)
    if model == "kOmegaSST":
        return k_omega_sst_step(m, st, u, u_bcs, flux, bcs_a, bcs_b, wi, nu, dt=dt)
    raise ValueError(f"unsupported turbulence model {model!r}")
