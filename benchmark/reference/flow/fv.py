"""Unstructured finite-volume operators and linear solvers, for the flow
reference: a frozen copy of the port's ``models/fv.py`` with the pressure
solve in plain PyTorch.  Every face-to-cell sum on the card gathers its
terms in a fixed order and sums each cell's run of them; the matvec and
each level of the AMG V-cycle are the plain versions of :mod:`.amg`, which
sum every row in that fixed order, left to right; the CG iteration runs
eagerly, its exit test read on the host once an iteration.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from . import amg as amg_ops
from .polymesh import PolyMesh, cell_centres_volumes, face_centres_areas


@dataclasses.dataclass(frozen=True, eq=False)
class FvMesh:
    """FV geometry of a PolyMesh on one torch device."""

    owner: torch.Tensor       # [nf] int64
    neighbour: torch.Tensor   # [n_int] int64
    sf: torch.Tensor          # [nf, 3] face area vectors (outward from owner)
    mag_sf: torch.Tensor      # [nf]
    cf: torch.Tensor          # [nf, 3] face centres
    cc: torch.Tensor          # [nc, 3] cell centres
    vol: torch.Tensor         # [nc]
    w: torch.Tensor           # [n_int] linear weights (owner side)
    delta: torch.Tensor       # [n_int] orthogonal delta coeffs |Sf|/(Sf.d/|Sf|)
    bd_delta: torch.Tensor    # [n_bd] boundary delta coeffs
    nonortho: torch.Tensor    # [n_int, 3] non-orthogonal correction vector k
    n_cells: int
    n_faces: int
    n_internal: int
    patch_slices: tuple       # ((name, type, start, count), ...) in bd-face numbering

    @property
    def dtype(self) -> torch.dtype:
        return self.sf.dtype

    @property
    def device(self) -> torch.device:
        return self.sf.device

    @property
    def own_i(self) -> torch.Tensor:
        """Owners of the internal faces."""
        return self.owner[: self.n_internal]

    @property
    def own_b(self) -> torch.Tensor:
        """Owners of the boundary faces."""
        return self.owner[self.n_internal :]


def fv_mesh(pm: PolyMesh, dtype=None, device=None) -> FvMesh:
    """FV tables of ``pm`` in ``dtype`` (default float32, as JAX) on
    ``device`` (default the card)."""
    f_ctr, f_area = face_centres_areas(pm)
    c_ctr, c_vol = cell_centres_volumes(pm, f_ctr, f_area)
    n_int = pm.n_internal_faces
    own, nei = pm.owner, pm.neighbour

    mag = np.linalg.norm(f_area, axis=1)
    # linear interpolation weights (OpenFOAM surfaceInterpolation):
    # w = |Cf - Cn| projected : use distance along face normal
    d_on = c_ctr[nei] - c_ctr[own[:n_int]]
    nhat = f_area[:n_int] / np.maximum(mag[:n_int], 1e-300)[:, None]
    d_fn = np.einsum("ij,ij->i", c_ctr[nei] - f_ctr[:n_int], nhat)
    d_of = np.einsum("ij,ij->i", f_ctr[:n_int] - c_ctr[own[:n_int]], nhat)
    w = d_fn / np.maximum(d_fn + d_of, 1e-300)

    # orthogonal delta coefficient (over-relaxed): |Sf|^2 / (Sf . d)
    sf_dot_d = np.einsum("ij,ij->i", f_area[:n_int], d_on)
    delta = mag[:n_int] ** 2 / np.maximum(sf_dot_d, 1e-300)
    # non-orthogonal correction vector: k = Sf - delta * d
    k = f_area[:n_int] - delta[:, None] * d_on

    # boundary deltas: |Sf| / (n . (Cf - Co))
    bd_own = own[n_int:]
    d_b = np.einsum(
        "ij,ij->i",
        f_ctr[n_int:] - c_ctr[bd_own],
        f_area[n_int:] / np.maximum(mag[n_int:], 1e-300)[:, None],
    )
    bd_delta = mag[n_int:] / np.maximum(d_b, 1e-300)

    patch_slices = tuple(
        (name, ptype, start - n_int, cnt) for name, ptype, start, cnt in pm.patches
    )
    fdt, dev = dtype, torch.device(device)
    as_f = lambda x: torch.as_tensor(np.asarray(x), dtype=fdt, device=dev)  # noqa: E731
    as_i = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int64, device=dev)  # noqa: E731
    return FvMesh(
        owner=as_i(own),
        neighbour=as_i(nei),
        sf=as_f(f_area),
        mag_sf=as_f(mag),
        cf=as_f(f_ctr),
        cc=as_f(c_ctr),
        vol=as_f(c_vol),
        w=as_f(w),
        delta=as_f(delta),
        bd_delta=as_f(bd_delta),
        nonortho=as_f(k),
        n_cells=pm.n_cells,
        n_faces=pm.n_faces,
        n_internal=n_int,
        patch_slices=patch_slices,
    )


def host(x) -> np.ndarray:
    """numpy copy of a tensor (the host-side set-up reads the device
    tables back, as JAX's ``np.asarray(m.cf)`` does)."""
    return x.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# sums into indexed rows (JAX's .at[i].add), in a fixed order on the card
# ---------------------------------------------------------------------------

_sum_plan = amg_ops.sum_plan


def _card_path(t) -> bool:
    """Whether ``t`` takes the card's path: fixed-order sums and the row
    plans' folds."""
    return t.device.type != "cpu"


def index_sum(n_out: int, parts, out=None, drop: bool = False):
    """``out`` (default zeros) plus, for each ``(index, values)`` of
    ``parts`` in turn, each row of ``values`` added to row ``index`` of an
    ``n_out``-row result, which is returned (``out`` itself is left as it
    is).  With ``drop`` an index outside [0, n_out) adds nothing (JAX's
    ``mode="drop"``).

    On the CPU: ``index_add_`` part by part, in order.  On the card: the
    concatenated values gathered in :func:`_sum_plan`'s order and summed
    row by row with ``torch.segment_reduce``, so each row sums in the same
    order on every run (``index_add_``'s atomics do not); the plan is made
    once per set of index tensors (``ops/amg.sum_plan``), which are the
    mesh's and the hierarchies' own.  Rows are segments of any length: a
    shard mesh's dummy cell takes every padded face, tens of thousands at
    full width."""
    vals = [v for _, v in parts]
    v0 = vals[0]
    if not _card_path(v0):
        idxs, n = [i for i, _ in parts], n_out
        if drop:    # out-of-range rows go to one spare row, sliced off
            idxs, n = [torch.where((i >= 0) & (i < n_out), i, n_out) for i in idxs], n_out + 1
        res = (v0.new_zeros((n,) + tuple(v0.shape[1:])) if out is None
               else torch.cat([out, out.new_zeros((1,) + tuple(out.shape[1:]))]) if drop
               else out.clone())
        for i, v in zip(idxs, vals):
            res.index_add_(0, i, v)
        return res[:n_out]
    order, offsets = _sum_plan(n_out, [i for i, _ in parts])
    src = torch.cat(vals) if len(vals) > 1 else v0
    res = torch.segment_reduce(src.index_select(0, order), "sum", offsets=offsets, unsafe=True)
    return res if out is None else out + res


# ---------------------------------------------------------------------------
# boundary conditions: phi_f = a * phi_owner + b  (per boundary face)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class BoundaryCoeffs:
    a: torch.Tensor   # [n_bd] multiplier on owner value
    b: torch.Tensor   # [n_bd, ncomp] offset
    # inletOutlet-family switching (OpenFOAM inletOutlet: zeroGradient on
    # outflow, fixedValue(inletValue) on backflow): faces flagged here flip
    # per outer iteration based on the current flux sign
    io_mask: torch.Tensor | None = None    # [n_bd] bool
    io_value: torch.Tensor | None = None   # [n_bd, ncomp]
    # slip/symmetry faces: for vector fields the face value is the owner
    # value with the face-normal component removed (U_f = U_P - (U_P.n)n);
    # a tensor relation the scalar affine form cannot express, handled as
    # a projection in boundary_value.  Scalars fall back to zeroGradient.
    slip_mask: torch.Tensor | None = None  # [n_bd] bool


def make_bcs(m: FvMesh, spec: dict, n_comp: int, default="zeroGradient", dtype=None):
    """Build affine BC coefficients from a {patch: (type, value)} spec.

    Supported types: fixedValue, zeroGradient, noSlip, empty, slip,
    calculated; pressure-coupled OpenFOAM types are mapped to their
    affine essence: totalPressure/uniformTotalPressure -> fixedValue (at
    the supplied value), inletOutlet / pressureInletOutletVelocity ->
    zeroGradient on outflow and fixedValue(inletValue) on backflow
    (:func:`effective_bcs`), outletInlet -> zeroGradient,
    pressureInletOutletParSlipVelocity -> slip.
    """
    dtype = dtype or m.dtype
    n_bd = m.n_faces - m.n_internal
    a = np.ones(n_bd)
    b = np.zeros((n_bd, n_comp))
    io_mask = np.zeros(n_bd, bool)
    io_value = np.zeros((n_bd, n_comp))
    slip_mask = np.zeros(n_bd, bool)
    fixed_types = ("fixedValue", "noSlip", "totalPressure", "uniformTotalPressure",
                   "uniformFixedValue", "movingWallVelocity")
    grad_types = ("zeroGradient", "empty", "calculated",
                  "outletInlet", "waveTransmissive")
    # tangential projection for vectors; identical to zeroGradient for
    # scalars (parSlip's tangential part is slip too)
    slip_types = ("slip", "symmetry", "symmetryPlane",
                  "pressureInletOutletParSlipVelocity")
    io_types = ("inletOutlet", "pressureInletOutletVelocity")
    for name, ptype, start, cnt in m.patch_slices:
        entry = spec.get(name)
        btype = entry[0] if entry else default
        val = entry[1] if entry and len(entry) > 1 else 0.0
        sl = slice(start, start + cnt)
        if btype in fixed_types:
            a[sl] = 0.0
            b[sl] = np.broadcast_to(
                np.zeros(n_comp) if btype == "noSlip"
                else np.asarray(0.0 if val is None else val, float),
                (cnt, n_comp),
            )
        elif btype in grad_types:
            a[sl] = 1.0
            b[sl] = 0.0
        elif btype in slip_types:
            a[sl] = 1.0
            b[sl] = 0.0
            slip_mask[sl] = True
        elif btype in io_types:
            # outflow branch (zeroGradient) as the base; backflow flips to
            # fixedValue(inletValue) via effective_bcs per outer iteration
            a[sl] = 1.0
            b[sl] = 0.0
            io_mask[sl] = True
            io_value[sl] = np.broadcast_to(
                np.asarray(0.0 if val is None else val, float), (cnt, n_comp)
            )
        else:
            raise ValueError(f"unsupported BC type {btype!r} on patch {name!r}")
    dev = m.device
    return BoundaryCoeffs(
        a=torch.as_tensor(a, dtype=dtype, device=dev),
        b=torch.as_tensor(b, dtype=dtype, device=dev).reshape(n_bd, n_comp),
        io_mask=torch.as_tensor(io_mask, device=dev),
        io_value=torch.as_tensor(io_value, dtype=dtype, device=dev).reshape(n_bd, n_comp),
        slip_mask=torch.as_tensor(slip_mask, device=dev) if slip_mask.any() else None,
    )


def effective_bcs(bc: BoundaryCoeffs, flux_b) -> BoundaryCoeffs:
    """Per-iteration inletOutlet switching: faces with inflow (flux < 0)
    become fixedValue(inletValue); outflow faces stay zeroGradient
    (OpenFOAM inletOutlet / pressureInletOutletVelocity semantics)."""
    if bc.io_mask is None:
        return bc
    inflow = bc.io_mask & (flux_b < 0.0)
    a = torch.where(inflow, 0.0, bc.a)
    b = torch.where(inflow[:, None], bc.io_value, bc.b)
    return dataclasses.replace(bc, a=a, b=b)


def boundary_value(m: FvMesh, bc: BoundaryCoeffs, phi):
    """phi on boundary faces: a * phi_owner + b (slip faces: tangential
    projection for vectors, which zeroes the wall-normal component so slip
    walls carry no mass flux)."""
    po = phi[m.own_b]
    if phi.ndim == 1:
        return bc.a * po + bc.b[:, 0]
    out = bc.a[:, None] * po + bc.b
    if bc.slip_mask is not None:
        nhat = m.sf[m.n_internal :] / m.mag_sf[m.n_internal :, None]
        tang = po - torch.sum(po * nhat, dim=-1, keepdim=True) * nhat
        out = torch.where(bc.slip_mask[:, None], tang, out)
    return out


# ---------------------------------------------------------------------------
# core operators
# ---------------------------------------------------------------------------


def face_interp(m: FvMesh, phi):
    """Linear face interpolation (internal faces)."""
    o = phi[m.own_i]
    n = phi[m.neighbour]
    w = m.w if phi.ndim == 1 else m.w[:, None]
    return w * o + (1.0 - w) * n


def surface_sum(m: FvMesh, face_vals):
    """Sum of per-face values into cells with owner +, neighbour - signs."""
    return index_sum(m.n_cells, [(m.owner, face_vals),
                                 (m.neighbour, -face_vals[: m.n_internal])])


def surface_sum_internal(m: FvMesh, face_vals):
    """surface_sum restricted to internal faces."""
    return index_sum(m.n_cells, [(m.own_i, face_vals), (m.neighbour, -face_vals)])


def divergence(m: FvMesh, face_flux):
    """div of a face flux field -> per-cell (per unit volume)."""
    v = m.vol if face_flux.ndim == 1 else m.vol[:, None]
    return surface_sum(m, face_flux) / v


def gradient(m: FvMesh, phi, bc: BoundaryCoeffs):
    """Gauss gradient of a scalar field -> [nc, 3]."""
    pf_i = face_interp(m, phi)
    pf_b = boundary_value(m, bc, phi)
    pf = torch.cat([pf_i, pf_b])
    return surface_sum(m, pf[:, None] * m.sf) / m.vol[:, None]


def flux_of(m: FvMesh, u, bc_u: BoundaryCoeffs):
    """Mass flux phi = U_f . Sf on all faces."""
    uf_i = face_interp(m, u)
    uf_b = boundary_value(m, bc_u, u)
    uf = torch.cat([uf_i, uf_b])
    return torch.sum(uf * m.sf, dim=-1)


def convection_correction(m: FvMesh, flux, phi, bc: BoundaryCoeffs, scheme: str,
                          grad=None):
    """Deferred second-order convection correction source [nc, ncomp].

    The implicit matrix stays first-order upwind (bounded, diagonally
    dominant); the difference between the high-order face value and the
    upwind value is added explicitly:  b += -sum_f F (phi_HO - phi_UD).
    Schemes (``system/fvSchemes`` divSchemes):

    * ``linearUpwind``: phi_HO = phi_UP + grad(phi)_UP . (Cf - C_UP)
    * ``limitedLinear`` (k=1): phi_HO = phi_UD + psi (phi_lin - phi_UD)
      with the OpenFOAM limiter psi = clamp(2 r, 0, 1),
      r = 2 (d . grad(phi)_UP) / (phi_D - phi_UP) - 1; for vectors the
      face limiter is the min over components (the ``V``-scheme)
    * ``linear``: unlimited central difference (deferred)
    """
    if scheme in ("upwind", "", None):
        ncomp = 1 if phi.ndim == 1 else phi.shape[1]
        return torch.zeros((m.n_cells, ncomp), dtype=m.dtype, device=m.device)
    ph = phi[:, None] if phi.ndim == 1 else phi
    n_int = m.n_internal
    f_i = flux[:n_int]
    own = m.own_i
    nei = m.neighbour
    fwd = f_i >= 0.0
    up = torch.where(fwd, own, nei)
    dn = torch.where(fwd, nei, own)
    phi_up = ph[up]
    phi_dn = ph[dn]
    w = m.w[:, None]
    phi_lin = w * ph[own] + (1.0 - w) * ph[nei]

    # per-component Gauss gradient (one surface sum for all components)
    if grad is None:
        pf_i = w * ph[own] + (1.0 - w) * ph[nei]
        pf_b = boundary_value(m, bc, ph)
        pf = torch.cat([pf_i, pf_b])
        grad = surface_sum(m, pf[:, :, None] * m.sf[:, None, :]) / m.vol[:, None, None]

    if scheme == "linearUpwind":
        d_up = m.cf[:n_int] - m.cc[up]
        phi_ho = phi_up + torch.einsum("fcd,fd->fc", grad[up], d_up)
    elif scheme == "limitedLinear":
        d = m.cc[nei] - m.cc[own]
        # r in upwind orientation: d points up->down for F>=0, down->up else
        dsign = torch.where(fwd, 1.0, -1.0).to(m.dtype)[:, None]
        dgrad = torch.einsum("fcd,fd->fc", grad[up], d) * dsign
        denom = phi_dn - phi_up
        r = 2.0 * dgrad / torch.where(torch.abs(denom) > 1e-30, denom, 1e-30) - 1.0
        psi = torch.clamp(2.0 * r, 0.0, 1.0)
        psi = torch.amin(psi, dim=1, keepdim=True)      # V-scheme direction
        phi_ho = phi_up + psi * (phi_lin - phi_up)
    elif scheme == "linear":
        phi_ho = phi_lin
    else:
        raise ValueError(f"unknown convection scheme {scheme!r}")

    corr_f = f_i[:, None] * (phi_ho - phi_up)
    return index_sum(m.n_cells, [(own, -corr_f), (nei, corr_f)])


def nonortho_flux(m: FvMesh, rau_f, p, p_bcs: BoundaryCoeffs):
    """Explicit non-orthogonal pressure-diffusion flux on internal faces:
    rau_f (k . grad(p)_f) with k the over-relaxed correction vector
    (``pEqn.H:42-57`` non-orthogonal corrector loop)."""
    n_int = m.n_internal
    gp = gradient(m, p, p_bcs)
    w = m.w[:, None]
    gpf = w * gp[m.own_i] + (1.0 - w) * gp[m.neighbour]
    return rau_f[:n_int] * torch.sum(m.nonortho * gpf, dim=-1)


# ---------------------------------------------------------------------------
# matrix-free LDU operator: A(phi) with upwind convection + diffusion
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class FvMatrix:
    """Implicit coefficients of a transport operator.

    A phi |_P = diag_P phi_P + sum_f lower/upper couplings; assembled
    matrix-free: ``matvec`` gathers neighbour values per face.
    Convention: A(phi) = b  discretizes  conv + diff (+ ddt).
    """

    diag: torch.Tensor      # [nc]
    lower: torch.Tensor     # [n_int] coeff of owner in neighbour's eq
    upper: torch.Tensor     # [n_int] coeff of neighbour in owner's eq
    source: torch.Tensor    # [nc, ncomp] rhs


def assemble_transport(
    m: FvMesh,
    flux,                 # [nf] mass flux
    gamma,                # scalar or [nf] diffusivity (times rho)
    bc: BoundaryCoeffs,
    n_comp: int,
    ddt_coeff=None,       # [nc] V/dt for transient, None for steady
    phi_old=None,         # [nc, ncomp]
):
    """Upwind convection + orthogonal diffusion matrix + BC/source terms."""
    n_int = m.n_internal
    f_i = flux[:n_int]
    f_b = flux[n_int:]
    gamma = torch.as_tensor(gamma, dtype=m.dtype, device=m.device).expand(m.n_faces)

    d_i = gamma[:n_int] * m.delta
    d_b = gamma[n_int:] * m.bd_delta

    # upwind convection: owner eq gets +max(F,0) on diag, +min(F,0) on N
    f_pos = torch.clamp(f_i, min=0.0)
    f_neg = torch.clamp(f_i, max=0.0)
    upper = f_neg - d_i          # coeff of phi_N in owner eq
    lower = -f_pos - d_i         # coeff of phi_P in neighbour eq
    diag = index_sum(m.n_cells, [(m.own_i, f_pos + d_i), (m.neighbour, -f_neg + d_i)])

    # boundary: phi_f = a phi_P + b
    # convection (outflow: phi_f upwinded to owner when F>0; inflow uses b)
    fb_neg = torch.clamp(f_b, max=0.0)
    conv_diag_b = torch.clamp(f_b, min=0.0) + fb_neg * bc.a
    conv_src_b = -fb_neg[:, None] * bc.b
    # diffusion: flux = d_b (phi_f - phi_P) = d_b ((a-1) phi_P + b)
    diff_diag_b = d_b * (1.0 - bc.a)
    diff_src_b = d_b[:, None] * bc.b
    diag = index_sum(m.n_cells, [(m.own_b, conv_diag_b + diff_diag_b)], out=diag)
    source = index_sum(m.n_cells, [(m.own_b, conv_src_b + diff_src_b)])

    if ddt_coeff is not None:
        diag = diag + ddt_coeff
        source = source + ddt_coeff[:, None] * phi_old

    return FvMatrix(diag=diag, lower=lower, upper=upper, source=source)


def matvec(m: FvMesh, A: FvMatrix, phi):
    """A @ phi (per component).  On the card the row plan's fold."""
    if _card_path(phi):
        return amg_ops.matvec_plain(amg_ops.row_plan(m.n_cells, m.own_i, m.neighbour),
                                    A.diag, A.upper, A.lower, phi)
    if phi.ndim == 2:
        out = A.diag[:, None] * phi
        upper, lower = A.upper[:, None], A.lower[:, None]
    else:
        out = A.diag * phi
        upper, lower = A.upper, A.lower
    return index_sum(m.n_cells, [(m.own_i, upper * phi[m.neighbour]),
                                 (m.neighbour, lower * phi[m.own_i])], out=out)


def h_operator(m: FvMesh, A: FvMatrix, phi):
    """H(phi) = source - offdiag @ phi (OpenFOAM's H)."""
    return A.source - (matvec(m, A, phi) - A.diag[:, None] * phi)


# ---------------------------------------------------------------------------
# algebraic multigrid (GAMG stand-in for the pressure equation)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class AmgHierarchy:
    """Aggregation hierarchy built once per mesh (host side).

    Pairwise greedy matching on the face graph weighted by the orthogonal
    diffusion coefficient (strongest couplings aggregate first), one
    pairing per level, down to a few hundred cells: OpenFOAM's GAMG
    agglomeration's role.  Per-solve coarse operators are Galerkin sums
    (piecewise-constant prolongation), built in :func:`amg_coarse_ops`.
    """

    aggs: tuple        # per level: [nc_l] int64 -> coarse cell id
    owners: tuple      # per level: coarse-face owner ids [n_cf_l]
    neighs: tuple      # per level: coarse-face neighbour ids
    f2cf: tuple        # per level: fine internal face -> coarse face (-1 intra)
    sizes: tuple       # coarse sizes per level


def _amg_pair_level(own, nei, w, nc):
    """One greedy pairwise-aggregation level on a face graph.

    Returns (matched[nc] fine->coarse, nc_c, own_c, nei_c, w_c, f2cf):
    the coarse cell map, coarse size, coarse face graph with summed
    weights, and the fine-face -> coarse-face map (-1 intra)."""
    order = np.argsort(-w, kind="stable")
    matched = np.full(nc, -1, np.int64)
    nxt = 0
    for f in order:
        a, b = own[f], nei[f]
        if matched[a] < 0 and matched[b] < 0:
            matched[a] = matched[b] = nxt
            nxt += 1
    single = matched < 0
    matched[single] = nxt + np.arange(int(single.sum()))
    nc_c = nxt + int(single.sum())
    co, cn = matched[own], matched[nei]
    inter = co != cn
    pmin = np.minimum(co[inter], cn[inter])
    pmax = np.maximum(co[inter], cn[inter])
    key = pmin.astype(np.int64) * nc_c + pmax
    ukey, inv = np.unique(key, return_inverse=True)
    f2cf = np.full(own.shape[0], -1, np.int64)
    f2cf[inter] = inv
    w_c = np.zeros(len(ukey))
    np.add.at(w_c, inv, w[inter])
    return matched, nc_c, ukey // nc_c, ukey % nc_c, w_c, f2cf


def build_amg(m: FvMesh, min_coarse: int = 200, max_levels: int = 16) -> AmgHierarchy:
    """Greedy pairwise aggregation on the owner/neighbour graph."""
    own = host(m.own_i)
    nei = host(m.neighbour)
    w = host(m.delta).astype(np.float64)
    nc = m.n_cells
    aggs, owners, neighs, f2cfs, sizes = [], [], [], [], []
    as_i = lambda x: torch.as_tensor(x, dtype=torch.int64, device=m.device)  # noqa: E731
    while nc > min_coarse and len(aggs) < max_levels:
        matched, nc_c, own_c, nei_c, w_c, f2cf = _amg_pair_level(own, nei, w, nc)
        aggs.append(as_i(matched))
        owners.append(as_i(own_c))
        neighs.append(as_i(nei_c))
        f2cfs.append(as_i(f2cf))
        sizes.append(nc_c)
        own, nei, w, nc = own_c, nei_c, w_c, nc_c
    return AmgHierarchy(
        aggs=tuple(aggs), owners=tuple(owners), neighs=tuple(neighs),
        f2cf=tuple(f2cfs), sizes=tuple(sizes),
    )


_INTRA_AGG: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _intra_agg(m: FvMesh, h: AmgHierarchy) -> tuple:
    """Per level of ``h``: each fine internal face's coarse cell where both
    its cells aggregate into it, else the coarse size (dropped).  Made once
    per hierarchy, so :func:`index_sum` finds its table again."""
    out = _INTRA_AGG.get(h)
    if out is None:
        out, own = [], m.own_i
        for li in range(len(h.sizes)):
            out.append(torch.where(h.f2cf[li] < 0, h.aggs[li][own], h.sizes[li]))
            own = h.owners[li]
        out = _INTRA_AGG[h] = tuple(out)
    return out


def amg_coarse_ops(m: FvMesh, h: AmgHierarchy, A: FvMatrix):
    """Galerkin coarse (diag, offdiag) per level for a SYMMETRIC operator
    (off = upper = lower, the pressure Laplacian).

    JAX scatters the faces it leaves out to the index one past the end
    with ``mode="drop"``, and so does :func:`index_sum` here: the kept
    faces sum in JAX's order."""
    diag, off = A.diag, A.upper
    intra = _intra_agg(m, h)
    levels = []
    for li in range(len(h.sizes)):
        ncl, n_cf = h.sizes[li], h.owners[li].shape[0]
        diag_c = index_sum(ncl, [(h.aggs[li], diag), (intra[li], 2.0 * off)], drop=True)
        off_c = index_sum(n_cf, [(h.f2cf[li], off)], drop=True)
        levels.append((diag_c, off_c))
        diag, off = diag_c, off_c
    return levels


def _sym_matvec(diag, off, own, nei, x):
    return index_sum(diag.shape[0], [(own, off * x[nei]), (nei, off * x[own])], out=diag * x)


def amg_vcycle(m: FvMesh, h: AmgHierarchy, A: FvMatrix, levels, r):
    """One V(1,1) cycle with damped-Jacobi smoothing; coarsest level gets
    a fixed Jacobi sweep block.  Used as the CG preconditioner.  On the
    card the plain levels of :mod:`.amg`, top to coarsest and back."""
    omega = amg_ops.OMEGA
    if _card_path(r):
        rows = [amg_ops.row_plan(m.n_cells, m.own_i, m.neighbour)] + [
            amg_ops.row_plan(n, o, ne) for n, o, ne in zip(h.sizes, h.owners, h.neighs)]
        aggs = [amg_ops.agg_plan(n, a) for n, a in zip(h.sizes, h.aggs)]
        ops = [(A.diag, A.upper)] + list(levels)
        return amg_ops.tail_plain(rows, aggs, ops, [(a, None) for a in h.aggs], r, omega)

    def descend(li, r):
        if li == 0:
            diag, off, own, nei = A.diag, A.upper, m.own_i, m.neighbour
        else:
            diag, off = levels[li - 1]
            own, nei = h.owners[li - 1], h.neighs[li - 1]
        x = omega * r / diag
        if li == len(h.sizes):
            for _ in range(amg_ops.COARSEST_SWEEPS):
                x = x + omega * (r - _sym_matvec(diag, off, own, nei, x)) / diag
            return x
        r1 = r - _sym_matvec(diag, off, own, nei, x)
        xc = descend(li + 1, index_sum(h.sizes[li], [(h.aggs[li], r1)]))
        x = x + xc[h.aggs[li]]
        x = x + omega * (r - _sym_matvec(diag, off, own, nei, x)) / diag
        return x

    return descend(0, r)


# ---------------------------------------------------------------------------
# linear solvers (residual exit tested on the host once per iteration)
# ---------------------------------------------------------------------------


def _dot(a, b):
    return torch.sum(a * b)


def _pcg(m: FvMesh, A: FvMatrix, b, x0, precond, tol, max_iter):
    """Preconditioned CG: the exit test ``|r|/|b| > tol and it < max_iter``
    before every body, its comparison on the device and one read of the
    result on the host.  Returns (x, |r|/|b|, iterations)."""
    r = b - matvec(m, A, x0)
    z = precond(r)
    x, p, rz = x0, z, _dot(r, z)
    norm_b = torch.sqrt(_dot(b, b)) + 1e-300
    go = torch.sqrt(_dot(r, r)) / norm_b > tol
    it = 0
    while it < max_iter and bool(go):
        ap = matvec(m, A, p)
        alpha = rz / (_dot(p, ap) + 1e-300)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = _dot(r, z)
        beta = rz_new / (rz + 1e-300)
        p = z + beta * p
        rz = rz_new
        it += 1
        go = torch.sqrt(_dot(r, r)) / norm_b > tol
    return x, torch.sqrt(_dot(r, r)) / norm_b, it


def amg_cg_solve(m: FvMesh, h: AmgHierarchy, A: FvMatrix, b, x0,
                 tol=1e-7, max_iter=200):
    """AMG-preconditioned CG (the GAMG stand-in): V-cycle as M^{-1}.
    Iteration counts stay roughly mesh-size independent, unlike the
    Jacobi-CG fallback."""
    levels = amg_coarse_ops(m, h, A)
    return _pcg(m, A, b, x0, lambda r: amg_vcycle(m, h, A, levels, r), tol, max_iter)


def jacobi_solve(m: FvMesh, A: FvMatrix, b, x0, sweeps: int = 5, relax=1.0):
    """Damped Jacobi sweeps (the smoothSolver stand-in for momentum)."""
    inv_d = 1.0 / A.diag
    if x0.ndim == 2:
        inv_d = inv_d[:, None]
    x = x0
    for _ in range(sweeps):
        x = x + relax * (inv_d * (b - matvec(m, A, x)))
    return x


def cg_solve(m: FvMesh, A: FvMatrix, b, x0, tol=1e-7, max_iter=500):
    """Jacobi-preconditioned conjugate gradients for symmetric operators
    (the pressure equation; stands in for OpenFOAM's GAMG).  Returns (x,
    final_residual, n_iterations)."""
    inv_d = 1.0 / A.diag
    return _pcg(m, A, b, x0, lambda r: inv_d * r, tol, max_iter)
