"""Momentum-equation fvOptions (run-time selectable source terms).

The port of ``cudaparticlesfoam_tpu/models/fvoptions.py``.  The reference
solver threads OpenFOAM's ``fv::options`` through its momentum equation:
``fvOptions(U)`` as an equation source, ``fvOptions.constrain(UEqn)``
before the solve, and ``fvOptions.correct(U)`` after the momentum
predictor and after the pressure corrector
(``applications/cudaParticlesPimpleFoam/UEqn.H:11,17,23``, ``pEqn.H:66``).

Supported types (the two momentum sources OpenFOAM tutorials use on this
solver family):

* ``meanVelocityForce`` — a closed-loop uniform driving force that
  maintains a prescribed volume-averaged velocity ``Ubar`` over a cell
  set: each ``correct(U)`` measures the zone's mean flow-direction
  velocity, OVERWRITES the pending gradient increment ``dGradP`` with the
  error over the zone-mean 1/A, and applies it to U directly;
  ``constrain`` folds the pending increment into the accumulated
  ``gradP0`` once per momentum assembly (OpenFOAM
  ``meanVelocityForce::correct/constrain``).  Both ride
  :class:`FvOptions` as state (``grad_p``, ``dgrad``: 0-dim tensors).
* ``vectorSemiImplicitSource`` — explicit ``Su`` [m/s^2] plus implicit
  ``Sp`` [1/s] volumetric sources over a cell set, with ``volumeMode``
  specific (per unit volume) or absolute (totals divided by the set
  volume).

Zone selection: ``selectionMode all`` or ``cellZone`` (read from
``constant/polyMesh/cellZones``).  Sources are packed into dense per-cell
fields (zero outside the set), as :mod:`.mrf` packs its zones.  Torch ops
on the mesh's device; no kernel.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..io import foamfile, polymesh
from . import fv


@dataclasses.dataclass(frozen=True, eq=False)
class FvOptions:
    """Packed momentum sources (all-zero fields = inert)."""

    su: torch.Tensor         # [nc, 3] explicit source per unit volume
    sp: torch.Tensor         # [nc] implicit coefficient per unit volume
    mvf_dir: torch.Tensor    # [3] unit flow direction (meanVelocityForce)
    mvf_mask: torch.Tensor   # [nc] 1.0 over the force's cell set
    mvf_mag: torch.Tensor    # [] target |Ubar|
    mvf_relax: torch.Tensor  # [] relaxation on the gradient increment
    grad_p: torch.Tensor     # [] accumulated driving gradient (state; gradP0)
    dgrad: torch.Tensor      # [] pending increment since the last assembly
    has_mvf: bool = False


def _zone_mask(sel_mode: str, spec: dict, n_cells: int, zones: dict,
               entry: str) -> np.ndarray:
    if sel_mode in ("all", ""):
        return np.ones(n_cells)
    if sel_mode == "cellZone":
        zname = str(spec.get("cellZone", spec.get("name", entry)))
        if zname not in zones:
            raise ValueError(
                f"fvOptions entry {entry!r}: cellZone {zname!r} not found "
                "in polyMesh/cellZones")
        mask = np.zeros(n_cells)
        mask[np.asarray(zones[zname], dtype=np.int64)] = 1.0
        return mask
    raise ValueError(
        f"fvOptions entry {entry!r}: selectionMode {sel_mode!r} not supported (all, cellZone)")


def from_case(case_dir: str, m: fv.FvMesh, pm=None) -> "FvOptions | None":
    """Read ``constant/fvOptions`` / ``system/fvOptions`` (both locations
    are legal in OpenFOAM; entries merge, system wins) onto ``m``'s device.
    Returns None when no momentum source is configured."""
    merged: dict = {}
    for sub in ("constant", "system"):
        path = os.path.join(case_dir, sub, "fvOptions")
        if os.path.exists(path):
            d = foamfile.read(path)
            d.pop("FoamFile", None)
            merged.update(d)
    if not merged:
        return None

    nc = m.n_cells
    zones = (pm.cell_zones if pm is not None and getattr(pm, "cell_zones", None)
             else polymesh.read_cell_zones(os.path.join(case_dir, "constant", "polyMesh")))
    vol = fv.host(m.vol).astype(np.float64)

    su = np.zeros((nc, 3))
    sp = np.zeros(nc)
    mvf_dir = np.zeros(3)
    mvf_mask = np.zeros(nc)
    mvf_mag = 0.0
    mvf_relax = 1.0
    has_mvf = False
    n_active = 0
    for name, spec in merged.items():
        if not isinstance(spec, dict):
            continue
        typ = str(spec.get("type", ""))
        if str(spec.get("active", "yes")).lower() in ("no", "false", "off"):
            continue
        coeffs = spec.get(f"{typ}Coeffs", spec)
        if typ == "meanVelocityForce":
            if has_mvf:
                raise ValueError(
                    "fvOptions: multiple meanVelocityForce entries are not supported "
                    "(OpenFOAM allows them per-zone; compose into one)")
            fields = coeffs.get("fields", ["U"])
            if "U" not in [str(f) for f in fields]:
                continue
            ubar = np.asarray([float(x) for x in coeffs["Ubar"]])
            mag = float(np.linalg.norm(ubar))
            if mag <= 0.0:
                continue
            mvf_dir = ubar / mag
            mvf_mag = mag
            mvf_relax = float(coeffs.get("relaxation", 1.0))
            mvf_mask = _zone_mask(str(coeffs.get("selectionMode", "all")), coeffs, nc, zones,
                                  str(name))
            has_mvf = True
            n_active += 1
        elif typ in ("vectorSemiImplicitSource", "semiImplicitSource"):
            rates = coeffs.get("injectionRateSuSp", {})
            entry = rates.get("U")
            if entry is None and "sources" in coeffs:
                src = coeffs["sources"].get("U", {})
                entry = [src.get("explicit", [0, 0, 0]), src.get("implicit", 0.0)]
            if entry is None:
                continue
            su_e = np.asarray([float(x) for x in entry[0]])
            sp_e = float(entry[1]) if len(entry) > 1 else 0.0
            mask = _zone_mask(str(coeffs.get("selectionMode", "all")), coeffs, nc, zones,
                              str(name))
            if str(coeffs.get("volumeMode", "specific")) == "absolute":
                vz = float((mask * vol).sum())
                su_e = su_e / max(vz, 1e-300)
                sp_e = sp_e / max(vz, 1e-300)
            su = su + mask[:, None] * su_e[None, :]
            sp = sp + mask * sp_e
            n_active += 1
        elif typ:
            raise ValueError(
                f"fvOptions entry {name!r}: type {typ!r} not supported "
                "(meanVelocityForce, vectorSemiImplicitSource)")
    if n_active == 0:
        return None

    def as_t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=m.dtype, device=m.device)

    return FvOptions(su=as_t(su), sp=as_t(sp), mvf_dir=as_t(mvf_dir), mvf_mask=as_t(mvf_mask),
                     mvf_mag=as_t(mvf_mag), mvf_relax=as_t(mvf_relax), grad_p=as_t(0.0),
                     dgrad=as_t(0.0), has_mvf=has_mvf)


def add_sup(fvo: FvOptions, m: fv.FvMesh, b):
    """``fvOptions(U)`` — explicit sources into the momentum RHS
    (volume-integrated): Su plus the meanVelocityForce's current driving
    gradient ``gradP0 + dGradP`` (``UEqn.H:11``)."""
    src = fvo.su
    if fvo.has_mvf:
        g = fvo.grad_p + fvo.dgrad
        src = src + (fvo.mvf_mask * g)[:, None] * fvo.mvf_dir[None, :]
    return b + src * m.vol[:, None]


def constrain(fvo: FvOptions, m: fv.FvMesh, A: fv.FvMatrix):
    """``fvOptions.constrain(UEqn)`` (``UEqn.H:17``): the implicit Sp part
    onto the diagonal (a source ``sp * u`` on the RHS moves over as ``-sp *
    V``), and the meanVelocityForce's once-per-assembly fold of the pending
    increment into ``gradP0``.  Returns (A, fvo)."""
    A = dataclasses.replace(A, diag=A.diag - fvo.sp * m.vol)
    if fvo.has_mvf:
        fvo = dataclasses.replace(fvo, grad_p=fvo.grad_p + fvo.dgrad,
                                  dgrad=torch.zeros_like(fvo.dgrad))
    return A, fvo


def correct(fvo: FvOptions, m: fv.FvMesh, u, rau):
    """``fvOptions.correct(U)`` (``UEqn.H:23``, ``pEqn.H:66``) — the
    meanVelocityForce feedback step: measure the zone's volume-averaged
    flow-direction velocity, OVERWRITE the pending gradient increment with
    the error over the zone-mean 1/A, and apply it to U.  The increment is
    folded into ``grad_p`` at the next :func:`constrain`.  Returns (u, fvo)."""
    if not fvo.has_mvf:
        return u, fvo
    w = fvo.mvf_mask * m.vol
    vz = torch.sum(w) + 1e-300
    ubar_star = torch.sum(w * (u @ fvo.mvf_dir)) / vz
    rau_ave = torch.sum(w * rau) / vz
    dgrad = fvo.mvf_relax * (fvo.mvf_mag - ubar_star) / rau_ave
    u = u + (fvo.mvf_mask * rau * dgrad)[:, None] * fvo.mvf_dir[None, :]
    return u, dataclasses.replace(fvo, dgrad=dgrad)
